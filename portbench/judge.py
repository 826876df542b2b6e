"""The comparison that decides ``correct``.

The frames the timed path produced, one frame of each of
:data:`CHECK_FRAMES` results drawn from the window by the seed
(:class:`portbench.loops.Reservoir`), are compared whole (BGR, every
channel) with the plain reference run on the same input frames and the
same checkpoint file.  Two numbers, each with the limit the
configuration's file gives:

* ``max_lsb``: the largest difference of an output byte from the
  reference's;
* ``share_off``: the share of output bytes that differ at all.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .reference import srcnn, srcnn_bgr

#: results of the window that each give one frame to the comparison
CHECK_FRAMES = 16


@dataclasses.dataclass
class Comparison:
    max_lsb: int = 0
    off: int = 0
    total: int = 0
    frames: int = 0

    def add(self, out: torch.Tensor, ref: torch.Tensor) -> None:
        self.frames += 1
        if tuple(out.shape) != tuple(ref.shape) or out.dtype != ref.dtype:
            self.max_lsb, self.off = 255, self.off + ref.numel()
            self.total += ref.numel()
            return
        d = (out.to(torch.int16) - ref.to(torch.int16)).abs()
        self.max_lsb = max(self.max_lsb, int(d.max()))
        self.off += int((d > 0).sum())
        self.total += ref.numel()

    def numbers(self) -> dict:
        return {"max_lsb": self.max_lsb,
                "share_off": self.off / self.total if self.total else 1.0}


def as_tensor(frame, device) -> torch.Tensor:
    if isinstance(frame, np.ndarray):
        frame = torch.from_numpy(np.ascontiguousarray(frame))
    return frame.to(device)


def compare(pairs: list, inputs, weights_file, scale: float, device,
            control: Comparison | None = None) -> Comparison:
    """Each output frame against the reference of its input frame
    (``inputs[i]``); with ``control``, also the control (the reference
    with the convs' operands in TF32) against the reference, into it."""
    weights = srcnn.load(weights_file, device)
    result = Comparison()
    for i, out in pairs:
        x = as_tensor(inputs[i], device)
        ref = srcnn_bgr.upscale_frame(x, weights, scale)
        result.add(as_tensor(out, device), ref)
        if control is not None:
            control.add(srcnn_bgr.upscale_frame(x, weights, scale,
                                                tf32=True), ref)
    return result


def checks(numbers: dict, limits: dict) -> dict:
    """``{name: {"value": v, "limit": l}}`` for each limited number."""
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}


def passed(found: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in found.values())
