"""VDSR weights as torch tensors (Kim, Lee, Lee, CVPR 2016, arXiv:1511.04587).

Twenty zero-padded 3x3 convolutions on the bicubic-upscaled Y plane in
[0, 1]: conv1 1->64, conv2..conv19 64->64, conv20 64->1; ReLU after every
layer but the last; the output is ``x + f(x)``.  A checkpoint is an npz of
``conv1_w`` .. ``conv20_b``, weights in OIHW ``(out, in, 3, 3)``, biases
``(out,)``.  No trained VDSR checkpoint ships with the port: the benchmark
serves seeded He-initialised weights (``portbench/configs/vdsr20_seeded.npz``).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

#: layers, feature maps and kernel size of the published network
DEPTH, CHANNELS, KERNEL = 20, 64, 3
KEYS = tuple(f"conv{i}_{p}" for i in range(1, DEPTH + 1) for p in "wb")


def vdsr_shapes() -> dict[str, tuple[int, ...]]:
    """The parameter shapes of the published network."""
    out = {}
    for i in range(1, DEPTH + 1):
        cin = 1 if i == 1 else CHANNELS
        cout = 1 if i == DEPTH else CHANNELS
        out[f"conv{i}_w"] = (cout, cin, KERNEL, KERNEL)
        out[f"conv{i}_b"] = (cout,)
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class VDSRWeights:
    """VDSR parameters: ``layers[i] = (w, b)`` of conv ``i + 1``, weights in
    OIHW ``[out_c, in_c, 3, 3]``, the published network's shapes
    (:func:`vdsr_shapes`)."""

    layers: tuple[tuple[torch.Tensor, torch.Tensor], ...]

    def __post_init__(self):
        got = {k: tuple(v.shape) for k, v in self.as_dict().items()}
        if got != vdsr_shapes():
            raise ValueError(f"not VDSR parameter shapes: {got}")

    def to(self, device) -> "VDSRWeights":
        return VDSRWeights(tuple((w.to(device), b.to(device))
                                 for w, b in self.layers))

    def as_dict(self) -> dict[str, torch.Tensor]:
        out = {}
        for i, (w, b) in enumerate(self.layers, start=1):
            out[f"conv{i}_w"], out[f"conv{i}_b"] = w, b
        return out

    @property
    def device(self) -> torch.device:
        return self.layers[0][0].device


def load_vdsr_weights(path: Path | str, device="cpu") -> VDSRWeights:
    """Load a 20-layer VDSR npz checkpoint as float32 tensors on
    ``device``; other keys or shapes raise ValueError."""
    with np.load(Path(path)) as z:
        missing = [k for k in KEYS if k not in z.files]
        if missing:
            raise ValueError(f"{path}: no VDSR checkpoint (lacks "
                             f"{', '.join(missing[:3])})")
        layers = tuple(
            tuple(torch.from_numpy(np.asarray(z[f"conv{i}_{p}"], np.float32)
                                   .copy()).to(device) for p in "wb")
            for i in range(1, DEPTH + 1))
    return VDSRWeights(layers)


def refuse_vdsr(weights, where: str, halo: str) -> None:
    """TypeError where ``weights`` are VDSR's and ``where`` carries only
    SRCNN's ``halo``: VDSR's 20 3x3 layers reach 20 pixels (a 41x41
    receptive field), which no tiled or merged SRCNN path has."""
    if isinstance(weights, VDSRWeights):
        raise TypeError(f"{where} takes SRCNN weights only: its halo is "
                        f"{halo}; VDSR needs a 20-pixel halo (41x41 "
                        f"receptive field), which it lacks")
