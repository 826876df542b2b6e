"""The whole frame through RCAN x2, plain: BGR uint8 -> RGB float32 -> RCAN
(:mod:`.rcan`) -> ``quantize`` -> BGR uint8, one frame at a time and whole,
since channel attention pools over all of it.

The reference of the RCAN configurations (their ``"reference"``): it
provides ``load``, ``macs_per_pixel`` and ``upscale_frame``, what
``portbench.spec.REFERENCE_API`` asks of a network's reference.

Departures from the paper (arXiv:1807.02758) and the authors' code, each
shared with the program:

* the frames are BGR uint8 (OpenCV's and the program's container order);
  the network sees them as RGB, in the authors' order, and its output is
  stored back as BGR;
* the weights are seeded (``configs/rcan_x2_seeded.jsonl``, written by
  ``configs/make_rcan_x2.py``), not the authors' trained ``RCAN_BIX2.pt``,
  which the repository does not hold.
"""

from __future__ import annotations

import torch

from .rcan import SCALE, load, macs_per_pixel, quantize, rcan_rgb

__all__ = ["load", "macs_per_pixel", "upscale_frame"]


def upscale_frame(bgr: torch.Tensor, weights: dict, scale: float,
                  tf32: bool = False) -> torch.Tensor:
    """uint8 BGR ``[H, W, 3]`` -> uint8 BGR ``[2H, 2W, 3]`` on ``bgr``'s
    device; ``tf32`` rounds the convs' operands to TF32 (the control).  The
    network upscales by 2 only: another ``scale`` raises ValueError."""
    if scale != SCALE:
        raise ValueError(f"RCAN x2 upscales by {SCALE}, not {scale}")
    rgb = bgr.flip(-1).permute(2, 0, 1).to(torch.float32)
    out = quantize(rcan_rgb(rgb, weights, tf32))
    return out.permute(1, 2, 0).flip(-1).contiguous()
