"""The whole frame, plain: the reference binary's 9 steps (srcnn.cpp:449-698).

BGR uint8 -> YCrCb -> each channel INTER_CUBIC to the output size -> the
SRCNN stack on Y -> (Y', Cr, Cb) -> BGR uint8, one frame at a time.

The reference of the SRCNN configurations (their ``"reference"``): it
provides ``load``, ``macs_per_pixel`` and ``upscale_frame``, what
``portbench.spec.REFERENCE_API`` asks of a network's reference.
"""

from __future__ import annotations

import torch

from .color import bgr2ycrcb, ycrcb2bgr
from .resize import output_size, resize_plane
from .srcnn import load, macs_per_pixel, srcnn_y

__all__ = ["load", "macs_per_pixel", "upscale_frame"]


def upscale_frame(bgr: torch.Tensor, weights: dict, scale: float,
                  tf32: bool = False) -> torch.Tensor:
    """uint8 BGR ``[H, W, 3]`` -> uint8 BGR ``[oh, ow, 3]`` on ``bgr``'s
    device; ``tf32`` rounds the convs' operands to TF32 (the control)."""
    oh, ow = output_size(bgr.shape[0], bgr.shape[1], scale)
    up = resize_plane(bgr2ycrcb(bgr).permute(2, 0, 1), (oh, ow))
    y = srcnn_y(up[0], weights, tf32=tf32)
    return ycrcb2bgr(torch.stack([y, up[1], up[2]], -1))
