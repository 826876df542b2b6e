"""The whole frame, plain: the reference binary's 9 steps (srcnn.cpp:449-698).

BGR uint8 -> YCrCb -> each channel INTER_CUBIC to the output size -> the
SRCNN stack on Y -> (Y', Cr, Cb) -> BGR uint8, one frame at a time.
"""

from __future__ import annotations

import torch

from .color import bgr2ycrcb, ycrcb2bgr
from .resize import output_size, resize_plane
from .srcnn import srcnn_y


def upscale_frame(bgr: torch.Tensor, weights: dict, scale: float,
                  tf32: bool = False) -> torch.Tensor:
    """uint8 BGR ``[H, W, 3]`` -> uint8 BGR ``[oh, ow, 3]`` on ``bgr``'s
    device; ``tf32`` rounds the convs' operands to TF32 (the control)."""
    oh, ow = output_size(bgr.shape[0], bgr.shape[1], scale)
    up = resize_plane(bgr2ycrcb(bgr).permute(2, 0, 1), (oh, ow))
    y = srcnn_y(up[0], weights, tf32=tf32)
    return ycrcb2bgr(torch.stack([y, up[1], up[2]], -1))
