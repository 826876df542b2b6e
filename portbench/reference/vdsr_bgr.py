"""The whole frame through VDSR, plain: BGR uint8 -> YCrCb -> each channel
bicubic to the output size -> the VDSR stack on Y -> (Y', Cr, Cb) -> BGR
uint8, one frame at a time.

The reference of the VDSR configurations (their ``"reference"``): it
provides ``load``, ``macs_per_pixel`` and ``upscale_frame``, what
``portbench.spec.REFERENCE_API`` asks of a network's reference.

Departures from the paper (arXiv:1511.04587), each shared with the program:

* colour and resize are OpenCV's fixed-point YCrCb and INTER_CUBIC on
  uint8 planes (:mod:`.color`, :mod:`.resize`, as for SRCNN), not
  MATLAB's ``rgb2ycbcr`` and ``imresize``, so that the pre-pass and the
  merge are the SRCNN pipeline's; the network's input is that uint8 Y
  over 255;
* the weights are seeded He-normal ones with zero biases
  (``configs/make_vdsr20.py``), not the authors' trained ones, which are
  not in the repository.
"""

from __future__ import annotations

import torch

from .color import bgr2ycrcb, ycrcb2bgr
from .resize import output_size, resize_plane
from .vdsr import load, macs_per_pixel, vdsr_y

__all__ = ["load", "macs_per_pixel", "upscale_frame"]


def upscale_frame(bgr: torch.Tensor, weights: dict, scale: float,
                  tf32: bool = False) -> torch.Tensor:
    """uint8 BGR ``[H, W, 3]`` -> uint8 BGR ``[oh, ow, 3]`` on ``bgr``'s
    device; ``tf32`` rounds the convs' operands to TF32 (the control)."""
    oh, ow = output_size(bgr.shape[0], bgr.shape[1], scale)
    up = resize_plane(bgr2ycrcb(bgr).permute(2, 0, 1), (oh, ow))
    y = vdsr_y(up[0], weights, tf32=tf32)
    return ycrcb2bgr(torch.stack([y, up[1], up[2]], -1))
