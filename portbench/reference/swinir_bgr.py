"""The whole frame through SwinIR x2, plain: BGR uint8 -> RGB / 255 ->
SwinIR (:mod:`.swinir`) -> the quantization -> BGR uint8, one frame at a
time and whole.

The reference of the SwinIR configurations (their ``"reference"``): it
provides ``load``, ``macs_per_pixel`` and ``upscale_frame``, what
``portbench.spec.REFERENCE_API`` asks of a network's reference.

Departures from the paper (arXiv:2108.10257) and the authors' code, each
shared with the program:

* the frames are BGR uint8 (OpenCV's and the program's container order);
  the network sees them as RGB, in the authors' order, and its output is
  stored back as BGR;
* the weights are seeded (``configs/swinir_x2_seeded.jsonl``, written by
  ``configs/make_swinir_x2.py``), not the authors' trained
  ``001_classicalSR_DF2K_s64w8_SwinIR-M_x2.pth``, which the repository
  does not hold.
"""

from __future__ import annotations

import torch

from .swinir import SCALE, load, macs_per_pixel, quantize, swinir_rgb

__all__ = ["load", "macs_per_pixel", "upscale_frame"]


def upscale_frame(bgr: torch.Tensor, weights: dict, scale: float,
                  tf32: bool = False) -> torch.Tensor:
    """uint8 BGR ``[H, W, 3]`` -> uint8 BGR ``[2H, 2W, 3]`` on ``bgr``'s
    device; ``tf32`` rounds the products' operands to TF32 (the control).
    The network upscales by 2 only: another ``scale`` raises ValueError."""
    if scale != SCALE:
        raise ValueError(f"SwinIR x2 upscales by {SCALE}, not {scale}")
    rgb = bgr.flip(-1).permute(2, 0, 1).to(torch.float32) / 255.0
    out = quantize(swinir_rgb(rgb, weights, tf32))
    return out.permute(1, 2, 0).flip(-1).contiguous()
