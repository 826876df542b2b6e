"""The VDSR stack on Y planes as fp32 ``F.conv2d`` (the plain path).

Kim, Lee, Lee (CVPR 2016, arXiv:1511.04587): the input is ``x``, the
upscaled Y plane in [0, 1] (u8 / 255); twenty 3x3 convolutions, each
zero-padded by 1 so the size is kept, ReLU after all but the last; the
output is ``y = x + f(x)``, stored as ``clamp(round(255 y), 0, 255)`` in
uint8 (round to nearest, as MATLAB's ``uint8`` of the authors' code; ties,
which fp32 values almost never meet, go to even).  Float32 throughout, TF32
off (:func:`.srcnn.fp32_strict`).  The CUDA chain (:mod:`.cuda_vdsr`) is
checked against this path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .srcnn import fp32_strict


def vdsr_residual_f32(y_u8: torch.Tensor, weights) -> torch.Tensor:
    """``(x, f(x))`` of uint8 Y planes ``[B, H, W]``: both float32
    ``[B, H, W]``, ``x = y / 255``."""
    x = y_u8.to(torch.float32)[:, None] / 255
    h = x
    with fp32_strict(), torch.no_grad():
        for i, (w, b) in enumerate(weights.layers):
            h = F.conv2d(h, w, b, padding=1)
            if i + 1 < len(weights.layers):
                h = F.relu(h)
    return x[:, 0], h[:, 0]


def quantize_round_u8(y: torch.Tensor) -> torch.Tensor:
    """``clamp(round(255 y), 0, 255)`` as uint8."""
    return torch.round(y * 255).clamp(0, 255).to(torch.uint8)


def vdsr_y(y_u8: torch.Tensor, weights) -> torch.Tensor:
    """uint8 Y plane(s) ``[H, W]`` / ``[B, H, W]`` -> uint8, same shape."""
    y3 = y_u8[None] if y_u8.dim() == 2 else y_u8
    x, f = vdsr_residual_f32(y3, weights)
    return quantize_round_u8(x + f).reshape(y_u8.shape)
