"""The VDSR stack on Y planes, plain (Kim, Lee, Lee, CVPR 2016,
arXiv:1511.04587, section 3.1).

The input is ``x``, the upscaled Y plane in [0, 1] (uint8 / 255).  Twenty
3x3 convolutions, each zero-padded by 1 so that the size is kept: conv1
1->64, conv2..conv19 64->64, conv20 64->1, ReLU after each but conv20.  The
output is ``y = x + f(x)`` (the global residual), stored as
``clamp(round(255 y), 0, 255)`` in uint8: rounding to nearest, as the
authors' MATLAB ``uint8`` does (torch rounds the ties, which float32
values almost never meet, to even).

Each conv is an explicit patch matrix times the weight matrix in float32,
with TF32 off (:func:`.srcnn._conv`), over blocks of output rows so that a
4K plane's patches fit.  The control of the comparison is the same stack
with every operand of every product rounded to TF32 (:func:`.srcnn.round_tf32`),
the precision a float32 conv takes when TF32 is allowed.  It imports
nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .srcnn import _conv, _fp32_strict

DEPTH = 20


def load(path, device) -> dict[str, torch.Tensor]:
    """The checkpoint's 40 arrays (``conv1_w`` .. ``conv20_b``) as float32
    tensors on ``device``."""
    with np.load(path) as z:
        return {f"conv{i}_{p}": torch.from_numpy(
            np.asarray(z[f"conv{i}_{p}"], np.float32)).to(device)
            for i in range(1, DEPTH + 1) for p in "wb"}


def macs_per_pixel(shapes: dict[str, tuple[int, ...]]) -> int:
    """Multiply-accumulates per output pixel of every conv, from the
    weights' shapes ``(out, in, 3, 3)``: 576 + 18 * 36,864 + 576 = 664,704
    for the published widths."""
    return sum(int(np.prod(s)) for k, s in shapes.items()
               if k.endswith("_w"))


def vdsr_y(y: torch.Tensor, weights: dict, tf32: bool = False,
           block_rows: int = 64) -> torch.Tensor:
    """uint8 Y ``[H, W]`` -> uint8 super-resolved Y ``[H, W]``."""
    h, w = y.shape
    depth = sum(k.endswith("_w") for k in weights)
    x = y.to(torch.float32)[None] / 255                  # [1, H, W]
    feat = x
    with _fp32_strict(), torch.no_grad():
        for i in range(1, depth + 1):
            wi, bi = weights[f"conv{i}_w"], weights[f"conv{i}_b"]
            padded = F.pad(feat, (1, 1, 1, 1))
            out = torch.empty((wi.shape[0], h, w), dtype=torch.float32,
                              device=y.device)
            for r0 in range(0, h, block_rows):
                r1 = min(h, r0 + block_rows)
                out[:, r0:r1] = _conv(padded[:, r0:r1 + 2], wi, bi, tf32)
            feat = F.relu(out) if i < depth else out
    return torch.round((x + feat)[0] * 255).clamp(0, 255).to(torch.uint8)
