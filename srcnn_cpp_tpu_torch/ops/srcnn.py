"""The SRCNN 9-5-5 conv stack as fp32 ``F.conv2d`` (the plain reference path).

Reproduces the numerics of the reference's hand-written kernels —
``Convolution99x11`` (reference src/srcnn.cpp:254-325) and ``Convolution55``
(:189-243) — like ``srcnn_cpp_tpu/ops/srcnn.py``:

* unnormalized uint8 0-255 input to conv1 (srcnn.cpp:297);
* replicate "same" padding: an input-level pad of 4 for conv1
  (srcnn.cpp:269-280) and a feature-level pad of 2 for conv3 — the pad
  rows are clamped copies of f2's edge rows (srcnn.cpp:200-210);
* ReLU after conv1 and conv2, none after conv3 (srcnn.cpp:304,319);
* float32 throughout.  cuDNN runs float32 convolutions in TF32 by default,
  which keeps ~10 mantissa bits and breaks the <=1 LSB bar, so TF32 is
  switched off for the duration of the call (both cuDNN and matmul);
* truncating uint8 quantization (srcnn.cpp:238-240).

The fused CUDA kernel (:mod:`.cuda_srcnn`) is checked against this path.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from .quantize import quantize_trunc_u8


@contextlib.contextmanager
def fp32_strict():
    """Disable TF32 for cuDNN convolutions and cuBLAS matmuls."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def srcnn_y_f32(y: torch.Tensor, weights) -> torch.Tensor:
    """3-layer SRCNN on Y planes ``[H, W]`` or ``[B, H, W]`` (0-255 domain);
    returns the pre-quantization float32 output of the same shape."""
    squeeze = y.dim() == 2
    x = (y[None] if squeeze else y).to(torch.float32)[:, None]   # [B,1,H,W]
    with torch.no_grad(), fp32_strict():
        x = F.pad(x, (4, 4, 4, 4), mode="replicate")
        x = F.relu(F.conv2d(x, weights.conv1_w, weights.conv1_b))
        x = F.relu(F.conv2d(x, weights.conv2_w, weights.conv2_b))
        x = F.pad(x, (2, 2, 2, 2), mode="replicate")
        x = F.conv2d(x, weights.conv3_w, weights.conv3_b)[:, 0]
    return x[0] if squeeze else x


def srcnn_y(y_u8: torch.Tensor, weights) -> torch.Tensor:
    """uint8 Y plane(s) -> uint8 super-resolved Y plane(s)."""
    return quantize_trunc_u8(srcnn_y_f32(y_u8, weights))
