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
:func:`srcnn_family_f32` is the differentiable forward of the whole model
family (``srcnn_cpp_tpu/models/srcnn.py::SRCNN.apply``) that the trainer
runs.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from .quantize import quantize_trunc_u8


@contextlib.contextmanager
def fp32_strict():
    """Disable TF32 for cuDNN convolutions and cuBLAS matmuls, and only
    that: cuDNN stays enabled (``torch.backends.cudnn.flags()`` would also
    switch it off, its ``enabled`` defaulting to False)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def srcnn_y_f32(y: torch.Tensor, weights) -> torch.Tensor:
    """3-layer SRCNN on Y planes ``[H, W]`` or ``[B, H, W]`` (0-255 domain);
    returns the pre-quantization float32 output of the same shape, without
    gradients (:func:`srcnn_family_f32` on the 9-5-5 weights: pads of 4 and
    2)."""
    with torch.no_grad():
        return srcnn_family_f32(y, weights)


def srcnn_y(y_u8: torch.Tensor, weights) -> torch.Tensor:
    """uint8 Y plane(s) -> uint8 super-resolved Y plane(s)."""
    return quantize_trunc_u8(srcnn_y_f32(y_u8, weights))


def srcnn_family_f32(y: torch.Tensor, weights) -> torch.Tensor:
    """Differentiable SRCNN ``f1-f2-f3`` forward on Y planes ``[H, W]`` or
    ``[B, H, W]`` (0-255 domain, any dtype) -> the weights' float type
    (float32; float64 weights give a float64 yardstick), same shape.

    The counterpart of ``SRCNN._apply_generic`` (and, for 9-1-5, of
    :func:`srcnn_y_f32`): each conv is "same" by a replicate pad of its
    input — the image by ``f1 // 2`` for conv1, the features by ``f2 // 2``
    for conv2 and ``f3 // 2`` for conv3 (the reference's feature-level
    clamp) — then a VALID float32 conv with TF32 off; ReLU after conv1 and
    conv2.  ``weights`` is any object with the six parameter tensors, e.g.
    an ``SRCNNWeights`` or a :class:`..models.SRCNN`; gradients flow to
    them.  The TF32 switch covers this forward only: run the backward
    under :func:`fp32_strict` too.
    """
    squeeze = y.dim() == 2
    x = (y[None] if squeeze else y).to(weights.conv1_w.dtype)[:, None]

    def conv(x, w, b):
        p = w.shape[-1] // 2
        if p:
            x = F.pad(x, (p, p, p, p), mode="replicate")
        return F.conv2d(x, w, b)

    with fp32_strict():
        x = F.relu(conv(x, weights.conv1_w, weights.conv1_b))
        x = F.relu(conv(x, weights.conv2_w, weights.conv2_b))
        x = conv(x, weights.conv3_w, weights.conv3_b)[:, 0]
    return x[0] if squeeze else x
