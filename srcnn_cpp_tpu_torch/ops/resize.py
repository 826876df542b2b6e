"""OpenCV-4.6-bit-exact INTER_CUBIC resize of uint8 planes, gather form.

The counterpart of ``srcnn_cpp_tpu/ops/resize.py::resize_bicubic_u8``
(reference src/srcnn.cpp:577-582).  OpenCV's uint8 path is fixed-point:
per-axis coefficient tables (Catmull-Rom a=-0.75 in float32, quantized to
int16 range by scaling with 2**11 and rounding), an integer horizontal
pass, and a float32 vertical pass that multiplies by
``int_coef * (1/2048**2)`` and accumulates right to left (taps 3,2,1,0)
with separate mul and add roundings, then rounds half-to-even and clips.

Here both passes are 4-tap gathers through the clamped index tables of
:func:`.resize_tables.cv_cubic_tables`: the horizontal pass in int32
(exact), the vertical pass in float32.  Eager PyTorch runs the multiply
and the add as separate kernels, so neither the CPU nor the CUDA build
contracts them into an FMA and the result is bit-exact on both.  The
TPU's dense/block/phase matmul forms are layout variants of this one
engine and have no counterpart here; the gather form covers every scale.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .resize_tables import cv_cubic_tables

__all__ = ["scaled_size", "cubic_tables", "resize_bicubic_u8"]


def scaled_size(w: int, h: int, scale: float) -> tuple[int, int]:
    """Output (w, h) = floor(float32(dim) * float32(scale)).

    Matches the reference's cv::Size arithmetic (srcnn.cpp:573-575): the
    product is computed in float32 and truncated toward zero.
    """
    return (
        int(np.float32(w) * np.float32(scale)),
        int(np.float32(h) * np.float32(scale)),
    )


@functools.lru_cache(maxsize=32)
def cubic_tables(dst: int, src: int, device: torch.device):
    """One axis's ``(idx int32 [dst,4], icoef int32 [dst,4], fcoef f32 [dst,4])``
    on ``device``, built once per geometry with NumPy.

    The cache hands the same tensors to every caller: they are read-only.
    """
    return tuple(torch.from_numpy(np.ascontiguousarray(t)).to(device)
                 for t in cv_cubic_tables(dst, src))


def resize_bicubic_u8(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """uint8 ``[..., H, W]`` -> uint8 ``[..., out_h, out_w]``, OpenCV-4.6-exact."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    ih, iw = img.shape[-2:]
    xi, xic, _ = cubic_tables(ow, iw, img.device)
    yi, _, yfc = cubic_tables(oh, ih, img.device)
    s = img.to(torch.int32)
    rows = s.index_select(-1, xi[:, 0]) * xic[:, 0]
    for j in (1, 2, 3):
        rows = rows + s.index_select(-1, xi[:, j]) * xic[:, j]
    rows = rows.to(torch.float32)
    r = rows.index_select(-2, yi[:, 3]) * yfc[:, 3, None]
    for k in (2, 1, 0):
        r = rows.index_select(-2, yi[:, k]) * yfc[:, k, None] + r
    return torch.round(r).clamp(0, 255).to(torch.uint8)
