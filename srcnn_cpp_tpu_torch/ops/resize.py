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

:func:`resize_separable` is the JAX package's second engine
(``srcnn_cpp_tpu/ops/resize.py:441-555``): a float resampler over the six
filters of :data:`FILTERS`, used by the evaluation harness's degradation.
Its weight tables are a copy of the original's NumPy code, built on the
host once per geometry; the tap loop runs in torch on the input's device.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .resize_tables import cv_cubic_tables

__all__ = ["scaled_size", "cubic_tables", "resize_bicubic_u8", "FILTERS",
           "resize_separable"]


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


# ---------------------------------------------------------------------------
# The generic float weights-table resampler.  The filters and the table
# builder are NumPy copies of srcnn_cpp_tpu/ops/resize.py:441-522
# (tests/test_torch_eval.py holds them equal to the originals).
# ---------------------------------------------------------------------------

def _box(x):
    return (np.abs(x) <= 0.5).astype(np.float64)


def _bilinear(x):
    return np.maximum(0.0, 1.0 - np.abs(x))


def _mitchell(x, b=1.0 / 3.0, c=1.0 / 3.0):
    x = np.abs(x)
    x2, x3 = x * x, x * x * x
    y = np.where(
        x < 1.0,
        ((12 - 9 * b - 6 * c) * x3 + (-18 + 12 * b + 6 * c) * x2 + (6 - 2 * b)) / 6.0,
        np.where(
            x < 2.0,
            ((-b - 6 * c) * x3 + (6 * b + 30 * c) * x2
             + (-12 * b - 48 * c) * x + (8 * b + 24 * c)) / 6.0,
            0.0,
        ),
    )
    return y


def _catmull_rom(x, a=-0.75):
    x = np.abs(x)
    return np.where(
        x < 1.0,
        ((a + 2) * x - (a + 3)) * x * x + 1,
        np.where(x < 2.0, ((a * x - 5 * a) * x + 8 * a) * x - 4 * a, 0.0),
    )


def _keys_cubic(x):
    # a = -0.5: the Keys kernel MATLAB's imresize 'bicubic' uses — the
    # degradation of record for the SRCNN evaluation protocol
    # (reference Pictures/Resize.m).
    return _catmull_rom(x, a=-0.5)


def _lanczos(x, a=3):
    x = np.asarray(x, dtype=np.float64)
    y = np.sinc(x) * np.sinc(x / a)
    return np.where(np.abs(x) < a, y, 0.0)


#: filter name -> (kernel function, support radius)
FILTERS: dict[str, tuple] = {
    "box": (_box, 0.5),
    "bilinear": (_bilinear, 1.0),
    "mitchell": (_mitchell, 2.0),      # frawscale's "bicubic" (frawscale.h:92)
    "catmull_rom": (_catmull_rom, 2.0),  # OpenCV INTER_CUBIC's kernel, float
    "cubic_matlab": (_keys_cubic, 2.0),  # MATLAB imresize kernel (a=-0.5)
    "lanczos3": (_lanczos, 3.0),
}


def weights_table(dst: int, src: int, filter_name: str) -> tuple[np.ndarray, np.ndarray]:
    """Gather-index and weight tables for one axis, ``(idx int32 [dst, taps],
    w float32 [dst, taps])``.

    Same contract as the reference's weight-table builder
    (frawscale.cpp:8-112): coordinate mapping ``(i+0.5)/scale - 0.5``,
    window ``2*ceil(fwidth)+1``, anti-aliased downscale (kernel stretched by
    the scale factor), weights normalized to sum 1, indices clamped to the
    image (replicate border).
    """
    fn, support = FILTERS[filter_name]
    scale = dst / src
    if scale < 1.0:
        fwidth, fscale = support / scale, scale
    else:
        fwidth, fscale = support, 1.0
    ntaps = 2 * math.ceil(fwidth) + 1
    centers = (np.arange(dst, dtype=np.float64) + 0.5) / scale - 0.5
    left = np.ceil(centers - fwidth).astype(np.int64)
    taps = left[:, None] + np.arange(ntaps)[None, :]
    w = fn((centers[:, None] - taps) * fscale)
    norm = w.sum(axis=1, keepdims=True)
    norm = np.where(norm == 0.0, 1.0, norm)
    w = (w / norm).astype(np.float32)
    idx = np.clip(taps, 0, src - 1).astype(np.int32)
    return idx, w


@functools.lru_cache(maxsize=32)
def _axis_tables(dst: int, src: int, method: str, device: torch.device):
    """:func:`weights_table` on ``device``, tap-major: ``(idx int64
    [taps, dst], w float32 [taps, dst])``.  Cached per geometry; the cache
    hands the same read-only tensors to every caller."""
    idx, w = weights_table(dst, src, method)
    return (torch.from_numpy(np.ascontiguousarray(idx.T, np.int64)).to(device),
            torch.from_numpy(np.ascontiguousarray(w.T)).to(device))


def _apply_axis(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                dim: int) -> torch.Tensor:
    """One 1-D filtering pass along ``dim``: per tap a gather, a multiply
    and an add, each rounded on its own (eager torch does not contract
    them), in tap order."""
    shape = [1] * x.dim()
    shape[dim] = w.shape[1]
    acc = None
    for t in range(idx.shape[0]):
        term = x.index_select(dim, idx[t]) * w[t].reshape(shape)
        acc = term if acc is None else acc + term
    return acc


def resize_separable(x: torch.Tensor, out_hw: tuple[int, int],
                     method: str = "mitchell") -> torch.Tensor:
    """General separable resize of float planes ``[..., H, W]`` -> float32.

    Pass order follows the reference engine (frawscale.cpp:195-278):
    horizontal first when downscaling, vertical first when upscaling, which
    minimizes the intermediate buffer.
    """
    oh, ow = int(out_hw[0]), int(out_hw[1])
    ih, iw = x.shape[-2:]
    x = x.to(torch.float32)
    yi, yw = _axis_tables(oh, ih, method, x.device)
    xi, xw = _axis_tables(ow, iw, method, x.device)
    if ow <= iw:  # downscale: shrink width first
        x = _apply_axis(x, xi, xw, x.dim() - 1)
        x = _apply_axis(x, yi, yw, x.dim() - 2)
    else:  # upscale: filter the small-width intermediate first (vertical pass)
        x = _apply_axis(x, yi, yw, x.dim() - 2)
        x = _apply_axis(x, xi, xw, x.dim() - 1)
    return x
