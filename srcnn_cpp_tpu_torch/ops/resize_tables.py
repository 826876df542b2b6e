"""NumPy-only coefficient tables + host reference for OpenCV-exact resize.

A copy of ``srcnn_cpp_tpu/ops/resize_tables.py`` (the port never imports
the JAX package; ``tests/test_torch_ops.py`` holds the two equal).  Used by
the torch gather engine (:mod:`.resize`) and by the pre-pass kernel's
host-built tap tables (:mod:`.cuda_resize`).  OpenCV 4.6 provenance:
reference src/srcnn.cpp:577-582 is the call site being matched.
"""

from __future__ import annotations

import numpy as np

_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS  # OpenCV INTER_RESIZE_COEF_SCALE


def catmull_rom_f32(fx: np.ndarray) -> np.ndarray:
    """OpenCV interpolateCubic: 4 taps of the a=-0.75 cubic, strict float32."""
    A = np.float32(-0.75)
    fx = fx.astype(np.float32)
    one = np.float32(1)
    c0 = ((A * (fx + one) - np.float32(5) * A) * (fx + one)
          + np.float32(8) * A) * (fx + one) - np.float32(4) * A
    c1 = ((A + 2) * fx - (A + 3)) * fx * fx + one
    c2 = ((A + 2) * (one - fx) - (A + 3)) * (one - fx) * (one - fx) + one
    c3 = one - c0 - c1 - c2
    return np.stack([c0, c1, c2, c3], axis=-1).astype(np.float32)


def cv_cubic_taps_unclamped(dst: int, src: int) -> tuple[np.ndarray, np.ndarray]:
    """The source-coordinate mapping, shared source of truth.

    Returns ``(taps, fr)``: the UNCLAMPED 4-tap source indices ``[dst, 4]``
    and the float32 fractional offsets.  The source coordinate
    ``(i+0.5)*src/dst - 0.5`` is cast to float32 *before* floor — OpenCV's
    exact recipe; :func:`cv_cubic_tables` and the phase-decomposition plans
    in :mod:`.resize` all derive from this one function so the mapping can
    never desync between the tables and the plans.
    """
    scale = src / dst
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    fr = (f - s).astype(np.float32)
    return s[:, None] + np.arange(-1, 3)[None, :], fr


def cv_cubic_tables(dst: int, src: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-axis (tap indices [dst,4], int coeffs [dst,4], float32 coeffs).

    Coefficients are computed in float32 and quantized to int16 range by
    scaling with 2048 and rounding half-to-even; float vertical
    coefficients are ``int_coef * float32(1/2048**2)``; tap indices clamp
    to the image (replicate border).
    """
    taps, fr = cv_cubic_taps_unclamped(dst, src)
    coef = catmull_rom_f32(fr)
    icoef = np.rint((coef * np.float32(_COEF_SCALE)).astype(np.float32)).astype(np.int32)
    fcoef = (icoef.astype(np.float32)
             * np.float32(1.0 / (_COEF_SCALE * _COEF_SCALE))).astype(np.float32)
    idx = np.clip(taps, 0, src - 1).astype(np.int32)
    return idx, icoef, fcoef


def resize_bicubic_u8_np(img: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """Host NumPy reference of the OpenCV-4.6-exact uint8 INTER_CUBIC resize.

    Integer horizontal pass, float32 right-to-left vertical pass with
    separate mul/add roundings — identical arithmetic to the JAX engine.
    ``img``: uint8 ``[H, W]``; returns uint8 ``[out_h, out_w]``.
    """
    oh, ow = int(out_hw[0]), int(out_hw[1])
    ih, iw = img.shape
    xi, xic, _ = cv_cubic_tables(ow, iw)
    yi, _, yfc = cv_cubic_tables(oh, ih)
    s = img.astype(np.int32)
    rows = sum(s[:, xi[:, j]] * xic[:, j][None, :] for j in range(4))
    r = rows[yi[:, 3], :].astype(np.float32) * yfc[:, 3][:, None]
    for k in (2, 1, 0):
        r = rows[yi[:, k], :].astype(np.float32) * yfc[:, k][:, None] + r
    return np.clip(np.rint(r), 0, 255).astype(np.uint8)
