"""Planar BGR <-> YCrCb conversion, bit-exact with OpenCV's uint8 path.

The reference delegates colorspace conversion to OpenCV (reference
src/srcnn.cpp:509 ``cvtColor(BGR2YCrCb)`` and :657 the inverse).  OpenCV's
uint8 conversion is fixed-point: 14-bit scaled integer coefficients with
round-half-up descaling.  Here that arithmetic runs in int32 torch ops —
the same constants as ``srcnn_cpp_tpu/ops/color.py:23-30`` — on planar
``[..., 3, H, W]`` tensors of any device.  The pre- and post-pass CUDA
kernels (``csrc/pre_pass.cu``, ``csrc/merge.cu``) restate the same integer
arithmetic per pixel.
"""

from __future__ import annotations

import torch

_SHIFT = 14
_HALF = 1 << (_SHIFT - 1)
# forward coefficients, round(c * 2**14)
_R2Y, _G2Y, _B2Y = 4899, 9617, 1868
_R2CR, _B2CB = 11682, 9241
_DELTA = 128 << _SHIFT
# inverse coefficients
_CR2R, _CR2G, _CB2G, _CB2B = 22987, -11698, -5636, 29049


def _descale(x: torch.Tensor) -> torch.Tensor:
    """OpenCV CV_DESCALE: add half, arithmetic shift right."""
    return (x + _HALF) >> _SHIFT


def bgr2ycrcb_u8_planar(bgr_p: torch.Tensor) -> torch.Tensor:
    """uint8 planar BGR ``[..., 3, H, W]`` -> planar YCrCb, OpenCV-bit-exact."""
    b, g, r = bgr_p.to(torch.int32).unbind(-3)
    y = _descale(b * _B2Y + g * _G2Y + r * _R2Y)
    cr = _descale((r - y) * _R2CR + _DELTA)
    cb = _descale((b - y) * _B2CB + _DELTA)
    return torch.stack([y, cr, cb], dim=-3).clamp(0, 255).to(torch.uint8)


def ycrcb2bgr_u8_planar(ycrcb_p: torch.Tensor) -> torch.Tensor:
    """uint8 planar YCrCb ``[..., 3, H, W]`` -> planar BGR, OpenCV-bit-exact."""
    y, cr, cb = ycrcb_p.to(torch.int32).unbind(-3)
    b = y + _descale((cb - 128) * _CB2B)
    g = y + _descale((cb - 128) * _CB2G + (cr - 128) * _CR2G)
    r = y + _descale((cr - 128) * _CR2R)
    return torch.stack([b, g, r], dim=-3).clamp(0, 255).to(torch.uint8)
