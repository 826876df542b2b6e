"""BGR <-> YCrCb conversion, bit-exact with OpenCV's uint8 path.

The reference delegates colorspace conversion to OpenCV (reference
src/srcnn.cpp:509 ``cvtColor(BGR2YCrCb)`` and :657 the inverse).  OpenCV's
uint8 conversion is fixed-point: 14-bit scaled integer coefficients with
round-half-up descaling.  Here that arithmetic runs in int32 torch ops —
the same constants as ``srcnn_cpp_tpu/ops/color.py:23-30`` — on tensors of
any device: channels-last ``[..., 3]`` (OpenCV's interleaved layout) or
planar ``[..., 3, H, W]`` (the pipeline's).  The pre- and post-pass CUDA
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


def _bgr2ycrcb(bgr: torch.Tensor, dim: int) -> torch.Tensor:
    b, g, r = bgr.to(torch.int32).unbind(dim)
    y = _descale(b * _B2Y + g * _G2Y + r * _R2Y)
    cr = _descale((r - y) * _R2CR + _DELTA)
    cb = _descale((b - y) * _B2CB + _DELTA)
    return torch.stack([y, cr, cb], dim=dim).clamp(0, 255).to(torch.uint8)


def _ycrcb2bgr(ycrcb: torch.Tensor, dim: int) -> torch.Tensor:
    y, cr, cb = ycrcb.to(torch.int32).unbind(dim)
    b = y + _descale((cb - 128) * _CB2B)
    g = y + _descale((cb - 128) * _CB2G + (cr - 128) * _CR2G)
    r = y + _descale((cr - 128) * _CR2R)
    return torch.stack([b, g, r], dim=dim).clamp(0, 255).to(torch.uint8)


def bgr2ycrcb_u8(bgr: torch.Tensor) -> torch.Tensor:
    """uint8 BGR ``[..., 3]`` -> uint8 YCrCb ``[..., 3]``, OpenCV-bit-exact."""
    return _bgr2ycrcb(bgr, -1)


def ycrcb2bgr_u8(ycrcb: torch.Tensor) -> torch.Tensor:
    """uint8 YCrCb ``[..., 3]`` -> uint8 BGR ``[..., 3]``, OpenCV-bit-exact."""
    return _ycrcb2bgr(ycrcb, -1)


def bgr2ycrcb_u8_planar(bgr_p: torch.Tensor) -> torch.Tensor:
    """uint8 planar BGR ``[..., 3, H, W]`` -> planar YCrCb, OpenCV-bit-exact."""
    return _bgr2ycrcb(bgr_p, -3)


def ycrcb2bgr_u8_planar(ycrcb_p: torch.Tensor) -> torch.Tensor:
    """uint8 planar YCrCb ``[..., 3, H, W]`` -> planar BGR, OpenCV-bit-exact."""
    return _ycrcb2bgr(ycrcb_p, -3)
