"""OpenCV's uint8 BGR <-> YCrCb, fixed point (cvtColor, srcnn.cpp:509, :657).

14-bit integer coefficients, round-half-up descaling, a clamp to [0, 255]
on the channels-last layout ``[..., 3]``.
"""

from __future__ import annotations

import torch

_SHIFT = 14
_HALF = 1 << (_SHIFT - 1)
_R2Y, _G2Y, _B2Y = 4899, 9617, 1868
_R2CR, _B2CB = 11682, 9241
_DELTA = 128 << _SHIFT
_CR2R, _CR2G, _CB2G, _CB2B = 22987, -11698, -5636, 29049


def _descale(x: torch.Tensor) -> torch.Tensor:
    return (x + _HALF) >> _SHIFT


def bgr2ycrcb(bgr: torch.Tensor) -> torch.Tensor:
    """uint8 BGR ``[..., 3]`` -> uint8 YCrCb ``[..., 3]``."""
    b, g, r = bgr.to(torch.int32).unbind(-1)
    y = _descale(b * _B2Y + g * _G2Y + r * _R2Y)
    cr = _descale((r - y) * _R2CR + _DELTA)
    cb = _descale((b - y) * _B2CB + _DELTA)
    return torch.stack([y, cr, cb], -1).clamp(0, 255).to(torch.uint8)


def ycrcb2bgr(ycrcb: torch.Tensor) -> torch.Tensor:
    """uint8 YCrCb ``[..., 3]`` -> uint8 BGR ``[..., 3]``."""
    y, cr, cb = ycrcb.to(torch.int32).unbind(-1)
    b = y + _descale((cb - 128) * _CB2B)
    g = y + _descale((cb - 128) * _CB2G + (cr - 128) * _CR2G)
    r = y + _descale((cr - 128) * _CR2R)
    return torch.stack([b, g, r], -1).clamp(0, 255).to(torch.uint8)
