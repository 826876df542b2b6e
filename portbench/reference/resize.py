"""OpenCV-4.6 INTER_CUBIC on uint8 planes (srcnn.cpp:577-582), plain.

Per axis: the source coordinate ``(i + 0.5) * src / dst - 0.5`` cast to
float32 before the floor, Catmull-Rom (a = -0.75) coefficients in float32,
quantized by 2**11 with round-half-to-even, taps clamped to the image.
Then an exact integer horizontal pass and a float32 vertical pass that
multiplies by ``icoef / 2048**2`` and adds taps 3, 2, 1, 0 in that order,
each product and sum rounded on its own, rounded half-to-even and clipped.
"""

from __future__ import annotations

import numpy as np
import torch

_SCALE = 2048


def output_size(h: int, w: int, scale: float) -> tuple[int, int]:
    """``(oh, ow)``: each side ``floor(float32(side) * float32(scale))``
    (srcnn.cpp:573-575)."""
    return (int(np.float32(h) * np.float32(scale)),
            int(np.float32(w) * np.float32(scale)))


def axis_tables(dst: int, src: int):
    """``(idx int64 [dst, 4], icoef int32 [dst, 4], fcoef float32 [dst, 4])``."""
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
         ).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    fx = (f - s).astype(np.float32)
    a, one = np.float32(-0.75), np.float32(1)
    c0 = ((a * (fx + one) - np.float32(5) * a) * (fx + one)
          + np.float32(8) * a) * (fx + one) - np.float32(4) * a
    c1 = ((a + 2) * fx - (a + 3)) * fx * fx + one
    c2 = ((a + 2) * (one - fx) - (a + 3)) * (one - fx) * (one - fx) + one
    c3 = one - c0 - c1 - c2
    coef = np.stack([c0, c1, c2, c3], -1).astype(np.float32)
    icoef = np.rint((coef * np.float32(_SCALE)).astype(np.float32)
                    ).astype(np.int32)
    fcoef = (icoef.astype(np.float32)
             * np.float32(1.0 / (_SCALE * _SCALE))).astype(np.float32)
    idx = np.clip(s[:, None] + np.arange(-1, 3)[None, :], 0, src - 1)
    return idx, icoef, fcoef


def resize_plane(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """uint8 ``[..., H, W]`` -> uint8 ``[..., oh, ow]``."""
    oh, ow = out_hw
    ih, iw = img.shape[-2:]
    dev = img.device
    xi, xic, _ = (torch.from_numpy(t).to(dev) for t in axis_tables(ow, iw))
    yi, _, yfc = (torch.from_numpy(t).to(dev) for t in axis_tables(oh, ih))
    s = img.to(torch.int32)
    rows = s[..., xi[:, 0]] * xic[:, 0]
    for j in (1, 2, 3):
        rows = rows + s[..., xi[:, j]] * xic[:, j]
    rows = rows.to(torch.float32)
    r = rows[..., yi[:, 3], :] * yfc[:, 3, None]
    for k in (2, 1, 0):
        r = rows[..., yi[:, k], :] * yfc[:, k, None] + r
    return torch.round(r).clamp(0, 255).to(torch.uint8)
