"""RCAN x2 on RGB frames as fp32 ``F.conv2d`` (the plain path).

Zhang et al. (ECCV 2018, arXiv:1807.02758), as the authors' ``rcan.py``
computes it: the mean shift, the head conv, residual groups of RCABs
(``x + s * t``, ``t = conv(relu(conv(x)))``, ``s`` channel attention over
the frame's per-channel means), the group and long skips, the upsampler
(conv 64->256, pixel shuffle) and the tail conv, the mean added back, then
clamped to [0, 255] and rounded.  Takes and gives planar BGR uint8, the
container order of the pipeline; the network sees RGB.  Float32
throughout, TF32 off (:func:`.srcnn.fp32_strict`), one frame at a time, so
that a frame's result does not depend on the rest of its batch.  The CUDA
network (:mod:`.cuda_rcan`) is checked against this path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..weights.rcan import RGB_MEAN, RGB_RANGE, SCALE, rcab_prefix
from .srcnn import fp32_strict


def conv(x: torch.Tensor, weights, name: str) -> torch.Tensor:
    """The conv ``name`` of ``weights``, zero-padded to keep the size."""
    w, b = weights.pair(name)
    return F.conv2d(x, w, b, padding=w.shape[-1] // 2)


def channel_attention(t: torch.Tensor, weights, prefix: str) -> torch.Tensor:
    """``s [1, 64, 1, 1]``: sigmoid of the 64->4->64 MLP of ``t``'s means."""
    z = t.mean((2, 3), keepdim=True)
    hidden = F.relu(conv(z, weights, f"{prefix}.3.conv_du.0"))
    return torch.sigmoid(conv(hidden, weights, f"{prefix}.3.conv_du.2"))


def rcab(x: torch.Tensor, weights, g: int, b: int) -> torch.Tensor:
    p = rcab_prefix(g, b)
    t = conv(F.relu(conv(x, weights, f"{p}.0")), weights, f"{p}.2")
    return x + t * channel_attention(t, weights, p)


def residual_group(x: torch.Tensor, weights, g: int) -> torch.Tensor:
    res = x
    for b in range(weights.blocks):
        res = rcab(res, weights, g, b)
    return conv(res, weights, f"body.{g}.body.{weights.blocks}") + x


def pixel_shuffle(x: torch.Tensor) -> torch.Tensor:
    """``[1, 4c, H, W]`` -> ``[1, c, 2H, 2W]``: channel ``4c + 2dy + dx``
    to channel ``c`` at ``(2h + dy, 2w + dx)``."""
    return F.pixel_shuffle(x, SCALE)


def rgb_mean(device) -> torch.Tensor:
    """``MeanShift``'s bias magnitude, ``255 * mean`` in float32,
    ``[3, 1, 1]``."""
    return RGB_RANGE * torch.tensor(RGB_MEAN, dtype=torch.float32,
                                    device=device)[:, None, None]


def bgr_rgb(x: torch.Tensor) -> torch.Tensor:
    """Planar BGR <-> RGB (``[..., 3, H, W]``): the planes reversed."""
    return x.flip(-3)


def rcan_rgb_f32(rgb: torch.Tensor, weights) -> torch.Tensor:
    """float32 RGB ``[3, H, W]`` in [0, 255] -> float32 RGB ``[3, 2H, 2W]``,
    the mean added back, before clamping and rounding."""
    mean = rgb_mean(rgb.device)
    with fp32_strict(), torch.no_grad():
        h = conv((rgb - mean)[None], weights, "head.0")
        res = h
        for g in range(weights.groups):
            res = residual_group(res, weights, g)
        res = conv(res, weights, f"body.{weights.groups}") + h
        up = pixel_shuffle(conv(res, weights, "tail.0.0"))
        return (conv(up, weights, "tail.1") + mean)[0]


def rcan_x2(bgr_p: torch.Tensor, weights) -> torch.Tensor:
    """Planar BGR uint8 ``[B, 3, H, W]`` -> planar BGR uint8
    ``[B, 3, 2H, 2W]``, frame by frame."""
    outs = [bgr_rgb(rcan_rgb_f32(bgr_rgb(f).to(torch.float32), weights)
                    .clamp(0, 255).round().to(torch.uint8))
            for f in bgr_p]
    if not outs:
        h, w = bgr_p.shape[2:]
        return torch.empty((0, 3, SCALE * h, SCALE * w), dtype=torch.uint8,
                           device=bgr_p.device)
    return torch.stack(outs)
