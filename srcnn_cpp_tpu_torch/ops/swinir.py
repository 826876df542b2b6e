"""SwinIR x2 on RGB frames in plain fp32 torch (the CPU path).

Liang et al. (ICCVW 2021, arXiv:2108.10257), as the authors'
``network_swinir.py`` computes SwinIR-M for classical SR with the
pixel-shuffle upsampler: the frame reflect-padded at the bottom and right
to a multiple of the window (``check_image_size``), the mean taken off,
``conv_first``, the patch LayerNorm, the RSTBs (their STLs, a 3x3 conv and
the group skip), the final LayerNorm, ``conv_after_body`` with the long
skip, ``conv_before_upsample`` with LeakyReLU, the upsampler (conv 64->256,
``PixelShuffle(2)``), ``conv_last``, the mean added back, the crop, then
clamped to [0, 1], times 255 and rounded.  An STL is ``x + proj(WMSA(LN1
x))`` then ``x + fc2(GELU(fc1(LN2 x)))``; WMSA attends within 8x8 windows,
after a cyclic shift of 4 on odd layers, with the relative position bias
and, where shifted, the mask of ``calculate_mask`` for the padded frame.

Takes and gives planar BGR uint8, the container order of the pipeline; the
network sees RGB.  Float32 throughout, TF32 off (:func:`.srcnn.fp32_strict`),
one frame at a time, so that a frame's result does not depend on the rest
of its batch; the attention runs 4,096 windows at a time.  The
CUDA network (:mod:`.cuda_swinir`) is checked against this path.  Each
step is a function of this module, so that a test can plant a fault in
one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..weights.swinir import (IMG_RANGE, LEAKY, LN_EPS, RGB_MEAN, SCALE,
                              SHIFT, WINDOW, stl_prefix)
from .srcnn import fp32_strict

#: windows attended at a time (bounds the scores' memory)
WINDOWS_AT_ONCE = 4096


def pad_to_window(x: torch.Tensor) -> torch.Tensor:
    """``[1, C, H, W]`` reflect-padded at the bottom and right to multiples
    of :data:`WINDOW` (``check_image_size``)."""
    h, w = x.shape[-2:]
    return F.pad(x, (0, -w % WINDOW, 0, -h % WINDOW), mode="reflect")


def norm(x: torch.Tensor, weights, name: str) -> torch.Tensor:
    """The LayerNorm ``name`` over the last dimension, eps 1e-5."""
    w, b = weights.pair(name)
    return F.layer_norm(x, (x.shape[-1],), w, b, LN_EPS)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``nn.GELU()``: the exact erf form."""
    return F.gelu(x)


def head_scale(head_dim: int) -> float:
    """``q``'s scale: ``head_dim ** -0.5``."""
    return head_dim ** -0.5


def relative_position_index(window: int = WINDOW) -> torch.Tensor:
    """``[N, N]`` rows of the bias table for query ``i``, key ``j`` of a
    window (``N = window ** 2``): Swin's index, query minus key."""
    coords = torch.stack(torch.meshgrid(torch.arange(window),
                                        torch.arange(window), indexing="ij"))
    flat = coords.flatten(1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0)
    return (rel[..., 0] + window - 1) * (2 * window - 1) \
        + rel[..., 1] + window - 1


def attention_mask(hp: int, wp: int, window: int = WINDOW,
                   shift: int = SHIFT) -> torch.Tensor:
    """``calculate_mask``: ``[windows, N, N]``, -100 between the tokens of
    a shifted window whose regions of the rolled frame differ, else 0."""
    img = torch.zeros((hp, wp))
    cnt = 0
    bands = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    for hs in bands:
        for ws in bands:
            img[hs, ws] = cnt
            cnt += 1
    m = windows(img[None, :, :, None]).squeeze(-1)
    diff = m[:, None, :] - m[:, :, None]
    return torch.where(diff != 0, torch.tensor(-100.0), torch.tensor(0.0))


def shift_tokens(x: torch.Tensor, shift: int) -> torch.Tensor:
    """``[1, H, W, C]`` rolled by ``(-shift, -shift)``: the window grid's
    cyclic shift (``shift`` negative rolls it back)."""
    return torch.roll(x, (-shift, -shift), dims=(1, 2))


def windows(x: torch.Tensor) -> torch.Tensor:
    """``[1, H, W, C]`` -> ``[windows, N, C]``, windows in row-major
    order, tokens row-major within a window."""
    _, h, w, c = x.shape
    x = x.reshape(h // WINDOW, WINDOW, w // WINDOW, WINDOW, c)
    return x.permute(0, 2, 1, 3, 4).reshape(-1, WINDOW * WINDOW, c)


def unwindows(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """:func:`windows`' inverse."""
    c = x.shape[-1]
    x = x.reshape(h // WINDOW, w // WINDOW, WINDOW, WINDOW, c)
    return x.permute(0, 2, 1, 3, 4).reshape(1, h, w, c)


def window_attention(x: torch.Tensor, weights, prefix: str, shift: int,
                     mask: torch.Tensor | None) -> torch.Tensor:
    """WMSA of the normed tokens ``x [1, H, W, C]`` before ``proj``:
    ``softmax(q k^T scale + B (+ M)) v`` per window and head, the heads'
    outputs side by side, at each token's own place."""
    _, h, w, c = x.shape
    heads = weights.heads
    hd = c // heads
    table = weights.params[f"{prefix}.attn.relative_position_bias_table"]
    n = WINDOW * WINDOW
    bias = table[relative_position_index().reshape(-1)] \
        .reshape(n, n, heads).permute(2, 0, 1)
    wq, bq = weights.pair(f"{prefix}.attn.qkv")
    xw = windows(shift_tokens(x, shift) if shift else x)
    out = torch.empty_like(xw)
    for s in range(0, xw.shape[0], WINDOWS_AT_ONCE):
        part = xw[s:s + WINDOWS_AT_ONCE]
        qkv = F.linear(part, wq, bq).reshape(part.shape[0], n, 3, heads, hd) \
            .permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * head_scale(hd), qkv[1], qkv[2]
        a = q @ k.transpose(-2, -1) + bias[None]
        if mask is not None:
            a = a + mask[s:s + WINDOWS_AT_ONCE, None]
        a = torch.softmax(a, dim=-1)
        out[s:s + WINDOWS_AT_ONCE] = (a @ v).transpose(1, 2) \
            .reshape(part.shape[0], n, c)
    y = unwindows(out, h, w)
    return shift_tokens(y, -shift) if shift else y


def stl(x: torch.Tensor, weights, r: int, i: int,
        mask: torch.Tensor | None) -> torch.Tensor:
    """STL ``i`` of RSTB ``r`` on tokens ``[1, H, W, C]``; shifted on odd
    ``i``, with ``mask``."""
    p = stl_prefix(r, i)
    shift = SHIFT if i % 2 else 0
    a = window_attention(norm(x, weights, f"{p}.norm1"), weights, p, shift,
                         mask if shift else None)
    x = x + F.linear(a, *weights.pair(f"{p}.attn.proj"))
    hid = gelu(F.linear(norm(x, weights, f"{p}.norm2"),
                        *weights.pair(f"{p}.mlp.fc1")))
    return x + F.linear(hid, *weights.pair(f"{p}.mlp.fc2"))


def conv(x: torch.Tensor, weights, name: str) -> torch.Tensor:
    """The 3x3 conv ``name`` of ``weights``, zero-padded to keep the size,
    on ``[1, C, H, W]``."""
    w, b = weights.pair(name)
    return F.conv2d(x, w, b, padding=w.shape[-1] // 2)


def features(x: torch.Tensor, weights) -> torch.Tensor:
    """``forward_features`` on ``conv_first``'s maps ``[1, C, H, W]``; the
    token maps in between are ``[1, H, W, C]``."""
    hp, wp = x.shape[-2:]
    mask = attention_mask(hp, wp).to(x.device)
    t = norm(x.permute(0, 2, 3, 1), weights, "patch_embed.norm")
    for r in range(weights.groups):
        res = t
        for i in range(weights.depth):
            res = stl(res, weights, r, i, mask)
        t = conv(res.permute(0, 3, 1, 2), weights,
                 f"layers.{r}.conv").permute(0, 2, 3, 1) + t
    return norm(t, weights, "norm").permute(0, 3, 1, 2)


def pixel_shuffle(x: torch.Tensor) -> torch.Tensor:
    """``[1, 4c, H, W]`` -> ``[1, c, 2H, 2W]``: channel ``4c + 2dy + dx``
    to channel ``c`` at ``(2h + dy, 2w + dx)``."""
    return F.pixel_shuffle(x, SCALE)


def rgb_mean(device) -> torch.Tensor:
    """The RGB mean, float32 ``[3, 1, 1]``."""
    return torch.tensor(RGB_MEAN, dtype=torch.float32,
                        device=device)[:, None, None]


def bgr_rgb(x: torch.Tensor) -> torch.Tensor:
    """Planar BGR <-> RGB (``[..., 3, H, W]``): the planes reversed."""
    return x.flip(-3)


def swinir_rgb_f32(rgb: torch.Tensor, weights) -> torch.Tensor:
    """float32 RGB ``[3, H, W]`` in [0, 1] -> float32 RGB ``[3, 2H, 2W]``
    in [0, 1] before clamping: the authors' ``forward``."""
    h, w = rgb.shape[-2:]
    mean = rgb_mean(rgb.device)
    with fp32_strict(), torch.no_grad():
        x = (pad_to_window(rgb[None]) - mean) * IMG_RANGE
        f0 = conv(x, weights, "conv_first")
        x = conv(features(f0, weights), weights, "conv_after_body") + f0
        x = F.leaky_relu(conv(x, weights, "conv_before_upsample.0"), LEAKY)
        x = conv(pixel_shuffle(conv(x, weights, "upsample.0")), weights,
                 "conv_last")
        x = x / IMG_RANGE + mean
        return x[0, :, :SCALE * h, :SCALE * w]


def swinir_x2(bgr_p: torch.Tensor, weights) -> torch.Tensor:
    """Planar BGR uint8 ``[B, 3, H, W]`` -> planar BGR uint8
    ``[B, 3, 2H, 2W]``, frame by frame."""
    outs = [bgr_rgb((swinir_rgb_f32(bgr_rgb(f).to(torch.float32) / 255.0,
                                    weights).clamp(0, 1) * 255.0)
                    .round().to(torch.uint8))
            for f in bgr_p]
    if not outs:
        h, w = bgr_p.shape[2:]
        return torch.empty((0, 3, SCALE * h, SCALE * w), dtype=torch.uint8,
                           device=bgr_p.device)
    return torch.stack(outs)
