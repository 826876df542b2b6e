"""SwinIR, plain (Liang, Cao, Sun, Zhang, Van Gool, Timofte, ICCVW 2021,
arXiv:2108.10257; the authors' ``models/network_swinir.py``, SwinIR-M for
classical SR with ``upsampler='pixelshuffle'`` and ``resi_connection=
'1conv'``).

On RGB in [0, 1] (``img_range`` 1): reflect-pad the bottom and right to a
multiple of the window, 8 (``check_image_size``); subtract the mean
(0.4488, 0.4371, 0.4040); ``conv_first``, a 3x3 conv 3->180 (``f0``);
flatten to tokens and LayerNorm (``patch_embed.norm``); 6 RSTBs, each
``y = conv(STL_6(... STL_1(x))) + x`` with ``conv`` a 3x3 conv 180->180 on
the token map; the final LayerNorm (``norm``); ``conv_after_body`` (3x3
180->180) plus ``f0``; ``conv_before_upsample`` (3x3 180->64, LeakyReLU
0.01); ``upsample`` (3x3 64->256, ``PixelShuffle(2)``: output channel
``c`` at ``(2h + dy, 2w + dx)`` is channel ``4c + 2dy + dx``);
``conv_last`` (3x3 64->3); add the mean back, crop to the input's 2H x 2W;
then ``main_test_swinir``'s quantization: clamp to [0, 1], times 255,
round (ties to even).  Every conv is zero-padded by 1, with bias.

An STL ``i`` (``x`` the token map): ``x + proj(WMSA(LN1(x)))``, then
``x + fc2(GELU(fc1(LN2(x))))``; LayerNorm eps 1e-5 with its affine, GELU
the exact erf form, ``fc1`` 180->360, ``fc2`` 360->180.  WMSA: for odd
``i`` ``torch.roll`` by (-4, -4) before the 8x8 windows are cut and by
(+4, +4) after; ``qkv`` a Linear 180->540 with bias, 6 heads of 30; per
window and head ``softmax(q * 30 ** -0.5 @ k^T + B (+ M)) @ v``, ``B`` the
``relative_position_bias_table`` at Swin's ``relative_position_index``
(query coordinates minus key coordinates, each + 7, the row term times 15,
summed), ``M`` the shifted layers' ``calculate_mask`` for the padded frame
(-100 between tokens whose regions of the rolled frame differ, else 0);
``proj`` a Linear 180->180.

Float32 with TF32 off; the attention runs a band of windows at a time so
that its scores fit.  The control of the comparison is the same network
with both operands of every conv, linear and attention product rounded to
TF32 (:func:`.srcnn.round_tf32`), the precision a float32 product takes
when TF32 is allowed.  It imports nothing of the program.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from .srcnn import _fp32_strict, round_tf32

RGB_MEAN, IMG_RANGE, SCALE, WINDOW = (0.4488, 0.4371, 0.4040), 1.0, 2, 8
SHIFT = WINDOW // 2
#: windows attended at a time
BAND = 2048


def expand(path) -> dict[str, np.ndarray]:
    """A seeded recipe's arrays.  The file: a JSON line with ``seed``, then
    a JSON line ``[name, shape, std, mean]`` a tensor; PCG64 seeded with
    ``seed`` draws, tensor after tensor in that order,
    ``standard_normal(shape) * std + mean`` in float64, rounded to float32;
    std 0 is the mean, drawing nothing."""
    head, *rows = Path(path).read_text().splitlines()
    rng = np.random.default_rng(int(json.loads(head)["seed"]))
    out = {}
    for row in map(json.loads, rows):
        name, shape, std = row[:3]
        mean = row[3] if len(row) > 3 else 0.0
        out[name] = (rng.standard_normal(shape) * std + mean) \
            .astype(np.float32) if std else np.full(shape, mean, np.float32)
    return out


_TOP = ("conv_first", "patch_embed", "layers", "norm", "conv_after_body",
        "conv_before_upsample", "upsample", "conv_last")


def load(path, device) -> dict[str, torch.Tensor]:
    """The checkpoint as float32 tensors on ``device`` by the authors'
    names: a seeded recipe (``.jsonl``, :func:`expand`) or an npz of those
    names (the index and mask buffers are not read: they are computed)."""
    path = Path(path)
    if path.suffix == ".jsonl":
        arrays = expand(path)
    else:
        with np.load(path) as z:
            arrays = {k: np.asarray(z[k], np.float32) for k in z.files
                      if k.split(".")[0] in _TOP
                      and not k.endswith(("relative_position_index",
                                          "attn_mask"))}
    return {k: torch.from_numpy(a).to(device) for k, a in arrays.items()}


def _shape(weights: dict) -> tuple[int, int]:
    """``(RSTBs, STLs an RSTB)`` of a checkpoint's names."""
    groups = sum(bool(re.fullmatch(r"layers\.\d+\.conv\.weight", k))
                 for k in weights)
    depth = sum(bool(re.fullmatch(
        r"layers\.0\.residual_group\.blocks\.\d+\.norm1\.weight", k))
        for k in weights)
    return groups, depth


def macs_per_pixel(shapes: dict[str, tuple[int, ...]]) -> int:
    """Multiply-accumulates per output pixel, from the checkpoint's shapes:
    a low-resolution pixel's linears (each weight once a token), its
    attention (``q k^T`` and ``a v``: 64 keys times the width, twice, a
    token and STL), every conv before the pixel shuffle (each weight once),
    over 4 output pixels, plus the tail conv's at the output size.
    3,116,187 at the published shapes: 12,464,748 a low-resolution pixel,
    of which 9,331,200 linears, 829,440 attention, 2,041,200 the seven
    180->180 convs and 262,908 the head, the conv before the upsampler,
    the upsampler and the tail's 4 output pixels."""
    low = 0
    for k, s in shapes.items():
        if not k.endswith(".weight") or len(s) == 1 \
                or k == "conv_last.weight":
            continue
        low += int(np.prod(s))
        if k.endswith(".attn.qkv.weight"):
            low += 2 * WINDOW * WINDOW * s[1]
    return low // (SCALE * SCALE) + int(np.prod(shapes["conv_last.weight"]))


def relative_position_index() -> torch.Tensor:
    coords_h = torch.arange(WINDOW)
    coords_w = torch.arange(WINDOW)
    coords = torch.stack(torch.meshgrid([coords_h, coords_w], indexing="ij"))
    coords_flatten = torch.flatten(coords, 1)
    relative_coords = coords_flatten[:, :, None] - coords_flatten[:, None, :]
    relative_coords = relative_coords.permute(1, 2, 0).contiguous()
    relative_coords[:, :, 0] += WINDOW - 1
    relative_coords[:, :, 1] += WINDOW - 1
    relative_coords[:, :, 0] *= 2 * WINDOW - 1
    return relative_coords.sum(-1)


def window_partition(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x.view(b, h // WINDOW, WINDOW, w // WINDOW, WINDOW, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, WINDOW, WINDOW,
                                                         c)


def window_reverse(windows: torch.Tensor, h: int, w: int) -> torch.Tensor:
    b = int(windows.shape[0] / (h * w / WINDOW / WINDOW))
    x = windows.view(b, h // WINDOW, w // WINDOW, WINDOW, WINDOW, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


def calculate_mask(h: int, w: int) -> torch.Tensor:
    img_mask = torch.zeros((1, h, w, 1))
    slices = (slice(0, -WINDOW), slice(-WINDOW, -SHIFT), slice(-SHIFT, None))
    cnt = 0
    for hs in slices:
        for ws in slices:
            img_mask[:, hs, ws, :] = cnt
            cnt += 1
    mask_windows = window_partition(img_mask).view(-1, WINDOW * WINDOW)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, float(-100.0)) \
        .masked_fill(attn_mask == 0, float(0.0))


def swinir_rgb(img: torch.Tensor, weights: dict,
               tf32: bool = False) -> torch.Tensor:
    """float32 RGB ``[3, H, W]`` in [0, 1] -> float32 RGB ``[3, 2H, 2W]``,
    the mean added back, before the quantization."""
    groups, depth = _shape(weights)
    dim = weights["conv_first.weight"].shape[0]
    heads = weights["layers.0.residual_group.blocks.0.attn."
                    "relative_position_bias_table"].shape[1]
    hd = dim // heads
    n = WINDOW * WINDOW

    def op(x):
        return round_tf32(x) if tf32 else x

    def conv(x, name):
        w, b = weights[f"{name}.weight"], weights[f"{name}.bias"]
        return F.conv2d(op(x), op(w), b, padding=1)

    def linear(x, name):
        return F.linear(op(x), op(weights[f"{name}.weight"]),
                        weights[f"{name}.bias"])

    def layer_norm(x, name):
        return F.layer_norm(x, (dim,), weights[f"{name}.weight"],
                            weights[f"{name}.bias"], 1e-5)

    index = relative_position_index().view(-1).to(img.device)

    def attention(x, p, mask):
        """``WindowAttention.forward`` (with ``proj``) on ``[B_, N, C]``,
        a band of windows at a time."""
        table = weights[f"{p}.attn.relative_position_bias_table"]
        bias = table[index].view(n, n, -1).permute(2, 0, 1).contiguous()
        out = torch.empty_like(x)
        for s in range(0, x.shape[0], BAND):
            xb = x[s:s + BAND]
            b_ = xb.shape[0]
            qkv = linear(xb, f"{p}.attn.qkv").reshape(b_, n, 3, heads, hd) \
                .permute(2, 0, 3, 1, 4)
            q, k, v = qkv[0], qkv[1], qkv[2]
            q = q * hd ** -0.5
            attn = op(q) @ op(k).transpose(-2, -1)
            attn = attn + bias.unsqueeze(0)
            if mask is not None:
                attn = attn + mask[s:s + BAND].unsqueeze(1)
            attn = torch.softmax(attn, dim=-1)
            out[s:s + BAND] = (op(attn) @ op(v)).transpose(1, 2) \
                .reshape(b_, n, dim)
        return linear(out, f"{p}.attn.proj")

    mean = torch.tensor(RGB_MEAN, dtype=torch.float32,
                        device=img.device).view(1, 3, 1, 1)
    h_old, w_old = img.shape[-2:]
    with _fp32_strict(), torch.no_grad():
        x = img[None]
        x = F.pad(x, (0, (WINDOW - w_old % WINDOW) % WINDOW, 0,
                      (WINDOW - h_old % WINDOW) % WINDOW), "reflect")
        x = (x - mean) * IMG_RANGE
        hp, wp = x.shape[-2:]
        mask = calculate_mask(hp, wp).to(img.device)
        f0 = conv(x, "conv_first")
        t = layer_norm(f0.flatten(2).transpose(1, 2), "patch_embed.norm")
        for r in range(groups):
            res = t
            for i in range(depth):
                p = f"layers.{r}.residual_group.blocks.{i}"
                shift = 0 if i % 2 == 0 else SHIFT
                shortcut = res
                y = layer_norm(res, f"{p}.norm1").view(1, hp, wp, dim)
                if shift:
                    y = torch.roll(y, shifts=(-shift, -shift), dims=(1, 2))
                win = window_partition(y).view(-1, n, dim)
                win = attention(win, p, mask if shift else None)
                y = window_reverse(win.view(-1, WINDOW, WINDOW, dim), hp, wp)
                if shift:
                    y = torch.roll(y, shifts=(shift, shift), dims=(1, 2))
                res = shortcut + y.view(1, hp * wp, dim)
                hid = F.gelu(linear(layer_norm(res, f"{p}.norm2"),
                                    f"{p}.mlp.fc1"))
                res = res + linear(hid, f"{p}.mlp.fc2")
            maps = res.transpose(1, 2).view(1, dim, hp, wp)
            t = conv(maps, f"layers.{r}.conv").flatten(2).transpose(1, 2) + t
        t = layer_norm(t, "norm")
        deep = t.transpose(1, 2).view(1, dim, hp, wp)
        x = conv(deep, "conv_after_body") + f0
        x = F.leaky_relu(conv(x, "conv_before_upsample.0"), 0.01)
        x = conv(F.pixel_shuffle(conv(x, "upsample.0"), SCALE), "conv_last")
        x = x / IMG_RANGE + mean
        return x[0, :, :h_old * SCALE, :w_old * SCALE]


def quantize(rgb: torch.Tensor) -> torch.Tensor:
    """``main_test_swinir``'s save: clamp to [0, 1], times 255, round, as
    uint8."""
    return (rgb.clamp(0, 1) * 255.0).round().to(torch.uint8)
