"""The SRCNN conv stack on Y planes, plain (srcnn.cpp:189-325, :77-81).

conv1 9x9 over the uint8 plane replicate-padded by 4 (srcnn.cpp:269-280),
ReLU; conv2 1x1, ReLU; conv3 5x5 over the features replicate-padded by 2
(their edge rows and columns repeated, srcnn.cpp:200-210); then IntTrim:
truncation toward zero and a clamp to [0, 255] (srcnn.cpp:238-240).

Each conv is an explicit patch matrix times the weight matrix in float32,
with TF32 off, over blocks of output rows so that a 4K plane fits.  The
control of the comparison is the same stack with every operand of the
three products rounded to TF32 (10 mantissa bits, round to nearest), the
precision a float32 conv takes when TF32 is allowed.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

KEYS = ("conv1_w", "conv1_b", "conv2_w", "conv2_b", "conv3_w", "conv3_b")


def load(path, device) -> dict[str, torch.Tensor]:
    """The checkpoint's six arrays as float32 tensors on ``device``."""
    with np.load(path) as z:
        return {k: torch.from_numpy(np.asarray(z[k], np.float32)).to(device)
                for k in KEYS}


def macs_per_pixel(shapes: dict[str, tuple[int, ...]]) -> int:
    """Multiply-accumulates per output pixel of the three convs, from the
    weights' shapes ``(out, in, kh, kw)``: 81*64 + 64*32 + 25*32 = 8,032
    for the checkpoint."""
    return sum(int(np.prod(shapes[k])) for k in ("conv1_w", "conv2_w",
                                                  "conv3_w"))


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def _fp32_strict():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, tf32: bool):
    """``x`` ``[C, h, w]`` (already padded) -> VALID conv ``[O, h', w']``."""
    o, c, k, _ = w.shape
    hh, ww = x.shape[1] - k + 1, x.shape[2] - k + 1
    patches = F.unfold(x[None], k)[0].T              # [h'*w', C*k*k]
    wm = w.reshape(o, c * k * k)
    if tf32:
        patches, wm = round_tf32(patches), round_tf32(wm)
    return torch.addmm(b, patches, wm.T).T.reshape(o, hh, ww)


def _pad_cols(x: torch.Tensor, p: int) -> torch.Tensor:
    cols = torch.arange(-p, x.shape[-1] + p, device=x.device)
    return x[..., cols.clamp(0, x.shape[-1] - 1)]


def srcnn_y(y: torch.Tensor, weights: dict, tf32: bool = False,
            block_rows: int = 64) -> torch.Tensor:
    """uint8 Y ``[H, W]`` -> uint8 super-resolved Y ``[H, W]``."""
    h, w = y.shape
    k1 = weights["conv1_w"].shape[-1] // 2
    k3 = weights["conv3_w"].shape[-1] // 2
    out = torch.empty((h, w), dtype=torch.uint8, device=y.device)
    img = y.to(torch.float32)
    with _fp32_strict(), torch.no_grad():
        for r0 in range(0, h, block_rows):
            r1 = min(h, r0 + block_rows)
            # the features of rows [f0, f1), from image rows clamped
            f0, f1 = max(0, r0 - k3), min(h, r1 + k3)
            rows = torch.arange(f0 - k1, f1 + k1, device=y.device)
            x = _pad_cols(img[rows.clamp(0, h - 1)][None], k1)
            x = F.relu(_conv(x, weights["conv1_w"], weights["conv1_b"], tf32))
            x = F.relu(_conv(x, weights["conv2_w"], weights["conv2_b"], tf32))
            # replicate-pad the features: their edge rows and columns
            frows = torch.arange(r0 - k3, r1 + k3, device=y.device)
            x = _pad_cols(x[:, frows.clamp(0, h - 1) - f0], k3)
            z = _conv(x, weights["conv3_w"], weights["conv3_b"], tf32)[0]
            out[r0:r1] = torch.trunc(z).clamp(0, 255).to(torch.uint8)
    return out
