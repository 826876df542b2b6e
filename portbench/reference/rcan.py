"""RCAN, plain (Zhang, Li, Li, Wang, Zhong, Fu, ECCV 2018, arXiv:1807.02758,
section 3; the authors' ``RCAN_TrainCode/code/model/rcan.py``, identical to
EDSR-PyTorch's ``src/model/rcan.py``).

On RGB in [0, 255] (``rgb_range`` 255): subtract ``255 * (0.4488, 0.4371,
0.4040)`` (``MeanShift``); the head, a 3x3 conv 3->64; the body, residual
groups, then a 3x3 conv 64->64, then the long skip ``res = body(h) + h``.
A residual group is RCABs, then a 3x3 conv, then ``g = body(x) + x``.  An
RCAB is ``t = conv(relu(conv(x)))`` and channel attention: ``z`` the mean
of ``t`` over the frame per channel, ``s = sigmoid(W2 relu(W1 z + b1) +
b2)`` (1x1 convs 64->4->64), out ``x + s * t``.  The tail: a 3x3 conv
64->256, ``PixelShuffle(2)`` (output channel ``c`` at ``(2h + dy, 2w + dx)``
is channel ``4c + 2dy + dx``), a 3x3 conv 64->3; then add the mean back and
``quantize``: clamp to [0, 255], round (ties, which float32 values almost
never meet, to even).  Every 3x3 conv is zero-padded by 1, with bias.

Float32 with TF32 off, through ``F.conv2d``, the whole frame at once:
channel attention pools over all of it.  The control of the comparison is
the same network with both operands of every conv rounded to TF32
(:func:`.srcnn.round_tf32`), the precision a float32 conv takes when TF32
is allowed.  It imports nothing of the program.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from .srcnn import _fp32_strict, round_tf32

RGB_MEAN, RGB_RANGE, SCALE = (0.4488, 0.4371, 0.4040), 255, 2


def expand(path) -> dict[str, np.ndarray]:
    """A seeded recipe's arrays.  The file: a JSON line with ``seed``, then
    a JSON line ``[name, shape, std]`` a tensor; PCG64 seeded with
    ``seed`` draws, tensor after tensor in that order,
    ``standard_normal(shape) * std`` in float64, rounded to float32; std 0
    is zeros, drawing nothing."""
    head, *rows = Path(path).read_text().splitlines()
    rng = np.random.default_rng(int(json.loads(head)["seed"]))
    out = {}
    for name, shape, std in map(json.loads, rows):
        out[name] = (rng.standard_normal(shape) * std).astype(np.float32) \
            if std else np.zeros(shape, np.float32)
    return out


def load(path, device) -> dict[str, torch.Tensor]:
    """The checkpoint as float32 tensors on ``device`` by the authors'
    names: a seeded recipe (``.jsonl``, :func:`expand`) or an npz of those
    names."""
    path = Path(path)
    if path.suffix == ".jsonl":
        arrays = expand(path)
    else:
        with np.load(path) as z:
            arrays = {k: np.asarray(z[k], np.float32) for k in z.files
                      if k.split(".")[0] in ("head", "body", "tail")}
    return {k: torch.from_numpy(a).to(device) for k, a in arrays.items()}


def macs_per_pixel(shapes: dict[str, tuple[int, ...]]) -> int:
    """Multiply-accumulates per output pixel: every conv before the
    pixel shuffle runs at the input size, a quarter of an output pixel, the
    tail conv at the output size; channel attention's 1x1 convs run once a
    frame and are not counted.  3,826,800 at the published shapes: head
    1,728, 411 convs 64->64 of 36,864 and the upsampler's 147,456 a low-
    resolution pixel, over 4, and the tail's 1,728."""
    low = sum(int(np.prod(s)) for k, s in shapes.items()
              if k.endswith(".weight") and "conv_du" not in k
              and k != "tail.1.weight")
    return low // (SCALE * SCALE) + int(np.prod(shapes["tail.1.weight"]))


def _depth(weights: dict) -> tuple[int, int]:
    groups = sum(k.endswith(".body.0.body.0.weight") and k.count(".") == 6
                 for k in weights)
    blocks = sum(k.startswith("body.0.body.") and k.endswith(".body.0.weight")
                 for k in weights)
    return groups, blocks


def rcan_rgb(img: torch.Tensor, weights: dict,
             tf32: bool = False) -> torch.Tensor:
    """float32 RGB ``[3, H, W]`` in [0, 255] -> float32 RGB ``[3, 2H, 2W]``,
    the mean added back, before ``quantize``."""
    groups, blocks = _depth(weights)

    def conv(x, name):
        w, b = weights[f"{name}.weight"], weights[f"{name}.bias"]
        if tf32:
            x, w = round_tf32(x), round_tf32(w)
        return F.conv2d(x, w, b, padding=w.shape[-1] // 2)

    mean = RGB_RANGE * torch.tensor(RGB_MEAN, dtype=torch.float32,
                                    device=img.device)[:, None, None]
    with _fp32_strict(), torch.no_grad():
        h = conv((img - mean)[None], "head.0")
        res = h
        for g in range(groups):
            x = res
            for b in range(blocks):
                p = f"body.{g}.body.{b}.body"
                t = conv(F.relu(conv(x, f"{p}.0")), f"{p}.2")
                z = t.mean((2, 3), keepdim=True)
                s = torch.sigmoid(conv(F.relu(conv(z, f"{p}.3.conv_du.0")),
                                       f"{p}.3.conv_du.2"))
                x = x + t * s
            res = conv(x, f"body.{g}.body.{blocks}") + res
        res = conv(res, f"body.{groups}") + h
        up = F.pixel_shuffle(conv(res, "tail.0.0"), SCALE)
        return (conv(up, "tail.1") + mean)[0]


def quantize(rgb: torch.Tensor) -> torch.Tensor:
    """The authors' ``utility.quantize`` at ``rgb_range`` 255: clamp to
    [0, 255], round, as uint8."""
    return rgb.clamp(0, 255).round().to(torch.uint8)
