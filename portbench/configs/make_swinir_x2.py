"""Write ``swinir_x2_seeded.jsonl``, the seeded checkpoint recipe of
``swinir_x2_1080p_to_4k``.

    python portbench/configs/make_swinir_x2.py [out.jsonl]

SwinIR-M x2 at its published shapes (arXiv:2108.10257, the authors'
``001_classicalSR_DF2K_s64w8_SwinIR-M_x2.pth``): 6 RSTBs of 6 STLs at 180
channels, 6 heads, window 8, MLP ratio 2, 11,752,487 parameters (47 MB in
float32), too large to keep in the tree as an npz.  The recipe is the seed
and each tensor's standard deviation and mean, in the authors' key order:
a JSON line ``{"model": ..., "seed": ...}``, then a line ``[name, shape,
std, mean]`` for each tensor.  The program's loader and the reference
each expand it with NumPy's PCG64 to the same float32 arrays
(``standard_normal(shape) * std + mean``; a std of 0 is the mean and
draws nothing).

The authors' init (``SwinIR._init_weights``): Linear weights and the
relative position bias tables trunc-normal with std 0.02 (drawn normal
here: timm's truncation at +-2 never binds at that std), Linear biases
zero, LayerNorm (1, 0), the convs PyTorch's default (drawn normal with the
std of its uniform, ``1 / sqrt(3 fan_in)``, biases alike).  On top of it,
so that the seeded network is not degenerate:

* ``qkv`` times :data:`QKV_SCALE`: the attention logits spread by about 1
  within a window, so the bias and the mask move the softmax;
* the bias tables times :data:`TABLE_SCALE`: the bias is of the logits'
  order;
* LayerNorm gains ``1 + N(0, LN_STD)`` and biases ``N(0, LN_STD)``
  (:data:`LN_STD`), away from (1, 0), so that a dropped affine shows;
* each RSTB's conv times :data:`RSTB_CONV_SCALE`: the body's token std
  stays within 4x of the patch embedding's across all 36 layers;
* ``conv_last`` times :data:`TAIL_SCALE`: the output before the mean has a
  std of tens of LSB, and at most 1 % of the output bytes clamp on the
  benchmark's frames.

The readings behind the scales are in the configuration's ``assumed``.
The same constants give the same bytes.
"""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path

SEED = 2108_10257
GROUPS, DEPTH, DIM, HEADS, WINDOW, FEAT = 6, 6, 180, 6, 8, 64
LINEAR_STD = 0.02
QKV_SCALE = 8.0
TABLE_SCALE = 25.0
LN_STD = 0.2
RSTB_CONV_SCALE = 0.5
TAIL_SCALE = 1.0
OUT = Path(__file__).with_name("swinir_x2_seeded.jsonl")


def _conv(name: str, cout: int, cin: int, scale: float = 1.0) -> list:
    std = 1.0 / math.sqrt(3.0 * cin * 9)
    return [[f"{name}.weight", [cout, cin, 3, 3], scale * std, 0.0],
            [f"{name}.bias", [cout], std, 0.0]]


def _linear(name: str, cout: int, cin: int, scale: float = 1.0) -> list:
    return [[f"{name}.weight", [cout, cin], scale * LINEAR_STD, 0.0],
            [f"{name}.bias", [cout], 0.0, 0.0]]


def _norm(name: str, dim: int) -> list:
    return [[f"{name}.weight", [dim], LN_STD, 1.0],
            [f"{name}.bias", [dim], LN_STD, 0.0]]


def tensors(groups: int = GROUPS, depth: int = DEPTH, dim: int = DIM,
            heads: int = HEADS) -> list:
    """``[name, shape, std, mean]`` of each tensor, in the authors'
    order."""
    out = _conv("conv_first", dim, 3) + _norm("patch_embed.norm", dim)
    for r in range(groups):
        for i in range(depth):
            p = f"layers.{r}.residual_group.blocks.{i}"
            out += _norm(f"{p}.norm1", dim)
            out.append([f"{p}.attn.relative_position_bias_table",
                        [(2 * WINDOW - 1) ** 2, heads],
                        TABLE_SCALE * LINEAR_STD, 0.0])
            out += _linear(f"{p}.attn.qkv", 3 * dim, dim, QKV_SCALE)
            out += _linear(f"{p}.attn.proj", dim, dim)
            out += _norm(f"{p}.norm2", dim)
            out += _linear(f"{p}.mlp.fc1", 2 * dim, dim)
            out += _linear(f"{p}.mlp.fc2", dim, 2 * dim)
        out += _conv(f"layers.{r}.conv", dim, dim, RSTB_CONV_SCALE)
    out += _norm("norm", dim)
    out += _conv("conv_after_body", dim, dim)
    out += _conv("conv_before_upsample.0", FEAT, dim)
    out += _conv("upsample.0", 4 * FEAT, FEAT)
    out += _conv("conv_last", 3, FEAT, TAIL_SCALE)
    return out


def recipe(groups: int = GROUPS, depth: int = DEPTH, dim: int = DIM,
           heads: int = HEADS) -> dict:
    return {"model": "SwinIR-M x2 (arXiv:2108.10257), seeded: the authors' "
                     "init with the scales of make_swinir_x2.py",
            "seed": SEED, "tensors": tensors(groups, depth, dim, heads)}


def write(path: Path, r: dict) -> None:
    head = json.dumps({"model": r["model"], "seed": r["seed"]})
    path.write_text("\n".join([head, *map(json.dumps, r["tensors"])])
                    + "\n")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    write(Path(argv[0]) if argv else OUT, recipe())
    return 0


if __name__ == "__main__":
    sys.exit(main())
