"""Write ``rcan_x2_seeded.jsonl``, the seeded checkpoint recipe of
``rcan_x2_1080p_to_4k``.

    python portbench/configs/make_rcan_x2.py [out.jsonl]

RCAN x2 at its published shapes (arXiv:1807.02758, ``RCAN_BIX2``): 10
residual groups of 20 RCABs, 64 maps, reduction 16, 15,444,643 parameters
(62 MB in float32), too large to keep in the tree as an npz.  The recipe
is the seed and each tensor's standard deviation, in the authors' key
order: a JSON line ``{"model": ..., "seed": ...}``, then a line ``[name,
shape, std]`` for each tensor.  The program's loader and the reference
each expand it with NumPy's PCG64 to the same float32 arrays
(``standard_normal(shape) * std``; a std of 0 is zeros and draws
nothing).

He-normal weights (std ``sqrt(2 / fan_in)``, He et al., ICCV 2015) and zero
biases, then four scales, so that 200 blocks of random weights neither
blow up nor vanish and the output is an image-like field about the mean:

* each RCAB's second conv times :data:`RCAB_OUT_SCALE` and each group's
  last conv times :data:`GROUP_OUT_SCALE`: the body's feature std stays
  within 4x of the head's across all 200 blocks;
* channel attention's first 1x1 conv times :data:`CA_SCALE`: the
  attention ``s`` spreads over (0, 1) (10 % to 90 % over 0.30 to 0.70)
  rather than saturating at 0 and 1, so it weighs every channel;
* the tail conv times :data:`TAIL_SCALE`: the output before the mean is
  added has a std of tens of LSB, and at most 1 % of the output bytes
  clamp on the benchmark's frames.

The readings behind the scales are in the configuration's ``assumed``.
The same constants give the same bytes.
"""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path

SEED = 1807_02758
GROUPS, BLOCKS, CHANNELS, REDUCTION = 10, 20, 64, 16
RCAB_OUT_SCALE = 0.1
GROUP_OUT_SCALE = 0.1
TAIL_SCALE = 0.12
CA_SCALE = 0.1
OUT = Path(__file__).with_name("rcan_x2_seeded.jsonl")


def convs(groups: int = GROUPS, blocks: int = BLOCKS) -> list:
    """``(name, shape, weight scale over He's)`` of each conv, in the
    authors' order."""
    c, r = CHANNELS, CHANNELS // REDUCTION
    out = [("head.0", [c, 3, 3, 3], 1.0)]
    for g in range(groups):
        for b in range(blocks):
            p = f"body.{g}.body.{b}.body"
            out += [(f"{p}.0", [c, c, 3, 3], 1.0),
                    (f"{p}.2", [c, c, 3, 3], RCAB_OUT_SCALE),
                    (f"{p}.3.conv_du.0", [r, c, 1, 1], CA_SCALE),
                    (f"{p}.3.conv_du.2", [c, r, 1, 1], 1.0)]
        out.append((f"body.{g}.body.{blocks}", [c, c, 3, 3],
                    GROUP_OUT_SCALE))
    out += [(f"body.{groups}", [c, c, 3, 3], 1.0),
            ("tail.0.0", [4 * c, c, 3, 3], 1.0),
            ("tail.1", [3, c, 3, 3], TAIL_SCALE)]
    return out


def recipe(groups: int = GROUPS, blocks: int = BLOCKS) -> dict:
    tensors = []
    for name, shape, scale in convs(groups, blocks):
        fan_in = shape[1] * shape[2] * shape[3]
        tensors.append([f"{name}.weight", shape,
                        scale * math.sqrt(2.0 / fan_in)])
        tensors.append([f"{name}.bias", shape[:1], 0.0])
    return {"model": "RCAN_BIX2 (arXiv:1807.02758), seeded: He-normal "
                     "weights, zero biases; see make_rcan_x2.py",
            "seed": SEED, "tensors": tensors}


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
