"""RCAN weights as torch tensors (Zhang, Li, Li, Wang, Zhong, Fu, ECCV 2018,
arXiv:1807.02758; the authors' ``RCAN_TrainCode/code/model/rcan.py``).

RCAN x2 (``RCAN_BIX2``) on RGB in [0, 255]: the mean shift, a head conv
3->64, 10 residual groups of 20 residual channel-attention blocks (RCAB)
and a conv each, a body conv and the long skip, then the upsampler (a conv
64->256 and ``PixelShuffle(2)``) and a tail conv 64->3 at the output size.
All convs are 3x3, zero-padded, with bias, except channel attention's two
1x1 convs (64->4->64, reduction 16).  The parameters carry the authors'
state-dict names (``head.0.weight``, ``body.{g}.body.{b}.body.{0,2}.weight``,
``body.{g}.body.{b}.body.3.conv_du.{0,2}.weight``, ``body.{g}.body.20.weight``,
``body.10.weight``, ``tail.0.0.weight``, ``tail.1.weight`` and each
``.bias``), so a converted ``RCAN_BIX2.pt`` saved as an npz loads by name;
the mean shift's fixed 1x1 convs are not parameters here (:data:`RGB_MEAN`).

No trained checkpoint ships with the port.  The benchmark serves seeded
weights from a recipe (``portbench/configs/rcan_x2_seeded.jsonl``): a seed
and each tensor's standard deviation in the authors' key order, which
:func:`expand_recipe` turns into float32 arrays with NumPy's PCG64.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
from pathlib import Path

import numpy as np
import torch

#: the published network: residual groups, RCABs a group, feature maps,
#: channel attention's reduction, the upscale factor and the colours
GROUPS, BLOCKS, CHANNELS, REDUCTION, SCALE, COLORS = 10, 20, 64, 16, 2, 3
#: ``MeanShift``'s RGB mean (of DIV2K) over ``rgb_range`` 255
RGB_MEAN, RGB_RANGE = (0.4488, 0.4371, 0.4040), 255


def rcab_prefix(g: int, b: int) -> str:
    """The key prefix of RCAB ``b`` of group ``g``."""
    return f"body.{g}.body.{b}.body"


def rcan_shapes(groups: int = GROUPS, blocks: int = BLOCKS
                ) -> dict[str, tuple[int, ...]]:
    """Each parameter's shape, in the authors' key order, of RCAN with
    ``groups`` residual groups of ``blocks`` RCABs at the published widths."""
    c, r = CHANNELS, CHANNELS // REDUCTION
    convs = [("head.0", (c, COLORS, 3, 3))]
    for g in range(groups):
        for b in range(blocks):
            p = rcab_prefix(g, b)
            convs += [(f"{p}.0", (c, c, 3, 3)), (f"{p}.2", (c, c, 3, 3)),
                      (f"{p}.3.conv_du.0", (r, c, 1, 1)),
                      (f"{p}.3.conv_du.2", (c, r, 1, 1))]
        convs.append((f"body.{g}.body.{blocks}", (c, c, 3, 3)))
    convs += [(f"body.{groups}", (c, c, 3, 3)),
              ("tail.0.0", (SCALE * SCALE * c, c, 3, 3)),
              ("tail.1", (COLORS, c, 3, 3))]
    out = {}
    for name, shape in convs:
        out[f"{name}.weight"], out[f"{name}.bias"] = shape, shape[:1]
    return out


def _count(keys, pattern: str) -> int:
    return sum(bool(re.fullmatch(pattern, k)) for k in keys)


@dataclasses.dataclass(frozen=True, eq=False)
class RCANWeights:
    """RCAN parameters by the authors' names (:func:`rcan_shapes`), weights
    in OIHW; ``groups`` and ``blocks`` follow from the names, so a smaller
    preset of the same widths is the same container."""

    params: dict
    #: channel attention pools over the whole frame: every output pixel
    #: depends on every input pixel
    halo = math.inf

    def __post_init__(self):
        got = {k: tuple(v.shape) for k, v in self.params.items()}
        if not self.groups or not self.blocks \
                or got != rcan_shapes(self.groups, self.blocks):
            raise ValueError(f"not RCAN parameter shapes: "
                             f"{len(got)} tensors")

    @property
    def groups(self) -> int:
        return _count(self.params, r"body\.\d+\.body\.0\.body\.0\.weight")

    @property
    def blocks(self) -> int:
        return _count(self.params, r"body\.0\.body\.\d+\.body\.0\.weight")

    def pair(self, prefix: str) -> tuple[torch.Tensor, torch.Tensor]:
        """``(weight, bias)`` of the conv named ``prefix``."""
        return self.params[f"{prefix}.weight"], self.params[f"{prefix}.bias"]

    def to(self, device) -> "RCANWeights":
        return RCANWeights({k: v.to(device) for k, v in self.params.items()})

    def as_dict(self) -> dict[str, torch.Tensor]:
        return dict(self.params)

    @property
    def device(self) -> torch.device:
        return self.params["head.0.weight"].device


def read_recipe(path: Path | str) -> tuple[int, list]:
    """``(seed, tensors)`` of a recipe file: a JSON line holding ``seed``,
    then one JSON line ``[name, shape, std]`` (or ``[name, shape, std,
    mean]``) a tensor."""
    head, *rows = Path(path).read_text().splitlines()
    return int(json.loads(head)["seed"]), [json.loads(r) for r in rows]


def expand_recipe(seed: int, tensors: list) -> dict[str, np.ndarray]:
    """A seeded checkpoint recipe -> its float32 arrays: NumPy's PCG64
    seeded with ``seed`` draws, tensor after tensor in the recipe's order,
    ``standard_normal(shape) * std + mean`` (rounded to float32; a row
    ``[name, shape, std]`` has mean 0, SwinIR's ``[name, shape, std,
    mean]`` gives it); a tensor of std 0 is its mean and draws nothing."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape, std, *mean in tensors:
        m = mean[0] if mean else 0.0
        out[name] = (rng.standard_normal(shape) * std + m) \
            .astype(np.float32) if std else np.full(shape, m, np.float32)
    return out


def load_rcan_weights(path: Path | str, device="cpu") -> RCANWeights:
    """An RCAN checkpoint as float32 tensors on ``device``: a seeded recipe
    (``.jsonl``, :func:`expand_recipe`) or an npz of the authors' keys
    (``head.*``, ``body.*``, ``tail.*``; others, such as the mean shift's,
    are ignored).  Anything else raises ValueError."""
    path = Path(path)
    if path.suffix == ".jsonl":
        arrays = expand_recipe(*read_recipe(path))
    else:
        with np.load(path) as z:
            arrays = {k: np.asarray(z[k], np.float32) for k in z.files
                      if k.split(".")[0] in ("head", "body", "tail")}
    if "head.0.weight" not in arrays:
        raise ValueError(f"{path}: no RCAN checkpoint (lacks head.0.weight)")
    return RCANWeights({k: torch.from_numpy(a.copy()).to(device)
                        for k, a in arrays.items()})
