"""SwinIR weights as torch tensors (Liang, Cao, Sun, Zhang, Van Gool,
Timofte, ICCVW 2021, arXiv:2108.10257; the authors'
``models/network_swinir.py``).

SwinIR-M for classical super-resolution x2 (``001_classicalSR_DF2K_s64w8_
SwinIR-M_x2.pth``): RGB in [0, 1] less the mean, a conv 3->180, the patch
LayerNorm, 6 residual Swin transformer blocks (RSTB) of 6 Swin transformer
layers (STL) and a 3x3 conv 180->180 each, a final LayerNorm, a conv
180->180 with the long skip, a conv 180->64 and LeakyReLU, the upsampler
(a conv 64->256 and ``PixelShuffle(2)``) and a conv 64->3 at the output
size.  An STL is window attention over 8x8 windows (6 heads of 30, the
relative position bias, the shift of 4 on odd layers) after LayerNorm, and
an MLP 180->360->180 with GELU after LayerNorm, each with its residual.
The parameters carry the authors' state-dict names (``conv_first.*``,
``patch_embed.norm.*``, ``layers.{r}.residual_group.blocks.{i}.{norm1,
attn.relative_position_bias_table, attn.qkv, attn.proj, norm2, mlp.fc1,
mlp.fc2}.*``, ``layers.{r}.conv.*``, ``norm.*``, ``conv_after_body.*``,
``conv_before_upsample.0.*``, ``upsample.0.*``, ``conv_last.*``), so the
authors' checkpoint converted to an npz of its ``params`` loads by name;
the ``relative_position_index`` and ``attn_mask`` buffers are computed,
not loaded.

No trained checkpoint ships with the port.  The benchmark serves seeded
weights from a recipe (``portbench/configs/swinir_x2_seeded.jsonl``): a
seed and each tensor's standard deviation and mean in the authors' key
order, which :func:`.rcan.expand_recipe` turns into float32 arrays.
"""

from __future__ import annotations

import dataclasses
import math
import re
from pathlib import Path

import numpy as np
import torch

from .rcan import expand_recipe, read_recipe

#: the published network: RSTBs, STLs an RSTB, the embedding width, heads,
#: the window, the MLP's hidden width, the upsampler's maps, the upscale
#: factor and the colours
GROUPS, DEPTH, DIM, HEADS, WINDOW = 6, 6, 180, 6, 8
HIDDEN, FEAT, SCALE, COLORS = 360, 64, 2, 3
#: the shift of odd layers, LayerNorm's epsilon, LeakyReLU's slope
SHIFT, LN_EPS, LEAKY = WINDOW // 2, 1e-5, 0.01
#: the RGB mean and ``img_range``
RGB_MEAN, IMG_RANGE = (0.4488, 0.4371, 0.4040), 1.0
#: the relative position bias table's rows: (2 window - 1) squared
TABLE = (2 * WINDOW - 1) ** 2


def stl_prefix(r: int, i: int) -> str:
    """The key prefix of STL ``i`` of RSTB ``r``."""
    return f"layers.{r}.residual_group.blocks.{i}"


def swinir_shapes(groups: int = GROUPS, depth: int = DEPTH, dim: int = DIM,
                  heads: int = HEADS) -> dict[str, tuple[int, ...]]:
    """Each parameter's shape, in the authors' key order, of SwinIR with
    ``groups`` RSTBs of ``depth`` STLs at width ``dim`` with ``heads``
    heads and an MLP of 2 ``dim`` maps (``mlp_ratio`` 2)."""
    hidden = 2 * dim
    out: dict[str, tuple[int, ...]] = {}

    def add(name, weight, bias=True):
        out[f"{name}.weight"] = weight
        if bias:
            out[f"{name}.bias"] = weight[:1]

    add("conv_first", (dim, COLORS, 3, 3))
    add("patch_embed.norm", (dim,))
    for r in range(groups):
        for i in range(depth):
            p = stl_prefix(r, i)
            add(f"{p}.norm1", (dim,))
            out[f"{p}.attn.relative_position_bias_table"] = (TABLE, heads)
            add(f"{p}.attn.qkv", (3 * dim, dim))
            add(f"{p}.attn.proj", (dim, dim))
            add(f"{p}.norm2", (dim,))
            add(f"{p}.mlp.fc1", (hidden, dim))
            add(f"{p}.mlp.fc2", (dim, hidden))
        add(f"layers.{r}.conv", (dim, dim, 3, 3))
    add("norm", (dim,))
    add("conv_after_body", (dim, dim, 3, 3))
    add("conv_before_upsample.0", (FEAT, dim, 3, 3))
    add("upsample.0", (SCALE * SCALE * FEAT, FEAT, 3, 3))
    add("conv_last", (COLORS, FEAT, 3, 3))
    return out


def _count(keys, pattern: str) -> int:
    return sum(bool(re.fullmatch(pattern, k)) for k in keys)


@dataclasses.dataclass(frozen=True, eq=False)
class SwinIRWeights:
    """SwinIR parameters by the authors' names (:func:`swinir_shapes`),
    convs in OIHW and linears ``[out, in]``; the depth, width and heads
    follow from the shapes, so a smaller preset is the same container."""

    params: dict
    #: a conv after 36 windowed layers: no receptive field that tiling
    #: could honour cheaply, so the whole frame is its halo
    halo = math.inf

    def __post_init__(self):
        got = {k: tuple(v.shape) for k, v in self.params.items()}
        if "conv_first.weight" not in got or not self.groups \
                or not self.depth \
                or got != swinir_shapes(self.groups, self.depth, self.dim,
                                        self.heads):
            raise ValueError(f"not SwinIR parameter shapes: "
                             f"{len(got)} tensors")

    @property
    def groups(self) -> int:
        return _count(self.params, r"layers\.\d+\.conv\.weight")

    @property
    def depth(self) -> int:
        return _count(self.params,
                      r"layers\.0\.residual_group\.blocks\.\d+\.norm1\.weight")

    @property
    def dim(self) -> int:
        return int(self.params["conv_first.weight"].shape[0])

    @property
    def heads(self) -> int:
        t = self.params.get(f"{stl_prefix(0, 0)}.attn."
                            "relative_position_bias_table")
        return int(t.shape[1]) if t is not None else 0

    @property
    def hidden(self) -> int:
        t = self.params.get(f"{stl_prefix(0, 0)}.mlp.fc1.weight")
        return int(t.shape[0]) if t is not None else 0

    def pair(self, prefix: str) -> tuple[torch.Tensor, torch.Tensor]:
        """``(weight, bias)`` of the layer named ``prefix``."""
        return self.params[f"{prefix}.weight"], self.params[f"{prefix}.bias"]

    def to(self, device) -> "SwinIRWeights":
        return SwinIRWeights({k: v.to(device)
                              for k, v in self.params.items()})

    def as_dict(self) -> dict[str, torch.Tensor]:
        return dict(self.params)

    @property
    def device(self) -> torch.device:
        return self.params["conv_first.weight"].device


#: the top-level names of the authors' parameters
_TOP = ("conv_first", "patch_embed", "layers", "norm", "conv_after_body",
        "conv_before_upsample", "upsample", "conv_last")


def load_swinir_weights(path: Path | str, device="cpu") -> SwinIRWeights:
    """A SwinIR checkpoint as float32 tensors on ``device``: a seeded recipe
    (``.jsonl``, :func:`.rcan.expand_recipe`) or an npz of the authors' keys
    (others, such as the ``relative_position_index`` and ``attn_mask``
    buffers, are ignored).  Anything else raises ValueError."""
    path = Path(path)
    if path.suffix == ".jsonl":
        arrays = expand_recipe(*read_recipe(path))
    else:
        with np.load(path) as z:
            arrays = {k: np.asarray(z[k], np.float32) for k in z.files
                      if k.split(".")[0] in _TOP
                      and not k.endswith(("relative_position_index",
                                          "attn_mask"))}
    if "conv_first.weight" not in arrays:
        raise ValueError(f"{path}: no SwinIR checkpoint (lacks "
                         f"conv_first.weight)")
    return SwinIRWeights({k: torch.from_numpy(a.copy()).to(device)
                          for k, a in arrays.items()})
