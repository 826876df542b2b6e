"""Checkpoint loading for the SRCNN 9-5-5 model, as torch tensors.

The checkpoint is the JAX package's ``srcnn_cpp_tpu/weights/srcnn955.npz``
(the reference's compiled-in src/convdata.h as an artifact).  It is read by
path with NumPy: :func:`importlib.util.find_spec` locates the package
directory without executing the package, whose ``weights`` module imports
``jax`` when it is installed.
"""

from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

_KEYS = ("conv1_w", "conv1_b", "conv2_w", "conv2_b", "conv3_w", "conv3_b")
_SHAPES = {"conv1_w": (64, 1, 9, 9), "conv1_b": (64,),
           "conv2_w": (32, 64, 1, 1), "conv2_b": (32,),
           "conv3_w": (1, 32, 5, 5), "conv3_b": (1,)}


def weights_npz() -> Path:
    """Path of the pretrained checkpoint shipped with the JAX package."""
    spec = importlib.util.find_spec("srcnn_cpp_tpu")
    if spec is None or not spec.submodule_search_locations:
        raise FileNotFoundError(
            "package srcnn_cpp_tpu (which ships weights/srcnn955.npz) "
            "is not installed")
    return Path(next(iter(spec.submodule_search_locations))) / \
        "weights" / "srcnn955.npz"


@dataclasses.dataclass(frozen=True, eq=False)
class SRCNNWeights:
    """SRCNN 9-5-5 parameters in OIHW filter layout ``[out_c, in_c, kh, kw]``."""

    conv1_w: torch.Tensor  # (64, 1, 9, 9)
    conv1_b: torch.Tensor  # (64,)
    conv2_w: torch.Tensor  # (32, 64, 1, 1)
    conv2_b: torch.Tensor  # (32,)
    conv3_w: torch.Tensor  # (1, 32, 5, 5)
    conv3_b: torch.Tensor  # (1,)

    def to(self, device) -> "SRCNNWeights":
        return SRCNNWeights(**{k: getattr(self, k).to(device) for k in _KEYS})

    def as_dict(self) -> dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in _KEYS}

    @property
    def device(self) -> torch.device:
        return self.conv1_w.device


def from_jax_params(w: Any, device="cpu") -> SRCNNWeights:
    """A JAX ``SRCNNWeights`` (or a mapping of arrays) -> the port's weights.

    Arrays are read with ``np.asarray``, so JAX arrays, NumPy arrays and
    nested lists all work and no JAX import happens here.
    """
    get = w.__getitem__ if isinstance(w, Mapping) else \
        (lambda k: getattr(w, k))
    arrays = {}
    for k in _KEYS:
        a = np.asarray(get(k), dtype=np.float32)
        if a.shape != _SHAPES[k]:
            raise ValueError(f"{k}: shape {a.shape}, expected {_SHAPES[k]}")
        arrays[k] = torch.from_numpy(a.copy()).to(device)
    return SRCNNWeights(**arrays)


def load_weights(path: Path | str | None = None, device="cpu") -> SRCNNWeights:
    """Load the pretrained SRCNN 9-5-5 checkpoint as float32 tensors."""
    with np.load(Path(path) if path is not None else weights_npz()) as z:
        return from_jax_params({k: z[k] for k in _KEYS}, device)
