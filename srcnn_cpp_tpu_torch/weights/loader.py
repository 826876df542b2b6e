"""Checkpoint loading for the SRCNN model family, as torch tensors.

The pretrained checkpoint is ``srcnn955.npz`` beside this file: the
reference's compiled-in src/convdata.h as an artifact, a copy of the JAX
package's ``srcnn_cpp_tpu/weights/srcnn955.npz`` (``tests/
test_torch_models_ckpt.py`` holds the two equal).  It is read with NumPy.

Two rules every network's weights share live here too: a value derived
from weights is cached per weights object until a tensor changes
(:func:`derived`), and the paths that reach SRCNN's halo only refuse any
other network (:func:`srcnn_only`).
"""

from __future__ import annotations

import dataclasses
import weakref
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

_KEYS = ("conv1_w", "conv1_b", "conv2_w", "conv2_b", "conv3_w", "conv3_b")
#: the canonical configuration ``(n1, n2, f1, f2, f3)`` of the checkpoint
#: and of the fused kernels (reference src/convdata.h:4-16)
CANONICAL = (64, 32, 9, 1, 5)
#: the canonical network's receptive-field radius: conv1's 4 + conv3's 2
HALO = sum(f // 2 for f in CANONICAL[2:])


def weights_npz() -> Path:
    """Path of the pretrained SRCNN 9-5-5 checkpoint shipped with the port."""
    return Path(__file__).with_name("srcnn955.npz")


def family_shapes(n1: int, n2: int, f1: int, f2: int, f3: int
                  ) -> dict[str, tuple[int, ...]]:
    """The parameter shapes of SRCNN ``f1-f2-f3`` with ``n1``/``n2`` maps."""
    return {"conv1_w": (n1, 1, f1, f1), "conv1_b": (n1,),
            "conv2_w": (n2, n1, f2, f2), "conv2_b": (n2,),
            "conv3_w": (1, n2, f3, f3), "conv3_b": (1,)}


def infer_config(shapes: Mapping[str, tuple[int, ...]]
                 ) -> tuple[int, int, int, int, int]:
    """``(n1, n2, f1, f2, f3)`` of a set of parameter shapes; raises
    ValueError when they are no member of the family."""
    try:
        n1, _, f1, _ = shapes["conv1_w"]
        n2, _, f2, _ = shapes["conv2_w"]
        f3 = shapes["conv3_w"][2]
    except (KeyError, ValueError, IndexError) as e:
        raise ValueError(f"not SRCNN parameter shapes: {dict(shapes)}") from e
    want = family_shapes(n1, n2, f1, f2, f3)
    for k in _KEYS:
        if tuple(shapes[k]) != want[k]:
            raise ValueError(f"{k}: shape {tuple(shapes[k])}, expected "
                             f"{want[k]} for n1={n1} n2={n2} "
                             f"{f1}-{f2}-{f3}")
    return n1, n2, f1, f2, f3


@dataclasses.dataclass(frozen=True, eq=False)
class SRCNNWeights:
    """SRCNN parameters in OIHW filter layout ``[out_c, in_c, kh, kw]``;
    shapes as in :func:`family_shapes` (the checkpoint's: 9-5-5, 64/32)."""

    conv1_w: torch.Tensor  # (n1, 1, f1, f1)
    conv1_b: torch.Tensor  # (n1,)
    conv2_w: torch.Tensor  # (n2, n1, f2, f2)
    conv2_b: torch.Tensor  # (n2,)
    conv3_w: torch.Tensor  # (1, n2, f3, f3)
    conv3_b: torch.Tensor  # (1,)

    def to(self, device) -> "SRCNNWeights":
        return SRCNNWeights(**{k: getattr(self, k).to(device) for k in _KEYS})

    def as_dict(self) -> dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in _KEYS}

    @property
    def device(self) -> torch.device:
        return self.conv1_w.device

    @property
    def config(self) -> tuple[int, int, int, int, int]:
        """``(n1, n2, f1, f2, f3)``."""
        return infer_config({k: tuple(v.shape)
                             for k, v in self.as_dict().items()})


def from_jax_params(w: Any, device="cpu") -> SRCNNWeights:
    """A JAX ``SRCNNWeights`` (or a mapping of arrays) of any member of the
    family -> the port's weights.

    Arrays are read with ``np.asarray``, so JAX arrays, NumPy arrays and
    nested lists all work and no JAX import happens here.  Shapes that match
    no member of the family raise ValueError.
    """
    get = w.__getitem__ if isinstance(w, Mapping) else \
        (lambda k: getattr(w, k))
    arrays = {k: np.asarray(get(k), dtype=np.float32) for k in _KEYS}
    infer_config({k: a.shape for k, a in arrays.items()})
    return SRCNNWeights(**{k: torch.from_numpy(a.copy()).to(device)
                           for k, a in arrays.items()})


def load_weights(path: Path | str | None = None, device="cpu") -> SRCNNWeights:
    """Load an npz checkpoint (the pretrained SRCNN 9-5-5 one when ``path``
    is None) as float32 tensors."""
    with np.load(Path(path) if path is not None else weights_npz()) as z:
        return from_jax_params({k: z[k] for k in _KEYS}, device)


_DEFAULT: dict = {}
_DERIVED: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def derived(weights, slot, tensors, build, *args):
    """``build(*args)``, a value derived from ``weights`` (a copy, a packed
    buffer), kept per weights object and ``slot`` while ``tensors``, those
    it is derived from, are unchanged: the same storage and no in-place
    edit since (``data_ptr()``, ``_version``).  Built again otherwise."""
    key = tuple((t.data_ptr(), t._version) for t in tensors)
    per = _DERIVED.get(weights)
    if per is None:
        per = _DERIVED[weights] = {}
    hit = per.get(slot)
    if hit is None or hit[0] != key:
        hit = per[slot] = (key, build(*args))
    return hit[1]


def srcnn_only(weights, where: str) -> None:
    """TypeError unless ``weights`` are SRCNN's (its parameter names; None
    is its checkpoint): ``where`` reaches SRCNN's :data:`HALO` pixels only.
    The message names the halo that the weights' network states
    (``halo``, a class attribute), where it states one."""
    if weights is None or all(hasattr(weights, k) for k in _KEYS):
        return
    name, halo = type(weights).__name__, getattr(weights, "halo", None)
    got = (f"{name} needs a {halo}-pixel halo ({2 * halo + 1}x{2 * halo + 1}"
           f" receptive field), which it lacks" if halo is not None
           else f"got {name}")
    raise TypeError(f"{where} takes SRCNN weights only: its halo is SRCNN's "
                    f"{HALO} pixels; {got}")


def _canonical(device) -> torch.device:
    """``device`` with its index: ``cuda`` names the current CUDA device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def weights_on(weights, device):
    """``weights``, an :class:`SRCNNWeights` or a ``VDSRWeights`` (the
    pretrained SRCNN checkpoint when None), on ``device``.

    The checkpoint is loaded once per process and device.  Weights that
    live on ``device`` (``cuda`` and ``cuda:<current>`` are one device)
    come back as they are; others are copied once per device and the copy
    is kept while their tensors are unchanged (:func:`derived`), so the
    kernels' packed weights, cached per weights object, are built once.
    """
    device = _canonical(device)
    if weights is None:
        hit = _DEFAULT.get(device)
        if hit is None:
            hit = _DEFAULT[device] = load_weights(device=device)
        return hit
    if weights.device == device:
        return weights
    return derived(weights, device, weights.as_dict().values(), weights.to,
                   device)
