"""Checkpoint save/restore (the runtime counterpart of convdata.h).

The port of ``srcnn_cpp_tpu/weights/checkpoint.py``.  The reference's only
checkpoint is the weight header compiled into the binary (reference
src/convdata.h included at srcnn.cpp:31); here checkpoints are artifacts:

* :func:`save_npz` / :func:`.loader.load_weights` — the portable .npz format
  (the pretrained checkpoint ships as ``srcnn955.npz``), readable by both
  packages;
* :func:`save_checkpoint` / :func:`load_checkpoint` — a training run's state
  (weights, the optimizer's ``state_dict``, the step and the losses) in one
  ``torch.save`` file, read back with ``torch.load(weights_only=True)``; it
  takes the place of the JAX package's Orbax checkpoints;
* :func:`export_convdata_header` — writes a C header in the reference's
  layout, so a trained model can be carried back to the reference binary;
  its text is byte-identical to the JAX package's export of the same
  weights.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch

from .loader import _KEYS, SRCNNWeights, load_weights  # noqa: F401

__all__ = ["save_npz", "load_weights", "save_checkpoint", "load_checkpoint",
           "export_convdata_header"]


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32, copy=False)


def save_npz(path, weights: SRCNNWeights) -> None:
    np.savez_compressed(
        Path(path), **{k: _numpy(getattr(weights, k)) for k in _KEYS})


def save_checkpoint(path, weights: SRCNNWeights,
                    optimizer_state: dict | None = None, step: int = 0,
                    losses: list[float] | None = None) -> None:
    """Write a training run's state to ``path`` (``torch.save``): the
    weights (moved to the CPU), the optimizer's ``state_dict``, the number
    of steps taken and the loss of each."""
    torch.save({"weights": {k: getattr(weights, k).detach().cpu()
                            for k in _KEYS},
                "optimizer": optimizer_state, "step": int(step),
                "losses": [float(v) for v in (losses or [])]}, Path(path))


def load_checkpoint(path, device="cpu") -> dict[str, Any]:
    """Read a :func:`save_checkpoint` file: ``{"weights": SRCNNWeights on
    device, "optimizer": state_dict or None, "step": int, "losses": list}``.
    Loads tensors and plain containers only (``weights_only=True``)."""
    ck = torch.load(Path(path), map_location="cpu", weights_only=True)
    ck["weights"] = SRCNNWeights(**ck["weights"]).to(device)
    return ck


def export_convdata_header(path, weights: SRCNNWeights) -> None:
    """Write weights as a convdata.h-layout C header (reference interop).

    Emits the reference's exact typedef names and array shapes
    (convdata.h:4-16) — ``ConvKernel64_99[64][9][9]``,
    ``ConvKernel32x64[32][64]``, ``ConvKernel32_55[32][5][5]`` — with
    nested-brace initializers, so the exported header drop-in replaces
    convdata.h in a reference build (the conv kernels index
    ``kernel[fc][i][j]``, srcnn.cpp:297,316,229).
    """
    w = {k: _numpy(getattr(weights, k)) for k in _KEYS}
    c1w = w["conv1_w"].reshape(64, 9, 9)
    c2w = w["conv2_w"].reshape(32, 64)
    c3w = w["conv3_w"].reshape(32, 5, 5)

    def fmt(v):
        # shortest decimal that round-trips the float32 value, always with
        # a decimal point/exponent so the `f` suffix stays a valid literal
        s = np.format_float_positional(np.float32(v), unique=True, trim="0")
        if "." not in s and "e" not in s:
            s += ".0"
        return s + "f"

    def fmt_vec(row, indent):
        return indent + "{ " + ", ".join(fmt(v) for v in row) + " }"

    def fmt_2d(rows, indent="    "):
        return ",\n".join(fmt_vec(r, indent) for r in rows)

    def fmt_3d(blocks):
        return ",\n".join(
            "    {\n" + fmt_2d(b, "        ") + "\n    }" for b in blocks)

    # the first line names the JAX package, as its export does, so the two
    # exports of one checkpoint are the same file
    lines = [
        "/* Auto-exported SRCNN 9-5-5 checkpoint (srcnn_cpp_tpu). */",
        "#ifndef __CONVDATA_H__",
        "#define __CONVDATA_H__",
        "",
        "#define CONV1_FILTERS       64",
        "#define CONV2_FILTERS       32",
        "",
        "typedef float KernelMat99[9][9];",
        "typedef float ConvKernel64_99[CONV1_FILTERS][9][9];",
        "typedef float ConvKernel32x64[CONV2_FILTERS][CONV1_FILTERS];",
        "typedef float ConvKernel32_55[CONV2_FILTERS][5][5];",
        "typedef float ConvKernel1[CONV1_FILTERS];",
        "typedef float ConvKernel2[CONV2_FILTERS];",
        "typedef float ConvKernel21[CONV2_FILTERS][CONV1_FILTERS];",
        "",
        "const ConvKernel1 biases_conv1 = {",
        "    " + ", ".join(fmt(v) for v in w["conv1_b"]),
        "};",
        "",
        "const ConvKernel64_99 weights_conv1_data = {",
        fmt_3d(c1w),
        "};",
        "",
        "const ConvKernel2 biases_conv2 = {",
        "    " + ", ".join(fmt(v) for v in w["conv2_b"]),
        "};",
        "",
        "const ConvKernel32x64 weights_conv2_data = {",
        fmt_2d(c2w),
        "};",
        "",
        f"const float biases_conv3 = {fmt(w['conv3_b'].ravel()[0])};",
        "",
        "const ConvKernel32_55 weights_conv3_data = {",
        fmt_3d(c3w),
        "};",
        "",
        "#endif",
        "",
    ]
    Path(path).write_text("\n".join(lines))
