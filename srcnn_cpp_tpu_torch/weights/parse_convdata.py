"""Converter: a reference ``convdata.h`` (C float arrays) -> an npz checkpoint.

The port's copy of ``srcnn_cpp_tpu/weights/parse_convdata.py`` (the port
never imports the JAX package).  The reference bakes its SRCNN 9-5-5
weights into the binary as ``const float`` initializer lists (reference
src/convdata.h); a retrained C++ build carries its own.  This reads that
payload (data, not code) into an ``.npz`` that :func:`.loader.load_weights`
serves; :func:`.checkpoint.export_convdata_header` writes such a header.

Usage::

    python -m srcnn_cpp_tpu_torch.weights.parse_convdata header.h out.npz

Layout facts recovered from the reference (srcnn.cpp usage sites):

* conv1: 64 filters of 9x9 over a single uint8 channel; row-major 9x9 per
  filter (srcnn.cpp:297 ``kernel99[k][i][j]`` with i=row, j=col).
* conv2: 32 filters x 64 input channels, 1x1 (srcnn.cpp:314 ``kernel11[k][i]``).
* conv3: 1 filter over 32 channels of 5x5 (srcnn.cpp:228 ``kernel[i][m][n]``).
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

import numpy as np

# A C float literal: optional sign, digits, optional fraction/exponent, optional f suffix.
_FLOAT_RE = re.compile(r"[+-]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][+-]?\d+)?f?")


def _extract_block(text: str, symbol: str) -> np.ndarray:
    """Return the flat float payload of ``const ... <symbol> = { ... };``."""
    m = re.search(re.escape(symbol) + r"\s*=\s*\\?\s*\{", text)
    if not m:
        raise ValueError(f"symbol {symbol!r} not found in header")
    start = text.index("{", m.start())
    depth = 0
    for i in range(start, len(text)):
        if text[i] == "{":
            depth += 1
        elif text[i] == "}":
            depth -= 1
            if depth == 0:
                body = text[start + 1 : i]
                break
    else:
        raise ValueError(f"unbalanced braces for {symbol!r}")
    # Strip comments before tokenizing numbers.
    body = re.sub(r"//[^\n]*", "", body)
    body = re.sub(r"/\*.*?\*/", "", body, flags=re.S)
    vals = [float(tok.rstrip("fF")) for tok in _FLOAT_RE.findall(body)]
    return np.asarray(vals, dtype=np.float32)


def _extract_scalar(text: str, symbol: str) -> float:
    m = re.search(re.escape(symbol) + r"\s*=\s*([^;]+);", text)
    if not m:
        raise ValueError(f"scalar {symbol!r} not found in header")
    tok = _FLOAT_RE.search(m.group(1))
    if not tok:
        raise ValueError(f"no float literal for {symbol!r}")
    return float(tok.group(0).rstrip("fF"))


def parse_convdata(header_path: Path | str) -> dict[str, np.ndarray]:
    """The six float32 arrays of a ``convdata.h``, in the npz layout;
    raises ValueError where a symbol is missing or has the wrong size."""
    text = Path(header_path).read_text()

    conv1_b = _extract_block(text, "biases_conv1")
    conv1_w = _extract_block(text, "weights_conv1_data")
    conv2_b = _extract_block(text, "biases_conv2")
    conv2_w = _extract_block(text, "weights_conv2_data")
    conv3_b = np.asarray([_extract_scalar(text, "biases_conv3")], dtype=np.float32)
    conv3_w = _extract_block(text, "weights_conv3_data")

    if conv1_b.shape != (64,):
        raise ValueError(f"conv1 biases: got {conv1_b.shape}, want (64,)")
    if conv1_w.size != 64 * 9 * 9:
        raise ValueError(f"conv1 weights: got {conv1_w.size} floats, want {64*81}")
    if conv2_b.shape != (32,):
        raise ValueError(f"conv2 biases: got {conv2_b.shape}, want (32,)")
    if conv2_w.size != 32 * 64:
        raise ValueError(f"conv2 weights: got {conv2_w.size} floats, want {32*64}")
    if conv3_w.size != 32 * 5 * 5:
        raise ValueError(f"conv3 weights: got {conv3_w.size} floats, want {32*25}")

    return {
        "conv1_w": conv1_w.reshape(64, 1, 9, 9),
        "conv1_b": conv1_b,
        "conv2_w": conv2_w.reshape(32, 64, 1, 1),
        "conv2_b": conv2_b,
        "conv3_w": conv3_w.reshape(1, 32, 5, 5),
        "conv3_b": conv3_b,
    }


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print("usage: python -m srcnn_cpp_tpu_torch.weights.parse_convdata "
              "header.h out.npz", file=sys.stderr)
        return 2
    header, out = Path(argv[0]), Path(argv[1])
    arrays = parse_convdata(header)
    np.savez_compressed(out, **arrays)
    total = sum(a.size for a in arrays.values())
    print(f"wrote {out} ({total} params)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
