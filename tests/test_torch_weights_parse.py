"""PyTorch port, ``weights/parse_convdata.py``: the reference header's
parser, against the JAX package's.

Headers come from the JAX package's ``export_convdata_header`` (the
reference's own ``convdata.h`` is not in the repo), of the pretrained
checkpoint and of a seeded perturbation of it.  Tolerance: bit-exact (the
same float literals parse to the same float32 values).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


def _arrays(weights, seed):
    if seed is None:
        return {k: np.asarray(v) for k, v in weights.as_dict().items()}
    rng = np.random.default_rng(seed)
    return {k: (np.asarray(v) * (1 + 1e-3 * rng.standard_normal(np.shape(v))))
            .astype(np.float32) for k, v in weights.as_dict().items()}


def _jax_header(path, arrays):
    from srcnn_cpp_tpu.weights import SRCNNWeights as JW
    from srcnn_cpp_tpu.weights.checkpoint import export_convdata_header

    export_convdata_header(path, JW(**arrays))
    return path


@pytest.mark.parametrize("seed", [None, 8])
def test_parse_convdata_equals_jax(tmp_path, weights, seed):
    from srcnn_cpp_tpu.weights.parse_convdata import \
        parse_convdata as jax_parse
    from srcnn_cpp_tpu_torch.weights.parse_convdata import parse_convdata

    arrays = _arrays(weights, seed)
    header = _jax_header(tmp_path / "convdata.h", arrays)
    got, want = parse_convdata(header), jax_parse(header)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32 and got[k].shape == v.shape, k
        assert np.array_equal(got[k], v), k
        assert np.array_equal(got[k], arrays[k]), k


def test_parse_convdata_npz_serves_through_load_weights(tmp_path, weights):
    from srcnn_cpp_tpu_torch.weights import load_weights
    from srcnn_cpp_tpu_torch.weights.parse_convdata import main

    arrays = _arrays(weights, 9)
    header = _jax_header(tmp_path / "convdata.h", arrays)
    out = tmp_path / "retrained.npz"
    assert main([str(header), str(out)]) == 0
    served = load_weights(out)
    for k, v in arrays.items():
        assert torch.equal(getattr(served, k), torch.from_numpy(v)), k
    assert main([str(header)]) == 2          # both paths are required


def test_parse_convdata_cli(tmp_path, weights):
    header = _jax_header(tmp_path / "convdata.h", _arrays(weights, None))
    out = tmp_path / "w.npz"
    proc = subprocess.run(
        [sys.executable, "-m", "srcnn_cpp_tpu_torch.weights.parse_convdata",
         str(header), str(out)], capture_output=True, text=True, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO)), timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "8129 params" in proc.stdout
    with np.load(out) as z:
        for k, v in weights.as_dict().items():
            assert np.array_equal(z[k], np.asarray(v)), k


@pytest.mark.parametrize("cut", ["truncated", "missing_symbol", "short_block"])
def test_parse_convdata_rejects_bad_headers(tmp_path, weights, cut):
    from srcnn_cpp_tpu.weights.parse_convdata import \
        parse_convdata as jax_parse
    from srcnn_cpp_tpu_torch.weights.parse_convdata import parse_convdata

    text = _jax_header(tmp_path / "ok.h", _arrays(weights, None)).read_text()
    if cut == "truncated":
        text = text[:len(text) // 2]
    elif cut == "missing_symbol":
        text = text.replace("biases_conv2", "biases_convX")
    else:                                   # one conv3 weight fewer
        start = text.index("weights_conv3_data")
        i = text.index(",", start)
        j = text.index(",", i + 1)
        text = text[:i] + text[j:]
    bad = tmp_path / "bad.h"
    bad.write_text(text)
    for parse in (parse_convdata, jax_parse):
        with pytest.raises(ValueError):
            parse(bad)
