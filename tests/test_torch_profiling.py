"""PyTorch port, ``utils/profiling.py``: the trace, and ``utils``'s
exports against the JAX package's.

On the CPU the trace records CPU activity only.  The program's spans are
tests/test_torch_tracing.py's.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch


def test_trace_writes_a_chrome_trace_with_aten_ops(tmp_path):
    from srcnn_cpp_tpu_torch.ops.color import bgr2ycrcb_u8_planar
    from srcnn_cpp_tpu_torch.utils.profiling import trace

    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (1, 3, 16, 16), dtype=np.uint8))
    with trace(str(tmp_path / "tr")) as logdir:
        bgr2ycrcb_u8_planar(x)
    assert logdir == str(tmp_path / "tr")
    path = Path(logdir) / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names), sorted(names)[:20]


def test_utils_exports_match_jax():
    import srcnn_cpp_tpu.utils as jax_utils
    import srcnn_cpp_tpu_torch.utils as utils

    assert utils.__all__ == jax_utils.__all__
    for name in utils.__all__:
        assert callable(getattr(utils, name)), name
