"""PyTorch port, ``utils/profiling.py``: the trace, the stage timer and the
MP/s helper, against the JAX package's ``utils/profiling.py``.

On the CPU the fences are host fetches of CPU tensors; the trace records
CPU activity only.  The report must equal JAX's character for character.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch


@pytest.mark.parametrize("spans", [
    {"h2d": 12.25, "device": 3.5, "d2h": 40.0},
    {"only": 0.0},
    {"a very long stage name over 24 chars": 1234.5678, "b": 1e-3}])
def test_stage_timer_report_equals_jax(spans):
    from srcnn_cpp_tpu.utils.profiling import StageTimer as JaxTimer
    from srcnn_cpp_tpu_torch.utils.profiling import StageTimer

    ours, theirs = StageTimer(), JaxTimer()
    ours.spans, theirs.spans = dict(spans), dict(spans)
    assert ours.report() == theirs.report()


def test_stage_timer_spans_fence_and_accumulate():
    from srcnn_cpp_tpu_torch.utils.profiling import StageTimer

    t = StageTimer()
    x = torch.arange(12.0)
    with t.span("tensor", fetch=x * 2):
        pass
    with t.span("tuple", fetch=lambda: (x + 1, x.reshape(3, 4))):
        pass
    with t.span("host array", fetch=np.zeros(3)):
        pass
    with t.span("tensor"):
        pass
    assert list(t.spans) == ["tensor", "tuple", "host array"]
    assert all(v >= 0.0 for v in t.spans.values())
    lines = t.report().splitlines()
    assert len(lines) == 4 and lines[-1].startswith("TOTAL")


@pytest.mark.parametrize("iters,repeats", [(6, 3), (2, 1)])
def test_throughput_calls_and_rate(iters, repeats):
    from srcnn_cpp_tpu_torch.utils.profiling import throughput

    calls = []
    x = torch.ones((2, 64, 64))

    def fn():
        calls.append(1)
        return x * 3 + 1

    mps = throughput(fn, out_px=2 * 64 * 64, iters=iters, repeats=repeats)
    assert len(calls) == 1 + iters * repeats
    assert np.isfinite(mps) and mps > 0


def test_throughput_defaults_match_jax():
    import inspect

    from srcnn_cpp_tpu.utils import profiling as jax_prof
    from srcnn_cpp_tpu_torch.utils import profiling

    for name in ("throughput", "StageTimer"):
        ours = inspect.signature(getattr(profiling, name))
        assert ours == inspect.signature(getattr(jax_prof, name)), name


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
