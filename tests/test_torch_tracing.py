"""PyTorch port, the program's spans (``utils.profiling.span``).

A span is recorded only while a ``torch.profiler`` session records, as a
``user_annotation`` event of the trace, nested in its caller's span; with
no session ``span()`` hands back one shared no-op.  On the CPU the entry
layer, the pipeline, the stream and the cached builders write their
``srcnn.*`` spans through ``utils.profiling.trace``; each builder writes
``srcnn.build.<what>`` only when its cache misses.  Every span name in the
package is listed in PERF.md's span table, and nothing else is.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "srcnn_cpp_tpu_torch"


def _traced(fn, tmp_path) -> list:
    """The ``X`` events of one ``utils.profiling.trace`` of ``fn()``."""
    from srcnn_cpp_tpu_torch.utils.profiling import trace

    with trace(str(tmp_path / "tr")) as logdir:
        fn()
    events = json.loads((Path(logdir) / "trace.json").read_text())
    return [e for e in events["traceEvents"] if e.get("ph") == "X"]


def _spans(events, prefix="srcnn.") -> list:
    return [e for e in events if e.get("cat") == "user_annotation"
            and e["name"].startswith(prefix)]


def _inside(inner, outer) -> bool:
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def _frames(b=2, h=12, w=20, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, h, w, 3),
                                                dtype=np.uint8)


def test_span_without_a_profiler_is_the_shared_noop(monkeypatch):
    from srcnn_cpp_tpu_torch.utils import profiling

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    a, b = profiling.span("srcnn.a"), profiling.span("srcnn.b")
    assert a is b is profiling._NO_SPAN
    with a, b:
        pass


def test_span_under_trace_writes_a_user_annotation(tmp_path):
    from srcnn_cpp_tpu_torch.utils.profiling import span

    def fn():
        with span("srcnn.test.outer"):
            with span("srcnn.test.inner"):
                torch.ones(4).add_(1)

    spans = {e["name"]: e for e in _spans(_traced(fn, tmp_path))}
    assert set(spans) == {"srcnn.test.outer", "srcnn.test.inner"}
    assert _inside(spans["srcnn.test.inner"], spans["srcnn.test.outer"])


def test_host_array_entry_writes_its_stages_in_order(tmp_path):
    from srcnn_cpp_tpu_torch.pipeline import upscale_bgr_batch

    x = _frames()
    upscale_bgr_batch(x, 2.0, device="cpu")     # tables built before
    events = _traced(lambda: upscale_bgr_batch(x, 2.0, device="cpu"),
                     tmp_path)
    spans = _spans(events)
    assert [e["name"] for e in spans] == [
        "srcnn.entry", "srcnn.entry.h2d", "srcnn.entry.to_planar",
        "srcnn.pipeline", "srcnn.entry.to_hwc", "srcnn.entry.fetch"]
    entry, children = spans[0], spans[1:]
    assert all(_inside(c, entry) for c in children)
    assert all(a["ts"] + a["dur"] <= b["ts"]
               for a, b in zip(children, children[1:]))
    assert len({e["tid"] for e in spans}) == 1
    # the copy's own ops sit inside its span: one clock for both
    h2d = spans[1]
    ops = [e["name"] for e in events if e.get("cat") == "cpu_op"
           and _inside(e, h2d)]
    assert "aten::to" in ops, ops


def test_tensor_entry_writes_to_planar_and_no_host_stages(tmp_path):
    from srcnn_cpp_tpu_torch.pipeline import upscale_bgr_batch

    x = torch.from_numpy(_frames(seed=1))
    names = [e["name"] for e in _spans(_traced(
        lambda: upscale_bgr_batch(x, 2.0, device="cpu"), tmp_path))]
    assert names[:2] == ["srcnn.entry", "srcnn.entry.to_planar"]
    assert "srcnn.pipeline" in names and "srcnn.entry.to_hwc" in names
    assert not {"srcnn.entry.host_transpose", "srcnn.entry.h2d",
                "srcnn.entry.fetch"} & set(names)


def test_stream_writes_its_dispatch(tmp_path):
    from srcnn_cpp_tpu_torch.stream import StreamUpscaler

    frames = list(_frames(3, 12, 20, 2))

    def run():
        up = StreamUpscaler(2.0, batch=2, depth=1, device="cpu")
        outs = [o for f in frames if (o := up.push(f)) is not None]
        assert len(outs + list(up.drain())) == 3

    spans = _spans(_traced(run, tmp_path))
    dispatch = [e for e in spans if e["name"] == "srcnn.stream.dispatch"]
    stage = [e for e in spans if e["name"] == "srcnn.stream.stage_in"]
    assert len(dispatch) == len(stage) == 2     # batches of 2 and of 1
    entries = [e for e in spans if e["name"] == "srcnn.entry"]
    assert len(entries) == 2
    assert all(any(_inside(e, d) for d in dispatch) for e in entries)


def test_a_cold_call_nests_its_builds_in_the_pipeline(tmp_path):
    from srcnn_cpp_tpu_torch.ops import resize
    from srcnn_cpp_tpu_torch.pipeline import upscale_bgr_batch

    x = _frames(1, 10, 14, 3)
    resize.cubic_tables.cache_clear()
    spans = _spans(_traced(lambda: upscale_bgr_batch(x, 2.0, device="cpu"),
                           tmp_path))
    by_name = {e["name"]: e for e in spans}
    builds = [e for e in spans if e["name"] == "srcnn.build.cubic_tables"]
    assert len(builds) == 2      # the rows' tables and the columns'
    assert all(_inside(b, by_name["srcnn.pipeline"]) for b in builds)
    assert _inside(by_name["srcnn.pipeline"], by_name["srcnn.entry"])


def test_vdsr_weights_run_the_chain_inside_the_pipeline(tmp_path):
    from srcnn_cpp_tpu_torch.pipeline import upscale_bgr_batch
    from srcnn_cpp_tpu_torch.weights import load_vdsr_weights

    w = load_vdsr_weights(REPO / "portbench/configs/vdsr20_seeded.npz")
    x = _frames(1, 6, 8, 4)
    spans = _spans(_traced(lambda: upscale_bgr_batch(x, 2.0, w, "cpu"),
                           tmp_path))
    by_name = {e["name"]: e for e in spans}
    assert _inside(by_name["srcnn.vdsr"], by_name["srcnn.pipeline"])
    assert _inside(by_name["srcnn.pipeline"], by_name["srcnn.entry"])


def test_rcan_weights_run_the_network_inside_the_pipeline(tmp_path):
    # RCAN takes the pipeline's other shape: no K2, no K3, its network
    # enqueued inside srcnn.pipeline; a warm call writes no build span
    from srcnn_cpp_tpu_torch.ops import cuda_rcan
    from srcnn_cpp_tpu_torch.pipeline import upscale_bgr_batch
    from srcnn_cpp_tpu_torch.weights import load_rcan_weights

    w = load_rcan_weights(REPO / "portbench/configs/rcan_x2_seeded.jsonl")
    x = _frames(1, 4, 6, 5)
    cuda_rcan.pack_rcan(w)
    upscale_bgr_batch(x, 2.0, w, "cpu")
    spans = _spans(_traced(lambda: upscale_bgr_batch(x, 2.0, w, "cpu"),
                           tmp_path))
    by_name = {e["name"]: e for e in spans}
    assert _inside(by_name["srcnn.rcan"], by_name["srcnn.pipeline"])
    assert _inside(by_name["srcnn.pipeline"], by_name["srcnn.entry"])
    assert not [e for e in spans if e["name"].startswith("srcnn.build.")]
    assert "srcnn.build.cubic_tables" not in by_name


def test_swinir_weights_run_the_network_inside_the_pipeline(tmp_path):
    # SwinIR takes the pipeline's other shape, as RCAN does: its network
    # enqueued inside srcnn.pipeline; a warm call writes no build span
    from srcnn_cpp_tpu_torch.ops import cuda_swinir
    from srcnn_cpp_tpu_torch.pipeline import upscale_bgr_batch

    w = _small_swinir()
    x = _frames(1, 8, 8, 5)
    cuda_swinir.pack_swinir(w)
    upscale_bgr_batch(x, 2.0, w, "cpu")
    spans = _spans(_traced(lambda: upscale_bgr_batch(x, 2.0, w, "cpu"),
                           tmp_path))
    by_name = {e["name"]: e for e in spans}
    assert _inside(by_name["srcnn.swinir"], by_name["srcnn.pipeline"])
    assert _inside(by_name["srcnn.pipeline"], by_name["srcnn.entry"])
    assert not [e for e in spans if e["name"].startswith("srcnn.build.")]


def _small_swinir():
    """SwinIR at the published widths, 1 RSTB of 1 STL, seeded."""
    from srcnn_cpp_tpu_torch.weights import SwinIRWeights
    from srcnn_cpp_tpu_torch.weights.swinir import swinir_shapes

    g = torch.Generator().manual_seed(0)
    return SwinIRWeights({k: 0.05 * torch.randn(s, generator=g) for k, s in
                          swinir_shapes(groups=1, depth=1).items()})


def _k2_plan():
    from srcnn_cpp_tpu_torch.ops import cuda_resize

    return cuda_resize._device_plan, lambda: cuda_resize._device_plan(
        24, 40, 12, 20, None, torch.device("cpu"))


def _k1_plan():
    from srcnn_cpp_tpu_torch.ops import cuda_srcnn

    return cuda_srcnn._plan, lambda: cuda_srcnn._plan(2, 24, 40, 132)


def _k3_args():
    from srcnn_cpp_tpu_torch.ops import cuda_merge

    return cuda_merge._launch_args, lambda: cuda_merge._launch_args(
        2, 24, 40, 0, (0, 0, 0))


def _cubic_tables():
    from srcnn_cpp_tpu_torch.ops import resize

    return resize.cubic_tables, lambda: resize.cubic_tables(
        40, 20, torch.device("cpu"))


def _weights():
    from srcnn_cpp_tpu_torch.ops.cuda_srcnn import pack_weights
    from srcnn_cpp_tpu_torch.weights import load_weights

    w = load_weights()       # a new object: its packed buffer is not built
    return None, lambda: pack_weights(w)


def _vdsr_plan():
    from srcnn_cpp_tpu_torch.ops import cuda_vdsr

    return cuda_vdsr._plan, lambda: cuda_vdsr._plan(24, 40, 132)


def _vdsr_weights():
    from srcnn_cpp_tpu_torch.ops.cuda_vdsr import pack_vdsr
    from srcnn_cpp_tpu_torch.weights import load_vdsr_weights

    w = load_vdsr_weights(REPO / "portbench/configs/vdsr20_seeded.npz")
    return None, lambda: pack_vdsr(w)


def _rcan_plan():
    from srcnn_cpp_tpu_torch.ops import cuda_rcan

    return cuda_rcan._plan, lambda: cuda_rcan._plan(24, 40, 132)


def _rcan_weights():
    from srcnn_cpp_tpu_torch.ops.cuda_rcan import pack_rcan
    from srcnn_cpp_tpu_torch.weights import load_rcan_weights

    w = load_rcan_weights(REPO / "portbench/configs/rcan_x2_seeded.jsonl")
    return None, lambda: pack_rcan(w)


def _swinir_plan():
    from srcnn_cpp_tpu_torch.ops import cuda_swinir

    return cuda_swinir._plan, lambda: cuda_swinir._plan(24, 40, 132)


def _swinir_weights():
    from srcnn_cpp_tpu_torch.ops.cuda_swinir import pack_swinir

    w = _small_swinir()      # a new object: its packed buffers are not built
    return None, lambda: pack_swinir(w)


BUILDERS = {"k2_plan": _k2_plan, "k1_plan": _k1_plan, "k3_args": _k3_args,
            "cubic_tables": _cubic_tables, "weights": _weights,
            "vdsr_plan": _vdsr_plan, "vdsr_weights": _vdsr_weights,
            "rcan_plan": _rcan_plan, "rcan_weights": _rcan_weights,
            "swinir_plan": _swinir_plan, "swinir_weights": _swinir_weights}


@pytest.mark.parametrize("what", sorted(BUILDERS))
def test_a_builder_writes_its_span_only_on_a_miss(what, tmp_path,
                                                  monkeypatch):
    from srcnn_cpp_tpu_torch import runtime

    # K3's plan asks the card for its SM count
    monkeypatch.setattr(runtime, "num_sms", lambda: 132)
    cache, call = BUILDERS[what]()
    if cache is not None:
        cache.cache_clear()
    try:
        first = _spans(_traced(call, tmp_path / "first"), "srcnn.build.")
        again = _spans(_traced(call, tmp_path / "again"), "srcnn.build.")
    finally:
        if cache is not None:
            cache.cache_clear()
    assert [e["name"] for e in first] == [f"srcnn.build.{what}"]
    assert again == []


def test_every_span_is_in_perf_md_and_nothing_else():
    in_code = set()
    for path in PACKAGE.rglob("*.py"):
        in_code |= set(re.findall(r'span\("(srcnn\.[^"]+)"\)',
                                  path.read_text()))
    table = set(re.findall(r"^\| `(srcnn\.[^`]+)` \|",
                           (REPO / "PERF.md").read_text(), re.M))
    assert in_code and in_code == table, (in_code ^ table)
