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


# --- the GEMM bodies' stall counters -------------------------------------------

def test_recording_is_the_one_switch(monkeypatch):
    # span and the launchers ask utils.profiling.recording(), which reads
    # torch's flag; a profiler session turns it on
    from torch.profiler import ProfilerActivity, profile

    from srcnn_cpp_tpu_torch.utils import profiling

    assert profiling.recording() is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.recording() is True
        assert profiling.span("srcnn.a") is not profiling._NO_SPAN
    assert profiling.recording() is False
    monkeypatch.setattr(profiling, "recording", lambda: True)
    assert profiling.span("srcnn.a") is not profiling._NO_SPAN
    assert profiling.counter_records(torch.device("cpu")) is not None
    monkeypatch.setattr(profiling, "recording", lambda: False)
    assert profiling.span("srcnn.a") is profiling._NO_SPAN
    assert profiling.counter_records(torch.device("cpu")) is None
    profiling._RECORDS.clear()


META = torch.device("meta")


@pytest.fixture
def fake_card(monkeypatch):
    """The launchers' card paths with nothing on a card: tensors on the
    meta device, the C library a recorder of its calls, the packed weights
    stand-ins; the counter records a CPU tensor.  Yields ``(calls,
    records)``."""
    import contextlib

    from srcnn_cpp_tpu_torch import runtime
    from srcnn_cpp_tpu_torch.ops import (cuda_rcan, cuda_srcnn, cuda_swinir,
                                         cuda_vdsr)
    from srcnn_cpp_tpu_torch.ops.cuda_swinir import PROBE_FIELDS, PROBE_KINDS
    from srcnn_cpp_tpu_torch.utils import profiling

    calls = []

    class Library:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(runtime, "library", Library)
    monkeypatch.setattr(runtime, "current_stream", lambda: 7)
    monkeypatch.setattr(runtime, "num_sms", lambda: 132)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    for module in (cuda_srcnn, cuda_rcan, cuda_swinir):
        monkeypatch.setattr(module, "_on_device", lambda x, device: None)
    empty = lambda n: lambda w: (torch.empty(4, device=META),) * n  # noqa
    monkeypatch.setattr(cuda_vdsr, "pack_vdsr", empty(3))
    monkeypatch.setattr(cuda_rcan, "pack_rcan", empty(4))
    monkeypatch.setattr(cuda_swinir, "pack_swinir", empty(5))
    records = torch.zeros((len(PROBE_KINDS), len(PROBE_FIELDS)),
                          dtype=torch.int64)
    monkeypatch.setattr(profiling, "_RECORDS", {META: records})
    yield calls, records


def _launch(name):
    from srcnn_cpp_tpu_torch.ops import cuda_rcan, cuda_swinir, cuda_vdsr
    from srcnn_cpp_tpu_torch.weights import load_vdsr_weights
    from srcnn_cpp_tpu_torch.weights.rcan import RCANWeights, rcan_shapes
    from srcnn_cpp_tpu_torch.weights.swinir import swinir_shapes

    def on_meta(shapes):
        return {k: torch.empty(s, device=META) for k, s in shapes.items()}

    bgr = torch.empty((1, 3, 8, 16), dtype=torch.uint8, device=META)
    if name == "vdsr_y_fused":
        w = load_vdsr_weights(REPO / "portbench/configs/vdsr20_seeded.npz")
        cuda_vdsr.vdsr_y_fused(
            torch.empty((2, 8, 16), dtype=torch.uint8, device=META),
            w.to(META))
    elif name == "rcan_fused":
        cuda_rcan.rcan_fused(bgr, RCANWeights(on_meta(rcan_shapes(1, 1))),
                             (16, 32))
    elif name == "swinir_fused":
        from srcnn_cpp_tpu_torch.weights import SwinIRWeights

        cuda_swinir.swinir_fused(
            bgr, SwinIRWeights(on_meta(swinir_shapes(groups=1, depth=1))),
            (16, 32))
    elif name == "gemm_variant":
        cuda_swinir.gemm_variant(
            "qkv", torch.empty((8, 16, 184), device=META),
            torch.zeros(540, 180), torch.zeros(540),
            ln=(torch.ones(180), torch.zeros(180)))
    else:
        cuda_rcan.conv3x3_variant(torch.empty((8, 16, 64), device=META),
                                  torch.zeros(64, 64, 3, 3), torch.zeros(64),
                                  "relu")


LAUNCHERS = {"vdsr_y_fused": "vdsr_y_u8", "rcan_fused": "rcan_x2_u8",
             "swinir_fused": "swinir_x2_u8",
             "gemm_variant": "swinir_gemm_f32",
             "conv3x3_variant": "rcan_conv3x3_f32"}


@pytest.mark.parametrize("launcher", sorted(LAUNCHERS))
def test_a_launcher_passes_the_counter_records_only_while_traced(
        launcher, fake_card):
    # the C entry point's last argument: null untraced, so the unprobed
    # kernels run; the card's records while a profiler records
    from torch.profiler import ProfilerActivity, profile

    calls, records = fake_card
    _launch(launcher)
    with profile(activities=[ProfilerActivity.CPU]):
        _launch(launcher)
    assert [name for name, _ in calls] == [LAUNCHERS[launcher]] * 2
    (_, off), (_, on) = calls
    assert off[-2:] == (7, None)
    assert on[-2:] == (7, records.data_ptr()) and records.data_ptr()
    assert off[:-1] == on[:-1]


def test_kernel_counters_is_empty_on_the_cpu(tmp_path):
    from srcnn_cpp_tpu_torch.pipeline import upscale_bgr_batch
    from srcnn_cpp_tpu_torch.utils.profiling import kernel_counters

    _traced(lambda: upscale_bgr_batch(_frames(), 2.0, device="cpu"),
            tmp_path)
    assert kernel_counters() == {}


def test_kernel_counters_reads_sums_and_resets(monkeypatch):
    # two cards' records: a kind only where it ran, summed over the cards
    from srcnn_cpp_tpu_torch.ops.cuda_swinir import PROBE_FIELDS, PROBE_KINDS
    from srcnn_cpp_tpu_torch.utils import profiling

    rows = torch.zeros((len(PROBE_KINDS), len(PROBE_FIELDS)),
                       dtype=torch.int64)
    qkv = PROBE_KINDS.index(("swinir_gemm", "qkv"))
    pool = PROBE_KINDS.index(("conv3x3", "pool"))
    rows[qkv] = torch.arange(1, 9)
    rows[pool] = torch.arange(2, 10)
    other = rows.clone()
    other[pool] = 0           # a card on which the pool conv never ran
    monkeypatch.setattr(profiling, "_RECORDS", {torch.device("cpu"): rows,
                                                torch.device("cpu", 0):
                                                other})
    got = profiling.kernel_counters()
    assert got == {"swinir_gemm": {"qkv": dict(zip(PROBE_FIELDS,
                                                   range(2, 17, 2)))},
                   "conv3x3": {"pool": dict(zip(PROBE_FIELDS,
                                                range(2, 10)))}}
    assert profiling.kernel_counters(reset=True) == got
    assert not rows.any() and not other.any()
    assert profiling.kernel_counters() == {}


#: the counter readers of portbench/metrics: (body, numerator,
#: denominator, scale) and the cells that report them
COUNTER_READERS = {
    "swinir_gemm_full_wait_pct": ("swinir_gemm", "full_wait_cycles",
                                  "unit_cycles", 100.0),
    "swinir_gemm_epilogue_pct": ("swinir_gemm", "epilogue_cycles",
                                 "unit_cycles", 100.0),
    "swinir_gemm_fill_cycles": ("swinir_gemm", "fill_cycles", "stages", 1.0),
    "conv3x3_full_wait_pct": ("conv3x3", "full_wait_cycles", "unit_cycles",
                              100.0),
    "conv3x3_epilogue_pct": ("conv3x3", "epilogue_cycles", "unit_cycles",
                             100.0),
    "conv3x3_fill_cycles": ("conv3x3", "fill_cycles", "stages", 1.0)}


@pytest.mark.parametrize("name", sorted(COUNTER_READERS))
def test_a_counter_reader_gives_its_quotient(name, monkeypatch):
    from portbench import spec
    from srcnn_cpp_tpu_torch.ops.cuda_swinir import PROBE_FIELDS
    from srcnn_cpp_tpu_torch.utils import profiling

    body, num, den, scale = COUNTER_READERS[name]
    a = {f: 3 * i + 1 for i, f in enumerate(PROBE_FIELDS)}
    b = {f: 7 * i + 5 for i, f in enumerate(PROBE_FIELDS)}
    other = "conv3x3" if body == "swinir_gemm" else "swinir_gemm"
    found = {body: {"a": a, "b": b}, other: {"c": dict.fromkeys(
        PROBE_FIELDS, 10 ** 6)}}
    monkeypatch.setattr(profiling, "kernel_counters",
                        lambda reset=False: found)
    read = spec.metric_reader(name)
    assert read(None) == pytest.approx(scale * (a[num] + b[num])
                                       / (a[den] + b[den]))
    found.pop(body)
    assert read(None) is None
    monkeypatch.setattr(profiling, "kernel_counters",
                        lambda reset=False: {})
    assert read(None) is None
    # a program without the counters (the parent of this reader)
    monkeypatch.delattr(profiling, "kernel_counters")
    assert read(None) is None
    entry = {m["name"]: m for m in spec.load_benchmark()["per_layer"]}[name]
    assert (entry["source"], entry["layer"], entry["moves"]) == (
        "program_counter", "kernels", "out_mpps")
    assert entry["workloads"] == (["swinir1080p.tensor"]
                                  if body == "swinir_gemm" else
                                  ["vdsr1080p.tensor", "rcan1080p.tensor"])
