"""The readers of the program's spans (``source: program_span``) on a
synthetic trace: ``srcnn.*`` spans inside ``portbench.call``, some before
the window and some on another thread, which no reader may count."""

from __future__ import annotations

import pytest

from portbench import spec, trace

X = {"ph": "X", "pid": 1, "tid": 7}


def _ua(name, ts, dur, **kw):
    return {**X, "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, **kw}


def _host_call(t0):
    """One host-array call at ``t0`` (us): 400 us of host transpose with
    the card idle, then the copy in, the kernels and the fetch."""
    return [
        _ua("portbench.call", t0, 1000),
        _ua("srcnn.entry", t0 + 10, 980),
        _ua("srcnn.entry.host_transpose", t0 + 20, 400),
        _ua("srcnn.entry.h2d", t0 + 420, 60),
        {**X, "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> "
         "Device)", "ts": t0 + 425, "dur": 50},
        _ua("srcnn.pipeline", t0 + 480, 20),
        {**X, "cat": "kernel", "name": "srcnn_conv_kernel<StoreU8>",
         "ts": t0 + 490, "dur": 200},
        _ua("srcnn.entry.to_hwc", t0 + 500, 10),
        _ua("srcnn.entry.fetch", t0 + 510, 470),
        {**X, "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> "
         "Pageable)", "ts": t0 + 700, "dur": 270},
    ]


def _events():
    return [
        # before the window: a cold call that built K1's plan
        _ua("srcnn.entry", 10, 50),
        _ua("srcnn.build.k1_plan", 20, 5),
        _ua("srcnn.entry.host_transpose", 30, 20),
        _ua(trace.WINDOW, 100, 3000),
        *_host_call(100),
        *_host_call(1100),
        # a cache miss inside the window
        _ua("srcnn.build.k3_args", 1600, 2),
        # another thread, inside the window: never counted
        _ua("srcnn.entry", 200, 2000, tid=9),
        _ua("srcnn.entry.host_transpose", 300, 1000, tid=9),
        _ua("srcnn.build.weights", 400, 10, tid=9),
    ]


def _ctx(events=None, frames=8):
    return trace.context(_events() if events is None else events, frames,
                         (2, 2), (4, 4), 8032, None)


def test_host_transpose_ms_per_frame_counts_the_windows_spans():
    read = spec.metric_reader("host_transpose_ms_per_frame")
    # two spans of 400 us in the window, over 8 frames
    assert read(_ctx()) == pytest.approx(2 * 0.4 / 8)


def test_enqueue_ms_per_call_is_the_mean_outermost_entry():
    read = spec.metric_reader("enqueue_ms_per_call")
    assert read(_ctx()) == pytest.approx(0.98)
    # an entry nested in another counts once, as the outer one
    nested = _events() + [_ua("srcnn.entry", 1200, 100)]
    assert read(_ctx(nested)) == pytest.approx(0.98)


def test_rebuilds_counts_the_windows_cache_misses():
    read = spec.metric_reader("rebuilds")
    assert read(_ctx()) == 1
    quiet = [e for e in _events() if e["name"] != "srcnn.build.k3_args"]
    assert read(_ctx(quiet)) == 0


@pytest.mark.parametrize("name", ["host_transpose_ms_per_frame",
                                  "enqueue_ms_per_call", "rebuilds"])
def test_a_program_without_spans_reads_nothing(name):
    bare = [e for e in _events() if not e["name"].startswith("srcnn.")]
    assert spec.metric_reader(name)(_ctx(bare)) is None


def test_breakdown_puts_the_gaps_down_to_the_programs_spans():
    gaps = dict(_ctx().breakdown()["idle_gaps"])
    # 100-525 and 1070-1525 (from the first fetch's copy to the second
    # copy in): the middle of each lies in a host transpose, not in the
    # benchmark's call
    assert gaps["srcnn.entry.host_transpose"] == pytest.approx(880e-6)
    assert "portbench.call" not in gaps
    # the card idle between the kernel and the fetch's copy
    assert gaps["srcnn.entry.fetch"] == pytest.approx(2 * 10e-6)


def test_the_new_metrics_are_declared_for_their_cells():
    bench = spec.load_benchmark()
    by_name = {m["name"]: m for m in bench["per_layer"]}
    for name, cell in (("host_transpose_ms_per_frame", "batch1080p.host"),
                       ("enqueue_ms_per_call", "batch1080p.tensor"),
                       ("rebuilds", "batch1080p.tensor")):
        m = by_name[name]
        assert m["source"] == "program_span" and m["workloads"] == [cell]
        assert name in [p["name"] for p in spec.cell(cell).per_layer]
