"""The reduction of a Chrome trace to the window's activities."""

from __future__ import annotations

import pytest

from portbench import trace


def _events():
    x = {"ph": "X", "pid": 1, "tid": 7}
    return [
        {**x, "cat": "kernel", "name": "lead-in fill", "ts": 10, "dur": 1},
        {**x, "cat": "user_annotation", "name": trace.WINDOW, "ts": 100,
         "dur": 1000},
        {**x, "cat": "user_annotation", "name": "portbench.call", "ts": 100,
         "dur": 600},
        {**x, "cat": "cpu_op", "name": "aten::copy_", "ts": 120, "dur": 80},
        {**x, "cat": "user_annotation", "name": "portbench.wait", "ts": 700,
         "dur": 390},
        {**x, "tid": 9, "cat": "cpu_op", "name": "other thread", "ts": 100,
         "dur": 900},
        {**x, "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> "
         "Device)", "ts": 150, "dur": 50},
        {**x, "cat": "kernel", "name": "void srcnn_conv_kernel<StoreU8>()",
         "ts": 300, "dur": 300},
        {**x, "cat": "kernel", "name": "merge_vec_kernel()", "ts": 1000,
         "dur": 50},
        {**x, "cat": "kernel", "name": "after the window", "ts": 1200,
         "dur": 50},
    ]


def test_window_and_device_ops():
    ctx = trace.context(_events(), 4, (2, 2), (4, 4), 8032, None)
    assert ctx.window == (100.0, 1000.0) and ctx.window_s == 1e-3
    names = [n for _, n, _, _ in ctx.device_ops]
    assert "lead-in fill" not in names and "after the window" not in names
    assert ctx.kernel_s(("srcnn_conv_kernel",)) == pytest.approx(300e-6)
    assert ctx.kernel_s(("pre_pass_kernel",)) is None
    assert ctx.busy_s() == pytest.approx(400e-6)
    assert "other thread" not in [n for n, _, _ in ctx.host_ops]


def test_breakdown_attributes_gaps_to_the_innermost_host_op():
    b = trace.context(_events(), 4, (2, 2), (4, 4), 8032, None).breakdown()
    ops = dict(b["device_ops"])
    assert ops["srcnn_conv_kernel<StoreU8>()"] == pytest.approx(300e-6)
    gaps = dict(b["idle_gaps"])
    # gaps 100-150 (middle in aten::copy_), 200-300 (in the call),
    # 600-1000 and 1050-1100 (in the wait)
    assert gaps["aten::copy_"] == pytest.approx(50e-6)
    assert gaps["portbench.call"] == pytest.approx(100e-6)
    assert gaps["portbench.wait"] == pytest.approx(450e-6)
    assert b["device_ops"][0][0].startswith("srcnn_conv_kernel")


def test_no_window_no_context():
    assert trace.context([], 1, (2, 2), (4, 4), 8032, None) is None


def test_union():
    assert trace.union_s([(0, 10), (5, 10), (30, 5)]) == pytest.approx(20e-6)
