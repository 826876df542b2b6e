"""The roofline and MFU arithmetic, from shapes alone."""

from __future__ import annotations

import pytest

from portbench import roofline, spec, trace
from portbench.reference import srcnn

WEIGHTS = spec.HERE / "configs" / "srcnn955.npz"
H100 = roofline.peaks_for("NVIDIA H100 80GB HBM3")
OUT_4K = 2160 * 3840
IN_1080 = 1080 * 1920


def _ctx(device_ops, frames=32, window_us=1e6):
    return trace.Ctx((0.0, window_us), device_ops, [], frames,
                     (1080, 1920), (2160, 3840), 8032, H100)


def test_macs_per_pixel_from_the_checkpoint_shapes():
    shapes = {k: tuple(v.shape) for k, v in srcnn.load(WEIGHTS,
                                                       "cpu").items()}
    assert shapes["conv2_w"] == (32, 64, 1, 1)
    assert srcnn.macs_per_pixel(shapes) == 81 * 64 + 64 * 32 + 25 * 32 \
        == 8032


def test_peaks():
    assert H100["tf32_flops"] == 495e12 and H100["hbm_bytes_per_s"] == 3.35e12
    assert roofline.peaks_for("some other card") is None


def test_conv_bound_is_the_networks_work():
    conv = spec.metric_reader("conv_roofline")
    # 8.29 MP at 2 * 8,032 FLOP a pixel and 495 TFLOP/s: 0.269 ms
    least = 2 * 8032 * 4 * 1080 * 1920 / 495e12
    assert least == pytest.approx(0.2692e-3, rel=1e-3)
    ops = [("kernel", "srcnn_conv_kernel<StoreU8>", 0.0, 2 * least * 1e6)]
    ctx = trace.Ctx((0.0, 1e6), ops, [], 1, (1080, 1920), (2160, 3840),
                    8032, H100)
    assert conv(ctx) == pytest.approx(50.0)


def test_prepass_and_merge_bytes_at_the_cells_geometry():
    pre = spec.metric_reader("prepass_roofline")
    merge = spec.metric_reader("merge_roofline")
    k2_bytes = 3 * IN_1080 + 3 * OUT_4K          # 31.1 MB a frame
    k3_bytes = 6 * OUT_4K                         # 49.8 MB a frame
    assert k2_bytes == 31_104_000 and k3_bytes == 49_766_400
    t2, t3 = 32 * k2_bytes / 3.35e12, 32 * k3_bytes / 3.35e12
    ctx = _ctx([("kernel", "pre_pass_kernel(...)", 0.0, 4 * t2 * 1e6),
                ("kernel", "merge_vec_kernel(...)", 0.0, 2 * t3 * 1e6)])
    assert pre(ctx) == pytest.approx(25.0)       # bytes bound K2 at x2
    assert merge(ctx) == pytest.approx(50.0)


def test_mfu_idle_and_copies():
    mfu = spec.metric_reader("mfu_pct")
    idle = spec.metric_reader("device_idle_pct")
    copies = spec.metric_reader("memcpy_ms_per_frame")
    ops = [("kernel", "a", 0.0, 250e3), ("kernel", "b", 200e3, 100e3),
           ("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 500e3, 40e3),
           ("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 600e3, 24e3),
           ("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 700e3, 1e3)]
    ctx = _ctx(ops, frames=32)
    assert idle(ctx) == pytest.approx(70.0)       # 300 of 1,000 ms busy
    assert copies(ctx) == pytest.approx(64.0 / 32)
    assert mfu(ctx) == pytest.approx(
        100 * 2 * 8032 * OUT_4K * 32 / 495e12)
    assert ctx.busy_s() == pytest.approx(0.365)


def test_a_reader_that_finds_nothing_returns_none():
    ctx = _ctx([("gpu_memset", "Memset", 0.0, 1.0)], frames=0)
    for name in ("conv_roofline", "prepass_roofline",
                 "merge_roofline", "mfu_pct", "device_idle_pct",
                 "memcpy_ms_per_frame"):
        assert spec.metric_reader(name)(ctx) is None, name


def test_the_configurations_state_the_checkpoints_sizes():
    w = srcnn.load(WEIGHTS, "cpu")
    for name in ("batch_1080p_to_4k", "stream_4k30"):
        cfg = spec.read_json(spec.config_path(name))
        assert (cfg["n1"], 1, cfg["f1"], cfg["f1"]) == tuple(
            w["conv1_w"].shape)
        assert (cfg["n2"], cfg["n1"], cfg["f2"], cfg["f2"]) == tuple(
            w["conv2_w"].shape)
        assert (1, cfg["n2"], cfg["f3"], cfg["f3"]) == tuple(
            w["conv3_w"].shape)
