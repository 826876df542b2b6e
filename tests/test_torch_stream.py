"""PyTorch port, the stream and the single-card configurations.

On the CPU ``StreamUpscaler`` runs the plain pipeline; its outputs must be
bit-identical to ``upscale_bgr_batch`` frame by frame and in order, for
every micro-batch size (every op works frame by frame).  The same pipeline
is held against the JAX package by tests/test_torch_pipeline.py, so here
the stream is also checked against the JAX stream to the pipeline's bar
(<=2 LSB, (diff > 1) on < 1e-5 of values).  ``run_synthetic`` reports the
float32-floor output geometry.  A ``cuda``-marked test drives the stream
with its pinned buffer ring on the card.
"""

import numpy as np
import pytest
import torch


def _frames(n, h, w, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]


def _collect(up, frames):
    outs = [o for f in frames if (o := up.push(f)) is not None]
    return outs + list(up.drain())


@pytest.mark.parametrize("batch", [1, 2, 3])
def test_stream_order_and_bit_identity(batch):
    from srcnn_cpp_tpu_torch.pipeline import upscale_bgr_batch
    from srcnn_cpp_tpu_torch.stream import StreamUpscaler

    frames = _frames(7, 24, 40, 5)
    ref = upscale_bgr_batch(np.stack(frames), 1.5, device="cpu")
    outs = _collect(StreamUpscaler(1.5, batch=batch, depth=2, device="cpu"),
                    frames)
    assert len(outs) == len(frames)
    for o, r in zip(outs, ref):
        assert o.shape == (36, 60, 3) and np.array_equal(o, r)


def test_stream_matches_jax_stream(weights):
    from srcnn_cpp_tpu.stream import StreamUpscaler as JaxStream
    from srcnn_cpp_tpu_torch.stream import StreamUpscaler
    from srcnn_cpp_tpu_torch.weights import from_jax_params

    frames = _frames(4, 20, 24, 8)
    got = _collect(StreamUpscaler(2.0, from_jax_params(weights), batch=2,
                                  device="cpu"), frames)
    ref = _collect(JaxStream(2.0, weights, kernel="xla", batch=2), frames)
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        d = np.abs(g.astype(int) - np.asarray(r).astype(int))
        assert d.max() <= 2 and (d > 1).mean() < 1e-5


def test_run_synthetic_uses_float_floor_geometry():
    # float32 30 * 2.1 = 62.999996 -> 62, where int(30 * 2.1) would be 63
    from srcnn_cpp_tpu_torch.ops.resize import scaled_size
    from srcnn_cpp_tpu_torch.stream import run_synthetic

    ow, oh = scaled_size(30, 30, 2.1)
    assert (oh, ow) == (62, 62) != (int(30 * 2.1), int(30 * 2.1))
    r = run_synthetic(3, (30, 30), 2.1, batch=2, device="cpu")
    assert r["frames"] == 2 and r["device"] == "cpu" and r["fps"] > 0
    assert r["mps"] * r["seconds"] / r["frames"] == \
        pytest.approx(oh * ow / 1e6, rel=1e-9)


def test_run_synthetic_device_refuses_the_cpu():
    from srcnn_cpp_tpu_torch.stream import run_synthetic_device

    with pytest.raises(ValueError):
        run_synthetic_device(2, (16, 16), 2.0, batch=1, device="cpu")


def test_run_video_lossless_round_trip(tmp_path):
    cv2 = pytest.importorskip("cv2")
    from srcnn_cpp_tpu_torch.pipeline import upscale_bgr
    from srcnn_cpp_tpu_torch.stream import run_video

    frames = _frames(3, 24, 32, 7)
    src, dst = tmp_path / "in.avi", tmp_path / "out.avi"
    wr = cv2.VideoWriter(str(src), cv2.VideoWriter_fourcc(*"FFV1"), 30.0,
                         (32, 24))
    if not wr.isOpened():
        pytest.skip("lossless FFV1 writer unavailable")
    for f in frames:
        wr.write(f)
    wr.release()
    assert run_video(str(src), str(dst), 2.0, verbose=False, batch=2,
                     device="cpu") == 0
    cap = cv2.VideoCapture(str(dst))
    for f in frames:
        ok, got = cap.read()
        assert ok
        np.testing.assert_array_equal(got, upscale_bgr(f, 2.0, device="cpu"))
    cap.release()


def test_stream_cli_device_flag(monkeypatch, capsys):
    from srcnn_cpp_tpu_torch.stream import main

    assert main(["--device=cpu", "--synthetic=2", "--size=32x24"]) == 0
    assert "on cpu" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["--synthetic=2", "--size=32x24"]) == 1   # default cuda
    assert "no CUDA device" in capsys.readouterr().err
    assert main(["--device=cpu", "--synthetic=2", "--device-resident"]) == 1
    assert main(["--device=cpu"]) == 1                    # no source
    with pytest.raises(SystemExit):
        main(["--device=tpu", "--synthetic=2"])


# --- configs -------------------------------------------------------------------

def test_batch_config_chunks_bit_identically():
    from srcnn_cpp_tpu_torch.configs import batch_1080p_to_4k

    frames = np.stack(_frames(5, 12, 16, 2))
    a = batch_1080p_to_4k(device="cpu")(frames)
    b = batch_1080p_to_4k(batch=2, device="cpu")(frames)
    assert a.shape == b.shape == (5, 24, 32, 3) and np.array_equal(a, b)


def test_single_8k_and_stream_configs_on_one_device():
    from srcnn_cpp_tpu_torch.configs import single_8k, stream_4k30
    from srcnn_cpp_tpu_torch.pipeline import upscale_bgr
    from srcnn_cpp_tpu_torch.stream import StreamUpscaler

    frame = _frames(1, 20, 28, 1)[0]
    assert np.array_equal(single_8k(device="cpu")(frame),
                          upscale_bgr(frame, 2.0, device="cpu"))
    up = stream_4k30(depth=1, device="cpu")
    assert isinstance(up, StreamUpscaler)
    outs = _collect(up, [frame, frame])
    assert len(outs) == 2 and outs[0].shape == (40, 56, 3)


def test_multi_device_configs_raise():
    from srcnn_cpp_tpu_torch.configs import single_8k, stream_4k30_distributed

    with pytest.raises(NotImplementedError, match="parallel"):
        single_8k(mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="parallel"):
        stream_4k30_distributed(mesh=object())


# --- on the card ---------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("batch,depth", [(1, 1), (3, 2)])
def test_cuda_stream_matches_batch_path(batch, depth):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from srcnn_cpp_tpu_torch.ops.cuda_srcnn import srcnn_y_fused
    from srcnn_cpp_tpu_torch.pipeline import upscale_bgr_batch
    from srcnn_cpp_tpu_torch.stream import StreamUpscaler
    from srcnn_cpp_tpu_torch.weights import load_weights

    w = load_weights(device="cuda")
    frames = _frames(7, 36, 52, 3)
    launches = srcnn_y_fused.launches
    outs = _collect(StreamUpscaler(2.0, w, depth=depth, batch=batch), frames)
    assert srcnn_y_fused.launches - launches == -(-len(frames) // batch)
    assert len(outs) == len(frames)
    for f, o in zip(frames, outs):
        assert np.array_equal(o, upscale_bgr_batch(f[None], 2.0, w, "cuda")[0])
