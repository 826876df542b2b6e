"""PyTorch port, the multi-process runtime (``parallel/distributed.py``).

Spawns two OS processes of ``python -m srcnn_cpp_tpu_torch.parallel.
distributed`` on the CPU over gloo, 2 mesh blocks each, meeting through a
``file://`` rendezvous under the test's own directory (no port to collide
between test workers).  Every ``communicate`` and the process group itself
carry a timeout, so a lost peer fails the test instead of hanging the
suite.  ``--check`` makes each process hold its output slab against the
port's monolithic pipeline bit for bit; the tests then hold that pipeline
(or the written video) to JAX's monolithic pipeline within
``tests/test_torch_pipeline.py``'s bar (<=2 LSB, (diff > 1) < 1e-5,
(diff > 0) < 5e-3), and the two-process trainer to the one-process
sharded step within float tolerance.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 240


def _run_two(tmp_path, extra):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "srcnn_cpp_tpu_torch.parallel.distributed",
         f"--init-method=file://{tmp_path}/rendezvous", "--world-size=2",
         f"--rank={r}", "--local-devices=2", "--device=cpu",
         f"--timeout={TIMEOUT // 2}", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO) for r in range(2)]
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, f"rc={p.returncode}\nstdout:{o}\nstderr:{e}"
    return [json.loads(next(ln for ln in o.splitlines()
                            if ln.startswith("{"))) for o, _ in outs]


def _frames(i, n, h, w, seed=0):
    """``run_synthetic``'s global frames of dispatch ``i``."""
    return np.random.default_rng(seed + i).integers(0, 256, (n, 3, h, w),
                                                    dtype=np.uint8)


def _assert_close_bgr(got, ref):
    d = np.abs(np.asarray(got).astype(int) - np.asarray(ref).astype(int))
    assert d.max() <= 2, d.max()
    assert (d > 1).mean() < 1e-5 and (d > 0).mean() < 5e-3


def _port_vs_jax(weights, planar, scale):
    """The port's monolithic pipeline (each process's oracle) against JAX's
    on the same planar frames."""
    from srcnn_cpp_tpu.pipeline import _upscale_planar_jit
    from srcnn_cpp_tpu_torch.ops.resize import scaled_size
    from srcnn_cpp_tpu_torch.pipeline import upscale_planar
    from srcnn_cpp_tpu_torch.weights import from_jax_params

    ow, oh = scaled_size(planar.shape[3], planar.shape[2], scale)
    port = upscale_planar(torch.from_numpy(planar), from_jax_params(weights),
                          (oh, ow)).numpy()
    _assert_close_bgr(port, np.asarray(_upscale_planar_jit(
        planar, weights, (oh, ow), "xla", "exact")))


def test_two_process_stream_row_spanning_bitexact(tmp_path, weights):
    """data=1: one frame's rows over both processes, so halos cross the
    process boundary; both slabs equal the monolithic pipeline's bits."""
    rows = _run_two(tmp_path, ["--frames=3", "--size=64x48", "--scale=2",
                               "--check"])
    for r in rows:
        assert r["processes"] == 2
        assert r["mesh"] == {"data": 1, "row": 4, "col": 1}
        assert r["bitexact"] is True and r["max_abs_diff"] == 0
        assert r["frames"] == 3
        # CPU blocks: two blocks per process, one plain call each per frame
        assert r["plain_calls"]["srcnn_y_plain"] == 2 * 3
    _port_vs_jax(weights, _frames(0, 1, 48, 64), 2.0)


def test_two_process_stream_data_parallel_bitexact(tmp_path, weights):
    """data=2: each process owns whole frames; rows split inside it."""
    rows = _run_two(tmp_path, ["--data=2", "--frames=2", "--size=48x64",
                               "--scale=1.5", "--check"])
    for r in rows:
        assert r["mesh"] == {"data": 2, "row": 2, "col": 1}
        assert r["bitexact"] is True and r["frames"] == 4
    _port_vs_jax(weights, _frames(1, 2, 64, 48), 1.5)


def _write_video(path, frames) -> bool:
    import cv2

    h, w = frames[0].shape[:2]
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"FFV1"), 30.0,
                         (w, h))
    if not wr.isOpened():
        return False
    for f in frames:
        wr.write(f)
    wr.release()
    return True


def _read_video(path):
    import cv2

    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return frames


@pytest.mark.parametrize("data", [1, 2])
def test_two_process_video_stream_bitexact(tmp_path, weights, data):
    """Real frame I/O: both processes decode the file and push their slabs;
    process 0 writes the ordered lossless output."""
    pytest.importorskip("cv2")
    from srcnn_cpp_tpu.pipeline import upscale_bgr

    rng = np.random.default_rng(0)
    frames = []
    for i in range(6):
        f = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
        f[:2] = (i * 29) % 256         # a distinct stripe per frame
        frames.append(f)
    src, dst = tmp_path / "in.avi", tmp_path / "out.avi"
    if not _write_video(src, frames):
        pytest.skip("lossless FFV1 writer unavailable")
    rows = _run_two(tmp_path, [f"--data={data}", f"--video-in={src}",
                               f"--video-out={dst}", "--scale=2", "--check"])
    for r in rows:
        assert r["frames"] == 6 and r["bitexact"] is True, r
    out = _read_video(dst)
    assert len(out) == 6
    monos = [np.asarray(upscale_bgr(f, 2.0, weights, kernel="xla"))
             for f in _read_video(src)]
    for i, o in enumerate(out):
        _assert_close_bgr(o, monos[i])
        assert all(np.abs(o.astype(int) - m.astype(int)).max() > 2
                   for j, m in enumerate(monos) if j != i), f"frame {i} order"


@pytest.mark.parametrize("data", [1, 2])
def test_two_process_training_matches_one_process(tmp_path, data):
    """The losses, final weights and input gradient of the two-process
    sharded trainer (halos and gradients crossing the process boundary at
    data=1) against the same mesh in one process."""
    from srcnn_cpp_tpu_torch.parallel import make_mesh
    from srcnn_cpp_tpu_torch.parallel.distributed import run_train

    rows = _run_two(tmp_path, ["--train", "--train-steps=3", "--size=32x32",
                               f"--data={data}"])
    ref = run_train(3, (32, 32), make_mesh(data=data, row=4 // data,
                                           devices=["cpu"] * 4))
    assert ref["losses"][2] < ref["losses"][0]
    for r in rows:
        assert r["mesh"]["data"] == data
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=1e-4)
        for k, v in ref["weight_fingerprint"].items():
            np.testing.assert_allclose(r["weight_fingerprint"][k], v,
                                       rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(r["input_grad_sum"], ref["input_grad_sum"],
                                   rtol=1e-4)


def test_single_process_stream_and_bounds(weights):
    """Without a process group the runner is one process over its mesh."""
    from srcnn_cpp_tpu_torch.parallel import make_mesh
    from srcnn_cpp_tpu_torch.parallel.distributed import (_local_bounds,
                                                          run_synthetic)
    from srcnn_cpp_tpu_torch.weights import from_jax_params

    mesh = make_mesh(data=2, row=4, devices=["cpu"] * 8)
    r = run_synthetic(2, (48, 64), 2.0, mesh, weights=from_jax_params(weights),
                      depth=1, check=True)
    assert r["bitexact"] is True and r["frames"] == 4
    assert r["plain_calls"]["pre_upscale_plain"] == 2 * 8
    b = _local_bounds(mesh, (4, 3, 32, 16))
    assert b == {0: (0, 4), 2: (0, 32)}


def test_frame_mesh_is_process_major():
    from srcnn_cpp_tpu_torch.parallel.distributed import frame_mesh

    m = frame_mesh(data=1, devices=["cpu"] * 4)
    assert m.shape == {"data": 1, "row": 4, "col": 1}
    assert (m.ranks == 0).all() and m.local_blocks() == [(0, r, 0)
                                                         for r in range(4)]
    with pytest.raises(ValueError):
        frame_mesh(data=3, devices=["cpu"] * 4)


def test_distributed_cli_without_a_card_exits_1(monkeypatch, capsys):
    from srcnn_cpp_tpu_torch.parallel.distributed import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["--world-size=1", "--rank=0"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
