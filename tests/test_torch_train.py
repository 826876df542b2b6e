"""PyTorch port, the training path, against the JAX package.

The same seeded NumPy inputs and weights go through both packages (the
batch of ``tests/test_train.py``: 4 x 32 x 32).  Tolerances, with their
reasons and the values measured on the CPU:

* gradients of ``mse_loss`` at the pretrained weights against
  ``jax.grad``: per tensor max |d| <= 1e-4 x max |g| (the sums run in
  another order; measured <= 1.5e-6);
* three Adam(1e-4) steps against ``optax.adam``: losses within rtol 1e-5
  (measured 1.6e-6), weight updates within 5e-3 of the largest update, as
  in ``tests/test_train.py:55-63`` (measured 2.0e-4);
* the patch pipeline: HR patches equal; LR patches <=1 LSB on < 1e-3 of
  pixels (the two degradations are separately compiled float resamplers;
  measured: equal on butterfly.png at x2 and x3); minibatches identical.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

GRAD_REL = 1e-4
LOSS_RTOL = 1e-5
UPDATE_REL = 5e-3
LR_LSB_SHARE = 1e-3


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (4, 32, 32), dtype=np.uint8)
    # target: a slightly sharpened copy, so there is something to learn
    t = np.clip(x.astype(np.float32) * 1.02 - 2.0, 0, 255)
    return x, t


def _model(weights):
    from srcnn_cpp_tpu_torch.models import SRCNN
    from srcnn_cpp_tpu_torch.weights import from_jax_params

    return SRCNN.from_weights(from_jax_params(weights))


def _images(tmp_path, n=2, size=66, seed=1):
    from srcnn_cpp_tpu_torch.imageio import imwrite_bgr

    rng = np.random.default_rng(seed)
    for i in range(n):
        img = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        assert imwrite_bgr(tmp_path / f"im{i}.png", img)
    return tmp_path


# --- the step ------------------------------------------------------------------

def test_mse_gradients_match_jax_grad(weights, batch):
    import jax

    from srcnn_cpp_tpu.train import mse_loss as jax_loss
    from srcnn_cpp_tpu_torch.train import mse_loss

    x, t = batch
    g = jax.grad(jax_loss)(weights, x, t)
    model = _model(weights)
    loss = mse_loss(model, torch.from_numpy(x), torch.from_numpy(t))
    loss.backward()
    assert np.isclose(float(loss.detach()), float(jax_loss(weights, x, t)),
                      rtol=LOSS_RTOL)
    for k, p in model.named_parameters():
        gj = np.asarray(getattr(g, k))
        d = np.abs(p.grad.numpy() - gj).max()
        assert d <= GRAD_REL * np.abs(gj).max(), (k, d, np.abs(gj).max())


def test_adam_steps_match_optax(weights, batch):
    import optax

    from srcnn_cpp_tpu.train import make_train_step as jax_step
    from srcnn_cpp_tpu_torch.train import make_train_step

    x, t = batch
    opt = optax.adam(1e-4)
    step, w, state = jax_step(opt), weights, opt.init(weights)
    model = _model(weights)
    tstep = make_train_step(model, torch.optim.Adam(model.parameters(),
                                                    lr=1e-4, eps=1e-8))
    for _ in range(3):
        w, state, loss = step(w, state, x, t)
        assert np.isclose(tstep(x, t), float(loss), rtol=LOSS_RTOL)
    for k, p in model.named_parameters():
        d1 = np.asarray(getattr(w, k)) - np.asarray(getattr(weights, k))
        d2 = p.detach().numpy() - np.asarray(getattr(weights, k))
        scale = np.abs(d1).max() + 1e-30
        np.testing.assert_allclose(d2 / scale, d1 / scale, atol=UPDATE_REL,
                                   err_msg=k)


def test_loss_decreases_under_sgd(weights, batch):
    from srcnn_cpp_tpu_torch.train import make_train_step, mse_loss

    x, t = batch
    model = _model(weights)
    # 0-255 domain: gradients are huge, lr tiny
    step = make_train_step(model, torch.optim.SGD(model.parameters(),
                                                  lr=1e-9))
    losses = [step(x, t) for _ in range(3)]
    with torch.no_grad():
        last = float(mse_loss(model, torch.from_numpy(x),
                              torch.from_numpy(t)))
    assert np.isfinite(losses).all() and last < losses[0]


def test_step_runs_forward_and_backward_with_tf32_off_on_cudnn(weights, batch):
    from srcnn_cpp_tpu_torch.train import make_train_step

    x, t = batch
    model = _model(weights)
    seen = []

    def record(*_):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.enabled))

    model.register_forward_hook(record)
    model.conv1_w.register_hook(record)      # conv1's weight gradient
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        make_train_step(model, torch.optim.SGD(model.parameters(),
                                               lr=1e-9))(x, t)
        after = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
    finally:
        torch.backends.cudnn.allow_tf32 = prev[0]
        torch.backends.cuda.matmul.allow_tf32 = prev[1]
    # forward, backward: TF32 off, cuDNN on
    assert seen == [(False, False, True), (False, False, True)]
    assert after == (True, True)                      # restored


@pytest.mark.parametrize("mesh", [(1, 2, 1), (2, 1, 2)])
def test_the_sharded_step_matches_the_step(mesh):
    from srcnn_cpp_tpu_torch.models import SRCNN
    from srcnn_cpp_tpu_torch.parallel import make_mesh
    from srcnn_cpp_tpu_torch.train import (make_sharded_train_step,
                                           make_train_step, shard_batch)

    rng = np.random.default_rng(4)
    x = rng.integers(0, 256, (2, 20, 24), dtype=np.uint8)
    t = np.clip(x.astype(np.float32) * 1.02 - 2.0, 0, 255)
    m = make_mesh(*mesh, devices=["cpu"] * int(np.prod(mesh)))
    a, b = SRCNN.from_weights(), SRCNN.from_weights()
    sa = make_sharded_train_step(m, a, torch.optim.Adam(a.parameters(),
                                                        lr=1e-4, eps=1e-8))
    sb = make_train_step(b, torch.optim.Adam(b.parameters(), lr=1e-4,
                                             eps=1e-8))
    xs, ts = shard_batch(m, x), shard_batch(m, t)
    assert len(xs) == m.size and all(blk.device.type == "cpu" for blk in xs)
    for _ in range(2):
        la, lb = sa(xs, ts), sb(x, t)
        assert abs(la - lb) <= 1e-5 * abs(lb)


# --- the data pipeline ---------------------------------------------------------

@pytest.mark.parametrize("scale", [2.0, 3.0])
def test_patches_match_jax(scale):
    from srcnn_cpp_tpu.train.data import patches_from_image as jax_patches
    from srcnn_cpp_tpu_torch.imageio import imread_bgr
    from srcnn_cpp_tpu_torch.train.data import patches_from_image

    bgr = imread_bgr(Path(__file__).parent / "data/eval/butterfly.png")
    assert bgr is not None
    rng_a, rng_b = np.random.default_rng(5), np.random.default_rng(5)
    lr, hr = patches_from_image(bgr, scale, rng=rng_a, max_patches=500)
    jlr, jhr = jax_patches(bgr, scale, rng=rng_b, max_patches=500)
    assert lr.shape == jlr.shape == hr.shape == (500, 33, 33)
    assert lr.dtype == hr.dtype == np.uint8
    assert np.array_equal(hr, jhr)
    d = np.abs(lr.astype(int) - jlr.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < LR_LSB_SHARE


def test_dataset_and_minibatches_match_jax(tmp_path):
    from srcnn_cpp_tpu.train.data import dataset_from_dir as jax_dataset
    from srcnn_cpp_tpu.train.data import iterate_minibatches as jax_batches
    from srcnn_cpp_tpu_torch.train.data import (dataset_from_dir,
                                                iterate_minibatches)

    d = _images(tmp_path, n=3, size=70)
    x, t = dataset_from_dir(d, scale=2.0, seed=3)
    jx, jt = jax_dataset(d, scale=2.0, seed=3)
    assert x.shape == jx.shape and len(x) == 3 * 9
    assert np.array_equal(t, jt)
    diff = np.abs(x.astype(int) - jx.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < LR_LSB_SHARE
    ours = iterate_minibatches(x, t, 8, seed=2, epochs=2)
    theirs = jax_batches(x, t, 8, seed=2, epochs=2)
    n = 0
    for (a, b), (c, e) in zip(ours, theirs, strict=True):
        assert np.array_equal(a, c) and np.array_equal(b, e)
        n += 1
    assert n == 2 * (27 // 8)


# --- fit and the CLI -----------------------------------------------------------

def test_fit_matches_the_jax_fit(tmp_path):
    from srcnn_cpp_tpu.train.trainer import fit as jax_fit
    from srcnn_cpp_tpu_torch.train import fit

    d = _images(tmp_path)
    w, losses = fit(d, steps=3, batch=8, lr=1e-4, verbose=False,
                    device="cpu")
    jw, jlosses = jax_fit(d, steps=3, batch=8, lr=1e-4, verbose=False)
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    assert w.device.type == "cpu" and w.config == (64, 32, 9, 1, 5)


def test_fit_from_scratch_is_seeded(tmp_path):
    from srcnn_cpp_tpu_torch.train import fit

    d = _images(tmp_path)
    runs = [fit(d, steps=2, batch=8, from_pretrained=False, seed=4,
                verbose=False, device="cpu") for _ in range(2)]
    assert runs[0][1] == runs[1][1] and np.isfinite(runs[0][1]).all()
    assert torch.equal(runs[0][0].conv1_w, runs[1][0].conv1_w)


def test_fit_refuses_cuda_without_a_gpu_and_short_datasets(tmp_path,
                                                           monkeypatch):
    from srcnn_cpp_tpu_torch.train import fit

    d = _images(tmp_path)
    with pytest.raises(ValueError, match="fewer than one batch"):
        fit(d, steps=1, batch=64, verbose=False, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit(d, steps=1, batch=8, verbose=False, device="cuda")


def test_train_cli_help(capsys):
    from srcnn_cpp_tpu_torch.train.trainer import main

    with pytest.raises(SystemExit) as e:
        main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "--data" in out and "--device" in out


def test_train_cli_cpu_run_writes_weights_that_serve(tmp_path):
    from srcnn_cpp_tpu_torch.pipeline import upscale_bgr
    from srcnn_cpp_tpu_torch.train import fit
    from srcnn_cpp_tpu_torch.train.trainer import main
    from srcnn_cpp_tpu_torch.weights import load_weights

    (tmp_path / "data").mkdir()
    d = _images(tmp_path / "data")
    out = tmp_path / "trained.npz"
    assert main(["--data", str(d), "--steps", "2", "--batch", "8",
                 "--device=cpu", "--out", str(out)]) == 0
    trained = load_weights(out)
    want, _ = fit(d, steps=2, batch=8, verbose=False, device="cpu")
    for k, v in want.as_dict().items():
        assert torch.equal(getattr(trained, k), v), k
    assert not torch.equal(trained.conv1_w, load_weights().conv1_w)
    img = np.random.default_rng(2).integers(0, 256, (20, 24, 3),
                                            dtype=np.uint8)
    sr = upscale_bgr(img, 2.0, trained, device="cpu")
    assert sr.shape == (40, 48, 3) and sr.dtype == np.uint8


def test_train_cli_default_device_without_gpu_exits_1(tmp_path, monkeypatch,
                                                      capsys):
    from srcnn_cpp_tpu_torch.train.trainer import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["--data", str(tmp_path), "--out",
                 str(tmp_path / "x.npz")]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "x.npz").exists()


def test_train_cli_sharded_on_cpu(tmp_path, capsys):
    from srcnn_cpp_tpu_torch.train.trainer import fit, main
    from srcnn_cpp_tpu_torch.weights import load_weights

    out = tmp_path / "x.npz"
    assert main(["--data", str(_images(tmp_path)), "--sharded", "--steps=2",
                 "--batch=8", "--device=cpu", "--out", str(out)]) == 0
    assert "final mse" in capsys.readouterr().out
    w = load_weights(out)
    _, losses = fit(_images(tmp_path), steps=2, batch=8, verbose=False,
                    device="cpu")
    assert np.isfinite(losses).all() and w.conv1_w.shape == (64, 1, 9, 9)
