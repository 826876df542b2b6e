"""PyTorch port, the slice end to end: pipeline, raw-buffer API and model.

On the CPU the port's pipeline runs the plain versions of K2 -> K1 -> K3.
Tolerances: against the JAX pipeline <=2 LSB with (diff > 1) on < 1e-5 of
values and (diff > 0) on < 5e-3, the conv's own bar (a 1-LSB Y difference
from the JAX conv's split-precision matmuls, or from an XLA:CPU
FMA-contracted resize pixel, becomes up to 2 LSB in BGR through the
inverse color transform); against the reference binary's goldens the gate
of tests/test_pipeline.py:30-43 (<=2 LSB, (diff > 1) < 1e-5, PSNR > 55 dB).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from tests.conftest import GOLDEN

BUTTERFLY = Path(__file__).parent / "data" / "eval" / "butterfly.png"


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _assert_close_bgr(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    d = np.abs(got.astype(int) - ref.astype(int))
    assert d.max() <= 2, d.max()
    assert (d > 1).mean() < 1e-5 and (d > 0).mean() < 5e-3, \
        ((d > 1).mean(), (d > 0).mean())


def test_batch_matches_jax_fused_pallas_path(weights):
    # the JAX main path: _upscale_planar_jit(..., "pallas", "fused"), its
    # three Pallas kernels in interpret mode
    from srcnn_cpp_tpu.pipeline import _upscale_planar_jit
    from srcnn_cpp_tpu_torch.pipeline import upscale_bgr_batch
    from srcnn_cpp_tpu_torch.weights import from_jax_params

    planar = _u8((2, 3, 40, 136), 0)
    ref = np.asarray(_upscale_planar_jit(planar, weights, (80, 272), "pallas",
                                         "fused"))
    got = upscale_bgr_batch(np.moveaxis(planar, 1, -1), 2.0,
                            from_jax_params(weights), device="cpu")
    _assert_close_bgr(got, np.moveaxis(ref, 1, -1))


@pytest.mark.parametrize("shape,scale", [((2, 33, 47, 3), 2.0),
                                         ((1, 41, 67, 3), 1.5),
                                         ((3, 20, 24, 3), 0.75)])
def test_batch_matches_jax_xla_exact_path(weights, shape, scale):
    from srcnn_cpp_tpu.pipeline import upscale_bgr_batch as jax_batch
    from srcnn_cpp_tpu_torch.pipeline import upscale_bgr_batch
    from srcnn_cpp_tpu_torch.weights import from_jax_params

    frames = _u8(shape, int(10 * scale) + shape[1])
    ref = jax_batch(frames, scale, weights, kernel="xla", resize="exact")
    got = upscale_bgr_batch(frames, scale, from_jax_params(weights),
                            device="cpu")
    _assert_close_bgr(got, ref)


@pytest.mark.parametrize("scale,tag", [(1.5, "1.5"), (1.25, "1.25"),
                                       (0.75, "0.75")])
def test_golden_butterfly(scale, tag):
    from srcnn_cpp_tpu.utils.metrics import psnr
    from srcnn_cpp_tpu_torch.imageio import imread_bgr
    from srcnn_cpp_tpu_torch.pipeline import upscale_bgr

    img = imread_bgr(BUTTERFLY)
    assert img is not None and img.shape == (384, 384, 3)
    ref = imread_bgr(GOLDEN / f"butterfly_x{tag}_ref.png")
    out = upscale_bgr(img, scale, device="cpu")
    assert out.shape == ref.shape
    diff = np.abs(out.astype(int) - ref.astype(int))
    assert diff.max() <= 2, f"max LSB diff {diff.max()}"
    assert (diff > 1).mean() < 1e-5
    assert psnr(out, ref) > 55.0


@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_process_srcnn_matches_jax(weights, d):
    from srcnn_cpp_tpu.pipeline import process_srcnn as jax_process
    from srcnn_cpp_tpu_torch.pipeline import process_srcnn
    from srcnn_cpp_tpu_torch.weights import from_jax_params

    h, w = 24, 16
    buf = _u8(h * w * d, d)
    ref, n_ref = jax_process(buf, w, h, d, 2.0, weights, kernel="xla")
    got, n = process_srcnn(buf, w, h, d, 2.0, from_jax_params(weights),
                           device="cpu")
    assert n == n_ref == (2 * w) * (2 * h) * (3 if d == 2 else d)
    _assert_close_bgr(got, ref)
    if d == 4:   # alpha is the bit-exact bicubic of the alpha plane
        assert np.array_equal(got.reshape(2 * h, 2 * w, 4)[..., 3],
                              ref.reshape(2 * h, 2 * w, 4)[..., 3])


def test_process_srcnn_rejects_bad_depth():
    from srcnn_cpp_tpu_torch.pipeline import process_srcnn

    with pytest.raises(ValueError):
        process_srcnn(np.zeros(4 * 4 * 5, np.uint8), 4, 4, 5, 2.0,
                      device="cpu")


def test_tiny_and_odd_shapes():
    from srcnn_cpp_tpu_torch.ops.resize import scaled_size
    from srcnn_cpp_tpu_torch.pipeline import upscale_bgr

    for i, (h, w) in enumerate([(7, 5), (8, 9), (5, 40), (40, 5), (1, 1)]):
        out = upscale_bgr(_u8((h, w, 3), i), 2.0, device="cpu")
        ow, oh = scaled_size(w, h, 2.0)
        assert out.shape == (oh, ow, 3)


def test_model_from_jax_params_equals_checkpoint(weights):
    from srcnn_cpp_tpu_torch.models import SRCNN955
    from srcnn_cpp_tpu_torch.weights import from_jax_params, load_weights

    model = SRCNN955.from_weights(from_jax_params(weights))
    ckpt = load_weights()
    for k, v in ckpt.as_dict().items():
        p = getattr(model, k)
        assert p.shape == v.shape and torch.equal(p, v), k
        assert not p.requires_grad
    y = torch.from_numpy(_u8((2, 20, 30), 4))
    assert torch.equal(model(y), SRCNN955.from_weights()(y))


def test_weights_match_jax_loader(weights):
    from srcnn_cpp_tpu_torch.weights import load_weights

    w = load_weights()
    for k, v in w.as_dict().items():
        assert v.dtype == torch.float32
        assert np.array_equal(v.numpy(), np.asarray(getattr(weights, k)))
