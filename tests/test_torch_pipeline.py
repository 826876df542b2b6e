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


def test_weights_on_keeps_the_object_and_loads_the_checkpoint_once():
    from srcnn_cpp_tpu_torch.parallel import tiling
    from srcnn_cpp_tpu_torch.pipeline import weights_on
    from srcnn_cpp_tpu_torch.weights import load_weights

    w = load_weights()
    assert weights_on(w, "cpu") is w
    assert weights_on(w, torch.device("cpu")) is w
    default = weights_on(None, "cpu")
    assert weights_on(None, "cpu") is default
    assert weights_on(None, torch.device("cpu")) is default
    assert torch.equal(default.conv1_w, w.conv1_w)
    # one helper: the tiled K1 moves its weights the same way
    assert tiling.weights_on is weights_on


def test_host_array_calls_pack_the_default_weights_once():
    # what a launch on the card packs (pack_weights, cached per weights
    # object) is built once for the default checkpoint across calls
    from srcnn_cpp_tpu_torch.ops import cuda_srcnn
    from srcnn_cpp_tpu_torch.pipeline import upscale_bgr_batch, weights_on

    frames = _u8((1, 12, 16, 3), 8)
    first = upscale_bgr_batch(frames, 2.0, None, device="cpu")
    calls = cuda_srcnn._pack.calls
    packed = cuda_srcnn.pack_weights(weights_on(None, "cpu"))
    assert cuda_srcnn.pack_weights(weights_on(None, "cpu")) is packed
    assert cuda_srcnn._pack.calls <= calls + 1
    assert np.array_equal(upscale_bgr_batch(frames, 2.0, None, device="cpu"),
                          first)


# --- the HWC entry points: tensor in, tensor out; array in, array out --------

_SHAPES = [((2, 33, 47, 3), 2.0), ((1, 41, 67, 3), 1.5), ((3, 20, 24, 3), 0.75)]


@pytest.mark.parametrize("shape,scale", _SHAPES)
def test_tensor_input_returns_a_tensor_like_jax_device_arrays(weights, shape,
                                                              scale):
    # the JAX entry point relayouts a device array on the device and
    # returns a device array; the port does the same with a tensor
    import jax
    import jax.numpy as jnp
    from srcnn_cpp_tpu.pipeline import upscale_bgr_batch as jax_batch
    from srcnn_cpp_tpu_torch.ops.resize import scaled_size
    from srcnn_cpp_tpu_torch.pipeline import upscale_bgr_batch
    from srcnn_cpp_tpu_torch.weights import from_jax_params

    tw = from_jax_params(weights)
    frames = _u8(shape, int(10 * scale) + shape[1])
    got = upscale_bgr_batch(torch.from_numpy(frames), scale, tw, device="cpu")
    ow, oh = scaled_size(shape[2], shape[1], scale)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert got.dtype == torch.uint8 and got.shape == (shape[0], oh, ow, 3)
    assert np.array_equal(got.numpy(),
                          upscale_bgr_batch(frames, scale, tw, device="cpu"))
    ref = jax_batch(jnp.asarray(frames), scale, weights, kernel="xla",
                    resize="exact")
    assert isinstance(ref, jax.Array)
    _assert_close_bgr(got.numpy(), np.asarray(ref))


def test_non_contiguous_tensor_inputs():
    from srcnn_cpp_tpu_torch.pipeline import upscale_bgr_batch

    planar = torch.from_numpy(_u8((2, 3, 18, 26), 11))
    hwc = planar.permute(0, 2, 3, 1)                 # an HWC view of planes
    assert not hwc.is_contiguous()
    assert torch.equal(upscale_bgr_batch(hwc, 2.0, device="cpu"),
                       upscale_bgr_batch(hwc.contiguous(), 2.0, device="cpu"))
    big = torch.from_numpy(_u8((3, 40, 60, 3), 12))
    sl = big[::2, 3:37:2, 1::3]                      # a strided slice
    assert not sl.is_contiguous()
    assert torch.equal(upscale_bgr_batch(sl, 1.5, device="cpu"),
                       upscale_bgr_batch(sl.contiguous(), 1.5, device="cpu"))


def test_array_input_returns_one_contiguous_array(weights):
    # the same values as the host transposes on both sides gave
    from srcnn_cpp_tpu_torch.pipeline import upscale_bgr_batch, upscale_planar
    from srcnn_cpp_tpu_torch.weights import from_jax_params

    tw = from_jax_params(weights)
    frames = _u8((2, 21, 35, 3), 13)
    got = upscale_bgr_batch(frames, 2.0, tw, device="cpu")
    assert isinstance(got, np.ndarray) and got.flags.c_contiguous
    planar = torch.from_numpy(np.ascontiguousarray(np.moveaxis(frames, -1, 1)))
    before = np.moveaxis(upscale_planar(planar, tw, (42, 70)).numpy(), 1, -1)
    assert got.dtype == np.uint8 and np.array_equal(got, before)


def test_upscale_bgr_takes_one_tensor_image():
    from srcnn_cpp_tpu_torch.pipeline import upscale_bgr

    img = _u8((19, 23, 3), 14)
    got = upscale_bgr(torch.from_numpy(img), 2.0, device="cpu")
    assert isinstance(got, torch.Tensor) and got.shape == (38, 46, 3)
    assert np.array_equal(got.numpy(), upscale_bgr(img, 2.0, device="cpu"))
    with pytest.raises(TypeError):
        upscale_bgr(torch.from_numpy(img).float(), 2.0, device="cpu")


def test_batch_1080p_to_4k_joins_tensor_chunks():
    from srcnn_cpp_tpu_torch import configs

    frames = _u8((5, 12, 20, 3), 15)
    run = configs.batch_1080p_to_4k(batch=2, device="cpu")
    got = run(torch.from_numpy(frames))
    assert isinstance(got, torch.Tensor) and got.shape == (5, 24, 40, 3)
    ref = run(frames)
    assert isinstance(ref, np.ndarray)
    assert np.array_equal(got.numpy(), ref)
