"""PyTorch port, kernel modules: K1 (cuda_srcnn), K2 (cuda_resize), K3 (cuda_merge).

On the CPU each wrapper runs its plain PyTorch version; those tests hold the
wrapper against the JAX package's Pallas kernel (interpret mode on the CPU
backend, as the JAX package's own tests run it) and its XLA path.
Tolerances: K1 <=1 LSB on < 5e-3 of pixels (split-precision bf16 matmuls on
the JAX side, fp32 on the port's); K2 <=1 LSB on < 1e-4 of pixels (XLA:CPU
FMA contraction on the JAX side, srcnn_cpp_tpu/ops/pallas_resize.py:28-37);
K3 bit-exact.

Tests marked ``cuda`` compare each CUDA kernel with its plain version on the
card and skip without one.  They import neither JAX nor the test conftest,
so on a GPU host without JAX they run with
``python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -o addopts=""``.
"""

import numpy as np
import pytest
import torch


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _lsb(a, b):
    d = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
    return d.max(), (d > 0).mean()


@pytest.fixture(scope="module")
def tweights(weights):
    from srcnn_cpp_tpu_torch.weights import from_jax_params

    return from_jax_params(weights)


# --- K1 ------------------------------------------------------------------------

@pytest.mark.parametrize("shape,seed", [((40, 520), 0), ((3, 32, 256), 9)])
def test_srcnn_y_fused_matches_jax(weights, tweights, shape, seed):
    from srcnn_cpp_tpu.ops.pallas_srcnn import srcnn_y_fused as jax_fused
    from srcnn_cpp_tpu.ops.srcnn import srcnn_y as jax_xla
    from srcnn_cpp_tpu_torch.ops.cuda_srcnn import srcnn_y_fused

    y = _u8(shape, seed)
    got = srcnn_y_fused(torch.from_numpy(y), tweights).numpy()
    assert got.shape == shape and got.dtype == np.uint8
    for ref in (jax_fused(y, weights), jax_xla(y, weights)):
        mx, frac = _lsb(got, ref)
        assert mx <= 1 and frac < 5e-3, (mx, frac)


def test_srcnn_y_fused_border_pattern(weights, tweights):
    # saturated frame, gradients and per-frame differences at the borders
    # (tests/test_pallas.py:147-163): the feature-level clamp of conv3
    from srcnn_cpp_tpu.ops.srcnn import srcnn_y as jax_xla
    from srcnn_cpp_tpu_torch.ops.cuda_srcnn import srcnn_y_fused

    g = np.meshgrid(np.arange(48), np.arange(200), indexing="ij")
    img = ((g[0] * 37 + g[1] * 11) % 256).astype(np.uint8)
    img[:3, :], img[:, :3], img[-3:, :], img[:, -3:] = 255, 0, 255, 0
    batch = np.stack([img, 255 - img, np.roll(img, 7, axis=1)])
    got = srcnn_y_fused(torch.from_numpy(batch), tweights).numpy()
    assert _lsb(got, jax_xla(batch, weights))[0] <= 1


def test_srcnn_wrapper_counts_plain_calls_on_cpu(tweights):
    from srcnn_cpp_tpu_torch.ops.cuda_srcnn import srcnn_y_fused, srcnn_y_plain

    launches, calls = srcnn_y_fused.launches, srcnn_y_plain.calls
    srcnn_y_fused(torch.zeros((1, 9, 9), dtype=torch.uint8), tweights)
    assert srcnn_y_fused.launches == launches
    assert srcnn_y_plain.calls == calls + 1


def test_pack_weights_layout(tweights):
    from srcnn_cpp_tpu_torch.ops.cuda_srcnn import PACKED_SIZE, pack_weights

    p = pack_weights(tweights)
    assert p.shape == (PACKED_SIZE,) and p.dtype == torch.float32
    w1 = p[:64 * 84].reshape(64, 84)
    assert torch.equal(w1[:, :81], tweights.conv1_w.reshape(64, 81))
    assert not w1[:, 81:].any()
    assert torch.equal(p[5376:5440], tweights.conv1_b)
    w2t = p[5440:7488].reshape(64, 32)
    assert torch.equal(w2t, tweights.conv2_w.reshape(32, 64).t())
    assert torch.equal(p[7488:7520], tweights.conv2_b)
    assert torch.equal(p[7520:8320], tweights.conv3_w.reshape(-1))
    assert p[8320] == tweights.conv3_b[0] and not p[8321:].any()


# --- K2 ------------------------------------------------------------------------

@pytest.mark.parametrize("ih,iw,s", [(64, 96, 2), (54, 172, 1.5),
                                     (64, 128, 1.25), (64, 192, 0.75)])
def test_pre_upscale_fused_matches_jax(ih, iw, s):
    from srcnn_cpp_tpu.ops.pallas_resize import pre_upscale_fused as jax_pre
    from srcnn_cpp_tpu_torch.ops.cuda_resize import pre_upscale_fused
    from srcnn_cpp_tpu_torch.ops.resize import scaled_size

    x = _u8((2, 3, ih, iw), int(ih + iw + s))
    ow, oh = scaled_size(iw, ih, s)
    got = pre_upscale_fused(torch.from_numpy(x), (oh, ow)).numpy()
    ref = jax_pre(x, (oh, ow))
    assert ref is not None and got.shape == ref.shape == (2, 3, oh, ow)
    mx, frac = _lsb(got, ref)
    assert mx <= 1 and frac < 1e-4, (mx, frac)


# --- K3 ------------------------------------------------------------------------

@pytest.mark.parametrize("b,oh,ow", [(2, 64, 128), (2, 37, 131)])
def test_merge_fused_matches_jax(b, oh, ow):
    from srcnn_cpp_tpu.ops.pallas_merge import merge_ycrcb_to_bgr_fused as jm
    from srcnn_cpp_tpu_torch.ops.cuda_merge import merge_ycrcb_to_bgr_fused

    y, up = _u8((b, oh, ow), oh), _u8((b, 3, oh, ow), ow)
    got = merge_ycrcb_to_bgr_fused(torch.from_numpy(y), torch.from_numpy(up))
    ref = jm(y, up)
    assert ref is not None
    assert np.array_equal(got.numpy(), np.asarray(ref))


def test_merge_fused_clip_boundaries_match_jax():
    # every (y, cr) and (y, cb) pair on the clip boundaries
    # (tests/test_pallas_merge.py:37)
    from srcnn_cpp_tpu.ops.pallas_merge import merge_ycrcb_to_bgr_fused as jm
    from srcnn_cpp_tpu_torch.ops.cuda_merge import merge_ycrcb_to_bgr_fused

    y = np.tile(np.arange(256, dtype=np.uint8), (1, 8, 1))
    for cr, cb in [(0, 0), (255, 255), (0, 255), (255, 0), (128, 128)]:
        up = np.zeros((1, 3, 8, 256), dtype=np.uint8)
        up[:, 1], up[:, 2] = cr, cb
        got = merge_ycrcb_to_bgr_fused(torch.from_numpy(y),
                                       torch.from_numpy(up)).numpy()
        assert np.array_equal(got, np.asarray(jm(y, up))), (cr, cb)


# --- on the card: each kernel against its plain version ----------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def cuda_weights(cuda):
    from srcnn_cpp_tpu_torch.weights import load_weights

    return load_weights(device=cuda)


def _dev(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1080, 1920), (1, 1), (3, 7),
                                   (17, 130), (3, 48, 200)])
def test_cuda_srcnn_matches_plain(cuda, cuda_weights, shape):
    from srcnn_cpp_tpu_torch.ops.cuda_srcnn import srcnn_y_fused, srcnn_y_plain

    y = _dev(_u8(shape, sum(shape)), cuda)
    got = srcnn_y_fused(y, cuda_weights)
    torch.cuda.synchronize()
    mx, frac = _lsb(got.cpu(), srcnn_y_plain(y, cuda_weights).cpu())
    assert mx <= 1 and frac < 5e-3, (mx, frac)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,s", [((2, 3, 540, 960), 2.0),
                                     ((2, 3, 540, 960), 1.5),
                                     ((2, 3, 540, 960), 1.2),
                                     ((1, 3, 333, 517), 2.75)])
def test_cuda_pre_pass_matches_plain(cuda, shape, s):
    from srcnn_cpp_tpu_torch.ops.cuda_resize import (pre_upscale_fused,
                                                     pre_upscale_plain)
    from srcnn_cpp_tpu_torch.ops.resize import scaled_size

    x = _dev(_u8(shape, int(10 * s)), cuda)
    ow, oh = scaled_size(shape[3], shape[2], s)
    got = pre_upscale_fused(x, (oh, ow))
    torch.cuda.synchronize()
    assert torch.equal(got, pre_upscale_plain(x, (oh, ow)))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", [(2, 1080, 1920), (2, 537, 1111)])
def test_cuda_merge_matches_plain(cuda, b, h, w):
    from srcnn_cpp_tpu_torch.ops.cuda_merge import (merge_plain,
                                                    merge_ycrcb_to_bgr_fused)

    y, up = _dev(_u8((b, h, w), h), cuda), _dev(_u8((b, 3, h, w), w), cuda)
    got = merge_ycrcb_to_bgr_fused(y, up)
    torch.cuda.synchronize()
    assert torch.equal(got, merge_plain(y, up))


@pytest.mark.cuda
def test_cuda_pipeline_runs_the_kernels(cuda, cuda_weights):
    from srcnn_cpp_tpu_torch.ops.cuda_merge import merge_ycrcb_to_bgr_fused
    from srcnn_cpp_tpu_torch.ops.cuda_resize import pre_upscale_fused
    from srcnn_cpp_tpu_torch.ops.cuda_srcnn import srcnn_y_fused
    from srcnn_cpp_tpu_torch.pipeline import upscale_bgr_batch

    frames = _u8((2, 40, 136, 3), 5)
    counts = [f.launches for f in (pre_upscale_fused, srcnn_y_fused,
                                   merge_ycrcb_to_bgr_fused)]
    out = upscale_bgr_batch(frames, 2.0, cuda_weights, device=cuda)
    ref = upscale_bgr_batch(frames, 2.0, cuda_weights.to("cpu"), device="cpu")
    assert [f.launches for f in (pre_upscale_fused, srcnn_y_fused,
                                 merge_ycrcb_to_bgr_fused)] == \
        [c + 1 for c in counts]
    d = np.abs(out.astype(int) - ref.astype(int))
    assert d.max() <= 2 and (d > 1).mean() < 1e-5
