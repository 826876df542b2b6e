"""PyTorch port, K4 (conv + merge) and K5 (f32-output conv) of cuda_srcnn.

On the CPU each wrapper runs its plain PyTorch version; these tests hold it
against the JAX package: K4 against ``srcnn_merge_fused`` (its Pallas
kernel in interpret mode, as tests/test_pallas_merge.py runs it), K5
against the XLA ``srcnn_y_f32`` and against the legacy 8-matmul Pallas body
``_kernel``.  Tolerances: K4 <=1 LSB per channel on < 5e-3 of values (a
1-LSB Y difference from the JAX conv's split-precision matmuls moves each
BGR channel by at most 1); K5 ``atol`` 1e-2 against the fp32 XLA path
(fp32 sums in another order), and <=1 LSB after quantization against the
legacy body (split precision) on the interior.

Tests marked ``cuda`` compare each CUDA kernel with its plain version and
with K1 on the card, and skip without one; they need no JAX
(``python -m pytest tests/test_torch_conv_variants.py -m cuda --noconftest
-o addopts=""``).
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


# --- K4 ------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 24, 136), (2, 16, 130)])
def test_srcnn_merge_fused_matches_jax(weights, tweights, shape):
    import jax.numpy as jnp

    from srcnn_cpp_tpu.ops.pallas_srcnn import srcnn_merge_fused as jax_k4
    from srcnn_cpp_tpu_torch.ops.cuda_srcnn import srcnn_merge_fused

    b, h, w = shape
    up = _u8((b, 3, h, w), h + w)
    got = srcnn_merge_fused(torch.from_numpy(up), tweights).numpy()
    ref = np.asarray(jax_k4(jnp.asarray(up), weights))
    assert got.shape == ref.shape == (b, 3, h, w) and got.dtype == np.uint8
    mx, frac = _lsb(got, ref)
    assert mx <= 1 and frac < 5e-3, (mx, frac)


def test_srcnn_merge_plain_is_conv_then_merge(tweights):
    from srcnn_cpp_tpu_torch.ops.cuda_merge import merge_plain
    from srcnn_cpp_tpu_torch.ops.cuda_srcnn import (srcnn_merge_fused,
                                                    srcnn_y_plain)

    up = torch.from_numpy(_u8((2, 3, 9, 13), 3))
    launches = srcnn_merge_fused.launches
    got = srcnn_merge_fused(up, tweights)
    assert srcnn_merge_fused.launches == launches   # CPU: no kernel launch
    assert torch.equal(got, merge_plain(srcnn_y_plain(up[:, 0], tweights), up))


@pytest.mark.parametrize("bad", [
    torch.zeros((1, 3, 8, 8), dtype=torch.int32),         # dtype
    torch.zeros((3, 8, 8), dtype=torch.uint8),            # rank
    torch.zeros((1, 4, 8, 8), dtype=torch.uint8),         # channels
    torch.zeros((1, 3, 0, 8), dtype=torch.uint8),         # empty plane
    torch.zeros((1, 3, 8, 16), dtype=torch.uint8)[..., ::2],  # contiguity
    torch.zeros((1, 3, 8, 8), dtype=torch.uint8, device="meta"),  # device
])
def test_srcnn_merge_wrapper_rejects(tweights, bad):
    from srcnn_cpp_tpu_torch.ops.cuda_srcnn import srcnn_merge_fused

    with pytest.raises((TypeError, ValueError)):
        srcnn_merge_fused(bad, tweights)


# --- K5 ------------------------------------------------------------------------

@pytest.mark.parametrize("shape,seed", [((24, 136), 0), ((2, 17, 33), 1),
                                        ((1, 1), 2)])
def test_srcnn_y_f32_fused_matches_jax_xla(weights, tweights, shape, seed):
    from srcnn_cpp_tpu.ops.srcnn import srcnn_y_f32 as jax_f32
    from srcnn_cpp_tpu_torch.ops.cuda_srcnn import srcnn_y_f32_fused

    y = _u8(shape, seed)
    got = srcnn_y_f32_fused(torch.from_numpy(y), tweights).numpy()
    ref = np.asarray(jax_f32(y, weights))
    assert got.shape == ref.shape == shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2)


@pytest.mark.parametrize("h,w", [(16, 130), (24, 136)])
def test_srcnn_y_f32_fused_matches_jax_legacy_kernel(weights, tweights, h, w):
    # the legacy 8-matmul Pallas body, driven as srcnn_y_fused pads a plane
    # (pallas_srcnn.py:683-687) with 8 x 128 tiles; _fused_call adds b3 and
    # quantizes its f32 output.  With no row-clamp plan its outer 2 rows
    # and columns are unclamped by design (virtual-extension values, not
    # the reference's feature clamp that K5 carries), so only the interior
    # is compared.
    import jax.numpy as jnp

    from srcnn_cpp_tpu.ops.pallas_srcnn import _fused_call, _prep_weights
    from srcnn_cpp_tpu_torch.ops.cuda_srcnn import srcnn_y_f32_fused
    from srcnn_cpp_tpu_torch.ops.quantize import quantize_trunc_u8

    y = _u8((h, w), h * w)
    th, tw = 8, 128
    hp, wp = -(-h // th) * th, -(-w // tw) * tw
    ypad = jnp.pad(jnp.asarray(y), ((6, 10 + hp - h), (6, 122 + wp - w)),
                   mode="edge")
    ref = np.asarray(_fused_call(ypad, _prep_weights(weights, stacked=False),
                                 th, tw))[:h, :w]
    got = quantize_trunc_u8(srcnn_y_f32_fused(torch.from_numpy(y), tweights))
    mx, frac = _lsb(got.numpy()[2:-2, 2:-2], ref[2:-2, 2:-2])
    assert mx <= 1 and frac < 5e-3, (mx, frac)


def test_srcnn_y_f32_fused_quantizes_to_k1(tweights):
    from srcnn_cpp_tpu_torch.ops.cuda_srcnn import (srcnn_y_f32_fused,
                                                    srcnn_y_f32_plain,
                                                    srcnn_y_fused)
    from srcnn_cpp_tpu_torch.ops.quantize import quantize_trunc_u8

    y = torch.from_numpy(_u8((2, 11, 19), 4))
    launches, calls = srcnn_y_f32_fused.launches, srcnn_y_f32_plain.calls
    got = srcnn_y_f32_fused(y, tweights)
    assert srcnn_y_f32_fused.launches == launches
    assert srcnn_y_f32_plain.calls == calls + 1
    assert got.dtype == torch.float32 and got.shape == y.shape
    assert torch.equal(quantize_trunc_u8(got), srcnn_y_fused(y, tweights))


# --- on the card: K4 and K5 against their plain versions and K1 ----------------

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
@pytest.mark.parametrize("shape", [(2, 1080, 1920), (1, 17, 130), (3, 1, 1)])
def test_cuda_merge_conv_matches_k1_k3_and_plain(cuda, cuda_weights, shape):
    from srcnn_cpp_tpu_torch.ops.cuda_merge import merge_ycrcb_to_bgr_fused
    from srcnn_cpp_tpu_torch.ops.cuda_srcnn import (srcnn_merge_fused,
                                                    srcnn_merge_plain,
                                                    srcnn_y_fused)

    b, h, w = shape
    up = _dev(_u8((b, 3, h, w), h + w), cuda)
    launches = srcnn_merge_fused.launches
    got = srcnn_merge_fused(up, cuda_weights)
    assert srcnn_merge_fused.launches == launches + 1
    chained = merge_ycrcb_to_bgr_fused(srcnn_y_fused(up[:, 0], cuda_weights),
                                       up)
    torch.cuda.synchronize()
    assert torch.equal(got, chained)
    mx, frac = _lsb(got.cpu(), srcnn_merge_plain(up, cuda_weights).cpu())
    assert mx <= 1 and frac < 5e-3, (mx, frac)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2160, 3840), (1, 1), (3, 7), (2, 17, 130)])
def test_cuda_f32_conv_matches_k1_and_plain(cuda, cuda_weights, shape):
    from srcnn_cpp_tpu_torch.ops.cuda_srcnn import (srcnn_y_f32_fused,
                                                    srcnn_y_f32_plain,
                                                    srcnn_y_fused)
    from srcnn_cpp_tpu_torch.ops.quantize import quantize_trunc_u8

    y = _dev(_u8(shape, sum(shape)), cuda)
    launches = srcnn_y_f32_fused.launches
    got = srcnn_y_f32_fused(y, cuda_weights)
    assert srcnn_y_f32_fused.launches == launches + 1
    torch.cuda.synchronize()
    assert torch.equal(quantize_trunc_u8(got), srcnn_y_fused(y, cuda_weights))
    d = (got - srcnn_y_f32_plain(y, cuda_weights)).abs().max()
    assert float(d) <= 1e-2
