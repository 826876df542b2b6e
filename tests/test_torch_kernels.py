"""PyTorch port, kernel modules: K1 (cuda_srcnn), K2 (cuda_resize), K3 (cuda_merge).

On the CPU each wrapper runs its plain PyTorch version; those tests hold the
wrapper against the JAX package's Pallas kernel (interpret mode on the CPU
backend, as the JAX package's own tests run it) and its XLA path.
Tolerances: K1 <=1 LSB on < 5e-3 of pixels (split-precision bf16 matmuls on
the JAX side, fp32 on the port's plain path); K2 <=1 LSB on < 1e-4 of pixels (XLA:CPU
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
    # the 3xTF32 layout: hi and lo planes of w1 [88][64], w2 [64][32] and
    # w3 [32][32], each in wgmma's K-major core matrices (unswizzled: per
    # k8 step, n-block and K half, 8 rows of n by 4 floats of k), biases in
    # between
    from srcnn_cpp_tpu_torch.ops.cuda_srcnn import (PACKED_SIZE, c_to_a_perm,
                                                    pack_weights)

    p = pack_weights(tweights)
    assert p.shape == (PACKED_SIZE,) and p.dtype == torch.float32
    assert pack_weights(tweights) is p              # cached per weights

    def plane(off, k, n):
        blk = p[off:off + k * n].reshape(k // 8, n // 8, 2, 8, 4)
        return blk.permute(0, 2, 4, 1, 3).reshape(k, n)   # (s,kc,k4),(nb,n8)

    perm = c_to_a_perm()
    want = {
        (0, 5632): (88, 64, torch.cat([tweights.conv1_w.reshape(64, 81).t(),
                                       torch.zeros((7, 64))])),
        (11328, 13376): (64, 32, tweights.conv2_w.reshape(32, 64)[:, perm].t()),
        (15456, 16480): (32, 32, torch.cat(
            [tweights.conv3_w.reshape(32, 25)[perm[:32]],
             torch.zeros((32, 7))], dim=1)),
    }
    for (off_hi, off_lo), (k, n, w) in want.items():
        hi, lo = plane(off_hi, k, n), plane(off_lo, k, n)
        assert not (hi.view(torch.int32) & 0x1FFF).any()   # low 13 bits clear
        rel = ((hi + lo - w).abs() / w.abs().clamp_min(1e-30)).max()
        assert float(rel) <= 2.0 ** -21, (off_hi, float(rel))
        assert torch.equal(hi + lo, w)                  # exact in fp32
        assert not (hi[w == 0].any() or lo[w == 0].any())  # zero padding
    assert not plane(0, 88, 64)[81:].any()              # K padded to 88
    assert torch.equal(p[11264:11328], tweights.conv1_b)
    assert torch.equal(p[15424:15456], tweights.conv2_b)
    assert p[17504] == tweights.conv3_b[0] and not p[17505:].any()


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


@pytest.mark.parametrize("b,h,w,offsets", [
    (1, 1, 1, (0, 0, 0)), (3, 7, 13, (0, 0, 0)),       # odd planes
    (2, 37, 131, (0, 0, 0)), (1, 33, 48, (0, 0, 0)),   # H*W % 16 != 0, == 0
    (2, 64, 96, (0, 0, 0)), (2, 64, 96, (1, 0, 0)),    # misaligned Y'
    (2, 64, 96, (0, 3, 0)), (2, 64, 96, (16, 48, 0)),  # whole 16-byte words
    (2, 64, 96, (5, 5, 5)), (1, 2, 8, (9, 9, 9)),      # a shared head
    (3, 16, 40, (0, 0, 8))])
def test_merge_plan_covers_every_byte_once(b, h, w, offsets):
    # K3's plan, decoded as merge.cu's two kernels decode it, writes each
    # byte of [B,3,H,W] exactly once, with 16-byte accesses exactly where
    # every frame's six planes share their alignment, and all of them aligned
    from srcnn_cpp_tpu_torch.ops.cuda_merge import MERGE_BLOCK, merge_plan

    plane = h * w
    bases = [(1 << 20) * (i + 1) + off for i, off in enumerate(offsets)]
    plan = merge_plan(b, h, w, num_sms=132, addrs=tuple(bases))
    shared = plane % 16 == 0 and len({p % 16 for p in bases}) == 1
    assert plan["vec"] == (16 if shared else 1)
    assert plan["units"] == b * plan["per_frame"]
    count = np.zeros((b, 3, plane), dtype=np.int64)
    if not shared:
        # merge_pixel_kernel: block (x, b), thread t -> pixel 256 x + t
        assert plan["per_frame"] == plane and plan["head"] == 0
        assert plan["grid"] * MERGE_BLOCK >= plane > (plan["grid"] - 1) * 256
        for x in range(plan["grid"]):
            px = [p for p in range(256 * x, 256 * x + 256) if p < plane]
            count[:, :, px] += 1
        assert (count == 1).all()
        return
    # merge_vec_kernel: unit k of frame b, k = 0 the head, k >= 1 16 pixels
    assert 1 <= plan["grid"] <= 132 * 4
    assert plan["grid"] * MERGE_BLOCK >= min(plan["units"], 132 * 4 * 256)
    head = plan["head"]
    for bb in range(b):
        o = bases[2] + 3 * bb * plane
        planes = (bases[0] + bb * plane, bases[1] + (3 * bb + 1) * plane,
                  bases[1] + (3 * bb + 2) * plane, o, o + plane, o + 2 * plane)
        vec_units = 0
        for k in range(plan["per_frame"]):
            s = 0 if k == 0 else head + 16 * (k - 1)
            e = head if k == 0 else min(s + 16, plane)
            if e - s == 16:
                vec_units += 1
                assert all((p + s) % 16 == 0 for p in planes)
            count[bb, :, s:max(s, e)] += 1
        assert vec_units == (plane - head) // 16, (bb, vec_units)
    assert (count == 1).all()


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
                                   (17, 130), (3, 48, 200), (2, 1079, 1921),
                                   (1, 16, 8)])
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
                                     ((2, 3, 540, 960), 0.75),
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


def _at_offset(t, offset):
    """Contiguous copy of u8 ``t`` starting ``offset`` bytes into a buffer."""
    buf = torch.empty(t.numel() + offset, dtype=torch.uint8, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,y_off,up_off", [
    (1, 1, 1, 0, 0), (3, 7, 13, 0, 0), (2, 1079, 1921, 0, 0),   # ragged
    (2, 64, 96, 1, 0), (2, 64, 96, 0, 3), (2, 64, 96, 1, 1),    # misaligned
    (2, 64, 96, 16, 48), (2, 7, 13, 5, 9)])
def test_cuda_merge_ragged_and_misaligned(cuda, b, h, w, y_off, up_off):
    # K3's per-pixel heads, tails and frames beside its 16-byte units
    from srcnn_cpp_tpu_torch.ops.cuda_merge import (merge_plain,
                                                    merge_ycrcb_to_bgr_fused)

    y = _dev(_u8((b, h, w), h + y_off), cuda)
    up = _dev(_u8((b, 3, h, w), w + up_off), cuda)
    ym, upm = _at_offset(y, y_off), _at_offset(up, up_off)
    assert ym.data_ptr() % 16 == y_off % 16 and ym.is_contiguous()
    got = merge_ycrcb_to_bgr_fused(ym, upm)
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


@pytest.mark.cuda
def test_cuda_tensor_in_tensor_out(cuda, cuda_weights):
    # a frame batch on the card stays there: relayout in and out on the
    # card, one launch of each kernel, the HWC result returned unfetched
    from srcnn_cpp_tpu_torch.ops.cuda_merge import merge_ycrcb_to_bgr_fused
    from srcnn_cpp_tpu_torch.ops.cuda_resize import pre_upscale_fused
    from srcnn_cpp_tpu_torch.ops.cuda_srcnn import srcnn_y_fused
    from srcnn_cpp_tpu_torch.pipeline import upscale_bgr_batch, upscale_planar

    frames = _u8((2, 40, 136, 3), 6)
    x = _dev(frames, cuda)
    wrappers = (pre_upscale_fused, srcnn_y_fused, merge_ycrcb_to_bgr_fused)
    counts = [f.launches for f in wrappers]
    out = upscale_bgr_batch(x, 2.0, cuda_weights, device=cuda)
    assert [f.launches for f in wrappers] == [c + 1 for c in counts]
    assert isinstance(out, torch.Tensor) and out.device.type == "cuda"
    assert out.shape == (2, 80, 272, 3) and out.is_contiguous()
    ref = upscale_planar(x.permute(0, 3, 1, 2).contiguous(), cuda_weights,
                         (80, 272)).permute(0, 2, 3, 1)
    assert torch.equal(out, ref)
    # a host array on the card: one contiguous host array, within the bar
    # of the plain path on the CPU
    got = upscale_bgr_batch(frames, 2.0, cuda_weights, device=cuda)
    assert isinstance(got, np.ndarray) and got.flags.c_contiguous
    assert np.array_equal(got, out.cpu().numpy())
    plain = upscale_bgr_batch(frames, 2.0, cuda_weights.to("cpu"),
                              device="cpu")
    d = np.abs(got.astype(int) - plain.astype(int))
    assert d.max() <= 2 and (d > 1).mean() < 1e-5


# --- the tiled callers (parallel/tiling.py) -----------------------------------

def _window_of(x, out_hw, rows, cols):
    """K2's window ``rows`` x ``cols`` of ``x``'s resize and the input block
    it reads: from the windows' smallest tap to its largest."""
    from srcnn_cpp_tpu_torch.ops.cuda_resize import PreWindow, window_source

    h, w = x.shape[2:]
    (s0, s1), (t0, t1) = window_source(out_hw, (h, w), rows, cols)
    return (x[:, :, s0:s1, t0:t1].contiguous(),
            PreWindow((h, w), rows, cols, (s0, t0)))


_WINDOW_CASES = [(2.0, (1, 3), (1, 4)), (1.5, (0, 2), (2, 4)),
                 (0.75, (1, 2), (0, 1)), (3.0, (2, 3), (1, 2))]


@pytest.mark.parametrize("s,rows,cols", _WINDOW_CASES)
def test_windowed_pre_pass_equals_its_slice(s, rows, cols):
    # rows/cols in thirds and quarters of the output
    from srcnn_cpp_tpu_torch.ops.cuda_resize import pre_upscale_fused
    from srcnn_cpp_tpu_torch.ops.resize import scaled_size

    x = torch.from_numpy(_u8((2, 3, 60, 100), 7))
    ow, oh = scaled_size(100, 60, s)
    r = (oh * rows[0] // 3, oh * rows[1] // 3)
    c = (ow * cols[0] // 4, ow * cols[1] // 4)
    blk, win = _window_of(x, (oh, ow), r, c)
    got = pre_upscale_fused(blk, (oh, ow), win)
    assert torch.equal(got, pre_upscale_fused(x, (oh, ow))[:, :, r[0]:r[1],
                                                            c[0]:c[1]])


def test_windowed_pre_pass_refuses_a_short_block():
    from srcnn_cpp_tpu_torch.ops.cuda_resize import pre_upscale_fused

    x = torch.from_numpy(_u8((1, 3, 60, 100), 8))
    blk, win = _window_of(x, (120, 200), (40, 80), (0, 200))
    with pytest.raises(ValueError, match="taps reach"):
        pre_upscale_fused(blk[:, :, :-1].contiguous(), (120, 200), win)


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", [(1, 4, 1), (2, 2, 1), (1, 2, 2)])
def test_cuda_tiled_srcnn_bit_equal(cuda, cuda_weights, mesh):
    from srcnn_cpp_tpu_torch.ops.cuda_srcnn import srcnn_y_fused
    from srcnn_cpp_tpu_torch.parallel import make_mesh, upscale_y_tiled

    y = _dev(_u8((3, 261, 389), 3), cuda)
    m = make_mesh(*mesh, devices=[cuda] * 4)
    launches = srcnn_y_fused.launches
    got = upscale_y_tiled(y, cuda_weights, m)
    torch.cuda.synchronize()
    assert srcnn_y_fused.launches - launches == 4
    assert torch.equal(got, srcnn_y_fused(y, cuda_weights))


@pytest.mark.cuda
def test_cuda_single_8k_uneven_mesh_bit_equal(cuda, cuda_weights):
    # 37 rows in, 55 out over 8 row blocks: uneven splits, K2, K1 and K3
    # once per block on the card
    from srcnn_cpp_tpu_torch.configs import single_8k
    from srcnn_cpp_tpu_torch.ops.cuda_merge import merge_ycrcb_to_bgr_fused
    from srcnn_cpp_tpu_torch.ops.cuda_resize import pre_upscale_fused
    from srcnn_cpp_tpu_torch.ops.cuda_srcnn import srcnn_y_fused
    from srcnn_cpp_tpu_torch.parallel import make_mesh

    frame = _u8((37, 26, 3), 3)
    kernels = (pre_upscale_fused, srcnn_y_fused, merge_ycrcb_to_bgr_fused)
    before = [f.launches for f in kernels]
    got = single_8k(cuda_weights, mesh=make_mesh(1, 8, devices=[cuda] * 8),
                    scale=1.5)(frame)
    assert [f.launches - n for f, n in zip(kernels, before)] == [8, 8, 8]
    assert np.array_equal(got, single_8k(cuda_weights, scale=1.5,
                                         device=cuda)(frame))


@pytest.mark.cuda
@pytest.mark.parametrize("s,rows,cols", _WINDOW_CASES)
def test_cuda_windowed_pre_pass_equals_its_slice(cuda, s, rows, cols):
    from srcnn_cpp_tpu_torch.ops.cuda_resize import pre_upscale_fused
    from srcnn_cpp_tpu_torch.ops.resize import scaled_size

    x = _dev(_u8((2, 3, 540, 960), 9), cuda)
    ow, oh = scaled_size(960, 540, s)
    r = (oh * rows[0] // 3, oh * rows[1] // 3)
    c = (ow * cols[0] // 4, ow * cols[1] // 4)
    blk, win = _window_of(x, (oh, ow), r, c)
    launches = pre_upscale_fused.launches
    got = pre_upscale_fused(blk, (oh, ow), win)
    torch.cuda.synchronize()
    assert pre_upscale_fused.launches - launches == 1
    assert torch.equal(got, pre_upscale_fused(x, (oh, ow))[:, :, r[0]:r[1],
                                                            c[0]:c[1]])
