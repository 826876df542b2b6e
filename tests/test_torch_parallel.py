"""PyTorch port, ``parallel/``: meshes, the tilings of K1, K2 and K3, the
tiled ``single_8k`` (fed host arrays or tensors) and the sharded train
step, against the JAX package.

The port's meshes name the CPU 8 times; the JAX package runs on conftest's
8 virtual devices.  On the CPU every block runs its kernel's plain version.
Tolerances: the tilings are bit-equal to the port's monolithic functions
(the same taps in the same order per output pixel); the tiled conv is
within the conv bar of JAX ``srcnn_y_tiled(kernel="xla")`` (<=1 LSB on
< 5e-3 of pixels: split-precision bf16 matmuls on the JAX side); the
windowed pre-pass and the tiled merge are bit-equal to JAX's exact engines;
the sharded step's losses within 1e-4 (relative) and its updates within
5e-3 of the largest, as ``tests/test_train.py:55-63`` holds JAX's.
"""

import numpy as np
import pytest
import torch

CPU8 = ["cpu"] * 8


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _mesh(data, row, col=1):
    from srcnn_cpp_tpu_torch.parallel import make_mesh

    return make_mesh(data=data, row=row, col=col,
                     devices=["cpu"] * (data * row * col))


def _jax_mesh(data, row, col=1):
    import jax
    from srcnn_cpp_tpu.parallel import make_mesh

    return make_mesh(data=data, row=row, col=col,
                     devices=jax.devices()[:data * row * col])


@pytest.fixture(scope="module")
def tweights(weights):
    from srcnn_cpp_tpu_torch.weights import from_jax_params

    return from_jax_params(weights)


# --- the mesh ------------------------------------------------------------------

def test_make_mesh_matches_jax():
    import jax

    from srcnn_cpp_tpu.parallel import make_mesh as jax_mesh
    from srcnn_cpp_tpu_torch.parallel import make_mesh

    for kw in ({}, {"data": 4}, {"data": 1, "row": 4, "col": 2},
               {"row": 2}):
        m = make_mesh(devices=CPU8, **kw)
        assert m.shape == dict(jax_mesh(devices=jax.devices(), **kw).shape)
        assert m.devices.shape == tuple(m.shape.values())
        assert all(d == torch.device("cpu") for d in m.devices.flat)
        assert m.local_blocks() == list(np.ndindex(*m.devices.shape))
    with pytest.raises(ValueError):
        make_mesh(data=3, row=3, devices=CPU8)


def test_make_mesh_without_a_card_raises(monkeypatch):
    from srcnn_cpp_tpu_torch.parallel import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


# --- K1 on tiles ---------------------------------------------------------------

@pytest.mark.parametrize("mesh,shape,seed", [
    ((2, 4, 1), (2, 64, 96), 0), ((1, 8, 1), (1, 128, 64), 3),
    ((1, 2, 4), (1, 64, 96), 7), ((2, 2, 2), (2, 48, 64), 8)])
def test_srcnn_y_tiled_matches_monolithic_and_jax(weights, tweights, mesh,
                                                  shape, seed):
    from srcnn_cpp_tpu.parallel import srcnn_y_tiled as jax_tiled
    from srcnn_cpp_tpu_torch.ops.cuda_srcnn import srcnn_y_fused
    from srcnn_cpp_tpu_torch.parallel import srcnn_y_tiled

    y = _u8(shape, seed)
    got = srcnn_y_tiled(torch.from_numpy(y), tweights, _mesh(*mesh)).numpy()
    assert got.shape == shape and got.dtype == np.uint8
    assert np.array_equal(got, srcnn_y_fused(torch.from_numpy(y),
                                             tweights).numpy())
    ref = np.asarray(jax_tiled(y, weights, _jax_mesh(*mesh), kernel="xla"))
    d = np.abs(got.astype(int) - ref.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 5e-3, (d.max(), (d > 0).mean())


def test_srcnn_y_tiled_border_pattern_runs_one_plain_call_per_block(tweights):
    # saturated rows and columns at every edge: the true-edge clamps happen
    # inside each block's conv, none is recomputed
    from srcnn_cpp_tpu_torch.ops.cuda_srcnn import srcnn_y_fused, srcnn_y_plain
    from srcnn_cpp_tpu_torch.parallel import srcnn_y_tiled

    g = np.meshgrid(np.arange(48), np.arange(200), indexing="ij")
    img = ((g[0] * 37 + g[1] * 11) % 256).astype(np.uint8)
    img[:3, :], img[:, :3], img[-3:, :], img[:, -3:] = 255, 0, 255, 0
    y = torch.from_numpy(np.stack([img, 255 - img]))
    mono = srcnn_y_fused(y, tweights)
    calls = srcnn_y_plain.calls
    got = srcnn_y_tiled(y, tweights, _mesh(2, 2, 2))
    assert srcnn_y_plain.calls - calls == 8
    assert torch.equal(got, mono)


def test_srcnn_y_tiled_rejects_bad_geometry(tweights):
    from srcnn_cpp_tpu_torch.parallel import srcnn_y_tiled, upscale_y_tiled

    with pytest.raises(ValueError, match="divisible"):
        srcnn_y_tiled(torch.zeros((2, 65, 64), dtype=torch.uint8), tweights,
                      _mesh(2, 4))
    with pytest.raises(ValueError, match="at least 6"):      # 5-row blocks
        srcnn_y_tiled(torch.zeros((1, 40, 64), dtype=torch.uint8), tweights,
                      _mesh(1, 8))
    with pytest.raises(ValueError, match="at least 6"):      # 4-column blocks
        upscale_y_tiled(torch.zeros((1, 64, 16), dtype=torch.uint8),
                        tweights, _mesh(1, 2, 4))


@pytest.mark.parametrize("mesh,shape", [((2, 4, 1), (61, 40)),
                                        ((2, 2, 2), (3, 61, 53))])
def test_upscale_y_tiled_uneven_matches_monolithic(tweights, mesh, shape):
    from srcnn_cpp_tpu_torch.ops.cuda_srcnn import srcnn_y_fused
    from srcnn_cpp_tpu_torch.parallel import upscale_y_tiled

    y = torch.from_numpy(_u8(shape, 5))
    got = upscale_y_tiled(y, tweights, _mesh(*mesh))
    assert got.shape == y.shape
    assert torch.equal(got, srcnn_y_fused(y, tweights))


# --- K2 and K3 on tiles --------------------------------------------------------

_PRE_CASES = [(2.0, (64, 160), None), (3.0, (64, 160), None),
              (1.5, (64, 160), None), (1.25, (64, 160), None),
              (0.75, (64, 160), None), (3.0, (540, 96), (1620, 288))]


@pytest.mark.parametrize("mesh", [(2, 4, 1), (1, 2, 4)])
@pytest.mark.parametrize("s,hw,out_hw", _PRE_CASES)
def test_pre_upscale_fused_rows_matches_jax_exact(mesh, s, hw, out_hw):
    from srcnn_cpp_tpu.ops.color import bgr2ycrcb_u8_planar
    from srcnn_cpp_tpu.ops.resize import resize_bicubic_u8
    from srcnn_cpp_tpu_torch.ops.resize import scaled_size
    from srcnn_cpp_tpu_torch.parallel import pre_upscale_fused_rows

    x = _u8((2, 3, *hw), int(10 * s) + hw[0])
    out_hw = out_hw or scaled_size(hw[1], hw[0], s)[::-1]
    got = pre_upscale_fused_rows(torch.from_numpy(x), out_hw, _mesh(*mesh))
    ref = np.asarray(resize_bicubic_u8(bgr2ycrcb_u8_planar(x), out_hw))
    assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("mesh", [(2, 4, 1), (1, 2, 4), (1, 4, 2)])
@pytest.mark.parametrize("s,hw,out_hw", _PRE_CASES)
def test_pre_pass_window_plans_hold_every_tap(mesh, s, hw, out_hw):
    # each block's window plan (ops/cuda_resize.py::pre_pass_plan with its
    # window) covers every tap of its output pixels inside its halo-extended
    # input block, as test_torch_conv_tc.py checks the whole plan
    from srcnn_cpp_tpu_torch.ops.cuda_resize import (PRE_SMEM_BUDGET,
                                                     PreWindow, pre_pass_plan,
                                                     window_tables)
    from srcnn_cpp_tpu_torch.ops.resize import scaled_size
    from srcnn_cpp_tpu_torch.parallel.tiling import pre_upscale_halos

    out_hw = out_hw or scaled_size(hw[1], hw[0], s)[::-1]
    halos = pre_upscale_halos(hw, out_hw, mesh)
    ri, ro, ci, co = halos.rows_in, halos.rows_out, halos.cols_in, \
        halos.cols_out
    for q in np.ndindex(*mesh):
        r, c = q[1], q[2]
        top = halos.top[q] if r > 0 else 0
        lft = halos.lft[q] if c > 0 else 0
        bot = halos.bot[q] if r < mesh[1] - 1 else 0
        rgt = halos.rgt[q] if c < mesh[2] - 1 else 0
        h = ri[r + 1] - ri[r] + top + bot
        w = ci[c + 1] - ci[c] + lft + rgt
        win = PreWindow(hw, (ro[r], ro[r + 1]), (co[c], co[c + 1]),
                        (ri[r] - top, ci[c] - lft))
        plan = pre_pass_plan(*out_hw, h, w, win)
        assert plan["out"] == (ro[r + 1] - ro[r], co[c + 1] - co[c])
        assert plan["smem_bytes"] <= PRE_SMEM_BUDGET
        (th, tw), (wh, ww) = plan["tile"], plan["win"]
        xi, _, yi, _ = window_tables(out_hw, win)
        for idx, t, org, span, n in ((xi, tw, plan["x0"], ww, w),
                                     (yi, th, plan["y0"], wh, h)):
            o = org[np.arange(idx.shape[0]) // t][:, None]
            assert ((idx >= o) & (idx < o + span) & (idx < n)
                    & (idx >= 0)).all()


def test_pre_pass_halo_at_x2_and_refusals():
    from srcnn_cpp_tpu_torch.parallel.tiling import pre_upscale_halos

    # x2: output row 2k reads source rows k-2 .. k+1, so a block reaches 2
    # rows above and 2 below its own
    h = pre_upscale_halos((64, 160), (128, 320), (2, 4, 1))
    assert h.top[:, 1:].min() == h.top.max() == 2
    assert h.bot[:, :-1].min() == h.bot.max() == 2
    # uneven: 63 rows split 16/16/16/15 and 126 output rows 32/32/31/31
    # (tensor_split's cuts).  Block 2 ends its output at row 94, whose
    # taps stop at source row 48: one row below its own
    u = pre_upscale_halos((63, 160), (126, 320), (2, 4, 1))
    assert u.rows_in == (0, 16, 32, 48, 63)
    assert u.rows_out == (0, 32, 64, 95, 126)
    assert u.top[:, :, 0].tolist() == [[0, 2, 2, 2]] * 2
    assert u.bot[:, :, 0].tolist() == [[2, 2, 1, 0]] * 2
    with pytest.raises(ValueError, match="past one neighbour"):
        pre_upscale_halos((4, 160), (8, 320), (1, 4, 1))   # 1-row blocks


@pytest.mark.parametrize("mesh,hw", [((2, 4, 1), (64, 192)),
                                     ((2, 2, 2), (64, 256)),
                                     ((2, 4, 1), (60, 192))])
def test_merge_fused_rows_matches_jax(mesh, hw):
    from srcnn_cpp_tpu.ops.pallas_merge import merge_ycrcb_to_bgr_fused
    from srcnn_cpp_tpu.parallel.tiling import \
        merge_ycrcb_to_bgr_fused_rows as jax_rows
    from srcnn_cpp_tpu_torch.parallel import merge_ycrcb_to_bgr_fused_rows

    y, up = _u8((2, *hw), 11), _u8((2, 3, *hw), 12)
    got = merge_ycrcb_to_bgr_fused_rows(torch.from_numpy(y),
                                        torch.from_numpy(up),
                                        _mesh(*mesh)).numpy()
    assert np.array_equal(got, np.asarray(merge_ycrcb_to_bgr_fused(y, up)))
    ref = jax_rows(y, up, _jax_mesh(*mesh))
    if ref is not None:
        assert np.array_equal(got, np.asarray(ref))


# --- single_8k over a mesh -----------------------------------------------------

@pytest.mark.parametrize("mesh,hw,scale", [
    ((1, 4, 1), (48, 64), 2.0), ((1, 2, 2), (40, 64), 1.5),
    ((2, 2, 1), (24, 40), 2.0),
    # uneven splits: rows or columns that the axis does not divide
    ((1, 8, 1), (37, 26), 1.5),      # JAX's tests/test_configs.py:57-69
    ((1, 2, 1), (1079, 64), 2.0), ((1, 1, 2), (64, 97), 2.0),
    ((1, 2, 2), (61, 53), 0.75)])
def test_single_8k_mesh_matches_unsharded(tweights, mesh, hw, scale):
    from srcnn_cpp_tpu_torch.configs import single_8k

    frame = _u8((*hw, 3), 13)
    got = single_8k(tweights, mesh=_mesh(*mesh), scale=scale)(frame)
    want = single_8k(tweights, scale=scale, device="cpu")(frame)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.array_equal(got, want)


def test_single_8k_mesh_uneven_matches_jax(weights, tweights):
    # the JAX runner serves 37x26 x1.5 over row 8 (it lets the partitioner
    # pad); the port splits unevenly.  The pipeline bar of
    # test_torch_pipeline.py: <=2 LSB, (diff > 1) on < 1e-5 of values (on
    # this 6,435-value frame 52 values differ by 1: the split-precision
    # bf16 conv of JAX's XLA path, as without a mesh)
    from srcnn_cpp_tpu.configs import single_8k as jax_single_8k
    from srcnn_cpp_tpu_torch.configs import single_8k

    frame = np.random.default_rng(3).integers(0, 256, (37, 26, 3),
                                              dtype=np.uint8)
    got = single_8k(tweights, mesh=_mesh(1, 8), scale=1.5)(frame)
    ref = jax_single_8k(weights, mesh=_jax_mesh(1, 8), scale=1.5,
                        kernel="xla")(frame)
    assert got.shape == ref.shape == (55, 39, 3)
    d = np.abs(got.astype(int) - np.asarray(ref).astype(int))
    assert d.max() <= 2, d.max()
    assert (d > 1).mean() < 1e-5, (d > 1).mean()


@pytest.mark.parametrize("mesh,hw,scale", [
    ((1, 4, 1), (48, 64), 2.0),
    ((1, 8, 1), (37, 26), 1.5)])     # uneven: 55 output rows over 8
@pytest.mark.parametrize("strided", [False, True])
def test_single_8k_mesh_takes_a_tensor(tweights, mesh, hw, scale, strided):
    # tensor in, tensor out on the input's device, bit-equal to the
    # host-array call, as the unmeshed runner
    from srcnn_cpp_tpu_torch.configs import single_8k

    frame = _u8((*hw, 3), 17)
    t = torch.from_numpy(frame.copy())
    if strided:
        t = t.transpose(0, 1).contiguous().transpose(0, 1)
        assert not t.is_contiguous()
    run = single_8k(tweights, mesh=_mesh(*mesh), scale=scale)
    got = run(t)
    want = run(frame)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert got.dtype == torch.uint8 and got.is_contiguous()
    assert isinstance(want, np.ndarray)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got, single_8k(tweights, scale=scale,
                                      device="cpu")(t))


def test_single_8k_mesh_tensor_matches_jax(weights, tweights):
    # the JAX meshed runner fed a device array, the port's a CPU tensor;
    # the pipeline bar, as test_single_8k_mesh_uneven_matches_jax
    import jax.numpy as jnp
    from srcnn_cpp_tpu.configs import single_8k as jax_single_8k
    from srcnn_cpp_tpu_torch.configs import single_8k

    frame = _u8((37, 26, 3), 5)
    got = single_8k(tweights, mesh=_mesh(1, 8), scale=1.5)(
        torch.from_numpy(frame))
    ref = jax_single_8k(weights, mesh=_jax_mesh(1, 8), scale=1.5,
                        kernel="xla")(jnp.asarray(frame))
    assert tuple(got.shape) == ref.shape == (55, 39, 3)
    d = np.abs(got.numpy().astype(int) - np.asarray(ref).astype(int))
    assert d.max() <= 2, d.max()
    assert (d > 1).mean() < 1e-5, (d > 1).mean()


def test_distributed_stream_keeps_even_row_shares(tweights):
    # single_8k splits unevenly; the multi-process stream still takes each
    # process's even share of the rows, as the JAX stream does
    from srcnn_cpp_tpu_torch.parallel.distributed import DistributedStream

    stream = DistributedStream(2.0, _mesh(1, 4), weights=tweights)
    with pytest.raises(ValueError, match="not divisible"):
        stream.push_local(_u8((1, 3, 37, 26), 1))
    assert stream.push_local(_u8((1, 3, 36, 26), 1)) is None
    assert next(stream.drain()).shape == (1, 3, 72, 52)


# --- the sharded train step ----------------------------------------------------

@pytest.fixture(scope="module")
def batch():
    x = _u8((4, 32, 32), 0)
    return x, np.clip(x.astype(np.float32) * 1.02 - 2.0, 0, 255)


def _updates(model, base):
    return {k: (p.detach() - getattr(base, k)).double()
            for k, p in model.named_parameters()}


def _assert_updates_close(got: dict, want: dict) -> None:
    for k, w in want.items():
        scale = float(w.abs().max()) + 1e-30
        np.testing.assert_allclose(got[k].numpy() / scale, w.numpy() / scale,
                                   atol=5e-3, err_msg=k)


@pytest.mark.parametrize("mesh", [(2, 4, 1), (2, 2, 2)])
def test_sharded_step_matches_jax_and_make_train_step(weights, tweights,
                                                      batch, mesh):
    import optax

    from srcnn_cpp_tpu.train import make_sharded_train_step as jax_sharded
    from srcnn_cpp_tpu.train.step import shard_batch as jax_shard
    from srcnn_cpp_tpu_torch.models import SRCNN
    from srcnn_cpp_tpu_torch.train import (make_sharded_train_step,
                                           make_train_step, shard_batch)

    x, t = batch
    m = _mesh(*mesh)
    sharded, single = SRCNN.from_weights(tweights), SRCNN.from_weights(tweights)
    step = make_sharded_train_step(m, sharded, torch.optim.SGD(
        sharded.parameters(), lr=1e-9))
    loss = step(shard_batch(m, x), shard_batch(m, t))
    loss1 = make_train_step(single, torch.optim.SGD(single.parameters(),
                                                    lr=1e-9))(x, t)
    assert abs(loss - loss1) <= 1e-4 * abs(loss1)
    _assert_updates_close(_updates(sharded, tweights),
                          _updates(single, tweights))
    # the JAX step on the JAX mesh of the same (data, row) shape
    jm = _jax_mesh(mesh[0], mesh[1])
    opt = optax.sgd(1e-9)
    w2, _, jloss = jax_sharded(jm, opt)(weights, opt.init(weights),
                                        jax_shard(jm, x), jax_shard(jm, t))
    assert abs(loss - float(jloss)) <= 1e-4 * abs(float(jloss))
    jax_upd = {k: torch.from_numpy(np.asarray(getattr(w2, k))
                                   - np.asarray(getattr(weights, k))).double()
               for k in _updates(single, tweights)}
    _assert_updates_close(_updates(sharded, tweights), jax_upd)


def test_shard_batch_places_the_blocks(batch):
    from srcnn_cpp_tpu_torch.train import shard_batch

    x, _ = batch
    blocks = shard_batch(_mesh(2, 2, 2), x)
    assert len(blocks) == 8
    assert all(b.shape == (2, 16, 16) and b.is_contiguous() for b in blocks)
    assert np.array_equal(blocks[3].numpy(), x[:2, 16:, 16:])
    assert np.array_equal(blocks[4].numpy(), x[2:, :16, :16])


def test_sharded_step_learns_over_steps(tweights, batch):
    from srcnn_cpp_tpu_torch.models import SRCNN
    from srcnn_cpp_tpu_torch.train import make_sharded_train_step

    x, t = batch
    model = SRCNN.from_weights(tweights)
    step = make_sharded_train_step(_mesh(2, 4), model, torch.optim.Adam(
        model.parameters(), lr=1e-6, eps=1e-8))
    losses = [step(x, t) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_halo_exchange_functions(tweights):
    # the named exchanges over a grid of blocks: neighbour rows at seams,
    # replicate rows at the true edges; the feature clamp at true edges only
    from srcnn_cpp_tpu_torch.parallel.tiling import (
        _clamp_feature_edges, _halo_exchange_cols_asym,
        _halo_exchange_rows, _halo_exchange_rows_asym, split_blocks)

    m = _mesh(1, 4, 2)
    y = torch.arange(32 * 20, dtype=torch.int32).reshape(1, 32, 20)
    blocks = split_blocks(y, m)
    ext = _halo_exchange_rows(blocks, m, 3)
    pad = torch.cat([y[:, :1].expand(1, 3, 20), y,
                     y[:, -1:].expand(1, 3, 20)], dim=1)
    for r in range(4):
        assert torch.equal(ext[0, r, 1], pad[:, 8 * r:8 * r + 14, 10:])
    asym = _halo_exchange_rows_asym(blocks, m, 1, 2, edge=None)
    assert torch.equal(asym[0, 0, 0], y[:, 0:10, :10])
    assert torch.equal(asym[0, 2, 0], y[:, 15:26, :10])
    cols = _halo_exchange_cols_asym(blocks, m, 2, 1)
    assert torch.equal(cols[0, 1, 0], torch.cat(
        [y[:, 8:16, :1], y[:, 8:16, :1], y[:, 8:16, :11]], dim=2))
    f = np.empty(m.devices.shape, dtype=object)
    for q in m.local_blocks():
        f[q] = torch.arange(12.0).reshape(1, 1, 12, 1).repeat(1, 2, 1, 3)
    top, mid = _clamp_feature_edges(f, m, 1)[0, 0, 0], \
        _clamp_feature_edges(f, m, 1)[0, 1, 0]
    assert top[0, 0, :, 0].tolist() == [2, 2] + list(range(2, 10)) + [10, 11]
    assert torch.equal(mid, f[0, 1, 0])
