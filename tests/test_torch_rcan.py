"""PyTorch port, RCAN x2 on the normal path (``weights.rcan``, ``ops.rcan``,
``ops.cuda_rcan``, ``pipeline.upscale_planar``).

On the CPU the network runs its plain ``F.conv2d`` path; these tests hold
the port's entry points against the benchmark's plain reference
(``portbench/reference/rcan_bgr.py``) on seeded weights at a reduced
depth (2 groups of 2 RCABs at the published widths) and small frames,
check the published container, its recipe and its MACs, drive the
benchmark's cell through ``run.run_cell`` at the published depth and a
small size, plant faults that its comparison must catch, check that the
paths which cannot take RCAN refuse it, and check the packed layers, the
launch order and the plan that the CUDA launcher reads.

Tests marked ``cuda`` compare the kernels with their plain versions on the
card; this file imports neither JAX nor the test conftest, so they run
with ``python -m pytest tests/test_torch_rcan.py -m cuda --noconftest -o
addopts=""``.
"""

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent.parent
RCAN_CU = REPO / "srcnn_cpp_tpu_torch/csrc/rcan.cu"
CONV_CUH = REPO / "srcnn_cpp_tpu_torch/csrc/conv3x3.cuh"
CONFIGS = REPO / "portbench/configs"
RECIPE = CONFIGS / "rcan_x2_seeded.jsonl"


def _make():
    spec = importlib.util.spec_from_file_location(
        "make_rcan_x2", CONFIGS / "make_rcan_x2.py")
    mk = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mk)
    return mk


def _frames(b, h, w, seed):
    """Frames with the gradients of images: a bilinear field plus noise."""
    g = torch.Generator().manual_seed(seed)
    coarse = torch.rand((b, 3, 3, 4), generator=g) * 200 + 28
    x = F.interpolate(coarse, size=(h, w), mode="bilinear")
    x = x + 12 * (torch.rand((b, 3, h, w), generator=g) - 0.5)
    return x.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1) \
        .contiguous().numpy()


def _lsb(a, b):
    d = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
    return d.max(), (d > 0).mean()


@pytest.fixture(scope="module")
def small_recipe(tmp_path_factory):
    """The recipe of 2 groups of 2 RCABs, the published widths and scales."""
    path = tmp_path_factory.mktemp("rcan") / "rcan_2x2.jsonl"
    mk = _make()
    mk.write(path, mk.recipe(groups=2, blocks=2))
    return path


@pytest.fixture(scope="module")
def small(small_recipe):
    from srcnn_cpp_tpu_torch.weights import load_rcan_weights

    return load_rcan_weights(small_recipe)


@pytest.fixture(scope="module")
def small_ref(small_recipe):
    from portbench.reference import rcan_bgr

    return rcan_bgr.load(small_recipe, "cpu")


@pytest.fixture(scope="module")
def rcan():
    from srcnn_cpp_tpu_torch.weights import load_rcan_weights

    return load_rcan_weights(RECIPE)


def _reference(frames, ref_weights, scale=2.0):
    from portbench.reference import rcan_bgr

    return np.stack([rcan_bgr.upscale_frame(torch.from_numpy(f), ref_weights,
                                            scale).numpy() for f in frames])


# --- the published network, its recipe and its work --------------------------

def test_the_container_holds_the_published_network(rcan):
    from srcnn_cpp_tpu_torch.weights import RCANWeights, weights_on
    from srcnn_cpp_tpu_torch.weights.rcan import rcan_shapes

    assert (rcan.groups, rcan.blocks) == (10, 20)
    assert sum(t.numel() for t in rcan.as_dict().values()) == 15_444_643
    keys = list(rcan.as_dict())
    assert keys == list(rcan_shapes())
    assert keys[:4] == ["head.0.weight", "head.0.bias",
                        "body.0.body.0.body.0.weight",
                        "body.0.body.0.body.0.bias"]
    assert keys[-6:] == ["body.10.weight", "body.10.bias",
                         "tail.0.0.weight", "tail.0.0.bias",
                         "tail.1.weight", "tail.1.bias"]
    assert tuple(rcan.params["body.9.body.19.body.3.conv_du.0.weight"]
                 .shape) == (4, 64, 1, 1)
    assert tuple(rcan.params["body.9.body.20.weight"].shape) == (64, 64, 3,
                                                                 3)
    assert tuple(rcan.params["tail.0.0.weight"].shape) == (256, 64, 3, 3)
    assert rcan.halo == float("inf") and weights_on(rcan, "cpu") is rcan
    moved = rcan.to("cpu")
    assert isinstance(moved, RCANWeights) and moved.groups == 10
    dropped = dict(rcan.params)
    del dropped["tail.1.bias"]
    with pytest.raises(ValueError):
        RCANWeights(dropped)


def test_macs_per_pixel_at_the_published_shapes(rcan):
    from portbench.reference import rcan_bgr

    shapes = {k: tuple(v.shape) for k, v in rcan.as_dict().items()}
    # a low-resolution pixel: head 1,728, 400 RCAB convs 14,745,600, 11
    # group and body convs 405,504, the upsampler 147,456; the tail 6,912
    # at 4 output pixels: 15,307,200, a quarter of it an output pixel
    assert 1_728 + 14_745_600 + 405_504 + 147_456 + 6_912 == 15_307_200
    assert rcan_bgr.macs_per_pixel(shapes) == 3_826_800 == 15_307_200 // 4


def test_the_recipe_expands_alike_in_the_loader_and_the_reference(rcan):
    from portbench.reference import rcan_bgr

    ref = rcan_bgr.load(RECIPE, "cpu")
    assert list(ref) == list(rcan.as_dict())
    for k, v in ref.items():
        assert v.dtype == torch.float32 and torch.equal(v, rcan.params[k]), k
    head, *rows = RECIPE.read_text().splitlines()
    assert json.loads(head)["seed"] == _make().SEED
    assert [json.loads(r)[0] for r in rows] == list(ref)
    w = rcan.params["body.3.body.7.body.0.weight"]
    assert abs(w.std().item() - np.sqrt(2 / 576)) < 0.02 * np.sqrt(2 / 576)
    assert not rcan.params["body.3.body.7.body.0.bias"].any()


def test_make_rcan_x2_regenerates_the_recipe_byte_for_byte(tmp_path):
    out = tmp_path / "again.jsonl"
    assert _make().main([str(out)]) == 0
    assert out.read_bytes() == RECIPE.read_bytes()


def test_an_npz_of_the_authors_keys_loads_by_name(small, tmp_path):
    from srcnn_cpp_tpu_torch.weights import load_rcan_weights, weights_npz

    arrays = {k: v.numpy() for k, v in small.as_dict().items()}
    # a converted RCAN_BIX2.pt also holds the mean shifts' fixed convs
    arrays["sub_mean.weight"] = np.eye(3, dtype=np.float32)[..., None, None]
    arrays["sub_mean.bias"] = np.zeros(3, np.float32)
    np.savez(tmp_path / "authors.npz", **arrays)
    got = load_rcan_weights(tmp_path / "authors.npz")
    assert (got.groups, got.blocks) == (2, 2)
    assert all(torch.equal(got.params[k], v) for k, v in small.params.items())
    with pytest.raises(ValueError, match="no RCAN checkpoint"):
        load_rcan_weights(weights_npz())


# --- the normal path against the reference ------------------------------------

def test_upscale_bgr_batch_runs_rcan_like_the_reference(small, small_ref):
    from srcnn_cpp_tpu_torch import upscale_bgr_batch
    from srcnn_cpp_tpu_torch.ops import cuda_rcan

    frames = _frames(2, 20, 24, 1)
    calls = cuda_rcan.rcan_plain.calls
    got = upscale_bgr_batch(frames, 2.0, small, device="cpu")
    assert cuda_rcan.rcan_plain.calls == calls + 1
    assert got.shape == (2, 40, 48, 3) and got.dtype == np.uint8
    # the same fp32 F.conv2d arithmetic, written twice: at most 1 LSB
    mx, frac = _lsb(got, _reference(frames, small_ref))
    assert mx <= 1 and frac < 1e-3, (mx, frac)


def test_the_configs_runner_and_the_stream_run_rcan(small, small_ref):
    from srcnn_cpp_tpu_torch.configs import batch_1080p_to_4k
    from srcnn_cpp_tpu_torch.stream import StreamUpscaler

    frames = _frames(3, 18, 22, 2)
    want = _reference(frames, small_ref)
    run = batch_1080p_to_4k(small, batch=2, device="cpu")
    got = run(frames)
    assert got.shape == (3, 36, 44, 3)
    assert _lsb(got, want)[0] <= 1
    tensor = run(torch.from_numpy(frames))
    assert isinstance(tensor, torch.Tensor)
    assert np.array_equal(tensor.numpy(), got)
    s = StreamUpscaler(2.0, weights=small, depth=2, device="cpu")
    outs = [o for f in frames for o in [s.push(f)] if o is not None]
    outs += s.drain()
    assert len(outs) == 3 and np.array_equal(np.stack(outs), got)


def test_a_frame_in_a_batch_is_the_frame_alone(small):
    from srcnn_cpp_tpu_torch import upscale_bgr_batch

    frames = _frames(4, 16, 20, 3)
    batch = upscale_bgr_batch(frames, 2.0, small, device="cpu")
    for i in (0, 2):
        alone = upscale_bgr_batch(frames[i:i + 1], 2.0, small, device="cpu")
        assert np.array_equal(batch[i], alone[0])


def test_the_pixel_shuffle_order():
    from srcnn_cpp_tpu_torch.ops.rcan import pixel_shuffle

    x = torch.arange(4 * 3 * 2 * 5, dtype=torch.float32).reshape(1, 12, 2, 5)
    y = pixel_shuffle(x)
    assert tuple(y.shape) == (1, 3, 4, 10)
    for c in range(3):
        for dy in (0, 1):
            for dx in (0, 1):
                assert torch.equal(y[0, c, dy::2, dx::2],
                                   x[0, 4 * c + 2 * dy + dx])


def test_the_upsampler_groups_shuffle_into_the_published_layer(small):
    """The launcher's four 64-channel output groups, each stored at its
    (dy, dx) of :data:`SHUFFLE`, make the conv 64->256 then
    ``PixelShuffle(2)``."""
    from srcnn_cpp_tpu_torch.ops.cuda_rcan import SHUFFLE, mid_order

    w, b = small.pair("tail.0.0")
    x = torch.randn((1, 64, 5, 7), generator=torch.Generator()
                    .manual_seed(4))
    want = F.pixel_shuffle(F.conv2d(x, w, b, padding=1), 2)
    got = torch.zeros_like(want)
    ups = [q for name, q in mid_order(2, 2) if q is not None]
    assert ups == [0, 1, 2, 3]
    for q in ups:
        dy, dx = SHUFFLE[q]
        got[:, :, dy::2, dx::2] = F.conv2d(x, w[q::4], b[q::4], padding=1)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_process_srcnn_runs_rcan_on_rgb_and_refuses_one_plane(small):
    from srcnn_cpp_tpu_torch import process_srcnn, upscale_bgr

    img = _frames(1, 12, 14, 5)[0]
    out, size = process_srcnn(img[..., ::-1].reshape(-1), 14, 12, 3, 2.0,
                              small, "cpu")
    assert size == 24 * 28 * 3
    want = upscale_bgr(img, 2.0, small, device="cpu")
    assert np.array_equal(out.reshape(24, 28, 3)[..., ::-1], want)
    with pytest.raises(TypeError, match="whole frame as its halo"):
        process_srcnn(img[..., 0].copy().reshape(-1), 14, 12, 1, 2.0, small,
                      "cpu")


@pytest.mark.parametrize("scale", [3.0, 1.5, 2.5])
def test_a_scale_other_than_2_raises(small, scale):
    from portbench.reference import rcan_bgr
    from srcnn_cpp_tpu_torch import upscale_bgr_batch
    from srcnn_cpp_tpu_torch.configs import single_8k

    frames = _frames(1, 10, 12, 6)
    with pytest.raises(ValueError, match="upscales by 2 only"):
        upscale_bgr_batch(frames, scale, small, device="cpu")
    with pytest.raises(ValueError, match="upscales by 2 only"):
        single_8k(small, scale=scale, device="cpu")(frames[0])
    with pytest.raises(ValueError):
        rcan_bgr.upscale_frame(torch.from_numpy(frames[0]), {}, scale)


# --- the benchmark's cell ---------------------------------------------------------

def _cell(hw=(8, 12)):
    """``rcan1080p.tensor`` at ``hw`` input frames, 4 distinct, 2 a call,
    at the published depth."""
    from portbench import spec

    cell = spec.cell("rcan1080p.tensor")
    cfg = dict(cell.config, in_hw=list(hw), out_hw=[2 * hw[0], 2 * hw[1]],
               frames_per_call=2, runner_kwargs={"batch": 2})
    return dataclasses.replace(cell, config=cfg, traffic=dict(
        cell.traffic, distinct_frames=4, warmup_units=1))


def test_the_cell_is_correct_at_a_small_size():
    from portbench import run

    r = run.run_cell(_cell(), 2 ** 31 + 101, 0.2, False, "cpu")
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0, r
    assert set(r["metrics"]) == {"out_mpps", "setup_s"}
    assert r["checks"]["max_lsb"]["value"] <= 1


def _no_attention(real):
    return lambda t, w, p: torch.ones_like(t.mean((2, 3), keepdim=True))


def _no_group_skip(real):
    from srcnn_cpp_tpu_torch.ops import rcan as ops

    def group(x, w, g):
        res = x
        for b in range(w.blocks):
            res = ops.rcab(res, w, g, b)
        return ops.conv(res, w, f"body.{g}.body.{w.blocks}")
    return group


def _shuffle_swapped(real):
    def shuffle(x):
        n, c4, h, w = x.shape
        x = x.reshape(n, c4 // 4, 2, 2, h, w).transpose(2, 3)
        return real(x.reshape(n, c4, h, w))
    return shuffle


def _no_mean_shift(real):
    return lambda device: torch.zeros((3, 1, 1), device=device)


def _red_blue_swapped(real):
    return lambda x: x


FAULTS = {"channel_attention": _no_attention,
          "residual_group": _no_group_skip,
          "pixel_shuffle": _shuffle_swapped,
          "rgb_mean": _no_mean_shift,
          "bgr_rgb": _red_blue_swapped}


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(monkeypatch, name):
    from portbench import run
    from srcnn_cpp_tpu_torch.ops import rcan as ops

    monkeypatch.setattr(ops, name, FAULTS[name](getattr(ops, name)))
    r = run.run_cell(_cell((10, 14)), 4_000_000_011, 0.2, False, "cpu")
    assert not r["correct"], r
    assert r["checks"]["share_off"]["value"] > 0.05, r["checks"]


# --- what refuses RCAN weights ---------------------------------------------------

WHOLE_FRAME = ("RCANWeights needs the whole frame as its halo (its "
               "receptive field), which it lacks")


def test_the_mesh_runner_refuses_rcan(small):
    from srcnn_cpp_tpu_torch.configs import single_8k
    from srcnn_cpp_tpu_torch.parallel import make_mesh

    mesh = make_mesh(2, 1, devices=["cpu"] * 2)
    with pytest.raises(TypeError) as e:
        single_8k(small, mesh=mesh)
    assert str(e.value) == ("single_8k(mesh=...) takes SRCNN weights only: "
                            f"its halo is SRCNN's 6 pixels; {WHOLE_FRAME}")


def test_tiling_refuses_rcan(small):
    from srcnn_cpp_tpu_torch.parallel import make_mesh
    from srcnn_cpp_tpu_torch.parallel.tiling import (split_blocks,
                                                     srcnn_blocks)

    mesh = make_mesh(1, 2, devices=["cpu"] * 2)
    y = torch.zeros((1, 16, 16), dtype=torch.uint8)
    with pytest.raises(TypeError, match="whole frame as its halo"):
        srcnn_blocks(split_blocks(y, mesh), small, mesh)


def test_distributed_refuses_rcan(small):
    from srcnn_cpp_tpu_torch.parallel.distributed import (DistributedStream,
                                                          frame_mesh)

    with pytest.raises(TypeError, match="whole frame as its halo"):
        DistributedStream(2.0, frame_mesh(1, devices=["cpu"]), weights=small)


def test_rcan_refuses_other_weights():
    from srcnn_cpp_tpu_torch.ops.cuda_rcan import rcan_fused
    from srcnn_cpp_tpu_torch.weights import load_weights

    with pytest.raises(TypeError, match="RCANWeights"):
        rcan_fused(torch.zeros((1, 3, 4, 4), dtype=torch.uint8),
                   load_weights(), (8, 8))


# --- the launch: packed layers, their order, the plan ---------------------------

def _constant(src, name):
    return int(re.search(rf"\b{name} = (\d+)", src).group(1))


def test_the_plan_mirrors_the_cuda_source():
    from srcnn_cpp_tpu_torch.ops import cuda_rcan as cr
    from srcnn_cpp_tpu_torch.ops import cuda_vdsr as cv

    src, cuh = RCAN_CU.read_text(), CONV_CUH.read_text()
    assert _constant(src, "MAPS") == cr.MAPS
    assert f'static_assert(CA_FLOATS == {cr.CA_FLOATS},' in cuh
    assert _constant(cuh, "POOL_PARTS") == cr.POOL_PARTS == cv.CONSUMERS
    assert _constant(cuh, "CONV3X3_LAYER_FLOATS") == cv.LAYER_FLOATS
    assert f"CONV3X3_SMEM_BYTES = 211968 + 48;" in cuh
    assert cv.vdsr_smem_bytes() == 211968 + 48
    for name, value in cr.EPILOGUES.items():
        assert f"EPI_{name.upper()} = {value}" in cuh
    for name, value in cr.LOADERS.items():
        assert f"LOAD_{name.upper()} = {value}" in cuh
    # the maps of launch_schedule: an RCAB's x in turn in xm and gout
    assert "(blocks - 1 - k) % 2 == 0 ? xm : gout" in src
    # the upsampler's group q at (dy, dx) = (q / 2, q % 2)
    assert "EpiArgs shuffle{nullptr, nullptr, q / 2, q % 2};" in src
    assert cr.SHUFFLE == tuple((q // 2, q % 2) for q in range(4))
    plan = cr.rcan_plan(1080, 1920, 132)
    assert plan["units"] == 540 * 15 and plan["grid"] == 132
    assert plan["smem_bytes"] == cv.vdsr_smem_bytes()
    px = 1080 * 1920
    # 6 maps, the upsampled one and the pool's sums; CA's s lives in the
    # conv's shared memory
    assert plan["workspace_floats"] == 10 * px * 64 + 132 * 2 * 64
    # the pool sums a loader stages in its shared memory
    assert plan["grid"] * cr.POOL_PARTS <= _constant(cuh, "CA_PARTS_MAX")
    assert cr.rcan_plan(3, 5, 132)["grid"] == 2
    assert len(cr.mid_order(10, 20)) == 411 + 4


def test_the_packed_buffers(small):
    from srcnn_cpp_tpu_torch.ops import cuda_rcan as cr
    from srcnn_cpp_tpu_torch.ops.cuda_vdsr import LAYER_FLOATS, pack_layer

    head, middle, ca, tail = (t.numpy() for t in cr.pack_rcan(small))
    w, b = small.pair("head.0")
    # [ci (RGB), ky, kx][co]
    assert head[(1 * 9 + 2 * 3 + 0) * 64 + 5] == w[5, 1, 2, 0]
    np.testing.assert_array_equal(head[27 * 64:], b.numpy())
    order = cr.mid_order(2, 2)
    assert middle.size == len(order) * LAYER_FLOATS == 15 * LAYER_FLOATS
    assert order[:3] == [("body.0.body.0.body.0", None),
                         ("body.0.body.0.body.2", None),
                         ("body.0.body.1.body.0", None)]
    assert order[4:6] == [("body.0.body.2", None),
                          ("body.1.body.0.body.0", None)]
    assert order[10:] == [("body.2", None)] + [("tail.0.0", q)
                                                for q in range(4)]
    for i in (1, 4, 10, 13):
        name, q = order[i]
        w, b = small.pair(name)
        if q is not None:
            w, b = w[q::4], b[q::4]
        np.testing.assert_array_equal(
            middle[i * LAYER_FLOATS:(i + 1) * LAYER_FLOATS],
            pack_layer(w, b).numpy())
    assert ca.size == 4 * cr.CA_FLOATS
    # W1 [4][64], b1, W2 [64][4], b2, as the loader's ca_finish reads them
    cuh = CONV_CUH.read_text()
    assert "CA_W1 = 0, CA_B1 = CA_HIDDEN * CONV3X3_C," in cuh
    assert "CA_W2 = CA_B1 + CA_HIDDEN," in cuh
    assert "CA_B2 = CA_W2 + CONV3X3_C * CA_HIDDEN," in cuh
    assert _constant(cuh, "CA_HIDDEN") == 4
    third = ca[2 * cr.CA_FLOATS:3 * cr.CA_FLOATS]       # group 1, RCAB 0
    w1, b1 = small.pair("body.1.body.0.body.3.conv_du.0")
    w2, b2 = small.pair("body.1.body.0.body.3.conv_du.2")
    np.testing.assert_array_equal(third, np.concatenate(
        [w1.reshape(-1), b1, w2.reshape(-1), b2]))
    w, b = small.pair("tail.1")
    # [RGB][ky, kx][ci]
    assert tail[(2 * 9 + 4) * 64 + 7] == w[2, 7, 1, 1]
    np.testing.assert_array_equal(tail[27 * 64:], [*b.numpy(), 0])


def _run_schedule(groups, blocks):
    """Interpret :func:`launch_schedule` on symbols: each map holds the
    expression of what was written to it.  Returns the upsampler's input."""
    from srcnn_cpp_tpu_torch.ops.cuda_rcan import launch_schedule

    maps = {"frame": "frame"}
    for kernel, epi, load, reads, writes in launch_schedule(groups, blocks):
        assert not set(reads) & set(writes), (kernel, epi, load, reads)
        got = [maps[m] for m in reads]
        if kernel == "head":
            maps["h"] = ("head", got[0])
            continue
        if kernel == "tail":
            return maps["hr"]
        if load == "plain":
            x = got[0]
        else:
            x = ("apply", got[0], got[1], got[2])
            if load == "apply":
                maps[writes[1]] = x
        if epi == "relu":
            maps["a"] = ("relu", x)
        elif epi == "pool":
            maps["t"] = ("conv", x)
            maps["pool"] = ("sums", maps["t"])
        elif epi == "skip":
            maps[writes[0]] = ("add", ("conv", x), got[-1])
        else:
            maps["hr"] = ("shuffle", x)


@pytest.mark.parametrize("blocks", [1, 2, 3, 4, 5])
def test_the_launch_schedule_computes_rcan(blocks):
    """No launch writes a map it reads, and the maps carry RCAN's data
    flow (``ops.rcan``) at odd and even depths."""
    def want(groups):
        h = ("head", "frame")
        res = h
        for _ in range(groups):
            x = res
            for _ in range(blocks):
                t = ("conv", ("relu", x))
                x = ("apply", x, t, ("sums", t))
            res = ("add", ("conv", x), res)
        return ("shuffle", ("add", ("conv", res), h))

    assert _run_schedule(3, blocks) == want(3)


def test_a_frame_is_417_kernels_at_the_published_depth():
    from srcnn_cpp_tpu_torch.ops.cuda_rcan import launch_schedule

    plan = launch_schedule(10, 20)
    # head, 200 RCABs of 2 convs, 10 group convs, body, 4 upsampler, tail
    assert len(plan) == 1 + 400 + 10 + 1 + 4 + 1 == 417
    loads = [load for _, _, load, _, _ in plan]
    assert loads.count("apply") == 10 * 19
    assert loads.count("apply_last") == 10


@pytest.mark.parametrize("shape", [(10, 20, 1080, 1920), (2, 3, 37, 300)])
def test_every_conv_of_a_frame_is_counted_by_its_kind(shape):
    # each 64->64 conv of the schedule adds to its instance's counters: a
    # unit of 2 rows by 128 columns, 8 stages of 8 channels
    from srcnn_cpp_tpu_torch.ops.cuda_rcan import (launch_schedule,
                                                   probed_kinds)
    from srcnn_cpp_tpu_torch.ops.cuda_swinir import PROBE_KINDS, probe_counts

    groups, blocks, h, w = shape
    kinds = probed_kinds(groups, blocks)
    assert set(kinds) <= set(PROBE_KINDS)
    assert sum(kinds.values()) == sum(
        k == "conv" for k, *_ in launch_schedule(groups, blocks))
    assert kinds["conv3x3", "relu_apply"] == groups * (blocks - 1)
    assert kinds["conv3x3", "shuffle"] == 4
    units = -(-h // 2) * -(-w // 128)
    got = probe_counts(kinds, 4, h, w)
    assert got["conv3x3", "pool"] == (4 * groups * blocks,
                                      4 * groups * blocks * units,
                                      4 * groups * blocks * units * 8)


def test_the_cpu_path_folds_no_attention(small):
    from srcnn_cpp_tpu_torch.ops.cuda_rcan import rcan_fused, rcan_plain

    x = torch.from_numpy(_frames(1, 6, 8, 7)).permute(0, 3, 1, 2) \
        .contiguous()
    folded, launches = rcan_fused.ca_folded, rcan_fused.launches
    calls = rcan_plain.calls
    rcan_fused(x, small, (12, 16))
    assert rcan_plain.calls == calls + 1
    assert rcan_fused.ca_folded == folded
    assert rcan_fused.launches == launches


def test_one_cache_rule_for_the_packed_weights(small):
    from srcnn_cpp_tpu_torch.ops import cuda_rcan as cr

    w = small.to("cpu")
    packed = cr.pack_rcan(w)
    calls = cr._pack.calls
    assert cr.pack_rcan(w) is packed and cr._pack.calls == calls
    w.params["body.1.body.1.body.2.weight"].add_(0)
    again = cr.pack_rcan(w)
    assert again is not packed and cr._pack.calls == calls + 1


# --- on the card -----------------------------------------------------------------

def _card(weights):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return weights.to("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,seed", [((2, 37, 300), 0),
                                        ((1, 1080, 1920), 1)])
def test_cuda_rcan_fused_matches_its_plain_version(rcan, shape, seed):
    # 3xTF32 on tensor cores, whose fp32 accumulation truncates, through
    # 415 layers, against cuDNN's rounded fp32 sums: each byte within 1 LSB
    from srcnn_cpp_tpu_torch.ops.cuda_rcan import rcan_fused, rcan_plain

    w = _card(rcan)
    b, h, wd = shape
    x = torch.from_numpy(_frames(b, h, wd, seed)).cuda() \
        .permute(0, 3, 1, 2).contiguous()
    launches, folded = rcan_fused.launches, rcan_fused.ca_folded
    got = rcan_fused(x, w, (2 * h, 2 * wd))
    torch.cuda.synchronize()
    assert rcan_fused.launches == launches + 1
    assert rcan_fused.ca_folded == folded + b * 10 * 20
    want = rcan_plain(x, w)
    mx, frac = _lsb(got.cpu(), want.cpu())
    print(f"{shape}: max {mx} LSB on {frac:.3e} of bytes")
    assert mx <= 1 and frac < 1e-2, (mx, frac)


@pytest.mark.cuda
def test_cuda_a_frame_in_a_batch_is_the_frame_alone(rcan):
    from srcnn_cpp_tpu_torch.ops.cuda_rcan import rcan_fused

    w = _card(rcan)
    x = torch.from_numpy(_frames(4, 45, 140, 2)).cuda() \
        .permute(0, 3, 1, 2).contiguous()
    batch = rcan_fused(x, w, (90, 280))
    for i in (0, 3):
        assert torch.equal(batch[i], rcan_fused(x[i:i + 1], w, (90, 280))[0])


@pytest.mark.cuda
def test_cuda_upscale_bgr_batch_runs_rcan(rcan):
    from srcnn_cpp_tpu_torch import upscale_bgr_batch
    from srcnn_cpp_tpu_torch.ops.cuda_rcan import rcan_fused
    from srcnn_cpp_tpu_torch.ops.cuda_resize import pre_upscale_fused

    w = _card(rcan)
    frames = torch.from_numpy(_frames(2, 30, 50, 3)).cuda()
    launches, k2 = rcan_fused.launches, pre_upscale_fused.launches
    got = upscale_bgr_batch(frames, 2.0, w, "cuda")
    assert got.is_cuda and tuple(got.shape) == (2, 60, 100, 3)
    assert rcan_fused.launches == launches + 1
    assert pre_upscale_fused.launches == k2
    host = upscale_bgr_batch(frames.cpu().numpy(), 2.0, w, "cuda")
    assert np.array_equal(host, got.cpu().numpy())


def _map(h, w, seed, relu=True):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((h, w, 64), generator=g)
    return (torch.relu(x) if relu else x).cuda()


def _layer(seed, c_out=64):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((c_out, 64, 3, 3), generator=g) * (2 / 576) ** 0.5,
            torch.randn(c_out, generator=g) * 0.1)


def _conv_f64(x, w, b):
    """NHWC ``x`` through the conv in float64: ``[H, W, C_out]``."""
    y = F.conv2d(x.permute(2, 0, 1)[None].double().cpu(), w.double(),
                 b.double(), padding=1)
    return y[0].permute(1, 2, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue", ["relu", "pool", "skip"])
@pytest.mark.parametrize("hw", [(37, 300), (540, 960)])
def test_cuda_each_epilogue_against_f_conv2d(epilogue, hw):
    from srcnn_cpp_tpu_torch.ops.cuda_rcan import conv3x3_variant

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, skip = _map(*hw, 10), _map(*hw, 11, relu=False)
    w, b = _layer(12)
    got = conv3x3_variant(x, w, b, epilogue,
                          skip if epilogue == "skip" else None)
    out, pool = got["out"], got["pool"]
    want = _conv_f64(x, w, b)
    if epilogue == "relu":
        want = want.clamp(min=0)
    if epilogue == "skip":
        want = want + skip.double().cpu()
    # 3xTF32 products summed in fp32 by tensor cores that truncate: a few
    # ulp of the terms' scale (576 terms of ~0.05, sums of ~1 to ~5; an
    # H100 80GB HBM3 gave at most 2.08e-5 over these shapes)
    torch.testing.assert_close(out.double().cpu(), want, rtol=0, atol=4e-5)
    if epilogue == "pool":
        # fp32 sums of ~32 terms a thread, 4 lanes, the units of a block in
        # turn and 2 x grid partials: at most ~400 roundings of the
        # magnitudes summed
        sums = pool.double().sum((0, 1)).cpu()
        bound = 400 * 2.0 ** -24 * want.abs().sum((0, 1))
        assert ((sums - want.sum((0, 1))).abs() <= bound).all()
        again = conv3x3_variant(x, w, b, "pool")["pool"]
        assert torch.equal(pool, again)    # a fixed order: bit-equal


@pytest.mark.cuda
def test_cuda_the_shuffle_epilogue_against_pixel_shuffle():
    from srcnn_cpp_tpu_torch.ops.cuda_rcan import conv3x3_variant

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    h, wd = 45, 140
    x = _map(h, wd, 13)
    w, b = _layer(14, c_out=256)
    got = torch.zeros((2 * h, 2 * wd, 64), dtype=torch.float64)
    for q in range(4):
        out = conv3x3_variant(x, w[q::4], b[q::4], "shuffle", q=q)["out"]
        mask = torch.zeros((2 * h, 2 * wd), dtype=torch.bool)
        mask[q // 2::2, q % 2::2] = True
        assert not out.cpu()[~mask].any()      # only its (dy, dx) written
        got += out.double().cpu()
    y = F.conv2d(x.permute(2, 0, 1)[None].double().cpu(), w.double(),
                 b.double(), padding=1)
    want = F.pixel_shuffle(y, 2)[0].permute(1, 2, 0)
    torch.testing.assert_close(got, want, rtol=0, atol=4e-5)


def _fma(a, b, c):
    """fmaf on float32 tensors: the exact product, one rounding (float64
    holds the product exactly)."""
    return (a.double() * b.double() + c.double()).float()


def _ca_scale(pool, ca, npx):
    """CA's finish as the loader computes it: the pool slots summed in
    order in float32, divided by the pixels, the 64->4->64 MLP by fmaf in
    the kernel's order, exp on the card, sigmoid as 1 / (1 + e)."""
    z = torch.zeros(64)
    for p in pool.cpu():
        z = z + p
    z = z / torch.tensor(float(npx), dtype=torch.float32)
    ca = ca.cpu()
    w1, b1 = ca[:256].reshape(4, 64), ca[256:260]
    w2, b2 = ca[260:516].reshape(64, 4), ca[516:580]
    h = b1.clone()
    for k in range(64):
        h = _fma(w1[:, k], z[k].expand(4), h)
    hid = h.clamp(min=0)
    v = b2.clone()
    for j in range(4):
        v = _fma(w2[:, j], hid[j].expand(64), v)
    e = torch.exp(-v.cuda()).cpu()
    return torch.tensor(1.0) / (torch.tensor(1.0) + e)


@pytest.mark.cuda
@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("epilogue", ["relu", "skip"])
@pytest.mark.parametrize("hw", [(37, 300), (540, 960)])
def test_cuda_the_apply_loader_against_f_conv2d(epilogue, hw, grouped):
    """The loader's x = x_prev + s t: ``s`` bit-equal to CA's finish in
    torch, the stored x bit-equal to torch's x_prev + t * s (``"apply"``
    under the ReLU epilogue; ``"apply_last"`` under the skip add stores
    none), the conv of it within the epilogue tests' bar, on frames whose
    width is no multiple of 128 (and an odd height), x_prev NHWC (a
    group's input) or grouped (an RCAB's result)."""
    from srcnn_cpp_tpu_torch import runtime
    from srcnn_cpp_tpu_torch.ops.cuda_rcan import (CA_FLOATS, POOL_PARTS,
                                                   conv3x3_variant,
                                                   rcan_plan)

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    h, wd = hw
    x, t = _map(h, wd, 20), _map(h, wd, 21, relu=False) * 0.5
    skip = _map(h, wd, 22, relu=False)
    g = torch.Generator().manual_seed(23)
    parts = rcan_plan(h, wd, runtime.num_sms())["grid"] * POOL_PARTS
    pool = (torch.randn((parts, 64), generator=g) * 50).cuda()
    ca = (torch.randn(CA_FLOATS, generator=g) * 0.3).cuda()
    w, b = _layer(24)
    got = conv3x3_variant(x, w, b, epilogue,
                          skip if epilogue == "skip" else None, t=t,
                          ca_pool=pool, ca=ca, grouped=grouped)
    s = _ca_scale(pool, ca, h * wd)
    assert torch.equal(got["s"].cpu(), s), (got["s"].cpu() - s).abs().max()
    applied = x.cpu() + t.cpu() * s
    if epilogue == "relu":
        assert torch.equal(got["x"].cpu(), applied)
    else:
        assert got["x"] is None
    want = _conv_f64(applied, w, b)
    want = want.clamp(min=0) if epilogue == "relu" \
        else want + skip.double().cpu()
    torch.testing.assert_close(got["out"].double().cpu(), want, rtol=0,
                               atol=4e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [1, 2, 3])
def test_cuda_rcan_fused_at_each_buffer_turn(tmp_path, blocks):
    """2 groups of 1, 2 or 3 RCABs: an RCAB's x goes to either map, the
    last conv reads the group's input (1) or either map."""
    from srcnn_cpp_tpu_torch.ops.cuda_rcan import rcan_fused, rcan_plain
    from srcnn_cpp_tpu_torch.weights import load_rcan_weights

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mk = _make()
    path = tmp_path / f"rcan_2x{blocks}.jsonl"
    mk.write(path, mk.recipe(groups=2, blocks=blocks))
    w = load_rcan_weights(path, device="cuda")
    x = torch.from_numpy(_frames(2, 37, 300, blocks)).cuda() \
        .permute(0, 3, 1, 2).contiguous()
    folded = rcan_fused.ca_folded
    got = rcan_fused(x, w, (74, 600))
    torch.cuda.synchronize()
    assert rcan_fused.ca_folded == folded + 2 * 2 * blocks
    mx, frac = _lsb(got.cpu(), rcan_plain(x, w).cpu())
    print(f"blocks {blocks}: max {mx} LSB on {frac:.3e} of bytes")
    assert mx <= 1 and frac < 1e-2, (mx, frac)


#: each instance of the 64->64 body that RCAN launches: its epilogue, and
#: whether it takes a skip and forms CA's x + s t in its loader
PROBED_CONVS = {"relu": ("relu", False, False), "pool": ("pool", False, False),
                "skip": ("skip", True, False),
                "shuffle": ("shuffle", False, False),
                "relu_apply": ("relu", False, True),
                "skip_apply_last": ("skip", True, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(37, 300), (1080, 1920)])
@pytest.mark.parametrize("kind", sorted(PROBED_CONVS))
def test_cuda_a_probed_conv3x3_is_bit_equal_and_counted(kind, hw):
    # traced, the launcher runs the probed instance: the untraced outputs
    # (the map, the pool sums, CA's s and the stored x), and the units and
    # stages of the schedule's arithmetic, the same again on a second launch
    from srcnn_cpp_tpu_torch import runtime
    from srcnn_cpp_tpu_torch.ops.cuda_rcan import (CA_FLOATS, POOL_PARTS,
                                                   conv3x3_call,
                                                   conv3x3_variant,
                                                   rcan_plan)
    from srcnn_cpp_tpu_torch.ops.cuda_swinir import probe_tally, probe_units
    from srcnn_cpp_tpu_torch.utils.profiling import counted

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    h, wd = hw
    epilogue, skip, apply = PROBED_CONVS[kind]
    kw = {"skip": _map(h, wd, 31, relu=False) if skip else None}
    if apply:
        g = torch.Generator().manual_seed(32)
        parts = rcan_plan(h, wd, runtime.num_sms())["grid"] * POOL_PARTS
        kw.update(t=_map(h, wd, 33, relu=False) * 0.5,
                  ca_pool=(torch.randn((parts, 64), generator=g) * 50).cuda(),
                  ca=(torch.randn(CA_FLOATS, generator=g) * 0.3).cuda())
    args = (_map(h, wd, 30), *_layer(34), epilogue)
    off = conv3x3_variant(*args, **kw)
    launch, result = conv3x3_call(*args, **kw)
    found = [probe_tally(counted(launch)[1])]
    on = result()
    for k, v in off.items():
        assert v is None and on[k] is None or torch.equal(on[k], v), k
    found.append(probe_tally(counted(launch)[1]))
    want = {("conv3x3", kind): (1, *probe_units("conv3x3", kind, h, wd))}
    assert found == [want, want]


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(37, 300), (1080, 1920)])
def test_cuda_rcan_fused_probed_is_bit_equal_and_counted(rcan, hw,
                                                         tmp_path):
    # under a trace the 64->64 convs run probed: the untraced frame,
    # counted as the launch schedule says, the same on a second call
    from srcnn_cpp_tpu_torch.ops.cuda_rcan import probed_kinds, rcan_fused
    from srcnn_cpp_tpu_torch.ops.cuda_swinir import probe_counts, probe_tally
    from srcnn_cpp_tpu_torch.utils.profiling import (counted,
                                                     kernel_counters, trace)

    w = _card(rcan)
    h, wd = hw
    x = torch.from_numpy(_frames(1, h, wd, 40)).cuda() \
        .permute(0, 3, 1, 2).contiguous()
    off = rcan_fused(x, w, (2 * h, 2 * wd))
    kernel_counters(reset=True)
    with trace(str(tmp_path)):
        traced = rcan_fused(x, w, (2 * h, 2 * wd))
    found = [probe_tally(kernel_counters(reset=True))]
    again, more = counted(lambda: rcan_fused(x, w, (2 * h, 2 * wd)))
    found.append(probe_tally(more))
    assert torch.equal(traced, off) and torch.equal(again, off)
    want = probe_counts(probed_kinds(w.groups, w.blocks), 1, h, wd)
    assert found == [want, want]
