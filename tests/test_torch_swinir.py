"""PyTorch port, SwinIR x2 on the normal path (``weights.swinir``,
``ops.swinir``, ``ops.cuda_swinir``, ``pipeline.upscale_planar``).

On the CPU the network runs its plain fp32 path; these tests hold the
port's entry points against the benchmark's plain reference
(``portbench/reference/swinir_bgr.py``) on seeded weights at a reduced
size (2 RSTBs of 2 STLs at width 24, 2 heads of 12, window 8) on frames
that need no padding and frames that do, and at the published widths on a
small frame; check the published container, its recipe and its MACs,
drive the benchmark's cell through ``run.run_cell`` at the published depth
and a small size, plant faults that the comparison must catch, check that
the paths which cannot take SwinIR refuse it, and check the packed layers,
the launch order and the plan that the CUDA launcher reads.

Tests marked ``cuda`` compare the kernels with their plain versions on the
card; this file imports neither JAX nor the test conftest, so they run
with ``python -m pytest tests/test_torch_swinir.py -m cuda --noconftest -o
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
SWINIR_CU = REPO / "srcnn_cpp_tpu_torch/csrc/swinir.cu"
CONFIGS = REPO / "portbench/configs"
RECIPE = CONFIGS / "swinir_x2_seeded.jsonl"


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _make():
    return _load("make_swinir_x2", CONFIGS / "make_swinir_x2.py")


def _frames(b, h, w, seed):
    """Frames with the gradients of images: a bilinear field plus noise."""
    g = torch.Generator().manual_seed(seed)
    coarse = torch.rand((b, 3, 3, 4), generator=g) * 200 + 28
    x = F.interpolate(coarse, size=(h, w), mode="bilinear")
    x = x + 24 * (torch.rand((b, 3, h, w), generator=g) - 0.5)
    return x.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1) \
        .contiguous().numpy()


def _lsb(a, b):
    d = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
    return d.max(), (d > 0).mean()


def _recipe(tmp_path_factory, name, **kw):
    path = tmp_path_factory.mktemp("swinir") / f"{name}.jsonl"
    mk = _make()
    mk.write(path, mk.recipe(**kw))
    return path


@pytest.fixture(scope="module")
def small_recipe(tmp_path_factory):
    """2 RSTBs of 2 STLs at width 24, 2 heads of 12."""
    return _recipe(tmp_path_factory, "small", groups=2, depth=2, dim=24,
                   heads=2)


@pytest.fixture(scope="module")
def small(small_recipe):
    from srcnn_cpp_tpu_torch.weights import load_swinir_weights

    return load_swinir_weights(small_recipe)


@pytest.fixture(scope="module")
def small_ref(small_recipe):
    from portbench.reference import swinir_bgr

    return swinir_bgr.load(small_recipe, "cpu")


@pytest.fixture(scope="module")
def wide_recipe(tmp_path_factory):
    """1 RSTB of 2 STLs (one unshifted, one shifted) at the published
    widths."""
    return _recipe(tmp_path_factory, "wide", groups=1, depth=2)


@pytest.fixture(scope="module")
def wide(wide_recipe):
    from srcnn_cpp_tpu_torch.weights import load_swinir_weights

    return load_swinir_weights(wide_recipe)


@pytest.fixture(scope="module")
def wide_ref(wide_recipe):
    from portbench.reference import swinir_bgr

    return swinir_bgr.load(wide_recipe, "cpu")


@pytest.fixture(scope="module")
def swinir():
    from srcnn_cpp_tpu_torch.weights import load_swinir_weights

    return load_swinir_weights(RECIPE)


def _reference(frames, ref_weights, scale=2.0):
    from portbench.reference import swinir_bgr

    return np.stack([swinir_bgr.upscale_frame(torch.from_numpy(f),
                                              ref_weights, scale).numpy()
                     for f in frames])


# --- the published network, its recipe and its work --------------------------

def test_the_container_holds_the_published_network(swinir):
    from srcnn_cpp_tpu_torch.weights import SwinIRWeights, weights_on
    from srcnn_cpp_tpu_torch.weights.swinir import swinir_shapes

    assert (swinir.groups, swinir.depth, swinir.dim, swinir.heads,
            swinir.hidden) == (6, 6, 180, 6, 360)
    assert sum(t.numel() for t in swinir.as_dict().values()) == 11_752_487
    keys = list(swinir.as_dict())
    assert keys == list(swinir_shapes())
    assert keys[:4] == ["conv_first.weight", "conv_first.bias",
                        "patch_embed.norm.weight", "patch_embed.norm.bias"]
    assert keys[4:9] == [
        "layers.0.residual_group.blocks.0.norm1.weight",
        "layers.0.residual_group.blocks.0.norm1.bias",
        "layers.0.residual_group.blocks.0.attn.relative_position_bias_table",
        "layers.0.residual_group.blocks.0.attn.qkv.weight",
        "layers.0.residual_group.blocks.0.attn.qkv.bias"]
    assert keys[-10:] == ["norm.weight", "norm.bias",
                          "conv_after_body.weight", "conv_after_body.bias",
                          "conv_before_upsample.0.weight",
                          "conv_before_upsample.0.bias", "upsample.0.weight",
                          "upsample.0.bias", "conv_last.weight",
                          "conv_last.bias"]
    p = "layers.5.residual_group.blocks.5"
    assert tuple(swinir.params[f"{p}.attn.relative_position_bias_table"]
                 .shape) == (225, 6)
    assert tuple(swinir.params[f"{p}.attn.qkv.weight"].shape) == (540, 180)
    assert tuple(swinir.params[f"{p}.mlp.fc2.weight"].shape) == (180, 360)
    assert tuple(swinir.params["upsample.0.weight"].shape) == (256, 64, 3, 3)
    assert swinir.halo == float("inf") and weights_on(swinir, "cpu") is swinir
    moved = swinir.to("cpu")
    assert isinstance(moved, SwinIRWeights) and moved.groups == 6
    dropped = dict(swinir.params)
    del dropped["norm.bias"]
    with pytest.raises(ValueError):
        SwinIRWeights(dropped)


def test_macs_per_pixel_at_the_published_shapes(swinir):
    from portbench.reference import swinir_bgr

    shapes = {k: tuple(v.shape) for k, v in swinir.as_dict().items()}
    # a low-resolution pixel: 36 STLs of linears 259,200 and attention
    # 23,040; 7 convs 180->180 of 291,600; the head 4,860, the conv before
    # the upsampler 103,680, the upsampler 147,456, the tail 6,912 at 4
    # output pixels
    stls = 36 * (259_200 + 23_040)
    assert stls == 10_160_640 and 36 * 259_200 == 9_331_200
    low = stls + 7 * 291_600 + 4_860 + 103_680 + 147_456 + 6_912
    assert low == 12_464_748
    assert swinir_bgr.macs_per_pixel(shapes) == 3_116_187 == low // 4


def test_the_conv_roofline_split_matches_the_macs(swinir):
    from portbench import spec
    from portbench.reference import swinir_bgr

    shapes = {k: tuple(v.shape) for k, v in swinir.as_dict().items()}
    macs = swinir_bgr.macs_per_pixel(shapes)
    conv = _load("swinir_conv_roofline",
                 REPO / "portbench/metrics/swinir_conv_roofline.py")
    stl = _load("swinir_stl_roofline",
                REPO / "portbench/metrics/swinir_stl_roofline.py")
    # the kernels outside the STLs and the STLs' least work: the network's
    assert conv.low_macs(macs) == 2_304_108
    assert conv.low_macs(macs) + stl.STLS * stl.STL_MACS == 4 * macs
    assert stl.STL_MACS == 282_240 and stl.STLS == 36
    for name in ("swinir_stl_roofline", "swinir_attention_roofline",
                 "swinir_conv_roofline", "rebuilds.swinir"):
        assert callable(spec.metric_reader(name))


def test_the_recipe_expands_alike_in_the_loader_and_the_reference(swinir):
    from portbench.reference import swinir_bgr

    ref = swinir_bgr.load(RECIPE, "cpu")
    assert list(ref) == list(swinir.as_dict())
    for k, v in ref.items():
        assert v.dtype == torch.float32 and torch.equal(v, swinir.params[k]), k
    head, *rows = RECIPE.read_text().splitlines()
    assert json.loads(head)["seed"] == _make().SEED
    assert [json.loads(r)[0] for r in rows] == list(ref)
    p = "layers.2.residual_group.blocks.3"
    w = swinir.params[f"{p}.mlp.fc1.weight"]
    assert abs(w.std().item() - 0.02) < 0.001
    assert not swinir.params[f"{p}.mlp.fc1.bias"].any()
    gain = swinir.params[f"{p}.norm2.weight"]
    assert abs(gain.mean().item() - 1) < 0.05 and gain.std().item() > 0.1


def test_make_swinir_x2_regenerates_the_recipe_byte_for_byte(tmp_path):
    out = tmp_path / "again.jsonl"
    assert _make().main([str(out)]) == 0
    assert out.read_bytes() == RECIPE.read_bytes()


def test_an_npz_of_the_authors_keys_loads_by_name(small, tmp_path):
    from srcnn_cpp_tpu_torch.weights import load_swinir_weights, weights_npz

    arrays = {k: v.numpy() for k, v in small.as_dict().items()}
    # the authors' state dict also holds the computed buffers
    p = "layers.0.residual_group.blocks.1"
    arrays[f"{p}.attn.relative_position_index"] = np.zeros((64, 64))
    arrays[f"{p}.attn_mask"] = np.zeros((64, 64, 64), np.float32)
    np.savez(tmp_path / "authors.npz", **arrays)
    got = load_swinir_weights(tmp_path / "authors.npz")
    assert (got.groups, got.depth, got.dim, got.heads) == (2, 2, 24, 2)
    assert all(torch.equal(got.params[k], v) for k, v in small.params.items())
    with pytest.raises(ValueError, match="no SwinIR checkpoint"):
        load_swinir_weights(weights_npz())


# --- the normal path against the reference ------------------------------------

@pytest.mark.parametrize("hw", [(24, 40), (30, 44)])
def test_upscale_bgr_batch_runs_swinir_like_the_reference(small, small_ref,
                                                          hw):
    # 24 x 40 is 3 x 5 windows; 30 x 44 is reflect-padded to 32 x 48
    from srcnn_cpp_tpu_torch import upscale_bgr_batch
    from srcnn_cpp_tpu_torch.ops import cuda_swinir

    frames = _frames(2, *hw, 1)
    calls = cuda_swinir.swinir_plain.calls
    got = upscale_bgr_batch(frames, 2.0, small, device="cpu")
    assert cuda_swinir.swinir_plain.calls == calls + 1
    assert got.shape == (2, 2 * hw[0], 2 * hw[1], 3) and got.dtype == np.uint8
    # the same fp32 arithmetic, written twice: at most 1 LSB
    mx, frac = _lsb(got, _reference(frames, small_ref))
    assert mx <= 1 and frac < 1e-3, (mx, frac)
    assert got.std() > 10


def test_the_published_widths_run_like_the_reference(wide, wide_ref):
    from srcnn_cpp_tpu_torch import upscale_bgr_batch

    frames = _frames(1, 16, 16, 7)
    got = upscale_bgr_batch(frames, 2.0, wide, device="cpu")
    mx, frac = _lsb(got, _reference(frames, wide_ref))
    assert mx <= 1 and frac < 1e-3, (mx, frac)


def test_the_configs_runner_and_the_stream_run_swinir(small, small_ref):
    from srcnn_cpp_tpu_torch.configs import batch_1080p_to_4k
    from srcnn_cpp_tpu_torch.stream import StreamUpscaler

    frames = _frames(3, 16, 24, 2)
    want = _reference(frames, small_ref)
    run = batch_1080p_to_4k(small, batch=2, device="cpu")
    got = run(frames)
    assert got.shape == (3, 32, 48, 3)
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

    frames = _frames(3, 18, 20, 3)
    batch = upscale_bgr_batch(frames, 2.0, small, device="cpu")
    for i in (0, 2):
        alone = upscale_bgr_batch(frames[i:i + 1], 2.0, small, device="cpu")
        assert np.array_equal(batch[i], alone[0])


def test_the_window_helpers():
    from srcnn_cpp_tpu_torch.ops import swinir as ops

    idx = ops.relative_position_index()
    # query (iy, ix), key (jy, jx): (iy - jy + 7) 15 + ix - jx + 7
    assert idx[0, 0] == 7 * 15 + 7 and idx[63, 0] == 14 * 15 + 14
    assert idx[0, 63] == 0 and idx[9, 1] == (1 + 7) * 15 + 7
    mask = ops.attention_mask(16, 24)
    assert tuple(mask.shape) == (6, 64, 64)
    # only the last row and column of windows mix regions
    assert not mask[0].any() and not mask[1].any()
    assert mask[2].min() == -100 and mask[5].min() == -100
    # the last column's window: columns 4-7 of the rolled frame are
    # another region than columns 0-3
    assert mask[2][0, 4] == -100 and mask[2][0, 1] == 0
    x = torch.arange(2 * 16 * 24, dtype=torch.float32).reshape(1, 16, 24, 2)
    assert torch.equal(ops.unwindows(ops.windows(x), 16, 24), x)
    assert torch.equal(ops.shift_tokens(ops.shift_tokens(x, 4), -4), x)
    assert ops.shift_tokens(x, 4)[0, 0, 0, 0] == x[0, 4, 4, 0]


def test_the_pad_index_is_reflect_padding():
    from srcnn_cpp_tpu_torch.ops.cuda_swinir import pad_index

    for n in (8, 13, 30, 1081):
        x = torch.arange(n, dtype=torch.float32)[None, None]
        want = F.pad(x, (0, -n % 8), mode="reflect")[0, 0]
        assert torch.equal(pad_index(n).float(), want)


def test_process_srcnn_runs_swinir_on_rgb_and_refuses_one_plane(small):
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


@pytest.mark.parametrize("scale", [3.0, 1.5])
def test_a_scale_other_than_2_raises(small, scale):
    from portbench.reference import swinir_bgr
    from srcnn_cpp_tpu_torch import upscale_bgr_batch
    from srcnn_cpp_tpu_torch.configs import single_8k

    frames = _frames(1, 10, 12, 6)
    with pytest.raises(ValueError, match="upscales by 2 only"):
        upscale_bgr_batch(frames, scale, small, device="cpu")
    with pytest.raises(ValueError, match="upscales by 2 only"):
        single_8k(small, scale=scale, device="cpu")(frames[0])
    with pytest.raises(ValueError):
        swinir_bgr.upscale_frame(torch.from_numpy(frames[0]), {}, scale)


# --- the benchmark's cell ---------------------------------------------------------

def _cell(hw=(8, 16)):
    """``swinir1080p.tensor`` at ``hw`` input frames, 4 distinct, 2 a call,
    at the published depth and widths."""
    from portbench import spec

    cell = spec.cell("swinir1080p.tensor")
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


def _no_shift(real):
    return lambda x, shift: x


def _shift_reversed(real):
    return lambda x, shift: real(x, -shift)


def _no_mask(real):
    return lambda hp, wp, *a: torch.zeros_like(real(hp, wp, *a))


def _key_minus_query(real):
    return lambda *a: real(*a).t()


def _no_affine(real):
    def norm(x, weights, name):
        return F.layer_norm(x, (x.shape[-1],), eps=1e-5)
    return norm


def _tanh_gelu(real):
    return lambda x: F.gelu(x, approximate="tanh")


def _padded_scale(real):
    return lambda hd: 32 ** -0.5


def _skip_norm(names):
    def fault(real):
        def norm(x, weights, name):
            return x if name in names else real(x, weights, name)
        return norm
    return fault


def _shuffle_swapped(real):
    def shuffle(x):
        n, c4, h, w = x.shape
        x = x.reshape(n, c4 // 4, 2, 2, h, w).transpose(2, 3)
        return real(x.reshape(n, c4, h, w))
    return shuffle


def _zero_padding(real):
    def pad(x):
        h, w = x.shape[-2:]
        return F.pad(x, (0, -w % 8, 0, -h % 8))
    return pad


FAULTS = {"shift_left_out": ("shift_tokens", _no_shift),
          "shift_reversed": ("shift_tokens", _shift_reversed),
          "mask_left_out": ("attention_mask", _no_mask),
          "bias_key_minus_query": ("relative_position_index",
                                   _key_minus_query),
          "layernorm_affine_dropped": ("norm", _no_affine),
          "scale_of_padded_head_dim": ("head_scale", _padded_scale),
          "patch_norm_left_out": ("norm", _skip_norm({"patch_embed.norm"})),
          "final_norm_left_out": ("norm", _skip_norm({"norm"})),
          "pixel_shuffle_order": ("pixel_shuffle", _shuffle_swapped),
          "zero_padding": ("pad_to_window", _zero_padding)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(monkeypatch, wide, wide_ref, fault):
    """Each fault in the port's CPU path, at the published widths (an
    unshifted and a shifted STL) on frames that need padding: the cell's
    limits refuse it."""
    from srcnn_cpp_tpu_torch import upscale_bgr_batch
    from srcnn_cpp_tpu_torch.ops import swinir as ops

    limits = json.loads((CONFIGS / "swinir_x2_1080p_to_4k.json")
                        .read_text())["limits"]
    frames = _frames(1, 20, 22, 11)
    want = _reference(frames, wide_ref)
    name, plant = FAULTS[fault]
    monkeypatch.setattr(ops, name, plant(getattr(ops, name)))
    mx, frac = _lsb(upscale_bgr_batch(frames, 2.0, wide, device="cpu"), want)
    assert mx > limits["max_lsb"] or frac > limits["share_off"], (mx, frac)


def _mlp_error(wide):
    """The largest error of the port's LN2 + fc1 + GELU of the first STL
    on random tokens, against float64 with the exact GELU."""
    from srcnn_cpp_tpu_torch.ops import swinir as ops

    p = "layers.0.residual_group.blocks.0"
    x = torch.randn((1, 8, 8, 180), generator=torch.Generator()
                    .manual_seed(9)) * 3
    got = ops.gelu(F.linear(ops.norm(x, wide, f"{p}.norm2"),
                            *wide.pair(f"{p}.mlp.fc1")))
    g, b = (t.double() for t in wide.pair(f"{p}.norm2"))
    w1, b1 = (t.double() for t in wide.pair(f"{p}.mlp.fc1"))
    want = F.gelu(F.linear(F.layer_norm(x.double(), (180,), g, b, 1e-5), w1,
                           b1))
    return (got.double() - want).abs().max().item()


def test_tanh_gelu_is_caught_at_the_op_level(monkeypatch, wide):
    """tanh-GELU moves the output by less than the cell's limits see; the
    op-level comparison of the MLP's hidden map does."""
    from srcnn_cpp_tpu_torch.ops import swinir as ops

    assert _mlp_error(wide) < 1e-5
    monkeypatch.setattr(ops, "gelu", _tanh_gelu(ops.gelu))
    assert _mlp_error(wide) > 1e-4


# --- what refuses SwinIR weights ---------------------------------------------------

WHOLE_FRAME = ("SwinIRWeights needs the whole frame as its halo (its "
               "receptive field), which it lacks")


def test_the_mesh_runner_refuses_swinir(small):
    from srcnn_cpp_tpu_torch.configs import single_8k
    from srcnn_cpp_tpu_torch.parallel import make_mesh

    mesh = make_mesh(2, 1, devices=["cpu"] * 2)
    with pytest.raises(TypeError) as e:
        single_8k(small, mesh=mesh)
    assert str(e.value) == ("single_8k(mesh=...) takes SRCNN weights only: "
                            f"its halo is SRCNN's 6 pixels; {WHOLE_FRAME}")


def test_tiling_refuses_swinir(small):
    from srcnn_cpp_tpu_torch.parallel import make_mesh
    from srcnn_cpp_tpu_torch.parallel.tiling import (split_blocks,
                                                     srcnn_blocks)

    mesh = make_mesh(1, 2, devices=["cpu"] * 2)
    y = torch.zeros((1, 16, 16), dtype=torch.uint8)
    with pytest.raises(TypeError, match="whole frame as its halo"):
        srcnn_blocks(split_blocks(y, mesh), small, mesh)


def test_distributed_refuses_swinir(small):
    from srcnn_cpp_tpu_torch.parallel.distributed import (DistributedStream,
                                                          frame_mesh)

    with pytest.raises(TypeError, match="whole frame as its halo"):
        DistributedStream(2.0, frame_mesh(1, devices=["cpu"]), weights=small)


def test_swinir_refuses_other_weights():
    from srcnn_cpp_tpu_torch.ops.cuda_swinir import swinir_fused
    from srcnn_cpp_tpu_torch.weights import load_weights

    with pytest.raises(TypeError, match="SwinIRWeights"):
        swinir_fused(torch.zeros((1, 3, 8, 8), dtype=torch.uint8),
                     load_weights(), (16, 16))


# --- the launch: packed layers, their order, the plan ---------------------------

def _unpack(packed, n, cin, taps, nt):
    """:func:`pack_gemm`'s inverse: ``(w [n][cin][taps], bias [n])``, each
    stage's hi + lo read back from wgmma's K-major core matrices, a stage
    16 channels (two k8 steps)."""
    tiles = -(-n // nt)
    stage = 2 * nt * 16
    w = torch.zeros((tiles * nt, cin, taps))
    for t in range(tiles):
        for tap in range(taps):
            for q in range(cin // 16):
                s = ((t * taps + tap) * (cin // 16) + q) * stage
                for plane in range(2):
                    m = packed[s + plane * nt * 16:s + (plane + 1) * nt * 16]
                    # element (k, j) of k8 step kk at (kk nt / 8 + j // 8)
                    # 64 + (k // 4) 32 + j % 8 4 + k % 4
                    cm = m.reshape(2, nt // 8, 2, 8, 4)
                    w[t * nt:(t + 1) * nt, 16 * q:16 * q + 16, tap] += \
                        cm.permute(1, 3, 0, 2, 4).reshape(nt, 16)
    return w[:n], packed[tiles * taps * (cin // 16) * stage:][:n]


@pytest.mark.parametrize("shape,nt,cin", [((540, 180), 184, 192),
                                          ((180, 360), 184, 368),
                                          ((64, 180, 3, 3), 64, 192)])
def test_pack_gemm_holds_the_layer(shape, nt, cin):
    from srcnn_cpp_tpu_torch.ops.cuda_swinir import pack_gemm

    g = torch.Generator().manual_seed(5)
    w = torch.randn(shape, generator=g)
    b = torch.randn(shape[0], generator=g)
    packed = pack_gemm(w, b, nt, cin)
    taps = 9 if len(shape) == 4 else 1
    tiles = -(-shape[0] // nt)
    assert packed.numel() == tiles * taps * cin // 16 * 2 * nt * 16 \
        + tiles * nt
    got, bias = _unpack(packed, shape[0], cin, taps, nt)
    want = w.reshape(shape[0], shape[1], taps)
    assert torch.equal(got[:, :shape[1]], want)
    assert not got[:, shape[1]:].any()
    assert torch.equal(bias, b)


def _constant(src, name):
    return int(re.search(rf"\b{name} = (\d+)", src).group(1))


def test_the_plan_mirrors_the_cuda_source():
    from srcnn_cpp_tpu_torch.ops import cuda_swinir as cs
    from srcnn_cpp_tpu_torch.ops import cuda_vdsr as cv

    src = SWINIR_CU.read_text()
    lay = cs.stl_layout()
    assert f"STL_FLOATS == {lay['floats']} && TAB_OFF == {lay['table']}" \
        in src
    assert cs.gemm_stage_floats(184) == 10048 \
        and cs.gemm_stage_floats(64) == 6208
    assert f"Geo<184>::SMEM == {cs.gemm_smem_bytes(184)}" in src
    assert f"Geo<64>::SMEM == {cs.gemm_smem_bytes(64)}" in src
    for name, value in (("TM", cs.UNIT), ("KC", cs.STAGE_CHANNELS),
                        ("STAGES", cs.STAGES), ("CP", cs.CP),
                        ("HIDP", cs.HIDP)):
        assert _constant(src, name) == value, name
    assert "constexpr int HALF = TM * 4 + 8;" in src and cs.HALF == 520
    # a token map's K, 184 channels read in stages of 16, and the MLP's
    assert "KCH = (184 + KC - 1) / KC, KCH_HID = 368 / KC;" in src
    assert cs.K_TOKENS == 12 * 16 and cs.K_HIDDEN == 23 * 16
    for kind, value in cs.KINDS.items():
        assert f"case {value}:" in src, kind
    plan = cs.swinir_plan(1080, 1920, 132)
    px = 1080 * 1920
    assert plan["units"] == px // 128 and plan["grid"] == 132
    assert plan["up_grid"] == 132 and plan["up_smem"] == cv.vdsr_smem_bytes()
    # four token maps of 184 floats and qkv's 552 (the MLP's map and the
    # upsampled map live in qkv's)
    # and LayerNorm's statistics, 2 floats a pixel
    assert plan["workspace_floats"] == px * (4 * 184 + 552 + 2)
    assert 4 * px * 64 <= px * 552 and 368 <= 552
    assert cs.swinir_plan(8, 8, 132)["grid"] == 1


def test_the_packed_buffers(small_recipe):
    from srcnn_cpp_tpu_torch.ops import cuda_swinir as cs
    from srcnn_cpp_tpu_torch.weights import load_swinir_weights
    from srcnn_cpp_tpu_torch.weights.swinir import swinir_shapes

    # the published widths at 1 RSTB of 1 STL
    from srcnn_cpp_tpu_torch.weights.swinir import SwinIRWeights
    g = torch.Generator().manual_seed(3)
    w = SwinIRWeights({k: torch.randn(s, generator=g) for k, s in
                       swinir_shapes(groups=1, depth=1).items()})
    head, stls, convs, up, tail = (t.numpy() for t in cs.pack_swinir(w))
    cw, cb = w.pair("conv_first")
    # [ci (RGB), ky, kx][184], over 255
    assert head[(1 * 9 + 2 * 3 + 0) * 184 + 5] == np.float32(
        cw[5, 1, 2, 0].item() / 255.0)
    assert not head[(2 * 9 + 1) * 184 + 180:(2 * 9 + 1) * 184 + 184].any()
    np.testing.assert_array_equal(head[27 * 184:27 * 184 + 180], cb)
    gain, bias = w.pair("patch_embed.norm")
    np.testing.assert_array_equal(head[28 * 184:28 * 184 + 180], gain)
    np.testing.assert_array_equal(head[29 * 184:29 * 184 + 180], bias)
    lay = cs.stl_layout()
    assert stls.size == lay["floats"]
    p = "layers.0.residual_group.blocks.0"
    qkv = stls[lay["qkv"]:lay["proj"]]
    got, b = _unpack(torch.from_numpy(qkv), 540, 192, 1, 184)
    assert torch.equal(got[:, :180, 0], w.params[f"{p}.attn.qkv.weight"])
    assert torch.equal(b, w.params[f"{p}.attn.qkv.bias"])
    fc2 = torch.from_numpy(stls[lay["fc2"]:lay["ln1"]])
    got, b = _unpack(fc2, 180, 368, 1, 184)
    assert torch.equal(got[:, :360, 0], w.params[f"{p}.mlp.fc2.weight"])
    np.testing.assert_array_equal(stls[lay["ln2"]:lay["ln2"] + 180],
                                  w.params[f"{p}.norm2.weight"])
    table = w.params[f"{p}.attn.relative_position_bias_table"]
    # [head][225]
    assert stls[lay["table"] + 3 * 225 + 17] == table[17, 3]
    conv = 9 * 12 * 2 * 184 * 16 + 184
    assert convs.size == 2 * conv + 2 * 184 + 9 * 12 * 2 * 64 * 16 + 64
    np.testing.assert_array_equal(convs[conv:conv + 180],
                                  w.params["norm.weight"])
    got, b = _unpack(torch.from_numpy(convs[conv + 368:2 * conv + 368]), 180,
                     192, 9, 184)
    assert torch.equal(got[:, :180],
                       w.params["conv_after_body.weight"].reshape(180, 180,
                                                                  9))
    assert up.size == 4 * 73792
    lw, lb = w.pair("conv_last")
    # [RGB][ky, kx][ci], times 255
    assert tail[(2 * 9 + 4) * 64 + 7] == np.float32(lw[2, 7, 1, 1] * 255)
    np.testing.assert_array_equal(tail[27 * 64:], [*(lb * 255).numpy(), 0])


def test_a_frame_is_194_kernels_at_the_published_depth():
    from srcnn_cpp_tpu_torch.ops.cuda_swinir import launch_schedule

    sched = launch_schedule(6, 6)
    assert len(sched) == 194
    stl = [k for k, _ in sched if k.startswith("swin_stl_")]
    assert len(stl) == 36 * 5
    # every kernel of the STLs, and no other, carries the prefix
    assert sum("attention" in k for k in stl) == 36
    assert [w for k, w in sched if "attention" in k].count("shifted") == 18
    assert sched[-8:-1] == [("swinir_conv3x3_kernel", "conv + group skip"),
                            ("swinir_conv3x3_kernel",
                             "norm + conv_after_body + f0"),
                            ("swinir_conv3x3_kernel",
                             "conv_before_upsample + leaky")] + \
        [("rcan_conv3x3_kernel", "upsample")] * 4
    src = SWINIR_CU.read_text()
    names = set(re.findall(
        r"__global__ void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\(", src))
    assert names == {"swin_stl_linear_kernel", "swin_stl_attention_kernel",
                     "swinir_conv3x3_kernel"}


def test_kernel_ab_names_every_conv_body_instance():
    from srcnn_cpp_tpu_torch.kernel_ab import conv_sass

    ns = "_ZN45_GLOBAL__N__c6fdafe9_12_vdsr_conv_cu_1ba58d60"
    sw = "_ZN41_GLOBAL__N__168fde48_9_swinir_cu_81eaa0a3"
    code = {f"{ns}19vdsr_conv3x3_kernelEPKfPfS1_ii": ["A"],
            f"{ns}19rcan_conv3x3_kernelILi0ELi1EEEvPKfPf": ["B"],
            f"{ns}19rcan_conv3x3_kernelILi3EEEvPKfPf": ["C"],
            f"{sw}22swin_stl_linear_kernelILi1ELi0EEEvNS_4GemmE": ["D"],
            f"{sw}21swinir_conv3x3_kernelILi184ELi3EEEvNS_4GemmE": ["E"],
            f"{sw}25swin_stl_attention_kernelEPKfS1_Pfiiif": ["F"],
            f"{ns}16vdsr_last_kernelEPKfPKhS1_Phii": ["G"]}
    assert conv_sass(code) == {
        "vdsr_conv3x3_kernel": ["A"], "rcan_conv3x3_kernel<0, 1>": ["B"],
        "rcan_conv3x3_kernel<3, 0>": ["C"],
        "swin_stl_linear_kernel<1, 0>": ["D"],
        "swinir_conv3x3_kernel<184, 3>": ["E"],
        "swin_stl_attention_kernel": ["F"]}


def test_one_cache_rule_for_the_packed_weights():
    from srcnn_cpp_tpu_torch.ops import cuda_swinir as cs
    from srcnn_cpp_tpu_torch.weights.swinir import (SwinIRWeights,
                                                    swinir_shapes)

    w = SwinIRWeights({k: torch.zeros(s) for k, s in
                       swinir_shapes(groups=1, depth=1).items()})
    calls = cs._pack.calls
    packed = cs.pack_swinir(w)
    assert cs.pack_swinir(w) is packed and cs._pack.calls == calls + 1
    w.params["norm.bias"].add_(0)
    again = cs.pack_swinir(w)
    assert again is not packed and cs._pack.calls == calls + 2


# --- on the card -----------------------------------------------------------------

def _card(weights):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return weights.to("cuda")


def _tokens(h, w, seed, cin=184, real=180):
    g = torch.Generator().manual_seed(seed)
    x = torch.zeros((h, w, cin))
    x[..., :real] = torch.randn((h, w, real), generator=g)
    return x


def _linear_layer(n, c, seed, std=0.05):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((n, c), generator=g) * std,
            torch.randn(n, generator=g) * 0.1)


def _ln(seed):
    g = torch.Generator().manual_seed(seed)
    return (1 + 0.2 * torch.randn(180, generator=g),
            0.2 * torch.randn(180, generator=g))


def _close(got, want, what):
    d = (got.double() - want.double()).abs().max().item()
    scale = want.double().abs().max().item()
    print(f"{what}: max abs error {d:.3e} of {scale:.3e}")
    assert d <= 2e-5 * max(scale, 1.0), (what, d, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(37, 45), (128, 96)])
def test_cuda_the_linears_against_f_linear(hw):
    # the 1-tap instances on the card against float64 on the CPU
    from srcnn_cpp_tpu_torch.ops.cuda_swinir import gemm_variant, ln_stats

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    h, w = hw
    x = _tokens(h, w, 1)
    gain, shift = _ln(2)
    normed = F.layer_norm(x[..., :180].double(), (180,), gain.double(),
                          shift.double(), 1e-5)
    wq, bq = _linear_layer(540, 180, 3)
    got = gemm_variant("qkv", x.cuda(), wq, bq,
                       ln=(gain, shift))["out"].cpu()
    _close(got[..., :540], F.linear(normed, wq.double(), bq.double()),
           "LN1 + qkv")
    assert not got[..., 540:].any()
    w1, b1 = _linear_layer(360, 180, 4)
    got = gemm_variant("fc1", x.cuda(), w1, b1,
                       ln=(gain, shift))["out"].cpu()
    _close(got[..., :360], F.gelu(F.linear(normed, w1.double(),
                                           b1.double())), "LN2 + fc1 + GELU")
    assert not got[..., 360:].any()
    skip = _tokens(h, w, 5)
    wp, bp = _linear_layer(180, 180, 6)
    res = gemm_variant("resid", x.cuda(), wp, bp, skip=skip.cuda())
    got = res["out"].cpu()
    _close(got[..., :180], skip[..., :180].double()
           + F.linear(x[..., :180].double(), wp.double(), bp.double()),
           "proj + residual")
    assert not got[..., 180:].any()
    # the statistics of the map it wrote, for the next LayerNorm loader
    _close(res["stats"].cpu(), ln_stats(got), "its LayerNorm statistics")
    hid = _tokens(h, w, 7, 368, 360)
    w2, b2 = _linear_layer(180, 360, 8)
    got = gemm_variant("resid", hid.cuda(), w2, b2,
                       skip=skip.cuda())["out"].cpu()
    _close(got[..., :180], skip[..., :180].double()
           + F.linear(hid[..., :360].double(), w2.double(), b2.double()),
           "fc2 + residual")


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(37, 45), (96, 128)])
def test_cuda_the_convs_against_f_conv2d(hw):
    from srcnn_cpp_tpu_torch.ops.cuda_swinir import gemm_variant, ln_stats

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    h, w = hw
    x = _tokens(h, w, 11)
    maps = x[..., :180].permute(2, 0, 1)[None].double()
    g = torch.Generator().manual_seed(12)
    wc = torch.randn((180, 180, 3, 3), generator=g) * 0.02
    bc = torch.randn(180, generator=g) * 0.1
    skip = _tokens(h, w, 13)
    y = F.conv2d(maps, wc.double(), bc.double(), padding=1)[0] \
        .permute(1, 2, 0) + skip[..., :180].double()
    res = gemm_variant("conv", x.cuda(), wc, bc, skip=skip.cuda())
    got = res["out"].cpu()
    _close(got[..., :180], y, "conv 180->180 + skip")
    assert not got[..., 180:].any()
    _close(res["stats"].cpu(), ln_stats(got), "its LayerNorm statistics")
    gain, shift = _ln(14)
    got = gemm_variant("conv_ln", x.cuda(), wc, bc, skip=skip.cuda(),
                       ln=(gain, shift))["out"].cpu()
    normed = F.layer_norm(x[..., :180].double(), (180,), gain.double(),
                          shift.double(), 1e-5).permute(2, 0, 1)[None]
    _close(got[..., :180], F.conv2d(normed, wc.double(), bc.double(),
                                    padding=1)[0].permute(1, 2, 0)
           + skip[..., :180].double(), "final LayerNorm + conv + skip")
    w6 = torch.randn((64, 180, 3, 3), generator=g) * 0.02
    b6 = torch.randn(64, generator=g) * 0.1
    got = gemm_variant("before_up", x.cuda(), w6, b6)["out"].cpu()
    _close(got, F.leaky_relu(F.conv2d(maps, w6.double(), b6.double(),
                                      padding=1)[0].permute(1, 2, 0), 0.01),
           "conv 180->64 + LeakyReLU")


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 4])
def test_cuda_the_attention_against_the_cpu_op(shift):
    from srcnn_cpp_tpu_torch.ops import swinir as ops
    from srcnn_cpp_tpu_torch.ops.cuda_swinir import gemm_variant

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    h, w = 24, 40
    g = torch.Generator().manual_seed(20 + shift)
    qkv = torch.zeros((h, w, 552))
    qkv[..., :540] = torch.randn((h, w, 540), generator=g)
    table = torch.randn((225, 6), generator=g) * 0.5
    got = gemm_variant("attention", qkv.cuda(), table=table,
                       shift=shift)["out"].cpu()
    # the CPU op's arithmetic from q, k, v, in float64
    x = qkv[None, ..., :540].double()
    if shift:
        x = ops.shift_tokens(x, shift)
    win = ops.windows(x).reshape(-1, 64, 3, 6, 30).permute(2, 0, 3, 1, 4)
    q, k, v = win[0] * 30 ** -0.5, win[1], win[2]
    bias = table.double()[ops.relative_position_index().reshape(-1)] \
        .reshape(64, 64, 6).permute(2, 0, 1)
    a = q @ k.transpose(-2, -1) + bias[None]
    if shift:
        a = a + ops.attention_mask(h, w).double()[:, None]
    o = (torch.softmax(a, -1) @ v).transpose(1, 2).reshape(-1, 64, 180)
    want = ops.unwindows(o, h, w)
    if shift:
        want = ops.shift_tokens(want, -shift)
    _close(got[..., :180], want[0], f"attention, shift {shift}")
    assert not got[..., 180:].any()


def _card_frames(h, w, seed):
    return torch.from_numpy(_frames(1, h, w, seed)).cuda() \
        .permute(0, 3, 1, 2).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(64, 96), (60, 90)])
def test_cuda_swinir_fused_matches_the_reference(swinir, hw):
    # 3xTF32 on tensor cores through 36 STLs against the plain fp32
    # reference on the card: each byte within 1 LSB
    from portbench.reference import swinir_bgr
    from srcnn_cpp_tpu_torch.ops.cuda_swinir import swinir_fused

    w = _card(swinir)
    h, wd = hw
    x = _card_frames(h, wd, 30)
    launches, windows = swinir_fused.launches, swinir_fused.windows
    got = swinir_fused(x, w, (2 * h, 2 * wd))
    torch.cuda.synchronize()
    assert swinir_fused.launches == launches + 1
    assert swinir_fused.windows == windows + 36 * (-(-h // 8)) \
        * (-(-wd // 8))
    ref = swinir_bgr.load(RECIPE, "cuda")
    want = swinir_bgr.upscale_frame(x[0].permute(1, 2, 0), ref, 2.0)
    mx, frac = _lsb(got[0].permute(1, 2, 0).cpu(), want.cpu())
    print(f"{hw}: max {mx} LSB on {frac:.3e} of bytes")
    assert mx <= 1 and frac < 1e-2, (mx, frac)


@pytest.mark.cuda
def test_cuda_a_frame_in_a_batch_is_the_frame_alone(swinir):
    from srcnn_cpp_tpu_torch.ops.cuda_swinir import swinir_fused

    w = _card(swinir)
    x = torch.from_numpy(_frames(3, 40, 56, 2)).cuda() \
        .permute(0, 3, 1, 2).contiguous()
    batch = swinir_fused(x, w, (80, 112))
    for i in (0, 2):
        assert torch.equal(batch[i], swinir_fused(x[i:i + 1], w,
                                                  (80, 112))[0])


@pytest.mark.cuda
def test_cuda_a_frame_is_194_launches(swinir):
    from torch.profiler import ProfilerActivity, profile

    from srcnn_cpp_tpu_torch.ops.cuda_swinir import (launch_schedule,
                                                     swinir_fused)

    w = _card(swinir)
    x = _card_frames(32, 48, 4)
    swinir_fused(x, w, (64, 96))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        swinir_fused(x, w, (64, 96))
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "_kernel" in e.name]
    assert len(names) == len(launch_schedule(6, 6)) == 194, len(names)
    assert sum("swin_stl_" in n for n in names) == 180


@pytest.mark.cuda
def test_cuda_upscale_bgr_batch_runs_swinir(swinir):
    from srcnn_cpp_tpu_torch import upscale_bgr_batch
    from srcnn_cpp_tpu_torch.ops.cuda_resize import pre_upscale_fused
    from srcnn_cpp_tpu_torch.ops.cuda_swinir import swinir_fused

    w = _card(swinir)
    frames = torch.from_numpy(_frames(2, 30, 50, 3)).cuda()
    launches, k2 = swinir_fused.launches, pre_upscale_fused.launches
    got = upscale_bgr_batch(frames, 2.0, w, "cuda")
    assert got.is_cuda and tuple(got.shape) == (2, 60, 100, 3)
    assert swinir_fused.launches == launches + 1
    assert pre_upscale_fused.launches == k2
    host = upscale_bgr_batch(frames.cpu().numpy(), 2.0, w, "cuda")
    assert np.array_equal(host, got.cpu().numpy())
