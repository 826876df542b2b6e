"""PyTorch port, VDSR on the normal path (``weights.vdsr``, ``ops.vdsr``,
``ops.cuda_vdsr``, ``pipeline.network_y``).

On the CPU the chain runs its plain ``F.conv2d`` path; these tests hold the
port's entry points against the benchmark's plain reference
(``portbench/reference/vdsr_bgr.py``) on the configuration's seeded
weights at their published widths (20 layers of 64 maps), drive the
benchmark's cell through ``run.run_cell`` at a small size, plant faults
that its comparison must catch, check that the SRCNN-only paths refuse
VDSR weights, and check the kernel's packed layout, stage layout and
descriptors by decoding them as wgmma reads them.

Tests marked ``cuda`` compare the kernel with its plain version on the
card; this file imports neither JAX nor the test conftest, so they run
with ``python -m pytest tests/test_torch_vdsr.py -m cuda --noconftest -o
addopts=""``.
"""

import dataclasses
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
VDSR_CU = REPO / "srcnn_cpp_tpu_torch/csrc/vdsr_conv.cu"
CONFIGS = REPO / "portbench/configs"
NPZ = CONFIGS / "vdsr20_seeded.npz"


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _smooth(b, h, w, seed):
    """Frames with the gradients of images: a bilinear field plus noise."""
    g = torch.Generator().manual_seed(seed)
    coarse = torch.rand((b, 3, 3, 4), generator=g) * 200 + 28
    x = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear")
    x = x + 12 * (torch.rand((b, 3, h, w), generator=g) - 0.5)
    return x.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1) \
        .contiguous().numpy()


def _lsb(a, b):
    d = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
    return d.max(), (d > 0).mean()


@pytest.fixture(scope="module")
def vdsr():
    from srcnn_cpp_tpu_torch.weights import load_vdsr_weights

    return load_vdsr_weights(NPZ)


@pytest.fixture(scope="module")
def ref_weights():
    from portbench.reference import vdsr_bgr

    return vdsr_bgr.load(NPZ, "cpu")


def _reference(frames, ref_weights, scale=2.0):
    from portbench.reference import vdsr_bgr

    return np.stack([vdsr_bgr.upscale_frame(torch.from_numpy(f), ref_weights,
                                            scale).numpy() for f in frames])


# --- weights --------------------------------------------------------------------

def test_the_container_holds_the_published_network(vdsr):
    from srcnn_cpp_tpu_torch.weights import VDSRWeights, weights_on

    assert len(vdsr.layers) == 20 and len(vdsr.as_dict()) == 40
    assert tuple(vdsr.layers[0][0].shape) == (64, 1, 3, 3)
    assert all(tuple(w.shape) == (64, 64, 3, 3) for w, _ in vdsr.layers[1:-1])
    assert tuple(vdsr.layers[-1][0].shape) == (1, 64, 3, 3)
    assert vdsr.device == torch.device("cpu")
    assert vdsr.as_dict()["conv20_b"] is vdsr.layers[-1][1]
    moved = vdsr.to("cpu")
    assert isinstance(moved, VDSRWeights) and len(moved.layers) == 20
    assert weights_on(vdsr, "cpu") is vdsr
    with pytest.raises(ValueError):
        VDSRWeights(vdsr.layers[:19])
    with pytest.raises(ValueError):
        VDSRWeights(((vdsr.layers[1][0], vdsr.layers[1][1]),
                     *vdsr.layers[1:]))


def test_the_loader_refuses_another_checkpoint():
    from srcnn_cpp_tpu_torch.weights import load_vdsr_weights, weights_npz

    with pytest.raises(ValueError, match="no VDSR checkpoint"):
        load_vdsr_weights(weights_npz())


def test_make_vdsr20_regenerates_the_weights_byte_for_byte(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "make_vdsr20", CONFIGS / "make_vdsr20.py")
    mk = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mk)
    out = tmp_path / "again.npz"
    assert mk.main([str(out)]) == 0
    assert out.read_bytes() == NPZ.read_bytes()
    with np.load(out) as z:
        assert len(z.files) == 40
        std = z["conv2_w"].std()
        assert abs(std - np.sqrt(2 / 576)) < 0.01 * np.sqrt(2 / 576)
        assert not z["conv7_b"].any()


# --- the normal path against the reference ------------------------------------

def test_upscale_bgr_batch_runs_vdsr_like_the_reference(vdsr, ref_weights):
    from srcnn_cpp_tpu_torch import upscale_bgr_batch
    from srcnn_cpp_tpu_torch.ops import cuda_vdsr

    frames = _smooth(2, 24, 32, 1)
    calls = cuda_vdsr.vdsr_y_plain.calls
    got = upscale_bgr_batch(frames, 2.0, vdsr, device="cpu")
    assert cuda_vdsr.vdsr_y_plain.calls == calls + 1
    assert got.shape == (2, 48, 64, 3) and got.dtype == np.uint8
    # F.conv2d against the reference's patch products: both fp32, in other
    # orders; a Y' off by 1 moves B, G, R by at most 2 through the colour
    mx, frac = _lsb(got, _reference(frames, ref_weights))
    assert mx <= 2 and frac < 5e-3, (mx, frac)


def test_the_configs_runner_and_the_stream_run_vdsr(vdsr, ref_weights):
    from srcnn_cpp_tpu_torch.configs import batch_1080p_to_4k
    from srcnn_cpp_tpu_torch.stream import StreamUpscaler

    frames = _smooth(3, 20, 28, 2)
    want = _reference(frames, ref_weights)
    run = batch_1080p_to_4k(vdsr, batch=2, device="cpu")
    mx, frac = _lsb(run(frames), want)
    assert mx <= 2 and frac < 5e-3, (mx, frac)
    s = StreamUpscaler(2.0, weights=vdsr, depth=2, device="cpu")
    outs = [o for f in frames for o in [s.push(f)] if o is not None]
    outs += s.drain()
    assert len(outs) == 3
    mx, frac = _lsb(np.stack(outs), want)
    assert mx <= 2 and frac < 5e-3, (mx, frac)


def test_process_srcnn_runs_vdsr_on_one_plane(vdsr, ref_weights):
    from portbench.reference.resize import resize_plane
    from portbench.reference.vdsr import vdsr_y
    from srcnn_cpp_tpu_torch import process_srcnn

    img = _smooth(1, 18, 22, 3)[0, :, :, 0].copy()
    out, size = process_srcnn(img.reshape(-1), 22, 18, 1, 2.0, vdsr, "cpu")
    assert size == 36 * 44
    up = resize_plane(torch.from_numpy(img), (36, 44))
    mx, frac = _lsb(out.reshape(36, 44), vdsr_y(up, ref_weights))
    assert mx <= 1 and frac < 5e-3, (mx, frac)


def test_the_plain_chain_is_x_plus_f(vdsr):
    from srcnn_cpp_tpu_torch.ops.vdsr import vdsr_residual_f32, vdsr_y

    y = torch.from_numpy(_u8((2, 9, 13), 4))
    x, f = vdsr_residual_f32(y, vdsr)
    assert torch.equal(x, y.float() / 255)
    assert torch.equal(vdsr_y(y, vdsr), torch.round((x + f) * 255)
                       .clamp(0, 255).to(torch.uint8))
    assert torch.equal(vdsr_y(y[0], vdsr), vdsr_y(y, vdsr)[0])


# --- the benchmark's cell --------------------------------------------------------

def _cell(hw=(12, 20)):
    """``vdsr1080p.tensor`` at ``hw`` input frames, 4 distinct, 2 a call."""
    from portbench import spec

    cell = spec.cell("vdsr1080p.tensor")
    cfg = dict(cell.config, in_hw=list(hw), out_hw=[2 * hw[0], 2 * hw[1]],
               frames_per_call=2, runner_kwargs={"batch": 2})
    return dataclasses.replace(cell, config=cfg, traffic=dict(
        cell.traffic, distinct_frames=4, warmup_units=1))


def _drop_residual(real, y, w):
    from srcnn_cpp_tpu_torch.ops.vdsr import quantize_round_u8, \
        vdsr_residual_f32

    y3 = y[None] if y.dim() == 2 else y
    return quantize_round_u8(vdsr_residual_f32(y3, w)[1]).reshape(y.shape)


def _scale_a_middle_layer(real, y, w):
    from srcnn_cpp_tpu_torch.weights import VDSRWeights

    layers = list(w.layers)
    layers[10] = (layers[10][0] * 1.01, layers[10][1])
    return real(y, VDSRWeights(tuple(layers)))


def _replicate_padding(real, y, w):
    import torch.nn.functional as F

    from srcnn_cpp_tpu_torch.ops.vdsr import quantize_round_u8

    y3 = y[None] if y.dim() == 2 else y
    x = y3.float()[:, None] / 255
    h = x
    for i, (wi, bi) in enumerate(w.layers):
        h = F.conv2d(F.pad(h, (1, 1, 1, 1), mode="replicate"), wi, bi)
        h = F.relu(h) if i + 1 < len(w.layers) else h
    return quantize_round_u8((x + h)[:, 0]).reshape(y.shape)


def test_the_cell_is_correct_at_a_small_size():
    from portbench import run

    r = run.run_cell(_cell(), 2 ** 31 + 99, 0.2, False, "cpu")
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0, r
    assert set(r["metrics"]) == {"out_mpps", "setup_s"}
    assert r["checks"]["max_lsb"]["value"] <= 1


@pytest.mark.parametrize("fault", [_drop_residual, _scale_a_middle_layer,
                                   _replicate_padding])
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    from portbench import run
    from srcnn_cpp_tpu_torch.ops import cuda_vdsr

    real = cuda_vdsr.vdsr_y
    monkeypatch.setattr(cuda_vdsr, "vdsr_y",
                        lambda y, w: fault(real, y, w))
    r = run.run_cell(_cell((14, 22)), 4_000_000_007, 0.2, False, "cpu")
    assert not r["correct"], r
    assert r["checks"]["share_off"]["value"] > 0.05


# --- what refuses VDSR weights ---------------------------------------------------

def test_the_mesh_runner_refuses_vdsr(vdsr):
    from srcnn_cpp_tpu_torch.configs import single_8k
    from srcnn_cpp_tpu_torch.parallel import make_mesh

    mesh = make_mesh(2, 1, devices=["cpu"] * 2)
    with pytest.raises(TypeError, match="halo"):
        single_8k(vdsr, mesh=mesh)


def test_tiling_refuses_vdsr(vdsr):
    from srcnn_cpp_tpu_torch.parallel import make_mesh
    from srcnn_cpp_tpu_torch.parallel.tiling import (split_blocks,
                                                     srcnn_blocks)

    mesh = make_mesh(1, 2, devices=["cpu"] * 2)
    y = torch.from_numpy(_u8((1, 16, 16), 5))
    with pytest.raises(TypeError, match="20-pixel halo"):
        srcnn_blocks(split_blocks(y, mesh), vdsr, mesh)


def test_distributed_refuses_vdsr(vdsr):
    from srcnn_cpp_tpu_torch.parallel.distributed import (DistributedStream,
                                                          frame_mesh)

    with pytest.raises(TypeError, match="halo"):
        DistributedStream(2.0, frame_mesh(1, devices=["cpu"]), weights=vdsr)


@pytest.mark.parametrize("kernel", ["srcnn_merge_fused", "srcnn_y_f32_fused",
                                    "srcnn_y_fused"])
def test_the_srcnn_kernels_refuse_vdsr(vdsr, kernel):
    from srcnn_cpp_tpu_torch.ops import cuda_srcnn

    x = torch.from_numpy(_u8((1, 3, 8, 8) if kernel == "srcnn_merge_fused"
                             else (8, 8), 6))
    with pytest.raises(TypeError, match="halo"):
        getattr(cuda_srcnn, kernel)(x, vdsr)


def test_the_chain_refuses_srcnn_weights():
    from srcnn_cpp_tpu_torch.ops.cuda_vdsr import vdsr_y_fused
    from srcnn_cpp_tpu_torch.weights import load_weights

    with pytest.raises(TypeError, match="VDSRWeights"):
        vdsr_y_fused(torch.zeros((4, 4), dtype=torch.uint8), load_weights())


# --- the kernel's layout, decoded as wgmma reads it ----------------------------

def _read(mem, d, rows):
    """The ``[8 k][rows]`` tf32 operand of one k8 step that descriptor
    ``d`` points at in ``mem`` (float32 words): K-major, no swizzle, core
    matrices of 8 rows x 16 bytes, the next 4 k ``lbo`` bytes on, the next
    8 rows ``sbo`` bytes on (PTX ISA, "Matrix Descriptor Format")."""
    start, lbo = (d & 0x3FFF) << 4, ((d >> 16) & 0x3FFF) << 4
    sbo, swizzle = ((d >> 32) & 0x3FFF) << 4, d >> 62
    assert swizzle == 0 and start % 16 == 0
    k = np.arange(8)[:, None]
    r = np.arange(rows)[None, :]
    byte = start + (k // 4) * lbo + (r // 8) * sbo + (r % 8) * 16 + (k % 4) * 4
    return mem[byte // 4]


def _split(v):
    hi = (v.view(np.int32) & np.int32(-8192)).view(np.float32)
    return hi, (v - hi).astype(np.float32)


def _stage(act, packed, y0, x0, q):
    """One stage's shared memory as vdsr_conv.cu's producer fills it: the
    layer's weights of stage q, then input rows y0 - 1 .. y0 + 2, columns
    x0 - 1 .. x0 + 128 of channels 8q .. 8q + 7, zero off the image, as
    hi and lo planes of [columns][4 channels]."""
    from srcnn_cpp_tpu_torch.ops import cuda_vdsr as cv

    lay = cv.stage_layout()
    mem = np.zeros(lay["stage"], np.float32)
    mem[:lay["w_stage"]] = packed[q * lay["w_stage"]:(q + 1) * lay["w_stage"]]
    h, w = act.shape[:2]
    for i in range(cv.IN_ROWS):
        for col in range(cv.COLS):
            gy, gx = y0 - 1 + i, x0 - 1 + col
            if not (0 <= gy < h and 0 <= gx < w):
                continue
            hi, lo = _split(act[gy, gx, 8 * q:8 * q + 8])
            for half in (0, 1):
                off = lay["x_hi"] + i * lay["row"] + half * lay["half"] \
                    + 4 * col
                mem[off:off + 4] = hi[4 * half:4 * half + 4]
                mem[off + lay["plane"]:off + lay["plane"] + 4] = \
                    lo[4 * half:4 * half + 4]
    return mem


@pytest.mark.parametrize("y0,x0", [(0, 0), (2, 128), (4, 0)])
def test_a_units_products_are_the_layers_conv(y0, x0):
    """Each consumer's 8 stages x 9 taps x (lo.hi + hi.lo + hi.hi), read
    through the module's descriptors from the packed weights and the
    staged activations, give the layer's conv (before ReLU) at its row."""
    import torch.nn.functional as F

    from srcnn_cpp_tpu_torch.ops import cuda_vdsr as cv

    g = torch.Generator().manual_seed(7)
    h, w = 5, 150                         # a partial row pair and strip
    act = torch.relu(torch.randn((h, w, 64), generator=g))
    wt = torch.randn((64, 64, 3, 3), generator=g) * (2 / 576) ** 0.5
    b = torch.randn(64, generator=g) * 0.1
    packed = cv.pack_layer(wt, b).numpy()
    assert packed.size == cv.LAYER_FLOATS
    np.testing.assert_array_equal(packed[-64:], b.numpy())
    want = F.conv2d(act.permute(2, 0, 1)[None].double(), wt.double(),
                    b.double(), padding=1)[0].numpy()      # [64, h, w]
    acc = {c: np.tile(b.numpy()[:, None], (1, cv.STRIP)).astype(np.float64)
           for c in range(cv.CONSUMERS)}
    for q in range(cv.CHUNKS):
        mem = _stage(act.numpy(), packed, y0, x0, q)
        for c in range(cv.CONSUMERS):
            for tap in range(cv.TAPS):
                a = [_read(mem, cv.weight_descriptor(tap, p), 64)
                     .astype(np.float64) for p in (0, 1)]
                x = [_read(mem, cv.act_descriptor(c, tap // 3, tap % 3, p),
                           cv.STRIP).astype(np.float64) for p in (0, 1)]
                acc[c] += a[1].T @ x[0] + a[0].T @ x[1] + a[0].T @ x[0]
    for c in range(cv.CONSUMERS):
        cols = slice(x0, min(w, x0 + cv.STRIP))
        if y0 + c < h:
            got = acc[c][:, :cols.stop - cols.start]
            np.testing.assert_allclose(got, want[:, y0 + c, cols],
                                       rtol=0, atol=1e-5)


def _constant(name):
    return int(re.search(rf"\b{name} = (\d+)", VDSR_CU.read_text()).group(1))


def test_the_plan_mirrors_the_cuda_source():
    from srcnn_cpp_tpu_torch.ops import cuda_vdsr as cv

    src = VDSR_CU.read_text()
    lay = cv.stage_layout()
    from srcnn_cpp_tpu_torch.weights.vdsr import DEPTH

    assert (_constant("DEPTH"), _constant("TN"), _constant("ROWS"),
            _constant("CG"), _constant("STAGES")) == (
        DEPTH, cv.STRIP, cv.UNIT_ROWS, cv.STAGE_CHANNELS, cv.STAGES)
    assert (f"static_assert(W_STAGE == {lay['w_stage']} && ACT_PLANE == "
            f"{lay['plane']} && STAGE == {lay['stage']},") in src
    assert cv.vdsr_smem_bytes() == 211968 + 48 <= cv.SMEM_LIMIT
    assert "m64n128k8.f32.tf32.tf32" in src
    # the activation planes lie 16 banks apart, for the producer's stores
    assert (16 * cv.PLANE_COLS) % 128 == 64
    plan = cv.vdsr_plan(2160, 3840, 132)
    assert plan["units"] == 1080 * 30 and plan["grid"] == 132
    assert plan["smem_bytes"] == cv.vdsr_smem_bytes()
    assert cv.vdsr_plan(3, 5, 132)["grid"] == 2


def test_the_packed_edges_and_layers(vdsr):
    from srcnn_cpp_tpu_torch.ops import cuda_vdsr as cv

    first, middle, last = (t.numpy() for t in cv.pack_vdsr(vdsr))
    (w1, b1), (w20, b20) = vdsr.layers[0], vdsr.layers[-1]
    np.testing.assert_array_equal(first[:576].reshape(9, 64),
                                  w1.reshape(64, 9).t().numpy())
    np.testing.assert_array_equal(first[576:], b1.numpy())
    np.testing.assert_array_equal(last[:576].reshape(9, 64),
                                  w20.reshape(64, 9).t().numpy())
    assert last[576] == b20.item() and not last[577:].any()
    assert middle.size == 18 * cv.LAYER_FLOATS
    np.testing.assert_array_equal(
        middle[5 * cv.LAYER_FLOATS:6 * cv.LAYER_FLOATS],
        cv.pack_layer(*vdsr.layers[6]).numpy())
    assert cv.pack_vdsr(vdsr)[1] is cv.pack_vdsr(vdsr)[1]


# --- on the card -----------------------------------------------------------------

def _card(vdsr):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return vdsr.to("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,seed", [((2, 37, 300), 0), ((1, 2160, 3840), 1)])
def test_cuda_vdsr_y_fused_matches_its_plain_version(vdsr, shape, seed):
    # 3xTF32 on tensor cores, whose fp32 accumulation truncates, against
    # cuDNN's rounded fp32 sums: Y' within 1 LSB; on an H100 80GB HBM3 at
    # 700 W, max 1 LSB on 1.62e-3 of the small planes' pixels and 1.47e-3
    # of the 4K plane's (2.4e-3 of a plane of uniform noise; cuDNN and the
    # reference's fp32 patch products differ on 1.8e-5)
    from srcnn_cpp_tpu_torch.ops.cuda_vdsr import vdsr_y_fused, vdsr_y_plain

    w = _card(vdsr)
    frames = _smooth(shape[0], shape[1], shape[2], seed)[..., 0]
    y = torch.from_numpy(np.ascontiguousarray(frames)).cuda()
    launches = vdsr_y_fused.launches
    got = vdsr_y_fused(y, w)
    torch.cuda.synchronize()
    assert vdsr_y_fused.launches == launches + 1
    want = vdsr_y_plain(y, w)
    mx, frac = _lsb(got.cpu(), want.cpu())
    print(f"{shape}: max {mx} LSB on {frac:.3e} of Y'")
    assert mx <= 1 and frac < 5e-3, (mx, frac)


@pytest.mark.cuda
def test_cuda_upscale_bgr_batch_runs_the_chain(vdsr):
    from srcnn_cpp_tpu_torch import upscale_bgr_batch
    from srcnn_cpp_tpu_torch.ops.cuda_vdsr import vdsr_y_fused

    w = _card(vdsr)
    frames = torch.from_numpy(_smooth(2, 60, 90, 3)).cuda()
    launches = vdsr_y_fused.launches
    got = upscale_bgr_batch(frames, 2.0, w, "cuda")
    assert got.is_cuda and vdsr_y_fused.launches == launches + 1
    want = upscale_bgr_batch(frames.cpu(), 2.0, vdsr, "cpu")
    mx, frac = _lsb(got.cpu(), want)
    # as above, through the colour: an H100 gives max 1 on 1.22e-3 of bytes
    print(f"BGR: max {mx} LSB on {frac:.3e} of bytes")
    assert mx <= 2 and frac < 5e-3, (mx, frac)
