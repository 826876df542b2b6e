"""PyTorch port, the tensor-core conv body (K1/K4/K5) and K2's window plan.

The CUDA kernels cannot run on the CPU, so these tests check what surrounds
them in Python and their arithmetic by emulation:

* a 3xTF32 emulation of ``csrc/srcnn_conv.cu`` that decodes the packed
  weight buffer by the mma.sync m16n8k8 fragment layout (written out here
  from the PTX definitions, not taken from the module), splits each A
  operand as the kernel does and truncates every operand to tf32, is held
  against the JAX package's ``srcnn_y`` / ``srcnn_y_f32`` (XLA, fp32) and
  the Pallas ``srcnn_y_fused`` (interpret mode on the CPU).  Tolerances:
  <=1 LSB on < 5e-3 of pixels, f32 within 1e-2 (chip_smoke.py's bars);
* the conv tile plan: shared memory within one block's limit, every output
  pixel covered exactly once, every conv1 read inside the window;
* K2's window plan: every tap of ``cubic_tables`` inside its block's window
  at the seven scales of chip_smoke.py's phase 3, and a NumPy emulation of
  the kernel's three steps over that plan bit-equal to the plain version.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
CONV_CU = REPO / "srcnn_cpp_tpu_torch/csrc/srcnn_conv.cu"

# mma.sync.m16n8k8 tf32 fragments, thread (g, t) = (lane // 4, lane % 4):
# (row offset, column) of each register, from the PTX ISA's figures
A_FRAG = lambda t: [(0, t), (8, t), (0, t + 4), (8, t + 4)]            # noqa: E731
C_FRAG = lambda t: [(0, 2 * t), (0, 2 * t + 1), (8, 2 * t), (8, 2 * t + 1)]  # noqa: E731
B_FRAG = lambda t: [t, t + 4]         # k rows of b0, b1 (column n = g)  # noqa: E731


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _lsb(a, b):
    d = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
    return d.max(), (d > 0).mean()


@pytest.fixture(scope="module")
def tweights(weights):
    from srcnn_cpp_tpu_torch.weights import from_jax_params

    return from_jax_params(weights)


def _a_from_c():
    """The kernel's relu_split: which accumulator register feeds each A
    register, read from the source."""
    body = CONV_CU.read_text().split("void relu_split(")[1].split("}")[0]
    return [int(i) for i in re.findall(r"fmaxf\(c\[(\d)\]", body)]


def _perm_from_layouts():
    """K position -> channel when A registers take accumulator registers
    ``_a_from_c()`` of the previous stage."""
    perm = [None] * 64
    a_from_c = _a_from_c()
    for j in range(8):
        for t in range(4):
            for ai, ci in enumerate(a_from_c):
                (ar, acol), (cr, ccol) = A_FRAG(t)[ai], C_FRAG(t)[ci]
                assert ar == cr                  # same position (row)
                perm[8 * j + acol] = 8 * j + ccol
    return perm


def _decode(packed, off, k, n):
    """Fragment-ordered hi/lo planes at float offset ``off`` -> [k][n]."""
    blk = packed[off:off + k * n * 2].reshape(k // 8, n // 8, 32, 4)
    hi, lo = np.zeros((k, n), np.float32), np.zeros((k, n), np.float32)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for r, kr in enumerate(B_FRAG(t)):
            hi[kr::8, g::8] = blk[:, :, lane, r]
            lo[kr::8, g::8] = blk[:, :, lane, 2 + r]
    return hi, lo


def _planes(packed):
    """The packed buffer as the kernel reads it (srcnn_conv.cu offsets)."""
    p = np.asarray(packed, np.float32)
    return {"w1": _decode(p, 0, 88, 64), "b1": p[11264:11328],
            "w2": _decode(p, 11328, 64, 32), "b2": p[15424:15456],
            "w3": _decode(p, 15456, 32, 32), "b3": p[17504]}


def _mask(x, bits):
    """fp32 ``x`` with its low ``bits`` mantissa bits cleared."""
    return (np.asarray(x, np.float32).view(np.int32)
            & np.int32(-(1 << bits))).view(np.float32)


def _tf32(x):
    """What the tensor core reads of an fp32 register: the low 13 bits
    dropped."""
    return _mask(x, 13)


def _bf16_rne(x):
    """fp32 ``x`` rounded to bf16, half to even."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


#: hi/lo splits of an fp32 operand, as each scheme's products read them
SPLITS = {
    "3xTF32, hi and lo truncated (srcnn_conv.cu)":
        lambda x: (_tf32(x), _tf32(np.float32(x) - _tf32(x))),
    "bf16x3, hi and lo truncated":
        lambda x: (_mask(x, 16), _mask(np.float32(x) - _mask(x, 16), 16)),
    "bf16x3, hi masked, lo rounded (srcnn_y_f32_split)":
        lambda x: (_mask(x, 16), _bf16_rne(np.float32(x) - _mask(x, 16))),
}
_KERNEL_SPLIT = next(iter(SPLITS.values()))


def _mm3(a, w, split):
    """3-product split matmul of f32 activations ``a`` [..., K] and weight
    planes ``w`` (hi, lo) as read: al.bh + ah.bl + ah.bh, products exact."""
    ah, al = (v.astype(np.float64) for v in split(a))
    wh, wl = (v.astype(np.float64) for v in w)
    return al @ wh + ah @ wl + ah @ wh


def _emulate(y_u8, pl, perm, split=_KERNEL_SPLIT):
    """f32 conv3 + b3 of u8 planes [B, H, W] from weight planes ``pl`` (in
    the kernel's K order, as the products read them): conv1 takes 2
    products (u8 is exact in tf32 and bf16), conv2 and conv3's per-tap
    partials 3, the 25-tap stencil sums in tap order in f32."""
    b, h, w = y_u8.shape
    x = np.pad(y_u8.astype(np.float32), ((0, 0), (4, 4), (4, 4)), mode="edge")
    cols = np.zeros((b, h, w, 88), np.float64)
    for k in range(81):
        ky, kx = divmod(k, 9)
        cols[..., k] = x[:, ky:ky + h, kx:kx + w]
    w1h, w1l = (a.astype(np.float64) for a in pl["w1"])
    f1 = np.maximum((cols @ w1l + cols @ w1h + pl["b1"]).astype(np.float32), 0)
    f2 = np.maximum((_mm3(f1[..., perm], pl["w2"], split) + pl["b2"])
                    .astype(np.float32), 0)
    part = _mm3(f2[..., perm[:32]], pl["w3"], split).astype(np.float32)
    part = np.pad(part, ((0, 0), (2, 2), (2, 2), (0, 0)), mode="edge")
    out = np.zeros((b, h, w), np.float32)
    for tap in range(25):
        dy, dx = divmod(tap, 5)
        out = (out + part[:, dy:dy + h, dx:dx + w, tap]).astype(np.float32)
    return (out + pl["b3"]).astype(np.float32)


def emulate_tf32x3(y_u8, packed):
    """f32 conv3 + b3 of u8 planes [B, H, W], as srcnn_conv.cu computes it
    from its packed weight buffer."""
    pl = _planes(packed)
    for k in ("w1", "w2", "w3"):
        pl[k] = tuple(_tf32(v) for v in pl[k])
    return _emulate(y_u8, pl, _perm_from_layouts())


def emulate_split(y_u8, tw, split):
    """The kernel's algorithm with the weights split by ``split``."""
    perm = _perm_from_layouts()
    w1 = np.zeros((88, 64), np.float32)
    w1[:81] = tw.conv1_w.numpy().reshape(64, 81).T
    w3 = np.zeros((32, 32), np.float32)
    w3[:, :25] = tw.conv3_w.numpy().reshape(32, 25)[perm[:32]]
    pl = {"w1": split(w1), "b1": tw.conv1_b.numpy(),
          "w2": split(tw.conv2_w.numpy().reshape(32, 64)[:, perm].T),
          "b2": tw.conv2_b.numpy(), "w3": split(w3),
          "b3": tw.conv3_b.numpy()[0]}
    return _emulate(y_u8, pl, perm, split)


def _border_batch():
    g = np.meshgrid(np.arange(48), np.arange(200), indexing="ij")
    img = ((g[0] * 37 + g[1] * 11) % 256).astype(np.uint8)
    img[:3, :], img[:, :3], img[-3:, :], img[:, -3:] = 255, 0, 255, 0
    return np.stack([img, 255 - img, np.roll(img, 7, axis=1)])


# --- the 3xTF32 emulation against the JAX package --------------------------

@pytest.mark.parametrize("case", ["40x520", "3x32x256", "border"])
def test_tf32x3_emulation_matches_jax(weights, tweights, case):
    from srcnn_cpp_tpu.ops.pallas_srcnn import srcnn_y_fused as jax_fused
    from srcnn_cpp_tpu.ops.srcnn import srcnn_y as jax_xla
    from srcnn_cpp_tpu.ops.srcnn import srcnn_y_f32 as jax_f32
    from srcnn_cpp_tpu_torch.ops.cuda_srcnn import pack_weights

    y = {"40x520": _u8((40, 520), 0), "3x32x256": _u8((3, 32, 256), 9),
         "border": _border_batch()}[case]
    y3 = y[None] if y.ndim == 2 else y
    got = emulate_tf32x3(y3, pack_weights(tweights).numpy()).reshape(y.shape)
    np.testing.assert_allclose(got, np.asarray(jax_f32(y, weights)),
                               rtol=0, atol=1e-2)
    q = np.clip(np.trunc(got), 0, 255).astype(np.uint8)
    refs = [jax_xla(y, weights)] + ([] if case == "border"
                                    else [jax_fused(y, weights)])
    for ref in refs:
        mx, frac = _lsb(q, ref)
        assert mx <= 1 and frac < 5e-3, (mx, frac)


def test_c_to_a_perm_is_the_fragment_map():
    from srcnn_cpp_tpu_torch.ops.cuda_srcnn import c_to_a_perm

    assert _a_from_c() == [0, 2, 1, 3]
    assert c_to_a_perm() == _perm_from_layouts()
    assert sorted(c_to_a_perm()) == list(range(64))


def test_tf32_split_is_exact():
    from srcnn_cpp_tpu_torch.ops.cuda_srcnn import tf32_split

    x = torch.from_numpy(np.random.default_rng(3).standard_normal(4096)
                         .astype(np.float32))
    hi, lo = tf32_split(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert torch.equal(hi + lo, x)
    assert float((lo.abs() / x.abs().clamp_min(1e-30)).max()) < 2.0 ** -10


# --- the conv tile plan ------------------------------------------------------

def _constant(name):
    m = re.search(rf"\b{name} = (\d+)", CONV_CU.read_text())
    return int(m.group(1))


def test_conv_plan_mirrors_the_cuda_source():
    from srcnn_cpp_tpu_torch.ops import cuda_srcnn as cs

    src = CONV_CU.read_text()
    assert f"static_assert(SMEM_BYTES == {cs.conv_smem_bytes()}," in src
    assert (_constant("TH"), _constant("TW")) == cs.TILE
    assert _constant("NTHREADS") == cs.THREADS
    assert cs.conv_smem_bytes() <= cs.SMEM_LIMIT == 232_448


@pytest.mark.parametrize("b,h,w", [(1, 1, 1), (1, 3, 7), (1, 16, 8),
                                   (1, 17, 130), (3, 37, 29), (2, 1079, 1921),
                                   (4, 1080, 1920)])
def test_conv_tile_plan_covers_every_pixel_once(b, h, w):
    from srcnn_cpp_tpu_torch.ops.cuda_srcnn import (SMEM_LIMIT,
                                                    conv_tile_origin,
                                                    conv_tile_plan)

    plan = conv_tile_plan(b, h, w, num_sms=132)
    th, tw = plan["tile"]
    assert plan["smem_bytes"] <= SMEM_LIMIT and plan["threads"] == 256
    assert 1 <= plan["grid"] <= min(132, plan["tiles"])
    seen = np.zeros((b, h, w), np.int32)
    for k in range(plan["grid"]):          # block k's persistent walk
        for tile in range(k, plan["tiles"], plan["grid"]):
            f, oy0, ox0 = conv_tile_origin(tile, h, w)
            assert 0 <= f < b and oy0 < h and ox0 < w
            seen[f, oy0:oy0 + th, ox0:ox0 + tw] += 1
            # every conv1 read of the tile's f2 halo lies in its window
            rows = np.clip(oy0 - 2 + np.arange(th + 4), 0, h - 1) - oy0 + 2
            cols = np.clip(ox0 - 2 + np.arange(tw + 4), 0, w - 1) - ox0 + 2
            assert rows.min() >= 0 and rows.max() + 8 < th + 12
            assert cols.min() >= 0 and cols.max() + 8 < tw + 12
    assert (seen == 1).all()


# --- K2's window plan --------------------------------------------------------

_K2_CASES = [((540, 960), s) for s in (2.0, 1.5, 3.0, 1.25, 0.75, 1.2)] + \
    [((333, 517), 2.75)]


@pytest.mark.parametrize("hw,s", _K2_CASES)
def test_pre_pass_plan_windows_hold_every_tap(hw, s):
    from srcnn_cpp_tpu_torch.ops.cuda_resize import (PRE_SMEM_BUDGET,
                                                     pre_pass_plan,
                                                     pre_pass_smem_bytes)
    from srcnn_cpp_tpu_torch.ops.resize import cubic_tables, scaled_size

    h, w = hw
    ow, oh = scaled_size(w, h, s)
    plan = pre_pass_plan(oh, ow, h, w)
    (th, tw), (wh, ww) = plan["tile"], plan["win"]
    assert plan["smem_bytes"] == pre_pass_smem_bytes((th, tw), (wh, ww))
    assert plan["smem_bytes"] <= PRE_SMEM_BUDGET
    assert plan["grid"] == (-(-ow // tw), -(-oh // th))
    for dst, src, t, org, span in ((ow, w, tw, plan["x0"], ww),
                                   (oh, h, th, plan["y0"], wh)):
        idx = cubic_tables(dst, src, torch.device("cpu"))[0].numpy()
        o = org[np.arange(dst) // t][:, None]
        assert ((idx >= o) & (idx < o + span) & (idx < src)).all()


def _emulate_pre_pass(bgr, oh, ow, plan):
    """K2's three steps over its plan, in NumPy (int32 and float32)."""
    from srcnn_cpp_tpu_torch.ops.color import bgr2ycrcb_u8_planar
    from srcnn_cpp_tpu_torch.ops.resize_tables import cv_cubic_tables

    b, _, h, w = bgr.shape
    xi, xic, _ = cv_cubic_tables(ow, w)
    yi, _, yfc = cv_cubic_tables(oh, h)
    (th, tw), (wh, ww) = plan["tile"], plan["win"]
    out = np.zeros((b, 3, oh, ow), np.uint8)
    for by, y0 in enumerate(plan["y0"]):
        for bx, x0 in enumerate(plan["x0"]):
            win = bgr[:, :, y0:y0 + wh, x0:x0 + ww]        # step 1
            ycc = bgr2ycrcb_u8_planar(torch.from_numpy(
                np.ascontiguousarray(win))).numpy().astype(np.int32)
            oxs = np.arange(bx * tw, min(ow, (bx + 1) * tw))
            hs = sum(ycc[..., xi[oxs, j] - x0] * xic[oxs, j]   # step 2
                     for j in range(4))
            for oy in range(by * th, min(oh, (by + 1) * th)):  # step 3
                r = [hs[:, :, yi[oy, k] - y0].astype(np.float32)
                     * yfc[oy, k] for k in range(4)]
                v = r[3]
                for k in (2, 1, 0):
                    v = (r[k] + v).astype(np.float32)
                out[:, :, oy, oxs] = np.clip(np.rint(v), 0, 255)
    return out


@pytest.mark.parametrize("hw,s", [((72, 80), 2.0), ((90, 100), 0.75),
                                  ((70, 90), 1.2), ((40, 50), 2.75),
                                  ((400, 300), 0.1)])
def test_pre_pass_window_emulation_is_bit_exact(hw, s):
    # several blocks on each axis; at x0.75 and x0.1 the plan halves the
    # tile's rows to fit its shared memory
    from srcnn_cpp_tpu_torch.ops.cuda_resize import (PRE_TILE, pre_pass_plan,
                                                     pre_upscale_plain)
    from srcnn_cpp_tpu_torch.ops.resize import scaled_size

    h, w = hw
    ow, oh = scaled_size(w, h, s)
    bgr = _u8((2, 3, h, w), h * w)
    plan = pre_pass_plan(oh, ow, h, w)
    assert min(plan["grid"]) >= 1 and max(plan["grid"]) >= 2
    if s < 1:
        assert plan["tile"][0] < min(PRE_TILE[0], oh)
    got = _emulate_pre_pass(bgr, oh, ow, plan)
    ref = pre_upscale_plain(torch.from_numpy(bgr), (oh, ow)).numpy()
    assert np.array_equal(got, ref)


def test_pre_pass_plan_mirrors_the_cuda_source():
    from srcnn_cpp_tpu_torch.ops.cuda_resize import PRE_SMEM_BUDGET, PRE_TILE

    src = (REPO / "srcnn_cpp_tpu_torch/csrc/pre_pass.cu").read_text()
    bx = int(re.search(r"\bBX = (\d+)", src).group(1))
    assert PRE_TILE[1] <= bx           # one thread column per tile column
    assert PRE_SMEM_BUDGET <= 48 * 1024


def test_kernel_ab_loads_a_checkout_beside_the_package():
    import importlib

    from srcnn_cpp_tpu_torch.kernel_ab import load_checkout
    from srcnn_cpp_tpu_torch.ops import cuda_srcnn

    load_checkout(REPO, alias="srcnn_ab_selftest")
    other = importlib.import_module("srcnn_ab_selftest.ops.cuda_srcnn")
    assert other is not cuda_srcnn and other.PACKED_SIZE == cuda_srcnn.PACKED_SIZE
    assert other.runtime.__name__ == "srcnn_ab_selftest.runtime"


def split_table(seed: int = 0, hw=(256, 256)) -> list[tuple]:
    """Each split of :data:`SPLITS` on a seeded random plane with the
    pretrained weights, against the port's fp32 plain path: ``(split, max
    abs diff of the f32 result, max Y' diff, share of Y' pixels off)``."""
    from srcnn_cpp_tpu_torch.ops.srcnn import srcnn_y_f32
    from srcnn_cpp_tpu_torch.weights import load_weights

    tw = load_weights()
    y = _u8((1,) + tuple(hw), seed)
    ref = srcnn_y_f32(torch.from_numpy(y), tw).numpy()
    qref = np.clip(np.trunc(ref), 0, 255)
    rows = []
    for name, split in SPLITS.items():
        got = emulate_split(y, tw, split)
        d = np.abs(np.clip(np.trunc(got), 0, 255) - qref)
        rows.append((name, float(np.abs(got - ref).max()), int(d.max()),
                     float((d > 0).mean())))
    return rows


if __name__ == "__main__":
    # CPU emulation of the candidate splits (PERF.md):
    #   PYTHONPATH=. python tests/test_torch_conv_tc.py
    for row in split_table():
        print("%s: max |f32 diff| %.3g, max Y' diff %d LSB, Y' off %.2g" % row)
