"""PyTorch port, the tensor-core conv body (K1/K4/K5) and K2's window plan.

The CUDA kernels cannot run on the CPU, so these tests check what surrounds
them in Python and their arithmetic by emulation:

* a 3xTF32 emulation of ``csrc/srcnn_conv.cu`` that decodes the packed
  weight buffer by wgmma's K-major core-matrix layout through matrix
  descriptors (written out here from the PTX ISA, not taken from the
  module; the plane offsets and byte offsets are the CUDA source's),
  splits each A operand as the kernel does and truncates every operand to
  tf32, is held against the JAX package's ``srcnn_y`` / ``srcnn_y_f32``
  (XLA, fp32) and the Pallas ``srcnn_y_fused`` (interpret mode on the
  CPU).  Tolerances: <=1 LSB on < 5e-3 of pixels, f32 within 1e-2
  (chip_smoke.py's bars);
* the descriptors the module computes beside its layout, decoded by the
  same reader, give back the weights; ``c_to_a_perm`` follows from wgmma's
  A and D register fragments and the source's ``relu_split``;
* the conv work plan: shared memory within one block's limit, every output
  pixel covered exactly once, every conv1 read inside its window, m64
  tiles of positions;
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

# wgmma .m64nNk8 tf32 A and .m64nN f32 D register fragments (PTX ISA,
# "Register Fragments and Shared Memory Matrix Layouts"): warp w holds rows
# 16w .. 16w+15; thread (g, t) = (lane // 4, lane % 4) of it holds (row
# offset from 16w, column) of each register, per k8 step (A) and per n8
# column block (D) -- within a warp's rows, mma.sync.m16n8k8's layouts
A_FRAG = lambda t: [(0, t), (8, t), (0, t + 4), (8, t + 4)]            # noqa: E731
C_FRAG = lambda t: [(0, 2 * t), (0, 2 * t + 1), (8, 2 * t), (8, 2 * t + 1)]  # noqa: E731


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


def desc_fields(d: int) -> dict:
    """A wgmma matrix descriptor's fields (PTX ISA, "Matrix Descriptor
    Format"): start address, leading and stride byte offsets (each stored
    >> 4 in 14 bits), base offset (bits 49-51) and layout type (62-63)."""
    return {"start": (d & 0x3FFF) << 4, "lbo": ((d >> 16) & 0x3FFF) << 4,
            "sbo": ((d >> 32) & 0x3FFF) << 4, "base": (d >> 49) & 7,
            "swizzle": d >> 62}


def read_core_matrices(mem: np.ndarray, start: int, lbo: int, sbo: int,
                       n: int) -> np.ndarray:
    """The 8 x ``n`` tf32 B operand of one k8 step at shared byte address
    ``start`` of ``mem`` (float32 words), K-major with no swizzle: core
    matrices of 8 rows (n) x 16 bytes (4 k), rows 16 bytes apart; the core
    matrix of k half ``kc`` and n-block ``nb`` starts at ``start + kc *
    lbo + nb * sbo``."""
    k = np.arange(8)[:, None]
    col = np.arange(n)[None, :]
    byte = (start + (k // 4) * lbo + (col // 8) * sbo + (col % 8) * 16
            + (k % 4) * 4)
    assert (byte % 4 == 0).all()
    return mem[byte // 4]


def read_b(mem: np.ndarray, d: int, n: int) -> np.ndarray:
    """The B operand that descriptor ``d`` points at."""
    f = desc_fields(d)
    assert f["swizzle"] == 0 and f["base"] == 0
    return read_core_matrices(mem, f["start"], f["lbo"], f["sbo"], n)


def _source_layout() -> dict:
    """The plane offsets and descriptor byte offsets as srcnn_conv.cu
    states them."""
    src = CONV_CU.read_text()
    assert_block = src.split("static_assert(W1L_OFF ==")[1].split('"')[0]
    offs = dict(re.findall(r"(\w+)_OFF == (\d+)", "W1L_OFF ==" + assert_block))
    offs = {k: int(v) for k, v in offs.items()}
    lbo, sbo = re.search(r"LBO = (\d+), SBO = (\d+)", src).groups()
    return {"off": {"W1H": 0, **offs}, "lbo": int(lbo), "sbo": int(sbo)}


def _decode(packed, off, k, n, lbo, sbo):
    """A [k][n] tf32 plane at float offset ``off``, read k8 step by k8
    step as the kernel's descriptors address it (a step of an N-column
    plane is N x 8 floats further)."""
    return np.concatenate([read_core_matrices(packed, 4 * off + s * n * 32,
                                              lbo, sbo, n)
                           for s in range(k // 8)])


def _planes(packed):
    """The packed buffer as the kernel reads it (srcnn_conv.cu offsets)."""
    p = np.asarray(packed, np.float32)
    lay = _source_layout()
    o, lbo, sbo = lay["off"], lay["lbo"], lay["sbo"]

    def pair(i, k, n):
        return (_decode(p, o[f"W{i}H"], k, n, lbo, sbo),
                _decode(p, o[f"W{i}L"], k, n, lbo, sbo))

    return {"w1": pair(1, 88, 64), "b1": p[o["B1"]:o["B1"] + 64],
            "w2": pair(2, 64, 32), "b2": p[o["B2"]:o["B2"] + 32],
            "w3": pair(3, 32, 32), "b3": p[o["B3"]]}


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
    # the source chains stages with the register layout named above: each
    # stage's D block j becomes the next stage's k8 step j
    src = CONV_CU.read_text()
    assert "relu_split(acc1[j], ah[j], al[j])" in src
    assert "relu_split(acc2[j], bh[j], bl[j])" in src


def test_b_descriptors_decode_to_the_weights(tweights):
    # every k8 step of every plane, through the module's descriptors and
    # the PTX ISA reader above, at two shared-memory base addresses
    from srcnn_cpp_tpu_torch.ops import cuda_srcnn as cs

    p = cs.pack_weights(tweights).numpy()
    perm = cs.c_to_a_perm()
    w1 = np.zeros((88, 64), np.float32)
    w1[:81] = tweights.conv1_w.numpy().reshape(64, 81).T
    w3 = np.zeros((32, 32), np.float32)
    w3[:, :25] = tweights.conv3_w.numpy().reshape(32, 25)[perm[:32]]
    want = {"w1": w1, "w2": tweights.conv2_w.numpy().reshape(32, 64)[:, perm].T,
            "w3": w3}
    lay = _source_layout()
    assert (cs.LBO, cs.SBO) == (lay["lbo"], lay["sbo"]) == (128, 256)
    for base in (0, 4096):
        mem = np.concatenate([np.zeros(base // 4, np.float32), p])
        for name, m in want.items():
            k, n = m.shape
            hi, lo = cs.tf32_split(torch.from_numpy(np.ascontiguousarray(m)))
            for half, ref in (("hi", hi.numpy()), ("lo", lo.numpy())):
                off, pk, pn = cs.packed_layout()[f"{name}_{half}"]
                assert (pk, pn) == (k, n)
                assert 4 * off == 4 * lay["off"][f"W{name[1]}{half[0].upper()}"]
                assert (4 * off) % 128 == 0      # descriptor start alignment
                for s in range(k // 8):
                    d = cs.b_descriptor(f"{name}_{half}", s, base)
                    f = desc_fields(d)
                    assert f["start"] == base + 4 * off + s * n * 32
                    assert (f["lbo"], f["sbo"]) == (128, 256)
                    assert np.array_equal(read_b(mem, d, n),
                                          ref[8 * s:8 * s + 8])
    for name, n in (("b1", 64), ("b2", 32)):
        off, size = cs.packed_layout()[name]
        src = getattr(tweights, f"conv{name[1]}_b").numpy()
        assert size >= n and np.array_equal(p[off:off + n], src)
    assert p[cs.packed_layout()["b3"][0]] == tweights.conv3_b.numpy()[0]
    with pytest.raises(ValueError):
        cs.b_descriptor("w3_hi", 4)


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
    assert _constant("TW") == cs.STRIP
    assert _constant("RIN") == cs.RING_IN and _constant("RP") == cs.RING_PART
    assert _constant("NCONS") == cs.CONSUMERS
    assert 128 * (cs.CONSUMERS + 1) == cs.THREADS
    assert (_constant("CONS_REGS"), _constant("HELP_REGS")) == cs.REGS
    assert cs.CONSUMERS * 128 * cs.REGS[0] + 128 * cs.REGS[1] <= 65536
    assert cs.conv_smem_bytes() <= cs.SMEM_LIMIT == 232_448
    # one m64 wgmma tile per strip row: the strip and its 2-column halos
    assert cs.POSITIONS == cs.STRIP + 4 and cs.POSITIONS % 64 == 0
    assert "m64n64k8.f32.tf32.tf32" in src and "m64n32k8.f32.tf32.tf32" in src
    assert "mma.sync" not in src
    assert cs.POSITION_MACS == 2 * 88 * 64 + 3 * 64 * 32 + 3 * 32 * 32


@pytest.mark.parametrize("b,h,w", [(1, 1, 1), (1, 3, 7), (1, 16, 8),
                                   (1, 17, 130), (3, 37, 29), (2, 1079, 1921),
                                   (4, 1080, 1920)])
def test_conv_tile_plan_covers_every_pixel_once(b, h, w):
    from srcnn_cpp_tpu_torch.ops.cuda_srcnn import (
        POSITIONS, SMEM_LIMIT, WINDOW_COLS, conv_consumer_units, conv_f2_rows,
        conv_tile_origin, conv_tile_plan)

    plan = conv_tile_plan(b, h, w, num_sms=132)
    seg_h, tw = plan["tile"]
    assert plan["smem_bytes"] <= SMEM_LIMIT and plan["threads"] == 384
    assert 1 <= plan["grid"] <= min(132, plan["tiles"])
    seen = np.zeros((b, h, w), np.int32)
    walked = []
    m = np.arange(POSITIONS)
    for k in range(plan["grid"]):          # block k's persistent walk
        for c in range(2):                 # its two consumer warpgroups
            for tile in conv_consumer_units(plan, k, c):
                walked.append(tile)
                f, oy0, ox0 = conv_tile_origin(tile, h, w, seg_h)
                assert 0 <= f < b and oy0 < h and ox0 < w
                seen[f, oy0:oy0 + seg_h, ox0:ox0 + tw] += 1
                # each output row's conv3 reach lies in the unit's f2 rows
                lo, hi = conv_f2_rows(oy0, seg_h, h)
                for oy in range(oy0, min(oy0 + seg_h, h)):
                    reach = np.clip(oy + np.arange(-2, 3), 0, h - 1)
                    assert lo <= reach.min() and reach.max() <= hi
                # every conv1 read of a position lies in the window, and
                # window column c holds input column clamp(ox0 - 6 + c)
                fc = np.clip(ox0 - 2 + m, 0, w - 1)
                base = fc - ox0 + 2
                assert base.min() >= 0 and base.max() + 8 < WINDOW_COLS
                for kx in range(9):
                    assert np.array_equal(
                        np.clip(ox0 - 6 + base + kx, 0, w - 1),
                        np.clip(fc - 4 + kx, 0, w - 1))
                # every output column's conv3 reach is among the positions
                out = np.arange(ox0, min(ox0 + tw, w))
                for dx in range(5):
                    j = out - ox0 + dx
                    assert j.max() < POSITIONS
                    assert np.array_equal(fc[j], np.clip(out - 2 + dx, 0, w - 1))
    assert sorted(walked) == list(range(plan["tiles"]))
    assert (seen == 1).all()


def test_conv_plan_cuts_the_halo_at_the_main_geometry():
    # [4,1080,1920] on 132 SMs: one unit per consumer, 540-row segments;
    # 21,926 MACs per output pixel: 20,480 per f2 position times the
    # strip's 64/60 column halo and the segments' 1,084/1,080 rows
    from srcnn_cpp_tpu_torch.ops.cuda_srcnn import conv_macs, conv_tile_plan

    plan = conv_tile_plan(4, 1080, 1920, 132)
    assert plan["tile"] == (540, 60) and plan["tiles"] == 256
    npix = 4 * 1080 * 1920
    per_pixel = conv_macs(4, 1080, 1920, 132) / npix
    assert 18_912 < per_pixel < 22_000


# --- K2's window plan --------------------------------------------------------

_K2_CASES = [((540, 960), s) for s in (2.0, 1.5, 3.0, 1.25, 0.75, 1.2)] + \
    [((333, 517), 2.75)]


@pytest.mark.parametrize("hw,s", _K2_CASES)
def test_pre_pass_plan_windows_hold_every_tap(hw, s):
    from srcnn_cpp_tpu_torch.ops.cuda_resize import (PRE_COLS, PRE_ROWS,
                                                     PRE_SMEM_BUDGET, PRE_TW,
                                                     PRE_WARPS, pre_pass_plan,
                                                     pre_pass_smem_bytes)
    from srcnn_cpp_tpu_torch.ops.resize import cubic_tables, scaled_size

    h, w = hw
    ow, oh = scaled_size(w, h, s)
    plan = pre_pass_plan(oh, ow, h, w)
    (th, tw), (wh, ww) = plan["tile"], plan["win"]
    assert plan["smem_bytes"] == pre_pass_smem_bytes((th, tw), (wh, ww))
    assert plan["smem_bytes"] <= PRE_SMEM_BUDGET
    assert plan["grid"] == (-(-ow // tw), -(-oh // th))
    # a warp spans the tile's columns, PRE_COLS per lane; the tile is
    # PRE_WARPS * R rows tall; no scale here needs R cut below 2
    assert tw == PRE_TW and plan["cols"] == PRE_COLS
    assert th == PRE_WARPS * plan["rows"] and 1 < plan["rows"] <= PRE_ROWS
    assert plan["threads"] == 32 * PRE_WARPS and th <= plan["threads"]
    for dst, src, t, org, span in ((ow, w, tw, plan["x0"], ww),
                                   (oh, h, th, plan["y0"], wh)):
        idx = cubic_tables(dst, src, torch.device("cpu"))[0].numpy()
        o = org[np.arange(dst) // t][:, None]
        assert ((idx >= o) & (idx < o + span) & (idx < src)).all()


def test_pre_pass_plan_at_the_main_geometry():
    # x2, 540x960 -> 1080x1920: 128-column tiles of 8 warps x 8 rows, so 15
    # x 17 tiles an image; 36 window rows and 68 columns at most; two
    # blocks' shared memory (and 1 KB each of the system's) fit an SM
    from srcnn_cpp_tpu_torch.ops.cuda_resize import pre_pass_plan

    plan = pre_pass_plan(1080, 1920, 540, 960)
    assert plan["tile"] == (64, 128) and plan["rows"] == 8
    assert plan["grid"] == (15, 17)
    assert plan["win"] == (36, 68)
    assert 2 * (plan["smem_bytes"] + 1024) <= 228 * 1024


@pytest.mark.parametrize("hw,s", [((64, 64), 8.0), ((540, 960), 4.0),
                                  ((5, 7), 3.0), ((400, 300), 0.1),
                                  ((2000, 40), 0.05)])
def test_pre_pass_plan_tiles_fit_a_block(hw, s):
    # every plan's tile is WARPS * R rows, R <= PRE_ROWS, and no taller than
    # a block has threads (the kernel stages a row's taps a thread): the
    # launcher refuses any other
    from srcnn_cpp_tpu_torch.ops.cuda_resize import (PRE_ROWS, PRE_WARPS,
                                                     pre_pass_plan)
    from srcnn_cpp_tpu_torch.ops.resize import scaled_size

    h, w = hw
    ow, oh = scaled_size(w, h, s)
    plan = pre_pass_plan(oh, ow, h, w)
    th = plan["tile"][0]
    assert th == PRE_WARPS * plan["rows"] and 1 <= plan["rows"] <= PRE_ROWS
    assert th <= plan["threads"]


def _byte_perm(x, y, s):
    """CUDA's ``__byte_perm(x, y, s)`` on uint32 arrays."""
    src = np.stack([(x >> np.uint32(8 * i)) & np.uint32(255) for i in range(4)]
                   + [(y >> np.uint32(8 * i)) & np.uint32(255)
                      for i in range(4)])
    out = np.zeros(np.broadcast(x, y).shape, np.uint32)
    for i in range(4):
        out |= src[(s >> 4 * i) & 7] << np.uint32(8 * i)
    return out


def _dp2a(a, b, c, hi):
    """PTX ``dp2a.{lo,hi}.s32.u32``: c + the signed 16-bit halves of a times
    bytes 0,1 (lo) or 2,3 (hi) of b."""
    a = a.astype(np.uint32)
    a0 = (a & np.uint32(0xffff)).astype(np.uint16).view(np.int16)
    a1 = (a >> np.uint32(16)).astype(np.uint16).view(np.int16)
    sh = np.uint32(16 if hi else 0)
    b0 = ((b >> sh) & np.uint32(255)).astype(np.int64)
    b1 = ((b >> (sh + np.uint32(8))) & np.uint32(255)).astype(np.int64)
    return (c + a0.astype(np.int64) * b0 + a1.astype(np.int64) * b1)


def _round_u8(v):
    """K2's rounding form: clamp in float, add 1.5 * 2**23 (round half to
    even), the low byte of the float's bits."""
    v = np.minimum(np.maximum(v.astype(np.float32), np.float32(0)),
                   np.float32(255))
    return (v + np.float32(12582912.0)).view(np.uint32) & np.uint32(255)


def _ycc_word(b, g, r):
    """The window's word {Y, Cr, Cb, 0} of each pixel (int32 BGR)."""
    y = np.clip((b * 1868 + g * 9617 + r * 4899 + 8192) >> 14, 0, 255)
    cr = np.clip(((r - y) * 11682 + (128 << 14) + 8192) >> 14, 0, 255)
    cb = np.clip(((b - y) * 9241 + (128 << 14) + 8192) >> 14, 0, 255)
    return (y | cr << 8 | cb << 16).astype(np.uint32)


def _emulate_pre_pass(bgr, oh, ow, plan, window=None):
    """K2 over its plan, step by step in NumPy: per tile, the window of
    YCrCb words (4-byte loads from a word-aligned column where W % 4 == 0),
    the horizontal dp2a sums converted to float32 once, then per warp and
    lane R rows of 4 columns (the last lane's ragged), each row's four tap
    rows, the vertical float32 chain and the rounding form."""
    from srcnn_cpp_tpu_torch.ops.cuda_resize import PRE_COLS, _tables

    b, _, h, w = bgr.shape
    xi, xic, yi, yfc = _tables(oh, ow, h, w, window)
    (th_, tw_), (wh_, ww_), r_ = plan["tile"], plan["win"], plan["rows"]
    oh, ow = plan["out"]
    vec = w % 4 == 0
    src = bgr.astype(np.int32)
    out = np.full((b, 3, oh, ow), -1, np.int32)
    for by, y0 in enumerate(plan["y0"]):
        for bx, x0 in enumerate(plan["x0"]):
            ox0, oy0 = bx * tw_, by * th_
            tw, th = min(tw_, ow - ox0), min(th_, oh - oy0)
            wh = min(wh_, h - y0)
            xb = x0 & ~3 if vec else x0
            wc = min(ww_ + x0 - xb, w - xb)
            n = -(-wc // 4) * 4 if vec else wc          # step 1
            assert xb + n <= w and n <= (ww_ + 6) & ~3
            win = _ycc_word(*(src[:, k, y0:y0 + wh, xb:xb + n]
                              for k in range(3)))
            hs = np.full((b, 3, wh_, tw_), np.nan, np.float32)   # step 2
            c = np.arange(tw)
            cx = xi[ox0 + c] - xb
            k = xic[ox0 + c].astype(np.int64)
            k01 = ((k[:, 0] & 0xffff) | (k[:, 1] << 16)).astype(np.uint32)
            k23 = ((k[:, 2] & 0xffff) | (k[:, 3] << 16)).astype(np.uint32)
            wk = [win[:, :, cx[:, j]] for j in range(4)]
            p01, p23 = (_byte_perm(wk[0], wk[1], 0x5140),
                        _byte_perm(wk[2], wk[3], 0x5140))
            q01, q23 = (_byte_perm(wk[0], wk[1], 0x0062),
                        _byte_perm(wk[2], wk[3], 0x6200))
            sums = (_dp2a(k01, p01, _dp2a(k23, p23, 0, False), False),
                    _dp2a(k01, p01, _dp2a(k23, p23, 0, True), True),
                    _dp2a(k01, q01, _dp2a(k23, q23, 0, True), False))
            for ch, s in enumerate(sums):
                assert np.abs(s).max() < 1 << 24      # exact in float32
                hs[:, ch, :wh, :tw] = s.astype(np.float32)
            # step 3: lane l owns columns 4l..4l+3 (the last lane with
            # columns may be ragged), warp v rows v*R .. v*R+R-1; columns
            # past the tile's edge read sums step 2 never wrote (NaN here)
            # and are not stored
            lanes = np.arange(0, tw, PRE_COLS)
            cols = lanes[:, None] + np.arange(PRE_COLS)[None, :]
            keep = cols < tw
            colsc = np.minimum(cols, tw_ - 1)
            for rb in range(0, th, r_):
                for r in range(rb, min(rb + r_, th)):
                    oy = oy0 + r
                    taps = [hs[:, :, int(t) - y0, :][..., colsc]
                            for t in yi[oy]]
                    f = yfc[oy]
                    v = taps[3] * f[3]
                    for j in (2, 1, 0):
                        v = (taps[j] * f[j]).astype(np.float32) + v
                    u = _round_u8(v.astype(np.float32))
                    word = _byte_perm(_byte_perm(u[..., 0], u[..., 1], 0x0040),
                                      _byte_perm(u[..., 2], u[..., 3], 0x0040),
                                      0x5410)
                    for j in range(PRE_COLS):
                        val = (word >> np.uint32(8 * j)) & np.uint32(255)
                        cs = cols[:, j][keep[:, j]]
                        out[:, :, oy, ox0 + cs] = val[..., keep[:, j]]
    assert out.min() >= 0, "an output pixel was never written"
    return out.astype(np.uint8)


@pytest.mark.parametrize("hw,s", [((72, 80), 2.0), ((90, 100), 0.75),
                                  ((70, 90), 1.2), ((40, 50), 2.75),
                                  ((400, 300), 0.1),
                                  ((60, 100), 1.5),     # ow % 4 == 2
                                  ((101, 77), 2.75),    # odd W, ow % 4 == 3
                                  ((300, 200), 0.2)])   # R = 1: no reuse
def test_pre_pass_window_emulation_is_bit_exact(hw, s):
    # several tiles on at least one axis; at x0.75 the plan halves R to
    # fit its shared memory, and at x0.2 and x0.1 the window's row span
    # forces R = 1
    from srcnn_cpp_tpu_torch.ops.cuda_resize import (PRE_COLS, PRE_ROWS,
                                                     pre_pass_plan,
                                                     pre_upscale_plain)
    from srcnn_cpp_tpu_torch.ops.resize import scaled_size

    h, w = hw
    ow, oh = scaled_size(w, h, s)
    bgr = _u8((2, 3, h, w), h * w)
    plan = pre_pass_plan(oh, ow, h, w)
    assert min(plan["grid"]) >= 1 and max(plan["grid"]) >= 2
    if s <= 0.25:
        assert plan["rows"] == 1
    elif s < 1:
        assert 1 <= plan["rows"] < PRE_ROWS
    else:
        assert plan["rows"] == PRE_ROWS
    if hw in ((60, 100), (101, 77)):
        assert ow % PRE_COLS != 0
    got = _emulate_pre_pass(bgr, oh, ow, plan)
    ref = pre_upscale_plain(torch.from_numpy(bgr), (oh, ow)).numpy()
    assert np.array_equal(got, ref)


def test_pre_pass_window_emulation_of_a_pre_window():
    # a PreWindow plan: output rows 10..100 and columns 30..150 of the x2
    # resize of 72x80, read from the input block its taps reach (origin
    # (3, 13), an unaligned column); equal to the slice of the whole
    from srcnn_cpp_tpu_torch.ops.cuda_resize import (PreWindow, pre_pass_plan,
                                                     pre_upscale_plain,
                                                     window_source)

    (s0, s1), (t0, t1) = window_source((144, 160), (72, 80), (10, 100),
                                       (30, 150))
    assert t0 % 4 != 0
    bgr = _u8((2, 3, 72, 80), 7)
    block = np.ascontiguousarray(bgr[:, :, s0:s1, t0:t1])
    win = PreWindow((72, 80), (10, 100), (30, 150), (s0, t0))
    plan = pre_pass_plan(144, 160, *block.shape[2:], win)
    assert plan["out"] == (90, 120)
    got = _emulate_pre_pass(block, 144, 160, plan, win)
    ref = pre_upscale_plain(torch.from_numpy(bgr), (144, 160)).numpy()
    assert np.array_equal(got, ref[:, :, 10:100, 30:150])


def test_pre_pass_rounding_form_is_rint_then_clip():
    # clamp in float, add 1.5 * 2**23, low byte == clip(rint(v), 0, 255)
    # over float32 values in [-2**24, 2**24] and every exact .5 in [-1, 256]
    rng = np.random.default_rng(0)
    dense = np.concatenate([
        rng.uniform(-2.0 ** 24, 2.0 ** 24, 1 << 20),
        rng.uniform(-2.0, 258.0, 1 << 20),
        np.arange(-2 ** 12, 2 ** 12, 1 / 64),
        np.arange(-1, 256.5, 0.5),
        [-2.0 ** 24, 2.0 ** 24, -0.0, 0.0, 254.5, 255.5, 255.49998, -0.5]])
    v = dense.astype(np.float32)
    v = np.concatenate([v, np.nextafter(v, np.float32(np.inf)),
                        np.nextafter(v, np.float32(-np.inf))])
    want = np.clip(np.rint(v), 0, 255).astype(np.uint32)
    assert np.array_equal(_round_u8(v), want)


def test_pre_pass_plan_mirrors_the_cuda_source():
    from srcnn_cpp_tpu_torch.ops.cuda_resize import (PRE_COLS, PRE_ROWS,
                                                     PRE_SMEM_BUDGET, PRE_TW,
                                                     PRE_WARPS,
                                                     pre_pass_smem_bytes)

    src = (REPO / "srcnn_cpp_tpu_torch/csrc/pre_pass.cu").read_text()
    const = {k: int(re.search(rf"\b{k} = (\d+)", src).group(1))
             for k in ("WARPS", "CPT")}
    assert (const["WARPS"], const["CPT"]) == (PRE_WARPS, PRE_COLS)
    assert "TW_MAX = 32 * CPT" in src and PRE_TW == 32 * PRE_COLS
    # a tile's rows are staged one a thread: the launcher refuses a tile
    # taller than a block, and no plan asks for one
    assert "TH > THREADS" in src and "THREADS = 32 * WARPS" in src
    assert PRE_WARPS * PRE_ROWS <= 32 * PRE_WARPS
    assert PRE_SMEM_BUDGET <= int(re.search(
        r"SMEM_MAX = (\d+) \* 1024", src).group(1)) * 1024
    # the launcher refuses any other shared-memory size than the plan's
    assert "3 * WH * TW * 4 + WH * ((WW + 6) & ~3) * 4 + 2 * TH * 32" in src
    assert pre_pass_smem_bytes((64, 128), (36, 68)) == \
        3 * 36 * 128 * 4 + 36 * 72 * 4 + 2 * 64 * 32


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
