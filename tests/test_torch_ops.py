"""PyTorch port, plain ops: held against the JAX package and its oracle.

Inputs come from ``np.random.default_rng`` and go to both packages as numpy
arrays.  Tolerances: color, quantization and resize against the NumPy
engines are bit-exact; resize against the JAX (XLA:CPU) engine allows <=1
LSB on < 1e-4 of pixels, because XLA:CPU may contract the vertical pass's
mul+add into an FMA (srcnn_cpp_tpu/ops/pallas_resize.py:28-37) while eager
PyTorch never does; the fp32 conv stack is <=1 LSB against both the XLA
path and the oracle.
"""

import numpy as np
import pytest
import torch

from tests.conftest import GOLDEN

REPO = GOLDEN.parent.parent


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --- color: the full u8 cube, in four blue quarters -------------------------

def _cube_quarter(q):
    b, g, r = np.meshgrid(np.arange(64 * q, 64 * q + 64), np.arange(256),
                          np.arange(256), indexing="ij")
    return np.stack([b, g, r]).reshape(3, 64 * 256, 256).astype(np.uint8)


@pytest.mark.parametrize("q", range(4))
def test_bgr2ycrcb_full_cube(q):
    from srcnn_cpp_tpu.oracle import bgr2ycrcb_u8_ref
    from srcnn_cpp_tpu.ops.color import bgr2ycrcb_u8_planar as jax_fwd
    from srcnn_cpp_tpu_torch.ops.color import bgr2ycrcb_u8_planar

    x = _cube_quarter(q)
    got = bgr2ycrcb_u8_planar(_t(x)).numpy()
    assert np.array_equal(got, np.asarray(jax_fwd(x)))
    ref = np.moveaxis(bgr2ycrcb_u8_ref(np.moveaxis(x, 0, -1)), -1, 0)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("q", range(4))
def test_ycrcb2bgr_full_cube(q):
    from srcnn_cpp_tpu.oracle import ycrcb2bgr_u8_ref
    from srcnn_cpp_tpu.ops.color import ycrcb2bgr_u8_planar as jax_inv
    from srcnn_cpp_tpu_torch.ops.color import ycrcb2bgr_u8_planar

    x = _cube_quarter(q)
    got = ycrcb2bgr_u8_planar(_t(x)).numpy()
    assert np.array_equal(got, np.asarray(jax_inv(x)))
    ref = np.moveaxis(ycrcb2bgr_u8_ref(np.moveaxis(x, 0, -1)), -1, 0)
    assert np.array_equal(got, ref)


def test_color_batched_planar():
    from srcnn_cpp_tpu.ops.color import bgr2ycrcb_u8_planar as jax_fwd
    from srcnn_cpp_tpu_torch.ops.color import bgr2ycrcb_u8_planar

    x = np.random.default_rng(11).integers(0, 256, (2, 3, 37, 53),
                                           dtype=np.uint8)
    assert np.array_equal(bgr2ycrcb_u8_planar(_t(x)).numpy(),
                          np.asarray(jax_fwd(x)))


@pytest.mark.parametrize("fwd", [True, False])
def test_color_interleaved_matches_jax_and_planar(fwd):
    # channels-last [..., 3]: bit-equal to JAX's pair and to the port's
    # planar pair on the same pixels
    import srcnn_cpp_tpu.ops.color as jax_color
    import srcnn_cpp_tpu_torch.ops.color as color

    name = "bgr2ycrcb_u8" if fwd else "ycrcb2bgr_u8"
    x = np.random.default_rng(12 + fwd).integers(0, 256, (4, 17, 23, 3),
                                                 dtype=np.uint8)
    got = getattr(color, name)(_t(x))
    assert got.dtype == torch.uint8 and got.shape == x.shape
    assert np.array_equal(got.numpy(), np.asarray(getattr(jax_color, name)(x)))
    planar = getattr(color, name + "_planar")(_t(x).permute(0, 3, 1, 2))
    assert torch.equal(got, planar.permute(0, 2, 3, 1))


def test_quantize_trunc_matches_jax():
    from srcnn_cpp_tpu.ops.quantize import quantize_trunc_u8 as jax_q
    from srcnn_cpp_tpu_torch.ops.quantize import quantize_trunc_u8

    x = np.random.default_rng(5).uniform(-300, 600, 10_000).astype(np.float32)
    x[:6] = [-0.99, -0.0, 0.99, 254.999, 255.0, 255.5]
    assert np.array_equal(quantize_trunc_u8(_t(x)).numpy(),
                          np.asarray(jax_q(x)))


# --- resize --------------------------------------------------------------------

# the geometries of tests/test_pallas_resize.py:31-37, plus x1.2 and x2.75
GEOMS = [
    (64, 96, 2), (32, 160, 2), (40, 128, 3), (24, 96, 4),
    (64, 96, 1.5), (54, 172, 1.5), (92, 250, 1.5),
    (64, 256, 0.5), (126, 300, 0.5),
    (64, 128, 1.25), (48, 160, 1.75), (40, 128, 2.5),
    (64, 192, 0.75), (63, 384, 1 / 3), (48, 512, 0.25),
    (64, 128, 1.2), (33, 51, 2.75),
]


@pytest.mark.parametrize("ih,iw,s", GEOMS)
def test_resize_matches_numpy_and_jax(ih, iw, s):
    from srcnn_cpp_tpu.ops.resize import resize_bicubic_u8 as jax_resize
    from srcnn_cpp_tpu.ops.resize_tables import resize_bicubic_u8_np
    from srcnn_cpp_tpu_torch.ops.resize import resize_bicubic_u8, scaled_size

    rng = np.random.default_rng(int(ih * 7 + iw + 100 * s))
    x = rng.integers(0, 256, (3, ih, iw), dtype=np.uint8)
    ow, oh = scaled_size(iw, ih, s)
    got = resize_bicubic_u8(_t(x), (oh, ow)).numpy()
    assert got.shape == (3, oh, ow)
    for c in range(3):   # bit-exact vs the NumPy engine
        assert np.array_equal(got[c], resize_bicubic_u8_np(x[c], (oh, ow)))
    d = np.abs(got.astype(int) - np.asarray(jax_resize(x, (oh, ow))).astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-4, (d.max(), (d > 0).mean())


def test_resize_golden_cv46():
    from srcnn_cpp_tpu_torch.ops.resize import resize_bicubic_u8

    with np.load(GOLDEN / "cv46_cubic_resize.npz") as z:
        cases = [(z[f"in_{i}"], z[f"out_{i}"]) for i in range(len(z.files) // 2)]
    for src, ref in cases:
        got = resize_bicubic_u8(_t(src), ref.shape).numpy()
        assert np.array_equal(got, ref), (src.shape, ref.shape)


def test_scaled_size_matches_jax():
    from srcnn_cpp_tpu.ops.resize import scaled_size as jax_size
    from srcnn_cpp_tpu_torch.ops.resize import scaled_size

    for w, h, s in [(53, 37, 1.5), (960, 540, 2.0), (384, 384, 0.75),
                    (517, 333, 2.75), (7, 5, 1.2), (1, 1, 0.3)]:
        assert scaled_size(w, h, s) == jax_size(w, h, s)


# --- copies of framework-free helpers -----------------------------------------

def test_resize_tables_copy_equals_original():
    import srcnn_cpp_tpu.ops.resize_tables as orig
    import srcnn_cpp_tpu_torch.ops.resize_tables as copy

    fr = np.random.default_rng(0).uniform(0, 1, 257).astype(np.float32)
    assert np.array_equal(copy.catmull_rom_f32(fr), orig.catmull_rom_f32(fr))
    for dst, src in [(144, 96), (103, 69), (31, 64), (1421, 517), (5, 7),
                     (1, 1), (3840, 1920), (1620, 540)]:
        for a, b in zip(copy.cv_cubic_taps_unclamped(dst, src),
                        orig.cv_cubic_taps_unclamped(dst, src)):
            assert np.array_equal(a, b)
        for a, b in zip(copy.cv_cubic_tables(dst, src),
                        orig.cv_cubic_tables(dst, src)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    x = np.random.default_rng(1).integers(0, 256, (29, 41), dtype=np.uint8)
    assert np.array_equal(copy.resize_bicubic_u8_np(x, (61, 47)),
                          orig.resize_bicubic_u8_np(x, (61, 47)))


def test_exit_codes_copy_equals_original():
    from srcnn_cpp_tpu.utils.debug import EXIT_CODES as orig
    from srcnn_cpp_tpu_torch.utils.debug import EXIT_CODES

    assert EXIT_CODES == orig


def test_conv_image_copy_equals_original():
    from srcnn_cpp_tpu.imageio import conv_image as orig
    from srcnn_cpp_tpu_torch.imageio import conv_image

    rng = np.random.default_rng(3)
    h, w = 5, 7
    for d in (1, 2, 3, 4):
        n = h * w * (2 if d == 2 else d)
        buf = rng.integers(0, 256, n, dtype=np.uint8)
        assert np.array_equal(conv_image(buf, w, h, d), orig(buf, w, h, d))
    with pytest.raises(ValueError):
        conv_image(buf, w, h, 5)


def test_sniff_format_copy_equals_original(tmp_path):
    from srcnn_cpp_tpu.imageio import sniff_format as orig
    from srcnn_cpp_tpu_torch.imageio import imwrite_bgr, sniff_format

    img = np.random.default_rng(13).integers(0, 256, (9, 11, 3),
                                             dtype=np.uint8)
    for name in ("a.png", "a.jpg", "a.bmp"):
        assert imwrite_bgr(tmp_path / name, img)
    (tmp_path / "a.txt").write_bytes(b"not an image")
    (tmp_path / "empty").write_bytes(b"")
    want = {"a.png": "png", "a.jpg": "jpeg", "a.bmp": "bmp", "a.txt": None,
            "empty": None, "missing": None}
    for name, fmt in want.items():
        assert sniff_format(tmp_path / name) == orig(tmp_path / name) == fmt
    real = REPO / "tests/data/eval/butterfly.png"
    assert sniff_format(real) == orig(real) == "png"


def test_timer_copy_matches_original_and_syncs():
    from srcnn_cpp_tpu.utils.timer import TickTimer as Orig
    from srcnn_cpp_tpu_torch.utils.timer import TickTimer, tick_ms

    calls = []
    with TickTimer() as a, Orig() as b:
        pass
    assert a.ms >= 0.0 and b.ms >= 0.0 and tick_ms() >= 0
    with TickTimer(sync=lambda: calls.append(1)) as t:
        pass
    assert calls == [1, 1] and t.ms >= 0.0


# --- the plain conv stack -------------------------------------------------------

@pytest.mark.parametrize("shape,seed", [((40, 52), 0), ((2, 17, 33), 1),
                                        ((1, 1), 2), ((5, 3), 3)])
def test_srcnn_plain_matches_jax_and_oracle(weights, shape, seed):
    from srcnn_cpp_tpu.oracle import srcnn_y_ref
    from srcnn_cpp_tpu.ops.srcnn import srcnn_y as jax_srcnn
    from srcnn_cpp_tpu_torch.ops.srcnn import srcnn_y
    from srcnn_cpp_tpu_torch.weights import from_jax_params

    y = np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)
    got = srcnn_y(_t(y), from_jax_params(weights)).numpy().astype(int)
    assert got.shape == shape
    d = np.abs(got - np.asarray(jax_srcnn(y, weights)).astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 5e-3
    planes = y.reshape((-1,) + shape[-2:])
    ref = np.stack([srcnn_y_ref(p, weights) for p in planes]).reshape(shape)
    assert np.abs(got - ref.astype(int)).max() <= 1
