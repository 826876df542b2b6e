"""PyTorch port, the evaluation harness and what it needs.

``resize_separable`` (plain PyTorch, all six filters, up and down) is held
bit-equal to a NumPy float32 replay of the same tap loop (separately
rounded products and sums in tap order), and to <=1 LSB after rounding
against the JAX package's engine, which XLA:CPU may compute with
contracted FMAs.  The NumPy copies (the filter tables, ``utils/metrics``,
``decode_provenance``) equal their originals exactly.  ``degrade_bgr`` is
<=1 LSB from the JAX package's; ``evaluate_image`` on the CPU agrees with
the JAX package's ``evaluate_image(kernel="xla")`` to 0.01 dB PSNR and
1e-4 SSIM (the conv's <=1-LSB band).
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

FILTERS = ("box", "bilinear", "mitchell", "catmull_rom", "cubic_matlab",
           "lanczos3")
# down by 1/2 and 1/3, up by ~1.5 and 2 (both pass orders)
GEOMS = [((40, 56), (20, 28)), ((39, 60), (13, 20)), ((17, 23), (26, 35)),
         ((12, 20), (24, 40))]


def _replay(x, out_hw, method):
    """NumPy float32 replay of the tap loop of resize_separable."""
    from srcnn_cpp_tpu_torch.ops.resize import weights_table

    def axis(x, idx, w, ax):
        acc = None
        for t in range(idx.shape[1]):
            shape = [1] * x.ndim
            shape[ax] = w.shape[0]
            term = np.take(x, idx[:, t], axis=ax) * w[:, t].reshape(shape)
            acc = term if acc is None else (acc + term).astype(np.float32)
        return acc

    (ih, iw), (oh, ow) = x.shape[-2:], out_hw
    yi, yw = weights_table(oh, ih, method)
    xi, xw = weights_table(ow, iw, method)
    if ow <= iw:
        return axis(axis(x, xi, xw, x.ndim - 1), yi, yw, x.ndim - 2)
    return axis(axis(x, yi, yw, x.ndim - 2), xi, xw, x.ndim - 1)


@pytest.mark.parametrize("method", FILTERS)
def test_resize_separable_matches_replay_and_jax(method):
    from srcnn_cpp_tpu.ops.resize import resize_separable as jax_resize
    from srcnn_cpp_tpu_torch.ops.resize import resize_separable

    rng = np.random.default_rng(FILTERS.index(method))
    for (ih, iw), out_hw in GEOMS:
        x = rng.uniform(0, 255, (3, ih, iw)).astype(np.float32)
        got = resize_separable(torch.from_numpy(x), out_hw, method).numpy()
        assert got.shape == (3, *out_hw) and got.dtype == np.float32
        assert np.array_equal(got, _replay(x, out_hw, method))
        ref = np.asarray(jax_resize(x, out_hw, method))
        assert np.abs(np.round(got) - np.round(ref)).max() <= 1


# --- copies of framework-free helpers -----------------------------------------

def test_filter_tables_copy_equals_original():
    import srcnn_cpp_tpu.ops.resize as orig
    import srcnn_cpp_tpu_torch.ops.resize as copy

    assert list(copy.FILTERS) == list(orig.FILTERS)
    xs = np.linspace(-4, 4, 801)
    for name, (fn, support) in copy.FILTERS.items():
        ofn, osupport = orig.FILTERS[name]
        assert support == osupport and np.array_equal(fn(xs), ofn(xs))
        for dst, src in [(20, 40), (13, 39), (26, 17), (1, 5), (96, 96)]:
            for a, b in zip(copy.weights_table(dst, src, name),
                            orig._weights_table(dst, src, name)):
                assert a.dtype == b.dtype and np.array_equal(a, b)


def test_metrics_copy_equals_original():
    from srcnn_cpp_tpu.utils import metrics as orig
    from srcnn_cpp_tpu_torch.utils import metrics as copy

    rng = np.random.default_rng(2)
    a = rng.uniform(0, 255, (31, 27))
    b = np.clip(a + rng.normal(0, 5, a.shape), 0, 255)
    assert copy.psnr(a, b) == orig.psnr(a, b)
    assert copy.psnr(a, a) == orig.psnr(a, a) == float("inf")
    assert copy.ssim(a, b) == orig.ssim(a, b)
    assert copy.psnr(a, b, peak=1.0) == orig.psnr(a, b, peak=1.0)


def test_decode_provenance_copy_equals_original():
    from srcnn_cpp_tpu.evaluate import EVAL_DECODE_PROVENANCE as orig_pin
    from srcnn_cpp_tpu.imageio import decode_provenance as orig
    from srcnn_cpp_tpu_torch.evaluate import EVAL_DECODE_PROVENANCE
    from srcnn_cpp_tpu_torch.imageio import decode_provenance

    assert decode_provenance() == orig()
    assert EVAL_DECODE_PROVENANCE == orig_pin


# --- the harness ---------------------------------------------------------------

def _smooth(h, w):
    x = np.indices((h, w)).sum(0)
    return np.stack([x % 256, (x * 3) % 256, (x * 7) % 256],
                    -1).astype(np.uint8)


@pytest.mark.parametrize("scale", [1.5, 2.0, 3.0])
def test_degrade_bgr_matches_jax(scale):
    from srcnn_cpp_tpu.evaluate import degrade_bgr as jax_degrade
    from srcnn_cpp_tpu_torch.evaluate import degrade_bgr

    img = np.random.default_rng(int(scale * 10)).integers(
        0, 256, (37, 44, 3), dtype=np.uint8)
    lr, gt = degrade_bgr(img, scale)
    jlr, jgt = jax_degrade(img, scale)
    assert np.array_equal(gt, jgt) and lr.shape == jlr.shape
    assert lr.dtype == np.uint8
    assert np.abs(lr.astype(int) - np.asarray(jlr).astype(int)).max() <= 1


def test_evaluate_image_matches_jax(weights):
    from srcnn_cpp_tpu.evaluate import evaluate_image as jax_eval
    from srcnn_cpp_tpu_torch.evaluate import evaluate_image
    from srcnn_cpp_tpu_torch.weights import from_jax_params

    img = _smooth(64, 64)
    got = evaluate_image(img, 2.0, from_jax_params(weights), device="cpu")
    ref = jax_eval(img, 2.0, weights, kernel="xla")
    assert set(got) == set(ref)
    for k in ("psnr_bicubic", "psnr_srcnn"):
        assert abs(got[k] - ref[k]) <= 0.01, (k, got[k], ref[k])
    for k in ("ssim_bicubic", "ssim_srcnn"):
        assert abs(got[k] - ref[k]) <= 1e-4, (k, got[k], ref[k])


def test_evaluate_cli_json_on_cpu(tmp_path):
    from srcnn_cpp_tpu_torch.evaluate import main
    from srcnn_cpp_tpu_torch.imageio import imwrite_bgr

    img = np.random.default_rng(0).integers(0, 256, (40, 40, 3),
                                            dtype=np.uint8)
    assert imwrite_bgr(tmp_path / "t.png", img)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["--scale=2", "--json", "--device=cpu", str(tmp_path)])
    assert rc == 0
    data = json.loads(buf.getvalue())
    assert data["images"][0]["image"] == "t.png"
    assert data["device"] == "cpu" and data["scale"] == 2.0
    assert np.isfinite(data["mean"]["psnr_srcnn"])


def test_evaluate_cli_device_flag(tmp_path, monkeypatch, capsys):
    from srcnn_cpp_tpu_torch.evaluate import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main([str(tmp_path)]) == 1                 # default cuda, no GPU
    assert "no CUDA device" in capsys.readouterr().err
    assert main(["--device=cpu", str(tmp_path)]) == 1   # no images
    assert "no images" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        main(["--device=tpu", str(tmp_path)])
