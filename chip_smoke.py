#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``srcnn_cpp_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the five CUDA kernels of the port from ``srcnn_cpp_tpu_torch/csrc``
(one nvcc per source, sm_90a), holds each against its plain PyTorch version
on the card, and drives each path through the entry points a user calls,
with the launch counts set to 0 just before and read just after:

* phases 2-6, the main path: ``upscale_bgr_batch`` on 4 seeded 540x960
  frames at x2 (K2 pre-pass -> K1 conv -> K3 merge), checked against the
  plain pipeline on the card and the reference binary's goldens, and timed;
* phase 7, K4 ``srcnn_merge_fused`` (conv + merge in one kernel) on the
  main path's upscaled YCrCb batch: bit-equal to K1 -> K3;
* phase 8, K5 ``srcnn_y_f32_fused`` (f32-output conv) on a 2160x3840
  plane: quantized, bit-equal to K1;
* phase 9, the evaluation harness on ``tests/data/eval``: against the
  port's CPU run and ``EVAL.md``'s butterfly rows;
* phase 10, the stream: ``StreamUpscaler`` at 1920x1080 x2, bit-equal to
  ``upscale_bgr_batch`` and in order; its two rate modes;
* phase 11, the ``single_8k`` configuration: 3840x2160 -> 7680x4320;
* phase 12, timings of K4 and K5 with CUDA events.

Any failure raises and the exit code is non-zero.  The last line of
standard output is a JSON object ``{"ok": true, "device": {...}}``; the
line before it lists the kernels.

Needs one CUDA card; exits non-zero without a result when there is none.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
# x2 main-path geometry: 4 frames of 540x960 -> 1080x1920
BATCH, IH, IW, SCALE = 4, 540, 960, 2.0
OH, OW = 2 * IH, 2 * IW
K1_FRAC = 5e-3        # K1 vs fp32 F.conv2d: <=1 LSB on < 0.5% of pixels
E2E_FRAC = 1e-5       # e2e: <=2 LSB, (diff > 1) on < 1e-5 of values
K5_ATOL = 1e-2        # K5 vs fp32 F.conv2d before quantization
EVAL_DB = 0.01        # eval: card vs CPU run and vs EVAL.md, PSNR in dB
EVAL_SSIM = 1e-4      # eval: SSIM against EVAL.md's 4-decimal rows
# EVAL.md, "Bicubic-vs-SRCNN protocol results": butterfly.png, scale ->
# (bicubic PSNR, bicubic SSIM, SRCNN PSNR, SRCNN SSIM)
EVAL_BUTTERFLY = {1.5: (39.80, 0.9915, 28.25, 0.9367),
                  2.0: (31.98, 0.9583, 32.51, 0.9627),
                  3.0: (26.38, 0.8628, 26.91, 0.8727)}


def say(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    """``name, power.limit`` of card 0, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def u8(shape, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, shape, dtype=torch.uint8, generator=g).cuda()


def diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    torch.cuda.synchronize()
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
    return (a.to(torch.int32) - b.to(torch.int32)).abs()


def assert_equal(a, b, what: str) -> None:
    d = diff(a, b)
    if int(d.max()) != 0:
        raise AssertionError(f"{what}: {int((d > 0).sum())} values differ, "
                             f"max {int(d.max())}")
    say(f"  {what}: bit-equal")


def median_ms(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after a warm-up."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def ab_ms(kernel, plain, reps: int) -> tuple[float, float]:
    """Kernel and plain medians, timed in turns (plain, kernel, kernel, plain)."""
    p = [median_ms(plain, reps)]
    k = [median_ms(kernel, reps), median_ms(kernel, reps)]
    p.append(median_ms(plain, reps))
    return statistics.median(k), statistics.median(p)


def main() -> int:
    # phase 0: the card
    say(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    gpu = card()
    say(f"card: {gpu}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from srcnn_cpp_tpu_torch import runtime
    from srcnn_cpp_tpu_torch.ops.cuda_merge import (merge_plain,
                                                    merge_ycrcb_to_bgr_fused)
    from srcnn_cpp_tpu_torch.ops.cuda_resize import (pre_upscale_fused,
                                                     pre_upscale_plain)
    from srcnn_cpp_tpu_torch.ops.cuda_srcnn import srcnn_y_fused, srcnn_y_plain
    from srcnn_cpp_tpu_torch.ops.resize import scaled_size
    from srcnn_cpp_tpu_torch.pipeline import upscale_bgr_batch, upscale_planar
    from srcnn_cpp_tpu_torch.weights import load_weights

    # phase 1: build and load
    path, secs, log = runtime.build()
    say(f"phase 1: built {path.relative_to(ROOT)} in {secs:.1f} s, one nvcc "
        f"per source ({', '.join(p.name for p in runtime.sources())}) with: "
        + " ".join(runtime.compile_command(Path("x.cu"), Path("x.o"))[1:8]))
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line \
                or line.startswith("=="):
            say(f"  ptxas: {line.strip()}")
    runtime.library()
    weights = load_weights(device="cuda")
    max_err = {}

    # phase 2: K3 merge vs plain, bit-equal
    say("phase 2: K3 merge_ycrcb_to_bgr_fused vs merge_plain")
    for i, (b, h, w) in enumerate([(2, 1080, 1920), (2, 537, 1111),
                                   (1, 12, 128)]):
        y, up = u8((b, h, w), 10 + i), u8((b, 3, h, w), 20 + i)
        assert_equal(merge_ycrcb_to_bgr_fused(y, up), merge_plain(y, up),
                     f"[{b},3,{h},{w}]")
    y = torch.arange(256, dtype=torch.uint8).repeat(1, 8, 1).cuda()
    for cr, cb in [(0, 0), (255, 255), (0, 255), (255, 0), (128, 128)]:
        up = torch.empty((1, 3, 8, 256), dtype=torch.uint8, device="cuda")
        up[:, 0], up[:, 1], up[:, 2] = 0, cr, cb
        assert_equal(merge_ycrcb_to_bgr_fused(y, up), merge_plain(y, up),
                     f"clip boundary cr={cr} cb={cb}")
    max_err["merge_ycrcb_to_bgr_fused"] = 0

    # phase 3: K2 pre-pass vs plain, bit-equal at every scale
    say("phase 3: K2 pre_upscale_fused vs pre_upscale_plain")
    cases = [((2, 3, IH, IW), s) for s in (2.0, 1.5, 3.0, 1.25, 0.75, 1.2)]
    cases.append(((1, 3, 333, 517), 2.75))
    for i, (shape, s) in enumerate(cases):
        x = u8(shape, 30 + i)
        ow, oh = scaled_size(shape[3], shape[2], s)
        assert_equal(pre_upscale_fused(x, (oh, ow)),
                     pre_upscale_plain(x, (oh, ow)),
                     f"{list(shape)} x{s} -> {oh}x{ow}")
    # gray BGR carries Y unchanged through the color transform, so the
    # Y plane of the butterfly x1.5 golden (reference binary) is K2's Y
    y384 = np.load(ROOT / "tests/golden/butterfly_y384.npy")
    yup = np.load(ROOT / "tests/golden/butterfly_yup576.npy")
    gray = torch.from_numpy(np.ascontiguousarray(
        np.broadcast_to(y384, (1, 3) + y384.shape))).cuda()
    assert_equal(pre_upscale_fused(gray, yup.shape)[:, 0],
                 torch.from_numpy(yup)[None].cuda(),
                 "butterfly Y x1.5 vs reference-binary golden")
    max_err["pre_upscale_fused"] = 0

    # phase 4: K1 conv vs the fp32 F.conv2d path
    say("phase 4: K1 srcnn_y_fused vs srcnn_y_plain (TF32 off)")
    k1_err = 0
    for y in [u8((2, OH, OW), 40), u8((1, 1), 41), u8((3, 7), 42),
              u8((17, 130), 43), border_batch()]:
        k1_err = max(k1_err, lsb_close(srcnn_y_fused(y, weights),
                                       srcnn_y_plain(y, weights),
                                       f"K1 {list(y.shape)}"))
    strided = u8((2, 3, 64, 96), 44)
    assert_equal(srcnn_y_fused(strided[:, 0], weights),
                 srcnn_y_fused(strided[:, 0].contiguous(), weights),
                 "strided frames (up[:, 0] view) vs contiguous")
    max_err["srcnn_y_fused"] = k1_err

    # phase 5: the main path, end to end
    say(f"phase 5: upscale_bgr_batch {BATCH}x{IH}x{IW} x{SCALE:g} on the card")
    rng = np.random.default_rng(SEED)
    frames = rng.integers(0, 256, (BATCH, IH, IW, 3), dtype=np.uint8)
    wrappers = (pre_upscale_fused, srcnn_y_fused, merge_ycrcb_to_bgr_fused)
    plains = (pre_upscale_plain, srcnn_y_plain, merge_plain)
    for f in wrappers:
        f.launches = 0
    for f in plains:
        f.calls = 0
    out = upscale_bgr_batch(frames, SCALE, weights, device="cuda")
    torch.cuda.synchronize()
    launches = {f.__name__: f.launches for f in wrappers}
    plain_calls = {f.__name__: f.calls for f in plains}
    say(f"  launches {launches}, plain calls {plain_calls}")
    if min(launches.values()) < 1 or max(plain_calls.values()) > 0:
        raise AssertionError("the main path did not run K2 -> K1 -> K3")
    if out.shape != (BATCH, OH, OW, 3) or out.dtype != np.uint8:
        raise AssertionError(f"output {out.shape} {out.dtype}")
    x = torch.from_numpy(np.ascontiguousarray(np.moveaxis(frames, -1, 1)))
    x = x.cuda()
    up = pre_upscale_plain(x, (OH, OW))
    ref = merge_plain(srcnn_y_plain(up[:, 0], weights), up)
    ref = np.moveaxis(ref.cpu().numpy(), 1, -1)
    d = np.abs(out.astype(np.int32) - ref.astype(np.int32))
    say(f"  vs plain pipeline on the card: max {d.max()} LSB, "
        f"(diff>1) {(d > 1).mean():.2e}, (diff>0) {(d > 0).mean():.2e}")
    if d.max() > 2 or (d > 1).mean() >= E2E_FRAC:
        raise AssertionError("end-to-end result differs from the plain path")
    from srcnn_cpp_tpu_torch.imageio import imread_bgr

    bf = imread_bgr(ROOT / "tests/data/eval/butterfly.png")
    if bf is None:
        say("  butterfly golden: not checked (no cv2 or PIL to decode PNG)")
    else:
        for tag in ("2", "1.5"):
            gold = imread_bgr(ROOT / f"tests/golden/butterfly_x{tag}_ref.png")
            got = upscale_bgr_batch(bf[None], float(tag), weights, "cuda")[0]
            d = np.abs(got.astype(np.int32) - gold.astype(np.int32))
            mse = float((d.astype(np.float64) ** 2).mean())
            psnr = 10 * np.log10(255.0 ** 2 / mse) if mse else float("inf")
            say(f"  butterfly x{tag} vs reference-binary golden: max {d.max()} "
                f"LSB, (diff>1) {(d > 1).mean():.2e}, PSNR {psnr:.2f} dB")
            if d.max() > 2 or (d > 1).mean() >= E2E_FRAC or psnr <= 55.0:
                raise AssertionError(f"butterfly x{tag} golden gate failed")

    # phase 6: timings at the x2 geometry (CUDA events, medians)
    say(f"phase 6: timings, [{BATCH},3,{IH},{IW}] -> [{BATCH},3,{OH},{OW}], "
        f"card {gpu}")
    ms, plain_ms = {}, {}
    ms["pre_upscale_fused"], plain_ms["pre_upscale_fused"] = ab_ms(
        lambda: pre_upscale_fused(x, (OH, OW)),
        lambda: pre_upscale_plain(x, (OH, OW)), 20)
    up = pre_upscale_fused(x, (OH, OW))
    ms["srcnn_y_fused"], plain_ms["srcnn_y_fused"] = ab_ms(
        lambda: srcnn_y_fused(up[:, 0], weights),
        lambda: srcnn_y_plain(up[:, 0], weights), 10)
    y_sr = srcnn_y_fused(up[:, 0], weights)
    ms["merge_ycrcb_to_bgr_fused"], plain_ms["merge_ycrcb_to_bgr_fused"] = \
        ab_ms(lambda: merge_ycrcb_to_bgr_fused(y_sr, up),
              lambda: merge_plain(y_sr, up), 20)
    for name in ms:
        say(f"  {name}: {ms[name]:.4f} ms, plain {plain_ms[name]:.4f} ms "
            f"({gpu})")
    mpix = BATCH * OH * OW / 1e6
    dev_ms = median_ms(lambda: upscale_planar(x, weights, (OH, OW)), 10)
    say(f"  e2e device-resident upscale_planar: {dev_ms:.4f} ms, "
        f"{mpix / (dev_ms / 1e3):.2f} MP/s ({gpu})")
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        upscale_bgr_batch(frames, SCALE, weights, device="cuda")
        host.append((time.perf_counter() - t0) * 1e3)
    host_ms = statistics.median(host)
    say(f"  e2e upscale_bgr_batch (host arrays in and out): {host_ms:.4f} ms, "
        f"{mpix / (host_ms / 1e3):.2f} MP/s ({gpu})")

    extra = Extra(gpu, weights, x, up)
    phase_k4(extra, launches, max_err)
    phase_k5(extra, launches, max_err)
    phase_eval(extra)
    phase_stream(extra)
    phase_single_8k(extra)
    phase_timings(extra, ms, plain_ms)

    replaces = {
        "pre_upscale_fused": ("srcnn_cpp_tpu_torch/csrc/pre_pass.cu",
                              "srcnn_cpp_tpu/ops/pallas_resize.py:81"),
        "srcnn_y_fused": ("srcnn_cpp_tpu_torch/csrc/srcnn_conv.cu",
                          "srcnn_cpp_tpu/ops/pallas_srcnn.py:281"),
        "merge_ycrcb_to_bgr_fused": ("srcnn_cpp_tpu_torch/csrc/merge.cu",
                                     "srcnn_cpp_tpu/ops/pallas_merge.py:40"),
        "srcnn_merge_fused": ("srcnn_cpp_tpu_torch/csrc/srcnn_conv.cu",
                              "srcnn_cpp_tpu/ops/pallas_srcnn.py:505"),
        "srcnn_y_f32_fused": ("srcnn_cpp_tpu_torch/csrc/srcnn_conv.cu",
                              "srcnn_cpp_tpu/ops/pallas_srcnn.py:157"),
    }
    kernels = [{"name": n, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[n], "max_abs_err": max_err[n],
                "ms": ms[n], "plain_ms": plain_ms[n]}
               for n, (src, rep) in replaces.items()]
    say(f"card: {gpu}")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


class Extra:
    """What the phases after the main path share: the card's name and
    power limit, the weights on the card, and the main path's planar input
    ``x`` [4,3,540,960] and its upscaled YCrCb ``up`` [4,3,1080,1920]."""

    def __init__(self, gpu, weights, x, up):
        from srcnn_cpp_tpu_torch.ops import (cuda_merge, cuda_resize,
                                             cuda_srcnn)

        self.gpu, self.weights, self.x, self.up = gpu, weights, x, up
        self.wrappers = (cuda_resize.pre_upscale_fused,
                         cuda_srcnn.srcnn_y_fused,
                         cuda_merge.merge_ycrcb_to_bgr_fused,
                         cuda_srcnn.srcnn_merge_fused,
                         cuda_srcnn.srcnn_y_f32_fused)
        self.plains = (cuda_resize.pre_upscale_plain, cuda_srcnn.srcnn_y_plain,
                       cuda_merge.merge_plain, cuda_srcnn.srcnn_merge_plain,
                       cuda_srcnn.srcnn_y_f32_plain)
        self.rng = np.random.default_rng(SEED + 1)
        self.y4k = None

    def drive(self, what: str, fn, needs: tuple[str, ...]):
        """Run ``fn`` with every count set to 0 just before and read just
        after; fail unless each kernel in ``needs`` was launched and no
        plain version was called.  Returns ``(result, launches)``."""
        for f in self.wrappers:
            f.launches = 0
        for f in self.plains:
            f.calls = 0
        result = fn()
        torch.cuda.synchronize()
        launches = {f.__name__: f.launches for f in self.wrappers}
        calls = {f.__name__: f.calls for f in self.plains if f.calls}
        say(f"  {what}: launches {launches}, plain calls {calls or 'none'}")
        if min(launches[n] for n in needs) < 1 or calls:
            raise AssertionError(f"{what} did not run {needs} on the card")
        return result, launches


def lsb_close(a, b, what: str) -> int:
    """<=1 LSB on < K1_FRAC of values (the conv's bar); returns the max."""
    d = diff(a, b)
    mx, frac = int(d.max()), float((d > 0).float().mean())
    say(f"  {what}: max {mx} LSB, differing fraction {frac:.2e}")
    if mx > 1 or frac >= K1_FRAC:
        raise AssertionError(f"{what}: max {mx}, frac {frac}")
    return mx


def border_batch() -> torch.Tensor:
    """The border pattern: saturated frame, gradients, shifted copies."""
    hh, ww = 48, 200
    g = np.meshgrid(np.arange(hh), np.arange(ww), indexing="ij")
    img = ((g[0] * 37 + g[1] * 11) % 256).astype(np.uint8)
    img[:3, :], img[:, :3], img[-3:, :], img[:, -3:] = 255, 0, 255, 0
    return torch.from_numpy(np.stack(
        [img, 255 - img, np.roll(img, 7, axis=1)])).cuda()


def phase_k4(e: Extra, launches: dict, max_err: dict) -> None:
    from srcnn_cpp_tpu_torch.ops.cuda_merge import merge_ycrcb_to_bgr_fused
    from srcnn_cpp_tpu_torch.ops.cuda_srcnn import (srcnn_merge_fused,
                                                    srcnn_merge_plain,
                                                    srcnn_y_fused)

    say("phase 7: K4 srcnn_merge_fused vs K1 -> K3 (bit-equal) and vs "
        "srcnn_merge_plain")
    w = e.weights
    _, got = e.drive(f"srcnn_merge_fused {list(e.up.shape)}",
                     lambda: srcnn_merge_fused(e.up, w), ("srcnn_merge_fused",))
    launches["srcnn_merge_fused"] = got["srcnn_merge_fused"]
    tiny = u8((1, 3, 17, 130), 70)
    bord = u8((3, 3, 48, 200), 71)
    bord[:, 0] = border_batch()
    err = 0
    for up in (e.up, tiny, bord):
        tag = f"[{','.join(map(str, up.shape))}]"
        k4 = srcnn_merge_fused(up, w)
        assert_equal(k4, merge_ycrcb_to_bgr_fused(srcnn_y_fused(up[:, 0], w),
                                                  up), f"{tag} vs K1 -> K3")
        err = max(err, lsb_close(k4, srcnn_merge_plain(up, w),
                                 f"{tag} vs plain"))
    max_err["srcnn_merge_fused"] = err


def phase_k5(e: Extra, launches: dict, max_err: dict) -> None:
    from srcnn_cpp_tpu_torch.ops.cuda_resize import pre_upscale_fused
    from srcnn_cpp_tpu_torch.ops.cuda_srcnn import (srcnn_y_f32_fused,
                                                    srcnn_y_f32_plain,
                                                    srcnn_y_fused)
    from srcnn_cpp_tpu_torch.ops.quantize import quantize_trunc_u8

    say("phase 8: K5 srcnn_y_f32_fused vs K1 (quantized, bit-equal) and vs "
        "srcnn_y_f32_plain")
    w = e.weights
    frame = torch.from_numpy(e.rng.integers(0, 256, (1, 3, 1080, 1920),
                                            dtype=np.uint8)).cuda()
    e.y4k = pre_upscale_fused(frame, (2160, 3840))[0, 0].contiguous()
    _, got = e.drive("srcnn_y_f32_fused [2160,3840]",
                     lambda: srcnn_y_f32_fused(e.y4k, w),
                     ("srcnn_y_f32_fused",))
    launches["srcnn_y_f32_fused"] = got["srcnn_y_f32_fused"]
    err = 0.0
    for i, y in enumerate([e.y4k, u8((1, 1), 72), u8((3, 7), 73),
                           u8((17, 130), 74), border_batch()]):
        tag = f"[{','.join(map(str, y.shape))}]"
        k5 = srcnn_y_f32_fused(y, w)
        assert_equal(quantize_trunc_u8(k5), srcnn_y_fused(y, w),
                     f"{tag} quantized vs K1")
        d = float((k5 - srcnn_y_f32_plain(y, w)).abs().max())
        say(f"  {tag} vs plain: max abs diff {d:.3e}")
        if d > K5_ATOL:
            raise AssertionError(f"K5 {tag}: max abs diff {d} > {K5_ATOL}")
        err = max(err, d)
    max_err["srcnn_y_f32_fused"] = err


def phase_eval(e: Extra) -> None:
    from srcnn_cpp_tpu_torch.evaluate import evaluate_image
    from srcnn_cpp_tpu_torch.imageio import imread_bgr

    say("phase 9: evaluate_image on tests/data/eval, card vs the port's CPU "
        "run and vs EVAL.md")
    runs = [("butterfly.png", s) for s in (1.5, 2.0, 3.0)]
    runs += [(p.name, 2.0) for p in sorted((ROOT / "tests/data/eval")
                                           .glob("*.png"))
             if p.name != "butterfly.png"]
    imgs = {}
    for name, _ in runs:
        imgs[name] = imread_bgr(ROOT / "tests/data/eval" / name)
        if imgs[name] is None:
            raise AssertionError(f"cannot decode {name} (needs cv2 or PIL)")
    card, _ = e.drive(
        f"evaluate_image x{len(runs)}",
        lambda: [evaluate_image(imgs[n], s, e.weights, "cuda")
                 for n, s in runs],
        ("pre_upscale_fused", "srcnn_y_fused", "merge_ycrcb_to_bgr_fused"))
    cpu_w = e.weights.to("cpu")
    for (name, s), m in zip(runs, card):
        c = evaluate_image(imgs[name], s, cpu_w, "cpu")
        d = abs(m["psnr_srcnn"] - c["psnr_srcnn"])
        say(f"  {name} x{s:g}: bicubic {m['psnr_bicubic']:.4f} dB / "
            f"{m['ssim_bicubic']:.5f}, SRCNN {m['psnr_srcnn']:.4f} dB / "
            f"{m['ssim_srcnn']:.5f}; CPU SRCNN {c['psnr_srcnn']:.4f} dB "
            f"(|d| {d:.2e})")
        if d > EVAL_DB or m["psnr_bicubic"] != c["psnr_bicubic"]:
            raise AssertionError(f"eval {name} x{s}: card vs CPU differ")
        if name == "butterfly.png":
            row = EVAL_BUTTERFLY[s]
            got = (m["psnr_bicubic"], m["ssim_bicubic"], m["psnr_srcnn"],
                   m["ssim_srcnn"])
            tol = (EVAL_DB, EVAL_SSIM, EVAL_DB, EVAL_SSIM)
            if any(abs(g - r) > t for g, r, t in zip(got, row, tol)):
                raise AssertionError(f"butterfly x{s}: {got} vs EVAL.md {row}")
    say(f"  butterfly x1.5/x2/x3 match EVAL.md's rows to {EVAL_DB} dB and "
        f"{EVAL_SSIM} SSIM")


def phase_stream(e: Extra) -> None:
    from srcnn_cpp_tpu_torch.pipeline import upscale_bgr_batch
    from srcnn_cpp_tpu_torch.stream import (StreamUpscaler, run_synthetic,
                                            run_synthetic_device)

    say("phase 10: StreamUpscaler 12 x 1080x1920 x2 vs upscale_bgr_batch")
    frames = e.rng.integers(0, 256, (12, 1080, 1920, 3), dtype=np.uint8)
    ref = [upscale_bgr_batch(frames[i:i + 1], 2.0, e.weights, "cuda")[0]
           for i in range(len(frames))]
    # (4, 3): the stated configuration; (5, 1): reuses the pinned ring and
    # ends on a partial micro-batch
    for batch, depth in ((4, 3), (5, 1)):
        def stream():
            up = StreamUpscaler(2.0, e.weights, depth=depth, batch=batch)
            outs = [o for f in frames if (o := up.push(f)) is not None]
            return outs + list(up.drain())

        outs, _ = e.drive(f"stream batch {batch} depth {depth}", stream,
                          ("pre_upscale_fused", "srcnn_y_fused",
                           "merge_ycrcb_to_bgr_fused"))
        if len(outs) != len(ref) or not all(
                np.array_equal(o, r) for o, r in zip(outs, ref)):
            raise AssertionError(f"stream batch {batch}: outputs differ")
        say(f"  batch {batch} depth {depth}: {len(outs)} frames bit-equal, "
            "in order")
    r, _ = e.drive("run_synthetic_device", lambda: run_synthetic_device(
        32, (1080, 1920), 2.0, batch=8, depth=3),
        ("pre_upscale_fused", "srcnn_y_fused", "merge_ycrcb_to_bgr_fused"))
    say(f"  run_synthetic_device 1920x1080 x2, batch 8, depth 3: "
        f"{r['frames']} frames, {r['fps']:.2f} fps, {r['mps']:.2f} MP/s "
        f"({e.gpu})")
    r, _ = e.drive("run_synthetic", lambda: run_synthetic(
        8, (1080, 1920), 2.0, batch=4),
        ("pre_upscale_fused", "srcnn_y_fused", "merge_ycrcb_to_bgr_fused"))
    say(f"  run_synthetic 1920x1080 x2, batch 4, depth 3: {r['frames']} "
        f"frames, {r['fps']:.2f} fps, {r['mps']:.2f} MP/s ({e.gpu})")


def phase_single_8k(e: Extra) -> None:
    from srcnn_cpp_tpu_torch.configs import single_8k
    from srcnn_cpp_tpu_torch.ops.cuda_merge import merge_plain
    from srcnn_cpp_tpu_torch.ops.cuda_resize import pre_upscale_plain
    from srcnn_cpp_tpu_torch.ops.cuda_srcnn import srcnn_y_plain

    say("phase 11: configs.single_8k() 2160x3840 -> 4320x7680 vs the plain "
        "pipeline")
    frame = e.rng.integers(0, 256, (2160, 3840, 3), dtype=np.uint8)
    run = single_8k(e.weights)
    t0 = time.perf_counter()
    out, _ = e.drive("single_8k", lambda: run(frame),
                     ("pre_upscale_fused", "srcnn_y_fused",
                      "merge_ycrcb_to_bgr_fused"))
    secs = time.perf_counter() - t0
    if out.shape != (4320, 7680, 3) or out.dtype != np.uint8:
        raise AssertionError(f"single_8k output {out.shape} {out.dtype}")
    x = torch.from_numpy(np.ascontiguousarray(np.moveaxis(frame, -1, 0)))
    up = pre_upscale_plain(x[None].cuda(), (4320, 7680))
    # the plain conv in row bands: cuDNN asks for a ~99 GiB workspace for
    # conv3 on the whole 33 MP plane.  A band's own rows are exact with a
    # 6-row halo (conv1 radius 4 + conv3 radius 2) cut from the image
    y, h, band, parts = up[:, 0], up.shape[2], 1080, []
    for r0 in range(0, h, band):
        a, b = max(0, r0 - 6), min(h, r0 + band + 6)
        out_b = srcnn_y_plain(y[:, a:b].contiguous(), e.weights)
        parts.append(out_b[:, r0 - a:r0 - a + min(band, h - r0)])
    ref = merge_plain(torch.cat(parts, dim=1), up)
    ref = np.moveaxis(ref[0].cpu().numpy(), 0, -1)
    d = np.abs(out.astype(np.int32) - ref.astype(np.int32))
    say(f"  vs plain pipeline on the card: max {d.max()} LSB, (diff>1) "
        f"{(d > 1).mean():.2e}, (diff>0) {(d > 0).mean():.2e}; host arrays "
        f"in and out {secs * 1e3:.1f} ms ({e.gpu})")
    if d.max() > 2 or (d > 1).mean() >= E2E_FRAC:
        raise AssertionError("single_8k differs from the plain pipeline")


def phase_timings(e: Extra, ms: dict, plain_ms: dict) -> None:
    from srcnn_cpp_tpu_torch.ops.cuda_merge import merge_ycrcb_to_bgr_fused
    from srcnn_cpp_tpu_torch.ops.cuda_srcnn import (srcnn_merge_fused,
                                                    srcnn_merge_plain,
                                                    srcnn_y_f32_fused,
                                                    srcnn_y_f32_plain,
                                                    srcnn_y_fused)

    w, up, y4k = e.weights, e.up, e.y4k
    say(f"phase 12: timings of K4 at {list(up.shape)} and K5 at "
        f"{list(y4k.shape)}, card {e.gpu}")
    ms["srcnn_merge_fused"], plain_ms["srcnn_merge_fused"] = ab_ms(
        lambda: srcnn_merge_fused(up, w),
        lambda: srcnn_merge_plain(up, w), 10)
    k4, chain = ab_ms(
        lambda: srcnn_merge_fused(up, w),
        lambda: merge_ycrcb_to_bgr_fused(srcnn_y_fused(up[:, 0], w), up), 10)
    say(f"  srcnn_merge_fused: {ms['srcnn_merge_fused']:.4f} ms, plain "
        f"{plain_ms['srcnn_merge_fused']:.4f} ms; in turns with K1 -> K3 "
        f"chained: K4 {k4:.4f} ms, K1 -> K3 {chain:.4f} ms ({e.gpu})")
    ms["srcnn_y_f32_fused"], plain_ms["srcnn_y_f32_fused"] = ab_ms(
        lambda: srcnn_y_f32_fused(y4k, w),
        lambda: srcnn_y_f32_plain(y4k, w), 10)
    k1 = median_ms(lambda: srcnn_y_fused(y4k, w), 10)
    say(f"  srcnn_y_f32_fused: {ms['srcnn_y_f32_fused']:.4f} ms, plain "
        f"{plain_ms['srcnn_y_f32_fused']:.4f} ms; K1 on the same plane "
        f"{k1:.4f} ms ({e.gpu})")


if __name__ == "__main__":
    sys.exit(main())
