#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``srcnn_cpp_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the three CUDA kernels of the main path from
``srcnn_cpp_tpu_torch/csrc`` (nvcc, sm_90a), holds each against its plain
PyTorch version on the card, drives the main path (``upscale_bgr_batch``
on 4 seeded 540x960 frames at x2) and checks that it went through the
three kernels, checks the result against the plain pipeline on the card
and against the reference binary's goldens, and times each kernel and the
end-to-end path with CUDA events.  Any failure raises and the exit code is
non-zero.  The last line of standard output is a JSON object
``{"ok": true, "device": {...}}``; the line before it lists the kernels.

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
    say(f"phase 1: built {path.relative_to(ROOT)} in {secs:.1f} s with: "
        + " ".join(runtime.nvcc_command(path.name)[1:8]))
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
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
    hh, ww = 48, 200
    g = np.meshgrid(np.arange(hh), np.arange(ww), indexing="ij")
    img = ((g[0] * 37 + g[1] * 11) % 256).astype(np.uint8)
    img[:3, :], img[:, :3], img[-3:, :], img[:, -3:] = 255, 0, 255, 0
    border = torch.from_numpy(np.stack(
        [img, 255 - img, np.roll(img, 7, axis=1)])).cuda()
    for i, y in enumerate([u8((2, OH, OW), 40), u8((1, 1), 41),
                           u8((3, 7), 42), u8((17, 130), 43), border]):
        d = diff(srcnn_y_fused(y, weights), srcnn_y_plain(y, weights))
        mx, frac = int(d.max()), float((d > 0).float().mean())
        say(f"  {list(y.shape)}: max {mx} LSB, differing fraction {frac:.2e}")
        if mx > 1 or frac >= K1_FRAC:
            raise AssertionError(f"K1 {list(y.shape)}: max {mx}, frac {frac}")
        k1_err = max(k1_err, mx)
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

    replaces = {
        "pre_upscale_fused": ("srcnn_cpp_tpu_torch/csrc/pre_pass.cu",
                              "srcnn_cpp_tpu/ops/pallas_resize.py:81"),
        "srcnn_y_fused": ("srcnn_cpp_tpu_torch/csrc/srcnn_conv.cu",
                          "srcnn_cpp_tpu/ops/pallas_srcnn.py:281"),
        "merge_ycrcb_to_bgr_fused": ("srcnn_cpp_tpu_torch/csrc/merge.cu",
                                     "srcnn_cpp_tpu/ops/pallas_merge.py:40"),
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


if __name__ == "__main__":
    sys.exit(main())
