#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``srcnn_cpp_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of the port from ``srcnn_cpp_tpu_torch/csrc``
(one nvcc per source, sm_90a; phase 1 prints ptxas's registers and spills,
the conv's setmaxnreg split and K2's static SASS instruction counts, and
fails on any spill), holds each against
its plain PyTorch version on the card, and drives each path through the
entry points a user calls, with the launch counts set to 0 just before and
read just after:

* phases 2-6, the main path: ``upscale_bgr_batch`` on 4 seeded 540x960
  frames at x2 (K2 pre-pass -> K1 conv -> K3 merge), checked against the
  plain pipeline on the card and the reference binary's goldens; two calls
  with the default weights pack the conv weights once; timed beside each
  kernel's bound, with K1's achieved TFLOP/s and MACs per output pixel,
  and K2's record: its graph-replay and profiler time, achieved bytes/s,
  plan and persistent blocks;
* phase 7, K4 ``srcnn_merge_fused`` (conv + merge in one kernel) on the
  main path's upscaled YCrCb batch: bit-equal to K1 -> K3;
* phase 8, K5 ``srcnn_y_f32_fused`` (f32-output conv) on a 2160x3840
  plane: quantized, bit-equal to K1;
* phase 9, the evaluation harness on ``tests/data/eval``: against the
  port's CPU run and ``EVAL.md``'s butterfly rows;
* phase 10, the stream: ``StreamUpscaler`` at 1920x1080 x2, bit-equal to
  ``upscale_bgr_batch`` and in order; its two rate modes;
* phase 11, the ``single_8k`` configuration: 3840x2160 -> 7680x4320;
* phase 12, timings of K4 and K5 with CUDA events;
* phase 13, training: ``train.fit`` on ``tests/data/eval`` at x2 (SRCNN
  9-5-5 from the checkpoint, batch 64 of 33x33 patches, Adam 1e-4, 50
  steps), its gradients and first steps against the port's CPU run and a
  float64 run, the step's time beside its bound, and the trained weights
  through a checkpoint and back into the main path (K2 -> K1 -> K3);
* phases 14-19, ``parallel/`` on meshes that name the one card several
  times (every block's kernels run on the card, every seam is stitched):
  K1 tiled bit-equal to K1 (14); windowed K2 and tiled K3 bit-equal to K2
  and K3 at x2, x1.5, x1.25, x0.75 and x3 (15); ``single_8k(mesh=row 4)``
  bit-equal to ``single_8k()``, with its times beside the unsharded run's
  (16); ``single_8k(mesh=...)`` where the mesh does not divide the output,
  3840x2160 x1.25 and 1920x1080 x1.5 over 8 row blocks and 1366x768 x1.5
  over (1,2,2), bit-equal with one launch of each kernel per block and
  timed the same way (16b); the sharded train step against
  ``make_train_step`` (17); two
  processes of ``parallel.distributed`` on the card over gloo, the stream
  bit-exact and the trainer's losses equal to one process's (18; over
  NCCL with one card per process where there are two cards); and
  ``scaling_efficiency`` as one card's tiling overhead (19);
* phase 20, ``utils.profiling`` on the main path: a ``trace`` of
  ``upscale_bgr_batch`` on host arrays that must name the path's three
  kernels, show no device-to-host copy between K2 and K1 and one after
  each chunk's K3 (``pipeline.chunks``), of that chunk's HWC bytes,
  enqueued inside the program's ``srcnn.entry.fetch`` spans, and K2's,
  K1's and K3's launches inside its ``srcnn.pipeline`` spans: the
  program's spans and the card's activities on one clock;
* phase 21, ``upscale_bgr_batch`` with a CUDA tensor: a CUDA tensor out,
  bit-equal to ``upscale_planar`` after the permute, one launch of each
  kernel, no device-to-host copy in its trace; timed beside
  ``upscale_planar``;
* phase 22, ``StreamUpscaler(2.0, batch=4, depth=3)`` fed 12 seeded
  1080x1920 frames as CUDA tensors: host arrays out, bit-equal to the same
  frames pushed as host arrays and in order, K2, K1 and K3 three times
  each, no host-to-device copy in the trace of one dispatch; its fps in
  turns with the host-array feed over the frames cycled to 96 (the ring
  wraps 6 times), beside phase 10's ``run_synthetic``;
* phase 23, ``single_8k(mesh=...)`` on a CUDA tensor (2160x3840 x2 over
  row 4, 1080x1920 x1.5 over row 8, the cuda:0 mesh): a CUDA tensor out,
  bit-equal to the host-array call and to ``single_8k()`` on the tensor,
  each kernel once per block, no frame or block bytes between host and
  card in its trace (a host-to-device copy may only be of a weight
  tensor); its CUDA-event time beside the host-array call's;
* phase 24, ``process_srcnn`` on the card: ``tests/data/eval/butterfly.png``
  x2 at d = 1 (its Y plane), 2 (RGB565), 3 (RGB) and 4 (RGB and a seeded
  alpha): bit-equal to the same composition of the port's card path, the
  golden gate against the port's CPU run (<=1 LSB at d = 1), the alpha
  plane bit-equal, K1 once at d = 1 and K2, K1, K3 once each otherwise;
* phase 25, the VDSR chain ``vdsr_y_fused`` (conv1, the 18 64->64 layers,
  conv20 with the residual) at the main path's batch and size, 8 frames of
  1080x1920 -> 2160x3840 with the seeded weights of
  ``portbench/configs/vdsr20_seeded.npz``: ``upscale_planar`` launches it
  once and K1 never, bit-equal to K2 -> the chain -> K3; each of the 8
  planes within 1 LSB of the fp32 ``F.conv2d`` path on under 0.5 % of
  pixels; timed beside the plain path and its bound;
* phase 26, RCAN x2 ``rcan_fused`` (10 groups of 20 RCABs, the 64->64
  conv's epilogues, channel attention) at its cell's shapes, 4 frames of
  1080x1920 -> 2160x3840 with the seeded weights of
  ``portbench/configs/rcan_x2_seeded.jsonl``: ``upscale_planar`` launches it
  once and K2, K1, K3 never; each frame within 1 LSB of the fp32
  ``F.conv2d`` path (TF32 off) on under 0.5 % of bytes; a trace of one
  call holds 417 RCAN kernels a frame and none named ``rcan_ca_*``
  (channel attention runs in the convs' loaders); the share off, ms a
  frame and the kernels a call, beside the plain path and its bound.
* phase 27, SwinIR x2 ``swinir_fused`` (6 RSTBs of 6 Swin transformer
  layers at 180 channels, the GEMM body's LayerNorm loaders and epilogues,
  the window attention, RCAN's upsampler and tail) at its cell's frame
  size, 2 frames of 1080x1920 -> 2160x3840 with the seeded weights of
  ``portbench/configs/swinir_x2_seeded.jsonl``: ``upscale_planar``
  launches it once and K2, K1, K3 never; each frame within 1 LSB of the
  fp32 path (TF32 off) on under 0.5 % of bytes; every GEMM launch (152 a
  frame) staged its epilogue (``swinir_fused.staged_epilogues``); a trace
  of one call holds 194 kernels a frame, 180 of them named
  ``swin_stl_*``; ms a frame
  beside the plain path and its bound.

Phases 25-27 also run one call under a trace, where the GEMM bodies run
their probed instances: its output bit-equal to the untraced call's, and
the stall counters (``utils.profiling.kernel_counters``) printed by kind,
each kind's launches, units and stages as the launch schedule counts them
and each wait inside its units' cycles; phase 1 fails unless every kind's
probed instance was compiled (and, as for every kernel, on a spill).

Each phase from 7 on prints its wall time.

Any failure raises and the exit code is non-zero.  The last line of
standard output is a JSON object ``{"ok": true, "device": {...}}``; the
line before it lists the kernels, each with its launches on its path, its
error against its plain version, its time and its plain version's, and its
bound: the larger of its bytes (each input read once, each output written
once) over 3.35 TB/s and its operations over the card's peak for their
type (H100 SXM data sheet, at 700 W).

Needs one CUDA card; exits non-zero without a result when there is none.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
VDSR_NPZ = ROOT / "portbench/configs/vdsr20_seeded.npz"
RCAN_RECIPE = ROOT / "portbench/configs/rcan_x2_seeded.jsonl"
SWINIR_RECIPE = ROOT / "portbench/configs/swinir_x2_seeded.jsonl"
SEED = 0
# x2 main-path geometry: 4 frames of 540x960 -> 1080x1920
BATCH, IH, IW, SCALE = 4, 540, 960, 2.0
OH, OW = 2 * IH, 2 * IW
K1_FRAC = 5e-3        # K1 vs fp32 F.conv2d: <=1 LSB on < 0.5% of pixels
E2E_FRAC = 1e-5       # e2e: <=2 LSB, (diff > 1) on < 1e-5 of values
K5_ATOL = 1e-2        # K5 vs fp32 F.conv2d before quantization
TRAIN_RTOL = 1e-4     # train: the card's first losses vs the CPU's
GRAD_REL = 1e-4       # train: gradients, relative to the tensor's max |g|
UPDATE_REL = 5e-3     # train: weight updates, relative to the largest
TRAIN_STEPS = 50      # train: steps of fit() on the card
EVAL_DB = 0.01        # eval: card vs CPU run and vs EVAL.md, PSNR in dB
EVAL_SSIM = 1e-4      # eval: SSIM against EVAL.md's 4-decimal rows
HBM_BPS = 3.35e12     # H100 SXM device memory, bytes/s
TF32_FLOPS = 495e12   # H100 SXM dense TF32 tensor-core peak
FP32_FLOPS = 67e12    # H100 SXM fp32 peak outside the tensor cores
# conv body: tensor-core MACs per output pixel in 3xTF32 (conv1 2 x 81 x 64,
# conv2 3 x 64 x 32, conv3 3 x 32 x 25)
CONV_MACS = 2 * 81 * 64 + 3 * 64 * 32 + 3 * 32 * 25
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


def at_offset(t: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of u8 ``t`` that starts ``offset`` bytes into a
    larger buffer on the card."""
    buf = torch.empty(t.numel() + offset, dtype=torch.uint8, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == offset % 16
    return view


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
    """Median over ``reps`` CUDA-event timings of ``fn`` after a warm-up.

    Each timing brackets enough back-to-back calls to fill about 2 ms and
    is divided by their count, so a short kernel is not timed at the
    host's launch rate.
    """
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    inner = max(1, min(50, int(2e-3 / (time.perf_counter() - t0))))
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(inner):
            fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1) / inner)
    return statistics.median(times)


def bound(nbytes: float, flops: float = 0.0,
          peak: float = FP32_FLOPS) -> tuple[float, str]:
    """``(ms, "bytes" | "operations")``: the least time for moving
    ``nbytes`` and doing ``flops`` at ``peak``."""
    t_bytes, t_ops = nbytes / HBM_BPS, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def conv_bound(npix: int, in_b: int, out_b: int) -> tuple[float, str]:
    """The conv body on ``npix`` output pixels, ``in_b``/``out_b`` bytes
    per pixel."""
    return bound(npix * (in_b + out_b), 2.0 * CONV_MACS * npix, TF32_FLOPS)


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
    from srcnn_cpp_tpu_torch.kernel_ab import graph_ms, profile, sass_counts
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
        elif "wgmma" in line or "setmaxnreg" in line:
            say(f"  ptxas: {line.strip()}")
    sass = sass_counts(path, "pre_pass_kernel")
    say("  K2 pre_pass_kernel, static SASS instruction counts: "
        + (", ".join(f"{k} {v}" for k, v in sass.items()) if sass else
           "not read (cuobjdump absent or failed)"))
    spilled = sum(int(n) for n in re.findall(r"(\d+) bytes spill", log))
    say(f"  ptxas: {spilled} bytes of spill stores and loads in all kernels")
    # the GEMM bodies' probed twins (csrc/probe.cuh: PROBE, mangled Lb1E)
    # are among them, one a kind
    from srcnn_cpp_tpu_torch.ops.cuda_swinir import PROBE_KINDS
    probed = set(re.findall(r"Compiling entry function '(\w+Lb1E\w*)'", log))
    say(f"  ptxas: {len(probed)} probed GEMM instances compiled, "
        f"{len(PROBE_KINDS)} kinds counted")
    if len(probed) != len(PROBE_KINDS):
        raise AssertionError(f"{len(probed)} probed instances, not one for "
                             f"each of the {len(PROBE_KINDS)} kinds")
    from srcnn_cpp_tpu_torch.ops import cuda_srcnn
    say(f"  conv (K1/K4/K5): {cuda_srcnn.CONSUMERS} consumer warpgroups at "
        f"setmaxnreg {cuda_srcnn.REGS[0]}, the helper warpgroup at "
        f"{cuda_srcnn.REGS[1]}, {cuda_srcnn.THREADS} threads, "
        f"{cuda_srcnn.conv_smem_bytes()} bytes of shared memory")
    if spilled:
        raise AssertionError(f"ptxas spilled {spilled} bytes")
    runtime.library()
    weights = load_weights(device="cuda")
    max_err = {}

    # phase 2: K3 merge vs plain, bit-equal
    say("phase 2: K3 merge_ycrcb_to_bgr_fused vs merge_plain")
    # 16-byte units where H*W % 16 == 0; one thread per pixel elsewhere
    for i, (b, h, w) in enumerate([(2, 1080, 1920), (2, 537, 1111),
                                   (1, 12, 128), (1, 1, 1), (3, 7, 13),
                                   (2, 1079, 1921)]):
        y, up = u8((b, h, w), 10 + i), u8((b, 3, h, w), 20 + i)
        assert_equal(merge_ycrcb_to_bgr_fused(y, up), merge_plain(y, up),
                     f"[{b},3,{h},{w}]")
    # contiguous inputs at byte offsets into a larger buffer: misaligned
    # (one thread per pixel), or offset by whole 16-byte words (16-byte
    # units)
    for y_off, up_off in ((1, 0), (0, 3), (1, 1), (16, 48)):
        y, up = u8((2, 64, 96), 16), u8((2, 3, 64, 96), 17)
        ym, upm = at_offset(y, y_off), at_offset(up, up_off)
        assert_equal(merge_ycrcb_to_bgr_fused(ym, upm), merge_plain(y, up),
                     f"[2,3,64,96], Y' at +{y_off} B, YCrCb at +{up_off} B")
    y = torch.arange(256, dtype=torch.uint8).repeat(1, 8, 1).cuda()
    for cr, cb in [(0, 0), (255, 255), (0, 255), (255, 0), (128, 128)]:
        up = torch.empty((1, 3, 8, 256), dtype=torch.uint8, device="cuda")
        up[:, 0], up[:, 1], up[:, 2] = 0, cr, cb
        assert_equal(merge_ycrcb_to_bgr_fused(y, up), merge_plain(y, up),
                     f"clip boundary cr={cr} cb={cb}")
    max_err["merge_ycrcb_to_bgr_fused"] = 0

    # phase 3: K2 pre-pass vs plain, bit-equal at every scale
    say("phase 3: K2 pre_upscale_fused vs pre_upscale_plain")
    # x0.1: one row per thread (no tap row shared); [3,3,101,77]: odd W
    # (byte loads) and OW % 4 != 0 (byte stores on odd rows); batch 1
    cases = [((2, 3, IH, IW), s)
             for s in (2.0, 1.5, 3.0, 1.25, 0.75, 1.2, 0.1)]
    cases += [((1, 3, 333, 517), 2.75), ((3, 3, 101, 77), 2.75),
              ((1, 3, IH, IW), 2.0)]
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
    # [2,1079,1921] and [1,16,8]: the last tiles and m16 row tiles are
    # partial on both axes
    for y in [u8((2, OH, OW), 40), u8((1, 1), 41), u8((3, 7), 42),
              u8((17, 130), 43), border_batch(), u8((2, 1079, 1921), 45),
              u8((1, 16, 8), 46)]:
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
    # the default weights: loaded and moved once per process and device,
    # so the conv's weights are packed once, not per call
    packs = []
    for _ in range(2):
        cuda_srcnn._pack.calls = 0
        upscale_bgr_batch(frames[:1], SCALE, None, device="cuda")
        packs.append(cuda_srcnn._pack.calls)
    say(f"  two upscale_bgr_batch calls with the default weights: packed "
        f"the conv weights {packs[0]} + {packs[1]} times")
    if sum(packs) > 1:
        raise AssertionError("the default weights are packed per call")

    # phase 6: timings at the x2 geometry (CUDA events, medians)
    say(f"phase 6: timings, [{BATCH},3,{IH},{IW}] -> [{BATCH},3,{OH},{OW}], "
        f"card {gpu}")
    # every kernel launched back to back from the host, as in earlier runs
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
    # K2 and K3 take tens of microseconds, about their wrappers' host time:
    # the card's own time comes from CUDA graph replays and the profiler
    k23 = (("pre_upscale_fused", lambda: pre_upscale_fused(x, (OH, OW))),
           ("merge_ycrcb_to_bgr_fused",
            lambda: merge_ycrcb_to_bgr_fused(y_sr, up)))
    say("  from CUDA graph replays: " + ", ".join(
        f"{n} {graph_ms(f, 20):.4f} ms" for n, f in k23) + "; profiler "
        "device time of 20 calls: " + ", ".join(
        f"{n} {profile(f)['device_ms_per_call']:.4f} ms" for n, f in k23))
    npix, nin = BATCH * OH * OW, BATCH * IH * IW
    k2_record(x, npix, nin, gpu)
    bounds = {
        # bytes: BGR in, YCrCb out; operations: the fp32 vertical chain
        "pre_upscale_fused": bound(3 * (nin + npix), 21.0 * npix),
        "srcnn_y_fused": conv_bound(npix, 1, 1),
        # bytes: Y', Cr, Cb in and BGR out
        "merge_ycrcb_to_bgr_fused": bound(6 * npix),
    }
    for name in ms:
        say(f"  {name}: {ms[name]:.4f} ms, plain {plain_ms[name]:.4f} ms, "
            f"bound {bounds[name][0]:.4f} ms ({bounds[name][1]}) ({gpu})")
    macs = cuda_srcnn.conv_macs(BATCH, OH, OW, runtime.num_sms())
    plan = cuda_srcnn.conv_tile_plan(BATCH, OH, OW, runtime.num_sms())
    say(f"  srcnn_y_fused: {2 * macs / (ms['srcnn_y_fused'] * 1e-3) / 1e12:.1f}"
        f" TFLOP/s achieved of {TF32_FLOPS / 1e12:.0f} (dense TF32), "
        f"{macs / npix:.0f} tensor-core MACs per output pixel ({CONV_MACS} "
        f"in the bound); plan: {plan['tiles']} units of {plan['tile'][0]} "
        f"rows x {plan['tile'][1]} columns on {plan['grid']} blocks ({gpu})")
    # H*W % 16 != 0: K3 runs one thread per pixel
    y_odd, up_odd = u8((BATCH, OH - 1, OW + 1), 47), \
        u8((BATCH, 3, OH - 1, OW + 1), 48)

    def odd():
        return merge_ycrcb_to_bgr_fused(y_odd, up_odd)

    say(f"  merge_ycrcb_to_bgr_fused per-pixel kernel at "
        f"[{BATCH},{OH - 1},{OW + 1}]: {median_ms(odd, 20):.4f} ms back to "
        f"back, {graph_ms(odd, 20):.4f} ms from graph replays, "
        f"{profile(odd)['device_ms_per_call']:.4f} ms profiler device time "
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
    timed(phase_k4, extra, launches, max_err)
    timed(phase_k5, extra, launches, max_err)
    timed(phase_eval, extra)
    synthetic_fps = timed(phase_stream, extra)
    timed(phase_single_8k, extra)
    timed(phase_timings, extra, ms, plain_ms, bounds)
    timed(phase_train, extra)
    timed(phase_tiled_k1, extra)
    timed(phase_tiled_k2_k3, extra)
    mesh_host_ms = timed(phase_single_8k_mesh, extra)
    uneven_host_ms = timed(phase_single_8k_uneven, extra)
    timed(phase_sharded_train, extra)
    timed(phase_two_processes, extra)
    timed(phase_scaling, extra)
    timed(phase_profiling, extra, frames)
    timed(phase_device_entry, extra, frames)
    timed(phase_stream_tensors, extra, synthetic_fps)
    timed(phase_single_8k_mesh_tensor, extra,
          {**mesh_host_ms, **uneven_host_ms})
    timed(phase_process_srcnn, extra)
    timed(phase_vdsr, extra, launches, max_err, ms, plain_ms, bounds)
    timed(phase_rcan, extra, launches, max_err, ms, plain_ms, bounds)
    timed(phase_swinir, extra, launches, max_err, ms, plain_ms, bounds)

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
        # the JAX package runs SRCNN only
        "vdsr_y_fused": ("srcnn_cpp_tpu_torch/csrc/vdsr_conv.cu", None),
        "rcan_fused": ("srcnn_cpp_tpu_torch/csrc/rcan.cu", None),
        "swinir_fused": ("srcnn_cpp_tpu_torch/csrc/swinir.cu", None),
    }
    # library_ms: no single PyTorch call computes any of these functions
    kernels = [{"name": n, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[n], "max_abs_err": max_err[n],
                "ms": ms[n], "plain_ms": plain_ms[n],
                "bound_ms": bounds[n][0], "bound_by": bounds[n][1],
                "library_ms": None}
               for n, (src, rep) in replaces.items()]
    say(f"card: {gpu}")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def k2_record(x: torch.Tensor, npix: int, nin: int, gpu: str) -> None:
    """Phase 6's K2 record at the main geometry: graph-replay and profiler
    time, achieved bytes/s, the plan and the persistent blocks it runs on
    (the launcher's own residency query)."""
    import ctypes

    from srcnn_cpp_tpu_torch import runtime
    from srcnn_cpp_tpu_torch.kernel_ab import graph_ms, profile
    from srcnn_cpp_tpu_torch.ops.cuda_resize import (pre_pass_plan,
                                                     pre_upscale_fused)

    def fn():
        return pre_upscale_fused(x, (OH, OW))

    g, p = graph_ms(fn, 20), profile(fn)["device_ms_per_call"]
    plan = pre_pass_plan(OH, OW, IH, IW)
    slots = ctypes.c_int(0)
    runtime.check(runtime.library().pre_pass_resident_blocks(
        plan["smem_bytes"], ctypes.byref(slots)), "pre_pass_resident_blocks")
    tiles = plan["grid"][0] * plan["grid"][1] * BATCH
    grid = min(tiles, slots.value)
    nbytes = 3 * (nin + npix)
    say(f"  K2 record: graph {g:.4f} ms, profile {p:.4f} ms; "
        f"{nbytes / p / 1e6:.1f} GB/s of {HBM_BPS / 1e9:.0f} "
        f"({100 * nbytes / HBM_BPS / (p * 1e-3):.1f} % of the byte bound); "
        f"plan: tile {plan['tile']}, {plan['cols']} columns x "
        f"{plan['rows']} rows per thread, {plan['threads']} threads, window "
        f"{plan['win']}, {plan['smem_bytes']} B of shared memory; "
        f"{plan['grid']} x {BATCH} = {tiles} tiles on {grid} persistent "
        f"blocks ({slots.value // runtime.num_sms()} an SM), "
        f"{tiles / grid:.2f} tiles a block ({gpu})")


def timed(phase, *args):
    """Run ``phase(*args)``, print its wall time and return its result."""
    t0 = time.perf_counter()
    result = phase(*args)
    say(f"  ({phase.__name__}: {time.perf_counter() - t0:.1f} s wall)")
    return result


class Extra:
    """What the phases after the main path share: the card's name and
    power limit, the weights on the card, and the main path's planar input
    ``x`` [4,3,540,960] and its upscaled YCrCb ``up`` [4,3,1080,1920]."""

    def __init__(self, gpu, weights, x, up):
        from srcnn_cpp_tpu_torch.ops import (cuda_merge, cuda_rcan,
                                             cuda_resize, cuda_srcnn,
                                             cuda_swinir, cuda_vdsr)

        self.gpu, self.weights, self.x, self.up = gpu, weights, x, up
        self.wrappers = (cuda_resize.pre_upscale_fused,
                         cuda_srcnn.srcnn_y_fused,
                         cuda_merge.merge_ycrcb_to_bgr_fused,
                         cuda_srcnn.srcnn_merge_fused,
                         cuda_srcnn.srcnn_y_f32_fused,
                         cuda_vdsr.vdsr_y_fused, cuda_rcan.rcan_fused,
                         cuda_swinir.swinir_fused)
        self.plains = (cuda_resize.pre_upscale_plain, cuda_srcnn.srcnn_y_plain,
                       cuda_merge.merge_plain, cuda_srcnn.srcnn_merge_plain,
                       cuda_srcnn.srcnn_y_f32_plain, cuda_vdsr.vdsr_y_plain,
                       cuda_rcan.rcan_plain, cuda_swinir.swinir_plain)
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


def phase_stream(e: Extra) -> float:
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
    return r["fps"]


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


def phase_timings(e: Extra, ms: dict, plain_ms: dict, bounds: dict) -> None:
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
    npix = up.shape[0] * up.shape[2] * up.shape[3]
    bounds["srcnn_merge_fused"] = conv_bound(npix, 3, 3)
    say(f"  srcnn_merge_fused: {ms['srcnn_merge_fused']:.4f} ms, plain "
        f"{plain_ms['srcnn_merge_fused']:.4f} ms, bound "
        f"{bounds['srcnn_merge_fused'][0]:.4f} ms; in turns with K1 -> K3 "
        f"chained: K4 {k4:.4f} ms, K1 -> K3 {chain:.4f} ms ({e.gpu})")
    ms["srcnn_y_f32_fused"], plain_ms["srcnn_y_f32_fused"] = ab_ms(
        lambda: srcnn_y_f32_fused(y4k, w),
        lambda: srcnn_y_f32_plain(y4k, w), 10)
    k1 = median_ms(lambda: srcnn_y_fused(y4k, w), 10)
    bounds["srcnn_y_f32_fused"] = conv_bound(y4k.numel(), 1, 4)
    say(f"  srcnn_y_f32_fused: {ms['srcnn_y_f32_fused']:.4f} ms, plain "
        f"{plain_ms['srcnn_y_f32_fused']:.4f} ms, bound "
        f"{bounds['srcnn_y_f32_fused'][0]:.4f} ms; K1 on the same plane "
        f"{k1:.4f} ms ({e.gpu})")


def check_gradients(model, cpu_model, exact_model, first) -> None:
    """The card's gradients of ``mse_loss`` before any step, which Adam's
    normalisation would hide from the update check: per tensor within
    GRAD_REL x max |g| of the CPU's, on the 4x32x32 batch of
    ``tests/test_torch_train.py`` and on the first training batch; on the
    latter each is also printed against a float64 run."""
    from srcnn_cpp_tpu_torch.ops.srcnn import fp32_strict
    from srcnn_cpp_tpu_torch.train import mse_loss

    def grads(m, xb, tb) -> dict:
        dev = next(m.parameters()).device
        m.zero_grad(set_to_none=True)
        with fp32_strict():
            mse_loss(m, torch.from_numpy(np.ascontiguousarray(xb)).to(dev),
                     torch.from_numpy(np.ascontiguousarray(tb)).to(dev)
                     ).backward()
        g = {k: p.grad.detach().cpu().double()
             for k, p in m.named_parameters()}
        m.zero_grad(set_to_none=True)
        return g

    rng = np.random.default_rng(0)
    xs = rng.integers(0, 256, (4, 32, 32), dtype=np.uint8)
    ts = np.clip(xs.astype(np.float32) * 1.02 - 2.0, 0, 255)
    for what, (xb, tb) in (("4x32x32", (xs, ts)), ("first 64x33x33", first)):
        card, cpu = grads(model, xb, tb), grads(cpu_model, xb, tb)
        rel = {k: float((card[k] - cpu[k]).abs().max() / cpu[k].abs().max())
               for k in cpu}
        msg = f"  gradients on the {what} batch, card vs CPU, of max |g|: " \
            + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()) \
            + f" (bar {GRAD_REL})"
        if what != "4x32x32":
            exact = grads(exact_model, xb, tb)
            msg += "; vs a float64 run, card/CPU: " + ", ".join(
                f"{k} {float((card[k] - g).abs().max() / g.abs().max()):.2e}/"
                f"{float((cpu[k] - g).abs().max() / g.abs().max()):.2e}"
                for k, g in exact.items())
        say(msg)
        if max(rel.values()) > GRAD_REL:
            raise AssertionError(f"the card's gradients on the {what} batch "
                                 f"differ from the CPU's: {rel}")


def phase_train(e: Extra) -> None:
    import itertools
    import tempfile

    from srcnn_cpp_tpu_torch.kernel_ab import profile
    from srcnn_cpp_tpu_torch.models import SRCNN
    from srcnn_cpp_tpu_torch.pipeline import upscale_bgr_batch
    from srcnn_cpp_tpu_torch.train import (dataset_from_dir, fit,
                                           iterate_minibatches,
                                           make_train_step)
    from srcnn_cpp_tpu_torch.weights import load_weights
    from srcnn_cpp_tpu_torch.weights.checkpoint import (load_checkpoint,
                                                        save_checkpoint)

    data = ROOT / "tests/data/eval"
    say(f"phase 13: training on the card: fit() on tests/data/eval x2, "
        f"batch 64, Adam 1e-4, {TRAIN_STEPS} steps from the checkpoint")
    t0 = time.perf_counter()
    x, t = dataset_from_dir(data, scale=2.0)
    say(f"  dataset_from_dir: {len(x)} patches of 33x33 in "
        f"{time.perf_counter() - t0:.1f} s (host)")
    batches = list(itertools.islice(iterate_minibatches(x, t, 64, seed=0),
                                    3))

    def trainer(device, dtype=torch.float32):
        model = SRCNN.from_weights(device=device).to(dtype)
        opt = torch.optim.Adam(model.parameters(), lr=1e-4, eps=1e-8)
        return model, opt, make_train_step(model, opt)

    # the first 3 steps on the CPU and on the card, on the same batches, and
    # on the CPU in float64: the yardstick of both float32 runs
    cpu_model, _, cpu_step = trainer("cpu")
    exact_model, _, exact_step = trainer("cpu", torch.float64)
    model, opt, step = trainer("cuda")
    check_gradients(model, cpu_model, exact_model, batches[0])
    cpu_losses = [cpu_step(xb, tb) for xb, tb in batches]
    for xb, tb in batches:
        exact_step(xb, tb)
    # the step switches TF32 off itself: turn it on (PyTorch's default for
    # cuDNN) around the card's steps and read the switches in the forward
    # and in the backward (conv1's weight gradient)
    seen = []

    def record(*_):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32,
                     not torch.backends.cudnn.enabled))

    hooks = [model.register_forward_hook(record),
             model.conv1_w.register_hook(record)]
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        losses = [step(xb, tb) for xb, tb in batches]
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        for h in hooks:
            h.remove()
    if len(seen) != 6 or any(any(f) for f in seen):
        raise AssertionError(f"TF32 on or cuDNN off inside the step: {seen}")
    say(f"  TF32 off and cuDNN on inside all {len(seen) // 2} steps "
        "(forward and backward) with PyTorch's TF32 default on outside")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses))
    say(f"  first 3 losses: card {losses}, CPU {cpu_losses}; max relative "
        f"difference {rel:.2e} (bar {TRAIN_RTOL})")
    if not np.isfinite(losses).all() or rel > TRAIN_RTOL:
        raise AssertionError("the card's first losses differ from the CPU's")
    # the updates: where a gradient element cancels over the batch's 69,696
    # positions its float32 sum keeps few digits on any device, and Adam
    # hands that on; so the card's updates are held to the float64 run no
    # further than the CPU's float32 updates are, plus UPDATE_REL of the
    # largest update
    ref, raw, err_cpu, err_card = load_weights(), 0.0, 0.0, 0.0
    for (k, pg), pc, pe in zip(model.named_parameters(),
                               cpu_model.parameters(),
                               exact_model.parameters()):
        w_cpu, w_card = pc.detach().double(), pg.detach().cpu().double()
        w_exact = pe.detach()
        largest = (w_exact - getattr(ref, k)).abs().max().clamp_min(1e-30)
        raw = max(raw, float((w_card - w_cpu).abs().max() / largest))
        err_cpu = max(err_cpu, float((w_cpu - w_exact).abs().max() / largest))
        err_card = max(err_card,
                       float((w_card - w_exact).abs().max() / largest))
    say(f"  weights after 3 steps, of the largest update: card vs CPU "
        f"{raw:.2e}; vs the float64 run: card {err_card:.2e}, CPU "
        f"{err_cpu:.2e} (bar: the CPU's + {UPDATE_REL})")
    if err_card > err_cpu + UPDATE_REL:
        raise AssertionError("the card's updates differ from the CPU's")

    # the step's time: host clock around steps that end in the loss's sync
    more = list(itertools.islice(iterate_minibatches(x, t, 64, seed=1), 40))
    for xb, tb in more[:10]:
        step(xb, tb)
    times = []
    for xb, tb in more[10:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(xb, tb)
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(times)
    # forward + backward: 3x the forward's 8,032 MACs per output pixel
    npx = 64 * 33 * 33
    b_ms, b_by = bound(2 * npx, 2.0 * 3 * (81 * 64 + 64 * 32 + 32 * 25) * npx)
    say(f"  train step (batch 64 x 33x33, cuDNN fp32, Adam): median "
        f"{step_ms:.4f} ms over {len(times)} steps (min {min(times):.4f}), "
        f"{64 / (step_ms / 1e3):.0f} patches/s; bound {b_ms:.4f} ms "
        f"({b_by}) ({e.gpu})")
    xb, tb = more[0]
    prof = profile(lambda: step(xb, tb), iters=10)
    top = sorted(prof["kernels_ms_per_call"].items(), key=lambda kv: -kv[1])
    say(f"  profile of 10 steps: device {prof['device_ms_per_call']:.4f} ms "
        f"of a {prof['span_ms_per_call']:.4f} ms span per step (busy "
        f"{prof['busy_share']:.3f}), {prof['activities_per_call']:.0f} device "
        f"activities per step; most time: " + "; ".join(
            f"{k[:48]} {v:.4f} ms" for k, v in top[:4]))

    # the user's entry point: fit() on the card
    t0 = time.perf_counter()
    trained, fit_losses = fit(data, scale=2.0, steps=TRAIN_STEPS, batch=64,
                              lr=1e-4, verbose=False, device="cuda")
    secs = time.perf_counter() - t0
    say(f"  fit: {TRAIN_STEPS} steps in {secs:.2f} s with its dataset; mse "
        f"{fit_losses[0]:.3f} -> {fit_losses[-1]:.3f} (min "
        f"{min(fit_losses):.3f})")
    rel = max(abs(a - b) / abs(b) for a, b in zip(fit_losses, cpu_losses))
    if not np.isfinite(fit_losses).all() or rel > TRAIN_RTOL:
        raise AssertionError(f"fit's losses: not finite, or its first 3 "
                             f"differ from the CPU's by {rel}")
    if trained.device.type != "cuda":
        raise AssertionError(f"fit returned weights on {trained.device}")

    # a checkpoint of the run, reloaded, serves through K2 -> K1 -> K3
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "run.pt"
        save_checkpoint(path, model.weights(), opt.state_dict(),
                        step=3 + len(more), losses=losses)
        ck = load_checkpoint(path, device="cuda")
    for k, v in model.weights().as_dict().items():
        if not torch.equal(getattr(ck["weights"], k), v):
            raise AssertionError(f"checkpoint {k} differs after reloading")
    # the optimizer's state loads back into an optimizer on the card
    torch.optim.Adam(SRCNN.from_weights(ck["weights"]).parameters(), lr=1e-4,
                     eps=1e-8).load_state_dict(ck["optimizer"])
    frames = e.rng.integers(0, 256, (2, 270, 480, 3), dtype=np.uint8)
    out, _ = e.drive("upscale_bgr_batch with the reloaded trained weights",
                     lambda: upscale_bgr_batch(frames, 2.0, ck["weights"],
                                               "cuda"),
                     ("pre_upscale_fused", "srcnn_y_fused",
                      "merge_ycrcb_to_bgr_fused"))
    cpu_out = upscale_bgr_batch(frames, 2.0, ck["weights"].to("cpu"), "cpu")
    d = np.abs(out.astype(np.int32) - cpu_out.astype(np.int32))
    pre = upscale_bgr_batch(frames, 2.0, e.weights, "cuda")
    say(f"  vs the CPU pipeline with the same weights: max {d.max()} LSB, "
        f"(diff>1) {(d > 1).mean():.2e}; values that differ from the "
        f"pretrained weights' output {(out != pre).mean():.2e}")
    if out.shape != (2, 540, 960, 3) or d.max() > 2 or \
            (d > 1).mean() >= E2E_FRAC:
        raise AssertionError("serving the trained weights failed")


def mesh_of(n: int, **axes):
    """A mesh over the card named ``n`` times."""
    from srcnn_cpp_tpu_torch.parallel import make_mesh

    return make_mesh(devices=["cuda:0"] * n, **axes)


#: the meshes of phase 14, as (data, row, col)
MESHES = ((1, 4, 1), (2, 2, 1), (1, 2, 2))
#: phase 16's frame (H, W) and phase 19's planes (B, H, W)
FRAME_8K, SCALING_SHAPE = (2160, 3840), (4, 1080, 1920)


def phase_tiled_k1(e: Extra) -> None:
    from srcnn_cpp_tpu_torch.ops.cuda_srcnn import srcnn_y_fused
    from srcnn_cpp_tpu_torch.parallel import upscale_y_tiled

    say("phase 14: K1 tiled over (data, row, col) meshes of cuda:0 x 4 vs "
        "K1 on the whole plane, bit-equal")
    for y in (e.up[:, 0], border_batch()):
        mono = srcnn_y_fused(y, e.weights)
        for d, r, c in MESHES:
            mesh = mesh_of(4, data=d, row=r, col=c)
            tag = f"{list(y.shape)} on ({d},{r},{c})"
            got, n = e.drive(f"upscale_y_tiled {tag}",
                             lambda: upscale_y_tiled(y, e.weights, mesh),
                             ("srcnn_y_fused",))
            if n["srcnn_y_fused"] != 4:
                raise AssertionError(f"{tag}: {n['srcnn_y_fused']} K1 "
                                     "launches, not one per block")
            assert_equal(got, mono, f"{tag} vs K1")


def phase_tiled_k2_k3(e: Extra) -> None:
    from srcnn_cpp_tpu_torch.ops.cuda_merge import merge_ycrcb_to_bgr_fused
    from srcnn_cpp_tpu_torch.ops.cuda_resize import pre_upscale_fused
    from srcnn_cpp_tpu_torch.ops.cuda_srcnn import srcnn_y_fused
    from srcnn_cpp_tpu_torch.ops.resize import scaled_size
    from srcnn_cpp_tpu_torch.parallel import (merge_ycrcb_to_bgr_fused_rows,
                                              pre_upscale_fused_rows)

    say("phase 15: windowed K2 and tiled K3 vs K2 and K3 on the whole frame, "
        "bit-equal")
    x3 = u8((2, 3, 540, 96), 90)
    cases = [(e.x, scaled_size(IW, IH, s)[::-1], s)
             for s in (2.0, 1.5, 1.25, 0.75)] + [(x3, (1620, 288), 3.0)]
    for x, out_hw, s in cases:
        up = pre_upscale_fused(x, out_hw)
        y_sr = srcnn_y_fused(up[:, 0], e.weights)
        bgr = merge_ycrcb_to_bgr_fused(y_sr, up)
        for d, r, c in ((1, 3, 1), (2, 3, 1), (1, 3, 2)) + (
                ((1, 4, 1),) if s == 2.0 else ()):
            mesh = mesh_of(d * r * c, data=d, row=r, col=c)
            tag = f"x{s:g} {list(x.shape)} -> {list(out_hw)} on ({d},{r},{c})"
            got, n = e.drive(f"pre_upscale_fused_rows {tag}",
                             lambda: pre_upscale_fused_rows(x, out_hw, mesh),
                             ("pre_upscale_fused",))
            assert_equal(got, up, f"K2 {tag}")
            got, m = e.drive(f"merge_ycrcb_to_bgr_fused_rows {tag}",
                             lambda: merge_ycrcb_to_bgr_fused_rows(y_sr, up,
                                                                   mesh),
                             ("merge_ycrcb_to_bgr_fused",))
            assert_equal(got, bgr, f"K3 {tag}")
            if n["pre_upscale_fused"] != mesh.size or \
                    m["merge_ycrcb_to_bgr_fused"] != mesh.size:
                raise AssertionError(f"{tag}: not one launch per block")


def mesh_run(e: Extra, frame: np.ndarray, scale: float, mesh, name: str,
             over: str) -> dict:
    """``single_8k(mesh=...)`` against ``single_8k()`` on ``frame``.  Each
    is driven with the counts at 0: one launch of each of K2, K1 and K3 per
    block (one in all untiled), no plain call, the results bit-equal.  Then
    their times: host arrays in and out (median of 5), the device span of
    the planar pipeline against its blocks' (CUDA events, median of 10) and
    the profiler's device work, busy share and activities (5 calls).
    Returns the host-array medians in ms, by run name."""
    from srcnn_cpp_tpu_torch.configs import single_8k
    from srcnn_cpp_tpu_torch.kernel_ab import profile
    from srcnn_cpp_tpu_torch.ops.resize import scaled_size
    from srcnn_cpp_tpu_torch.parallel.tiling import split_blocks, upscale_blocks
    from srcnn_cpp_tpu_torch.pipeline import upscale_planar

    runs = {"unsharded": single_8k(e.weights, scale=scale),
            name: single_8k(e.weights, mesh=mesh, scale=scale)}
    outs = {}
    for run_name, run in runs.items():
        outs[run_name], n = e.drive(f"single_8k {run_name}",
                                    lambda: run(frame),
                                    ("pre_upscale_fused", "srcnn_y_fused",
                                     "merge_ycrcb_to_bgr_fused"))
        want = mesh.size if run_name == name else 1
        if any(n[k] != want for k in ("pre_upscale_fused", "srcnn_y_fused",
                                      "merge_ycrcb_to_bgr_fused")):
            raise AssertionError(f"single_8k {run_name}: launches {n}, not "
                                 f"{want} of each of K2, K1, K3")
    if not np.array_equal(outs[name], outs["unsharded"]):
        d = np.abs(outs[name].astype(int) - outs["unsharded"].astype(int))
        raise AssertionError(f"single_8k(mesh) differs: {(d > 0).sum()} "
                             f"values, max {d.max()}")
    say(f"  single_8k(mesh={name}) vs single_8k(): bit-equal")
    h, w = frame.shape[:2]
    ow, oh = scaled_size(w, h, scale)
    host = {}
    for run_name, run in runs.items():
        ts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(frame)
            ts.append((time.perf_counter() - t0) * 1e3)
        host[run_name] = statistics.median(ts)
    x = torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(frame, -1, 0)))[None].cuda()
    blocks = split_blocks(x, mesh)
    calls = {"unsharded": lambda: upscale_planar(x, e.weights, (oh, ow)),
             name: lambda: upscale_blocks(blocks, e.weights, (h, w), (oh, ow),
                                          mesh)}
    dev = {k: median_ms(f, 10) for k, f in calls.items()}
    prof = {k: profile(f, iters=5) for k, f in calls.items()}
    for run_name in runs:
        p = prof[run_name]
        top = sorted(p["kernels_ms_per_call"].items(), key=lambda kv: -kv[1])
        say(f"  single_8k {run_name}: host arrays in and out "
            f"{host[run_name]:.1f} ms (median of 5), device span "
            f"{dev[run_name]:.4f} ms (CUDA events, median of 10); profiler: "
            f"{p['device_ms_per_call']:.4f} ms of device work in a "
            f"{p['span_ms_per_call']:.4f} ms span (busy "
            f"{p['busy_share']:.3f}), {p['activities_per_call']:.0f} device "
            f"activities per call, most time: " + "; ".join(
                f"{k[:40]} {v:.4f} ms" for k, v in top[:4]) + f" ({e.gpu})")
    say(f"  tiling over {over} on one card: device span "
        f"{dev[name] / dev['unsharded'] - 1:+.2%}, host arrays "
        f"{host[name] / host['unsharded'] - 1:+.2%}")
    return host


def phase_single_8k_mesh(e: Extra) -> dict:
    (h, w), (oh, ow) = FRAME_8K, (2 * FRAME_8K[0], 2 * FRAME_8K[1])
    say(f"phase 16: configs.single_8k(mesh=row 4 over cuda:0) {h}x{w} -> "
        f"{oh}x{ow} vs single_8k(), bit-equal")
    mesh = mesh_of(4, data=1, row=4)
    frame = e.rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    host = mesh_run(e, frame, 2.0, mesh, "row 4", "4 row blocks")
    return {(FRAME_8K, 2.0, (1, 4, 1)): host["row 4"]}


#: phase 16b's uneven splits: frame (H, W), scale, mesh (data, row, col)
UNEVEN = (((2160, 3840), 1.25, (1, 8, 1)),    # 2,700 output rows over 8
          ((1080, 1920), 1.5, (1, 8, 1)),     # 1,620 output rows over 8
          ((768, 1366), 1.5, (1, 2, 2)))      # 2,049 output columns over 2


def phase_single_8k_uneven(e: Extra) -> dict:
    from srcnn_cpp_tpu_torch.ops.resize import scaled_size

    say("phase 16b: configs.single_8k(mesh=...) over cuda:0 where the mesh "
        "does not divide the output: uneven splits, bit-equal to "
        "single_8k()")
    host = {}
    for (h, w), scale, (d, r, c) in UNEVEN:
        ow, oh = scaled_size(w, h, scale)
        mesh = mesh_of(d * r * c, data=d, row=r, col=c)
        name = f"({d},{r},{c})"
        say(f"  {w}x{h} x{scale:g} -> {ow}x{oh} over {name}: output rows "
            f"{oh} % {r} = {oh % r}, columns {ow} % {c} = {ow % c}")
        frame = e.rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        host[(h, w), scale, (d, r, c)] = mesh_run(e, frame, scale, mesh, name,
                                                  f"{name} blocks")[name]
    return host


def phase_sharded_train(e: Extra) -> None:
    import itertools

    from srcnn_cpp_tpu_torch.models import SRCNN
    from srcnn_cpp_tpu_torch.train import (dataset_from_dir,
                                           iterate_minibatches,
                                           make_sharded_train_step,
                                           make_train_step, shard_batch)
    from srcnn_cpp_tpu_torch.weights import load_weights

    say("phase 17: make_sharded_train_step on (2,2,1) over cuda:0 vs "
        "make_train_step, batch 64 of 32x32 patches of tests/data/eval")
    x, t = dataset_from_dir(ROOT / "tests/data/eval", scale=2.0)
    batches = [(xb[:, :32, :32], tb[:, :32, :32]) for xb, tb in
               itertools.islice(iterate_minibatches(x, t, 64, seed=2), 3)]
    mesh = mesh_of(4, data=2, row=2)

    card_dev = e.weights.device

    def run(sharded: bool, device=card_dev, dtype=torch.float32, lr=1e-4):
        model = SRCNN.from_weights(device=device).to(dtype)
        opt = (torch.optim.Adam(model.parameters(), lr=lr, eps=1e-8) if lr
               else torch.optim.SGD(model.parameters(), lr=0.0))
        step = make_sharded_train_step(mesh, model, opt) if sharded \
            else make_train_step(model, opt)
        return model, step

    # gradients of the first batch (a step at learning rate 0 keeps them)
    grads = {}
    for sharded in (False, True):
        model, step = run(sharded, lr=0.0)
        xb, tb = batches[0]
        step(shard_batch(mesh, xb) if sharded else xb,
             shard_batch(mesh, tb) if sharded else tb)
        grads[sharded] = {k: p.grad.detach().double()
                          for k, p in model.named_parameters()}
    rel = {k: float((grads[True][k] - g).abs().max() / g.abs().max())
           for k, g in grads[False].items()}
    say("  gradients, sharded vs unsharded, of max |g|: " + ", ".join(
        f"{k} {v:.2e}" for k, v in rel.items()) + f" (bar {GRAD_REL})")
    if max(rel.values()) > GRAD_REL:
        raise AssertionError(f"sharded gradients differ: {rel}")
    # three Adam steps each, beside a float64 run on the CPU
    models, losses = {}, {}
    for name, sharded, dev, dt in (("sharded", True, card_dev, torch.float32),
                                   ("unsharded", False, card_dev,
                                    torch.float32),
                                   ("float64", False, "cpu", torch.float64)):
        models[name], step = run(sharded, dev, dt)
        losses[name] = [step(*(tuple(shard_batch(mesh, a) for a in b)
                               if sharded else b)) for b in batches]
    lrel = max(abs(a - b) / abs(b) for a, b in zip(losses["sharded"],
                                                   losses["unsharded"]))
    say(f"  losses: sharded {losses['sharded']}, unsharded "
        f"{losses['unsharded']}; max relative difference {lrel:.2e} (bar "
        f"{TRAIN_RTOL})")
    if not np.isfinite(losses["sharded"]).all() or lrel > TRAIN_RTOL:
        raise AssertionError("the sharded step's losses differ")
    ref, err = load_weights(), {}
    for name in ("sharded", "unsharded"):
        err[name] = 0.0
        for (k, p), pe in zip(models[name].named_parameters(),
                              models["float64"].parameters()):
            largest = (pe.detach() - getattr(ref, k)).abs().max()
            err[name] = max(err[name], float(
                (p.detach().cpu().double() - pe.detach()).abs().max()
                / largest.clamp_min(1e-30)))
    say(f"  weights after 3 steps vs the float64 run, of the largest "
        f"update: sharded {err['sharded']:.2e}, unsharded "
        f"{err['unsharded']:.2e} (bar: the unsharded + {UPDATE_REL})")
    if err["sharded"] > err["unsharded"] + UPDATE_REL:
        raise AssertionError("the sharded step's updates differ")


def two_processes(args: list[str], timeout: float) -> list[dict]:
    """Run two ranks of ``parallel.distributed`` with ``args``, each under
    ``timeout`` seconds; fail if either fails.  Returns their JSON lines."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "srcnn_cpp_tpu_torch.parallel.distributed",
             f"--init-method=file://{tmp}/rendezvous", "--world-size=2",
             f"--rank={r}", f"--timeout={timeout / 2:.0f}", *args],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for r, (p, (o, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} exited {p.returncode}:\n{o}\n"
                                 f"{err[-3000:]}")
    return [json.loads(next(ln for ln in o.splitlines()
                            if ln.startswith("{"))) for o, _ in outs]


def phase_two_processes(e: Extra) -> None:
    from srcnn_cpp_tpu_torch.parallel.distributed import run_train

    backends = [("gloo", "--local-devices=2", "two ranks on cuda:0")]
    if torch.cuda.device_count() >= 2:
        backends.append(("nccl", "--local-devices=2", "one card per rank"))
    say("phase 18: parallel.distributed in two processes, the rows of one "
        "frame over both (" + "; ".join(f"{b}: {w}" for b, _, w in backends)
        + ")")
    ref = run_train(3, (32, 32), mesh_of(4, data=1, row=4))
    for backend, local, where in backends:
        t0 = time.perf_counter()
        rows = two_processes([f"--backend={backend}", local, "--device=cuda",
                              "--frames=2", "--size=1920x1080", "--scale=2",
                              "--check"], 300)
        for r in rows:
            say(f"  {backend} rank {r['process']} of {r['processes']} on "
                f"{r['device']}, mesh {r['mesh']}: bitexact {r['bitexact']} "
                f"(max {r['max_abs_diff']} LSB), launches {r['launches']}, "
                f"plain calls {r['plain_calls']}, {r['fps']:.2f} fps "
                f"({e.gpu})")
            if not r["bitexact"] or min(r["launches"].values()) < 1 or \
                    max(r["plain_calls"].values()) > 0:
                raise AssertionError(f"{backend} rank {r['process']} failed")
        rows = two_processes([f"--backend={backend}", local, "--device=cuda",
                              "--train", "--train-steps=3", "--size=32x32"],
                             300)
        for r in rows:
            lrel = max(abs(a - b) / abs(b)
                       for a, b in zip(r["losses"], ref["losses"]))
            grel = abs(r["input_grad_sum"] - ref["input_grad_sum"]) / abs(
                ref["input_grad_sum"])
            say(f"  {backend} rank {r['process']} train: losses "
                f"{r['losses']} vs one process {ref['losses']} (max relative "
                f"{lrel:.2e}); input gradient sum {r['input_grad_sum']:.6g} "
                f"vs {ref['input_grad_sum']:.6g} ({grel:.2e})")
            if lrel > TRAIN_RTOL or grel > TRAIN_RTOL:
                raise AssertionError(f"{backend} two-process training differs")
        say(f"  {backend}: {time.perf_counter() - t0:.1f} s for both runs")
    if torch.cuda.device_count() < 2:
        say("  nccl: not run: NCCL refuses two ranks on one card (duplicate "
            "GPU) and this machine has 1; it needs one card per rank")


def phase_scaling(e: Extra) -> None:
    from srcnn_cpp_tpu_torch.parallel import scaling_efficiency

    b, h, w = SCALING_SHAPE
    say(f"phase 19: scaling_efficiency on cuda:0 named 1, 2 and 4 times, "
        f"{b}x{h}x{w}: one card, so this is tiling overhead, not scaling")
    r = scaling_efficiency(e.weights, (h, w), batch=b,
                           devices=["cuda:0"] * 4, iters=4)
    for n, mps in r["mps"].items():
        say(f"  {n} row block(s): {mps:.2f} MP/s, {mps / r['mps'][1]:.4f} of "
            f"one block ({e.gpu})")


#: the main path's kernels, as ``torch.profiler`` names them at x2
MAIN_KERNELS = ("pre_pass_kernel", "srcnn_conv_kernel", "merge_vec_kernel")
MAIN_WRAPPERS = ("pre_upscale_fused", "srcnn_y_fused", "merge_ycrcb_to_bgr_fused")


def trace_events(fn) -> tuple[int, list, dict]:
    """``(bytes of trace JSON, its events, the events of each of
    MAIN_KERNELS)`` of one ``utils.profiling.trace`` of ``fn()``; fails
    unless the trace names every kernel of the main path."""
    import tempfile

    from srcnn_cpp_tpu_torch.utils.profiling import trace

    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp) as logdir:
            fn()
        path = Path(logdir) / "trace.json"
        size = path.stat().st_size
        events = json.loads(path.read_text())["traceEvents"]
    found = {k: [ev for ev in events if k in ev.get("name", "")]
             for k in MAIN_KERNELS}
    missing = [k for k, v in found.items() if not v]
    if missing:
        raise AssertionError(f"the trace names none of {missing}")
    return size, events, found


def d2h_copies(events: list) -> list:
    return [ev for ev in events if ev.get("cat") == "gpu_memcpy"
            and "DtoH" in ev.get("name", "")]


def spans_named(events: list, name: str) -> list:
    return [ev for ev in events if ev.get("cat") == "user_annotation"
            and ev.get("name") == name]


def within(inner: dict, outer: dict) -> bool:
    """``inner``'s interval lies in ``outer``'s (trace microseconds)."""
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def phase_profiling(e: Extra, frames: np.ndarray) -> None:
    from srcnn_cpp_tpu_torch.pipeline import chunks, upscale_bgr_batch

    say(f"phase 20: utils.profiling on the main path, [{BATCH},{IH},{IW},3] "
        f"host arrays x{SCALE:g}")
    w = e.weights
    size, events, found = trace_events(
        lambda: upscale_bgr_batch(frames, SCALE, w, "cuda"))
    # between K2 and K1 the main path moves nothing through the host
    k2 = found["pre_pass_kernel"][0]
    k1 = found["srcnn_conv_kernel"][0]
    copies = [ev["name"] for ev in events if ev.get("cat") == "gpu_memcpy"
              and k2["ts"] < ev.get("ts", -1) < k1["ts"]]
    say(f"  trace(): device copies between K2 and K1: {copies or 'none'}")
    if any("DtoH" in c for c in copies):
        raise AssertionError("a device-to-host copy between K2 and K1")
    # and after each chunk's K3 it fetches that chunk's HWC result, the
    # chunks' copies adding up to the whole result
    parts = chunks(*frames.shape[:3])
    kernels = {k: sorted((ev for ev in v if ev.get("cat") == "kernel"),
                         key=lambda ev: ev["ts"]) for k, v in found.items()}
    k3s = kernels["merge_vec_kernel"]
    d2h = sorted(d2h_copies(events), key=lambda ev: ev["ts"])
    say("  trace(): device-to-host copies: " + (", ".join(
        f"{ev['name']} of {ev.get('args', {}).get('bytes')} bytes"
        for ev in d2h) or "none"))
    sizes = [(p.stop - p.start) * OH * OW * 3 for p in parts]
    if [ev.get("args", {}).get("bytes") for ev in d2h] != sizes \
            or len(k3s) != len(parts) or any(
                c["ts"] < k["ts"] + k["dur"] for c, k in zip(d2h, k3s)):
        raise AssertionError(f"expected {len(parts)} device-to-host copies "
                             f"of {sizes} bytes, each after its chunk's K3")
    # the program's spans share the device's clock: each copy is enqueued
    # in a fetch span, and each kernel's launch lies in a pipeline span
    fetch = spans_named(events, "srcnn.entry.fetch")
    pipe = spans_named(events, "srcnn.pipeline")
    if len(fetch) != len(parts) or len(pipe) != len(parts):
        raise AssertionError(f"expected {len(parts)} srcnn.entry.fetch and "
                             f"srcnn.pipeline spans, got {len(fetch)} and "
                             f"{len(pipe)}")
    launches = {ev["args"]["correlation"]: ev for ev in events
                if ev.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in ev.get("args", {})}

    def launched_in(ev, spans):
        launch = launches.get(ev.get("args", {}).get("correlation"))
        return launch is not None and any(within(launch, s) for s in spans)

    if not all(launched_in(c, fetch) for c in d2h):
        raise AssertionError("a device-to-host copy was enqueued outside "
                             "srcnn.entry.fetch")
    for k in ("pre_pass_kernel", "srcnn_conv_kernel", "merge_vec_kernel"):
        if not all(launched_in(ev, pipe) for ev in kernels[k]):
            raise AssertionError(f"a launch of {k} is not inside "
                                 f"srcnn.pipeline")
    busy = [ev for ev in events if ev.get("cat") == "kernel"]
    hidden = [c for c in d2h + h2d_copies(events) if any(
        k["ts"] < c["ts"] + c["dur"] and c["ts"] < k["ts"] + k["dur"]
        for k in busy)]
    say(f"  trace(): {len(parts)} chunks; K2, K1, K3 launched inside "
        f"srcnn.pipeline ({sum(s['dur'] for s in pipe):.1f} us of host "
        f"time); {len(hidden)} copies overlap a kernel")
    say(f"  trace(): {size} bytes of Chrome trace JSON, {len(events)} "
        f"events; " + "; ".join(
            f"{k}: {len(v)} event(s), {sum(ev.get('dur', 0) for ev in v):.1f}"
            f" us" for k, v in found.items()) + f" ({e.gpu})")


def phase_device_entry(e: Extra, frames: np.ndarray) -> None:
    from srcnn_cpp_tpu_torch.pipeline import upscale_bgr_batch, upscale_planar

    say(f"phase 21: upscale_bgr_batch on a CUDA tensor [{BATCH},{IH},{IW},3]"
        f" x{SCALE:g}: tensor in, tensor on the card out")
    w = e.weights
    xt = torch.from_numpy(frames).cuda()

    def entry():
        return upscale_bgr_batch(xt, SCALE, w, "cuda")

    out, launches = e.drive("upscale_bgr_batch(CUDA tensor)", entry,
                            MAIN_WRAPPERS)
    if any(launches[n] != 1 for n in MAIN_WRAPPERS):
        raise AssertionError("expected one launch of each of K2, K1, K3")
    if not isinstance(out, torch.Tensor) or out.device.type != "cuda" \
            or out.shape != (BATCH, OH, OW, 3) or out.dtype != torch.uint8:
        raise AssertionError(f"expected a CUDA u8 tensor [{BATCH},{OH},{OW},"
                             f"3], got {type(out).__name__} "
                             f"{getattr(out, 'device', '')}")
    ref = upscale_planar(xt.permute(0, 3, 1, 2).contiguous(), w,
                         (OH, OW)).permute(0, 2, 3, 1)
    assert_equal(out, ref, "vs upscale_planar(x.permute(0, 3, 1, 2)"
                 ".contiguous()).permute(0, 2, 3, 1)")
    _, events, _ = trace_events(entry)
    d2h = d2h_copies(events)
    say(f"  trace(): device-to-host copies: "
        f"{[ev['name'] for ev in d2h] or 'none'}")
    if d2h:
        raise AssertionError("the CUDA-tensor call copied to the host")
    entry_ms, planar_ms = ab_ms(entry, lambda: upscale_planar(e.x, w,
                                                              (OH, OW)), 10)
    mpix = BATCH * OH * OW / 1e6
    say(f"  CUDA events, in turns: upscale_bgr_batch(CUDA tensor) "
        f"{entry_ms:.4f} ms, {mpix / (entry_ms / 1e3):.2f} MP/s; "
        f"upscale_planar {planar_ms:.4f} ms, {mpix / (planar_ms / 1e3):.2f} "
        f"MP/s ({e.gpu})")



def h2d_copies(events: list) -> list:
    return [ev for ev in events if ev.get("cat") == "gpu_memcpy"
            and "HtoD" in ev.get("name", "")]


def phase_stream_tensors(e: Extra, synthetic_fps: float) -> None:
    from srcnn_cpp_tpu_torch.stream import StreamUpscaler

    n, batch, depth = 12, 4, 3
    say(f"phase 22: StreamUpscaler(2.0, batch={batch}, depth={depth}) fed "
        f"{n} x 1080x1920 CUDA tensors vs the same frames as host arrays")
    frames = e.rng.integers(0, 256, (n, 1080, 1920, 3), dtype=np.uint8)
    tensors = list(torch.from_numpy(frames).cuda().unbind(0))
    up = StreamUpscaler(2.0, e.weights, depth=depth, batch=batch)

    def stream(feed):
        outs = [o for f in feed if (o := up.push(f)) is not None]
        return outs + list(up.drain())

    ref = stream(list(frames))
    outs, launches = e.drive("stream fed CUDA tensors",
                             lambda: stream(tensors), MAIN_WRAPPERS)
    if any(launches[k] != n // batch for k in MAIN_WRAPPERS):
        raise AssertionError(f"expected {n // batch} launches of each of K2, "
                             f"K1, K3, got {launches}")
    if len(outs) != n or not all(
            isinstance(o, np.ndarray) and o.flags.c_contiguous
            and np.array_equal(o, r) for o, r in zip(outs, ref)):
        raise AssertionError("the CUDA-tensor feed differs from the "
                             "host-array feed")
    say(f"  {n} frames: host arrays out, bit-equal to the host-array feed, "
        "in order")
    _, events, _ = trace_events(lambda: stream(tensors[:batch]))
    h2d = h2d_copies(events)
    say(f"  trace() of one dispatch: host-to-device copies "
        f"{[ev['name'] for ev in h2d] or 'none'}, device-to-host copies "
        f"{len(d2h_copies(events))} (into the pinned output)")
    if h2d:
        raise AssertionError("a dispatch of CUDA frames copied from the host")
    # the rate: the 12 frames cycled to 96, 24 dispatches, so the ring of
    # depth + 1 slots wraps 6 times with depth dispatches in flight
    long = n * 8
    feeds = {"host arrays": [frames[i % n] for i in range(long)],
             "CUDA tensors": [tensors[i % n] for i in range(long)]}
    secs = {k: [] for k in feeds}
    for k in ("host arrays", "CUDA tensors", "CUDA tensors",
              "host arrays") * 3:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stream(feeds[k])
        secs[k].append(time.perf_counter() - t0)
    say(f"  fps, medians of 6 runs of {long} frames ({long // batch} "
        f"dispatches), in turns: " + ", ".join(
            f"{k} {long / statistics.median(v):.2f}"
            for k, v in secs.items())
        + f"; phase 10 run_synthetic (host frames, batch 4) "
        f"{synthetic_fps:.2f} ({e.gpu})")


#: phase 23's geometries: phase 16's and one of phase 16b's
MESH_TENSOR = ((FRAME_8K, 2.0, (1, 4, 1)), ((1080, 1920), 1.5, (1, 8, 1)))


def phase_single_8k_mesh_tensor(e: Extra, host_ms: dict) -> None:
    from srcnn_cpp_tpu_torch.configs import single_8k
    from srcnn_cpp_tpu_torch.ops.resize import scaled_size
    from srcnn_cpp_tpu_torch.weights import weights_on

    say("phase 23: configs.single_8k(mesh=...) over cuda:0 on a CUDA tensor: "
        "a CUDA tensor out, bit-equal to the host-array call and to "
        "single_8k()")
    weight_bytes = {t.numel() * t.element_size()
                    for t in weights_on(None, "cpu").as_dict().values()}
    for (h, w), scale, (d, r, c) in MESH_TENSOR:
        ow, oh = scaled_size(w, h, scale)
        mesh = mesh_of(d * r * c, data=d, row=r, col=c)
        tag = f"{w}x{h} x{scale:g} over ({d},{r},{c})"
        frame = e.rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        xt = torch.from_numpy(frame).cuda()
        # the default weights, kept on the CPU by the runner
        run = single_8k(mesh=mesh, scale=scale)
        out, launches = e.drive(f"single_8k(mesh) {tag}, CUDA tensor",
                                lambda: run(xt), MAIN_WRAPPERS)
        if any(launches[k] != mesh.size for k in MAIN_WRAPPERS):
            raise AssertionError(f"{tag}: launches {launches}, not one of "
                                 "each of K2, K1, K3 per block")
        if not isinstance(out, torch.Tensor) or out.device != xt.device \
                or out.shape != (oh, ow, 3) or not out.is_contiguous():
            raise AssertionError(f"{tag}: expected a contiguous CUDA tensor "
                                 f"[{oh},{ow},3], got {type(out).__name__} "
                                 f"{getattr(out, 'device', '')}")
        host_out = run(frame)
        if not isinstance(host_out, np.ndarray):
            raise AssertionError(f"{tag}: a host array in gave "
                                 f"{type(host_out).__name__}")
        assert_equal(out, torch.from_numpy(host_out).cuda(),
                     f"{tag} vs the host-array call")
        assert_equal(out, single_8k(e.weights, scale=scale)(xt),
                     f"{tag} vs single_8k() on the tensor")
        _, events, _ = trace_events(lambda: run(xt))
        d2h, h2d = d2h_copies(events), h2d_copies(events)
        sizes = [ev.get("args", {}).get("bytes") for ev in h2d]
        say(f"  trace(): {len(d2h)} device-to-host copies, {len(h2d)} "
            f"host-to-device copies ({sum(sizes)} bytes: {sizes}; the "
            f"weights' tensors are {sorted(weight_bytes)} bytes)")
        if d2h or any(b not in weight_bytes for b in sizes):
            raise AssertionError(f"{tag}: frame or block bytes crossed "
                                 "between host and card")
        tensor_ms = median_ms(lambda: run(xt), 5)
        key = ((h, w), scale, (d, r, c))
        say(f"  {tag}: CUDA tensor in and out {tensor_ms:.4f} ms (CUDA "
            f"events, median of 5); host arrays in and out "
            f"{host_ms[key]:.1f} ms (phase 16/16b, median of 5) ({e.gpu})")


def phase_process_srcnn(e: Extra) -> None:
    from srcnn_cpp_tpu_torch.imageio import conv_image, imread_bgr
    from srcnn_cpp_tpu_torch.ops.color import bgr2ycrcb_u8
    from srcnn_cpp_tpu_torch.ops.cuda_srcnn import srcnn_y_fused
    from srcnn_cpp_tpu_torch.ops.resize import resize_bicubic_u8, scaled_size
    from srcnn_cpp_tpu_torch.pipeline import process_srcnn, upscale_bgr

    bf = imread_bgr(ROOT / "tests/data/eval/butterfly.png")
    if bf is None:
        raise AssertionError("no cv2 or PIL to decode butterfly.png")
    h, w = bf.shape[:2]
    ow, oh = scaled_size(w, h, 2.0)
    say(f"phase 24: process_srcnn on the card, butterfly {w}x{h} x2 at "
        "d = 1, 2, 3, 4 vs the port's card composition and its CPU run")
    rgb = np.ascontiguousarray(bf[..., ::-1])
    r, g, b = (rgb[..., i].astype(np.uint16) for i in range(3))
    alpha = e.rng.integers(0, 256, (h, w, 1), dtype=np.uint8)
    bufs = {
        1: bgr2ycrcb_u8(torch.from_numpy(bf))[..., 0].numpy().reshape(-1),
        2: ((r >> 3) << 11 | (g >> 2) << 5 | (b >> 3)).view(np.uint8)
        .reshape(-1),
        3: rgb.reshape(-1),
        4: np.concatenate([rgb, alpha], axis=-1).reshape(-1)}
    cpu_weights = e.weights.to("cpu")
    for d, buf in bufs.items():
        needs = ("srcnn_y_fused",) if d == 1 else MAIN_WRAPPERS
        (got, size), launches = e.drive(
            f"process_srcnn d={d}",
            lambda: process_srcnn(buf, w, h, d, 2.0, e.weights, "cuda"),
            needs)
        if any(launches[k] != (k in needs) for k in launches):
            raise AssertionError(f"d={d}: launches {launches}, expected one "
                                 f"of each of {needs} and no other")
        c = 3 if d == 2 else d
        if size != ow * oh * c or got.shape != (size,):
            raise AssertionError(f"d={d}: out_size {size}, not {ow * oh * c}")
        if d == 1:
            want = srcnn_y_fused(resize_bicubic_u8(
                torch.from_numpy(bufs[1].reshape(h, w)).cuda(), (oh, ow)),
                e.weights).cpu().numpy().reshape(-1)
        else:
            src = conv_image(buf, w, h, 2) if d == 2 else rgb
            want = upscale_bgr(src[..., ::-1], 2.0, e.weights, "cuda")
            want = want[..., ::-1]
        out = got.reshape(oh, ow, c) if d > 1 else got
        if not np.array_equal(out[..., :3] if d == 4 else out, want):
            raise AssertionError(f"d={d}: differs from the card composition")
        cpu, _ = process_srcnn(buf, w, h, d, 2.0, cpu_weights, "cpu")
        diff = np.abs(got.astype(np.int32) - cpu.astype(np.int32))
        bar = 1 if d == 1 else 2
        say(f"  d={d}: out_size {size}, bit-equal to the card composition; "
            f"vs the CPU run max {diff.max()} LSB, (diff>1) "
            f"{(diff > 1).mean():.2e}, (diff>0) {(diff > 0).mean():.2e}")
        if diff.max() > bar or (diff > 1).mean() >= E2E_FRAC:
            raise AssertionError(f"d={d}: the card run misses the gate "
                                 "against the CPU run")
        if d == 4:
            assert_equal(torch.from_numpy(out[..., 3].copy()),
                         torch.from_numpy(cpu.reshape(oh, ow, 4)[..., 3]
                                          .copy()),
                         "d=4 alpha vs the CPU run")


def phase_vdsr(e: Extra, launches: dict, max_err: dict, ms: dict,
               plain_ms: dict, bounds: dict) -> None:
    """The VDSR chain at the shapes of the benchmark's VDSR cell: a batch
    of 8 frames of 1080x1920 through ``upscale_planar`` at x2."""
    from srcnn_cpp_tpu_torch.ops.cuda_merge import merge_ycrcb_to_bgr_fused
    from srcnn_cpp_tpu_torch.ops.cuda_resize import pre_upscale_fused
    from srcnn_cpp_tpu_torch.ops.cuda_swinir import probe_counts
    from srcnn_cpp_tpu_torch.ops.cuda_vdsr import vdsr_y_fused, vdsr_y_plain
    from srcnn_cpp_tpu_torch.pipeline import upscale_planar
    from srcnn_cpp_tpu_torch.utils.profiling import kernel_counters
    from srcnn_cpp_tpu_torch.weights import load_vdsr_weights

    b, h, w = 8, 1080, 1920
    oh, ow = 2 * h, 2 * w
    say(f"phase 25: VDSR vdsr_y_fused vs vdsr_y_plain (TF32 off), "
        f"upscale_planar on [{b},3,{h},{w}] -> [{b},3,{oh},{ow}]")
    weights = load_vdsr_weights(VDSR_NPZ, device="cuda")
    x = u8((b, 3, h, w), 60)
    out, got = e.drive(
        "upscale_planar with VDSR weights",
        lambda: upscale_planar(x, weights, (oh, ow)),
        ("pre_upscale_fused", "vdsr_y_fused", "merge_ycrcb_to_bgr_fused"))
    if got["vdsr_y_fused"] != 1 or got["srcnn_y_fused"]:
        raise AssertionError("upscale_planar did not run the VDSR chain "
                             "once and K1 never")
    launches["vdsr_y_fused"] = got["vdsr_y_fused"]
    up = pre_upscale_fused(x, (oh, ow))
    y = vdsr_y_fused(up[:, 0], weights)
    assert_equal(out, merge_ycrcb_to_bgr_fused(y, up),
                 "upscale_planar vs K2 -> vdsr_y_fused -> K3")
    err = 0
    for i in range(b):
        err = max(err, lsb_close(y[i], vdsr_y_plain(up[i, 0], weights),
                                 f"plane {i} of {b} [{oh},{ow}]"))
    max_err["vdsr_y_fused"] = err
    # traced, the chain runs probed: bit-equal, and counted as planned
    kernel_counters(reset=True)
    probed = []
    kernels_named(lambda: probed.append(vdsr_y_fused(up[:, 0], weights)),
                  "vdsr_")
    assert_equal(probed[0], y, "vdsr_y_fused traced vs untraced")
    check_counters(kernel_counters(reset=True), probe_counts(
        {("conv3x3", "vdsr"): len(weights.layers) - 2}, b, oh, ow),
        f"a call of {b} planes of {oh}x{ow}")

    def plain():
        for i in range(b):
            vdsr_y_plain(up[i, 0], weights)

    name = "vdsr_y_fused"
    ms[name], plain_ms[name] = ab_ms(lambda: vdsr_y_fused(up[:, 0], weights),
                                     plain, 2)
    npix = b * oh * ow
    macs = sum(wt.numel() for wt, _ in weights.layers)
    # bytes: Y in, Y' out; operations: the network's MACs at dense TF32
    bounds[name] = bound(2.0 * npix, 2.0 * macs * npix, TF32_FLOPS)
    say(f"  {name}: {ms[name]:.2f} ms, plain {plain_ms[name]:.2f} ms, bound "
        f"{bounds[name][0]:.2f} ms ({bounds[name][1]}); a frame "
        f"{ms[name] / b:.2f} ms against {bounds[name][0] / b:.2f}; "
        f"{2 * macs * npix / (ms[name] * 1e-3) / 1e12:.1f} TFLOP/s of "
        f"{TF32_FLOPS / 1e12:.0f} (dense TF32), {macs} MACs a pixel "
        f"({e.gpu})")


def check_counters(found: dict, expect: dict, what: str) -> None:
    """Print the GEMM bodies' stall counters of a traced run
    (``utils.profiling.kernel_counters``) by kind: cycles of a unit (of one
    consumer warpgroup), of them waiting on ``full`` and in the epilogue;
    the producer's cycles filling a stage and waiting on ``empty`` a
    stage.  Fails unless the kinds, launches, units and stages are
    ``expect``'s (``{(body, kind): (launches, units, stages)}``) and every
    wait lies inside its units' cycles."""
    from srcnn_cpp_tpu_torch.ops.cuda_swinir import probe_tally

    got = {(body, kind): c for body, kinds in found.items()
           for kind, c in kinds.items()}
    for (body, kind), c in sorted(got.items()):
        u, st = 2 * c["units"], c["stages"]
        say(f"  counters {body}.{kind} ({what}): {c['launches']} launches, "
            f"{c['units']} units, {st} stages; a unit "
            f"{c['unit_cycles'] / u:,.0f} cycles, waiting on full "
            f"{c['full_wait_cycles'] / u:,.0f}, "
            f"epilogue {c['epilogue_cycles'] / u:,.0f}; the producer a stage: "
            f"fill {c['fill_cycles'] / st:,.0f}, waiting on empty "
            f"{c['empty_wait_cycles'] / st:,.0f}")
    counts = probe_tally(found)
    if counts != expect:
        raise AssertionError(f"counters {counts}, the schedule's {expect}")


def kernels_named(fn, part: str) -> list[str]:
    """The names of the kernels of a ``utils.profiling.trace`` of ``fn()``
    whose name holds ``part``, in the order they started."""
    import tempfile

    from srcnn_cpp_tpu_torch.utils.profiling import trace

    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp) as logdir:
            fn()
        events = json.loads((Path(logdir) / "trace.json").read_text())
    found = [ev for ev in events["traceEvents"]
             if ev.get("cat") == "kernel" and part in ev.get("name", "")]
    return [ev["name"] for ev in sorted(found, key=lambda e: float(e["ts"]))]


def phase_rcan(e: Extra, launches: dict, max_err: dict, ms: dict,
               plain_ms: dict, bounds: dict) -> None:
    """RCAN x2 at the shapes of the benchmark's RCAN cell: a batch of 4
    frames of 1080x1920 through ``upscale_planar`` at x2."""
    from srcnn_cpp_tpu_torch.ops.cuda_rcan import (launch_schedule,
                                                   probed_kinds, rcan_fused,
                                                   rcan_plain, rcan_plan)
    from srcnn_cpp_tpu_torch.ops.cuda_swinir import probe_counts
    from srcnn_cpp_tpu_torch.pipeline import upscale_planar
    from srcnn_cpp_tpu_torch.utils.profiling import kernel_counters
    from srcnn_cpp_tpu_torch.weights import load_rcan_weights

    b, h, w = 4, 1080, 1920
    oh, ow = 2 * h, 2 * w
    say(f"phase 26: RCAN rcan_fused vs rcan_plain (TF32 off), "
        f"upscale_planar on [{b},3,{h},{w}] -> [{b},3,{oh},{ow}]")
    weights = load_rcan_weights(RCAN_RECIPE, device="cuda")
    # the benchmark's frames (portbench/frames.py): the limits were read on
    # them, and uniform noise would clamp a large share of RCAN's output
    from portbench.frames import make

    x = make(SEED + 26, b, (h, w), "cuda").permute(0, 3, 1, 2).contiguous()
    out, got = e.drive("upscale_planar with RCAN weights",
                       lambda: upscale_planar(x, weights, (oh, ow)),
                       ("rcan_fused",))
    if got["rcan_fused"] != 1 or got["pre_upscale_fused"] \
            or got["srcnn_y_fused"] or got["merge_ycrcb_to_bgr_fused"]:
        raise AssertionError("upscale_planar did not run RCAN once and K2, "
                             "K1, K3 never")
    launches["rcan_fused"] = got["rcan_fused"]
    err, off = 0, 0
    for i in range(b):
        d = diff(out[i], rcan_plain(x[i:i + 1], weights)[0])
        mx, frac = int(d.max()), float((d > 0).float().mean())
        say(f"  frame {i} of {b} [3,{oh},{ow}]: max {mx} LSB, differing "
            f"fraction {frac:.3e}")
        if mx > 1 or frac >= K1_FRAC:
            raise AssertionError(f"RCAN frame {i}: max {mx}, frac {frac}")
        err, off = max(err, mx), max(off, frac)
    max_err["rcan_fused"] = err
    g, k = weights.groups, weights.blocks
    kernels = b * len(launch_schedule(g, k))
    kernel_counters(reset=True)
    probed = []
    traced = kernels_named(
        lambda: probed.append(rcan_fused(x, weights, (oh, ow))), "rcan_")
    assert_equal(probed[0], out, "rcan_fused traced vs untraced")
    check_counters(kernel_counters(reset=True), probe_counts(
        probed_kinds(g, k), b, h, w), f"a call of {b} frames of {h}x{w}")
    ca = sorted({n for n in traced if "rcan_ca_" in n})
    say(f"  trace of one call: {len(traced)} RCAN kernels ({kernels} "
        f"planned, {kernels // b} a frame), CA kernels {ca or 'none'}")
    if ca or len(traced) != kernels:
        raise AssertionError(f"RCAN ran {len(traced)} kernels, {ca} among "
                             f"them; {kernels} planned and no rcan_ca_*")

    def plain():
        for i in range(b):
            rcan_plain(x[i:i + 1], weights)

    name = "rcan_fused"
    ms[name], plain_ms[name] = ab_ms(
        lambda: rcan_fused(x, weights, (oh, ow)), plain, 2)
    npix = b * oh * ow
    from portbench.reference.rcan import macs_per_pixel

    macs = macs_per_pixel({k: tuple(v.shape)
                           for k, v in weights.as_dict().items()})
    # bytes: BGR in, BGR out; operations: the network's MACs at dense TF32
    bounds[name] = bound(3.0 * b * h * w + 3.0 * npix, 2.0 * macs * npix,
                         TF32_FLOPS)
    plan = rcan_plan(h, w, torch.cuda.get_device_properties(0)
                     .multi_processor_count)
    say(f"  {name}: {ms[name]:.2f} ms, plain {plain_ms[name]:.2f} ms, bound "
        f"{bounds[name][0]:.2f} ms ({bounds[name][1]}); a frame "
        f"{ms[name] / b:.2f} ms against {bounds[name][0] / b:.2f}; "
        f"{2 * macs * npix / (ms[name] * 1e-3) / 1e12:.1f} TFLOP/s of "
        f"{TF32_FLOPS / 1e12:.0f} (dense TF32), {macs} MACs an output "
        f"pixel; max {err} LSB, share off {off:.3e} at most a frame; 1 C "
        f"call, {kernels} kernels a call; workspace "
        f"{4 * plan['workspace_floats'] / 1e9:.2f} GB ({e.gpu})")



def phase_swinir(e: Extra, launches: dict, max_err: dict, ms: dict,
                 plain_ms: dict, bounds: dict) -> None:
    """SwinIR x2 at the frame size of the benchmark's SwinIR cell: a batch
    of 2 frames of 1080x1920 through ``upscale_planar`` at x2."""
    from srcnn_cpp_tpu_torch.ops.cuda_swinir import (gemm_launches,
                                                     launch_schedule,
                                                     probe_counts,
                                                     probed_kinds,
                                                     swinir_fused,
                                                     swinir_plain,
                                                     swinir_plan)
    from srcnn_cpp_tpu_torch.pipeline import upscale_planar
    from srcnn_cpp_tpu_torch.utils.profiling import kernel_counters
    from srcnn_cpp_tpu_torch.weights import load_swinir_weights

    b, h, w = 2, 1080, 1920
    oh, ow = 2 * h, 2 * w
    say(f"phase 27: SwinIR swinir_fused vs swinir_plain (TF32 off), "
        f"upscale_planar on [{b},3,{h},{w}] -> [{b},3,{oh},{ow}]")
    weights = load_swinir_weights(SWINIR_RECIPE, device="cuda")
    from portbench.frames import make

    x = make(SEED + 27, b, (h, w), "cuda").permute(0, 3, 1, 2).contiguous()
    staged = swinir_fused.staged_epilogues
    out, got = e.drive("upscale_planar with SwinIR weights",
                       lambda: upscale_planar(x, weights, (oh, ow)),
                       ("swinir_fused",))
    if got["swinir_fused"] != 1 or got["pre_upscale_fused"] \
            or got["srcnn_y_fused"] or got["merge_ycrcb_to_bgr_fused"]:
        raise AssertionError("upscale_planar did not run SwinIR once and "
                             "K2, K1, K3 never")
    staged = swinir_fused.staged_epilogues - staged
    say(f"  staged epilogues: {staged} GEMM launches of {b} frames "
        f"({staged // b} a frame)")
    if staged != b * gemm_launches(weights.groups, weights.depth):
        raise AssertionError(f"SwinIR staged {staged} epilogues, not every "
                             f"GEMM launch's")
    launches["swinir_fused"] = got["swinir_fused"]
    err, off = 0, 0
    for i in range(b):
        d = diff(out[i], swinir_plain(x[i:i + 1], weights)[0])
        mx, frac = int(d.max()), float((d > 0).float().mean())
        say(f"  frame {i} of {b} [3,{oh},{ow}]: max {mx} LSB, differing "
            f"fraction {frac:.3e}")
        if mx > 1 or frac >= K1_FRAC:
            raise AssertionError(f"SwinIR frame {i}: max {mx}, frac {frac}")
        err, off = max(err, mx), max(off, frac)
    max_err["swinir_fused"] = err
    # traced, both GEMM bodies run probed: bit-equal, and counted as
    # planned (the table of PERF.md, section 6)
    kernel_counters(reset=True)
    probed = []
    kernels_named(lambda: probed.append(swinir_fused(x, weights, (oh, ow))),
                  "swin_stl_")
    assert_equal(probed[0], out, "swinir_fused traced vs untraced")
    check_counters(kernel_counters(reset=True), probe_counts(
        probed_kinds(weights.groups, weights.depth), b, h, w),
        f"a call of {b} frames of {h}x{w}")
    kernels = b * len(launch_schedule(weights.groups, weights.depth))
    # the launches of a call do not depend on the frame size: counted on 2
    # frames of 64x96.  In this process CUPTI lost the first 2 kernels of a
    # traced call (5 at 1080p) after the lead-in, in every trace, so the
    # trace holds two calls, and the second one's kernels, in time order,
    # must be the plan's
    small = x[:, :, :64, :96].contiguous()
    sched = [k for k, _ in launch_schedule(weights.groups, weights.depth)] * b

    def two_calls():
        swinir_fused(small, weights, (128, 192))
        torch.cuda.synchronize()
        swinir_fused(small, weights, (128, 192))

    traced = kernels_named(two_calls, "_kernel")
    last = traced[-kernels:]
    stl = sum("swin_stl_" in n for n in last)
    say(f"  trace of two calls of 2 frames of 64x96: {len(traced)} kernels "
        f"({2 * kernels} planned, {kernels // b} a frame), the second "
        f"call's {stl} named swin_stl_*")
    if len(traced) > 2 * kernels or len(last) != kernels or not all(
            k in n for k, n in zip(sched, last)):
        raise AssertionError(f"SwinIR's second call ran {len(last)} "
                             f"kernels, not the {kernels} planned in order")

    def plain():
        for i in range(b):
            swinir_plain(x[i:i + 1], weights)

    name = "swinir_fused"
    ms[name], plain_ms[name] = ab_ms(
        lambda: swinir_fused(x, weights, (oh, ow)), plain, 1)
    npix = b * oh * ow
    from portbench.reference.swinir import macs_per_pixel

    macs = macs_per_pixel({k: tuple(v.shape)
                           for k, v in weights.as_dict().items()})
    # bytes: BGR in, BGR out; operations: the network's MACs at dense TF32
    bounds[name] = bound(3.0 * b * h * w + 3.0 * npix, 2.0 * macs * npix,
                         TF32_FLOPS)
    plan = swinir_plan(h, w, torch.cuda.get_device_properties(0)
                       .multi_processor_count)
    say(f"  {name}: {ms[name]:.2f} ms, plain {plain_ms[name]:.2f} ms, bound "
        f"{bounds[name][0]:.2f} ms ({bounds[name][1]}); a frame "
        f"{ms[name] / b:.2f} ms against {bounds[name][0] / b:.2f}; "
        f"{2 * macs * npix / (ms[name] * 1e-3) / 1e12:.1f} TFLOP/s of "
        f"{TF32_FLOPS / 1e12:.0f} (dense TF32), {macs} MACs an output "
        f"pixel; max {err} LSB, share off {off:.3e} at most a frame; 1 C "
        f"call, {kernels} kernels a call; workspace "
        f"{4 * plan['workspace_floats'] / 1e9:.2f} GB ({e.gpu})")


if __name__ == "__main__":
    sys.exit(main())
