"""Set5/Set14-style evaluation harness (the reference's implied protocol).

The port of ``srcnn_cpp_tpu/evaluate.py``.  The reference documents its
evaluation recipe in Pictures/Resize.m: bicubic-downscale a ground-truth
image by 1/scale, super-resolve it back, and compare — the standard SRCNN
protocol (Dong et al. 2014).  This module automates it for any directory of
images:

    python -m srcnn_cpp_tpu_torch.evaluate --scale=2 [--device=cuda|cpu] <dir-or-image>...

It prints per-image and mean PSNR/SSIM on the Y channel (the convention SR
papers use), for both plain bicubic and SRCNN, plus the bicubic->SRCNN
gain, with a border of ``ceil(scale)`` px shaved, as in the original SRCNN
evaluation.  The super-resolution runs on ``--device`` (default ``cuda``:
the pipeline's CUDA kernels; ``cpu``: their plain versions); without a GPU,
``cuda`` is an error.  Degradation, color conversion and metrics run on the
host.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import numpy as np
import torch

from .cli import DEVICES, cuda_missing, device_name
from .imageio import decode_provenance, imread_bgr
from .ops.color import bgr2ycrcb_u8_planar, ycrcb2bgr_u8_planar
from .ops.resize import resize_separable
from .ops.resize_tables import resize_bicubic_u8_np
from .utils.metrics import psnr, ssim
from .weights import load_weights

_PROG = "srcnn-torch-eval"
#: the decoder that minted the recorded EVAL.md numbers (JPEG decode
#: differs between decoders, shifting PSNR in the 3rd decimal)
EVAL_DECODE_PROVENANCE = {"decoder": "cv2", "version": "5.0.0"}

_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".webp"}


def _collect(paths) -> list[Path]:
    out = []
    for p in map(Path, paths):
        if p.is_dir():
            out += sorted(q for q in p.iterdir() if q.suffix.lower() in _EXTS)
        elif p.suffix.lower() in _EXTS:
            out.append(p)
    return out


def _convert(fn, img: np.ndarray) -> np.ndarray:
    """An HWC uint8 image through a planar color op of :mod:`.ops.color`,
    on CPU tensors (bit-exact with OpenCV's uint8 conversion)."""
    planar = torch.from_numpy(np.ascontiguousarray(np.moveaxis(img, -1, 0)))
    return np.ascontiguousarray(np.moveaxis(fn(planar).numpy(), 0, -1))


def degrade_bgr(bgr: np.ndarray, scale: float):
    """Resize.m degradation: crop GT + MATLAB-imresize-bicubic downscale.

    Crops so the low-res size recovers the crop exactly under the float
    rule, then downscales each YCrCb plane with the Keys a=-0.5 kernel,
    anti-aliased (MATLAB ``imresize(gnd, 1/scale, 'bicubic')``,
    reference Pictures/Resize.m:1-3).  NOT OpenCV INTER_CUBIC, which skips
    the anti-alias widening — the model was trained on imresize degradation
    and loses its gain under aliased inputs.

    Returns ``(lr_bgr, gt_cropped)``.
    """
    h, w = bgr.shape[:2]
    ch = int(math.floor(h / scale) * scale)
    cw = int(math.floor(w / scale) * scale)
    gt = bgr[:ch, :cw]
    lh, lw = int(round(ch / scale)), int(round(cw / scale))
    planar = torch.from_numpy(np.ascontiguousarray(np.moveaxis(gt, -1, 0)))
    lr = resize_separable(bgr2ycrcb_u8_planar(planar), (lh, lw),
                          "cubic_matlab")
    lr = torch.round(lr).clamp(0, 255).to(torch.uint8)
    lr_bgr = ycrcb2bgr_u8_planar(lr).numpy()
    return np.ascontiguousarray(np.moveaxis(lr_bgr, 0, -1)), gt


def evaluate_image(bgr: np.ndarray, scale: float, weights=None,
                   device="cuda") -> dict:
    """One image through the Resize.m protocol; returns Y-channel metrics.

    The super-resolution runs on ``device``; everything else on the host.
    """
    from .pipeline import upscale_bgr

    lr_bgr, gt = degrade_bgr(bgr, scale)
    ch, cw = gt.shape[:2]
    ycc = _convert(bgr2ycrcb_u8_planar, gt)
    lr = _convert(bgr2ycrcb_u8_planar, lr_bgr)

    sr = upscale_bgr(lr_bgr, scale, weights, device=device)[:ch, :cw]
    bic = np.stack([resize_bicubic_u8_np(lr[..., i], (ch, cw))
                    for i in range(3)], axis=-1)

    gt_y = ycc[..., 0].astype(np.float64)
    sr_y = _convert(bgr2ycrcb_u8_planar, sr)[..., 0].astype(np.float64)
    bic_y = bic[..., 0].astype(np.float64)
    s = int(math.ceil(scale))
    sl = np.s_[s:-s, s:-s]
    return {
        "psnr_bicubic": psnr(gt_y[sl], bic_y[sl]),
        "psnr_srcnn": psnr(gt_y[sl], sr_y[sl]),
        "ssim_bicubic": ssim(gt_y[sl], bic_y[sl]),
        "ssim_srcnn": ssim(gt_y[sl], sr_y[sl]),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=_PROG, description=__doc__)
    ap.add_argument("paths", nargs="+")
    ap.add_argument("--scale", type=float, default=2.0)
    ap.add_argument("--device", default="cuda", choices=DEVICES,
                    help="where the super-resolution runs (default cuda)")
    ap.add_argument("--json", action="store_true", help="machine-readable")
    args = ap.parse_args(argv)

    if cuda_missing(args.device, _PROG):
        return 1
    files = _collect(args.paths)
    if not files:
        print(f"{_PROG}: no images found", file=sys.stderr)
        return 1
    prov = decode_provenance()
    if prov != EVAL_DECODE_PROVENANCE:
        print(f"{_PROG}: WARNING decode provenance {prov} != "
              f"{EVAL_DECODE_PROVENANCE} that minted EVAL.md — JPEG-decode "
              f"differences shift PSNR in the 3rd decimal", file=sys.stderr)
    weights = load_weights(device=args.device)
    rows = []
    for f in files:
        bgr = imread_bgr(f)
        if bgr is None:
            print(f"{_PROG}: skipping unreadable {f}", file=sys.stderr)
            continue
        m = evaluate_image(bgr, args.scale, weights, args.device)
        m["image"] = f.name
        rows.append(m)
        if not args.json:
            print(f"{f.name:28s} x{args.scale:g}  "
                  f"bicubic {m['psnr_bicubic']:.2f} dB / {m['ssim_bicubic']:.4f}"
                  f"  ->  SRCNN {m['psnr_srcnn']:.2f} dB / {m['ssim_srcnn']:.4f}"
                  f"  (+{m['psnr_srcnn'] - m['psnr_bicubic']:.2f} dB)")
    if not rows:
        return 1
    mean = {k: float(np.mean([r[k] for r in rows]))
            for k in ("psnr_bicubic", "psnr_srcnn", "ssim_bicubic", "ssim_srcnn")}
    device = device_name(args.device)
    if args.json:
        print(json.dumps({"scale": args.scale, "images": rows, "mean": mean,
                          "decode": prov, "device": device}))
    else:
        print(f"{'MEAN':28s} x{args.scale:g}  "
              f"bicubic {mean['psnr_bicubic']:.2f} dB / {mean['ssim_bicubic']:.4f}"
              f"  ->  SRCNN {mean['psnr_srcnn']:.2f} dB / {mean['ssim_srcnn']:.4f}"
              f"  (+{mean['psnr_srcnn'] - mean['psnr_bicubic']:.2f} dB)"
              f"  [{device}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
