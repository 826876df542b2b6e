"""K2: fused color-convert + bicubic-resize pre-pass (``csrc/pre_pass.cu``).

The counterpart of ``srcnn_cpp_tpu/ops/pallas_resize.py``: the reference's
``cvtColor(BGR2YCrCb)`` (src/srcnn.cpp:509) and per-channel INTER_CUBIC
resize (:570-583) in one pass over the output.  The wrapper launches the
CUDA kernel for CUDA tensors and runs the plain version
(:func:`pre_upscale_plain`: :func:`.color.bgr2ycrcb_u8_planar`, then
:func:`.resize.resize_bicubic_u8`) for CPU tensors; the two are
bit-identical, at every scale.
"""

from __future__ import annotations

import torch

from .. import runtime
from .color import bgr2ycrcb_u8_planar
from .resize import cubic_tables, resize_bicubic_u8

__all__ = ["pre_upscale_fused", "pre_upscale_plain"]


def pre_upscale_plain(bgr_p: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """``resize_bicubic_u8(bgr2ycrcb_u8_planar(bgr_p), out_hw)``."""
    pre_upscale_plain.calls += 1
    return resize_bicubic_u8(bgr2ycrcb_u8_planar(bgr_p), out_hw)


pre_upscale_plain.calls = 0


def _validate(bgr_p: torch.Tensor, out_hw) -> tuple[int, int]:
    if bgr_p.dtype != torch.uint8:
        raise TypeError(f"expected uint8, got {bgr_p.dtype}")
    if bgr_p.dim() != 4 or bgr_p.shape[1] != 3:
        raise ValueError(f"expected planar BGR [B,3,H,W], got "
                         f"{tuple(bgr_p.shape)}")
    if not bgr_p.is_contiguous():
        raise ValueError("input must be contiguous")
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if oh <= 0 or ow <= 0 or min(bgr_p.shape[2:]) <= 0:
        raise ValueError(f"empty geometry {tuple(bgr_p.shape)} -> {(oh, ow)}")
    return oh, ow


def pre_upscale_fused(bgr_p: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Planar BGR u8 ``[B, 3, H, W]`` -> upscaled YCrCb u8 ``[B, 3, oh, ow]``."""
    oh, ow = _validate(bgr_p, out_hw)
    if bgr_p.device.type == "cpu":
        return pre_upscale_plain(bgr_p, (oh, ow))
    if bgr_p.device.type != "cuda":
        raise ValueError(f"unsupported device {bgr_p.device}")
    b, _, h, w = bgr_p.shape
    xi, xic, _ = cubic_tables(ow, w, bgr_p.device)
    yi, _, yfc = cubic_tables(oh, h, bgr_p.device)
    out = torch.empty((b, 3, oh, ow), dtype=torch.uint8, device=bgr_p.device)
    if b == 0:
        return out
    with torch.cuda.device(bgr_p.device):
        runtime.check(runtime.library().pre_pass_u8(
            bgr_p.data_ptr(), xi.data_ptr(), xic.data_ptr(), yi.data_ptr(),
            yfc.data_ptr(), out.data_ptr(), b, h, w, oh, ow,
            runtime.current_stream()), "pre_pass_u8")
    pre_upscale_fused.launches += 1
    return out


pre_upscale_fused.launches = 0
