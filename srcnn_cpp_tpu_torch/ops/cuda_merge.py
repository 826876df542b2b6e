"""K3: fused merge + YCrCb->BGR post-pass (``csrc/merge.cu``).

The counterpart of ``srcnn_cpp_tpu/ops/pallas_merge.py``: the reference's
last two stages, ``merge([Y', Cr, Cb])`` (src/srcnn.cpp:638-639) and
``cvtColor(YCrCb2BGR)`` (:657), in one pass over the output.  The wrapper
launches the CUDA kernel for CUDA tensors and runs the plain version
(:func:`merge_plain`) for CPU tensors; the two are bit-identical.
"""

from __future__ import annotations

import torch

from .. import runtime
from .color import ycrcb2bgr_u8_planar

__all__ = ["merge_ycrcb_to_bgr_fused", "merge_plain"]


def merge_plain(y_sr: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``ycrcb2bgr_u8_planar(stack([y_sr, up[:, 1], up[:, 2]]))``."""
    merge_plain.calls += 1
    return ycrcb2bgr_u8_planar(torch.stack([y_sr, up[:, 1], up[:, 2]], dim=1))


merge_plain.calls = 0


def _validate(y_sr: torch.Tensor, up: torch.Tensor) -> None:
    if y_sr.dtype != torch.uint8 or up.dtype != torch.uint8:
        raise TypeError(f"expected uint8, got {y_sr.dtype} and {up.dtype}")
    if y_sr.dim() != 3 or up.shape != (y_sr.shape[0], 3, *y_sr.shape[1:]):
        raise ValueError(f"expected Y' [B,H,W] and up [B,3,H,W], got "
                         f"{tuple(y_sr.shape)} and {tuple(up.shape)}")
    if y_sr.device != up.device:
        raise ValueError(f"inputs on {y_sr.device} and {up.device}")
    if not (y_sr.is_contiguous() and up.is_contiguous()):
        raise ValueError("inputs must be contiguous")


def merge_ycrcb_to_bgr_fused(y_sr: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``Y' [B, H, W]`` + upscaled YCrCb ``[B, 3, H, W]`` -> planar BGR u8."""
    _validate(y_sr, up)
    if y_sr.device.type == "cpu":
        return merge_plain(y_sr, up)
    if y_sr.device.type != "cuda":
        raise ValueError(f"unsupported device {y_sr.device}")
    out = torch.empty_like(up)
    if out.numel() == 0:
        return out
    b, h, w = y_sr.shape
    with torch.cuda.device(y_sr.device):
        runtime.check(runtime.library().merge_ycrcb_bgr_u8(
            y_sr.data_ptr(), up.data_ptr(), out.data_ptr(), b, h, w,
            runtime.current_stream()), "merge_ycrcb_bgr_u8")
    merge_ycrcb_to_bgr_fused.launches += 1
    return out


merge_ycrcb_to_bgr_fused.launches = 0
