"""K3: fused merge + YCrCb->BGR post-pass (``csrc/merge.cu``).

The counterpart of ``srcnn_cpp_tpu/ops/pallas_merge.py``: the reference's
last two stages, ``merge([Y', Cr, Cb])`` (src/srcnn.cpp:638-639) and
``cvtColor(YCrCb2BGR)`` (:657), in one pass over the output.  The wrapper
launches the CUDA kernel for CUDA tensors and runs the plain version
(:func:`merge_plain`) for CPU tensors; the two are bit-identical.

Where a frame's six planes share their 16-byte alignment, the kernel works
in units of 16 pixels with 16-byte loads and stores; elsewhere it runs one
thread per pixel.  Its launch plan (:func:`merge_plan`) is pure Python, so
the CPU tests check that it covers every output byte exactly once.
"""

from __future__ import annotations

import functools

import torch

from .. import runtime
from ..utils.profiling import span
from .color import ycrcb2bgr_u8_planar

__all__ = ["merge_ycrcb_to_bgr_fused", "merge_plain", "merge_plan"]

#: pixels per work unit: one 16-byte access per plane (merge.cu ``VEC``)
MERGE_VEC = 16
#: threads per block (merge.cu ``BLOCK``)
MERGE_BLOCK = 256
#: blocks per SM in the 16-byte kernel's grid (merge.cu ``BLOCKS_PER_SM``)
MERGE_BLOCKS_PER_SM = 4


def merge_plan(batch: int, h: int, w: int, num_sms: int,
               addrs: tuple[int, int, int] = (0, 0, 0)) -> dict:
    """K3's launch for ``[batch, h, w]`` with Y', YCrCb and BGR buffers at
    ``addrs`` (only their residues mod 16 matter).

    Where ``h * w % 16 == 0`` and the three addresses are congruent mod 16,
    every frame's six planes share their alignment: ``vec`` 16, a head unit
    up to the first aligned pixel and ``ceil(h * w / 16)`` units of 16
    pixels per frame (``per_frame``), walked grid-stride by ``grid`` blocks,
    at most one resident wave.  Elsewhere ``vec`` 1: one thread per pixel
    (``per_frame`` = ``h * w``) on ``grid`` x ``batch`` blocks.  ``head`` is
    the pixels before the first aligned one (0 for ``vec`` 1)."""
    plane = h * w
    a = addrs[0] % MERGE_VEC
    if plane % MERGE_VEC == 0 and all(p % MERGE_VEC == a for p in addrs):
        per_frame = 1 + -(-plane // MERGE_VEC)
        units = batch * per_frame
        grid = max(1, min(-(-units // MERGE_BLOCK),
                          num_sms * MERGE_BLOCKS_PER_SM))
        head = min((MERGE_VEC - a) % MERGE_VEC, plane)
        return {"vec": MERGE_VEC, "block": MERGE_BLOCK, "per_frame": per_frame,
                "units": units, "grid": grid, "head": head}
    return {"vec": 1, "block": MERGE_BLOCK, "per_frame": plane,
            "units": batch * plane, "grid": -(-plane // MERGE_BLOCK),
            "head": 0}


@functools.lru_cache(maxsize=64)
def _launch_args(b: int, h: int, w: int, index: int,
                 residues: tuple[int, int, int]) -> tuple[int, ...]:
    """:func:`merge_plan`'s launcher arguments on CUDA device ``index`` (the
    current one), computed once per geometry and alignment: K3's device time
    is shorter than its wrapper's host time, so the wrapper stays lean."""
    with span("srcnn.build.k3_args"):
        plan = merge_plan(b, h, w, runtime.num_sms(), residues)
        return plan["grid"], plan["block"], plan["vec"], plan["per_frame"]


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
    ptrs = (y_sr.data_ptr(), up.data_ptr(), out.data_ptr())
    with torch.cuda.device(y_sr.device):
        runtime.check(runtime.library().merge_ycrcb_bgr_u8(
            *ptrs, b, h, w, *_launch_args(b, h, w, y_sr.device.index,
                                          tuple(p % MERGE_VEC for p in ptrs)),
            runtime.current_stream()), "merge_ycrcb_bgr_u8")
    merge_ycrcb_to_bgr_fused.launches += 1
    return out


merge_ycrcb_to_bgr_fused.launches = 0
