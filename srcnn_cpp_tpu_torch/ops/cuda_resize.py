"""K2: fused color-convert + bicubic-resize pre-pass (``csrc/pre_pass.cu``).

The counterpart of ``srcnn_cpp_tpu/ops/pallas_resize.py``: the reference's
``cvtColor(BGR2YCrCb)`` (src/srcnn.cpp:509) and per-channel INTER_CUBIC
resize (:570-583) in one pass over the output.  The wrapper launches the
CUDA kernel for CUDA tensors and runs the plain version
(:func:`pre_upscale_plain`: :func:`.color.bgr2ycrcb_u8_planar`, then
:func:`.resize.resize_bicubic_u8`) for CPU tensors; the two are
bit-identical, at every scale.  The kernel's block windows come from
:func:`pre_pass_plan`, pure Python that the CPU tests check.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import runtime
from .color import bgr2ycrcb_u8_planar
from .resize import cubic_tables, resize_bicubic_u8
from .resize_tables import cv_cubic_tables

__all__ = ["pre_upscale_fused", "pre_upscale_plain", "pre_pass_plan"]

#: the largest output tile (rows, cols) of one block
PRE_TILE = (64, 64)
#: shared-memory budget of one block: the limit without an opt-in
PRE_SMEM_BUDGET = 48 * 1024


def _window_spans(idx: np.ndarray, tile: int) -> tuple[np.ndarray, int]:
    """Per block of ``tile`` consecutive outputs along one axis: the first
    source index its taps read, and the widest span of taps of any block."""
    n = -(-idx.shape[0] // tile)
    pad = np.concatenate([idx, np.repeat(idx[-1:], n * tile - idx.shape[0],
                                         axis=0)])
    blocks = pad.reshape(n, tile * 4)
    lo, hi = blocks.min(axis=1), blocks.max(axis=1)
    return lo.astype(np.int32), int((hi - lo).max()) + 1


def pre_pass_smem_bytes(tile: tuple[int, int], win: tuple[int, int]) -> int:
    """Shared memory of one K2 block: int32 horizontal sums ``[3][WH][TW]``
    and the YCrCb window ``[3][WH][WW rounded up to 4]`` in bytes."""
    (_, tw), (wh, ww) = tile, win
    return 3 * wh * tw * 4 + 3 * wh * (-(-ww // 4) * 4)


def pre_pass_plan(oh: int, ow: int, h: int, w: int) -> dict:
    """K2's launch plan for ``[h, w] -> [oh, ow]``.

    A block owns :data:`PRE_TILE` output pixels (rows, cols), halved (rows
    first) until its shared memory fits :data:`PRE_SMEM_BUDGET`, as at
    strong downscales; its input window starts at
    ``x0[bx]``, ``y0[by]``: the smallest tap of ``cubic_tables`` over its
    columns and rows.  ``win`` (rows, cols) is the largest window of any
    block.  Returns ``tile``, ``x0``, ``y0`` (int32 arrays), ``win``,
    ``grid`` (blocks along x and y) and ``smem_bytes``.
    """
    xi = cv_cubic_tables(ow, w)[0]
    yi = cv_cubic_tables(oh, h)[0]
    th, tw = min(PRE_TILE[0], oh), min(PRE_TILE[1], ow)
    while True:
        x0, ww = _window_spans(xi, tw)
        y0, wh = _window_spans(yi, th)
        smem = pre_pass_smem_bytes((th, tw), (wh, ww))
        if smem <= PRE_SMEM_BUDGET or th == tw == 1:
            break
        if th > 1:
            th //= 2
        else:
            tw //= 2
    return {"tile": (th, tw), "x0": x0, "y0": y0, "win": (wh, ww),
            "grid": (len(x0), len(y0)), "smem_bytes": smem}


@functools.lru_cache(maxsize=32)
def _device_plan(oh: int, ow: int, h: int, w: int, device: torch.device):
    """:func:`pre_pass_plan` with its origins on ``device``, per geometry."""
    plan = pre_pass_plan(oh, ow, h, w)
    return plan, torch.from_numpy(plan["x0"]).to(device), \
        torch.from_numpy(plan["y0"]).to(device)


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
    plan, x0, y0 = _device_plan(oh, ow, h, w, bgr_p.device)
    out = torch.empty((b, 3, oh, ow), dtype=torch.uint8, device=bgr_p.device)
    if b == 0:
        return out
    with torch.cuda.device(bgr_p.device):
        runtime.check(runtime.library().pre_pass_u8(
            bgr_p.data_ptr(), xi.data_ptr(), xic.data_ptr(), yi.data_ptr(),
            yfc.data_ptr(), x0.data_ptr(), y0.data_ptr(), out.data_ptr(),
            b, h, w, oh, ow, *plan["tile"], *plan["win"], plan["smem_bytes"],
            runtime.current_stream()), "pre_pass_u8")
    pre_upscale_fused.launches += 1
    return out


pre_upscale_fused.launches = 0
