"""K2: fused color-convert + bicubic-resize pre-pass (``csrc/pre_pass.cu``).

The counterpart of ``srcnn_cpp_tpu/ops/pallas_resize.py``: the reference's
``cvtColor(BGR2YCrCb)`` (src/srcnn.cpp:509) and per-channel INTER_CUBIC
resize (:570-583) in one pass over the output.  The wrapper launches the
CUDA kernel for CUDA tensors and runs the plain version
(:func:`pre_upscale_plain`: :func:`.color.bgr2ycrcb_u8_planar`, then
:func:`.resize.resize_bicubic_u8`) for CPU tensors; the two are
bit-identical, at every scale.  The kernel's block windows come from
:func:`pre_pass_plan`, pure Python that the CPU tests check.

A :class:`PreWindow` makes the pass compute one window of a larger resize:
output rows ``rows`` and columns ``cols`` of the global ``in_hw -> out_hw``
plan, read from an input block whose first pixel is the global source pixel
``origin`` (a row block of a device mesh, :mod:`..parallel.tiling`).  The
kernel reads its taps from tables, so the window is the global tables
sliced to the window and shifted by the origin (:func:`window_tables`);
its device code is the same.  Every output pixel runs the same taps and
the same arithmetic as in the whole resize, so a window equals the slice of
the whole result, bit for bit.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import runtime
from ..utils.profiling import span
from .color import bgr2ycrcb_u8_planar
from .resize import resize_bicubic_u8, resize_taps_u8
from .resize_tables import cv_cubic_tables

__all__ = ["pre_upscale_fused", "pre_upscale_plain", "pre_pass_plan",
           "PreWindow", "window_tables", "window_source"]

#: output columns per thread and warps per block (``CPT`` and ``WARPS`` of
#: ``csrc/pre_pass.cu``): a warp spans :data:`PRE_TW` columns, a block's
#: tile is ``PRE_WARPS * rows`` tall
PRE_COLS, PRE_WARPS = 4, 8
#: the widest tile (``TW_MAX``): one warp's columns
PRE_TW = 32 * PRE_COLS
#: output rows per thread, at most (32 at most: a tile, ``PRE_WARPS * R``
#: rows, is no taller than a block has threads, one a row to stage its taps)
PRE_ROWS = 8
#: shared-memory budget of one block: two blocks fit an SM's 228 KB
PRE_SMEM_BUDGET = 112 * 1024


class PreWindow(NamedTuple):
    """Output rows ``rows`` = (r0, r1) and columns ``cols`` = (c0, c1) of
    the resize of a global ``in_hw`` input, computed from an input block
    whose first pixel is global source pixel ``origin`` = (row, col)."""

    in_hw: tuple[int, int]
    rows: tuple[int, int]
    cols: tuple[int, int]
    origin: tuple[int, int] = (0, 0)


def window_tables(out_hw: tuple[int, int], window: PreWindow):
    """``(xi, xic, yi, yfc)`` of ``window``: the global tap tables of
    :func:`.resize_tables.cv_cubic_tables` sliced to its columns and rows,
    the indices shifted to its input block's origin (NumPy, contiguous)."""
    (oh, ow), (h, w) = out_hw, window.in_hw
    (r0, r1), (c0, c1), (s0, t0) = window.rows, window.cols, window.origin
    if not (0 <= r0 < r1 <= oh and 0 <= c0 < c1 <= ow):
        raise ValueError(f"window rows {window.rows} / cols {window.cols} "
                         f"outside the output {out_hw}")
    xi, xic, _ = cv_cubic_tables(ow, w)
    yi, _, yfc = cv_cubic_tables(oh, h)
    return (np.ascontiguousarray(xi[c0:c1] - t0), np.ascontiguousarray(xic[c0:c1]),
            np.ascontiguousarray(yi[r0:r1] - s0), np.ascontiguousarray(yfc[r0:r1]))


def window_source(out_hw: tuple[int, int], in_hw: tuple[int, int],
                  rows: tuple[int, int], cols: tuple[int, int]):
    """The global source rows ``(s0, s1)`` and columns ``(t0, t1)`` that
    output rows ``rows`` and columns ``cols`` read: from their smallest tap
    to their largest (the tables clamp, so both lie inside the image)."""
    win = PreWindow(in_hw, rows, cols)
    xi, _, yi, _ = window_tables(out_hw, win)
    return (int(yi.min()), int(yi.max()) + 1), (int(xi.min()), int(xi.max()) + 1)


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
    """Shared memory of one K2 block: float32 horizontal sums ``3 * WH * TW``,
    the YCrCb window, one 4-byte word per pixel, ``[WH][WP]``, its pitch
    ``WP`` being ``WW + 3`` (the 4-byte loads start up to 3 columns early)
    rounded up to 4, and two tiles' row taps and weights (32 bytes a row
    each: the next tile's are written while the last tile's are read)."""
    (th, tw), (wh, ww) = tile, win
    return 3 * wh * tw * 4 + wh * ((ww + 6) & ~3) * 4 + 2 * th * 32


def _tables(oh: int, ow: int, h: int, w: int, window: PreWindow | None):
    """The tap tables a launch reads and the output extent they cover."""
    if window is None:
        window = PreWindow((h, w), (0, oh), (0, ow))
    elif not (0 <= window.origin[0] and 0 <= window.origin[1]):
        raise ValueError(f"window origin {window.origin} outside the input")
    tabs = window_tables((oh, ow), window)
    for idx, n, axis in ((tabs[0], w, "columns"), (tabs[2], h, "rows")):
        if idx.min() < 0 or idx.max() >= n:
            raise ValueError(f"the window's taps reach {axis} "
                             f"{int(idx.min())}..{int(idx.max())} of an input "
                             f"block of {n}")
    return tabs


def pre_pass_plan(oh: int, ow: int, h: int, w: int,
                  window: PreWindow | None = None) -> dict:
    """K2's launch plan for ``[h, w] -> [oh, ow]``, or, with ``window``, for
    that window of the ``window.in_hw -> [oh, ow]`` resize read from an
    ``[h, w]`` input block.

    The output is cut into tiles of ``PRE_WARPS * R`` rows by ``TW``
    columns; a block of :data:`PRE_WARPS` warps computes a tile at a time,
    lane ``l`` of warp ``v`` columns ``PRE_COLS * l ..`` of rows
    ``v * R .. v * R + R - 1`` (the launcher starts as many blocks as the
    card holds at once, each walking tiles).  ``TW`` is the power of two
    (4 .. :data:`PRE_TW`) that covers the output's width; ``R`` is
    :data:`PRE_ROWS`, no taller than the output needs.  A tile's window
    spans about ``TH * h / oh`` input rows, so at strong downscales ``R``
    halves, then ``TW``, until the block's shared memory fits
    :data:`PRE_SMEM_BUDGET`.  Tile ``(bx, by)``'s input window starts at
    ``x0[bx]``, ``y0[by]``: the smallest tap of the (window's) tables over
    its columns and rows; ``win`` (rows, cols) is the largest window of any
    tile.  Returns ``tile`` (TH, TW), ``rows`` (R), ``cols``
    (:data:`PRE_COLS`), ``threads`` (a block's), ``x0``, ``y0`` (int32
    arrays), ``win``, ``grid`` (tiles along x and y), ``smem_bytes`` and
    ``out`` (the output rows and columns the launch writes).
    """
    xi, xic, yi, _ = _tables(oh, ow, h, w, window)
    oh, ow = yi.shape[0], xi.shape[0]
    if np.abs(xic).max() >= 1 << 15:
        raise ValueError("a column coefficient exceeds 16 bits")
    r = max(1, min(PRE_ROWS, -(-oh // PRE_WARPS)))
    tw = PRE_COLS
    while tw < min(ow, PRE_TW):
        tw *= 2
    while True:
        th = PRE_WARPS * r
        x0, ww = _window_spans(xi, tw)
        y0, wh = _window_spans(yi, th)
        smem = pre_pass_smem_bytes((th, tw), (wh, ww))
        if smem <= PRE_SMEM_BUDGET:
            break
        if r > 1:
            r //= 2
        elif tw > PRE_COLS:
            tw //= 2
        else:
            raise ValueError(f"no K2 tile fits {PRE_SMEM_BUDGET} bytes of "
                             f"shared memory for {(h, w)} -> {(oh, ow)}")
    return {"tile": (th, tw), "rows": r, "cols": PRE_COLS,
            "threads": 32 * PRE_WARPS, "x0": x0, "y0": y0, "win": (wh, ww),
            "grid": (len(x0), len(y0)), "smem_bytes": smem, "out": (oh, ow)}


@functools.lru_cache(maxsize=64)
def _device_plan(oh: int, ow: int, h: int, w: int, window, device: torch.device):
    """:func:`pre_pass_plan` and its tables on ``device``, per geometry and
    window: ``(plan, (xi, xic, yi, yfc, x0, y0))``."""
    with span("srcnn.build.k2_plan"):
        plan = pre_pass_plan(oh, ow, h, w, window)
        tabs = (*_tables(oh, ow, h, w, window), plan["x0"], plan["y0"])
        return plan, tuple(torch.from_numpy(t).to(device) for t in tabs)


def pre_upscale_plain(bgr_p: torch.Tensor, out_hw: tuple[int, int],
                      window: PreWindow | None = None) -> torch.Tensor:
    """``resize_bicubic_u8(bgr2ycrcb_u8_planar(bgr_p), out_hw)``, or its
    ``window`` through the window's tables."""
    pre_upscale_plain.calls += 1
    ycc = bgr2ycrcb_u8_planar(bgr_p)
    if window is None:
        return resize_bicubic_u8(ycc, out_hw)
    tabs = _tables(*out_hw, *bgr_p.shape[-2:], window)
    return resize_taps_u8(ycc, *(torch.from_numpy(t).to(bgr_p.device)
                                 for t in tabs))


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


def pre_upscale_fused(bgr_p: torch.Tensor, out_hw: tuple[int, int],
                      window: PreWindow | None = None) -> torch.Tensor:
    """Planar BGR u8 ``[B, 3, H, W]`` -> upscaled YCrCb u8 ``[B, 3, oh, ow]``;
    with ``window``, its ``[B, 3, r1 - r0, c1 - c0]`` window of the
    ``window.in_hw -> out_hw`` resize, ``bgr_p`` being the input block."""
    oh, ow = _validate(bgr_p, out_hw)
    if bgr_p.device.type == "cpu":
        return pre_upscale_plain(bgr_p, (oh, ow), window)
    if bgr_p.device.type != "cuda":
        raise ValueError(f"unsupported device {bgr_p.device}")
    b, _, h, w = bgr_p.shape
    plan, tabs = _device_plan(oh, ow, h, w, window, bgr_p.device)
    out = torch.empty((b, 3, *plan["out"]), dtype=torch.uint8,
                      device=bgr_p.device)
    if b == 0:
        return out
    with torch.cuda.device(bgr_p.device):
        runtime.check(runtime.library().pre_pass_u8(
            bgr_p.data_ptr(), *(t.data_ptr() for t in tabs), out.data_ptr(),
            b, h, w, *plan["out"], *plan["tile"], *plan["win"],
            plan["smem_bytes"], runtime.current_stream()),
            "pre_pass_u8")
    pre_upscale_fused.launches += 1
    return out


pre_upscale_fused.launches = 0
