"""One frame tiled over a device mesh, stitched with halo exchange.

The port of ``srcnn_cpp_tpu/parallel/tiling.py``.  A frame's batch, rows and
columns split over the ``data``, ``row`` and ``col`` axes of a
:class:`.mesh.Mesh`; the blocks live in an object array shaped like the
mesh (``None`` for a block of another process).  A halo exchange extends
each block by its neighbours' edge rows or columns: inside one process a
copy onto the block's device (``Tensor.to``: a peer copy between cards, a
device-local copy on one card), across processes a ``torch.distributed``
send and receive (:func:`_p2p`).

**K1 on a tile** (:func:`srcnn_blocks`).  The conv kernel applies the
reference's clamps itself at its own plane's edges: the input clamp of
conv1 and the feature clamp of conv3 (``ops/cuda_srcnn.py``).  So each
block is extended by :data:`HALO` = 6 real neighbour rows (and columns) on
its *interior* sides only, K1 runs on that, and only the interior sides are
cropped.  A true image edge stays the extended plane's edge, where K1
clamps as the reference does; a kept pixel's receptive field (f2 rows
±2, each reading input rows ±4) lies inside the extended block, and every
row that K1 clamps at a seam is cropped away.  Each output pixel's sum runs
over the same taps in the same order wherever its tile starts, so the
stitched result equals monolithic K1 bit for bit.  The JAX composition
(``_srcnn_rows_fused`` :88-124, ``_srcnn_tile2d_fused`` :127-201) extends
every side with replicate rows, because its kernel clamps at the extended
tile's edge, and must then recompute the 2 true-edge rows, columns and
corners from 8-deep strips with the split XLA path and transposed weights;
here nothing is recomputed, so none of that has a counterpart.

**K2 on a tile** (:func:`pre_upscale_blocks`).  A block computes its
window of the *global* bicubic plan from an input block extended by the
rows its taps reach: from its smallest tap to its largest
(:func:`..ops.cuda_resize.window_source`; at x2, 2 rows above and 2
below).
The windowed kernel reads the global tap tables sliced to the window
(:class:`..ops.cuda_resize.PreWindow`), so it equals the slice of the
monolithic K2 at every scale and split.  The JAX version's phase-plan,
parity and 128-lane refusals (:482-509) are Mosaic constraints and have no
counterpart.  Splits may be uneven (``tensor_split``'s cuts of the input
and of the output); it refuses only where a halo would reach past one
neighbour.

**K3 on a tile** (:func:`merge_blocks`): pointwise, no halo.

**The differentiable forward** (:func:`_srcnn_tile_f32`, the sharded train
step's): plain ``F.conv2d`` under ``fp32_strict`` on a block extended by 6
rows and columns (replicate rows at the true edges): conv1 and conv2 valid,
:func:`_clamp_feature_edges` at the true edges, conv3 valid.  Autograd
carries gradients back through the copies and through each block's copy
of the weights; across processes through :class:`_HaloP2P`.
"""

from __future__ import annotations

import functools
import types
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.cuda_merge import merge_ycrcb_to_bgr_fused
from ..ops.cuda_resize import PreWindow, pre_upscale_fused, window_source
from ..ops.cuda_srcnn import srcnn_y_fused
from ..ops.srcnn import fp32_strict
from ..weights import srcnn_only, weights_on
from ..weights.loader import _KEYS, HALO
from .mesh import Mesh

__all__ = ["HALO", "split_blocks", "gather_blocks", "srcnn_blocks",
           "srcnn_y_tiled", "upscale_y_tiled", "pre_upscale_blocks",
           "pre_upscale_fused_rows", "merge_blocks",
           "merge_ycrcb_to_bgr_fused_rows", "upscale_blocks"]

#: the tensor dimension each spatial mesh axis splits
_DIM = {1: -2, 2: -1}


# --- blocks --------------------------------------------------------------------

def bounds(n: int, parts: int) -> list[int]:
    """Where ``torch.tensor_split(x, parts)`` cuts ``n`` elements: the first
    ``n % parts`` parts take one more."""
    q, r = divmod(n, parts)
    return [i * q + min(i, r) for i in range(parts + 1)]


def split_blocks(x: torch.Tensor, mesh: Mesh, dims=(0, -2, -1)) -> np.ndarray:
    """This process's blocks of ``x``: split along ``dims`` (batch, rows,
    columns) over the mesh's axes as ``tensor_split`` does, each block a
    contiguous copy on its device."""
    cuts = [bounds(x.shape[d], n) for d, n in zip(dims, mesh.devices.shape)]
    out = np.empty(mesh.devices.shape, dtype=object)
    for idx in mesh.local_blocks():
        sl = [slice(None)] * x.dim()
        for d, c, i in zip(dims, cuts, idx):
            sl[d] = slice(c[i], c[i + 1])
        out[idx] = x[tuple(sl)].to(mesh.devices[idx],
                                   non_blocking=True).contiguous()
    return out


def gather_blocks(blocks: np.ndarray, dims=(0, -2, -1),
                  device=None) -> torch.Tensor:
    """The blocks of a grid, all of this process, joined on ``device`` (the
    first block's when None)."""
    device = blocks.flat[0].device if device is None else device
    nd, nr, nc = blocks.shape
    return torch.cat([
        torch.cat([torch.cat([blocks[d, r, c].to(device) for c in range(nc)],
                             dim=dims[2]) for r in range(nr)], dim=dims[1])
        for d in range(nd)], dim=dims[0])


# --- halo exchange -------------------------------------------------------------

def _edge_piece(t: torch.Tensor, dim: int, k: int, last: bool) -> torch.Tensor:
    return t.narrow(dim, t.shape[dim] - k, k) if last else t.narrow(dim, 0, k)


def _exchange(blocks: np.ndarray, mesh: Mesh, axis: int, lead, tail,
              edge: str | None = None):
    """Extend each local block along grid ``axis`` (1: rows, 2: columns)
    by ``lead`` elements of its predecessor's end and ``tail`` of its
    successor's start (ints, or int arrays shaped like the mesh, per
    receiving block).  At the true image edges ``edge="replicate"`` repeats
    the block's edge row ``lead``/``tail`` times; ``edge=None`` adds
    nothing.  Returns ``(extended, added_before)``: the grid of extended
    blocks and the elements added before each block."""
    shape, dim = mesh.devices.shape, _DIM[axis]
    lead = np.broadcast_to(np.asarray(lead), shape)
    tail = np.broadcast_to(np.asarray(tail), shape)
    n = shape[axis]
    # every message, in one global order that all processes agree on:
    # (source block, receiving block, count, from the source's end?)
    msgs = []
    for q in np.ndindex(*shape):
        i = q[axis]
        if i > 0 and lead[q]:
            p = tuple(i - 1 if a == axis else v for a, v in enumerate(q))
            msgs.append((p, q, int(lead[q]), True))
        if i < n - 1 and tail[q]:
            s = tuple(i + 1 if a == axis else v for a, v in enumerate(q))
            msgs.append((s, q, int(tail[q]), False))
    pieces, sends, recvs = {}, [], []
    for tag, (src, dst, k, last) in enumerate(msgs):
        here_src, here_dst = mesh.is_local(src), mesh.is_local(dst)
        if here_src:
            if blocks[src].shape[dim] < k:
                raise ValueError(f"a halo of {k} reaches past one neighbour "
                                 f"of {blocks[src].shape[dim]} along axis "
                                 f"{axis}")
            piece = _edge_piece(blocks[src], dim, k, last)
            if here_dst:
                pieces[dst, last] = piece.to(mesh.devices[dst],
                                             non_blocking=True)
            else:
                sends.append((tag, int(mesh.ranks[dst]), piece))
        elif here_dst:
            want = list(blocks[dst].shape)
            want[dim] = k
            recvs.append((tag, int(mesh.ranks[src]), (dst, last), tuple(want),
                          blocks[dst].dtype, mesh.devices[dst]))
    if sends or recvs:
        got = _p2p(sends, recvs)
        pieces.update(zip((r[2] for r in recvs), got))
    out = np.empty(shape, dtype=object)
    before = np.zeros(shape, dtype=int)
    for q in mesh.local_blocks():
        t, i = blocks[q], q[axis]
        head, foot = pieces.get((q, True)), pieces.get((q, False))
        if edge == "replicate":
            if i == 0 and lead[q]:
                head = _edge_piece(t, dim, 1, False).repeat_interleave(
                    int(lead[q]), dim=dim)
            if i == n - 1 and tail[q]:
                foot = _edge_piece(t, dim, 1, True).repeat_interleave(
                    int(tail[q]), dim=dim)
        elif edge is not None:
            raise ValueError(f"edge must be 'replicate' or None, not {edge!r}")
        parts = [p for p in (head, t, foot) if p is not None]
        out[q] = torch.cat(parts, dim=dim) if len(parts) > 1 else t
        before[q] = 0 if head is None else head.shape[dim]
    return out, before


def _halo_exchange_rows(blocks, mesh, halo: int, edge="replicate"):
    """Extend each row block by ``halo`` rows on each side: neighbour rows
    at interior seams, replicate rows at the true top and bottom."""
    return _exchange(blocks, mesh, 1, halo, halo, edge)[0]


def _halo_exchange_rows_asym(blocks, mesh, top, bot, edge="replicate"):
    """Asymmetric row halo: ``top`` rows from above, ``bot`` from below."""
    return _exchange(blocks, mesh, 1, top, bot, edge)[0]


def _halo_exchange_cols(blocks, mesh, halo: int, edge="replicate"):
    """The column analogue of :func:`_halo_exchange_rows`."""
    return _exchange(blocks, mesh, 2, halo, halo, edge)[0]


def _halo_exchange_cols_asym(blocks, mesh, lft, rgt, edge="replicate"):
    """Asymmetric column halo: ``lft`` from the left, ``rgt`` from the
    right."""
    return _exchange(blocks, mesh, 2, lft, rgt, edge)[0]


def _transfer(msgs):
    """Post every message of ``msgs`` — ``(tag, peer, tensor)`` to send or
    ``(tag, peer, shape, dtype, device)`` to receive — in tag order and wait
    for all; returns the received tensors in order.  Over gloo the tensors
    cross as host copies, over NCCL as they are."""
    import torch.distributed as dist

    host = dist.get_backend() == "gloo"
    ops, got = [], []
    for m in sorted(msgs, key=lambda m: m[0]):
        if len(m) == 3:
            t = m[2].detach().contiguous()
            ops.append(dist.P2POp(dist.isend, t.cpu() if host else t, m[1],
                                  tag=m[0]))
        else:
            buf = torch.empty(m[2], dtype=m[3],
                              device="cpu" if host else m[4])
            got.append((m[4], buf))
            ops.append(dist.P2POp(dist.irecv, buf, m[1], tag=m[0]))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [buf.to(dev) for dev, buf in got]


class _HaloP2P(torch.autograd.Function):
    """A halo exchange across processes, differentiable: forward sends edge
    pieces to the neighbours and receives their halos; backward sends each
    received halo's gradient back to its sender and receives the gradient
    of each piece it sent, which autograd adds into the edge rows."""

    @staticmethod
    def forward(ctx, send_meta, recv_meta, *pieces):
        ctx.send_meta, ctx.recv_meta = send_meta, recv_meta
        ctx.sent = [(p.shape, p.dtype, p.device) for p in pieces]
        return tuple(_transfer([(*m, p) for m, p in zip(send_meta, pieces)]
                               + list(recv_meta)))

    @staticmethod
    def backward(ctx, *grads):
        back = [(m[0], m[1], torch.zeros(m[2], dtype=m[3], device=m[4])
                 if g is None else g) for m, g in zip(ctx.recv_meta, grads)]
        back += [(m[0], m[1], *spec) for m, spec in zip(ctx.send_meta,
                                                         ctx.sent)]
        return (None, None, *_transfer(back))


def _p2p(sends, recvs):
    """The cross-process part of one exchange: ``sends`` ``(tag, peer,
    piece)``, ``recvs`` ``(tag, peer, key, shape, dtype, device)``."""
    send_meta = tuple((tag, peer) for tag, peer, _ in sends)
    recv_meta = tuple((tag, peer, shape, dtype, dev)
                      for tag, peer, _, shape, dtype, dev in recvs)
    return _HaloP2P.apply(send_meta, recv_meta, *(p for _, _, p in sends))


# --- K1 on tiles ---------------------------------------------------------------

def _check_min(n: int, parts: int, what: str) -> None:
    if parts > 1 and n // parts < HALO:
        raise ValueError(f"{what} {n} over {parts} blocks: a block must be at "
                         f"least {HALO} tall so that one neighbour holds its "
                         f"halo")


def srcnn_blocks(blocks: np.ndarray, weights, mesh: Mesh) -> np.ndarray:
    """K1 on each block of a grid of Y blocks ``[b, h, w]`` u8 (rows and
    columns of one frame, halos from the neighbours on interior sides
    only); returns the grid of ``[b, h, w]`` u8 outputs.  Another
    network's weights raise TypeError: the blocks' halo is SRCNN's."""
    srcnn_only(weights, "parallel.tiling")
    ext_c, lc = _exchange(blocks, mesh, 2, HALO, HALO)
    ext, lr = _exchange(ext_c, mesh, 1, HALO, HALO)
    out = np.empty(blocks.shape, dtype=object)
    for q in mesh.local_blocks():
        _, h, w = blocks[q].shape
        y = srcnn_y_fused(ext[q], weights_on(weights, mesh.devices[q]))
        out[q] = y[:, lr[q]:lr[q] + h, lc[q]:lc[q] + w].contiguous()
    return out


def _planes(y_u8: torch.Tensor) -> torch.Tensor:
    if y_u8.dim() not in (2, 3):
        raise ValueError(f"expected Y [H,W] or [B,H,W], got "
                         f"{tuple(y_u8.shape)}")
    return y_u8[None] if y_u8.dim() == 2 else y_u8


def srcnn_y_tiled(y_u8: torch.Tensor, weights, mesh: Mesh) -> torch.Tensor:
    """SRCNN an upscaled Y batch ``[B, H, W]`` (or ``[H, W]``) tiled over
    ``mesh``: ``B`` over ``data``, rows over ``row``, columns over ``col``;
    K1 per block, bit-equal to K1 on the whole plane.  The dims must divide
    by the axes (:func:`upscale_y_tiled` takes any ``H``).  Returns the
    result on ``y_u8``'s device."""
    y = _planes(y_u8)
    nd, nr, nc = mesh.devices.shape
    b, h, w = y.shape
    if b % nd or h % nr or w % nc:
        raise ValueError(f"batch {b} / height {h} / width {w} not divisible "
                         f"by mesh {nd}x{nr}x{nc}")
    return _tiled_y(y, weights, mesh).reshape(y_u8.shape)


def upscale_y_tiled(y_u8: torch.Tensor, weights, mesh: Mesh) -> torch.Tensor:
    """Like :func:`srcnn_y_tiled` for any ``B``, ``H`` and ``W``: the axes
    split them unevenly (``tensor_split``; the JAX version pads and patches
    the last rows), and the result still equals K1 on the whole plane."""
    y = _planes(y_u8)
    return _tiled_y(y, weights, mesh).reshape(y_u8.shape)


def _tiled_y(y: torch.Tensor, weights, mesh: Mesh) -> torch.Tensor:
    _check_min(y.shape[1], mesh.shape["row"], "height")
    _check_min(y.shape[2], mesh.shape["col"], "width")
    out = srcnn_blocks(split_blocks(y, mesh), weights, mesh)
    return gather_blocks(out, device=y.device)


# --- K2 and K3 on tiles --------------------------------------------------------

class PreHalos(NamedTuple):
    """The splits of a pre-pass over a mesh: cut points of the input
    and output rows and columns, and each block's halo (int arrays shaped
    like the mesh, read-only): rows from above (``top``) and below
    (``bot``), columns from the left (``lft``) and right (``rgt``)."""

    rows_in: tuple
    rows_out: tuple
    cols_in: tuple
    cols_out: tuple
    top: np.ndarray
    bot: np.ndarray
    lft: np.ndarray
    rgt: np.ndarray


@functools.lru_cache(maxsize=32)
def pre_upscale_halos(in_hw, out_hw, mesh_shape) -> PreHalos:
    """:class:`PreHalos` of a ``in_hw -> out_hw`` pre-pass over ``(data,
    row, col)`` = ``mesh_shape``, computed once per geometry from the
    global tap tables.  Input and output split as ``tensor_split`` does,
    unevenly where an axis does not divide the size.  Raises ValueError
    where a halo would reach past one neighbour."""
    (h, w), (oh, ow) = in_hw, out_hw
    _, nr, nc = mesh_shape
    ri, ro = tuple(bounds(h, nr)), tuple(bounds(oh, nr))
    ci, co = tuple(bounds(w, nc)), tuple(bounds(ow, nc))
    halo = {k: np.zeros(mesh_shape, dtype=int)
            for k in ("top", "bot", "lft", "rgt")}
    for q in np.ndindex(*mesh_shape):
        r, c = q[1], q[2]
        (s0, s1), (t0, t1) = window_source(out_hw, in_hw, (ro[r], ro[r + 1]),
                                           (co[c], co[c + 1]))
        halo["top"][q], halo["bot"][q] = max(0, ri[r] - s0), max(0, s1 - ri[r + 1])
        halo["lft"][q], halo["rgt"][q] = max(0, ci[c] - t0), max(0, t1 - ci[c + 1])
    # a halo may not outreach the smallest block of its axis (the split
    # is uneven where the axis does not divide the size)
    if max(halo["top"].max(), halo["bot"].max()) > min(np.diff(ri)) or \
            max(halo["lft"].max(), halo["rgt"].max()) > min(np.diff(ci)):
        raise ValueError(f"{h}x{w} -> {oh}x{ow} over {nr}x{nc} blocks: a "
                         f"halo reaches past one neighbour")
    for a in halo.values():
        a.setflags(write=False)
    return PreHalos(ri, ro, ci, co, **halo)


def pre_upscale_blocks(blocks: np.ndarray, in_hw, out_hw,
                       mesh: Mesh) -> np.ndarray:
    """Windowed K2 on each block of a grid of planar BGR blocks ``[b, 3, h,
    w]`` (the ``tensor_split`` of a global ``in_hw`` frame, even or not);
    returns the grid of upscaled YCrCb blocks, the same split of
    ``out_hw``."""
    in_hw, out_hw = tuple(map(int, in_hw)), tuple(map(int, out_hw))
    p = pre_upscale_halos(in_hw, out_hw, mesh.devices.shape)
    ext_c, lc = _exchange(blocks, mesh, 2, p.lft, p.rgt)
    ext, lr = _exchange(ext_c, mesh, 1, p.top, p.bot)
    ri, ro, ci, co = p.rows_in, p.rows_out, p.cols_in, p.cols_out
    out = np.empty(blocks.shape, dtype=object)
    for q in mesh.local_blocks():
        r, c = q[1], q[2]
        win = PreWindow(in_hw, (ro[r], ro[r + 1]), (co[c], co[c + 1]),
                        (ri[r] - int(lr[q]), ci[c] - int(lc[q])))
        out[q] = pre_upscale_fused(ext[q], out_hw, win)
    return out


def pre_upscale_fused_rows(bgr_p: torch.Tensor, out_hw,
                           mesh: Mesh) -> torch.Tensor:
    """Planar BGR u8 ``[B, 3, H, W]`` (or ``[3, H, W]``) -> upscaled YCrCb
    u8, batch over ``data``, rows over ``row`` and columns over ``col``:
    windowed K2 per block, bit-equal to K2 on the whole frame, at any
    split (uneven where an axis does not divide the size).  Raises
    ValueError where a halo would reach past one neighbour (the JAX
    version returns None where the mesh does not divide the geometry, and
    also where Mosaic has no plan)."""
    x = bgr_p[None] if bgr_p.dim() == 3 else bgr_p
    oh, ow = int(out_hw[0]), int(out_hw[1])
    out = pre_upscale_blocks(split_blocks(x, mesh), x.shape[2:], (oh, ow),
                             mesh)
    out = gather_blocks(out, device=bgr_p.device)
    return out[0] if bgr_p.dim() == 3 else out


def merge_blocks(y_blocks: np.ndarray, up_blocks: np.ndarray,
                 mesh: Mesh) -> np.ndarray:
    """K3 on each block: ``Y' [b, h, w]`` + YCrCb ``[b, 3, h, w]`` -> BGR."""
    out = np.empty(y_blocks.shape, dtype=object)
    for q in mesh.local_blocks():
        out[q] = merge_ycrcb_to_bgr_fused(y_blocks[q], up_blocks[q])
    return out


def merge_ycrcb_to_bgr_fused_rows(y_sr: torch.Tensor, up: torch.Tensor,
                                  mesh: Mesh) -> torch.Tensor:
    """``y_sr [B, oh, ow]`` + ``up [B, 3, oh, ow]`` -> planar BGR u8, K3 per
    block of the mesh (no halo; any split), bit-equal to K3 on the whole."""
    out = merge_blocks(split_blocks(y_sr, mesh), split_blocks(up, mesh), mesh)
    return gather_blocks(out, device=y_sr.device)


def upscale_blocks(blocks: np.ndarray, weights, in_hw, out_hw,
                   mesh: Mesh) -> np.ndarray:
    """The pipeline on a grid of planar BGR blocks: windowed K2, then K1
    tiled, then K3, each block on its device; returns the BGR blocks."""
    up = pre_upscale_blocks(blocks, in_hw, out_hw, mesh)
    y = np.empty(up.shape, dtype=object)
    for q in mesh.local_blocks():
        y[q] = up[q][:, 0]
    return merge_blocks(srcnn_blocks(y, weights, mesh), up, mesh)


# --- the differentiable forward ------------------------------------------------

def _clamp_feature_edges(blocks: np.ndarray, mesh: Mesh, axis: int,
                         m: int = 2) -> np.ndarray:
    """At the true image edges along grid ``axis`` (1 rows, 2 columns),
    replace the ``m`` outermost feature rows of each block ``[B, C, h +
    2m, w + 2m]`` with copies of the next one (the reference's conv3
    feature clamp, srcnn.cpp:200-210); interior sides keep their
    neighbour-derived rows."""
    dim, n = _DIM[axis], mesh.devices.shape[axis]
    out = np.empty(blocks.shape, dtype=object)
    for q in mesh.local_blocks():
        f, i = blocks[q], q[axis]
        size = f.shape[dim]
        lead = f.narrow(dim, m, 1).repeat_interleave(m, dim=dim) if i == 0 \
            else f.narrow(dim, 0, m)
        tail = f.narrow(dim, size - m - 1, 1).repeat_interleave(m, dim=dim) \
            if i == n - 1 else f.narrow(dim, size - m, m)
        out[q] = torch.cat([lead, f.narrow(dim, m, size - 2 * m), tail],
                           dim=dim)
    return out


def _params_on(weights, device: torch.device):
    """The six parameters on ``device``, differentiably (autograd adds each
    copy's gradient into the original)."""
    return types.SimpleNamespace(**{k: getattr(weights, k).to(device)
                                    for k in _KEYS})


def _srcnn_tile_f32(blocks: np.ndarray, weights, mesh: Mesh) -> np.ndarray:
    """The differentiable forward on each block of a grid of Y blocks
    ``[B, h, w]`` (0-255 domain) -> the weights' float type, same shapes.

    The counterpart of both ``_srcnn_rows_f32`` (:72-85) and
    ``_srcnn_tile2d_f32`` (:223-236): a 6-row and 6-column halo (replicate
    rows at the true edges), conv1 and conv2 valid, the feature clamp at
    the true edges, conv3 valid; a rows-only mesh is the ``col == 1`` case.
    ``weights``: an ``SRCNNWeights`` or :class:`..models.SRCNN` with 9x9,
    1x1 and 5x5 filters."""
    srcnn_only(weights, "parallel.tiling")
    ks = tuple(getattr(weights, k).shape[-1] for k in ("conv1_w", "conv2_w",
                                                      "conv3_w"))
    if ks != (9, 1, 5):
        raise ValueError(f"the tiled forward takes 9-1-5 filters, got {ks}")
    ext = _halo_exchange_cols(blocks, mesh, HALO)
    ext = _halo_exchange_rows(ext, mesh, HALO)
    f2 = np.empty(blocks.shape, dtype=object)
    params = {q: _params_on(weights, mesh.devices[q])
              for q in mesh.local_blocks()}
    with fp32_strict():
        for q, w in params.items():
            x = ext[q].to(w.conv1_w.dtype)[:, None]
            x = F.relu(F.conv2d(x, w.conv1_w, w.conv1_b))
            f2[q] = F.relu(F.conv2d(x, w.conv2_w, w.conv2_b))
        f2 = _clamp_feature_edges(_clamp_feature_edges(f2, mesh, 1), mesh, 2)
        out = np.empty(blocks.shape, dtype=object)
        for q, w in params.items():
            out[q] = F.conv2d(f2[q], w.conv3_w, w.conv3_b)[:, 0]
    return out
