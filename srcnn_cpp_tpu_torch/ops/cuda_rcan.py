"""RCAN x2 on planar BGR frames (``csrc/rcan.cu``, with the 64->64 conv of
``csrc/vdsr_conv.cu``).

:func:`rcan_fused` takes planar BGR uint8 ``[B, 3, H, W]`` and
``RCANWeights`` and returns planar BGR uint8 ``[B, 3, 2H, 2W]``: RCAN x2
(Zhang et al., arXiv:1807.02758) on the frame's RGB, quantized as the
authors' ``quantize``.  On a CUDA tensor it enqueues, frame by frame, the
head (3->64, SIMT), each RCAB's two 64->64 convs on Hopper's warpgroup MMA
in 3xTF32 (the kernel VDSR runs, with RCAN's epilogues: the second conv
sums its outputs per channel for channel attention; and its loaders: the
conv that reads an RCAB's result computes the RCAB's attention ``s`` from
those sums and forms ``x + s * t`` as it stages its input), each group's
last conv and the body conv with their skips added in the epilogue, the
upsampler as four 64->64 convs storing pixel-shuffled, and the tail (64->3
at the output size, SIMT) with the mean, the clamp and the rounding fused
in: 417 kernels a frame at the published depth.  On a CPU tensor it runs the
plain fp32 ``F.conv2d`` path of :mod:`.rcan`.  The two sum in other
orders, so they agree to within 1 LSB on a small share of bytes.

This module also holds what the CPU tests check of the launch: the order
of the packed layers (:func:`mid_order`), the packed buffers
(:func:`pack_rcan`), the plan with its workspace (:func:`rcan_plan`) and
the kernels of a frame with the maps each reads and writes
(:func:`launch_schedule`); and :func:`conv3x3_variant`, one layer with one
epilogue and one loader, for the tests on the card.
"""

from __future__ import annotations

import collections
import functools

import torch

from .. import runtime
from ..utils.profiling import counter_records, span
from ..weights.loader import derived
from ..weights.rcan import CHANNELS, COLORS, SCALE, RCANWeights, rcab_prefix
from .cuda_srcnn import _on_device
from .cuda_vdsr import conv_grid, pack_layer, vdsr_smem_bytes
from .rcan import rcan_x2

__all__ = ["rcan_fused", "rcan_plain", "pack_rcan", "mid_order",
           "rcan_plan", "launch_schedule", "probed_kinds", "conv3x3_variant",
           "conv3x3_call"]

#: floats of one RCAB's channel attention: W1 [4][64], b1, W2 [64][4], b2
CA_FLOATS = 4 * CHANNELS + 4 + CHANNELS * 4 + CHANNELS
#: the conv's epilogues and loaders (``csrc/conv3x3.cuh``)
EPILOGUES = {"relu": 0, "pool": 1, "skip": 2, "shuffle": 3}
LOADERS = {"plain": 0, "apply": 1, "apply_last": 2}
#: the upsampler's output groups: group ``q`` holds output channels
#: ``4c + 2dy + dx`` of ``(dy, dx) = SHUFFLE[q]``, stored at ``(2h + dy,
#: 2w + dx)``
SHUFFLE = ((0, 0), (0, 1), (1, 0), (1, 1))
MAPS = 6           # input-size maps of the workspace
POOL_PARTS = 2     # pool partial sums of a conv block: one a consumer


def mid_order(groups: int, blocks: int) -> list[tuple[str, int | None]]:
    """The packed 64-input layers in launch order: ``(conv name, None)``,
    or ``("tail.0.0", q)`` for the upsampler's output group ``q``."""
    out = []
    for g in range(groups):
        for b in range(blocks):
            p = rcab_prefix(g, b)
            out += [(f"{p}.0", None), (f"{p}.2", None)]
        out.append((f"body.{g}.body.{blocks}", None))
    out.append((f"body.{groups}", None))
    return out + [("tail.0.0", q) for q in range(len(SHUFFLE))]


def launch_schedule(groups: int, blocks: int) -> list[tuple]:
    """The kernels ``rcan_x2_u8`` enqueues for a frame, in order: ``(kernel,
    epilogue, loader, maps read, maps written)``, the maps named after the
    workspace's (``h`` the head's output, ``g0``, ``g1`` the group maps,
    ``x``, ``a``, ``t``, ``hr`` the upsampled map, ``pool`` the partial
    sums).  RCAB ``k``'s result ``x_k = x_{k-1} + s_k t_k`` (``x_{-1}`` the
    group's input) is formed by the loader of the conv after it, which
    stores it for ``k < blocks - 1`` in ``x`` where ``blocks - 2 - k`` is
    even, else in the map the group's last conv writes."""
    out = [("head", None, None, ("frame",), ("h",))]
    gin = "h"
    for g in range(groups):
        gout = f"g{g % 2}"
        xprev = gin
        for k in range(blocks):
            if k == 0:
                out.append(("conv", "relu", "plain", (gin,), ("a",)))
            else:
                x = "x" if (blocks - 1 - k) % 2 == 0 else gout
                out.append(("conv", "relu", "apply", (xprev, "t", "pool"),
                            ("a", x)))
                xprev = x
            out.append(("conv", "pool", "plain", ("a",), ("t", "pool")))
        out.append(("conv", "skip", "apply_last", (xprev, "t", "pool", gin),
                    (gout,)))
        gin = gout
    out.append(("conv", "skip", "plain", (gin, "h"), ("x",)))
    out += [("conv", "shuffle", "plain", ("x",), ("hr",))] * len(SHUFFLE)
    return out + [("tail", None, None, ("hr",), ("out",))]


def probed_kinds(groups: int, blocks: int) -> dict:
    """The launches a frame of each 64->64 conv kind
    (``cuda_swinir.PROBE_KINDS``: the epilogue, and the loader after it
    unless plain) in :func:`launch_schedule`."""
    return dict(collections.Counter(
        ("conv3x3", epi if load == "plain" else f"{epi}_{load}")
        for kernel, epi, load, *_ in launch_schedule(groups, blocks)
        if kernel == "conv"))


def _pack(weights: RCANWeights) -> tuple:
    _pack.calls += 1
    with span("srcnn.build.rcan_weights"):
        def get(name):
            return tuple(t.detach().to("cpu", torch.float32)
                         for t in weights.pair(name))

        w, b = get("head.0")
        head = torch.cat([w.reshape(CHANNELS, -1).t().reshape(-1), b])
        mid = []
        for name, q in mid_order(weights.groups, weights.blocks):
            w, b = get(name)
            if q is not None:
                w, b = w[q::len(SHUFFLE)], b[q::len(SHUFFLE)]
            mid.append(pack_layer(w, b))
        ca = []
        for g in range(weights.groups):
            for k in range(weights.blocks):
                p = rcab_prefix(g, k)
                for name in (f"{p}.3.conv_du.0", f"{p}.3.conv_du.2"):
                    ca += [t.reshape(-1) for t in get(name)]
        w, b = get("tail.1")
        tail = torch.cat([w.reshape(COLORS, CHANNELS, -1).permute(0, 2, 1)
                          .reshape(-1), b, torch.zeros(1)])
        return tuple(t.to(weights.device) for t in
                     (head, torch.cat(mid), torch.cat(ca), tail))


_pack.calls = 0   # how often pack_rcan really packed (not cached)


def pack_rcan(weights: RCANWeights) -> tuple:
    """``(head, middle, ca, tail)``, the kernels' float32 weight buffers on
    the weights' device, built once per weights object and kept while its
    tensors are unchanged (:func:`..weights.loader.derived`): the head conv
    as ``[27 (RGB, ky, kx)][64]`` and its 64 biases; the 64-input layers of
    :func:`mid_order`, each packed as :func:`.cuda_vdsr.pack_layer` packs
    VDSR's; each RCAB's :data:`CA_FLOATS`; the tail conv as ``[3 (RGB)][9
    taps][64]``, its 3 biases and a 0."""
    return derived(weights, "rcan", weights.as_dict().values(), _pack,
                   weights)


@functools.lru_cache(maxsize=256)
def _plan(h: int, w: int, num_sms: int) -> tuple[int, int, int]:
    """``(units, grid, workspace floats)`` of one frame."""
    with span("srcnn.build.rcan_plan"):
        units, grid = conv_grid(h, w, num_sms)
        feature_map = h * w * CHANNELS
        workspace = (MAPS + SCALE * SCALE) * feature_map \
            + grid * POOL_PARTS * CHANNELS
        return units, grid, workspace


def rcan_plan(h: int, w: int, num_sms: int) -> dict:
    """The launch on an ``h x w`` frame: the 64->64 kernel's ``units`` and
    persistent ``grid`` (as :func:`.cuda_vdsr.vdsr_plan` plans VDSR's) and
    ``smem_bytes``; ``workspace_floats``, the call's scratch: 6 feature
    maps of ``h x w x 64`` float32 and one of ``2h x 2w x 64`` (5.3 GB at
    1080p) and the pool's partial sums (``grid x 2 x 64``); the frames of a
    call run one after another through it."""
    units, grid, workspace = _plan(h, w, num_sms)
    return {"units": units, "grid": grid, "smem_bytes": vdsr_smem_bytes(),
            "workspace_floats": workspace}


def rcan_plain(bgr_p: torch.Tensor, weights: RCANWeights) -> torch.Tensor:
    """The fp32 ``F.conv2d`` path (TF32 off): :func:`.rcan.rcan_x2`."""
    rcan_plain.calls += 1
    return rcan_x2(bgr_p, weights)


rcan_plain.calls = 0


def rcan_fused(bgr_p: torch.Tensor, weights: RCANWeights,
               out_hw: tuple[int, int]) -> torch.Tensor:
    """Planar BGR uint8 ``[B, 3, H, W]`` -> planar BGR uint8 ``[B, 3, oh,
    ow]``, on the weights' device.  RCAN x2 upscales by 2 only: an
    ``out_hw`` other than ``(2H, 2W)`` raises ValueError."""
    if not isinstance(weights, RCANWeights):
        raise TypeError(f"RCAN takes RCANWeights, got "
                        f"{type(weights).__name__}")
    if bgr_p.dtype != torch.uint8:
        raise TypeError(f"expected uint8, got {bgr_p.dtype}")
    if bgr_p.dim() != 4 or bgr_p.shape[1] != 3 or min(bgr_p.shape[2:]) <= 0:
        raise ValueError(f"expected planar BGR [B,3,H,W], got "
                         f"{tuple(bgr_p.shape)}")
    b, _, h, w = bgr_p.shape
    if tuple(out_hw) != (SCALE * h, SCALE * w):
        raise ValueError(f"RCAN x{SCALE} upscales by {SCALE} only: "
                         f"[{h}, {w}] to {tuple(out_hw)}")
    _on_device(bgr_p, weights.device)
    with span("srcnn.rcan"):
        if bgr_p.device.type == "cpu":
            return rcan_plain(bgr_p, weights)
        x = bgr_p.contiguous()
        out = torch.empty((b, 3, SCALE * h, SCALE * w), dtype=torch.uint8,
                          device=x.device)
        if b > 0:
            head, middle, ca, tail = pack_rcan(weights)
            plan = rcan_plan(h, w, runtime.num_sms())
            ws = torch.empty(plan["workspace_floats"], dtype=torch.float32,
                             device=x.device)
            with torch.cuda.device(x.device):
                runtime.check(runtime.library().rcan_x2_u8(
                    x.data_ptr(), x.stride(0), head.data_ptr(),
                    middle.data_ptr(), ca.data_ptr(), tail.data_ptr(),
                    ws.data_ptr(), out.data_ptr(), b, h, w, weights.groups,
                    weights.blocks, plan["grid"], plan["smem_bytes"],
                    runtime.current_stream(), counter_records(x.device)),
                "rcan_x2_u8")
            rcan_fused.launches += 1
            rcan_fused.ca_folded += b * weights.groups * weights.blocks
        return out


rcan_fused.launches = 0
#: RCABs whose channel attention ran in a conv's loader (every one on CUDA)
rcan_fused.ca_folded = 0


def conv3x3_variant(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    epilogue: str, skip: torch.Tensor | None = None,
                    q: int = 0, t: torch.Tensor | None = None,
                    ca_pool: torch.Tensor | None = None,
                    ca: torch.Tensor | None = None,
                    grouped: bool = False) -> dict:
    """One 64->64 layer of the shared kernel on an NHWC float32 CUDA map
    ``x [H, W, 64]`` with the epilogue named in :data:`EPILOGUES`.

    Given ``t [H, W, 64]``, pool sums ``ca_pool [parts, 64]`` and one
    RCAB's :data:`CA_FLOATS` weights ``ca``, the loader forms the conv's
    input ``x + s * t`` (``"apply"``; ``"apply_last"`` with the ``"skip"``
    epilogue), ``s`` the RCAB's attention over the ``H x W`` pixels; with
    ``grouped`` it reads ``x`` grouped, as it reads an RCAB's result.  The
    maps are given and returned NHWC; those that RCAN keeps grouped
    (:func:`to_grouped`) are converted around the launch.  Returns
    ``{"out", "pool", "x", "s"}``: ``out`` is ``[H, W, 64]``, or ``[2H,
    2W, 64]`` for ``"shuffle"``, which writes output group ``q``
    (:data:`SHUFFLE`) of a zeroed map; ``pool`` the partial sums ``[grid,
    2, 64]`` for ``"pool"``; ``x`` the input the loader formed and stored
    (``"apply"``) and ``s`` the attention (64), else None."""
    launch, result = conv3x3_call(x, w, b, epilogue, skip, q, t, ca_pool, ca,
                                  grouped)
    launch()
    return result()


def conv3x3_call(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 epilogue: str, skip: torch.Tensor | None = None, q: int = 0,
                 t: torch.Tensor | None = None,
                 ca_pool: torch.Tensor | None = None,
                 ca: torch.Tensor | None = None,
                 grouped: bool = False) -> tuple:
    """:func:`conv3x3_variant`'s launch, with its buffers made once:
    ``(launch, result)``, where each ``launch()`` enqueues the layer again
    (probed while a profiler records) and ``result()`` returns the dict
    that :func:`conv3x3_variant` returns, of the last launch."""
    h, wd, _ = x.shape
    plan = rcan_plan(h, wd, runtime.num_sms())
    x = to_grouped(x) if grouped else x.contiguous()
    scale = SCALE if epilogue == "shuffle" else 1
    out = torch.zeros((scale * h, scale * wd, CHANNELS), dtype=torch.float32,
                      device=x.device)
    pool = torch.zeros((plan["grid"], POOL_PARTS, CHANNELS),
                       dtype=torch.float32, device=x.device) \
        if epilogue == "pool" else None
    load = "plain"
    xs = s = None
    if t is not None:
        load = "apply_last" if epilogue == "skip" else "apply"
        t, ca_pool, ca = to_grouped(t), ca_pool.contiguous(), ca.contiguous()
        s = torch.full((CHANNELS,), float("nan"), device=x.device)
        if load == "apply":
            xs = torch.full((h * wd * CHANNELS,), float("nan"),
                            device=x.device)
    packed = pack_layer(w, b).to(x.device)
    skip = skip.contiguous() if skip is not None else None

    def ptr(v):
        return v.data_ptr() if v is not None else None

    dy, dx = SHUFFLE[q]

    def launch():
        with torch.cuda.device(x.device):
            runtime.check(runtime.library().rcan_conv3x3_f32(
                EPILOGUES[epilogue], LOADERS[load], x.data_ptr(),
                out.data_ptr(), packed.data_ptr(), ptr(skip), ptr(pool),
                ptr(t), ptr(ca_pool), ptr(ca), ptr(xs), ptr(s),
                ca_pool.shape[0] if ca_pool is not None else 0, int(grouped),
                dy, dx, h, wd, plan["grid"], plan["smem_bytes"],
                runtime.current_stream(), counter_records(x.device)),
                "rcan_conv3x3_f32")

    def result():
        return {"out": out if pool is None
                else from_grouped(out.reshape(-1), h, wd), "pool": pool,
                "x": from_grouped(xs, h, wd) if xs is not None else None,
                "s": s}

    return launch, result


def to_grouped(x: torch.Tensor) -> torch.Tensor:
    """NHWC ``[H, W, 64]`` -> the layout in which the pool epilogue stores
    ``t`` and the apply loader an RCAB's result, flat: ``[8][H][W][8]``,
    channels ``8q .. 8q + 7`` of every pixel together."""
    h, w, c = x.shape
    return x.reshape(h, w, c // 8, 8).permute(2, 0, 1, 3).contiguous() \
        .reshape(-1)


def from_grouped(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """:func:`to_grouped`'s inverse: NHWC ``[h, w, 64]``."""
    return x.reshape(CHANNELS // 8, h, w, 8).permute(1, 2, 0, 3) \
        .reshape(h, w, CHANNELS)
