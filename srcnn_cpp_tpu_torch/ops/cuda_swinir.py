"""SwinIR x2 on planar BGR frames (``csrc/swinir.cu``, with RCAN's head,
upsampler and tail: ``csrc/rcan.cu``, ``csrc/vdsr_conv.cu``).

:func:`swinir_fused` takes planar BGR uint8 ``[B, 3, H, W]`` and
``SwinIRWeights`` and returns planar BGR uint8 ``[B, 3, 2H, 2W]``: SwinIR-M
x2 (Liang et al., arXiv:2108.10257) on the frame's RGB.  On a CUDA tensor
it reflect-pads a frame whose sides are not multiples of 8 at the bottom
and right, enqueues frame by frame the head (conv 3->180 and the patch
LayerNorm), each STL's LN1 + qkv, window attention, proj + residual,
LN2 + fc1 + GELU and fc2 + residual, each RSTB's conv with the group skip,
the final LayerNorm + conv_after_body with the long skip,
conv_before_upsample with LeakyReLU, RCAN's upsampler and tail, and crops:
194 kernels a frame at the published depth.  The linears and the convs
run one GEMM body on Hopper's warpgroup MMA in 3xTF32, on token maps of
184 floats a pixel (180 channels and 4 zero pads); each of its launches
stages a unit's epilogue in shared memory, its residual bulk-copied in
and its outputs stored by one tensor copy while the next unit's products
run (:func:`gemm_smem_bytes`, ``swinir_fused.staged_epilogues``).  On a
CPU tensor it runs the plain fp32 path of :mod:`.swinir`.  The two sum in other orders, so
they agree to within 1 LSB on a small share of bytes.

This module also holds what the CPU tests check of the launch: the packed
layers (:func:`pack_gemm`, :func:`pack_swinir`, :func:`stl_layout`), the
plan with its workspace (:func:`swinir_plan`) and the kernels of a frame
(:func:`launch_schedule`); and :func:`gemm_variant`, one GEMM or one
attention on the card, for the tests there.
"""

from __future__ import annotations

import collections
import functools

import torch

from .. import runtime
from ..utils.profiling import counter_records, span
from ..weights.loader import derived
from ..weights.swinir import (DIM, FEAT, HEADS, HIDDEN, SCALE, TABLE, WINDOW,
                              SwinIRWeights, stl_prefix)
from .cuda_rcan import SHUFFLE
from .cuda_srcnn import _on_device, tf32_split
from .cuda_vdsr import CHUNKS, conv_grid, pack_layer, vdsr_smem_bytes
from .swinir import swinir_x2

__all__ = ["swinir_fused", "swinir_plain", "pack_swinir", "pack_gemm",
           "stl_layout", "swinir_plan", "launch_schedule", "gemm_launches",
           "gemm_variant", "gemm_call", "ln_stats", "pad_index",
           "PROBE_KINDS", "PROBE_FIELDS", "probe_units", "probed_kinds",
           "probe_counts", "probe_tally"]

#: the token map's floats a pixel: 180 channels and 4 zero pads
CP = 184
#: qkv's and the MLP's padded widths
QKVP, HIDP = 3 * CP, 368
#: the GEMM: pixels of a unit, input channels of a stage, the deepest
#: ring, one block's shared memory
UNIT, STAGE_CHANNELS, MAX_STAGES, SMEM_MAX = 128, 16, 5, 232448
HALF = UNIT * 4 + 8         # a staged [128 px][4 ch] plane, padded
#: K of a token map (184 channels read, 8 zero) and of the MLP's map
K_TOKENS, K_HIDDEN = 192, HIDP
#: the kinds of swinir_gemm_f32
KINDS = {"qkv": 0, "resid": 1, "fc1": 2, "conv": 3, "conv_ln": 4,
         "before_up": 5, "attention": 6}


def gemm_stage_floats(nt: int) -> int:
    """Floats of one stage of the GEMM's ring: the weights ``[2][nt][8]``
    hi and lo, then the pixels' four ``[128][4]`` planes hi and lo."""
    return 2 * nt * STAGE_CHANNELS + 2 * (STAGE_CHANNELS // 4) * HALF


def gemm_stages(nt: int) -> int:
    """The GEMM's ring depth at ``nt`` outputs a tile: as deep as fits
    beside the staged epilogue's tile (``[128][nt]`` floats) and the
    mbarriers, at most :data:`MAX_STAGES` (3 at 184, 5 at 64)."""
    fit = (SMEM_MAX - 4 * UNIT * nt - 16 * (MAX_STAGES + 1)) \
        // (4 * gemm_stage_floats(nt))
    return min(MAX_STAGES, fit)


def gemm_smem_bytes(nt: int) -> int:
    """Shared memory of a GEMM block: the ring, the staged epilogue's tile
    and the mbarriers (each stage's full and empty, the tile's ready and
    staged)."""
    stages = gemm_stages(nt)
    return 4 * (stages * gemm_stage_floats(nt) + UNIT * nt) \
        + 16 * (stages + 1)


def pack_gemm(w: torch.Tensor, b: torch.Tensor, nt: int,
              cin: int) -> torch.Tensor:
    """A linear ``w [out][in]`` or a 3x3 conv ``w [out][in][3][3]`` and its
    bias -> the GEMM's packed floats: the outputs padded with zero rows to
    tiles of ``nt``, the inputs with zero columns to ``cin`` (a multiple
    of 16: :data:`K_TOKENS` for a token map); for each tile, tap (``3 ky +
    kx``) and stage of 16 input channels, the ``[16][nt]`` matrix's tf32
    hi, then lo, in wgmma's K-major core-matrix order
    (:func:`.cuda_srcnn._k_major`: its two k8 steps one after the other),
    so that a stage's weights are one contiguous block; then the padded
    biases."""
    w = w.detach().to("cpu", torch.float32)
    if w.dim() == 2:
        w = w[:, :, None, None]
    n, c, kh, kw = w.shape
    tiles, taps, k = -(-n // nt), kh * kw, STAGE_CHANNELS
    full = torch.zeros((tiles * nt, cin, taps))
    full[:n, :c] = w.reshape(n, c, taps)
    # [tile, tap, stage, k, n]: each stage's [16][nt] matrix
    m = full.reshape(tiles, nt, cin // k, k, taps).permute(0, 4, 2, 3, 1)
    # _k_major over the leading dimensions: k8 step, n-block, K half, n % 8,
    # k % 4
    parts = [h.reshape(-1, k // 8, 2, 4, nt // 8, 8).permute(0, 1, 4, 2, 5, 3)
             .reshape(-1, k * nt) for h in tf32_split(m)]
    bias = torch.zeros(tiles * nt)
    bias[:n] = b.detach().to("cpu", torch.float32).reshape(-1)
    return torch.cat([torch.stack(parts, 1).reshape(-1), bias])


def _padded(v: torch.Tensor, n: int = CP) -> torch.Tensor:
    out = torch.zeros(n)
    out[:v.numel()] = v.detach().to("cpu", torch.float32).reshape(-1)
    return out


def stl_layout() -> dict:
    """Float offsets of one STL's packed block (``swinir.cu``'s
    ``*_OFF``): qkv (3 tiles), proj, fc1 (2 tiles) (K 192), fc2 (K 368), LN1 and
    LN2 (gains then biases, 184 each), the bias table ``[6][225]`` and 2
    pad floats; ``floats`` its size."""
    stage, k = 2 * CP * STAGE_CHANNELS, K_TOKENS // STAGE_CHANNELS
    qkv = 3 * k * stage + QKVP
    proj = k * stage + CP
    fc1 = 2 * k * stage + HIDP
    fc2 = K_HIDDEN // STAGE_CHANNELS * stage + CP
    out = {"qkv": 0, "proj": qkv, "fc1": qkv + proj,
           "fc2": qkv + proj + fc1}
    out["ln1"] = out["fc2"] + fc2
    out["ln2"] = out["ln1"] + 2 * CP
    out["table"] = out["ln2"] + 2 * CP
    out["floats"] = out["table"] + HEADS * TABLE + 2
    return out


def _norm(weights, name) -> torch.Tensor:
    return torch.cat([_padded(t) for t in weights.pair(name)])


def _pack(weights: SwinIRWeights) -> tuple:
    _pack.calls += 1
    with span("srcnn.build.swinir_weights"):
        def get(name):
            return tuple(t.detach().to("cpu", torch.float32)
                         for t in weights.pair(name))

        w, b = get("conv_first")
        head = torch.zeros((27, CP))
        head[:, :DIM] = w.reshape(DIM, 27).t() / 255.0
        head = torch.cat([head.reshape(-1), _padded(b),
                          _norm(weights, "patch_embed.norm")])
        stls = []
        for r in range(weights.groups):
            for i in range(weights.depth):
                p = stl_prefix(r, i)
                table = weights.params[
                    f"{p}.attn.relative_position_bias_table"]
                stls += [pack_gemm(*get(f"{p}.attn.qkv"), CP, K_TOKENS),
                         pack_gemm(*get(f"{p}.attn.proj"), CP, K_TOKENS),
                         pack_gemm(*get(f"{p}.mlp.fc1"), CP, K_TOKENS),
                         pack_gemm(*get(f"{p}.mlp.fc2"), CP, K_HIDDEN),
                         _norm(weights, f"{p}.norm1"),
                         _norm(weights, f"{p}.norm2"),
                         table.detach().to("cpu", torch.float32).t()
                         .reshape(-1), torch.zeros(2)]
        convs = [pack_gemm(*get(f"layers.{r}.conv"), CP, K_TOKENS)
                 for r in range(weights.groups)]
        convs += [_norm(weights, "norm"),
                  pack_gemm(*get("conv_after_body"), CP, K_TOKENS),
                  pack_gemm(*get("conv_before_upsample.0"), FEAT, K_TOKENS)]
        w, b = get("upsample.0")
        up = [pack_layer(w[q::len(SHUFFLE)], b[q::len(SHUFFLE)])
              for q in range(len(SHUFFLE))]
        # RCAN's tail adds 255 mean and clamps to [0, 255]: SwinIR's
        # conv_last in [0, 1], times 255
        w, b = get("conv_last")
        tail = torch.cat([(w * 255.0).reshape(3, FEAT, -1).permute(0, 2, 1)
                          .reshape(-1), b * 255.0, torch.zeros(1)])
        return tuple(t.to(weights.device) for t in
                     (head, torch.cat(stls), torch.cat(convs),
                      torch.cat(up), tail))


_pack.calls = 0   # how often pack_swinir really packed (not cached)


def pack_swinir(weights: SwinIRWeights) -> tuple:
    """``(head, stls, convs, up, tail)``, the kernels' float32 weight
    buffers on the weights' device, built once per weights object and kept
    while its tensors are unchanged (:func:`..weights.loader.derived`): the
    head conv over 255 as ``[27 (RGB, ky, kx)][184]``, its biases and the
    patch LayerNorm's; each STL's block (:func:`stl_layout`); the RSTB
    convs, the final LayerNorm, conv_after_body and conv_before_upsample
    (:func:`pack_gemm`); the upsampler's four output groups as RCAN packs
    them; the tail conv times 255 as ``[3 (RGB)][9 taps][64]``, its 3
    biases times 255 and a 0."""
    return derived(weights, "swinir", weights.as_dict().values(), _pack,
                   weights)


def _check_widths(weights: SwinIRWeights) -> None:
    if (weights.dim, weights.heads, weights.hidden) != (DIM, HEADS, HIDDEN):
        raise ValueError(f"the CUDA SwinIR runs the published widths "
                         f"({DIM} channels, {HEADS} heads, an MLP of "
                         f"{HIDDEN}), not {weights.dim}, {weights.heads}, "
                         f"{weights.hidden}")


@functools.lru_cache(maxsize=256)
def _plan(h: int, w: int, num_sms: int) -> tuple[int, int, int, int]:
    """``(units, grid, up_grid, workspace floats)`` of one padded frame."""
    with span("srcnn.build.swinir_plan"):
        units = -(-h * w // UNIT)
        grid = min(num_sms, units)
        _, up_grid = conv_grid(h, w, num_sms)
        return units, grid, up_grid, h * w * (4 * CP + QKVP + 2)


def swinir_plan(h: int, w: int, num_sms: int) -> dict:
    """The launch on an ``h x w`` frame (multiples of 8): the GEMM's
    ``units`` of 128 pixels and persistent ``grid``, the upsampler's
    ``up_grid`` and ``up_smem`` (as :func:`.cuda_vdsr.vdsr_plan` plans
    RCAN's), and ``workspace_floats``, the call's scratch: four token maps
    of ``h x w x 184`` float32, one of ``h x w x 552`` and LayerNorm's
    statistics, 2 floats a pixel (10.7 GB at 1080p); the frames of a call
    run one after another through it."""
    units, grid, up_grid, workspace = _plan(h, w, num_sms)
    return {"units": units, "grid": grid, "up_grid": up_grid,
            "up_smem": vdsr_smem_bytes(), "workspace_floats": workspace}


def launch_schedule(groups: int, depth: int) -> list[tuple]:
    """The kernels ``swinir_x2_u8`` enqueues for a frame, in order: ``(kernel,
    what)``."""
    out = [("swinir_head_kernel", "conv_first + patch_embed.norm")]
    for r in range(groups):
        for i in range(depth):
            out += [("swin_stl_linear_kernel", "norm1 + qkv"),
                    ("swin_stl_attention_kernel",
                     "shifted" if i % 2 else "unshifted"),
                    ("swin_stl_linear_kernel", "proj + residual"),
                    ("swin_stl_linear_kernel", "norm2 + fc1 + gelu"),
                    ("swin_stl_linear_kernel", "fc2 + residual")]
        out.append(("swinir_conv3x3_kernel", "conv + group skip"))
    out += [("swinir_conv3x3_kernel", "norm + conv_after_body + f0"),
            ("swinir_conv3x3_kernel", "conv_before_upsample + leaky")]
    out += [("rcan_conv3x3_kernel", "upsample")] * len(SHUFFLE)
    return out + [("rcan_tail_kernel", "conv_last")]


#: the kernels of the GEMM body: each launch runs the staged epilogue
GEMM_KERNELS = ("swin_stl_linear_kernel", "swinir_conv3x3_kernel")


#: the kinds of the two warp-specialised GEMM bodies whose stall counters
#: their probed instances keep (``csrc/probe.cuh``'s ``ProbeKind``, in its
#: order), as ``(body, kind)``: this module's GEMM body, ``swinir_gemm``
#: (the 180->180 convs one kind, conv_before_upsample another); and the
#: 64->64 body of ``csrc/vdsr_conv.cu``, ``conv3x3``, one kind an instance
#: (VDSR's, then RCAN's ``<EPI, LOAD>``, which also runs SwinIR's
#: upsampler)
PROBE_KINDS = (("swinir_gemm", "qkv"), ("swinir_gemm", "proj"),
               ("swinir_gemm", "fc1"), ("swinir_gemm", "fc2"),
               ("swinir_gemm", "conv"), ("swinir_gemm", "before_up"),
               ("conv3x3", "vdsr"), ("conv3x3", "relu"), ("conv3x3", "pool"),
               ("conv3x3", "skip"), ("conv3x3", "shuffle"),
               ("conv3x3", "relu_apply"), ("conv3x3", "skip_apply_last"))
#: a kind's counters (``probe.cuh``'s ``Probe``): the launches; the
#: consumers' units, their cycles from the first wait on ``full`` to the
#: end of the epilogue, the cycles waiting on ``full`` and the epilogue's
#: (cycles summed over a block's two consumer warpgroups); the producer's
#: stages, its cycles not waiting on ``empty`` (its fills) and waiting
PROBE_FIELDS = ("launches", "units", "unit_cycles", "full_wait_cycles",
                "epilogue_cycles", "stages", "fill_cycles",
                "empty_wait_cycles")


#: a SwinIR GEMM kind's output tiles and stages a unit (taps x stages of
#: 16 input channels)
_GEMM_SHAPE = {"qkv": (3, K_TOKENS // STAGE_CHANNELS),
               "proj": (1, K_TOKENS // STAGE_CHANNELS),
               "fc1": (2, K_TOKENS // STAGE_CHANNELS),
               "fc2": (1, K_HIDDEN // STAGE_CHANNELS),
               "conv": (1, 9 * K_TOKENS // STAGE_CHANNELS),
               "before_up": (1, 9 * K_TOKENS // STAGE_CHANNELS)}


def probe_units(body: str, kind: str, h: int, w: int) -> tuple[int, int]:
    """``(units, stages)`` that one launch of a kind of :data:`PROBE_KINDS`
    counts on an ``h x w`` map: SwinIR's units of 128 pixels by an output
    tile, of 12 to 108 stages; the 64->64 body's units of 2 rows by 128
    columns (:func:`.cuda_vdsr.conv_grid`), of 8 stages (``CHUNKS``)."""
    if body == "swinir_gemm":
        tiles, stages = _GEMM_SHAPE[kind]
        units = -(-h * w // UNIT) * tiles
    else:
        units, stages = conv_grid(h, w, 1)[0], CHUNKS
    return units, units * stages


def probe_counts(per_frame: dict, frames: int, h: int, w: int) -> dict:
    """``{(body, kind): (launches, units, stages)}`` that ``frames`` frames
    of ``h x w`` count, from each kind's launches a frame (``per_frame``:
    :func:`probed_kinds`, ``cuda_rcan.probed_kinds``)."""
    out = {}
    for (body, kind), n in per_frame.items():
        units, stages = probe_units(body, kind, h, w)
        out[body, kind] = (frames * n, frames * n * units,
                           frames * n * stages)
    return out


def probe_tally(found: dict) -> dict:
    """``{(body, kind): (launches, units, stages)}`` of
    ``utils.profiling.kernel_counters()``'s result, to compare with
    :func:`probe_counts`.  ValueError where a kind's waits on ``full`` and
    epilogues, or its producer's waits on ``empty``, outlast its units'
    cycles, or it took no cycles: the counters would be at fault."""
    out = {}
    for body, kinds in found.items():
        for kind, c in kinds.items():
            if c["full_wait_cycles"] + c["epilogue_cycles"] \
                    > c["unit_cycles"] \
                    or c["empty_wait_cycles"] > c["unit_cycles"] \
                    or not (c["fill_cycles"] and c["unit_cycles"]):
                raise ValueError(f"{body}.{kind}: counters {c}")
            out[body, kind] = (c["launches"], c["units"], c["stages"])
    return out


#: the GEMM kind of each launch of :func:`launch_schedule` that has one
_PROBE_KIND = {"norm1 + qkv": ("swinir_gemm", "qkv"),
               "proj + residual": ("swinir_gemm", "proj"),
               "norm2 + fc1 + gelu": ("swinir_gemm", "fc1"),
               "fc2 + residual": ("swinir_gemm", "fc2"),
               "conv + group skip": ("swinir_gemm", "conv"),
               "norm + conv_after_body + f0": ("swinir_gemm", "conv"),
               "conv_before_upsample + leaky": ("swinir_gemm", "before_up"),
               "upsample": ("conv3x3", "shuffle")}


def probed_kinds(groups: int, depth: int) -> dict:
    """The launches a frame of each GEMM kind (:data:`PROBE_KINDS`) in
    :func:`launch_schedule`."""
    return dict(collections.Counter(
        _PROBE_KIND[what] for _, what in launch_schedule(groups, depth)
        if what in _PROBE_KIND))


def gemm_launches(groups: int, depth: int) -> int:
    """The GEMM body's launches a frame (:func:`launch_schedule`): 4
    linears an STL and the ``groups + 2`` 180-wide convs, 152 at the
    published depth."""
    return sum(k in GEMM_KERNELS for k, _ in launch_schedule(groups, depth))


def pad_index(n: int) -> torch.Tensor:
    """The rows (or columns) of a side of ``n`` reflect-padded at its end to
    a multiple of 8 (``F.pad`` ``reflect``: ``n - 1`` is not repeated)."""
    m = n + (-n % WINDOW)
    i = torch.arange(m)
    return torch.where(i < n, i, 2 * (n - 1) - i)


def swinir_plain(bgr_p: torch.Tensor, weights: SwinIRWeights
                 ) -> torch.Tensor:
    """The fp32 path (TF32 off): :func:`.swinir.swinir_x2`."""
    swinir_plain.calls += 1
    return swinir_x2(bgr_p, weights)


swinir_plain.calls = 0


def swinir_fused(bgr_p: torch.Tensor, weights: SwinIRWeights,
                 out_hw: tuple[int, int]) -> torch.Tensor:
    """Planar BGR uint8 ``[B, 3, H, W]`` -> planar BGR uint8 ``[B, 3, oh,
    ow]``, on the weights' device.  SwinIR x2 upscales by 2 only: an
    ``out_hw`` other than ``(2H, 2W)`` raises ValueError."""
    if not isinstance(weights, SwinIRWeights):
        raise TypeError(f"SwinIR takes SwinIRWeights, got "
                        f"{type(weights).__name__}")
    if bgr_p.dtype != torch.uint8:
        raise TypeError(f"expected uint8, got {bgr_p.dtype}")
    if bgr_p.dim() != 4 or bgr_p.shape[1] != 3 or min(bgr_p.shape[2:]) <= 0:
        raise ValueError(f"expected planar BGR [B,3,H,W], got "
                         f"{tuple(bgr_p.shape)}")
    b, _, h, w = bgr_p.shape
    if tuple(out_hw) != (SCALE * h, SCALE * w):
        raise ValueError(f"SwinIR x{SCALE} upscales by {SCALE} only: "
                         f"[{h}, {w}] to {tuple(out_hw)}")
    _on_device(bgr_p, weights.device)
    with span("srcnn.swinir"):
        if bgr_p.device.type == "cpu":
            return swinir_plain(bgr_p, weights)
        _check_widths(weights)
        x = bgr_p
        if h % WINDOW or w % WINDOW:
            x = x[:, :, pad_index(h).to(x.device)][..., pad_index(w)
                                                    .to(x.device)]
        x = x.contiguous()
        hp, wp = x.shape[2:]
        out = torch.empty((b, 3, SCALE * hp, SCALE * wp), dtype=torch.uint8,
                          device=x.device)
        if b > 0:
            head, stls, convs, up, tail = pack_swinir(weights)
            plan = swinir_plan(hp, wp, runtime.num_sms())
            ws = torch.empty(plan["workspace_floats"], dtype=torch.float32,
                             device=x.device)
            with torch.cuda.device(x.device):
                runtime.check(runtime.library().swinir_x2_u8(
                    x.data_ptr(), x.stride(0), head.data_ptr(),
                    stls.data_ptr(), convs.data_ptr(), up.data_ptr(),
                    tail.data_ptr(), ws.data_ptr(), out.data_ptr(), b, hp,
                    wp, weights.groups, weights.depth, plan["grid"],
                    plan["up_grid"], plan["up_smem"],
                    float((DIM // HEADS) ** -0.5), runtime.current_stream(),
                    counter_records(x.device)), "swinir_x2_u8")
            swinir_fused.launches += 1
            swinir_fused.windows += b * weights.groups * weights.depth \
                * (hp // WINDOW) * (wp // WINDOW)
            swinir_fused.staged_epilogues += b * gemm_launches(
                weights.groups, weights.depth)
        if (hp, wp) != (h, w):
            out = out[:, :, :SCALE * h, :SCALE * w].contiguous()
        return out


swinir_fused.launches = 0
#: windows attended, each by every head: groups x depth x windows a frame
swinir_fused.windows = 0
#: GEMM launches that staged their epilogue in shared memory and moved it
#: with bulk copies: :func:`gemm_launches` a frame
swinir_fused.staged_epilogues = 0


def ln_stats(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm's statistics of each token of ``x [..., 184]`` over its
    180 channels, as the kernels keep them: ``(mean, 1 / sqrt(var +
    1e-5))``, float32 ``[..., 2]`` (computed in float64)."""
    v = x[..., :DIM].double()
    mean = v.mean(-1)
    var = ((v - mean[..., None]) ** 2).mean(-1)
    return torch.stack([mean, (var + 1e-5).rsqrt()], -1).float()


def gemm_variant(kind: str, x: torch.Tensor, w: torch.Tensor | None = None,
                 b: torch.Tensor | None = None,
                 skip: torch.Tensor | None = None,
                 ln: tuple | None = None, table: torch.Tensor | None = None,
                 shift: int = 0, alias: bool = False) -> dict:
    """One launch of the body on a CUDA map ``x [H, W, cin]`` (cin 184 or
    368, pads zero), for the tests on the card.  ``kind`` of
    :data:`KINDS`: ``qkv`` and ``fc1`` (``ln`` the ``(gain, bias)`` of the
    LayerNorm their loader forms, from the statistics of :func:`ln_stats`),
    ``resid`` and ``conv`` (a linear or a 3x3 conv and the ``skip [H, W,
    184]``; the epilogue also stores the output's statistics), ``conv_ln``
    (a 3x3 conv of the LayerNorm ``ln`` of ``x``, formed in the loader,
    and the skip: conv_after_body), ``before_up`` (a 3x3 conv 180->64,
    LeakyReLU), with ``w``, ``b`` the layer as the authors hold it; ``attention`` on a qkv map ``[H, W, 552]`` with ``table [225, 6]``
    and ``shift``.  ``alias``: the output map starts as a copy of
    ``skip`` and is passed as the skip too, so the kernel reads the
    residual from the map it writes, as proj and fc2 run in place.
    Returns ``{"out", "stats"}``: the output map (``[H, W, 552]``, ``[H,
    W, 368]``, ``[H, W, 184]`` or ``[H, W, 64]``) and, for ``resid`` and
    ``conv``, the statistics ``[H, W, 2]`` it stored."""
    launch, result = gemm_call(kind, x, w, b, skip, ln, table, shift, alias)
    launch()
    return result


def gemm_call(kind: str, x: torch.Tensor, w: torch.Tensor | None = None,
              b: torch.Tensor | None = None, skip: torch.Tensor | None = None,
              ln: tuple | None = None, table: torch.Tensor | None = None,
              shift: int = 0, alias: bool = False) -> tuple:
    """:func:`gemm_variant`'s launch, with its buffers made once:
    ``(launch, result)``, where each ``launch()`` enqueues the launch again
    (probed while a profiler records) and ``result`` is the dict that
    :func:`gemm_variant` returns, which the launches write."""
    h, wd, cin = x.shape
    x = x.contiguous()
    width = {"qkv": QKVP, "fc1": HIDP, "before_up": FEAT}.get(kind, CP)
    out = torch.full((h, wd, width), float("nan"), device=x.device)
    stats = None
    if kind in ("qkv", "fc1", "conv_ln"):
        stats = ln_stats(x).contiguous()
    elif kind in ("resid", "conv"):
        stats = torch.full((h, wd, 2), float("nan"), device=x.device)
    if kind == "attention":
        packed = table.detach().to(torch.float32).t().contiguous() \
            .to(x.device)
        wfloats, cin = 0, shift
    else:
        nt = FEAT if kind == "before_up" else CP
        packed = pack_gemm(w, b, nt, -(-cin // STAGE_CHANNELS)
                           * STAGE_CHANNELS).to(x.device)
        wfloats = packed.numel() - (-(-w.shape[0] // nt) * nt)
    lnp = torch.cat([_padded(t) for t in ln]).to(x.device) \
        if ln is not None else None
    skip = skip.contiguous() if skip is not None else None
    if alias:
        out = skip = skip.clone()
    grid = min(runtime.num_sms(), -(-h * wd // UNIT))

    def ptr(v):
        return v.data_ptr() if v is not None else None

    def launch():
        with torch.cuda.device(x.device):
            runtime.check(runtime.library().swinir_gemm_f32(
                KINDS[kind], x.data_ptr(), out.data_ptr(), packed.data_ptr(),
                wfloats, ptr(skip), ptr(lnp), ptr(stats), h, wd, cin, grid,
                float((DIM // HEADS) ** -0.5), runtime.current_stream(),
                counter_records(x.device)), "swinir_gemm_f32")

    return launch, {"out": out, "stats": stats if kind in ("resid", "conv")
                    else None}
