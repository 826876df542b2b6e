"""K1, K4, K5: the fused SRCNN 9-5-5 conv stack (``csrc/srcnn_conv.cu``).

One CUDA kernel template, three stores, each the counterpart of an entry of
``srcnn_cpp_tpu/ops/pallas_srcnn.py``:

* K1 :func:`srcnn_y_fused` (``srcnn_y_fused`` :636): conv1 + conv2 + conv3
  + IntTrim quantization, Y u8 -> Y' u8;
* K4 :func:`srcnn_merge_fused` (``srcnn_merge_fused`` :695): K1, then the
  merge with the upscaled Cr/Cb and the inverse color transform, upscaled
  YCrCb u8 -> planar BGR u8;
* K5 :func:`srcnn_y_f32_fused` (the legacy ``_kernel`` :157): conv3 + b3
  in f32, unquantized.

None writes a feature map to device memory; the reference's input-level
clamp for conv1 and feature-level clamp for conv3 (srcnn.cpp:200-210,
269-280) are computed inside the kernel.  Each wrapper launches its CUDA
kernel for CUDA tensors and runs its plain version (the fp32 ``F.conv2d``
path of :mod:`.srcnn`) for CPU tensors.  The kernel runs all three convs
on Hopper's warpgroup MMA (``wgmma``) in 3xTF32 (hi/lo split, fp32
accumulation), whose sums differ from cuDNN's fp32 ones in order and in
the last bits, so the two agree to <=1 LSB (K1, K4) or, unquantized, to
within 1e-2 (K5).  The three
kernels share their body, so quantized K5 equals K1 and K4 equals K1
followed by K3, bit for bit.

This module also holds what the CPU tests check of the kernel: the packed
weight layout (:func:`pack_weights`, :func:`packed_layout`,
:func:`c_to_a_perm`), the matrix descriptors the kernel builds over it
(:func:`b_descriptor`) and the work plan (:func:`conv_tile_plan`) that the
wrappers hand to the launcher.
"""

from __future__ import annotations

import functools

import torch

from .. import runtime
from ..utils.profiling import span
from .color import ycrcb2bgr_u8_planar
from ..weights.loader import _KEYS, CANONICAL, derived, family_shapes, \
    srcnn_only
from .srcnn import srcnn_y, srcnn_y_f32

__all__ = ["srcnn_y_fused", "srcnn_y_plain", "srcnn_merge_fused",
           "srcnn_merge_plain", "srcnn_y_f32_fused", "srcnn_y_f32_plain",
           "pack_weights", "conv_tile_plan", "c_to_a_perm", "tf32_split",
           "smem_descriptor", "y_planes"]

#: the kernel's geometry, mirrored by the constants in srcnn_conv.cu
STRIP = 60                 # output columns of a work unit
POSITIONS = STRIP + 4      # f2 positions of a strip row: one m64 wgmma tile
WINDOW_COLS = STRIP + 12   # input window columns
_IWS = 88                  # float window row stride
RING_IN = 16               # input ring rows (the kernel keeps 8 copies more)
RING_PART = 8              # conv3 partial ring rows
_PSTR = POSITIONS + 4      # partial plane stride
CONSUMERS = 2              # consumer warpgroups per block
THREADS = 128 * (CONSUMERS + 1)   # + the helper (loader, stencil) warpgroup
REGS = (224, 56)           # setmaxnreg: a consumer's, the helper's
SMEM_LIMIT = 232_448       # one block's shared memory on sm_90
K1P = 88                   # conv1's 81 taps padded to whole k8 steps
#: tensor-core MACs per f2 position in 3xTF32: conv1 2 x 88 x 64, conv2
#: 3 x 64 x 32, conv3 3 x 32 x 32 (25 taps padded to 32)
POSITION_MACS = 2 * K1P * 64 + 3 * 64 * 32 + 3 * 32 * 32
#: wgmma's B operand: K-major, no swizzle; byte offsets between core
#: matrices along K (leading) and along N (stride)
LBO, SBO = 128, 256
_CORE = 32                 # floats of one core matrix (8 rows x 16 bytes)
_TF32_MASK = -8192         # 0xFFFFE000 as int32: the tf32 bits of an fp32


def packed_layout() -> dict:
    """The packed weight buffer: name -> ``(float offset, K, N)`` of each
    tf32 plane (``w1_hi``, ``w1_lo``, ...) and ``(float offset, size)`` of
    each bias.  ``srcnn_conv.cu`` static_asserts the same offsets."""
    out, off = {}, 0
    for i, (k, n, nb) in enumerate(((K1P, 64, 64), (64, 32, 32),
                                    (32, 32, 4)), start=1):
        for half in ("hi", "lo"):
            out[f"w{i}_{half}"] = (off, k, n)
            off += k * n
        out[f"b{i}"] = (off, nb)
        off += nb
    return out


#: packed weight size in floats (srcnn_conv.cu static_asserts WTOTAL)
PACKED_SIZE = sum(v[1] * v[2] if len(v) == 3 else v[1]
                  for v in packed_layout().values())


def c_to_a_perm() -> list[int]:
    """Channel read by each K position of a stage whose A fragments are the
    previous stage's accumulators, for 64 channels in k8 groups.

    In wgmma's register fragments (as in mma.sync's), thread ``(g, t)``
    holds accumulator columns ``2t`` and ``2t+1`` of each n8 block and the
    A operand wants K positions ``t`` and ``t+4``.  With ``a = (c0, c2, c1,
    c3)`` K position ``q`` of group ``j`` is channel ``8j + 2q`` for
    ``q < 4`` and ``8j + 2(q-4) + 1`` otherwise, and the packed w2 and w3
    carry that permutation of their K index.
    """
    return [8 * j + (2 * q if q < 4 else 2 * (q - 4) + 1)
            for j in range(8) for q in range(8)]


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` of float32 ``x``: hi keeps the tf32 bits (low 13 bits
    cleared), ``lo = x - hi`` exactly."""
    x = x.to(torch.float32).contiguous()
    hi = (x.view(torch.int32) & _TF32_MASK).view(torch.float32)
    return hi, x - hi


def _k_major(m: torch.Tensor) -> torch.Tensor:
    """Weight matrix ``[K][N]`` (K, N multiples of 8) -> wgmma's K-major
    core matrices, unswizzled: for each k8 step ``s``, n-block ``nb`` and
    K half ``kc``, one 8 x 4 core matrix (rows n, 16 bytes of K each), so
    element ``(k, n)`` lands at ``((s * N/8 + nb) * 2 + kc) * 32 + (n % 8)
    * 4 + k % 4``."""
    k, n = m.shape
    return m.reshape(k // 8, 2, 4, n // 8, 8).permute(0, 3, 1, 4, 2) \
        .reshape(-1)


def _pack(weights) -> torch.Tensor:
    _pack.calls += 1
    with span("srcnn.build.weights"):
        w1, b1, w2, b2, w3, b3 = (getattr(weights, k).detach().to(
            "cpu", torch.float32) for k in _KEYS)
        perm = c_to_a_perm()
        m1 = torch.zeros((K1P, 64))
        m1[:81] = w1.reshape(64, 81).t()
        m2 = w2.reshape(32, 64)[:, perm].t()
        m3 = torch.zeros((32, 32))
        m3[:, :25] = w3.reshape(32, 25)[perm[:32]]
        parts = []
        for m, b in ((m1, b1.reshape(64)), (m2, b2.reshape(32)),
                     (m3, torch.cat([b3.reshape(1), torch.zeros(3)]))):
            parts += [_k_major(h) for h in tf32_split(m)] + [b]
        packed = torch.cat(parts)
        assert packed.numel() == PACKED_SIZE
        return packed.to(weights.conv1_w.device)


_pack.calls = 0   # how often pack_weights really packed (not cached)


def pack_weights(weights) -> torch.Tensor:
    """SRCNNWeights -> the kernel's flat float32 weight buffer (same device),
    built once per weights object and cached while its tensors are
    unchanged (same storage, same version counter).

    Layout (:func:`packed_layout`): w1 as a ``[88 taps][64]`` matrix (taps
    ky*9+kx, zero rows past 81), b1 ``[64]``, w2 as ``[64][32]`` with its K
    index in :func:`c_to_a_perm` order, b2 ``[32]``, w3 as ``[32][32
    taps]`` (K permuted, taps dy*5+dx, zero columns past 25), b3 and 3 zeros.
    Each matrix is stored as its 3xTF32 hi and lo planes, each in wgmma's
    K-major core-matrix order (:func:`_k_major`), so that the kernel copies
    the buffer into shared memory as it is and points its matrix
    descriptors (:func:`b_descriptor`) at the planes.
    """
    return derived(weights, "srcnn", [getattr(weights, k) for k in _KEYS],
                   _pack, weights)


def b_descriptor(plane: str, step: int, base: int = 0) -> int:
    """The 64-bit wgmma matrix descriptor the kernel gives k8 step ``step``
    of weight plane ``plane`` (``"w2_lo"``, ...) when the packed buffer
    starts at shared byte address ``base`` (a step of an N-column plane is
    N x 8 floats): start ``>> 4`` in bits 0-13, ``LBO >> 4`` in 16-29,
    ``SBO >> 4`` in 32-45, base offset 0, layout type 0 (no swizzle) in
    bits 62-63."""
    off, k, n = packed_layout()[plane]
    if not 0 <= step < k // 8:
        raise ValueError(f"{plane} has {k // 8} k8 steps")
    return smem_descriptor(base + 4 * off + step * n * 32, LBO, SBO)


def smem_descriptor(addr: int, lbo: int, sbo: int) -> int:
    """The 64-bit wgmma matrix descriptor of a K-major, unswizzled operand
    at shared byte address ``addr`` (``csrc/wgmma.cuh::smem_desc``):
    ``addr >> 4`` in bits 0-13, ``lbo >> 4`` (between core matrices along
    K) in 16-29, ``sbo >> 4`` (along M or N) in 32-45, base offset 0,
    layout type 0 (no swizzle) in bits 62-63."""
    return ((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16) | ((sbo >> 4) << 32)


def conv_smem_bytes() -> int:
    """Shared memory of one block: packed weights (to a 128-byte boundary),
    each consumer's input ring (16 rows + 8 copies) and conv3 partial ring,
    and their mbarriers (full and free per slot)."""
    floats = (-(-PACKED_SIZE // 32) * 32
              + CONSUMERS * (RING_IN + 8) * _IWS
              + CONSUMERS * RING_PART * 25 * _PSTR)
    return 4 * floats + 8 * CONSUMERS * 2 * (RING_IN + RING_PART)


@functools.lru_cache(maxsize=256)
def _plan(batch: int, h: int, w: int, num_sms: int) -> tuple[int, int, int]:
    """``(segment rows, units, grid)``: segments as tall as the card's
    consumers allow, their count chosen for the fewest rows per consumer
    (waves of units x rows of a unit, with 4 halo rows)."""
    with span("srcnn.build.k1_plan"):
        sx = -(-w // STRIP)
        best = None
        most = min(h, -(-8 * CONSUMERS * num_sms // (batch * sx)))
        for nseg in range(1, max(1, most) + 1):
            seg_h = -(-h // nseg)
            units = batch * sx * -(-h // seg_h)
            grid = min(num_sms, units)
            cost = -(-units // (CONSUMERS * grid)) * (seg_h + 4)
            if best is None or cost < best[0]:
                best = (cost, seg_h, units, grid)
        return best[1:]


def conv_tile_plan(batch: int, h: int, w: int, num_sms: int) -> dict:
    """The conv launch: ``tile`` (segment rows, strip columns), the number
    of work units ``tiles``, the persistent ``grid`` (one block per SM,
    never more blocks than units), ``threads`` and ``smem_bytes``.

    Unit ``i`` covers output rows ``oy0 .. oy0 + tile[0] - 1`` and columns
    ``ox0 .. ox0 + tile[1] - 1`` of frame ``b`` (:func:`conv_tile_origin`),
    clipped to the image; consumer ``c`` of block ``k`` takes units ``k +
    (c + CONSUMERS i) grid`` (:func:`conv_consumer_units`).  Each unit's f2
    rows are m64 tiles of ``POSITIONS`` positions.
    """
    seg_h, units, grid = _plan(batch, h, w, num_sms)
    return {"tile": (seg_h, STRIP), "tiles": units, "grid": grid,
            "threads": THREADS, "smem_bytes": conv_smem_bytes()}


def conv_tile_origin(tile: int, h: int, w: int,
                     seg_h: int) -> tuple[int, int, int]:
    """``(b, oy0, ox0)`` of unit ``tile``, as the kernel decodes it."""
    sx_n, seg_n = -(-w // STRIP), -(-h // seg_h)
    rest = tile // sx_n
    return rest // seg_n, (rest % seg_n) * seg_h, (tile % sx_n) * STRIP


def conv_consumer_units(plan: dict, block: int, consumer: int) -> range:
    """The units that consumer ``consumer`` of block ``block`` walks."""
    return range(block + consumer * plan["grid"], plan["tiles"],
                 CONSUMERS * plan["grid"])


def conv_f2_rows(oy0: int, seg_h: int, h: int) -> tuple[int, int]:
    """``(first, last)`` f2 row a unit computes: its output rows' conv3
    reach, clipped to the image (rows past an edge are the edge row's)."""
    return max(oy0 - 2, 0), min(oy0 + seg_h + 1, h - 1)


def conv_macs(batch: int, h: int, w: int, num_sms: int) -> int:
    """Tensor-core MACs of one launch under its plan: every unit computes
    ``POSITIONS`` f2 positions on each of its f2 rows."""
    plan = conv_tile_plan(batch, h, w, num_sms)
    seg_h = plan["tile"][0]
    rows = sum(b - a + 1 for a, b in (conv_f2_rows(r0, seg_h, h)
                                      for r0 in range(0, h, seg_h)))
    return batch * -(-w // STRIP) * rows * POSITIONS * POSITION_MACS


def _plan_args(b: int, h: int, w: int) -> tuple:
    """The plan's launcher arguments on the current CUDA device."""
    plan = conv_tile_plan(b, h, w, runtime.num_sms())
    return (*plan["tile"], plan["grid"], plan["smem_bytes"])


def srcnn_y_plain(y_u8: torch.Tensor, weights) -> torch.Tensor:
    """The fp32 ``F.conv2d`` path (TF32 off): :func:`.srcnn.srcnn_y`."""
    srcnn_y_plain.calls += 1
    return srcnn_y(y_u8, weights)


srcnn_y_plain.calls = 0


def srcnn_merge_plain(up: torch.Tensor, weights) -> torch.Tensor:
    """``merge_plain(srcnn_y_plain(up[:, 0]), up)``: the plain conv stack on
    Y, then the inverse color transform of ``(Y', Cr, Cb)``."""
    srcnn_merge_plain.calls += 1
    y_sr = srcnn_y(up[:, 0], weights)
    return ycrcb2bgr_u8_planar(torch.stack([y_sr, up[:, 1], up[:, 2]], dim=1))


srcnn_merge_plain.calls = 0


def srcnn_y_f32_plain(y_u8: torch.Tensor, weights) -> torch.Tensor:
    """The fp32 ``F.conv2d`` path (TF32 off) before quantization:
    :func:`.srcnn.srcnn_y_f32`."""
    srcnn_y_f32_plain.calls += 1
    return srcnn_y_f32(y_u8, weights)


srcnn_y_f32_plain.calls = 0


_SHAPES = family_shapes(*CANONICAL)


def _check_weights(weights) -> None:
    srcnn_only(weights, "the SRCNN conv kernels (K1, K4, K5)")
    if any(tuple(getattr(weights, k).shape) != v for k, v in _SHAPES.items()):
        raise ValueError("the fused kernels take SRCNN 9-5-5 64/32 weights")


def _on_device(x: torch.Tensor, device: torch.device) -> None:
    """ValueError unless ``x`` is on ``device`` (the weights'), a CPU or
    CUDA device."""
    if device != x.device:
        raise ValueError(f"weights on {device}, input on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def y_planes(y_u8: torch.Tensor, device: torch.device) -> torch.Tensor:
    """The input every network on Y takes: uint8 plane(s) ``[H, W]`` /
    ``[B, H, W]``, each plane row-contiguous (frames of a batch at any
    stride, e.g. ``up[:, 0]`` of a planar YCrCb batch), on ``device`` (the
    weights').  Returns them as ``[B, H, W]``; raises TypeError or
    ValueError otherwise."""
    if y_u8.dtype != torch.uint8:
        raise TypeError(f"expected uint8, got {y_u8.dtype}")
    if y_u8.dim() not in (2, 3) or min(y_u8.shape[-2:]) <= 0:
        raise ValueError(f"expected Y [H,W] or [B,H,W], got "
                         f"{tuple(y_u8.shape)}")
    if y_u8.stride(-1) != 1 or y_u8.stride(-2) != y_u8.shape[-1]:
        raise ValueError("each Y plane must be contiguous")
    _on_device(y_u8, device)
    return y_u8[None] if y_u8.dim() == 2 else y_u8


def _planes(wrapper, plain, name: str, y_u8: torch.Tensor, weights,
            dtype: torch.dtype) -> torch.Tensor:
    """``plain`` on the CPU, else C entry ``name`` (K1 or K5) launched on
    Y plane(s) ``[H, W]`` / ``[B, H, W]`` and counted on ``wrapper``."""
    _check_weights(weights)
    y3 = y_planes(y_u8, weights.conv1_w.device)
    if y3.device.type == "cpu":
        return plain(y_u8, weights)
    b, h, w = y3.shape
    out = torch.empty((b, h, w), dtype=dtype, device=y3.device)
    if b > 0:
        packed = pack_weights(weights)
        with torch.cuda.device(y3.device):
            runtime.check(getattr(runtime.library(), name)(
                y3.data_ptr(), y3.stride(0), packed.data_ptr(),
                out.data_ptr(), b, h, w, *_plan_args(b, h, w),
                runtime.current_stream()), name)
        wrapper.launches += 1
    return out.reshape(y_u8.shape)


def srcnn_y_fused(y_u8: torch.Tensor, weights) -> torch.Tensor:
    """uint8 Y plane(s) ``[H, W]`` / ``[B, H, W]`` (:func:`y_planes`) ->
    uint8, same shape."""
    return _planes(srcnn_y_fused, srcnn_y_plain, "srcnn_conv_u8", y_u8,
                   weights, torch.uint8)


srcnn_y_fused.launches = 0


def srcnn_y_f32_fused(y_u8: torch.Tensor, weights) -> torch.Tensor:
    """uint8 Y plane(s) ``[H, W]`` / ``[B, H, W]`` (:func:`y_planes`) ->
    float32 conv3 + b3, same shape, with the reference's border clamps and
    no quantization (``quantize_trunc_u8`` of it is :func:`srcnn_y_fused`)."""
    return _planes(srcnn_y_f32_fused, srcnn_y_f32_plain, "srcnn_conv_f32",
                   y_u8, weights, torch.float32)


srcnn_y_f32_fused.launches = 0


def srcnn_merge_fused(up: torch.Tensor, weights) -> torch.Tensor:
    """Upscaled YCrCb u8 ``[B, 3, H, W]`` -> planar BGR u8 ``[B, 3, H, W]``:
    the conv stack on Y, IntTrim, merge and inverse color in one kernel."""
    if up.dtype != torch.uint8:
        raise TypeError(f"expected uint8, got {up.dtype}")
    if up.dim() != 4 or up.shape[1] != 3 or min(up.shape[2:]) <= 0:
        raise ValueError(f"expected upscaled YCrCb [B,3,H,W], got "
                         f"{tuple(up.shape)}")
    if not up.is_contiguous():
        raise ValueError("input must be contiguous")
    _check_weights(weights)
    _on_device(up, weights.conv1_w.device)
    if up.device.type == "cpu":
        return srcnn_merge_plain(up, weights)
    b, _, h, w = up.shape
    out = torch.empty_like(up)
    if b > 0:
        packed = pack_weights(weights)
        with torch.cuda.device(up.device):
            runtime.check(runtime.library().srcnn_conv_merge_u8(
                up.data_ptr(), packed.data_ptr(), out.data_ptr(), b, h, w,
                *_plan_args(b, h, w), runtime.current_stream()),
                "srcnn_conv_merge_u8")
        srcnn_merge_fused.launches += 1
    return out


srcnn_merge_fused.launches = 0
