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
on tensor cores in 3xTF32 (hi/lo split, fp32 accumulation), whose sums
differ from cuDNN's fp32 ones in order and in the last bits, so the two
agree to <=1 LSB (K1, K4) or, unquantized, to within 1e-2 (K5).  The three
kernels share their body, so quantized K5 equals K1 and K4 equals K1
followed by K3, bit for bit.

This module also holds what the CPU tests check of the kernel: the packed
weight layout (:func:`pack_weights`, :func:`c_to_a_perm`) and the tile
plan (:func:`conv_tile_plan`) that the wrappers hand to the launcher.
"""

from __future__ import annotations

import weakref

import torch

from .. import runtime
from .color import ycrcb2bgr_u8_planar
from ..weights.loader import CANONICAL, family_shapes
from .srcnn import srcnn_y, srcnn_y_f32

__all__ = ["srcnn_y_fused", "srcnn_y_plain", "srcnn_merge_fused",
           "srcnn_merge_plain", "srcnn_y_f32_fused", "srcnn_y_f32_plain",
           "pack_weights", "conv_tile_plan", "c_to_a_perm"]

#: the kernel's geometry, mirrored by the constants in srcnn_conv.cu
TILE = (36, 28)            # output tile (rows, cols) of one block step
_HALO = (TILE[0] + 4, TILE[1] + 4)      # f2 positions: 40 x 32
_WINDOW = (TILE[0] + 12, TILE[1] + 12)  # input window: 48 x 40
_IWS = 52                  # float window row stride
_PSTR = _HALO[0] * _HALO[1] + 4         # conv3 partial plane stride
_BROW = 48                 # cp.async byte window row stride
THREADS = 256
SMEM_LIMIT = 232_448       # one block's shared memory on sm_90
K1P = 88                   # conv1's 81 taps padded to whole k8 steps
#: packed weight size in floats (srcnn_conv.cu static_asserts WTOTAL)
PACKED_SIZE = 11 * 8 * 128 + 64 + 8 * 4 * 128 + 32 + 4 * 4 * 128 + 4
_TF32_MASK = -8192         # 0xFFFFE000 as int32: the tf32 bits of an fp32


def c_to_a_perm() -> list[int]:
    """Channel read by each K position of a stage whose A fragments are the
    previous stage's m16n8 accumulators, for 64 channels in k8 groups.

    Thread ``(g, t)`` of an accumulator tile holds columns ``2t`` and
    ``2t+1``; the m16n8k8 A operand wants columns ``t`` and ``t+4``.  With
    ``a = (c0, c2, c1, c3)`` K position ``q`` of group ``j`` is channel
    ``8j + 2q`` for ``q < 4`` and ``8j + 2(q-4) + 1`` otherwise, and the
    packed w2 and w3 carry that permutation of their K index.
    """
    return [8 * j + (2 * q if q < 4 else 2 * (q - 4) + 1)
            for j in range(8) for q in range(8)]


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` of float32 ``x``: hi keeps the tf32 bits (low 13 bits
    cleared), ``lo = x - hi`` exactly."""
    x = x.to(torch.float32).contiguous()
    hi = (x.view(torch.int32) & _TF32_MASK).view(torch.float32)
    return hi, x - hi


def _fragments(b: torch.Tensor) -> torch.Tensor:
    """Weight matrix ``[K][N]`` (K, N multiples of 8) -> its mma.sync B
    fragments: for each k8 x n8 tile and lane ``(g, t) = (lane // 4,
    lane % 4)``, ``(hi[t, g], hi[t+4, g], lo[t, g], lo[t+4, g])``."""
    hi, lo = tf32_split(b)
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    k = 8 * torch.arange(b.shape[0] // 8)[:, None, None] + t
    n = 8 * torch.arange(b.shape[1] // 8)[None, :, None] + g
    return torch.stack([hi[k, n], hi[k + 4, n], lo[k, n], lo[k + 4, n]],
                       dim=-1).reshape(-1)


def _pack(weights) -> torch.Tensor:
    f32 = [getattr(weights, k).detach().to("cpu", torch.float32)
           for k in ("conv1_w", "conv1_b", "conv2_w", "conv2_b", "conv3_w",
                     "conv3_b")]
    w1, b1, w2, b2, w3, b3 = f32
    perm = c_to_a_perm()
    m1 = torch.zeros((K1P, 64))
    m1[:81] = w1.reshape(64, 81).t()
    m2 = w2.reshape(32, 64)[:, perm].t()
    m3 = torch.zeros((32, 32))
    m3[:, :25] = w3.reshape(32, 25)[perm[:32]]
    packed = torch.cat([_fragments(m1), b1.reshape(64), _fragments(m2),
                        b2.reshape(32), _fragments(m3), b3.reshape(1),
                        torch.zeros(3)])
    assert packed.numel() == PACKED_SIZE
    return packed


_PACKED: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def pack_weights(weights) -> torch.Tensor:
    """SRCNNWeights -> the kernel's flat float32 weight buffer (same device),
    built once per weights object and cached while its tensors are
    unchanged (same storage, same version counter).

    Layout: w1 as a ``[88 taps][64]`` matrix (taps ky*9+kx, zero rows past
    81), b1 ``[64]``, w2 as ``[64][32]`` with its K index in
    :func:`c_to_a_perm` order, b2 ``[32]``, w3 as ``[32][32 taps]`` (K
    permuted, taps dy*5+dx, zero columns past 25), b3, zero pad to a
    multiple of 4.  Each matrix is stored as its 3xTF32 hi/lo planes in
    mma.sync B-fragment order (:func:`_fragments`).
    """
    tensors = [getattr(weights, k) for k in ("conv1_w", "conv1_b", "conv2_w",
                                              "conv2_b", "conv3_w", "conv3_b")]
    key = tuple((t.data_ptr(), t._version) for t in tensors)
    hit = _PACKED.get(weights)
    if hit is None or hit[0] != key:
        hit = (key, _pack(weights).to(weights.conv1_w.device))
        _PACKED[weights] = hit
    return hit[1]


def conv_smem_bytes() -> int:
    """Shared memory of one block: packed weights, the float input window,
    the conv3 partials of every halo position and two cp.async byte
    windows."""
    floats = PACKED_SIZE + _WINDOW[0] * _IWS + 25 * _PSTR
    return 4 * floats + 2 * _WINDOW[0] * _BROW


def conv_tile_plan(batch: int, h: int, w: int, num_sms: int) -> dict:
    """The conv launch: ``tile`` (rows, cols), the number of ``tiles``, the
    persistent ``grid`` (one block per SM, never more blocks than tiles),
    ``threads`` and ``smem_bytes``.  Tile ``i`` covers output rows
    ``oy0 .. oy0 + tile[0] - 1`` and columns ``ox0 .. ox0 + tile[1] - 1``
    of frame ``b`` (:func:`conv_tile_origin`), clipped to the image; block
    ``k`` takes tiles ``k, k + grid, k + 2 grid, ...``."""
    th, tw = TILE
    tiles = batch * -(-h // th) * -(-w // tw)
    return {"tile": TILE, "tiles": tiles, "grid": max(1, min(tiles, num_sms)),
            "threads": THREADS, "smem_bytes": conv_smem_bytes()}


def conv_tile_origin(tile: int, h: int, w: int) -> tuple[int, int, int]:
    """``(b, oy0, ox0)`` of tile ``tile``, as the kernel decodes it."""
    th, tw = TILE
    tx_n, ty_n = -(-w // tw), -(-h // th)
    rest = tile // tx_n
    return rest // ty_n, (rest % ty_n) * th, (tile % tx_n) * tw


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


def _check_device(x: torch.Tensor, weights) -> None:
    if any(tuple(getattr(weights, k).shape) != v for k, v in _SHAPES.items()):
        raise ValueError("the fused kernels take SRCNN 9-5-5 64/32 weights")
    if weights.conv1_w.device != x.device:
        raise ValueError(f"weights on {weights.conv1_w.device}, "
                         f"input on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _validate(y_u8: torch.Tensor, weights) -> None:
    if y_u8.dtype != torch.uint8:
        raise TypeError(f"expected uint8, got {y_u8.dtype}")
    if y_u8.dim() not in (2, 3) or min(y_u8.shape[-2:]) <= 0:
        raise ValueError(f"expected Y [H,W] or [B,H,W], got "
                         f"{tuple(y_u8.shape)}")
    if y_u8.stride(-1) != 1 or y_u8.stride(-2) != y_u8.shape[-1]:
        raise ValueError("each Y plane must be contiguous")
    _check_device(y_u8, weights)


def _launch_planes(wrapper, name: str, y_u8: torch.Tensor, weights,
                   dtype: torch.dtype) -> torch.Tensor:
    """Launch C entry ``name`` (K1 or K5) on Y plane(s) ``[H, W]`` /
    ``[B, H, W]`` and count the launch on ``wrapper``."""
    y3 = y_u8[None] if y_u8.dim() == 2 else y_u8
    b, h, w = y3.shape
    out = torch.empty((b, h, w), dtype=dtype, device=y_u8.device)
    if b > 0:
        packed = pack_weights(weights)
        with torch.cuda.device(y_u8.device):
            runtime.check(getattr(runtime.library(), name)(
                y3.data_ptr(), y3.stride(0), packed.data_ptr(),
                out.data_ptr(), b, h, w, *_plan_args(b, h, w),
                runtime.current_stream()), name)
        wrapper.launches += 1
    return out.reshape(y_u8.shape)


def srcnn_y_fused(y_u8: torch.Tensor, weights) -> torch.Tensor:
    """uint8 Y plane(s) ``[H, W]`` / ``[B, H, W]`` -> uint8, same shape.

    Frames of a batch may sit at any stride (e.g. ``up[:, 0]`` of a planar
    YCrCb batch); each plane must be row-contiguous.
    """
    _validate(y_u8, weights)
    if y_u8.device.type == "cpu":
        return srcnn_y_plain(y_u8, weights)
    return _launch_planes(srcnn_y_fused, "srcnn_conv_u8", y_u8, weights,
                          torch.uint8)


srcnn_y_fused.launches = 0


def srcnn_y_f32_fused(y_u8: torch.Tensor, weights) -> torch.Tensor:
    """uint8 Y plane(s) ``[H, W]`` / ``[B, H, W]`` -> float32 conv3 + b3,
    same shape, with the reference's border clamps and no quantization
    (``quantize_trunc_u8`` of it is :func:`srcnn_y_fused`)."""
    _validate(y_u8, weights)
    if y_u8.device.type == "cpu":
        return srcnn_y_f32_plain(y_u8, weights)
    return _launch_planes(srcnn_y_f32_fused, "srcnn_conv_f32", y_u8, weights,
                          torch.float32)


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
    _check_device(up, weights)
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
