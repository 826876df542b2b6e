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
path of :mod:`.srcnn`) for CPU tensors; the kernel's fp32 FMA order differs
from cuDNN's, so the two agree to <=1 LSB (K1, K4) or, unquantized, to
within 1e-2 (K5).  The three kernels share their sum order, so quantized
K5 equals K1 and K4 equals K1 followed by K3, bit for bit.
"""

from __future__ import annotations

import torch

from .. import runtime
from .color import ycrcb2bgr_u8_planar
from .srcnn import srcnn_y, srcnn_y_f32

__all__ = ["srcnn_y_fused", "srcnn_y_plain", "srcnn_merge_fused",
           "srcnn_merge_plain", "srcnn_y_f32_fused", "srcnn_y_f32_plain",
           "pack_weights"]

#: packed weight layout (floats), mirrored by the constants in srcnn_conv.cu
_K1P = 84            # conv1's 81 taps padded for 16-byte weight reads
PACKED_SIZE = 8324


def pack_weights(weights) -> torch.Tensor:
    """SRCNNWeights -> the kernel's flat float32 weight buffer (same device).

    Layout: w1 ``[64][84]`` (taps ky*9+kx, zero pad), b1 ``[64]``, w2
    transposed ``[64 in][32 out]``, b2 ``[32]``, w3 ``[32][25]`` (taps
    dy*5+dx), b3, zero pad to a multiple of 4.
    """
    f32 = dict(dtype=torch.float32, device=weights.conv1_w.device)
    w1 = torch.zeros((64, _K1P), **f32)
    w1[:, :81] = weights.conv1_w.reshape(64, 81)
    parts = [w1.reshape(-1), weights.conv1_b.reshape(64),
             weights.conv2_w.reshape(32, 64).t().reshape(-1),
             weights.conv2_b.reshape(32), weights.conv3_w.reshape(-1),
             weights.conv3_b.reshape(1), torch.zeros(3, **f32)]
    packed = torch.cat([p.to(torch.float32) for p in parts])
    assert packed.numel() == PACKED_SIZE
    return packed


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


def _check_device(x: torch.Tensor, weights) -> None:
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
                out.data_ptr(), b, h, w, runtime.current_stream()), name)
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
                runtime.current_stream()), "srcnn_conv_merge_u8")
        srcnn_merge_fused.launches += 1
    return out


srcnn_merge_fused.launches = 0
