"""K1: fused SRCNN 9-5-5 conv stack with IntTrim (``csrc/srcnn_conv.cu``).

The counterpart of ``srcnn_cpp_tpu/ops/pallas_srcnn.py::srcnn_y_fused``:
conv1 + conv2 + conv3 + quantization in one kernel that never writes a
feature map to device memory, with the reference's input-level clamp for
conv1 and feature-level clamp for conv3 (srcnn.cpp:200-210, 269-280)
computed inside the kernel.  The wrapper launches the CUDA kernel for CUDA
tensors and runs the plain version (:func:`srcnn_y_plain`, the fp32
``F.conv2d`` path of :mod:`.srcnn`) for CPU tensors; the kernel's fp32
FMA order differs from cuDNN's, so the two agree to <=1 LSB.
"""

from __future__ import annotations

import torch

from .. import runtime
from .srcnn import srcnn_y

__all__ = ["srcnn_y_fused", "srcnn_y_plain", "pack_weights"]

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


def _validate(y_u8: torch.Tensor, weights) -> None:
    if y_u8.dtype != torch.uint8:
        raise TypeError(f"expected uint8, got {y_u8.dtype}")
    if y_u8.dim() not in (2, 3) or min(y_u8.shape[-2:]) <= 0:
        raise ValueError(f"expected Y [H,W] or [B,H,W], got "
                         f"{tuple(y_u8.shape)}")
    if y_u8.stride(-1) != 1 or y_u8.stride(-2) != y_u8.shape[-1]:
        raise ValueError("each Y plane must be contiguous")
    if weights.conv1_w.device != y_u8.device:
        raise ValueError(f"weights on {weights.conv1_w.device}, "
                         f"input on {y_u8.device}")


def srcnn_y_fused(y_u8: torch.Tensor, weights) -> torch.Tensor:
    """uint8 Y plane(s) ``[H, W]`` / ``[B, H, W]`` -> uint8, same shape.

    Frames of a batch may sit at any stride (e.g. ``up[:, 0]`` of a planar
    YCrCb batch); each plane must be row-contiguous.
    """
    _validate(y_u8, weights)
    if y_u8.device.type == "cpu":
        return srcnn_y_plain(y_u8, weights)
    if y_u8.device.type != "cuda":
        raise ValueError(f"unsupported device {y_u8.device}")
    y3 = y_u8[None] if y_u8.dim() == 2 else y_u8
    b, h, w = y3.shape
    out = torch.empty((b, h, w), dtype=torch.uint8, device=y_u8.device)
    if b == 0:
        return out.reshape(y_u8.shape)
    packed = pack_weights(weights)
    with torch.cuda.device(y_u8.device):
        runtime.check(runtime.library().srcnn_conv_u8(
            y3.data_ptr(), y3.stride(0), packed.data_ptr(), out.data_ptr(),
            b, h, w, runtime.current_stream()), "srcnn_conv_u8")
    srcnn_y_fused.launches += 1
    return out.reshape(y_u8.shape)


srcnn_y_fused.launches = 0
