"""The VDSR chain on Y planes (``csrc/vdsr_conv.cu``).

:func:`vdsr_y_fused` takes uint8 Y planes and ``VDSRWeights`` and returns
``clamp(round(255 (x + f(x))), 0, 255)`` as uint8, ``x = Y / 255`` (Kim,
Lee, Lee, arXiv:1511.04587).  On a CUDA tensor it enqueues, frame by frame,
conv1 (1->64, SIMT), the 64->64 layers on Hopper's warpgroup MMA in 3xTF32
(hi/lo split, fp32 accumulation) and conv20 (64->1, SIMT) with the
residual and the store fused in; the activations pass through device
memory as NHWC float32, two buffers of ``H x W x 64`` that the layers and
frames use in turn (2 x 2.12 GB at 4K).  On a CPU tensor it runs the plain
fp32 ``F.conv2d`` path of :mod:`.vdsr`.  The two sum in other orders, so
they agree to within 1 LSB on a small share of pixels.

This module also holds what the CPU tests check of the kernel: the packed
weight layout (:func:`pack_vdsr`, :func:`pack_layer`), the layout of a
stage in shared memory (:func:`stage_layout`), the descriptors the kernel
gives its operands there (:func:`weight_descriptor`,
:func:`act_descriptor`) and the plan (:func:`vdsr_plan`).  It shares K1's
3xTF32 split, K-major packing and descriptor arithmetic
(:mod:`.cuda_srcnn`).
"""

from __future__ import annotations

import functools

import torch

from .. import runtime
from ..utils.profiling import counter_records, span
from ..weights.loader import derived
from ..weights.vdsr import CHANNELS, VDSRWeights
from .cuda_srcnn import _k_major, smem_descriptor, tf32_split, y_planes
from .vdsr import vdsr_y

__all__ = ["vdsr_y_fused", "vdsr_y_plain", "pack_vdsr", "pack_layer",
           "vdsr_plan", "stage_layout", "weight_descriptor",
           "act_descriptor"]

#: the kernel's geometry, mirrored by the constants in vdsr_conv.cu
STRIP = 128                # output columns of a unit: one wgmma N
UNIT_ROWS = 2              # output rows of a unit, one a consumer
CONSUMERS = UNIT_ROWS      # consumer warpgroups per block
IN_ROWS = UNIT_ROWS + 2    # input rows a unit reaches
COLS = STRIP + 2           # input columns a unit reaches
PLANE_COLS = STRIP + 4     # column stride of a staged 4-channel plane
STAGE_CHANNELS = 8         # input channels of a stage: one k8 step
CHUNKS = CHANNELS // STAGE_CHANNELS
TAPS = 9
STAGES = 3                 # the ring of stages
SMEM_LIMIT = 232_448       # one block's shared memory on sm_90
W_LBO, W_SBO = 128, 256    # weight descriptors: along K, along co
X_SBO = 128                # activation descriptors along pixels
#: floats of a 64->64 layer's packed weights and biases
LAYER_FLOATS = CHUNKS * TAPS * 2 * CHANNELS * STAGE_CHANNELS + CHANNELS


def stage_layout() -> dict:
    """Float offsets inside one stage of shared memory: ``w`` (tap, plane)
    -> the ``[64 co][8 ci]`` core matrices, and the activation planes:
    ``x_hi``/``x_lo`` start, ``row`` (8 channels of one input row), ``half``
    (4 channels); ``stage`` is its size.  ``vdsr_conv.cu`` static_asserts
    the same sizes."""
    w_mat = CHANNELS * STAGE_CHANNELS
    w_stage = TAPS * 2 * w_mat
    half = PLANE_COLS * 4
    row = 2 * half
    plane = IN_ROWS * row
    return {"w_mat": w_mat, "w_stage": w_stage, "half": half, "row": row,
            "plane": plane, "x_hi": w_stage, "x_lo": w_stage + plane,
            "stage": w_stage + 2 * plane}


def vdsr_smem_bytes() -> int:
    """Shared memory of one block: the ring of stages and its full and
    empty mbarriers."""
    return 4 * STAGES * stage_layout()["stage"] + 8 * 2 * STAGES


def weight_descriptor(tap: int, plane: int, base: int = 0) -> int:
    """The A descriptor of tap ``tap`` (``3 ky + kx``), plane 0 (hi) or 1
    (lo), of a stage at shared byte address ``base``."""
    off = (2 * tap + plane) * stage_layout()["w_mat"]
    return smem_descriptor(base + 4 * off, W_LBO, W_SBO)


def act_descriptor(consumer: int, ky: int, kx: int, plane: int,
                   base: int = 0) -> int:
    """The B descriptor of consumer ``consumer``'s output row at tap
    ``(ky, kx)``, plane 0 (hi) or 1 (lo): input row ``consumer + ky`` of
    the stage, from column ``kx``."""
    lay = stage_layout()
    off = (lay["x_lo"] if plane else lay["x_hi"]) \
        + (consumer + ky) * lay["row"] + 4 * kx
    return smem_descriptor(base + 4 * off, 4 * lay["half"], X_SBO)


def pack_layer(w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A 64->64 layer ``w [64 co][64 ci][3][3]``, ``b [64]`` -> its packed
    floats: for each stage ``q`` (channels ``8q .. 8q+7``), tap ``3 ky +
    kx`` and plane (tf32 hi, lo) the ``[8 ci][64 co]`` matrix in wgmma's
    K-major core-matrix order (:func:`.cuda_srcnn._k_major`), so that a
    stage's weights are one contiguous block; then the biases."""
    w = w.detach().to("cpu", torch.float32)
    parts = []
    for q in range(CHUNKS):
        rows = w[:, STAGE_CHANNELS * q:STAGE_CHANNELS * (q + 1)]
        for tap in range(TAPS):
            m = rows[:, :, tap // 3, tap % 3].t()         # [8 ci][64 co]
            parts += [_k_major(h) for h in tf32_split(m)]
    parts.append(b.detach().to("cpu", torch.float32).reshape(CHANNELS))
    packed = torch.cat(parts)
    assert packed.numel() == LAYER_FLOATS
    return packed


def _pack(weights: VDSRWeights) -> tuple:
    _pack.calls += 1
    with span("srcnn.build.vdsr_weights"):
        (w1, b1), *mid, (wn, bn) = weights.layers
        f32 = dict(device="cpu", dtype=torch.float32)
        first = torch.cat([w1.detach().to(**f32).reshape(CHANNELS, TAPS).t()
                           .reshape(-1), b1.detach().to(**f32).reshape(-1)])
        last = torch.cat([wn.detach().to(**f32).reshape(CHANNELS, TAPS).t()
                          .reshape(-1), bn.detach().to(**f32).reshape(1),
                          torch.zeros(3)])
        middle = torch.cat([pack_layer(w, b) for w, b in mid]) if mid \
            else torch.zeros(4)
        return tuple(t.to(weights.device) for t in (first, middle, last))


_pack.calls = 0   # how often pack_vdsr really packed (not cached)


def pack_vdsr(weights: VDSRWeights) -> tuple:
    """``(first, middle, last)``, the kernel's float32 weight buffers on
    the weights' device, built once per weights object and kept while its
    tensors are unchanged (:func:`..weights.loader.derived`): conv1 as
    ``[9][64]`` and its 64 biases; the 64->64 layers one after the other
    (:func:`pack_layer`); conv20 as ``[9][64]``, its bias and 3 zeros."""
    return derived(weights, "vdsr", weights.as_dict().values(), _pack,
                   weights)


def conv_grid(h: int, w: int, num_sms: int) -> tuple[int, int]:
    """``(units, grid)`` of the 64->64 kernel on an ``h x w`` frame, as
    :func:`vdsr_plan` describes them; RCAN's plan takes the same."""
    units = -(-h // UNIT_ROWS) * -(-w // STRIP)
    return units, min(num_sms, units)


@functools.lru_cache(maxsize=256)
def _plan(h: int, w: int, num_sms: int) -> tuple[int, int]:
    """``(units, grid)`` of one frame."""
    with span("srcnn.build.vdsr_plan"):
        return conv_grid(h, w, num_sms)


def vdsr_plan(h: int, w: int, num_sms: int) -> dict:
    """The 64->64 layer's launch on an ``h x w`` frame: ``units`` of
    ``UNIT_ROWS`` rows by ``STRIP`` columns (unit ``i`` at rows ``2 (i //
    sx)``, columns ``STRIP (i % sx)``, ``sx`` strips a row), the persistent
    ``grid`` (one block an SM, never more blocks than units) and
    ``smem_bytes``.  Memory: the frames of a call run one after another
    through two ``h x w x 64`` float32 activation buffers."""
    units, grid = _plan(h, w, num_sms)
    return {"units": units, "grid": grid, "smem_bytes": vdsr_smem_bytes()}


def vdsr_y_plain(y_u8: torch.Tensor, weights: VDSRWeights) -> torch.Tensor:
    """The fp32 ``F.conv2d`` path (TF32 off): :func:`.vdsr.vdsr_y`."""
    vdsr_y_plain.calls += 1
    return vdsr_y(y_u8, weights)


vdsr_y_plain.calls = 0


def vdsr_y_fused(y_u8: torch.Tensor, weights: VDSRWeights) -> torch.Tensor:
    """uint8 Y plane(s) ``[H, W]`` / ``[B, H, W]``
    (:func:`.cuda_srcnn.y_planes`) -> uint8, same shape."""
    if not isinstance(weights, VDSRWeights):
        raise TypeError(f"the VDSR chain takes VDSRWeights, got "
                        f"{type(weights).__name__}")
    y3 = y_planes(y_u8, weights.device)
    with span("srcnn.vdsr"):
        if y3.device.type == "cpu":
            return vdsr_y_plain(y_u8, weights)
        b, h, w = y3.shape
        out = torch.empty((b, h, w), dtype=torch.uint8, device=y3.device)
        if b > 0:
            first, middle, last = pack_vdsr(weights)
            plan = vdsr_plan(h, w, runtime.num_sms())
            act = torch.empty((2, h * w * CHANNELS), dtype=torch.float32,
                              device=y3.device)
            with torch.cuda.device(y3.device):
                runtime.check(runtime.library().vdsr_y_u8(
                    y3.data_ptr(), y3.stride(0), first.data_ptr(),
                    middle.data_ptr(), last.data_ptr(), act[0].data_ptr(),
                    act[1].data_ptr(), out.data_ptr(), b, h, w,
                    plan["grid"], plan["smem_bytes"],
                    runtime.current_stream(), counter_records(y3.device)),
                "vdsr_y_u8")
            vdsr_y_fused.launches += 1
        return out.reshape(y_u8.shape)


vdsr_y_fused.launches = 0
