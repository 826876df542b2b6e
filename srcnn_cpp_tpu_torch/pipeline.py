"""End-to-end super-resolution pipeline (the reference's ``pthreadcall``).

Runs the reference's 9-step pipeline (src/srcnn.cpp:449-698) on one
device:

    BGR u8 -> YCrCb (fixed-point) -> per-channel bicubic x scale
    (OpenCV-4.6-bit-exact) -> SRCNN on Y -> merge(Y', Cr, Cb) -> BGR u8

as three kernels: K2 the pre-pass (:mod:`.ops.cuda_resize`), the network
on Y and K3 the post-pass (:mod:`.ops.cuda_merge`).  The network follows
from the weights' type (:func:`network_y`): SRCNN's K1 conv stack
(:mod:`.ops.cuda_srcnn`) for ``SRCNNWeights``, the VDSR chain
(:mod:`.ops.cuda_vdsr`) for ``VDSRWeights``.
On a CUDA device each wrapper launches its kernel; on the CPU each runs its
plain PyTorch version.  There is one path per device and no fallback.

Device tensors are planar ``[B, 3, H, W]`` u8, as in the JAX package.  The
HWC entry points relayout on the device, all through :func:`upscale_hwc`:
an input becomes planar there (a host array is first copied in once as it
is, HWC; the JAX package transposes on the host instead, to the same
bytes), and the planar result becomes HWC there, so a host-array caller
pays one contiguous copy in and one contiguous fetch.  On a CUDA device
that fetch lands in pinned memory from torch's caching host allocator
(:func:`fetch_host`): the returned array is backed by a pinned block,
which it keeps while the caller holds it.  Image decode and encode stay
on the host (srcnn.cpp:462,670).
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.cuda_merge import merge_ycrcb_to_bgr_fused
from .ops.cuda_resize import pre_upscale_fused
from .ops.cuda_srcnn import srcnn_y_fused
from .ops.cuda_vdsr import vdsr_y_fused
from .ops.resize import resize_bicubic_u8, scaled_size
from .utils.profiling import span
from .weights import SRCNNWeights, VDSRWeights, weights_on


def u8_tensor(frames) -> torch.Tensor:
    """``frames`` given to a frame entry point, as a uint8 tensor: a tensor
    as it is if it is uint8 (any other dtype raises TypeError); a host
    array cast to uint8, as it is (HWC), with one host copy only when it
    is not C-contiguous uint8."""
    if not isinstance(frames, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(frames, dtype=np.uint8))
    if frames.dtype != torch.uint8:
        raise TypeError(f"expected a uint8 tensor, got {frames.dtype}")
    return frames


def network_y(y_u8: torch.Tensor, weights) -> torch.Tensor:
    """The weights' network on uint8 Y plane(s), uint8 out: VDSR's chain
    for ``VDSRWeights``, SRCNN's K1 for any other weights."""
    if isinstance(weights, VDSRWeights):
        return vdsr_y_fused(y_u8, weights)
    return srcnn_y_fused(y_u8, weights)


def upscale_planar(bgr_p: torch.Tensor, weights,
                   out_hw: tuple[int, int]) -> torch.Tensor:
    """Planar BGR u8 ``[B, 3, H, W]`` -> planar BGR u8 ``[B, 3, oh, ow]``,
    on the device of ``bgr_p`` (``weights``, ``SRCNNWeights`` or
    ``VDSRWeights``, must live there too)."""
    with span("srcnn.pipeline"):
        up = pre_upscale_fused(bgr_p, out_hw)        # YCrCb [B, 3, oh, ow]
        y_sr = network_y(up[:, 0], weights)          # [B, oh, ow]
        return merge_ycrcb_to_bgr_fused(y_sr, up)


def upscale_hwc(hwc: torch.Tensor, scale: float, weights,
                device: torch.device) -> torch.Tensor:
    """HWC BGR u8 frames ``[B, H, W, 3]``, a tensor on any device with any
    strides, -> the HWC result ``[B, oh, ow, 3]``, contiguous, on
    ``device`` (``weights`` must live there): made planar there, through
    :func:`upscale_planar`, made HWC there."""
    with span("srcnn.entry.to_planar"):
        planar = hwc.to(device).permute(0, 3, 1, 2).contiguous()
    h, w = planar.shape[2:]
    ow, oh = scaled_size(w, h, scale)
    out = upscale_planar(planar, weights, (oh, ow))
    with span("srcnn.entry.to_hwc"):
        return out.permute(0, 2, 3, 1).contiguous()


def fetch_host(out: torch.Tensor) -> np.ndarray:
    """``out``, a contiguous result of the pipeline, as a host array.

    A CPU tensor is returned as ``out.numpy()``, its own memory.  A CUDA
    tensor is copied once, blocking, into a tensor from torch's pinned
    caching host allocator, and that tensor's array is returned: the copy
    goes straight into page-locked memory, with no bounce buffer and no
    first touch of fresh pages.  The array keeps its block while it is
    held; when it is dropped, the block goes back to torch's cache for the
    next result of its size class.

    ``fetch_host.misses`` counts the CUDA fetches in which the cache had
    to grow (``num_host_alloc`` of ``torch.cuda.host_memory_stats()``
    rose), ``fetch_host.hits`` every other CUDA fetch.
    """
    if not out.is_cuda:
        return out.numpy()
    allocs = torch.cuda.host_memory_stats()["num_host_alloc"]
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    if torch.cuda.host_memory_stats()["num_host_alloc"] > allocs:
        fetch_host.misses += 1
    else:
        fetch_host.hits += 1
    host.copy_(out)
    return host.numpy()


fetch_host.hits = 0     # CUDA fetches served from torch's pinned cache
fetch_host.misses = 0   # CUDA fetches for which the cache grew


def upscale_bgr_batch(bgr_u8, scale: float,
                      weights: SRCNNWeights | VDSRWeights | None = None,
                      device="cuda"):
    """Super-resolve a batch ``[B, H, W, 3]`` of BGR uint8 frames on
    ``device`` into ``[B, oh, ow, 3]``.

    Tensor in, tensor on ``device`` out; array in, array out.  A
    ``torch.Tensor`` (any strides) goes to ``device`` (no copy when it is
    there already) and becomes planar there; its result is returned on
    ``device``, unfetched.  A host array is cast to uint8 and copied in as
    it is, HWC (with one host copy first only when it is not C-contiguous
    uint8), and becomes planar on ``device`` as a tensor does; its result
    comes back as one C-contiguous, writable host array
    (:func:`fetch_host`).  On CUDA that array lives in pinned memory
    from torch's caching host allocator, and a held result keeps its block
    (1 GiB for 32 frames of 4K: torch rounds a block up to a power of
    two); a dropped one returns it for the next call.

    Output dims are ``floor(float32(dim) * float32(scale))``, matching the
    reference (srcnn.cpp:573-575).

    Under a ``torch.profiler`` session the call records ``srcnn.entry``
    and, nested in it, one span a stage (:func:`.utils.profiling.span`).
    """
    device = torch.device(device)
    tensor = isinstance(bgr_u8, torch.Tensor)
    with span("srcnn.entry"):
        if tensor:
            hwc = u8_tensor(bgr_u8)
        else:
            with span("srcnn.entry.h2d"):
                hwc = u8_tensor(bgr_u8).to(device)
        out = upscale_hwc(hwc, scale, weights_on(weights, device), device)
        if tensor:
            return out
        with span("srcnn.entry.fetch"):
            return fetch_host(out)


def upscale_bgr(bgr_u8, scale: float, weights: SRCNNWeights | None = None,
                device="cuda"):
    """Super-resolve one BGR uint8 image ``[H, W, 3]`` by ``scale``.

    Tensor in, tensor on ``device`` out; array in, array out
    (:func:`upscale_bgr_batch`).
    """
    batch = (bgr_u8[None] if isinstance(bgr_u8, torch.Tensor)
             else np.asarray(bgr_u8)[None])
    return upscale_bgr_batch(batch, scale, weights, device)[0]


def process_srcnn(buf, w: int, h: int, d: int, scale: float,
                  weights: SRCNNWeights | None = None, device="cuda"):
    """Raw-buffer library API (the libsrcnn ``ProcessSRCNN`` shape).

    The call contract of reference src/test.cpp:345-361: interleaved uint8
    pixels in, ``(out_buffer, out_size)`` out, with ``out_size ==
    floor(w*scale) * floor(h*scale) * d``.  ``d`` may be 1 (one plane,
    resized and super-resolved directly), 2 (RGB565, normalized to RGB by
    :func:`.imageio.conv_image` and returned with 3 channels), 3 (RGB,
    through YCrCb like the main binary) or 4 (RGBA: color super-resolved,
    alpha bicubic).
    """
    device = torch.device(device)
    if d == 2:
        from .imageio import conv_image

        img = conv_image(buf, w, h, 2)
        d = 3
    elif d in (1, 3, 4):
        img = np.asarray(buf, dtype=np.uint8).reshape(
            (h, w, d) if d > 1 else (h, w))
    else:
        raise ValueError(f"unsupported depth {d}; expected 1, 2, 3 or 4")
    ow, oh = scaled_size(w, h, scale)
    if d == 1:
        up = resize_bicubic_u8(torch.from_numpy(np.array(img)).to(device),
                               (oh, ow))
        out = network_y(up, weights_on(weights, device)).cpu().numpy()
    else:
        bgr = img[..., 2::-1]
        out = upscale_bgr(bgr, scale, weights, device)[..., ::-1]
        if d == 4:
            alpha = resize_bicubic_u8(
                torch.from_numpy(np.ascontiguousarray(img[..., 3])).to(device),
                (oh, ow)).cpu().numpy()
            out = np.concatenate([out, alpha[..., None]], axis=-1)
    flat = np.ascontiguousarray(out).reshape(-1)
    return flat, flat.size
