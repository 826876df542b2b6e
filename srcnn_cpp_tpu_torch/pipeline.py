"""End-to-end super-resolution pipeline (the reference's ``pthreadcall``).

Runs the reference's 9-step pipeline (src/srcnn.cpp:449-698) on one
device:

    BGR u8 -> YCrCb (fixed-point) -> per-channel bicubic x scale
    (OpenCV-4.6-bit-exact) -> SRCNN on Y -> merge(Y', Cr, Cb) -> BGR u8

as three kernels: K2 the pre-pass (:mod:`.ops.cuda_resize`), the network
on Y and K3 the post-pass (:mod:`.ops.cuda_merge`).  The network follows
from the weights' type (:func:`network_y`): SRCNN's K1 conv stack
(:mod:`.ops.cuda_srcnn`) for ``SRCNNWeights``, the VDSR chain
(:mod:`.ops.cuda_vdsr`) for ``VDSRWeights``.  ``RCANWeights`` and
``SwinIRWeights`` take the pipeline's other shape (:func:`upscale_planar`):
RCAN x2 (:mod:`.ops.cuda_rcan`) or SwinIR x2 (:mod:`.ops.cuda_swinir`)
upscales the BGR frame itself, with no YCrCb, no bicubic and no merge.
On a CUDA device each wrapper launches its kernel; on the CPU each runs its
plain PyTorch version.  There is one path per device and no fallback.

Device tensors are planar ``[B, 3, H, W]`` u8, as in the JAX package.  The
HWC entry points relayout on the device, all through :func:`upscale_hwc`:
an input becomes planar there (a host array is first copied in as it is,
HWC; the JAX package transposes on the host instead, to the same bytes),
and the planar result becomes HWC there.  On a CUDA device a host-array
call runs in chunks of frames (:func:`chunks`, :func:`upscale_host`):
each chunk is staged through pinned memory and copied in on one copy
stream, runs on the current stream and is fetched on another, so that the
copy in of one chunk, the kernels of the next and the fetch of the one
before overlap.  The result lands in one pinned block from torch's caching
host allocator (:func:`fetch_host`), which the returned array keeps while
the caller holds it.  Image decode and encode stay on the host
(srcnn.cpp:462,670).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .ops.cuda_merge import merge_ycrcb_to_bgr_fused
from .ops.cuda_rcan import rcan_fused
from .ops.cuda_resize import pre_upscale_fused
from .ops.cuda_srcnn import srcnn_y_fused
from .ops.cuda_swinir import swinir_fused
from .ops.cuda_vdsr import vdsr_y_fused
from .ops.resize import resize_bicubic_u8, scaled_size
from .utils.profiling import span
from .weights import (RCANWeights, SRCNNWeights, SwinIRWeights, VDSRWeights,
                      weights_on)


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
    for ``VDSRWeights``, SRCNN's K1 for any other weights (which refuses
    any that are not SRCNN's, such as ``RCANWeights``, with TypeError)."""
    if isinstance(weights, VDSRWeights):
        return vdsr_y_fused(y_u8, weights)
    return srcnn_y_fused(y_u8, weights)


def upscale_planar(bgr_p: torch.Tensor, weights,
                   out_hw: tuple[int, int]) -> torch.Tensor:
    """Planar BGR u8 ``[B, 3, H, W]`` -> planar BGR u8 ``[B, 3, oh, ow]``,
    on the device of ``bgr_p`` (``weights`` must live there too).  The
    weights' type picks the shape: K2 -> the network on Y -> K3 for
    ``SRCNNWeights`` and ``VDSRWeights`` (:func:`network_y`); RCAN x2 or
    SwinIR x2 on the RGB frame for ``RCANWeights`` or ``SwinIRWeights``,
    which upscale by 2 only (another ``out_hw`` raises ValueError)."""
    with span("srcnn.pipeline"):
        if isinstance(weights, RCANWeights):
            return rcan_fused(bgr_p, weights, out_hw)
        if isinstance(weights, SwinIRWeights):
            return swinir_fused(bgr_p, weights, out_hw)
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


#: a host-array call on a CUDA device is cut into at most this many chunks
CHUNKS = 16
#: ... of at least this many bytes of input each, where the call has them
CHUNK_MIN_BYTES = 8 << 20


def chunks(b: int, h: int, w: int) -> list[slice]:
    """The frames of each chunk of a host-array call of ``b`` frames of
    ``h x w`` on a CUDA device, in order: ``ceil(b / CHUNKS)`` frames a
    chunk, but never fewer than hold ``CHUNK_MIN_BYTES`` of input, and the
    last chunk takes what is left.

    The card waits for the first chunk's copy in and the host for the last
    chunk's kernels and fetch, so a call takes its kernels' time plus
    about ``1 / CHUNKS`` of it.  The host takes about as long to stage and
    enqueue a chunk of one 1080p frame (6.2 MB) as the card takes for its
    kernels (~1 ms at x2, H100), so a smaller chunk would leave the card
    waiting for the host.  A batch of 32 1080p frames runs as 16 chunks of
    2; a frame, or a call of small frames, as one chunk.
    """
    per = max(-(-b // CHUNKS), -(-CHUNK_MIN_BYTES // max(h * w * 3, 1)))
    return [slice(s, min(s + per, b)) for s in range(0, b, per)]


def pinned(shape) -> torch.Tensor:
    """An uninitialised uint8 tensor of ``shape`` in page-locked memory,
    from torch's caching host allocator: the one place the port takes
    pinned blocks.  The staging below relies on that allocator: for each
    ``non_blocking`` copy that reads or writes a block it records an event
    on the copy's stream, and it hands a dropped block out again only once
    those events have completed, so no block is rewritten while a copy may
    still use it."""
    return torch.empty(shape, dtype=torch.uint8, pin_memory=True)


def fetch_host(shape) -> torch.Tensor:
    """The block a host-array call's result ``[B, oh, ow, 3]`` is fetched
    into on a CUDA device (:func:`pinned`): the copies go straight into
    page-locked memory, with no bounce buffer and no first touch of fresh
    pages.  The array the call hands back keeps the block while it is
    held; when it is dropped, the block goes back to torch's cache for the
    next result of its size class.  On the CPU a result is its own memory
    (``out.numpy()``) and takes no block.

    ``fetch_host.misses`` counts the CUDA calls in which the cache had to
    grow for the result (``num_host_alloc`` of
    ``torch.cuda.host_memory_stats()`` rose), ``fetch_host.hits`` every
    other CUDA call.
    """
    allocs = torch.cuda.host_memory_stats()["num_host_alloc"]
    host = pinned(shape)
    if torch.cuda.host_memory_stats()["num_host_alloc"] > allocs:
        fetch_host.misses += 1
    else:
        fetch_host.hits += 1
    return host


fetch_host.hits = 0     # CUDA calls whose result came from torch's cache
fetch_host.misses = 0   # CUDA calls for which the cache grew


def _copy_u8(dst: torch.Tensor, src) -> None:
    """The host array ``src`` into ``dst``, a CPU uint8 tensor of its
    shape, read through its own strides and cast to uint8 as
    :func:`u8_tensor` casts: by torch's threads where torch can take the
    array as it is (uint8, writable, no negative stride), else by numpy's
    cast (``np.copyto``, one thread)."""
    src = np.asarray(src)
    if src.shape != dst.shape:
        raise ValueError(f"frame of shape {src.shape}, expected "
                         f"{tuple(dst.shape)}")
    if (src.dtype == np.uint8 and src.flags.writeable
            and min(src.strides, default=0) >= 0):
        dst.copy_(torch.from_numpy(src))
    else:
        np.copyto(dst.numpy(), src, casting="unsafe")


def stage_in(frames, block: torch.Tensor, device) -> torch.Tensor:
    """Host frames ``[n, H, W, 3]`` (an array of any strides and dtype, or
    a sequence of ``[H, W, 3]`` arrays) copied into ``block`` and sent to
    ``device``, the stage-in step of every host-array path on a CUDA
    device (:func:`upscale_host`, the stream's dispatch).

    The host copies frame by frame into ``block`` (from :func:`pinned`),
    reading each frame through its own strides (:func:`_copy_u8`), so a
    strided view is copied once; then the block is copied to ``device``
    with ``non_blocking`` on the current stream, and the device tensor,
    allocated on that stream, is returned.
    """
    with span("srcnn.entry.stage_in"):
        for dst, frame in zip(block, frames, strict=True):
            _copy_u8(dst, frame)
    with span("srcnn.entry.h2d"):
        return block.to(device, non_blocking=True)


@functools.cache
def _copy_streams(device: torch.device):
    """The copy-in and the fetch stream of a CUDA device, made once."""
    return torch.cuda.Stream(device), torch.cuda.Stream(device)


def upscale_host(frames: np.ndarray, scale: float, weights,
                 device: torch.device) -> np.ndarray:
    """A host-array call ``[B, H, W, 3]`` on a CUDA device, in the chunks
    of :func:`chunks`: the result ``[B, oh, ow, 3]`` as one C-contiguous,
    writable host array in a pinned block (:func:`fetch_host`).

    For each chunk in order the host stages it in (:func:`stage_in`, on
    the copy-in stream); the current stream waits for that copy and runs
    :func:`upscale_hwc` on it; the fetch stream waits for that and copies
    the chunk's result into its slice of the block.  While the card works
    on one chunk the host is already copying the next.  A device tensor
    made on one stream and used on another is marked with
    ``record_stream``, so the device allocator does not hand its memory
    out again before that use has run.  Returns once the last fetch has
    completed.  ``upscale_host.calls`` and ``.chunks`` count the calls and
    the chunks sent.
    """
    b, h, w = frames.shape[:3]
    ow, oh = scaled_size(w, h, scale)
    parts = chunks(b, h, w)
    upscale_host.calls += 1
    upscale_host.chunks += len(parts)
    with torch.cuda.device(device):
        compute = torch.cuda.current_stream()
        copy_in, fetch = _copy_streams(compute.device)
        block_in = pinned(frames.shape)
        host = fetch_host((b, oh, ow, 3))
        for part in parts:
            with torch.cuda.stream(copy_in):
                x = stage_in(frames[part], block_in[part], device)
            compute.wait_stream(copy_in)
            x.record_stream(compute)
            out = upscale_hwc(x, scale, weights, device)
            fetch.wait_stream(compute)
            with span("srcnn.entry.fetch"), torch.cuda.stream(fetch):
                host[part].copy_(out, non_blocking=True)
            out.record_stream(fetch)
        with span("srcnn.entry.fetch_wait"):
            fetch.synchronize()
    return host.numpy()


upscale_host.calls = 0    # host-array calls that ran in chunks
upscale_host.chunks = 0   # chunks those calls sent


def upscale_bgr_batch(bgr_u8, scale: float,
                      weights: SRCNNWeights | VDSRWeights | RCANWeights
                      | SwinIRWeights | None = None,
                      device="cuda"):
    """Super-resolve a batch ``[B, H, W, 3]`` of BGR uint8 frames on
    ``device`` into ``[B, oh, ow, 3]``.

    Tensor in, tensor on ``device`` out; array in, array out.  A
    ``torch.Tensor`` (any strides) goes to ``device`` (no copy when it is
    there already) and becomes planar there; its result is returned on
    ``device``, unfetched.  A host array is cast to uint8 and copied in as
    it is, HWC, and becomes planar on ``device`` as a tensor does; its
    result comes back as one C-contiguous, writable host array.  On CUDA
    the call runs in chunks that overlap their copies with the kernels
    (:func:`upscale_host`), and the array lives in pinned memory from
    torch's caching host allocator: a held result keeps its block (1 GiB
    for 32 frames of 4K: torch rounds a block up to a power of two); a
    dropped one returns it for the next call.  On the CPU it is the
    result's own memory.

    Output dims are ``floor(float32(dim) * float32(scale))``, matching the
    reference (srcnn.cpp:573-575).

    Under a ``torch.profiler`` session the call records ``srcnn.entry``
    and, nested in it, one span a stage (:func:`.utils.profiling.span`).
    """
    device = torch.device(device)
    with span("srcnn.entry"):
        weights = weights_on(weights, device)
        if isinstance(bgr_u8, torch.Tensor):
            return upscale_hwc(u8_tensor(bgr_u8), scale, weights, device)
        if device.type == "cuda":
            return upscale_host(np.asarray(bgr_u8), scale, weights, device)
        with span("srcnn.entry.h2d"):
            hwc = u8_tensor(bgr_u8).to(device)
        out = upscale_hwc(hwc, scale, weights, device)
        with span("srcnn.entry.fetch"):
            return out.numpy()


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
