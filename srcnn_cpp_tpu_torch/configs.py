"""Named production configurations.

The port of ``srcnn_cpp_tpu/configs.py``: the deployment shapes with the
knobs that matter pre-picked, each returned as a runner.

* ``batch_1080p_to_4k`` — throughput batches of 1080p-class frames x2;
* ``single_8k`` — one very large frame (e.g. 4K -> 8K) on one card, or
  with ``mesh=`` its rows (and columns) tiled over a device mesh with halo
  exchange (:mod:`.parallel.tiling`);
* ``stream_4k30`` — the streaming config: micro-batches in flight with
  host I/O overlapped (:class:`.stream.StreamUpscaler`);
* ``stream_4k30_distributed`` — the multi-process frame stream
  (:class:`.parallel.distributed.DistributedStream`).
"""

from __future__ import annotations

import numpy as np
import torch

from .pipeline import u8_tensor, upscale_bgr, upscale_bgr_batch, weights_on
from .stream import StreamUpscaler
from .weights import SRCNNWeights, refuse_vdsr

def batch_1080p_to_4k(weights: SRCNNWeights | None = None, batch: int = 32,
                      device="cuda"):
    """Runner: BGR uint8 ``[B, H, W, 3]`` -> x2, in chunks of ``batch``
    frames per dispatch (frames of one chunk share one launch per kernel).
    A tensor batch comes back as one tensor on ``device``, its chunks
    joined there; a host array as one host array.  ``VDSRWeights`` run
    VDSR in place of SRCNN (:func:`.pipeline.network_y`)."""
    device = torch.device(device)
    weights = weights_on(weights, device)

    def run(frames):
        if frames.ndim != 4:
            raise ValueError(f"expected [B, H, W, 3], got {frames.shape}")
        outs = [upscale_bgr_batch(frames[i:i + batch], 2.0, weights, device)
                for i in range(0, len(frames), batch)]
        if len(outs) == 1:
            return outs[0]
        return (torch.cat(outs) if isinstance(frames, torch.Tensor)
                else np.concatenate(outs))

    run.batch = batch
    return run


def single_8k(weights: SRCNNWeights | None = None, mesh=None,
              scale: float = 2.0, device="cuda"):
    """Runner: one huge BGR frame ``[H, W, 3]`` -> ``scale``, on ``device``.

    Tensor in, tensor out; array in, array out, with or without ``mesh``,
    so the two runners are interchangeable.  Without ``mesh`` a tensor's
    result is returned on ``device``.

    With ``mesh`` (:func:`.parallel.make_mesh`; ``device`` is then unused)
    each block's input rows go to its device, and windowed K2, K1 and K3
    run per block with halo exchange (:func:`.parallel.tiling.upscale_blocks`);
    the result equals the unsharded runner's bit for bit.  A tensor (any
    device, any strides) becomes planar as a view, its blocks go from its
    device straight to theirs, and the result is joined and made HWC on
    the input's device, unfetched; a host array is transposed on the host
    and its blocks joined there.  Any H and W
    serve: an axis that does not divide the input or output size splits it
    unevenly (``tensor_split``).  A geometry whose blocks are too small for
    their halos raises ValueError.
    """
    if mesh is not None:
        return _single_8k_mesh(weights, mesh, scale)
    device = torch.device(device)
    weights = weights_on(weights, device)

    def run(bgr):
        return upscale_bgr(bgr, scale, weights, device)

    return run


def _single_8k_mesh(weights: SRCNNWeights | None, mesh, scale: float):
    from .ops.resize import scaled_size
    from .parallel.tiling import (HALO, gather_blocks, split_blocks,
                                  upscale_blocks)

    refuse_vdsr(weights, "single_8k(mesh=...)", f"SRCNN's {HALO} rows and "
                f"columns")
    weights = weights_on(weights, "cpu") if weights is None else weights

    def run(bgr):
        h, w = bgr.shape[:2]
        ow, oh = scaled_size(w, h, scale)
        tensor = isinstance(bgr, torch.Tensor)
        if tensor:
            planar = u8_tensor(bgr).permute(2, 0, 1)[None]
        else:
            # a host transpose, as the JAX runner's (srcnn_cpp_tpu/configs.py:119)
            planar = torch.from_numpy(np.ascontiguousarray(
                np.moveaxis(np.asarray(bgr, dtype=np.uint8), -1, 0)))[None]
        out = upscale_blocks(split_blocks(planar, mesh), weights, (h, w),
                             (oh, ow), mesh)
        # the JAX runner always fetches (srcnn_cpp_tpu/configs.py:125)
        out = gather_blocks(out, device=planar.device)[0]
        if tensor:
            return out.permute(1, 2, 0).contiguous()
        return np.ascontiguousarray(np.moveaxis(out.numpy(), 0, -1))

    return run


def stream_4k30(weights: SRCNNWeights | None = None, scale: float = 2.0,
                depth: int = 3, device="cuda"):
    """Runner: the pipelined video upscaler (push/drain protocol)."""
    return StreamUpscaler(scale, weights=weights, depth=depth, device=device)


def stream_4k30_distributed(mesh=None, weights: SRCNNWeights | None = None,
                            scale: float = 2.0, depth: int = 2):
    """Runner: the multi-process frame stream (BASELINE config 5).

    Frames over the mesh's ``data`` axis, each frame's rows over ``row``
    with halo exchange; every process pushes its local slab
    (:meth:`.parallel.DistributedStream.push_local`).  Call
    :func:`.parallel.initialize` once per process first; ``mesh=None`` is
    :func:`.parallel.frame_mesh` with one frame per process on ``data``.
    """
    from .parallel.distributed import DistributedStream, frame_mesh

    if mesh is None:
        import torch.distributed as dist

        mesh = frame_mesh(data=dist.get_world_size()
                          if dist.is_initialized() else 1)
    return DistributedStream(scale, mesh, weights=weights, depth=depth)
