"""Named production configurations, single-card.

The port of ``srcnn_cpp_tpu/configs.py``: three deployment shapes with the
knobs that matter pre-picked, each returned as a runner on one device.

* ``batch_1080p_to_4k`` — throughput batches of 1080p-class frames x2;
* ``single_8k`` — one very large frame (e.g. 4K -> 8K) on one card;
* ``stream_4k30`` — the streaming config: micro-batches in flight with
  host I/O overlapped (:class:`.stream.StreamUpscaler`).

The multi-device forms — ``single_8k(mesh=...)`` (rows tiled over a mesh
with halo exchange) and ``stream_4k30_distributed`` — need the port of
``parallel/`` (ROADMAP.md, "Modules to port": ``parallel/``); until then
they raise :class:`NotImplementedError`.
"""

from __future__ import annotations

import numpy as np
import torch

from .pipeline import upscale_bgr, upscale_bgr_batch, weights_on
from .stream import StreamUpscaler
from .weights import SRCNNWeights

_NEEDS_PARALLEL = ("needs the port of srcnn_cpp_tpu/parallel/ (ROADMAP.md, "
                   "'Modules to port': parallel/), not done yet")


def batch_1080p_to_4k(weights: SRCNNWeights | None = None, batch: int = 32,
                      device="cuda"):
    """Runner: BGR uint8 ``[B, H, W, 3]`` -> x2, in chunks of ``batch``
    frames per dispatch (frames of one chunk share one launch per kernel)."""
    device = torch.device(device)
    weights = weights_on(weights, device)

    def run(frames: np.ndarray) -> np.ndarray:
        if frames.ndim != 4:
            raise ValueError(f"expected [B, H, W, 3], got {frames.shape}")
        outs = [upscale_bgr_batch(frames[i:i + batch], 2.0, weights, device)
                for i in range(0, len(frames), batch)]
        return outs[0] if len(outs) == 1 else np.concatenate(outs)

    run.batch = batch
    return run


def single_8k(weights: SRCNNWeights | None = None, mesh=None,
              scale: float = 2.0, device="cuda"):
    """Runner: one huge BGR frame ``[H, W, 3]`` -> ``scale``, on one card.

    ``mesh`` (rows tiled over several devices) is not ported yet and raises.
    """
    if mesh is not None:
        raise NotImplementedError(f"single_8k(mesh=...) {_NEEDS_PARALLEL}")
    device = torch.device(device)
    weights = weights_on(weights, device)

    def run(bgr: np.ndarray) -> np.ndarray:
        return upscale_bgr(bgr, scale, weights, device)

    return run


def stream_4k30(weights: SRCNNWeights | None = None, scale: float = 2.0,
                depth: int = 3, device="cuda"):
    """Runner: the pipelined video upscaler (push/drain protocol)."""
    return StreamUpscaler(scale, weights=weights, depth=depth, device=device)


def stream_4k30_distributed(*args, **kwargs):
    """The multi-host frame stream: not ported yet, raises."""
    raise NotImplementedError(f"stream_4k30_distributed {_NEEDS_PARALLEL}")
