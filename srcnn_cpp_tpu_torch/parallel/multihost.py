"""Scaling harness of the tiled conv (the port of
``srcnn_cpp_tpu/parallel/multihost.py``).

:func:`scaling_efficiency` times K1 tiled over ``n`` = 1, 2, 4, ... row
blocks.  The JAX harness timed its XLA conv; this one times the port's
kernel path (:func:`.tiling.srcnn_y_tiled`: the halo copies and one K1
launch per block).  On distinct cards it measures scaling; on one card
named ``n`` times (``devices=["cuda:0"] * n``) every block runs on the same
card, so it measures what tiling costs — the halo rows recomputed and the
extra launches — and not scaling.  Multi-process runs call
:func:`.distributed.initialize` first.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .mesh import make_mesh
from .tiling import srcnn_y_tiled


def _sync(devices) -> None:
    for d in {torch.device(d) for d in devices}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def scaling_efficiency(weights, image_hw=(256, 256), batch: int = 4,
                       device_counts=None, iters: int = 4,
                       devices=None) -> dict:
    """MP/s of the tiled conv over ``n`` row blocks of ``devices[:n]``
    (default: every visible card), for each ``n`` of ``device_counts``
    (default 1, 2, 4, ... up to ``len(devices)``), best of 3 rounds of
    ``iters`` calls on a seeded ``[batch, *image_hw]`` Y plane resident on
    the first device; the output stays on the device, which is synchronized
    before the clock stops.  Returns ``{"mps": {n: MP/s}, "n_max",
    "efficiency"}``: MP/s at the largest ``n`` over ``n`` times MP/s at 1.
    """
    if devices is None:
        devices = list(make_mesh().devices.flat)
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= len(devices)]
    h, w = image_hw
    y = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (batch, h, w), dtype=np.uint8)).to(devices[0])
    weights = weights.to(devices[0])
    results = {}
    for n in device_counts:
        mesh = make_mesh(data=1, row=n, devices=devices[:n])
        srcnn_y_tiled(y, weights, mesh)
        _sync(devices[:n])
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(iters):
                srcnn_y_tiled(y, weights, mesh)
            _sync(devices[:n])
            best = min(best, (time.perf_counter() - t0) / iters)
        results[n] = batch * h * w / 1e6 / best
    n_max = max(results)
    eff = results[n_max] / (results[1] * n_max) if 1 in results else None
    return {"mps": results, "n_max": n_max, "efficiency": eff}
