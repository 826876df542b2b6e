"""Parallelism over device meshes (the port of ``srcnn_cpp_tpu/parallel``).

* :mod:`.mesh` — :func:`make_mesh`: a ``(data, row, col)`` grid of
  ``torch.device``\\ s, which may repeat one card;
* :mod:`.tiling` — one frame's rows and columns over the mesh, stitched
  with halo exchange, through K1, K2 and K3 per block
  (:func:`srcnn_y_tiled`, :func:`upscale_y_tiled`,
  :func:`pre_upscale_fused_rows`, :func:`merge_ycrcb_to_bgr_fused_rows`),
  and the differentiable tiled forward of the sharded train step;
* :mod:`.distributed` — the multi-process runtime over
  ``torch.distributed``: :func:`initialize`, :func:`frame_mesh` and the
  pipelined :class:`DistributedStream`;
* :mod:`.multihost` — :func:`scaling_efficiency`.

``gspmd.py`` (XLA's automatic partitioner) has no counterpart.
"""

from .mesh import Mesh, make_mesh
from .tiling import (merge_ycrcb_to_bgr_fused_rows, pre_upscale_fused_rows,
                     srcnn_y_tiled, upscale_y_tiled)


def __getattr__(name):
    if name in ("DistributedStream", "frame_mesh", "initialize"):
        from . import distributed

        return getattr(distributed, name)
    if name == "scaling_efficiency":
        from . import multihost

        return multihost.scaling_efficiency
    raise AttributeError(name)


__all__ = ["Mesh", "make_mesh", "srcnn_y_tiled", "upscale_y_tiled",
           "pre_upscale_fused_rows", "merge_ycrcb_to_bgr_fused_rows",
           "initialize", "scaling_efficiency", "DistributedStream",
           "frame_mesh"]
