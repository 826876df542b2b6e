"""Device meshes: a ``(data, row, col)`` grid of ``torch.device``\\ s.

The port of ``srcnn_cpp_tpu/parallel/mesh.py``, with its axis names:

* ``data`` — whole frames (the batch) split across blocks;
* ``row`` / ``col`` — one frame's rows / columns split across blocks and
  stitched with halo exchange (:mod:`.tiling`).

A mesh may name one device many times: ``make_mesh(devices=["cuda:0"] * 4)``
runs every block's kernels on one card and really stitches every seam,
which is how the tilings are checked on one card; on several cards the same
code puts each block on its own card.  A mesh that spans processes
(:func:`.distributed.frame_mesh`) also records which process owns each
block; a block of another process has no device here (``None``).
"""

from __future__ import annotations

import numpy as np
import torch

AXES = ("data", "row", "col")


def _device(d) -> torch.device:
    """``d`` as a ``torch.device`` with its CUDA index filled in."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _process_rank() -> int:
    """This process's rank in ``torch.distributed`` (0 when not started)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


class Mesh:
    """``devices``: an object array ``[data, row, col]`` of ``torch.device``
    (``None`` for a block of another process); ``ranks``: the process that
    owns each block (this process's for every block by default); ``shape``:
    ``{"data": .., "row": .., "col": ..}``."""

    def __init__(self, devices: np.ndarray, ranks: np.ndarray | None = None):
        if devices.ndim != 3:
            raise ValueError(f"a mesh is [data, row, col], got {devices.shape}")
        self.devices = devices
        self.rank = _process_rank()
        self.ranks = np.full(devices.shape, self.rank) if ranks is None \
            else np.asarray(ranks).reshape(devices.shape)
        self.shape = dict(zip(AXES, devices.shape))

    def is_local(self, idx: tuple[int, int, int]) -> bool:
        return int(self.ranks[idx]) == self.rank

    def local_blocks(self):
        """The grid indices of this process's blocks, in grid order."""
        return [i for i in np.ndindex(*self.devices.shape) if self.is_local(i)]

    @property
    def size(self) -> int:
        return self.devices.size


def make_mesh(data: int | None = None, row: int | None = None, col: int = 1,
              devices=None) -> Mesh:
    """Build a ``(data, row, col)`` mesh over ``devices``.

    ``devices=None`` means every visible CUDA card; with no card that is an
    error (pass e.g. ``devices=["cpu"] * 8`` to tile on the CPU).  With no
    sizes, every device goes on the ``row`` axis.  One of ``data``/``row``
    may be None and is inferred; the sizes must multiply to the device
    count.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is available; pass "
                               "devices=[...] (e.g. ['cpu'] * 8) to tile "
                               "elsewhere")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    n = len(devices)
    if data is None and row is None:
        data, row = 1, n // col
    elif data is None:
        data = n // (row * col)
    elif row is None:
        row = n // (data * col)
    if data * row * col != n or min(data, row, col) < 1:
        raise ValueError(f"mesh {data}x{row}x{col} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(data, row, col))
