"""The multi-process frame stream over ``torch.distributed`` (BASELINE config 5).

The port of ``srcnn_cpp_tpu/parallel/distributed.py``.  A ``(data, row)``
mesh spans N processes, each owning ``local_devices`` consecutive blocks
(:func:`frame_mesh`, process-major):

* whole frames split over ``data``;
* each frame's rows split over ``row``, stitched with halo exchange
  (:mod:`.tiling`): a copy between a process's own blocks, a
  ``torch.distributed`` send and receive across processes;
* every block runs the pipeline on its device: windowed K2, K1 tiled, K3
  on CUDA blocks, their plain versions on CPU blocks; several dispatches
  stay in flight (:class:`DistributedStream`).

Backends: ``nccl`` (the default for CUDA) carries the CUDA tensors
themselves and needs one card per process; ``gloo`` (the default for the
CPU; on CUDA when several processes share one card, which NCCL refuses)
carries host copies.  The backend is the caller's choice and is never
switched on a failure.

The module doubles as the multi-process runner::

    python -m srcnn_cpp_tpu_torch.parallel.distributed \\
        --init-method=file:///tmp/rdv --world-size=2 --rank=K \\
        --local-devices=2 --backend=gloo --device=cuda \\
        --frames=4 --size=1920x1080 --check

``--check`` holds every process's output block against the monolithic
pipeline (:func:`..pipeline.upscale_planar`) on the same device type, bit
for bit.  Under ``torchrun`` the rendezvous arguments come from its
environment.
"""

from __future__ import annotations

import argparse
import collections
import datetime
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ..ops.resize import scaled_size
from ..weights import SRCNNWeights, load_weights, refuse_vdsr
from .mesh import Mesh, _device
from .tiling import (HALO, bounds, gather_blocks, pre_upscale_halos,
                     upscale_blocks)

_PROG = "srcnn-torch-distributed"


def _card(rank: int) -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available (use device='cpu')")
    return torch.device("cuda", rank % torch.cuda.device_count())


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None,
               local_devices: int | None = None, device: str = "cuda",
               timeout: float = 300.0) -> list[torch.device]:
    """Join the process group (``torch.distributed.init_process_group``)
    and return this process's devices: ``local_devices`` (default 1) mesh
    blocks, all on its device — card ``rank % device_count()`` for
    ``device="cuda"``, else the CPU.

    ``None`` arguments come from ``torchrun``'s environment (``env://``,
    ``WORLD_SIZE``, ``RANK``).  ``backend`` defaults to ``nccl`` for CUDA and
    ``gloo`` for the CPU.  ``timeout`` (seconds) bounds the rendezvous and
    every collective, so a lost peer fails the run instead of hanging it.
    """
    dev = _card(rank if rank is not None else int(os.environ.get("RANK", 0))) \
        if device == "cuda" else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kwargs = {}
    if world_size is not None:
        kwargs["world_size"] = int(world_size)
    if rank is not None:
        kwargs["rank"] = int(rank)
    dist.init_process_group(
        backend=backend, init_method=init_method or "env://",
        timeout=datetime.timedelta(seconds=timeout), **kwargs)
    return [dev] * int(local_devices or 1)


def frame_mesh(data: int | None = None, devices=None) -> Mesh:
    """A ``(data, row, 1)`` mesh over every process's blocks, process-major:
    this process owns ``len(devices)`` consecutive blocks of the grid (the
    list :func:`initialize` returned; one card by default).

    ``data`` = the process count gives each process whole frames (halos stay
    inside it); ``data=1`` (the default) spans one frame's rows over every
    process, so halos cross the process boundary.
    """
    if devices is None:
        devices = [_card(dist.get_rank() if dist.is_initialized() else 0)]
    devices = [_device(d) for d in devices]
    world = dist.get_world_size() if dist.is_initialized() else 1
    per, n = len(devices), len(devices) * world
    data = data or 1
    row = n // data
    if data * row != n:
        raise ValueError(f"data axis {data} does not divide {n} blocks")
    if per % row and row % per:
        raise ValueError(f"{per} blocks per process over a row axis of {row}:"
                         f" a process's blocks would not form one slab")
    ranks = np.repeat(np.arange(world), per).reshape(data, row, 1)
    me = dist.get_rank() if dist.is_initialized() else 0
    arr = np.empty(n, dtype=object)
    arr[me * per:(me + 1) * per] = devices
    return Mesh(arr.reshape(data, row, 1), ranks)


def _local_bounds(mesh: Mesh, shape, dims=(0, 2), rank: int | None = None):
    """``{dim: (start, stop)}`` of process ``rank``'s (this one's) blocks
    along ``dims`` (batch, rows) of a global array of ``shape`` split over
    the ``data`` and ``row`` axes."""
    rank = mesh.rank if rank is None else rank
    owned = [q for q in np.ndindex(*mesh.devices.shape)
             if int(mesh.ranks[q]) == rank]
    out = {}
    for d, axis in zip(dims, (0, 1)):
        cut = bounds(shape[d], mesh.devices.shape[axis])
        idx = [q[axis] for q in owned]
        out[d] = (cut[min(idx)], cut[max(idx) + 1])
    return out


class DistributedStream:
    """Pipelined multi-process frame upscaler over a ``(data, row)`` mesh.

    ``push_local`` takes this process's slab of the global batch — planar
    BGR u8 ``[B_local, 3, H_local, W]``, its share of the ``data`` and
    ``row`` axes — dispatches the pipeline on its blocks and returns a
    completed output slab once ``depth`` dispatches are in flight, in
    order.  ``gather="full"`` returns the whole output batch on every
    process (an ``all_gather``) instead of the local slab.
    """

    def __init__(self, scale: float, mesh: Mesh,
                 weights: SRCNNWeights | None = None, depth: int = 2,
                 gather: str = "local"):
        if gather not in ("local", "full"):
            raise ValueError(f"gather must be 'local' or 'full', not "
                             f"{gather!r}")
        refuse_vdsr(weights, "parallel.distributed", f"SRCNN's {HALO} "
                    f"rows, exchanged between the row blocks")
        if mesh.shape["col"] != 1:
            raise ValueError("the stream tiles rows only: col must be 1")
        self.scale, self.mesh = float(scale), mesh
        self.depth, self.gather = int(depth), gather
        self.weights = weights if weights is not None else load_weights()
        self._q: collections.deque = collections.deque()
        owned = mesh.local_blocks()
        self._share = tuple(len({q[a] for q in owned}) for a in (0, 1))

    def _global_shape(self, local_shape) -> tuple[int, int, int, int]:
        """The global input batch's ``[B, 3, H, W]`` from a local slab's."""
        (bl, c, hl, w), (nd, nr) = local_shape, self._share
        return (bl * self.mesh.shape["data"] // nd, c,
                hl * self.mesh.shape["row"] // nr, w)

    def push_local(self, local_bgr_p) -> np.ndarray | None:
        mesh = self.mesh
        shape = self._global_shape(local_bgr_p.shape)
        b, _, h, w = shape
        ow, oh = scaled_size(w, h, self.scale)
        nd, nr = mesh.shape["data"], mesh.shape["row"]
        # each process's slab is its even share, as in the JAX stream
        if b % nd or h % nr or oh % nr:
            raise ValueError(f"global batch {b} / height {h} / output height "
                             f"{oh} not divisible by mesh {nd}x{nr}")
        pre_upscale_halos((h, w), (oh, ow), mesh.devices.shape)  # raises
        lb = _local_bounds(mesh, shape)
        if (lb[0][1] - lb[0][0], lb[2][1] - lb[2][0]) != \
                (local_bgr_p.shape[0], local_bgr_p.shape[2]):
            raise ValueError(f"local slab {tuple(local_bgr_p.shape)} is not "
                             f"this process's share of {shape}")
        x = torch.from_numpy(np.ascontiguousarray(local_bgr_p)) \
            if isinstance(local_bgr_p, np.ndarray) else local_bgr_p
        bc, rc = bounds(b, mesh.shape["data"]), bounds(h, mesh.shape["row"])
        blocks = np.empty(mesh.devices.shape, dtype=object)
        for q in mesh.local_blocks():
            d, r = q[0], q[1]
            blocks[q] = x[bc[d] - lb[0][0]:bc[d + 1] - lb[0][0], :,
                          rc[r] - lb[2][0]:rc[r + 1] - lb[2][0]].to(
                mesh.devices[q], non_blocking=True).contiguous()
        out = upscale_blocks(blocks, self.weights, (h, w), (oh, ow), mesh)
        self._q.append((out, (b, 3, oh, ow)))
        if len(self._q) > self.depth:
            return self._fetch(*self._q.popleft())
        return None

    def drain(self):
        while self._q:
            yield self._fetch(*self._q.popleft())

    def _local_slab(self, blocks) -> torch.Tensor:
        """This process's blocks joined into its contiguous slab, on the
        host (gloo) or its first device (NCCL)."""
        mesh = self.mesh
        owned = mesh.local_blocks()
        ds = sorted({q[0] for q in owned})
        rs = sorted({q[1] for q in owned})
        grid = np.empty((len(ds), len(rs), 1), dtype=object)
        for q in owned:
            grid[ds.index(q[0]), rs.index(q[1]), 0] = blocks[q]
        dev = mesh.devices[owned[0]] if self.gather == "full" and \
            dist.is_initialized() and dist.get_backend() == "nccl" else "cpu"
        return gather_blocks(grid, (0, 2, 3), device=dev)

    def _fetch(self, blocks, out_shape) -> np.ndarray:
        slab = self._local_slab(blocks)
        if self.gather == "local":
            return slab.numpy()
        if not dist.is_initialized() or dist.get_world_size() == 1:
            return slab.cpu().numpy()
        parts = [torch.empty_like(slab) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, slab.contiguous())
        full = np.empty(out_shape, dtype=np.uint8)
        for r, part in enumerate(parts):
            lb = _local_bounds(self.mesh, out_shape, rank=r)
            full[lb[0][0]:lb[0][1], :, lb[2][0]:lb[2][1]] = part.cpu().numpy()
        return full


def _kernel_counts() -> tuple[dict, dict]:
    """The launch counts of K2, K1, K3 and the calls of their plain
    versions."""
    from ..ops import cuda_merge, cuda_resize, cuda_srcnn

    wrappers = (cuda_resize.pre_upscale_fused, cuda_srcnn.srcnn_y_fused,
                cuda_merge.merge_ycrcb_to_bgr_fused)
    plains = (cuda_resize.pre_upscale_plain, cuda_srcnn.srcnn_y_plain,
              cuda_merge.merge_plain)
    return ({f.__name__: f.launches for f in wrappers},
            {f.__name__: f.calls for f in plains})


def _counts_since(start) -> dict:
    now = _kernel_counts()
    return {"launches": {k: v - start[0][k] for k, v in now[0].items()},
            "plain_calls": {k: v - start[1][k] for k, v in now[1].items()}}


def _process() -> dict:
    return {"process": dist.get_rank() if dist.is_initialized() else 0,
            "processes": dist.get_world_size() if dist.is_initialized() else 1}


def _mono(frames: np.ndarray, weights, out_hw, device) -> np.ndarray:
    """The monolithic pipeline on ``device``: the bit-exactness oracle."""
    from ..pipeline import upscale_planar, weights_on

    x = torch.from_numpy(np.ascontiguousarray(frames)).to(device)
    return upscale_planar(x, weights_on(weights, device), out_hw).cpu().numpy()


def run_synthetic(frames: int, size: tuple[int, int], scale: float,
                  mesh: Mesh, weights: SRCNNWeights | None = None,
                  depth: int = 2, check: bool = False, seed: int = 0) -> dict:
    """Per-process synthetic stream; optionally checks each output slab.

    Every process makes the same seeded global frames (``data`` frames a
    dispatch), pushes only its slab, and with ``check`` holds its output
    slab against the monolithic pipeline on the full frames on its own
    device, bit for bit.  Returns frames, seconds, fps, MP/s, the kernels'
    launches and their plain versions' calls in the timed run, and with
    ``check`` ``bitexact`` and ``max_abs_diff``.
    """
    weights = weights if weights is not None else load_weights()
    h, w = size
    nd = mesh.shape["data"]
    ow, oh = scaled_size(w, h, scale)
    stream = DistributedStream(scale, mesh, weights, depth=depth)
    ib = _local_bounds(mesh, (nd, 3, h, w))
    ob = _local_bounds(mesh, (nd, 3, oh, ow))
    dev = mesh.devices[mesh.local_blocks()[0]]

    def global_frames(i):
        rng = np.random.default_rng(seed + i)
        return rng.integers(0, 256, (nd, 3, h, w), dtype=np.uint8)

    def local(g):
        return g[ib[0][0]:ib[0][1], :, ib[2][0]:ib[2][1]]

    # warm-up: the kernels' build, the plans
    stream.push_local(local(global_frames(0)))
    for _ in stream.drain():
        pass
    start = _kernel_counts()
    t0 = time.monotonic()
    outs = []
    for i in range(frames):
        r = stream.push_local(local(global_frames(i)))
        if r is not None:
            outs.append(r)
    outs += list(stream.drain())
    dt = time.monotonic() - t0
    result = {**_process(), "mesh": dict(mesh.shape), "device": str(dev),
              "frames": frames * nd, "seconds": dt, "fps": frames * nd / dt,
              "mps": frames * nd * oh * ow / 1e6 / dt, **_counts_since(start)}
    if check:
        worst = 0
        for i, blk in enumerate(outs):
            want = _mono(global_frames(i), weights, (oh, ow), dev)
            want = want[ob[0][0]:ob[0][1], :, ob[2][0]:ob[2][1]]
            worst = max(worst, int(np.abs(blk.astype(int)
                                          - want.astype(int)).max()))
        result["bitexact"] = worst == 0 and len(outs) == frames
        result["max_abs_diff"] = worst
    return result


def run_train(steps: int, size: tuple[int, int], mesh: Mesh,
              weights: SRCNNWeights | None = None, seed: int = 0,
              lr: float = 1e-4) -> dict:
    """Multi-process sharded training (batch over ``data``, rows over
    ``row``): every process makes the same seeded global batch, takes its
    blocks (:func:`..train.shard_batch`) and runs
    :func:`..train.make_sharded_train_step` with Adam; gradients cross the
    process boundary through the halo exchange and the ``all_reduce``.
    Returns the per-step losses and per-tensor sums of the final weights'
    magnitudes, to compare with a one-process run within float tolerance."""
    from ..models import SRCNN
    from ..train import make_sharded_train_step, shard_batch

    h, w = size
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (2 * mesh.shape["data"], h, w), dtype=np.uint8)
    t = np.clip(x.astype(np.float32) * 1.01 - 1.0, 0, 255)
    dev = mesh.devices[mesh.local_blocks()[0]]
    model = SRCNN.from_weights(weights, device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=lr, eps=1e-8)
    step = make_sharded_train_step(mesh, model, opt)
    xs, ts = shard_batch(mesh, x), shard_batch(mesh, t)
    losses = [step(xs, ts) for _ in range(steps)]
    fp = {k: float(getattr(model, k).detach().abs().sum())
          for k in ("conv1_w", "conv1_b", "conv2_w", "conv3_w")}
    return {**_process(), "mesh": dict(mesh.shape), "device": str(dev),
            "losses": losses, "weight_fingerprint": fp,
            "input_grad_sum": _input_grad_sum(model, mesh, xs, ts)}


def _input_grad_sum(model, mesh: Mesh, xs: list, ts: list) -> float:
    """The sum over every block of the squared error's gradient with
    respect to the input: it reaches each halo's source rows only through
    the halo exchange's backward, so it equals a one-process run's only if
    that backward adds every halo's gradient into its edge rows."""
    from .tiling import _srcnn_tile_f32

    grid = np.empty(mesh.devices.shape, dtype=object)
    for i, blk in enumerate(xs):
        if blk is not None:
            grid.flat[i] = blk.float().requires_grad_()
    preds = _srcnn_tile_f32(grid, model, mesh)
    local = mesh.local_blocks()
    sum(((preds[q] - ts[int(np.ravel_multi_index(q, grid.shape))]) ** 2)
        .sum() for q in local).backward()
    total = torch.tensor(sum(float(grid[q].grad.sum()) for q in local),
                         dtype=torch.float64)
    if dist.is_initialized():
        dist.all_reduce(total)
    return float(total)


def run_video(src: str, dst: str | None, scale: float, mesh: Mesh,
              weights: SRCNNWeights | None = None, depth: int = 2,
              check: bool = False, codec: str = "FFV1",
              max_frames: int | None = None) -> dict:
    """Distributed video super-resolution (BASELINE config 5 end to end).

    Every process decodes the same file (decode is a small share of the
    work), groups frames along ``data`` and pushes only its slab of each
    group; the outputs are gathered to every process and process 0 writes
    them in order with a lossless codec by default (FFV1).  ``check``
    holds every output frame against the monolithic pipeline on the same
    decoded frame: order and bits.  Returns frames, seconds, fps, MP/s.
    """
    import cv2

    weights = weights if weights is not None else load_weights()
    cap = cv2.VideoCapture(src)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video {src!r}")
    in_fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    nd = mesh.shape["data"]
    stream = DistributedStream(scale, mesh, weights, depth=depth,
                               gather="full")
    write_here = dst is not None and _process()["process"] == 0
    dev = mesh.devices[mesh.local_blocks()[0]]
    writer = None
    pending: collections.deque = collections.deque()  # (n_valid, inputs)
    stats = {"frames": 0, "bitexact": True, "max_abs_diff": 0}
    oh = ow = None

    def emit(out_g):
        nonlocal writer
        n_valid, inputs = pending.popleft()
        for k in range(n_valid):
            if check:
                mono = _mono(inputs[k:k + 1], weights, (oh, ow), dev)[0]
                d = int(np.abs(out_g[k].astype(int) - mono.astype(int)).max())
                stats["max_abs_diff"] = max(stats["max_abs_diff"], d)
                stats["bitexact"] = stats["bitexact"] and d == 0
            if write_here:
                if writer is None:
                    writer = cv2.VideoWriter(
                        dst, cv2.VideoWriter_fourcc(*codec), in_fps, (ow, oh))
                    if not writer.isOpened():
                        raise RuntimeError(f"cannot open video writer for "
                                           f"{dst!r} (codec {codec!r} "
                                           f"unavailable?)")
                writer.write(np.ascontiguousarray(np.moveaxis(out_g[k], 0, -1)))
            stats["frames"] += 1

    group: list[np.ndarray] = []
    t0 = time.monotonic()
    try:
        while True:
            ok, frame = cap.read()
            if ok and max_frames is not None and stats["frames"] + len(
                    pending) * nd + len(group) >= max_frames:
                ok = False
            if ok:
                group.append(np.moveaxis(frame, -1, 0))     # planar [3, H, W]
            if group and (len(group) == nd or not ok):
                n_valid = len(group)
                group += [group[-1]] * (nd - n_valid)       # pad the last group
                batch, group = np.stack(group), []
                h, w = batch.shape[2:]
                ow, oh = scaled_size(w, h, scale)
                lb = _local_bounds(mesh, batch.shape)
                pending.append((n_valid, batch if check else None))
                out = stream.push_local(batch[lb[0][0]:lb[0][1], :,
                                              lb[2][0]:lb[2][1]])
                if out is not None:
                    emit(out)
            if not ok:
                break
        for out in stream.drain():
            emit(out)
    finally:
        cap.release()
        if writer is not None:
            writer.release()
    dt = time.monotonic() - t0
    stats.update({**_process(), "seconds": dt,
                  "fps": stats["frames"] / max(dt, 1e-9),
                  "mps": stats["frames"] * (oh or 0) * (ow or 0) / 1e6
                  / max(dt, 1e-9)})
    if not check:
        stats.pop("bitexact"), stats.pop("max_abs_diff")
    return stats


def _size(s: str) -> tuple[int, int]:
    w, h = (int(t) for t in s.lower().split("x"))
    return h, w


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=_PROG, description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--init-method", default=None,
                    help="rendezvous URL (tcp://host:port, file:///path); "
                         "default env:// (torchrun)")
    ap.add_argument("--world-size", type=int, default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--local-devices", type=int, default=1,
                    help="mesh blocks this process owns (all on its device)")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="default nccl on cuda, gloo on cpu")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds for the rendezvous and each collective")
    ap.add_argument("--data", type=int, default=None,
                    help="data-axis size (default 1: rows span every block)")
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--size", default="96x64", help="frame WxH")
    ap.add_argument("--scale", type=float, default=2.0)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--check", action="store_true",
                    help="bit-exact check vs the monolithic pipeline")
    ap.add_argument("--video-in", default=None,
                    help="stream a video file (every process decodes it)")
    ap.add_argument("--video-out", default=None,
                    help="output video (written by process 0; FFV1)")
    ap.add_argument("--codec", default="FFV1", help="fourcc for --video-out")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--train", action="store_true",
                    help="run the sharded trainer instead of inference")
    ap.add_argument("--train-steps", type=int, default=3)
    args = ap.parse_args(argv)

    from ..cli import cuda_missing

    if cuda_missing(args.device, _PROG):
        return 1
    devices = initialize(args.init_method, args.world_size, args.rank,
                         args.backend, args.local_devices, args.device,
                         args.timeout)
    try:
        mesh = frame_mesh(data=args.data, devices=devices)
        if args.train:
            r = run_train(args.train_steps, _size(args.size), mesh)
        elif args.video_in:
            r = run_video(args.video_in, args.video_out, args.scale, mesh,
                          depth=args.depth, check=args.check,
                          codec=args.codec, max_frames=args.max_frames)
        else:
            r = run_synthetic(args.frames, _size(args.size), args.scale, mesh,
                              depth=args.depth, check=args.check)
        print(json.dumps(r), flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0 if not args.check or r.get("bitexact") else 1


if __name__ == "__main__":
    sys.exit(main())
