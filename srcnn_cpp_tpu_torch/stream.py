"""Streaming/video super-resolution with host/device overlap.

The port of ``srcnn_cpp_tpu/stream.py``: a pipelined upscaler that keeps
several micro-batches in flight on the card, so host-side decode and encode
overlap device compute, plus a CLI:

    python -m srcnn_cpp_tpu_torch.stream --scale=2 in.mp4 out.avi
    python -m srcnn_cpp_tpu_torch.stream --synthetic=32 --device-resident --batch=8 --size=1920x1080

``push`` takes a host array or a ``torch.Tensor`` on any device, as the JAX
stream takes a host or device array; results are host arrays either way.
On a CUDA device, a micro-batch of host frames is staged in a pinned host
buffer and copied in; one that holds a tensor is stacked on the card
instead (a frame already there is not copied).  Then the pipeline
(:func:`.pipeline.upscale_planar`: K2 -> the weights' network -> K3, with
the HWC <-> planar transposes on the card) and the device-to-host copy into
a pinned output buffer are enqueued on the current CUDA stream, an event is
recorded and ``push`` returns; a result is read only once the pipeline depth is
reached, after its event has completed.  On the CPU each micro-batch runs
the plain pipeline at once.  ``--device=cuda`` (the default) without a GPU
is an error.
"""

from __future__ import annotations

import argparse
import collections
import sys
import time

import numpy as np
import torch

from .cli import DEVICES, cuda_missing, device_name
from .ops.resize import scaled_size
from .pipeline import u8_tensor, upscale_bgr_batch, upscale_planar, weights_on
from .utils.profiling import span
from .weights import SRCNNWeights

_PROG = "srcnn-torch-stream"


class StreamUpscaler:
    """Pipelined frame upscaler with at most ``depth`` micro-batches in flight.

    ``batch`` > 1 groups consecutive frames into one dispatch, amortizing
    the per-dispatch launches and copies.  Outputs are bit-identical to
    batch=1 (every kernel works frame by frame) and frame order is
    preserved; latency grows by up to ``batch-1`` frames.

    On CUDA, the pinned staging buffers form a ring of ``depth + 1`` input /
    output pairs: a dispatch takes the next pair, and at that moment at most
    ``depth`` earlier dispatches are in flight, so the pair it takes belongs
    to one whose event has completed and whose output has been copied out.
    No buffer is written by the host while a copy from or into it may run.

    Under a ``torch.profiler`` session a dispatch records the spans
    ``srcnn.stream.stage_in`` and ``srcnn.stream.dispatch``, and a
    completion ``srcnn.stream.wait`` and ``srcnn.stream.copy_out``.
    """

    def __init__(self, scale: float, weights: SRCNNWeights | None = None,
                 depth: int = 3, batch: int = 1, device="cuda"):
        self.scale = float(scale)
        self.depth = max(0, int(depth))
        self.batch = max(1, int(batch))
        self.device = torch.device(device)
        self.weights = weights_on(weights, self.device)
        self._pending: list = []   # host arrays or tensors
        self._inflight: collections.deque = collections.deque()
        self._ready: collections.deque = collections.deque()
        self._ring: list[tuple[torch.Tensor, torch.Tensor]] = []
        self._shape = None   # (h, w) of the frames the ring was sized for
        self._next = 0       # ring slot of the next dispatch

    def _slot(self, h: int, w: int):
        """The next pinned (input, output) pair, sized for ``h x w`` frames."""
        if self._shape != (h, w):
            while self._inflight:       # the old ring is in use until drained
                self._complete_oldest()
            ow, oh = scaled_size(w, h, self.scale)
            self._ring = [
                (torch.empty((self.batch, h, w, 3), dtype=torch.uint8,
                             pin_memory=True),
                 torch.empty((self.batch, oh, ow, 3), dtype=torch.uint8,
                             pin_memory=True))
                for _ in range(self.depth + 1)]
            self._shape, self._next = (h, w), 0
        pair = self._ring[self._next]
        self._next = (self._next + 1) % len(self._ring)
        return pair

    def _stack(self, frames: list) -> torch.Tensor:
        """A micro-batch of host arrays and tensors, stacked on
        ``self.device``."""
        return torch.stack([torch.as_tensor(f).to(self.device)
                            for f in frames])

    def _dispatch(self) -> None:
        frames, self._pending = self._pending, []
        n = len(frames)
        if self.device.type != "cuda":
            with span("srcnn.stream.stage_in"):
                x = self._stack(frames)
            with span("srcnn.stream.dispatch"):
                self._inflight.append((None, upscale_bgr_batch(
                    x, self.scale, self.weights, self.device).numpy()))
            return
        tensors = any(isinstance(f, torch.Tensor) for f in frames)
        h, w = frames[0].shape[:2]
        pin_in, pin_out = self._slot(h, w)
        ow, oh = scaled_size(w, h, self.scale)
        with torch.cuda.device(self.device):
            with span("srcnn.stream.stage_in"):
                if tensors:
                    x = self._stack(frames)
                else:
                    np.stack(frames, out=pin_in.numpy()[:n])
            with span("srcnn.stream.dispatch"):
                if not tensors:
                    x = pin_in[:n].to(self.device, non_blocking=True)
                out = upscale_planar(x.permute(0, 3, 1, 2).contiguous(),
                                     self.weights, (oh, ow))
                pin_out[:n].copy_(out.permute(0, 2, 3, 1).contiguous(),
                                  non_blocking=True)
                done = torch.cuda.Event()
                done.record()
        self._inflight.append((done, pin_out[:n]))

    def _complete_oldest(self) -> None:
        done, out = self._inflight.popleft()
        if done is not None:
            with span("srcnn.stream.wait"):
                done.synchronize()
            with span("srcnn.stream.copy_out"):
                out = out.numpy().copy()    # the pinned buffer will be reused
        self._ready.extend(out)

    def push(self, frame_bgr) -> np.ndarray | None:
        """Enqueue one BGR uint8 frame ``[H, W, 3]``, a host array or a
        ``torch.Tensor`` on any device with any strides; returns a completed
        frame (a C-contiguous host array) or None."""
        self._pending.append(u8_tensor(frame_bgr)
                             if isinstance(frame_bgr, torch.Tensor)
                             else np.asarray(frame_bgr, dtype=np.uint8))
        if len(self._pending) == self.batch:
            self._dispatch()
        if len(self._inflight) > self.depth:
            self._complete_oldest()
        return self._ready.popleft() if self._ready else None

    def drain(self):
        """Yield all remaining frames in order."""
        if self._pending:
            self._dispatch()
        while self._inflight:
            self._complete_oldest()
        while self._ready:
            yield self._ready.popleft()


def run_synthetic(n: int, size: tuple[int, int], scale: float,
                  batch: int = 1, device="cuda") -> dict:
    """Stream throughput over synthetic host frames (host copies, transposes
    and device compute all in the loop); returns frames, seconds, fps and
    MP/s of output, and the device it ran on."""
    h, w = size
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    up = StreamUpscaler(scale, batch=batch, device=device)
    for _ in range(up.batch):   # warm-up: kernel build, allocations
        up.push(frame)
    for _ in up.drain():
        pass
    # whole batches only, but never round the run down to zero frames
    n = max(n - n % up.batch, up.batch)
    t0 = time.monotonic()
    done = 0
    for _ in range(n):
        if up.push(frame) is not None:
            done += 1
    for _ in up.drain():
        done += 1
    dt = time.monotonic() - t0
    ow, oh = scaled_size(w, h, scale)   # float32-floor rule (srcnn.cpp:573-575)
    mp = done * oh * ow / 1e6
    return {"frames": done, "seconds": dt, "fps": done / dt, "mps": mp / dt,
            "device": device_name(device)}


def run_synthetic_device(n: int, size: tuple[int, int], scale: float,
                         batch: int = 8, depth: int = 3,
                         device="cuda") -> dict:
    """Device-resident sustained rate of the stream's scheduling, on a card.

    The frame batch is staged on the card once; each dispatch runs the
    pipeline on it, chained on a data dependency (a zero from the previous
    output's first pixel added into the input), with ``depth`` dispatches
    in flight and the oldest fenced once the pipeline is full.  The span
    from the first dispatch to the last completion is timed with CUDA
    events.  Returns frames, seconds, fps and MP/s of output, and the card.
    """
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"run_synthetic_device times a CUDA device, got "
                         f"{device}")
    h, w = size
    ow, oh = scaled_size(w, h, scale)
    rng = np.random.default_rng(0)
    weights = weights_on(None, device)
    xb = torch.from_numpy(rng.integers(0, 256, (batch, 3, h, w),
                                       dtype=np.uint8)).to(device)
    dep = torch.zeros((), dtype=torch.uint8, device=device)

    def dispatch(dep):
        xb[0, 0, 0, 0] += dep
        return upscale_planar(xb, weights, (oh, ow))[0, 0, 0, 0] * 0

    with torch.cuda.device(device):
        dispatch(dep)                                # warm-up
        torch.cuda.synchronize(device)
        inflight: collections.deque = collections.deque()
        nb = -(-n // batch)     # whole batches, at least n frames measured
        start, end = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(nb):
            dep = dispatch(dep)
            ev = torch.cuda.Event()
            ev.record()
            inflight.append(ev)
            if len(inflight) > depth:
                inflight.popleft().synchronize()     # fence the oldest
        end.record()
        end.synchronize()
    dt = start.elapsed_time(end) / 1e3
    done = nb * batch
    mp = done * oh * ow / 1e6
    return {"frames": done, "seconds": dt, "fps": done / dt, "mps": mp / dt,
            "device": device_name(device)}


def run_video(src: str, dst: str, scale: float, verbose: bool = True,
              batch: int = 1, codec: str = "FFV1", device="cuda") -> int:
    """Upscale a video file through the pipelined stream.

    ``codec`` is the output fourcc.  The default is LOSSLESS (FFV1): the
    compute path is bit-exact end to end, so the default writer should not
    be the place fidelity silently ends — pass e.g. ``mp4v``/``avc1``
    explicitly when a lossy delivery format is wanted.
    """
    try:
        import cv2
    except ImportError:
        print(f"{_PROG}: cv2 unavailable for video I/O", file=sys.stderr)
        return 2
    cap = cv2.VideoCapture(src)
    if not cap.isOpened():
        print(f"{_PROG}: cannot open {src!r}", file=sys.stderr)
        return 1
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    up = StreamUpscaler(scale, batch=batch, device=device)
    writer = None
    n = 0

    def emit(out):
        nonlocal writer, n
        if writer is None:
            oh, ow = out.shape[:2]
            writer = cv2.VideoWriter(
                dst, cv2.VideoWriter_fourcc(*codec), fps, (ow, oh))
            if not writer.isOpened():
                raise RuntimeError(f"cannot open video writer for {dst!r} "
                                   f"(codec {codec!r} unavailable?)")
        writer.write(out)
        n += 1

    t0 = time.monotonic()
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            out = up.push(frame)
            if out is not None:
                emit(out)
        for out in up.drain():
            emit(out)
    finally:
        cap.release()
        if writer is not None:
            writer.release()
    dt = time.monotonic() - t0
    if verbose:
        print(f"stream: {n} frames in {dt:.1f}s ({n / max(dt, 1e-9):.1f} fps)"
              f" on {device_name(device)} -> {dst}")
    return 0 if n else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=_PROG, description=__doc__)
    ap.add_argument("src", nargs="?")
    ap.add_argument("dst", nargs="?")
    ap.add_argument("--scale", type=float, default=2.0)
    ap.add_argument("--device", default="cuda", choices=DEVICES,
                    help="where the pipeline runs (default cuda: the CUDA "
                         "kernels; cpu: their plain PyTorch versions)")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="benchmark N synthetic frames instead of a file")
    ap.add_argument("--device-resident", action="store_true",
                    help="with --synthetic: measure the card's sustained "
                         "rate (frames staged on the card, fenced "
                         "completion) instead of timing host I/O too")
    ap.add_argument("--size", default="1920x1080",
                    help="synthetic frame WxH")
    ap.add_argument("--batch", type=int, default=1,
                    help="micro-batch size per dispatch (bit-identical; "
                         "higher throughput, +batch-1 frames latency)")
    ap.add_argument("--codec", default="FFV1",
                    help="output fourcc (default FFV1, lossless — pass "
                         "mp4v/avc1 etc. for lossy delivery formats)")
    args = ap.parse_args(argv)

    if cuda_missing(args.device, _PROG):
        return 1
    if args.synthetic:
        w, h = (int(t) for t in args.size.lower().split("x"))
        if args.device_resident:
            if args.device != "cuda":
                print(f"{_PROG}: --device-resident measures a CUDA device",
                      file=sys.stderr)
                return 1
            r = run_synthetic_device(args.synthetic, (h, w), args.scale,
                                     batch=max(1, args.batch))
        else:
            r = run_synthetic(args.synthetic, (h, w), args.scale,
                              batch=args.batch, device=args.device)
        print(f"synthetic {r['frames']} frames {args.size} x{args.scale:g}: "
              f"{r['fps']:.1f} fps  ({r['mps']:.0f} MP/s output) "
              f"on {r['device']}")
        return 0
    if not args.src or not args.dst:
        ap.print_help()
        return 1
    return run_video(args.src, args.dst, args.scale, batch=args.batch,
                     codec=args.codec, device=args.device)


if __name__ == "__main__":
    sys.exit(main())
