"""The closed loops that drive a runner, and what a window records.

Two protocols, named by a configuration's ``protocol``:

* ``call``: ``runner(unit)`` on a batch ``[n, H, W, 3]``, which returns
  ``[n, oh, ow, 3]``, or on one frame ``[H, W, 3]``, which returns
  ``[oh, ow, 3]``.  A result on the card is in the caller's hands when the
  event recorded after the call has completed; at most ``inflight`` calls
  are in flight, and before the next call the loop waits on the oldest.
  A host array is in hand when the call returns.
* ``push``: ``runner.push(frame)`` as fast as it returns (the loop of
  ``srcnn_cpp_tpu_torch.stream.run_synthetic``, seeded), taking each frame
  it hands back; then ``runner.drain()``.

Units (calls, or pushed frames) are issued until the window's seconds have
passed, and the window closes when every issued unit is in hand, so that
each frame the window issued is counted, and none from before it.  One
frame of each of a few results, drawn from ``seed``, is kept for the
comparison with the reference (:class:`Reservoir`).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import random
import time

import numpy as np
import torch


@dataclasses.dataclass
class Window:
    start: float = 0.0
    end: float = 0.0
    issued: int = 0             # frames
    done: int = 0               # frames whose result was in hand, whole
    latency_s: list = dataclasses.field(default_factory=list)  # per frame

    @property
    def seconds(self) -> float:
        return self.end - self.start


class Reservoir:
    """One frame of each of ``k`` results drawn uniformly, by reservoir
    sampling, out of a stream of unknown length, the frame drawn uniformly
    within its result, all from ``seed``.  ``items`` holds ``(unit, frame
    in the unit, frame)``; a frame kept out of a batch is copied, so that
    the rest of the batch is freed."""

    def __init__(self, k: int, seed: int):
        self.k, self.n, self.items = k, 0, []
        self.rng = random.Random(seed)

    def offer(self, unit: int, frames) -> None:
        """``frames``: the ``[n, oh, ow, 3]`` result of input unit
        ``unit``."""
        self.n += 1
        if len(self.items) < self.k:
            slot = len(self.items)
            self.items.append(None)
        else:
            slot = self.rng.randrange(self.n)
            if slot >= self.k:
                return
        j = self.rng.randrange(len(frames))
        frame = frames[j]
        if len(frames) > 1:
            frame = frame.clone() if isinstance(frame, torch.Tensor) \
                else frame.copy()
        self.items[slot] = (unit, j, frame)


def _span(on: bool):
    if on:
        return torch.profiler.record_function
    return lambda name: contextlib.nullcontext()


def _frames_of(out, batched: bool, per_unit: int, out_shape: tuple):
    """``(frames [per_unit, oh, ow, 3] or None, malformed count)``."""
    frames = out if batched else out[None]
    if tuple(frames.shape) != (per_unit, *out_shape):
        return None, per_unit
    return frames, 0


def call_loop(runner, units: list, out_shape: tuple, *, seconds=None,
              count=None, inflight: int = 1, keep: Reservoir | None = None,
              spans: bool = False) -> Window:
    """Drive ``runner`` over ``units`` (cycled) for ``seconds``, or for
    ``count`` calls; ``out_shape`` is one output frame's ``(oh, ow, 3)``.
    A unit of four dimensions is a batch, of three a frame."""
    span = _span(spans)
    batched = units[0].ndim == 4
    per_unit = len(units[0]) if batched else 1
    win, q = Window(), collections.deque()

    def complete() -> None:
        t_issue, k, ev, out = q.popleft()
        if ev is not None:
            with span("portbench.wait"):
                ev.synchronize()
        t = time.perf_counter()
        frames, bad = _frames_of(out, batched, per_unit, out_shape)
        win.done += per_unit - bad
        win.latency_s.extend([t - t_issue] * (per_unit - bad))
        if keep is not None and frames is not None:
            keep.offer(k, frames)

    win.start = time.perf_counter()
    deadline = win.start + (seconds or 0.0)
    i = 0
    while (i < count) if count is not None else \
            (time.perf_counter() < deadline):
        k = i % len(units)
        t_issue = time.perf_counter()
        with span("portbench.call"):
            out = runner(units[k])
        ev = None
        if isinstance(out, torch.Tensor) and out.is_cuda:
            ev = torch.cuda.Event()
            ev.record()
        q.append((t_issue, k, ev, out))
        win.issued += per_unit
        i += 1
        while len(q) >= max(1, inflight):
            complete()
    while q:
        complete()
    win.end = time.perf_counter()
    return win


def push_loop(runner, units: list, out_shape: tuple, *, seconds=None,
              count=None, keep: Reservoir | None = None,
              spans: bool = False) -> Window:
    """Push ``units`` (single frames, cycled) into ``runner`` for
    ``seconds``, or ``count`` frames, then drain it."""
    span = _span(spans)
    win, pushed = Window(), collections.deque()   # (t_push, unit) in order

    def got(out) -> None:
        t = time.perf_counter()
        t_push, k = pushed.popleft()
        frames, bad = _frames_of(np.asarray(out), False, 1, out_shape)
        win.done += 1 - bad
        if not bad:
            win.latency_s.append(t - t_push)
            if keep is not None:
                keep.offer(k, frames)

    win.start = time.perf_counter()
    deadline = win.start + (seconds or 0.0)
    i = 0
    while (i < count) if count is not None else \
            (time.perf_counter() < deadline):
        k = i % len(units)
        pushed.append((time.perf_counter(), k))
        with span("portbench.push"):
            out = runner.push(units[k])
        win.issued += 1
        i += 1
        if out is not None:
            got(out)
    with span("portbench.drain"):
        for out in runner.drain():
            got(out)
    win.end = time.perf_counter()
    return win


LOOPS = {"call": call_loop, "push": push_loop}
