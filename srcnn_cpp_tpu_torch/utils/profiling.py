"""Profiling hooks: a trace, a per-stage timer and an MP/s helper.

The port of ``srcnn_cpp_tpu/utils/profiling.py`` in PyTorch's idiom:

* :func:`trace` — context manager recording a ``torch.profiler`` trace
  (CPU activity, and the card's when there is one) around any span, written
  as Chrome/Perfetto trace JSON into ``logdir``;
* :class:`StageTimer` — per-stage wall-clock breakdown, each span fenced by
  a host fetch of its result (``.cpu()``), as the JAX version fetches with
  ``np.asarray``;
* :func:`throughput` — best-of sustained MP/s of a call, fenced the same
  way.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

#: no-op device activities that lead a trace on the card (:func:`trace`)
_LEAD_IN = 16


def _fetch(value) -> None:
    """Copy a tensor, or each tensor of a tuple or list, to the host: the
    fence that waits for the device work that made it.  Host arrays need
    no fence."""
    for t in value if isinstance(value, (tuple, list)) else (value,):
        if hasattr(t, "cpu"):
            t.cpu()


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Record a ``torch.profiler`` trace of the span; on exit write it to
    ``logdir/trace.json`` (open it in Perfetto or ``chrome://tracing``).
    ``logdir`` defaults to ``srcnn_trace`` in the temporary directory
    (``/tmp/srcnn_trace``, as in the JAX version, where ``TMPDIR`` is
    unset).  Yields ``logdir``."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    if logdir is None:
        logdir = str(Path(tempfile.gettempdir()) / "srcnn_trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        if torch.cuda.is_available():
            # CUPTI can drop the first device activities of a trace (the
            # first 4 in a process that had run the profiler before, on an
            # H100 with torch 2.11): lead with no-op fills, so that none
            # of the span's own activities is lost
            for _ in range(_LEAD_IN):
                torch.empty(1, device="cuda").zero_()
            torch.cuda.synchronize()
        try:
            yield logdir
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))


class StageTimer:
    """Accumulates named spans; device results are fenced by host fetch."""

    def __init__(self) -> None:
        self.spans: dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str, fetch=None):
        t0 = time.monotonic()
        try:
            yield
        finally:
            if fetch is not None:
                _fetch(fetch() if callable(fetch) else fetch)
            self.spans[name] = self.spans.get(name, 0.0) + (
                time.monotonic() - t0) * 1e3

    def report(self) -> str:
        total = sum(self.spans.values())
        lines = [f"{k:24s} {v:8.1f} ms ({v / max(total, 1e-9):5.1%})"
                 for k, v in self.spans.items()]
        lines.append(f"{'TOTAL':24s} {total:8.1f} ms")
        return "\n".join(lines)


def throughput(fn, out_px: int, iters: int = 6, repeats: int = 3) -> float:
    """Best-of sustained MP/s of ``fn()`` (fn returns a tensor or a tuple
    of tensors): one warm-up call, then ``repeats`` runs of ``iters`` calls,
    each fenced by a host fetch of its last output."""
    out = fn()
    _fetch(out)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.monotonic()
        for _ in range(iters):
            out = fn()
        _fetch(out)
        best = min(best, (time.monotonic() - t0) / iters)
    return out_px / 1e6 / best
