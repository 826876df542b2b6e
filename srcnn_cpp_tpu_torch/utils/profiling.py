"""Profiling hooks: a trace, and the program's spans inside it.

The port of ``srcnn_cpp_tpu/utils/profiling.py`` in PyTorch's idiom:

* :func:`trace` — context manager recording a ``torch.profiler`` trace
  (CPU activity, and the card's when there is one) around any span, written
  as Chrome/Perfetto trace JSON into ``logdir``;
* :func:`span` — a named host span of the program (``srcnn.*``), recorded
  by whatever ``torch.profiler`` session is running, on the same clock as
  the card's kernels and copies; a shared no-op when none is.
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import torch
from torch.autograd import profiler as _autograd_profiler

#: no-op device activities that lead a trace on the card (:func:`trace`)
_LEAD_IN = 16

#: what :func:`span` returns while no profiler records
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager that records the span ``name`` while a
    ``torch.profiler`` session records (:func:`trace`, or any other), as a
    ``user_annotation`` event nested in its caller's span; otherwise the one
    shared no-op, so that an untraced call pays for one flag check and no
    span is kept anywhere."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Record a ``torch.profiler`` trace of the span; on exit write it to
    ``logdir/trace.json`` (open it in Perfetto or ``chrome://tracing``).
    ``logdir`` defaults to ``srcnn_trace`` in the temporary directory
    (``/tmp/srcnn_trace``, as in the JAX version, where ``TMPDIR`` is
    unset).  Yields ``logdir``."""
    import tempfile

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
