"""Profiling hooks: a trace, and the program's spans inside it.

The port of ``srcnn_cpp_tpu/utils/profiling.py`` in PyTorch's idiom:

* :func:`trace` — context manager recording a ``torch.profiler`` trace
  (CPU activity, and the card's when there is one) around any span, written
  as Chrome/Perfetto trace JSON into ``logdir``;
* :func:`span` — a named host span of the program (``srcnn.*``), recorded
  by whatever ``torch.profiler`` session is running, on the same clock as
  the card's kernels and copies; a shared no-op when none is;
* :func:`counter_records`, :func:`kernel_counters` — the stall counters
  of the two GEMM bodies (``csrc/probe.cuh``), which their launchers turn
  on with the same session: while one records they run the kernels' probed
  instances, which add to a small table on the card; after it,
  :func:`kernel_counters` reads it (:func:`counted`: one function's).

:func:`recording` is the one switch: ``span`` and the launchers ask it.
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

#: each card's counter records (:func:`counter_records`), by device
_RECORDS: dict = {}


def recording() -> bool:
    """True while a ``torch.profiler`` session records (:func:`trace`, or
    any other).  The only read of torch's private flag, so that a torch
    that renames it breaks here alone."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str):
    """A context manager that records the span ``name`` while a
    ``torch.profiler`` session records (:func:`trace`, or any other), as a
    ``user_annotation`` event nested in its caller's span; otherwise the one
    shared no-op, so that an untraced call pays for one flag check and no
    span is kept anywhere."""
    if recording():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def counter_records(device) -> int | None:
    """The address of ``device``'s counter records while a profiler
    records, else None: the last argument of the GEMM bodies' C entry
    points, which run their probed instances when it is given and add each
    launch's counts to its kind's record.  One int64 row of
    ``ops.cuda_swinir.PROBE_FIELDS`` a kind of ``PROBE_KINDS``, zeroed
    when first asked for; nothing is copied or synchronised here."""
    if not recording():
        return None
    records = _RECORDS.get(device)
    if records is None:
        from ..ops.cuda_swinir import PROBE_FIELDS, PROBE_KINDS

        records = _RECORDS[device] = torch.zeros(
            (len(PROBE_KINDS), len(PROBE_FIELDS)), dtype=torch.int64,
            device=device)
    return records.data_ptr()


def kernel_counters(reset: bool = False) -> dict:
    """The probed launches' counts since the last reset, summed over the
    cards: ``{body: {kind: {field: int}}}`` (``ops.cuda_swinir.PROBE_KINDS``
    and ``PROBE_FIELDS``), a kind only where it ran; ``{}`` where nothing
    was probed, as on the CPU.  Waits once for each card; ``reset`` zeroes
    the records after reading them."""
    if not _RECORDS:
        return {}
    from ..ops.cuda_swinir import PROBE_FIELDS, PROBE_KINDS

    out: dict = {}
    for device, records in _RECORDS.items():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        rows = records.tolist()
        if reset:
            records.zero_()
        for (body, kind), row in zip(PROBE_KINDS, rows):
            if row[0]:
                have = out.setdefault(body, {}).setdefault(
                    kind, dict.fromkeys(PROBE_FIELDS, 0))
                for field, v in zip(PROBE_FIELDS, row):
                    have[field] += v
    return out


def counted(fn) -> tuple:
    """``(fn(), counters)``: ``fn()`` run inside a CPU-only
    ``torch.profiler`` session, so that the GEMM bodies run their probed
    instances and nothing is traced on the card, and the counters that it
    added (:func:`kernel_counters`, reset before and after)."""
    from torch.profiler import ProfilerActivity, profile

    kernel_counters(reset=True)
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, kernel_counters(reset=True)


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
