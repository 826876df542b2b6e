"""The device trace of a window, and what the per-layer readers read.

:func:`recording` is a copy of ``srcnn_cpp_tpu_torch.utils.profiling.trace``:
a ``torch.profiler`` trace of CPU and CUDA activity that leads with 16
no-op fills on the card, because CUPTI can drop the first device
activities of a trace.  The trace is written as Chrome trace JSON into a
temporary directory, read back and deleted.

:class:`Ctx` holds the device activities that started inside the window
(the benchmark's own ``portbench.window`` span), the window's length and
the frames it completed, for the readers in ``metrics/``.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import tempfile
from pathlib import Path

LEAD_IN = 16
WINDOW = "portbench.window"
KERNEL, COPY, SET = "kernel", "gpu_memcpy", "gpu_memset"
NAME_CHARS = 96     # a device op's name in the breakdown, cut to this


@contextlib.contextmanager
def recording(out: dict):
    """Profile the span; on exit ``out["events"]`` holds the trace's
    events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(LEAD_IN):
                torch.empty(1, device="cuda").zero_()
            torch.cuda.synchronize()
            try:
                yield
            finally:
                torch.cuda.synchronize()
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            out["events"] = json.load(f)["traceEvents"]


def union_s(intervals) -> float:
    """Seconds covered by ``(start_us, dur_us)`` intervals."""
    total, end = 0.0, float("-inf")
    for s, d in sorted(intervals):
        e = s + d
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e6


@dataclasses.dataclass
class Ctx:
    """What a per-layer reader reads."""

    window: tuple             # (ts_us, dur_us) of the window span
    device_ops: list          # (cat, name, ts_us, dur_us), started inside
    host_ops: list            # (name, ts_us, dur_us) on the window's thread
    frames: int               # frames completed in the window
    in_hw: tuple              # (H, W) of an input frame
    out_hw: tuple             # (oh, ow) of an output frame
    macs_per_px: int          # the network's MACs per output pixel
    peaks: dict | None        # the card's row of peaks.json, or None

    @property
    def window_s(self) -> float:
        return self.window[1] / 1e6

    @property
    def in_px(self) -> int:
        return self.in_hw[0] * self.in_hw[1]

    @property
    def out_px(self) -> int:
        return self.out_hw[0] * self.out_hw[1]

    def kernels(self, patterns=None) -> list:
        return [(s, d) for c, n, s, d in self.device_ops if c == KERNEL
                and (patterns is None or any(p in n for p in patterns))]

    def kernel_s(self, patterns) -> float | None:
        """Device seconds of the kernels whose names hold one of
        ``patterns``; None when the window ran none."""
        found = self.kernels(patterns)
        return sum(d for _, d in found) / 1e6 if found else None

    def copies(self, directions=("HtoD", "DtoH")) -> list:
        return [(s, d) for c, n, s, d in self.device_ops if c == COPY
                and any(k in n for k in directions)]

    def busy_s(self) -> float:
        """Seconds in which any device operation ran (kernels, copies,
        fills)."""
        return union_s((s, d) for _, _, s, d in self.device_ops)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps summed by what the host was doing (the innermost host op or
        span covering each gap's middle)."""
        by_op: dict = {}
        for _, n, _, d in self.device_ops:
            n = n.removeprefix("void ")[:NAME_CHARS]
            by_op[n] = by_op.get(n, 0.0) + d / 1e6
        gaps, end = [], self.window[0]
        for s, d in sorted((s, d) for _, _, s, d in self.device_ops):
            if s > end:
                gaps.append((end, s))
            end = max(end, s + d)
        if self.window[0] + self.window[1] > end:
            gaps.append((end, self.window[0] + self.window[1]))
        by_host: dict = {}
        for (a, b), what in zip(gaps, self._host_at([(a + b) / 2
                                                     for a, b in gaps])):
            by_host[what] = by_host.get(what, 0.0) + (b - a) / 1e6
        order = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in order],
                "idle_gaps": [[k, v] for k, v in idle]}

    def _host_at(self, points: list) -> list:
        """For each time, the innermost host op covering it (a sweep over
        the properly nested ops of one thread)."""
        ops = sorted(self.host_ops, key=lambda o: (o[1], -o[2]))
        starts = [o[1] for o in ops]
        names = []
        for t in points:
            # the innermost op covering t is the last-starting one that
            # has not ended; scan back from the last start before t
            i = bisect.bisect_right(starts, t) - 1
            found, limit = "between host ops", 256
            while i >= 0 and limit:
                name, s, d = ops[i]
                if s + d >= t:
                    found = name
                    break
                i -= 1
                limit -= 1
            names.append(found)
        return names


def context(events: list, frames: int, in_hw: tuple, out_hw: tuple,
            macs_per_px: int, peaks: dict | None) -> Ctx | None:
    """The :class:`Ctx` of a trace's window; None when the trace has no
    window span."""
    spans = [e for e in events if e.get("name") == WINDOW
             and e.get("cat") == "user_annotation"]
    if not spans:
        return None
    w = spans[0]
    t0, t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    device = [(e["cat"], e["name"], float(e["ts"]), float(e["dur"]))
              for e in events if e.get("cat") in (KERNEL, COPY, SET)
              and t0 <= float(e["ts"]) <= t1]
    host = [(e["name"], float(e["ts"]), float(e["dur"])) for e in events
            if e.get("ph") == "X" and e.get("tid") == w.get("tid")
            and e.get("pid") == w.get("pid")
            and e.get("cat") in ("cpu_op", "user_annotation", "cuda_runtime",
                                 "cuda_driver")
            and e is not w and t0 <= float(e["ts"]) <= t1]
    return Ctx((t0, t1 - t0), device, host, frames, tuple(in_hw),
               tuple(out_hw), macs_per_px, peaks)
