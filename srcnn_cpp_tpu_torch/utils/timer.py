"""Millisecond wall-clock timing (the reference's tick module).

A copy of ``srcnn_cpp_tpu/utils/timer.py`` with one addition: an optional
``sync`` callable that :class:`TickTimer` calls before each clock read, so
a span around asynchronous device work (pass ``torch.cuda.synchronize``)
measures the work and not its enqueue.  The module itself imports no
framework.

The reference brackets its compute span with ``tick::getTickCount()`` —
milliseconds since static init via gettimeofday (reference src/tick.cpp:28-37,
used at src/srcnn.cpp:505,659).
"""

from __future__ import annotations

import time
from typing import Callable

_T0 = time.monotonic()


def tick_ms() -> int:
    """Milliseconds since module import (reference tick semantics)."""
    return int((time.monotonic() - _T0) * 1000.0)


class TickTimer:
    """Context manager measuring one span in milliseconds.

    >>> with TickTimer(sync=torch.cuda.synchronize) as t:
    ...     work()
    >>> t.ms
    """

    def __init__(self, sync: Callable[[], None] | None = None) -> None:
        self.ms = 0.0
        self._sync = sync

    def __enter__(self) -> "TickTimer":
        if self._sync is not None:
            self._sync()
        self._start = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        if self._sync is not None:
            self._sync()
        self.ms = (time.monotonic() - self._start) * 1000.0
