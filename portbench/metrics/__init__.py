"""One reader per per-layer metric, found by the metric's name.

Each ``<name>.py`` holds ``read(ctx) -> float | None`` over a
:class:`portbench.trace.Ctx`, with its kernel-name patterns and its
operations and bytes functions.  A reader that finds nothing to read
returns None and the metric is left out of the result line.
"""
