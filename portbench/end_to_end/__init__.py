"""One reader per end-to-end metric, found by the metric's name.

Each ``<name>.py`` holds ``read(run) -> float | None`` over a
:class:`portbench.run.Measured`: the window of :mod:`portbench.loops`, one
output frame's pixels and the set-up seconds.  A reader that finds
nothing to read returns None and the metric is left out of the result
line.
"""
