"""The card's idle share: the share of the window's wall time in which no
kernel ran, from the device activities of the trace (copies do not count
as busy)."""

from portbench.trace import union_s


def read(ctx):
    kernels = ctx.kernels()
    if not kernels:
        return None
    return 100.0 * (1.0 - union_s(kernels) / ctx.window_s)
