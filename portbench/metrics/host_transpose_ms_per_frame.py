"""The entry layer's host transpose: host milliseconds of the program's
``srcnn.entry.host_transpose`` spans (``pipeline.upscale_bgr_batch``'s
``np.moveaxis`` and ``np.ascontiguousarray`` of a host-array input) that
start in the window, per frame completed.  The card sees nothing of it: it
shows in the trace as the program's span alone."""

SPAN = "srcnn.entry.host_transpose"


def read(ctx):
    found = [d for n, _, d in ctx.host_ops if n == SPAN]
    if not found or not ctx.frames:
        return None
    return sum(found) / 1e3 / ctx.frames
