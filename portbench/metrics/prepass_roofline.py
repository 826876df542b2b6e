"""K2's share of its roofline: ``ops.cuda_resize`` (``pre_pass_kernel``).

Bytes: 3 a pixel of BGR read, 3 a pixel of upscaled YCrCb written.
Operations, stated beside them: the colour conversion, 11 integer
operations an input pixel, and the bicubic resize of three channels, 4
multiply-adds a tap row for the horizontal pass (over the input rows) and
4 for the vertical one, at the card's float32 rate.  At x2 the bytes bound.
"""

from portbench.roofline import least_s, share_pct

KERNELS = ("pre_pass_kernel",)
COLOR_OPS = 11


def ops(in_px: int, out_px: int, in_rows_share: float) -> float:
    """``in_rows_share``: input rows over output rows, which sets how many
    rows the horizontal pass filters."""
    return COLOR_OPS * in_px + 3 * 2 * 4 * out_px * (1 + in_rows_share)


def nbytes(in_px: int, out_px: int) -> float:
    return 3.0 * in_px + 3.0 * out_px


def read(ctx):
    t = ctx.kernel_s(KERNELS)
    if t is None or ctx.peaks is None:
        return None
    n = ctx.frames
    rows = ctx.in_hw[0] / ctx.out_hw[0]
    return share_pct(least_s(ops(n * ctx.in_px, n * ctx.out_px, rows),
                             ctx.peaks["fp32_flops"],
                             nbytes(n * ctx.in_px, n * ctx.out_px),
                             ctx.peaks["hbm_bytes_per_s"]), t)
