"""K3's share of its roofline: ``ops.cuda_merge`` (``merge_vec_kernel``,
or ``merge_pixel_kernel`` for planes without 16-byte alignment).

Bytes: Y', Cr and Cb read and BGR written, 6 a pixel.  Operations: the
inverse colour conversion, 10 integer operations a pixel, at the card's
float32 rate; the bytes bound.
"""

from portbench.roofline import least_s, share_pct

KERNELS = ("merge_vec_kernel", "merge_pixel_kernel")
OPS_PER_PX = 10


def nbytes(out_px: int) -> float:
    return 6.0 * out_px


def read(ctx):
    t = ctx.kernel_s(KERNELS)
    if t is None or ctx.peaks is None:
        return None
    px = ctx.frames * ctx.out_px
    return share_pct(least_s(OPS_PER_PX * px, ctx.peaks["fp32_flops"],
                             nbytes(px), ctx.peaks["hbm_bytes_per_s"]), t)
