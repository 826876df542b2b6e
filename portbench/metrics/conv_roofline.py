"""K1's share of its roofline: ``ops.cuda_srcnn`` (``srcnn_conv_kernel``).

The least time counts the network's own work, 2 FLOP a multiply-accumulate
times the MACs per output pixel of the checkpoint's shapes (8,032: 81*64 +
64*32 + 25*32), at the dense TF32 peak, and 2 bytes a pixel (the upscaled
Y read, Y' written) at the HBM rate.  The count does not change with the
implementation: a body that kept less than float32 accuracy would fail
``correct``, not read higher.
"""

from portbench.roofline import least_s, share_pct

KERNELS = ("srcnn_conv_kernel",)


def flops(out_px: int, macs_per_px: int) -> float:
    return 2.0 * macs_per_px * out_px


def nbytes(out_px: int) -> float:
    return 2.0 * out_px


def read(ctx):
    t = ctx.kernel_s(KERNELS)
    if t is None or ctx.peaks is None:
        return None
    px = ctx.frames * ctx.out_px
    return share_pct(least_s(flops(px, ctx.macs_per_px),
                             ctx.peaks["tf32_flops"], nbytes(px),
                             ctx.peaks["hbm_bytes_per_s"]), t)
