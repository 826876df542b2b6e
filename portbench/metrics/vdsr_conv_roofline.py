"""The VDSR chain's share of its roofline: ``ops.cuda_vdsr`` (conv1
``vdsr_first_kernel``, conv2..conv19 ``vdsr_conv3x3_kernel``, conv20
``vdsr_last_kernel``), their device time together.

The least time counts the network's own work, as :mod:`conv_roofline`
does for SRCNN: 2 FLOP a multiply-accumulate times the MACs per output
pixel of the checkpoint's shapes (664,704 at the published widths: 576 +
18 * 36,864 + 576), at the dense TF32 peak, and 2 bytes a pixel (the
upscaled Y read, Y' written) at the HBM rate.  The count does not change
with the implementation: the chain's activations in device memory and
3xTF32's three products a MAC are its own cost.
"""

from portbench.roofline import least_s, share_pct

KERNELS = ("vdsr_first_kernel", "vdsr_conv3x3_kernel", "vdsr_last_kernel")


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
