"""RCAN's share of its roofline: ``ops.cuda_rcan`` (``rcan_head_kernel``,
``rcan_conv3x3_kernel``, ``rcan_ca_finish_kernel``, ``rcan_ca_apply_kernel``,
``rcan_tail_kernel``), every kernel of the network, their device time
together.

The least time counts the network's own work, as :mod:`conv_roofline`
does for SRCNN: 2 FLOP a multiply-accumulate times the MACs per output
pixel of the checkpoint's shapes (3,826,800 at the published shapes; the
reference's ``macs_per_pixel``), at the dense TF32 peak, and the frame's
bytes once, 3 an input pixel read and 3 an output pixel written, at the
HBM rate.  The count does not change with the implementation: the feature
maps in device memory, channel attention's passes over them and 3xTF32's
three products a MAC are its own cost.
"""

from portbench.roofline import least_s, share_pct

KERNELS = ("rcan_head_kernel", "rcan_conv3x3_kernel", "rcan_ca_finish_kernel",
           "rcan_ca_apply_kernel", "rcan_tail_kernel")


def flops(out_px: int, macs_per_px: int) -> float:
    return 2.0 * macs_per_px * out_px


def nbytes(in_px: int, out_px: int) -> float:
    return 3.0 * in_px + 3.0 * out_px


def read(ctx):
    t = ctx.kernel_s(KERNELS)
    if t is None or ctx.peaks is None:
        return None
    n = ctx.frames
    return share_pct(least_s(flops(n * ctx.out_px, ctx.macs_per_px),
                             ctx.peaks["tf32_flops"],
                             nbytes(n * ctx.in_px, n * ctx.out_px),
                             ctx.peaks["hbm_bytes_per_s"]), t)
