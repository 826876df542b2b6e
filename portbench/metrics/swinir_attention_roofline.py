"""The share of its roofline of SwinIR's window attention: the device time
of ``swin_stl_attention_kernel`` (``ops.cuda_swinir``) alone.

The least time a low-resolution pixel and STL, from the checkpoint's
shapes: the larger of the operations, 2 FLOP a multiply-accumulate times
23,040 (``q k^T`` and ``a v``: 64 keys by 180 channels each), at the
dense TF32 peak, and the bytes, q, k and v read once and the output
written once, 4 x 180 float32 = 2,880, at the HBM rate; times the 36 STLs.
The bytes bind, by about 9x.  A later change that fuses the attention into
the linears takes this kernel off the path: the metric then reads nothing
(null), and a ``benchmark`` PR repoints it, as ``rcan_attention_roofline``
went null when RCAN's channel attention was folded into its convs.
"""

from portbench.roofline import least_s, share_pct

KERNELS = ("swin_stl_attention_kernel",)
STLS = 6 * 6
MACS = 2 * 64 * 180
BYTES = 4 * 180 * 4


def read(ctx):
    t = ctx.kernel_s(KERNELS)
    if t is None or ctx.peaks is None:
        return None
    px = ctx.frames * ctx.in_px * STLS
    return share_pct(least_s(2.0 * MACS * px, ctx.peaks["tf32_flops"],
                             float(BYTES * px),
                             ctx.peaks["hbm_bytes_per_s"]), t)
