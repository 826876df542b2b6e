"""The share of their roofline of SwinIR's kernels outside the Swin
transformer layers: ``swinir_head_kernel`` (conv_first and the patch
LayerNorm), ``swinir_conv3x3_kernel`` (the six RSTB convs and
conv_after_body 180->180, conv_before_upsample 180->64),
``rcan_conv3x3_kernel`` (the upsampler 64->256) and ``rcan_tail_kernel``
(conv_last at the output size), their device time together.

Operations: 2 FLOP a multiply-accumulate, the network's MACs a low-
resolution pixel (4 times the checkpoint's MACs per output pixel) less
the 36 STLs' 282,240 each (:mod:`swinir_stl_roofline`): 2,304,108 at the
published shapes (the 180->180 convs' 2,041,200, the head's 4,860, the
180->64's 103,680, the upsampler's 147,456, the tail's 6,912), at the
dense TF32 peak.  Bytes, each conv's input read once and its output
written once, a low-resolution pixel: the head 3 u8 in and 180 float32
out, the seven 180->180 convs 2 x 180 float32 each, the 180->64 180 in and
64 out, the upsampler 64 in and 4 x 64 out, the tail 4 x 64 in and 4 x 3
u8 out, at the HBM rate.  The operations bind, by 2.2x.
"""

from portbench.roofline import least_s, share_pct

KERNELS = ("swinir_head_kernel", "swinir_conv3x3_kernel",
           "rcan_conv3x3_kernel", "rcan_tail_kernel")
STLS, STL_MACS = 36, 282_240
BYTES = (3 + 180 * 4) + 7 * 2 * 180 * 4 + (180 + 64) * 4 \
    + (64 + 4 * 64) * 4 + (4 * 64 * 4 + 4 * 3)


def low_macs(macs_per_px: int) -> int:
    """The MACs a low-resolution pixel outside the STLs."""
    return 4 * macs_per_px - STLS * STL_MACS


def read(ctx):
    t = ctx.kernel_s(KERNELS)
    if t is None or ctx.peaks is None:
        return None
    px = ctx.frames * ctx.in_px
    return share_pct(least_s(2.0 * low_macs(ctx.macs_per_px) * px,
                             ctx.peaks["tf32_flops"], float(BYTES * px),
                             ctx.peaks["hbm_bytes_per_s"]), t)
