"""The share of its roofline of RCAN's 64-input 3x3 convs:
``rcan_conv3x3_kernel`` (``ops.cuda_rcan``; the body of VDSR's
``vdsr_conv3x3_kernel`` with RCAN's epilogues), the 411 64->64 layers at
the input size and the upsampler's 64->256 as four 64->64 launches.

Operations: 2 FLOP a multiply-accumulate, 36,864 a layer and 147,456 the
upsampler's a low-resolution pixel, at the dense TF32 peak.  Bytes, the
least each layer moves: its input map read and its output written, 64
float32 each, 512 a low-resolution pixel and layer, and the upsampler's
256 in and 1,024 out, at the HBM rate.  The layers are those of the
checkpoint's shapes: the MACs per output pixel less the head's (1,728 a
low-resolution pixel, a quarter an output pixel) and the tail's 1,728,
over 4 output pixels a low-resolution one, less the upsampler's, over
36,864.  At the published shapes the bytes bind, by 2 %.
"""

from portbench.roofline import least_s, share_pct

KERNELS = ("rcan_conv3x3_kernel",)
LAYER_MACS = 9 * 64 * 64
UPSAMPLER_MACS = 4 * LAYER_MACS
EDGE_MACS = 9 * 3 * 64      # the head 3->64 and the tail 64->3 each


def low_macs(macs_per_px: int) -> int:
    """The 64-input convs' MACs a low-resolution pixel."""
    return 4 * (macs_per_px - EDGE_MACS) - EDGE_MACS


def layers(macs_per_px: int) -> int:
    """The 64->64 layers at the input size (411 at the published shapes)."""
    return (low_macs(macs_per_px) - UPSAMPLER_MACS) // LAYER_MACS


def flops(in_px: int, macs_per_px: int) -> float:
    return 2.0 * low_macs(macs_per_px) * in_px


def nbytes(in_px: int, macs_per_px: int) -> float:
    return (2.0 * 64 * 4 * layers(macs_per_px) + 64 * 4 + 4 * 64 * 4) \
        * in_px


def read(ctx):
    t = ctx.kernel_s(KERNELS)
    if t is None or ctx.peaks is None:
        return None
    px = ctx.frames * ctx.in_px
    return share_pct(least_s(flops(px, ctx.macs_per_px),
                             ctx.peaks["tf32_flops"],
                             nbytes(px, ctx.macs_per_px),
                             ctx.peaks["hbm_bytes_per_s"]), t)
