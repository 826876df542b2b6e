"""The VDSR chain's 64->64 layer kernel's share of its roofline:
``vdsr_conv3x3_kernel`` (``ops.cuda_vdsr``), conv2..conv19, nearly all of
the chain's device time.

Operations: 2 FLOP a multiply-accumulate, 9 * 64 * 64 MACs a pixel and a
layer, at the dense TF32 peak.  Bytes: a layer reads its input activation
and writes its output, 64 float32 each, 512 bytes a pixel, at the HBM
rate.  At the dense TF32 peak the two bounds are near each other (0.149
against 0.153 ns a pixel and a layer, 2.68 against 2.75 ns a pixel over
the 18 layers); the layers are those of the checkpoint's shapes: the MACs
per pixel less conv1's and conv20's 576 each, over 36,864.
"""

from portbench.roofline import least_s, share_pct

KERNELS = ("vdsr_conv3x3_kernel",)
LAYER_MACS = 9 * 64 * 64
EDGE_MACS = 9 * 64          # conv1 1->64 and conv20 64->1 each


def layers(macs_per_px: int) -> int:
    return (macs_per_px - 2 * EDGE_MACS) // LAYER_MACS


def flops(out_px: int, macs_per_px: int) -> float:
    return 2.0 * LAYER_MACS * layers(macs_per_px) * out_px


def nbytes(out_px: int, macs_per_px: int) -> float:
    return 2.0 * 64 * 4 * layers(macs_per_px) * out_px


def read(ctx):
    t = ctx.kernel_s(KERNELS)
    if t is None or ctx.peaks is None:
        return None
    px = ctx.frames * ctx.out_px
    return share_pct(least_s(flops(px, ctx.macs_per_px),
                             ctx.peaks["tf32_flops"],
                             nbytes(px, ctx.macs_per_px),
                             ctx.peaks["hbm_bytes_per_s"]), t)
