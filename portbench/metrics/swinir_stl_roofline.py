"""The share of their roofline of SwinIR's Swin transformer layers: the
device time of every kernel named ``swin_stl_*`` (``ops.cuda_swinir``:
the linears with their LayerNorm loaders and epilogues, the window
attention), together.

The least time of an STL a low-resolution pixel, counted from the
checkpoint's shapes (180 channels, 6 heads of 30, 8 x 8 windows, an MLP of
360), not from the implementation: the larger of its operations, 2 FLOP a
multiply-accumulate times 282,240 (the linears' 259,200: qkv 97,200, proj
32,400, fc1 and fc2 64,800 each; the attention's 23,040: ``q k^T`` and
``a v``, 64 keys by 180 channels each), at the dense TF32 peak, and its
bytes, the token map read once and written once, 2 x 180 float32 = 1,440,
at the HBM rate; times the 36 STLs.  No fusion of the layer can beat this
count.  The operations bind, by 2.7x.
"""

from portbench.roofline import least_s, share_pct

KERNELS = ("swin_stl_",)
STLS = 6 * 6                # the published RSTBs x STLs an RSTB
STL_MACS = 97_200 + 32_400 + 2 * 64_800 + 2 * 64 * 180
STL_BYTES = 2 * 180 * 4


def read(ctx):
    t = ctx.kernel_s(KERNELS)
    if t is None or ctx.peaks is None:
        return None
    px = ctx.frames * ctx.in_px * STLS
    return share_pct(least_s(2.0 * STL_MACS * px, ctx.peaks["tf32_flops"],
                             float(STL_BYTES * px),
                             ctx.peaks["hbm_bytes_per_s"]), t)
