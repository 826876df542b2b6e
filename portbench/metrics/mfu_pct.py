"""The whole step's share of the card's peak: ``pipeline.upscale_planar``.

The network's FLOP (2 a MAC, the checkpoint's MACs per output pixel) of
every frame the traced window completed, over the window's seconds at the
dense TF32 peak.  It keeps bounding a gain after a kernel is fused away.
"""

from portbench.roofline import share_pct


def read(ctx):
    if ctx.peaks is None or not ctx.frames:
        return None
    flops = 2.0 * ctx.macs_per_px * ctx.out_px * ctx.frames
    return share_pct(flops / ctx.peaks["tf32_flops"], ctx.window_s)
