"""RCAN's channel attention's share of its roofline: the device time of
``rcan_ca_finish_kernel`` (the pool's partial sums to ``s``) and
``rcan_ca_apply_kernel`` (``x + s * t``) of ``ops.cuda_rcan``.

Bytes, the least the attention moves once the pool's sums come out of the
conv that writes ``t``: ``t`` and ``x`` read and ``x`` written, 3 x 256 a
low-resolution pixel and RCAB, 200 RCABs at the published shapes, at the
HBM rate; its operations (a multiply and an add a value) are far below
the card's float32 rate.  A later change that fuses the apply into the
next conv's loader takes these kernels off the path, and the metric then
reads nothing (null), as it should.
"""

from portbench.roofline import share_pct

KERNELS = ("rcan_ca_finish_kernel", "rcan_ca_apply_kernel")
RCABS = 10 * 20             # the published groups x RCABs a group
BYTES_PER_PX = 3 * 64 * 4   # t in, x in, x out


def nbytes(in_px: int) -> float:
    return float(BYTES_PER_PX * RCABS * in_px)


def read(ctx):
    t = ctx.kernel_s(KERNELS)
    if t is None or ctx.peaks is None:
        return None
    return share_pct(nbytes(ctx.frames * ctx.in_px)
                     / ctx.peaks["hbm_bytes_per_s"], t)
