"""The share of a unit in which the consumers of the 64->64 conv body
(``vdsr_conv3x3_kernel``, ``rcan_conv3x3_kernel``) wait on ``full`` for a
stage: the program's stall counters of the window, the cycles inside the
waits over the units', over every kind of the body.  None where there is
nothing to read (``swinir_gemm_full_wait_pct``)."""

from portbench.metrics.swinir_gemm_full_wait_pct import quotient

BODY = "conv3x3"


def read(ctx):
    return quotient(BODY, "full_wait_cycles", "unit_cycles", 100.0)
