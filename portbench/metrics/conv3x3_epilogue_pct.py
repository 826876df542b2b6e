"""The share of a unit that the epilogue of the 64->64 conv body takes,
from the consumers' last products to the end of the unit's store (and of
its pool sums): the program's stall counters of the window, the
epilogues' cycles over the units', over every kind of the body.  None
where there is nothing to read (``swinir_gemm_full_wait_pct``)."""

from portbench.metrics.swinir_gemm_full_wait_pct import quotient

BODY = "conv3x3"


def read(ctx):
    return quotient(BODY, "epilogue_cycles", "unit_cycles", 100.0)
