"""The share of a unit that the epilogue of SwinIR's GEMM body takes, from
the consumers' last products to the unit staged in shared memory (the
wait for the tile included): the program's stall counters of the window,
the epilogues' cycles over the units', over every kind of the body.  None
where there is nothing to read (``swinir_gemm_full_wait_pct``)."""

from portbench.metrics.swinir_gemm_full_wait_pct import quotient

BODY = "swinir_gemm"


def read(ctx):
    return quotient(BODY, "epilogue_cycles", "unit_cycles", 100.0)
