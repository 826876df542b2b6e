"""The cycles the producer of SwinIR's GEMM body takes to fill a stage,
from the end of its wait on ``empty`` to its arrive on ``full`` (the
activations' loads, the LayerNorm, the split and the stores): the
program's stall counters of the window, the fill cycles over the stages,
over every kind of the body.  None where there is nothing to read
(``swinir_gemm_full_wait_pct``)."""

from portbench.metrics.swinir_gemm_full_wait_pct import quotient

BODY = "swinir_gemm"


def read(ctx):
    return quotient(BODY, "fill_cycles", "stages", 1.0)
