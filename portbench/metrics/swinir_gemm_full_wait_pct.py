"""The share of a unit in which the consumers of SwinIR's GEMM body
(``swin_stl_linear_kernel``, ``swinir_conv3x3_kernel``) wait on ``full``
for a stage: the program's stall counters of the window
(``srcnn_cpp_tpu_torch.utils.profiling.kernel_counters``, which the
probed instances keep while the trace records), the cycles inside the
waits over the cycles of the units, over every kind of the body.

None where the body recorded nothing, or where the program keeps no such
counters.  :func:`quotient` is the other counter readers' too.
"""

BODY = "swinir_gemm"


def totals(body: str) -> dict | None:
    """The body's counters summed over its kinds, or None."""
    try:
        from srcnn_cpp_tpu_torch.utils.profiling import kernel_counters
    except ImportError:
        return None
    kinds = kernel_counters().get(body)
    if not kinds:
        return None
    return {f: sum(k[f] for k in kinds.values())
            for f in next(iter(kinds.values()))}


def quotient(body: str, num: str, den: str, scale: float) -> float | None:
    """``scale`` x the body's ``num`` over its ``den``, or None."""
    t = totals(body)
    if t is None or not t.get(den):
        return None
    return scale * t[num] / t[den]


def read(ctx):
    return quotient(BODY, "full_wait_cycles", "unit_cycles", 100.0)
