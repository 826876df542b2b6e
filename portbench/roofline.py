"""The table of peaks and the roofline arithmetic the readers share.

A share of the roofline is the least time the card could take, the larger
of the operations over the peak rate and the bytes over the HBM rate, over
the time measured.  Operations and bytes come from shapes alone: each
input byte read once, each output byte written once.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = Path(__file__).with_name("peaks.json")


def peaks_for(kind: str) -> dict | None:
    """The row of ``peaks.json`` whose ``match`` is in the card's name
    ``kind``; None for a card the table does not hold."""
    for row in json.loads(PEAKS.read_text())["cards"]:
        if row["match"] in kind:
            return row
    return None


def least_s(ops: float, op_rate: float, nbytes: float,
            byte_rate: float) -> float:
    return max(ops / op_rate, nbytes / byte_rate)


def share_pct(least: float, measured_s: float | None) -> float | None:
    """``100 * least / measured``; None when nothing was measured."""
    if not measured_s:
        return None
    return 100.0 * least / measured_s
