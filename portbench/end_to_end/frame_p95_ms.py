"""The 95th percentile, over every frame the window completed, of the time
from the frame's issue (``push``, or the call that carried it) to the
moment its result was in the caller's hands."""

import numpy as np


def read(run):
    if not run.win.latency_s:
        return None
    return float(np.percentile(run.win.latency_s, 95)) * 1e3
