"""``python -m portbench``: one run of one cell (:mod:`portbench.run`)."""

import time

_T0 = time.perf_counter()   # set-up is counted from here

import sys  # noqa: E402

from portbench.run import main  # noqa: E402

sys.exit(main(t0=_T0))
