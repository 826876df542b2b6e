"""Readings that the limits of ``correct`` are set from, on the card.

    python -m portbench.calibrate --workload <name> --seconds 3 --seeds 1 2 3 ...

For each seed, in one process: one run of the cell as ``python -m
portbench`` makes it (the timed path at the timed sizes, a short window),
whose numbers are the program's readings, and the control on the same
sampled frames: the reference with the convs' operands rounded to TF32,
put in the program's place, against the reference.  One JSON line a seed;
the benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import run, spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    print(f"card: {run.card_line(torch)}", flush=True)
    for seed in args.seeds:
        t = time.perf_counter()
        r = run.run_cell(cell, seed, args.seconds, False, "cuda",
                         control=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": r["correct"], "failed": r["failed"],
                          "program": r["checks"], "control": r["control"],
                          "metrics": r["metrics"],
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
