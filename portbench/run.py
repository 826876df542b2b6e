"""Run one cell of ``BENCHMARK.json`` once.

    python -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in ``setup_s``, from the process's start): import the
program, make the cell's frames from ``--seed``, load the checkpoint file
through the program's loader, build the runner of ``configs.py`` that the
configuration names (the kernel library is built into the checkout on a
checkout's first run, and loaded after), and run the cell's own loop for
the traffic's warm-up units.  Then the window: the closed loop of
:mod:`.loops` for ``--seconds``.  With ``--trace 0`` the readers of
``end_to_end/`` report the cell's end-to-end metrics; with ``--trace 1``
the window runs under ``torch.profiler`` and the readers of ``metrics/``
report its per-layer metrics instead.  After the window, the kept frames
are compared with the plain reference (:mod:`.judge`).

The last line of standard output is the result as JSON; the numbers
compared, each with its limit, are the last lines of standard error.
Without a card, or with fewer cards than the cell asks for, the run
prints no result and exits 2; with JAX or the JAX package loaded, 3.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import subprocess
import sys
import time

from . import frames as frame_gen
from . import judge, loops, roofline, spec, trace
from .reference.resize import output_size
from .reference.srcnn import load as load_reference_weights
from .reference.srcnn import macs_per_pixel

#: top-level module names that may not be loaded when the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "srcnn_cpp_tpu")


def forbidden_modules() -> list[str]:
    """The FORBIDDEN top-level names in ``sys.modules``, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line(torch) -> str:
    """``name, power limit`` of card 0 as ``nvidia-smi`` reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(0)}, power limit not read"


@dataclasses.dataclass
class Measured:
    """What an end-to-end reader (``end_to_end/<name>.py``) reads."""

    win: loops.Window
    out_px: int             # pixels of one output frame
    setup_s: float


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device="cuda", t0: float | None = None,
             control: bool = False) -> dict:
    """One run of ``cell``: the result line's object, before the check for
    JAX.  ``device`` is the card; the tests give ``cpu`` to drive the
    program's plain path at small sizes."""
    import torch

    from srcnn_cpp_tpu_torch import configs
    from srcnn_cpp_tpu_torch.weights import load_weights

    t0 = time.perf_counter() if t0 is None else t0
    cfg, tr = cell.config, cell.traffic
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    weights_file = spec.HERE / "configs" / cfg["weights"]
    in_hw = tuple(cfg["in_hw"])
    out_hw = output_size(*in_hw, cfg["scale"])
    if list(out_hw) != list(cfg["out_hw"]):
        raise ValueError(f"{cfg['name']}: {in_hw} x{cfg['scale']} gives "
                         f"{out_hw}, the file states {cfg['out_hw']}")
    call = cfg["protocol"] == "call"
    # a call of frames_per_call frames, or of one frame where it is null
    per_unit = (cfg["frames_per_call"] if call else None) or 1
    batched = call and cfg["frames_per_call"] is not None

    phases = {"imports": time.perf_counter() - t0}
    inputs = frame_gen.make(seed, tr["distinct_frames"], in_hw, dev)
    if tr["frames_on"] == "host":
        inputs = inputs.cpu().numpy()
    units = [inputs[i:i + per_unit] if batched else inputs[i]
             for i in range(0, len(inputs), per_unit)]
    phases["frames"] = time.perf_counter() - t0 - sum(phases.values())
    runner = getattr(configs, cfg["runner"])(
        weights=load_weights(weights_file, dev), device=dev,
        **cfg.get("runner_kwargs", {}))
    loop = loops.LOOPS[cfg["protocol"]]
    kw = {"inflight": tr["inflight"]} if call else {}
    out_shape = (*out_hw, 3)
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    loop(runner, units, out_shape, count=tr["warmup_units"],
         keep=loops.Reservoir(judge.CHECK_FRAMES, seed), **kw)
    if on_card:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    phases["runner_and_warmup"] = setup_s - sum(phases.values())
    print("setup: " + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items()),
          file=sys.stderr, flush=True)

    keep = loops.Reservoir(judge.CHECK_FRAMES, seed)
    rec: dict = {}
    with trace.recording(rec) if traced else contextlib.nullcontext():
        with torch.profiler.record_function(trace.WINDOW) if traced \
                else contextlib.nullcontext():
            win = loop(runner, units, out_shape, seconds=seconds, keep=keep,
                       spans=traced, **kw)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    del runner, loop
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    out_px = out_hw[0] * out_hw[1]
    metrics, extra = {}, {}
    if traced:
        shapes = {k: tuple(v.shape) for k, v in
                  load_reference_weights(weights_file, "cpu").items()}
        ctx = trace.context(rec.get("events", []), win.done, in_hw, out_hw,
                            macs_per_pixel(shapes), roofline.peaks_for(kind))
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"])(ctx) if ctx else None
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if ctx is not None:
            extra = {"busy_s": ctx.busy_s(), "window_s": ctx.window_s}
            breakdown = ctx.breakdown()
        rec.clear()
    else:
        measured = Measured(win, out_px, setup_s)
        for m in cell.end_to_end:
            v = spec.end_to_end_reader(m["name"])(measured)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    t_judge = time.perf_counter()
    pairs = [(unit * per_unit + j, frame) for unit, j, frame in keep.items]
    keep.items.clear()
    ctrl = judge.Comparison() if control else None
    found = judge.compare(pairs, inputs, weights_file, cfg["scale"], dev,
                          ctrl)
    print(f"judge: {found.frames} frames of {keep.n} results in "
          f"{time.perf_counter() - t_judge:.3f} s", file=sys.stderr,
          flush=True)
    checks = judge.checks(found.numbers(), cfg["limits"])
    failed = win.issued - win.done
    result = {
        "correct": bool(failed == 0 and found.frames > 0
                        and judge.passed(checks)),
        "attempted": win.issued, "failed": failed, "metrics": metrics,
        "device": {"platform": "gpu" if on_card else dev.type, "kind": kind,
                   "count": 1, "memory_peak_bytes": peak, **extra},
    }
    if traced and extra:
        result["breakdown"] = breakdown
    if control:
        result["control"] = judge.checks(ctrl.numbers(), cfg["limits"])
    result["checks"] = checks
    return result


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m portbench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"card(s), found {found}; nothing is measured on the CPU",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", t0)
    card = card_line(torch)     # after the window: not part of set-up
    print(f"card: {card}", flush=True)
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: loaded in the measuring process: "
              f"{', '.join(loaded)}", file=sys.stderr)
        return 3
    for name, m in result["metrics"].items():
        print(f"{name} {m['value']!r} {m['unit']} ({card})", flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
