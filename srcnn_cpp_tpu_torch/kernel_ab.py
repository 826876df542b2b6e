"""Time this tree's kernels against another checkout's, in turns, on one card.

    git archive <commit> | tar -x -C _ab/parent      # any listed scratch dir
    python -m srcnn_cpp_tpu_torch.kernel_ab --parent _ab/parent

Loads the other checkout's ``srcnn_cpp_tpu_torch`` under another module
name beside this one, builds both kernel libraries, and on the x2 main
geometry (4 seeded 540x960 BGR frames -> 4 x 1080x1920) times, with CUDA
events, the conv K1 (``srcnn_y_fused``), the pre-pass K2
(``pre_upscale_fused``), the post-pass K3 (``merge_ycrcb_to_bgr_fused``),
the VDSR chain (``vdsr_y_fused``, on the same 4 upscaled Y planes with
``portbench/configs/vdsr20_seeded.npz``: the 64->64 conv that RCAN
shares), RCAN x2 (``rcan_fused`` on the same 4 BGR frames with
``portbench/configs/rcan_x2_seeded.jsonl``, fewer repetitions: a call
takes ~0.66 s), SwinIR x2 (``swinir_fused`` on the same frames with
``portbench/configs/swinir_x2_seeded.jsonl``, fewer repetitions, where
both trees have it) and the device-resident pipeline (``upscale_planar``)
of both, and K3 on 4 seeded [1079,1921] planes (H*W % 16 != 0), in turns (parent, change,
change, parent) for ``--rounds`` rounds; K2 and both K3 cases also from
CUDA graph replays; the host-array entry (``upscale_bgr_batch`` on the
same frames as a host array, host clock per call).  Before timing it
checks that both give the same K2, K3, RCAN and SwinIR outputs, K1 and VDSR
outputs within 1 LSB of each other (it prints their largest difference) and
host-array outputs within 2 LSB, and it profiles
20 calls of each pipeline and of the odd-plane K3 (``torch.profiler``:
device time by kernel, busy share of the span) and, in turns, 2 calls of
each ``swinir_fused`` (device time by kernel), and prints K2's static
SASS instruction counts of both builds and whether the shared conv
bodies' instances (``vdsr_conv3x3_kernel``, RCAN's ``rcan_conv3x3_kernel``
of each epilogue and loader, SwinIR's ``swin_stl_*`` and
``swinir_conv3x3_kernel``) compiled to the same SASS in both
(``cuobjdump``, where it runs).

    python -m srcnn_cpp_tpu_torch.kernel_ab --probes

times instead, in this tree alone, what the stall counters cost when they
are on (:func:`probe_cost`): each GEMM kind of the two bodies at 1080p,
unprobed against probed, in turns.

Prints one line per round
and a JSON summary (medians over the rounds, the profiles, the card's name
and power limit), also written to ``--out``.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

_ALIAS = "srcnn_ab_parent"
VDSR_NPZ = Path(__file__).resolve().parent.parent / \
    "portbench/configs/vdsr20_seeded.npz"
RCAN_RECIPE = VDSR_NPZ.with_name("rcan_x2_seeded.jsonl")
SWINIR_RECIPE = VDSR_NPZ.with_name("swinir_x2_seeded.jsonl")
#: timed with fewer repetitions: a call takes a large part of a second
SLOW = ("rcan_fused", "swinir_fused")


def load_checkout(root: Path, alias: str = _ALIAS):
    """Import ``root/srcnn_cpp_tpu_torch`` as package ``alias``."""
    pkg = Path(root).resolve() / "srcnn_cpp_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return mod


def _median_ms(fn, reps: int) -> float:
    """Median over ``reps`` CUDA-event timings, each of enough back-to-back
    calls to fill about 2 ms, divided by their count."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    inner = max(1, min(50, int(2e-3 / (time.perf_counter() - t0))))
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(inner):
            fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1) / inner)
    return statistics.median(times)


def _host_ms(fn, reps: int) -> float:
    """Median host-clock time of one call of ``fn`` that ends in a host
    fetch (a call that returns a host array), after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def graph_ms(fn, reps: int, inner: int = 20) -> float:
    """Median over ``reps`` CUDA-event timings of one replay of a CUDA graph
    that holds ``inner`` calls of ``fn``, divided by ``inner``: the card's
    time for a call without the host's launch overhead between calls, which
    exceeds a kernel of a few tens of microseconds."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):      # warm-up off the capture, as required
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1) / inner)
    return statistics.median(times)


def profile(fn, iters: int = 20) -> dict:
    """Device time by kernel over ``iters`` back-to-back calls of ``fn``
    (``torch.profiler``), the busy share of their CUDA-event span and the
    device activities (kernels and copies) per call."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        torch.cuda.synchronize()
    span = t0.elapsed_time(t1)
    kernels, activities = {}, 0
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total", None)
        if dev is None:
            dev = getattr(ev, "self_cuda_time_total", 0)
        if dev > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.key[:80]] = dev / 1e3 / iters   # ms per call
            activities += ev.count
    busy = sum(kernels.values())
    return {"span_ms_per_call": span / iters, "device_ms_per_call": busy,
            "busy_share": busy * iters / span if span else None,
            "activities_per_call": activities / iters,
            "kernels_ms_per_call": kernels}


def sass_code(lib: Path) -> dict[str, list[str]] | None:
    """Each function's SASS instructions in the built library ``lib``
    (``cuobjdump -sass``), by mangled name.  None where the toolkit has no
    ``cuobjdump`` or it fails."""
    exe = shutil.which("cuobjdump")
    if exe is None and Path("/usr/local/cuda/bin/cuobjdump").exists():
        exe = "/usr/local/cuda/bin/cuobjdump"
    if exe is None:
        return None
    try:
        run = subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                             text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if run.returncode != 0:
        return None
    code, body = {}, None
    for line in run.stdout.splitlines():
        if "Function :" in line:
            body = code.setdefault(line.split("Function :")[1].strip(), [])
            continue
        m = body is not None and re.search(r"/\*[0-9a-f]+\*/\s+(.*?);", line)
        if m:
            body.append(m.group(1).strip())
    return code


def sass_counts(lib: Path, kernel: str,
                ops=("I2F", "I2FP", "F2I", "FRND", "IDP", "LDS", "STS",
                     "LDG", "STG"), code: dict | None = None) -> dict | None:
    """Static counts of the SASS opcodes ``ops`` in the code of ``kernel``
    (a substring of its mangled name) within the built library ``lib``
    (or its :func:`sass_code`): each instruction once, however often it
    runs.  None where the toolkit has no ``cuobjdump`` or it fails."""
    code = code if code is not None else sass_code(lib)
    if code is None:
        return None
    counts = dict.fromkeys(ops, 0)
    for name, body in code.items():
        if kernel in name:
            for ins in body:
                m = re.match(r"(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", ins)
                if m and m.group(1) in counts:
                    counts[m.group(1)] += 1
    return counts


def conv_sass(code: dict) -> dict[str, list[str]]:
    """The shared conv bodies' instances in :func:`sass_code`:
    ``vdsr_conv3x3_kernel``; ``rcan_conv3x3_kernel<e, l>`` of each epilogue
    ``e`` and loader ``l`` (mangled ``...ILi<e>ELi<l>EE``, or ``...ILi<e>EE``
    before the loader became a template parameter, read as ``l`` 0); and
    SwinIR's ``swin_stl_linear_kernel<l, e>``, ``swinir_conv3x3_kernel<n,
    l, e>`` and ``swin_stl_attention_kernel``.  Where an instance has the
    stall counters' last template parameter ``PROBE`` (mangled ``Lb0E``,
    ``Lb1E``), the unprobed one keeps the name of a tree's instance without
    it, so that the two are compared, and the probed one is named with
    ``" probed"`` after it."""
    out = {}
    for name, body in code.items():
        m = re.search(r"vdsr_conv3x3_kernel(?:ILb([01])EE)?", name)
        if m:
            out["vdsr_conv3x3_kernel" + PROBED[m.group(1)]] = body
        if "swin_stl_attention_kernel" in name:
            out["swin_stl_attention_kernel"] = body
        m = re.search(r"(rcan_conv3x3|swin_stl_linear|swinir_conv3x3)_kernel"
                      r"ILi(\d+)E(?:Li(\d+)E)?(?:Li(\d+)E)?(?:Lb([01])E)?E",
                      name)
        if m:
            last = f", {m.group(4)}" if m.group(4) else ""
            out[f"{m.group(1)}_kernel<{m.group(2)}, "
                f"{m.group(3) or 0}{last}>{PROBED[m.group(5)]}"] = body
    return out


#: a conv-body instance's name suffix by its mangled PROBE (None: no such
#: parameter)
PROBED = {None: "", "0": "", "1": " probed"}


def _queued_ms(fn, n: int) -> float:
    """CUDA-event ms a call over ``n`` back-to-back calls of ``fn``,
    enqueued behind a sleep on the card, so that the host's time to launch
    them (longer for a probed call) stays out of the span."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / n


def probe_cost_calls(h: int = 1080, w: int = 1920) -> dict:
    """``{kind: launch}``: one launch of each GEMM kind of the two bodies
    (``ops.cuda_swinir.PROBE_KINDS``, the 180-wide convs with and without
    the LayerNorm loader) on a seeded ``h x w`` map; VDSR's kind is its
    chain on one ``h x w`` Y plane, whose 64->64 layers take 96 % of it."""
    from .ops import cuda_rcan, cuda_swinir
    from .ops.cuda_vdsr import vdsr_y_fused
    from .weights import load_vdsr_weights

    torch.manual_seed(0)

    def rand(*shape, std=0.05):
        return std * torch.randn(shape, device="cuda")

    def tokens(real, width):
        x = torch.zeros((h, w, width), device="cuda")
        x[..., :real] = torch.randn((h, w, real), device="cuda")
        return x

    x, hid = tokens(180, 184), tokens(360, 368)
    ln = (1 + rand(180), rand(180))
    calls = {
        "qkv": ("qkv", x, (540, 180), {"ln": ln}),
        "proj": ("resid", x, (180, 180), {"skip": x}),
        "fc1": ("fc1", x, (360, 180), {"ln": ln}),
        "fc2": ("resid", hid, (180, 360), {"skip": x}),
        "conv": ("conv", x, (180, 180, 3, 3), {"skip": x}),
        "conv_ln": ("conv_ln", x, (180, 180, 3, 3), {"skip": x, "ln": ln}),
        "before_up": ("before_up", x, (64, 180, 3, 3), {})}
    out = {}
    for name, (kind, inp, shape, kw) in calls.items():
        out[f"swinir_gemm.{name}"] = cuda_swinir.gemm_call(
            kind, inp, rand(*shape).cpu(), rand(shape[0]).cpu(), **kw)[0]
    m = torch.relu(torch.randn((h, w, 64), device="cuda"))
    grid = cuda_rcan.rcan_plan(h, w, torch.cuda.get_device_properties(0)
                               .multi_processor_count)["grid"]
    ca = {"t": torch.randn((h, w, 64), device="cuda"),
          "ca_pool": torch.rand((2 * grid, 64), device="cuda") * h * w
          / (2 * grid), "ca": rand(cuda_rcan.CA_FLOATS, std=0.5)}
    for name, epi, kw in (("relu", "relu", {}), ("pool", "pool", {}),
                          ("skip", "skip", {"skip": m}),
                          ("shuffle", "shuffle", {}),
                          ("relu_apply", "relu", ca),
                          ("skip_apply_last", "skip", {"skip": m, **ca})):
        out[f"conv3x3.{name}"] = cuda_rcan.conv3x3_call(
            m, rand(64, 64, 3, 3).cpu(), rand(64).cpu(), epi, **kw)[0]
    weights = load_vdsr_weights(VDSR_NPZ, device="cuda")
    y = torch.randint(0, 256, (1, h, w), dtype=torch.uint8, device="cuda")
    out["conv3x3.vdsr"] = lambda: vdsr_y_fused(y, weights)
    return out


def probe_cost(rounds: int = 7, n: int = 10) -> dict:
    """What the stall counters cost when on: each launch of
    :func:`probe_cost_calls` timed unprobed and probed
    (``utils.profiling.counted``), in turns (off, on, on, off) for
    ``rounds`` rounds, each a mean over ``n`` queued launches
    (:func:`_queued_ms`).  ``{kind: {"off": ms, "on": ms, "cost_pct":
    ...}}``, medians over the rounds."""
    from .utils.profiling import counted

    found = {}
    for name, fn in probe_cost_calls().items():
        off, on = [], []
        for _ in range(rounds):
            off.append(_queued_ms(fn, n))
            on += [counted(lambda: _queued_ms(fn, n))[0] for _ in range(2)]
            off.append(_queued_ms(fn, n))
        a, b = statistics.median(off), statistics.median(on)
        found[name] = {"off": a, "on": b, "cost_pct": 100.0 * (b - a) / a,
                       "off_all": off, "on_all": on}
    return found


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path,
                    help="root of the checkout to compare against")
    ap.add_argument("--probes", action="store_true",
                    help="time the stall counters' cost when on, each GEMM "
                         "kind at 1080p probed against unprobed, and "
                         "nothing else")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path, default=Path("chiprun_out/ab.json"))
    args = ap.parse_args(argv)
    if args.parent is None and not args.probes:
        ap.error("give --parent or --probes")
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = _card()
    if args.probes:
        found = probe_cost()
        for name, r in found.items():
            print(f"probe cost {name}: off {r['off']:.4f} ms, on "
                  f"{r['on']:.4f} ms a launch, {r['cost_pct']:+.2f} % "
                  f"({card})", flush=True)
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "probe_cost": found},
                                       indent=1))
        return 0

    load_checkout(args.parent)
    sides, code = {}, {}
    for tag, name in (("parent", _ALIAS), ("change", "srcnn_cpp_tpu_torch")):
        m = {k: importlib.import_module(f"{name}.{k}") for k in
             ("runtime", "pipeline", "weights", "ops.cuda_srcnn",
              "ops.cuda_resize", "ops.cuda_merge", "ops.cuda_vdsr",
              "ops.cuda_rcan")}
        # SwinIR, where the tree has it
        swinir = importlib.util.find_spec(f"{name}.ops.cuda_swinir")
        m["ops.cuda_swinir"] = importlib.import_module(
            f"{name}.ops.cuda_swinir") if swinir is not None else None
        path, secs, _ = m["runtime"].build()
        m["runtime"].library()
        code[tag] = sass_code(path)
        print(f"{tag}: built {path} in {secs:.1f} s; K2's static SASS "
              f"counts {sass_counts(path, 'pre_pass_kernel', code=code[tag])}",
              flush=True)
        sides[tag] = m
    if code["parent"] is None or code["change"] is None:
        print("SASS of the conv bodies: not read (no cuobjdump)", flush=True)
    else:
        convs = {tag: conv_sass(c) for tag, c in code.items()}
        for kernel in sorted(convs["parent"].keys() | convs["change"].keys()):
            body = convs["parent"].get(kernel)
            other = convs["change"].get(kernel)
            verdict = ("new in the change" if body is None else "absent"
                       if other is None else "identical" if other == body
                       else "DIFFERS")
            print(f"SASS {kernel}: {verdict} ({len(body or [])} "
                  f"instructions in the parent, {len(other or [])} in the "
                  f"change)", flush=True)

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 256, (4, 3, 540, 960),
                                      dtype=np.uint8)).cuda()
    frames = np.ascontiguousarray(np.moveaxis(x.cpu().numpy(), 1, -1))
    host = "upscale_bgr_batch (host arrays)"
    hw = (1080, 1920)
    # K3 on planes with H*W % 16 != 0 (odd sizes from the CLI and the eval
    # harness), beside the main geometry
    odd = (1079, 1921)
    y_odd = torch.from_numpy(rng.integers(0, 256, (4, *odd),
                                          dtype=np.uint8)).cuda()
    up_odd = torch.from_numpy(rng.integers(0, 256, (4, 3, *odd),
                                           dtype=np.uint8)).cuda()
    k3_odd = f"merge_ycrcb_to_bgr_fused [4,{odd[0]},{odd[1]}]"
    fns = {}
    ups = {}
    for tag, m in sides.items():
        w = m["weights"].load_weights(device="cuda")
        pre = m["ops.cuda_resize"].pre_upscale_fused
        conv = m["ops.cuda_srcnn"].srcnn_y_fused
        merge = m["ops.cuda_merge"].merge_ycrcb_to_bgr_fused
        ups[tag] = pre(x, hw)
        up = ups[tag]
        y_sr = conv(up[:, 0], w)
        vdsr = m["ops.cuda_vdsr"].vdsr_y_fused
        wv = m["weights"].load_vdsr_weights(VDSR_NPZ, device="cuda")
        rcan = m["ops.cuda_rcan"].rcan_fused
        wr = m["weights"].load_rcan_weights(RCAN_RECIPE, device="cuda")
        fns[tag] = {
            "srcnn_y_fused": (lambda c=conv, u=up, w=w: c(u[:, 0], w)),
            "vdsr_y_fused": (lambda f=vdsr, u=up, w=wv: f(u[:, 0], w)),
            "rcan_fused": (lambda f=rcan, w=wr: f(x, w, hw)),
            "pre_upscale_fused": (lambda p=pre: p(x, hw)),
            "merge_ycrcb_to_bgr_fused": (lambda f=merge, y=y_sr, u=up:
                                         f(y, u)),
            k3_odd: (lambda f=merge: f(y_odd, up_odd)),
            "upscale_planar": (lambda m=m, w=w:
                               m["pipeline"].upscale_planar(x, w, hw)),
            host: (lambda m=m, w=w:
                   m["pipeline"].upscale_bgr_batch(frames, 2.0, w, "cuda")),
        }
        if all(side["ops.cuda_swinir"] is not None
               for side in sides.values()):
            swin = m["ops.cuda_swinir"].swinir_fused
            ws = m["weights"].load_swinir_weights(SWINIR_RECIPE,
                                                  device="cuda")
            fns[tag]["swinir_fused"] = (lambda f=swin, w=ws: f(x, w, hw))
    if "swinir_fused" not in fns["change"]:
        print("swinir_fused: not compared (the parent has no SwinIR)",
              flush=True)
    if not torch.equal(ups["parent"], ups["change"]):
        raise AssertionError("K2 outputs differ between the two trees")
    equal = [n for n in ("merge_ycrcb_to_bgr_fused", k3_odd, "rcan_fused",
                         "swinir_fused") if n in fns["change"]]
    for name in equal:
        if not torch.equal(fns["parent"][name](), fns["change"][name]()):
            raise AssertionError(f"{name}: outputs differ between the trees")
    print(f"{', '.join(equal)}: bit-equal to the parent", flush=True)
    # K2 and K3 take less device time than their wrappers' host time: they
    # are also timed from CUDA graph replays, in turns like the rest
    graphed = ("pre_upscale_fused", "merge_ycrcb_to_bgr_fused", k3_odd)
    for name, what in (("srcnn_y_fused", "K1"), ("vdsr_y_fused", "VDSR")):
        d = (fns["parent"][name]().int() - fns["change"][name]().int()).abs()
        print(f"{what} parent vs change: max {int(d.max())} LSB, differing "
              f"{float((d > 0).float().mean()):.2e}", flush=True)
        if int(d.max()) > 1:
            raise AssertionError(f"{what} outputs differ by more than 1 LSB")
    d = np.abs(fns["parent"][host]().astype(np.int32)
               - fns["change"][host]().astype(np.int32))
    print(f"{host} parent vs change: max {int(d.max())} LSB, differing "
          f"{float((d > 0).mean()):.2e}", flush=True)
    if int(d.max()) > 2:
        raise AssertionError(f"{host}: outputs differ by more than 2 LSB")

    timed = [(name, "", _host_ms if name == host else _median_ms)
             for name in fns["change"]]
    timed += [(name, " (graph)", graph_ms) for name in graphed]
    rounds = []
    for r in range(args.rounds):
        row = {}
        for name, suffix, timer in timed:
            reps = max(3, args.reps // 5) if name in SLOW else args.reps
            p = [timer(fns["parent"][name], reps)]
            c = [timer(fns["change"][name], reps) for _ in range(2)]
            p.append(timer(fns["parent"][name], reps))
            row[name + suffix] = {"parent": p, "change": c}
            print(f"round {r}: {name}{suffix}: parent {p[0]:.4f}/{p[1]:.4f} "
                  f"ms, change {c[0]:.4f}/{c[1]:.4f} ms ({card})", flush=True)
        rounds.append(row)
    summary = {"card": card, "geometry": "4x3x540x960 -> 4x3x1080x1920",
               "profile": {tag: profile(fns[tag]["upscale_planar"])
                           for tag in ("parent", "change")},
               "profile_k3_odd": {tag: profile(fns[tag][k3_odd])
                                  for tag in ("parent", "change")},
               "rounds": rounds, "median_ms": {
                   name: {side: statistics.median(
                       v for row in rounds for v in row[name][side])
                       for side in ("parent", "change")}
                   for name in rounds[0]}}
    if "swinir_fused" in fns["change"]:
        # SwinIR's kernels by name, 2 calls a profile, in turns
        swin = {"parent": [], "change": []}
        for tag in ("parent", "change", "change", "parent"):
            swin[tag].append(profile(fns[tag]["swinir_fused"], iters=2)
                             ["kernels_ms_per_call"])
        summary["profile_swinir"] = swin
        for k, v in sorted(swin["parent"][0].items(), key=lambda kv: -kv[1]):
            print(f"profile swinir_fused, {k}: parent " + "/".join(
                f"{p.get(k, 0):.3f}" for p in swin["parent"]) + " ms, change "
                + "/".join(f"{p.get(k, 0):.3f}" for p in swin["change"])
                + f" ms a call ({card})", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(summary, indent=1))
    for tag in ("parent", "change"):
        pr = summary["profile_k3_odd"][tag]
        print(f"profile {tag}, {k3_odd} alone: device "
              f"{pr['device_ms_per_call']:.4f} ms/call of a "
              f"{pr['span_ms_per_call']:.4f} ms span", flush=True)
        pr = summary["profile"][tag]
        print(f"profile {tag}: span {pr['span_ms_per_call']:.4f} ms/call, "
              f"device {pr['device_ms_per_call']:.4f} ms/call, busy "
              f"{pr['busy_share']:.3f}; " + ", ".join(
                  f"{k} {v:.4f}" for k, v in sorted(
                      pr["kernels_ms_per_call"].items(),
                      key=lambda kv: -kv[1])), flush=True)
    print(json.dumps(summary["median_ms"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
