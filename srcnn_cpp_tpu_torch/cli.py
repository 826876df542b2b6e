"""The command line, with the reference binary's surface, on PyTorch.

Mirrors ``srcnn (options) <source> [output]`` (reference src/srcnn.cpp
parseArgs :331-425, printTitle/printHelp :427-447) as the JAX package's
``srcnn_cpp_tpu/cli.py`` does:

* ``--scale=<float>``   scaling ratio, default 2.0; a non-positive or
  unparsable value falls back to the default (srcnn.cpp:359-370);
* ``--noverbose``       silence the per-stage narration;
* ``--repeat=<int>``    re-run the compute span N times, report the best;
* ``--device=cuda|cpu`` where the pipeline runs (default ``cuda``: the
  three CUDA kernels; ``cpu`` runs their plain PyTorch versions);
* ``--help``            usage text;
* positional source image, optional output image; the default output path is
  ``<name>_resized.<ext>`` next to the source (srcnn.cpp:396-416).

The default device is ``cuda``; without a GPU the CLI exits with an error
instead of running on the CPU.  Exit codes follow
:data:`.utils.debug.EXIT_CODES`: 1 = load/scale failure or bad command line
or no GPU, 2 = decoded image is not 3-channel BGR, 3 = output is not
3-channel, 10 = empty output or failed write.
"""

from __future__ import annotations

import sys
from pathlib import Path

from . import __version__
from .imageio import imread_bgr, imwrite_bgr
from .pipeline import upscale_bgr
from .runtime import DEVICES, cuda_missing
from .utils.debug import EXIT_CODES
from .utils.timer import TickTimer
from .weights import load_weights

_PROG = "srcnn-torch"


class UsageError(ValueError):
    """Malformed command line (bad flag value or unknown flag)."""


def print_title(file=None) -> None:
    import torch

    file = file or sys.stdout
    print(f"{_PROG} : SRCNN super-resolution on PyTorch/CUDA, "
          f"version {__version__}", file=file)
    dev = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
           else "no CUDA device")
    print(f"Using torch {torch.__version__} on [{dev}]", file=file)


def print_help(file=None) -> None:
    file = file or sys.stdout
    print(f"Usage: {_PROG} (options) <source image file> [output image file]",
          file=file)
    print("Options:", file=file)
    print("  --scale=<float>    scaling ratio, default 2.0 (must be > 0)",
          file=file)
    print("  --noverbose        run silently", file=file)
    print("  --device=<name>    cuda (default: the CUDA kernels) or cpu",
          file=file)
    print("  --repeat=<int>     time the compute span over N runs", file=file)
    print("  --help             this message", file=file)


def parse_args(argv: list[str]):
    """argv (no program name) -> dict of options, or None after --help.

    Raises :class:`UsageError` for unknown ``--flags`` and malformed values
    of ``--repeat`` and ``--device``.
    """
    opts = {"scale": 2.0, "verbose": True, "device": "cuda", "repeat": 1,
            "src": None, "dst": None}
    for arg in argv:
        if arg.startswith("--scale="):
            try:
                v = float(arg.split("=", 1)[1])
            except ValueError:
                v = 0.0
            if v > 0.0:
                opts["scale"] = v
        elif arg == "--noverbose":
            opts["verbose"] = False
        elif arg.startswith("--device="):
            v = arg.split("=", 1)[1]
            if v not in DEVICES:
                raise UsageError(f"unknown device {v!r} (choose from "
                                 f"{', '.join(DEVICES)})")
            opts["device"] = v
        elif arg.startswith("--repeat="):
            v = arg.split("=", 1)[1]
            try:
                opts["repeat"] = max(1, int(v))
            except ValueError:
                raise UsageError(f"--repeat expects an integer, got {v!r}")
        elif arg == "--help":
            return None
        elif arg.startswith("--"):
            raise UsageError(f"unknown option {arg!r}")
        elif opts["src"] is None:
            opts["src"] = arg
        elif opts["dst"] is None:
            opts["dst"] = arg
    if opts["src"] and not opts["dst"]:
        p = Path(opts["src"])
        opts["dst"] = str(p.with_name(p.stem + "_resized" + p.suffix))
    return opts


def run(opts) -> int:
    import torch

    verbose = opts["verbose"]

    def say(msg: str) -> None:
        if verbose:
            print(msg, flush=True)

    device = opts["device"]
    if cuda_missing(device, _PROG):
        return EXIT_CODES["load_or_scale"]
    src, dst = opts["src"], opts["dst"]
    say(f"- Loading image : {src}")
    img = imread_bgr(src)
    if img is None:
        print(f"{_PROG}: cannot load image {src!r}", file=sys.stderr)
        return EXIT_CODES["load_or_scale"]
    if img.ndim != 3 or img.shape[2] != 3:
        # the BGR->YCrCb stage needs 3 channels (reference cvtColor failure,
        # srcnn.cpp:509-526 -> exit -2)
        print(f"{_PROG}: cannot convert colorspace of "
              f"{img.shape}-shaped image", file=sys.stderr)
        return EXIT_CODES["colorspace"]
    h, w = img.shape[:2]
    say(f"- Image size : {w}x{h}")
    say(f"- Scale : {opts['scale']:g}, device : {device}")

    weights = load_weights(device=device)
    say("- Weights : SRCNN 9-5-5 (pretrained, 0-255 domain)")

    sync = torch.cuda.synchronize if device == "cuda" else None
    best_ms = None
    out = None
    for i in range(opts["repeat"]):
        with TickTimer(sync=sync) as t:
            out = upscale_bgr(img, opts["scale"], weights, device=device)
        note = " (includes kernel build and load)" \
            if i == 0 and device == "cuda" else ""
        say(f"- Performance : {t.ms:.1f} ms took.{note}")
        best_ms = t.ms if best_ms is None else min(best_ms, t.ms)
    if out.size == 0:
        print(f"{_PROG}: empty output", file=sys.stderr)
        return EXIT_CODES["empty_output"]
    if out.ndim != 3 or out.shape[2] != 3:
        # merge produced the wrong plane count (reference split/merge
        # failure, srcnn.cpp:540-555 -> exit -3)
        print(f"{_PROG}: merge failure: output shape {out.shape}",
              file=sys.stderr)
        return EXIT_CODES["split"]
    oh, ow = out.shape[:2]
    say(f"- Output size : {ow}x{oh}")
    if opts["repeat"] > 1:
        mp = (oh * ow) / 1e6
        say(f"- Best : {best_ms:.1f} ms  ({mp / (best_ms / 1e3):.1f} MP/s)")

    say(f"- Writing : {dst}")
    if not imwrite_bgr(dst, out):
        print(f"{_PROG}: cannot write {dst!r}", file=sys.stderr)
        return EXIT_CODES["empty_output"]
    say("- Done.")
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        opts = parse_args(argv)
    except UsageError as e:
        print(f"{_PROG}: {e}", file=sys.stderr)
        print_help(file=sys.stderr)
        return 1
    if opts is None or opts["verbose"]:
        print_title()
    if opts is None or opts["src"] is None:
        print_help()
        # bare/helpful invocations exit 0 like the reference binary
        # (srcnn.cpp:711-715); only a malformed line exits 1
        return 0
    return run(opts)


if __name__ == "__main__":
    sys.exit(main())
