"""``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own, found by the name ``BENCHMARK.json``
gives it:

* ``configs/<config>.json``: the sizes and the runner of a configuration,
  and the network it runs: ``"reference"``, the name of its plain
  reference ``reference/<name>.py``, and ``"program_weights"``,
  ``"<module>:<function>"``, the program's checkpoint loader;
* ``traffic/<traffic>.json``: the parameters the closed loop reads;
* ``end_to_end/<metric>.py``: a reader with ``read(run) -> float | None``;
* ``metrics/<metric>.py``: a per-layer reader with ``read(ctx) -> float |
  None``.

A cell, a configuration or a metric is added by adding such files and
entries; no file of the harness changes.  A configuration of another
network adds, all as new files: its ``configs/<name>.json`` naming
``reference`` and ``program_weights``; its checkpoint beside it, or
seeded weights saved as a data file by a script kept beside them; its
``reference/<name>.py``; its traffic file and its readers.  The program
brings the runner in ``srcnn_cpp_tpu_torch/configs.py`` and the loader.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import types
from pathlib import Path
from typing import Callable

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: what a configuration's reference module provides
REFERENCE_API = ("load", "macs_per_pixel", "upscale_frame")
#: the package a configuration's ``program_weights`` has to lie in
PROGRAM = "srcnn_cpp_tpu_torch"
_MODULE_NAME = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict            # configs/<config>.json, with "name"
    traffic: dict           # traffic/<traffic>.json, with "name"
    end_to_end: list[dict]  # this cell's end-to-end metrics
    per_layer: list[dict]   # this cell's per-layer metrics
    reference: types.ModuleType     # the configuration's plain reference
    program_weights: Callable       # the program's loader, fn(path, device)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def read_json(path: Path) -> dict:
    return json.loads(path.read_text())


def config_path(name: str) -> Path:
    return HERE / "configs" / f"{name}.json"


def traffic_path(name: str) -> Path:
    return HERE / "traffic" / f"{name}.json"


def cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files read; an
    unknown name raises KeyError."""
    bench = load_benchmark() if bench is None else bench
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (known: "
                       f"{', '.join(sorted(by_name))})")
    return build(by_name[name], bench)


def build(w: dict, bench: dict) -> Cell:
    """The cell of workload entry ``w`` (its ``name``, ``config``,
    ``traffic`` and ``chips``), with the files those name read and the
    configuration's reference and program loader resolved; either raises
    ValueError where it names nothing that may serve."""
    name = w["name"]
    config = read_json(config_path(w["config"])) | {"name": w["config"]}
    traffic = read_json(traffic_path(w["traffic"])) | {"name": w["traffic"]}
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    layer = [m for m in bench["per_layer"] if _applies(m, name)
             and any(e["name"] == m["moves"] for e in e2e)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, layer,
                reference(config["reference"]),
                program_function(config["program_weights"]))


def reference(name: str, folder: Path = HERE / "reference"
              ) -> types.ModuleType:
    """The module ``<folder>/<name>.py``, loaded from its file as
    :func:`reader` loads a reader, with the functions of
    :data:`REFERENCE_API`.  A name that is no module name, and so could
    reach outside ``folder``, is refused, as is a module lacking one of
    them."""
    path = folder / f"{name}.py"
    if not _MODULE_NAME.fullmatch(name) or not path.is_file():
        raise ValueError(f"reference {name!r}: no module {name}.py in "
                         f"{folder}")
    spec = importlib.util.spec_from_file_location(
        f"portbench.reference.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    missing = [f for f in REFERENCE_API
               if not callable(getattr(module, f, None))]
    if missing:
        raise ValueError(f"reference {name!r} lacks {', '.join(missing)}")
    return module


def program_function(target: str) -> Callable:
    """The function ``"<module>:<function>"`` of the program; a module
    outside :data:`PROGRAM` is refused before it is imported."""
    module, _, fn = target.partition(":")
    parts = module.split(".")
    if parts[0] != PROGRAM or not all(
            _MODULE_NAME.fullmatch(p) for p in (*parts, fn)):
        raise ValueError(f"program_weights {target!r}: not a function "
                         f"'<module>:<function>' of {PROGRAM}")
    found = getattr(importlib.import_module(module), fn, None)
    if not callable(found):
        raise ValueError(f"program_weights {target!r}: {module} has no "
                         f"function {fn}")
    return found


def base_name(name: str) -> str:
    """What a metric measures: its name before the first dot.  After the
    dot, a name says which cells report it (``out_mpps.host``), so that a
    quantity whose cells spread differently has a bound for each."""
    return name.split(".")[0]


def reader(folder: str, name: str):
    """The ``read`` function of ``<folder>/<name>.py``, or, where there is
    no such file, of the file of the metric's base name."""
    path = HERE / folder / f"{name}.py"
    if not path.exists():
        path = HERE / folder / f"{base_name(name)}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.{folder}.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metric_reader(name: str):
    """The reader of the per-layer metric ``name``."""
    return reader("metrics", name)


def end_to_end_reader(name: str):
    """The reader of the end-to-end metric ``name``."""
    return reader("end_to_end", name)
