"""``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own, found by the name ``BENCHMARK.json``
gives it:

* ``configs/<config>.json``: the sizes and the runner of a configuration;
* ``traffic/<traffic>.json``: the parameters the closed loop reads;
* ``end_to_end/<metric>.py``: a reader with ``read(run) -> float | None``;
* ``metrics/<metric>.py``: a per-layer reader with ``read(ctx) -> float |
  None``.

A cell, a configuration or a metric is added by adding such files and
entries; no file of the harness changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


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
    ``traffic`` and ``chips``), with the files those name read."""
    name = w["name"]
    config = read_json(config_path(w["config"])) | {"name": w["config"]}
    traffic = read_json(traffic_path(w["traffic"])) | {"name": w["traffic"]}
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    layer = [m for m in bench["per_layer"] if _applies(m, name)
             and any(e["name"] == m["moves"] for e in e2e)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, layer)


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
