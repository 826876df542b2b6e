"""``BENCHMARK.json`` against the benchmark's contract, and the lookup of
each file by the name it gives."""

from __future__ import annotations

import json
import re

import pytest

from portbench import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LAYERS = {"kernels", "pipeline", "device", "entry"}


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "-m", "portbench"]
    assert BENCH["paths"] == ["portbench"]
    assert len(json.dumps(BENCH)) < 64 * 1024
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits into its 43,200 seconds
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                           "bound", "source"}
        assert m["source"] == "host_clock"
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["layer"] in LAYERS


def test_names_units_and_uniqueness():
    groups = [BENCH["configs"], BENCH["workloads"],
              BENCH["end_to_end"] + BENCH["per_layer"]]
    for group in groups:
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files_and_metrics(name):
    cell = spec.cell(name)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for key in ("runner", "protocol", "in_hw", "scale", "out_hw",
                "weights", "limits"):
        assert key in cell.config
    assert (spec.HERE / "configs" / cell.config["weights"]).exists()
    for key in ("frames_on", "distinct_frames", "warmup_units"):
        assert key in cell.traffic
    for m in cell.end_to_end:
        assert callable(spec.end_to_end_reader(m["name"]))
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))
        assert m["moves"] in e2e


def test_every_metric_and_config_is_used():
    cells = {w["name"] for w in BENCH["workloads"]}
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for m in BENCH["per_layer"]:
        moved = [e for e in BENCH["end_to_end"] if e["name"] == m["moves"]]
        assert moved and set(m["workloads"]) <= set(
            moved[0].get("workloads", cells))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/configs/")
        assert spec.config_path(c["name"]).as_posix().endswith(c["file"])


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.cell("no.such.cell")
