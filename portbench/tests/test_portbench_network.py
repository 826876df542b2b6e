"""A configuration names its network: the plain reference that decides
``correct`` and the program's checkpoint loader are the ones its file
names, resolved when the cell is built, and the harness calls only those."""

from __future__ import annotations

import ast
import contextlib
import dataclasses
import json
import sys

import pytest

from portbench import judge, run, spec, trace
from portbench.reference import srcnn, srcnn_bgr
from portbench.tests.test_portbench_faults import _plant, altered
from portbench.tests.test_portbench_imports import SOURCES, top_level_imports

CONFIGS = sorted(p.stem for p in (spec.HERE / "configs").glob("*.json"))
CALL_CELLS = ["batch1080p.tensor", "batch1080p.host"]

#: SRCNN with rounding in place of IntTrim: conv3's bias raised by a half
#: turns the truncation of the stack's output into rounding
ROUNDED = '''
from portbench.reference.srcnn_bgr import load as _load
from portbench.reference.srcnn_bgr import macs_per_pixel, upscale_frame


def load(path, device):
    w = _load(path, device)
    w["conv3_b"] = w["conv3_b"] + 0.5
    return w
'''


@pytest.mark.parametrize("name", CONFIGS)
def test_each_configuration_names_its_network(name):
    cfg = spec.read_json(spec.config_path(name))
    ref = spec.reference(cfg["reference"])
    assert all(callable(getattr(ref, f)) for f in spec.REFERENCE_API)
    assert callable(spec.program_function(cfg["program_weights"]))
    weights = ref.load(spec.HERE / "configs" / cfg["weights"], "cpu")
    macs = ref.macs_per_pixel({k: tuple(v.shape)
                               for k, v in weights.items()})
    assert isinstance(macs, int) and macs > 0
    # the module the run loads is one that the imports test reads
    path = spec.HERE / "reference" / f"{cfg['reference']}.py"
    assert path in SOURCES
    assert "srcnn_cpp_tpu_torch" not in top_level_imports(path)


@pytest.mark.parametrize("name", [w["name"] for w in
                                  spec.load_benchmark()["workloads"]])
def test_a_cell_carries_what_its_configuration_names(name):
    from srcnn_cpp_tpu_torch.weights import load_weights

    cell = spec.cell(name)
    assert cell.program_weights is load_weights
    assert cell.reference.__file__ == srcnn_bgr.__file__


@pytest.mark.parametrize("name", [
    "no_such_reference", "../run", "../reference/srcnn_bgr", "srcnn_bgr.py",
    "/etc/hostname", "", "srcnn", "color", "__init__"])
def test_the_resolver_refuses_a_reference(name):
    # names outside reference/, unknown names, and modules of reference/
    # that are no network's whole reference
    with pytest.raises(ValueError):
        spec.reference(name)


@pytest.mark.parametrize("target", [
    "numpy:load", "portbench.frames:make",
    "srcnn_cpp_tpu.weights:load_weights",
    "srcnn_cpp_tpu_torch_like.weights:load_weights",
    "srcnn_cpp_tpu_torch.weights", "srcnn_cpp_tpu_torch.weights:",
    "srcnn_cpp_tpu_torch.weights:no_such",
    "srcnn_cpp_tpu_torch.weights:CANONICAL", "srcnn_cpp_tpu_torch/../x:f"])
def test_the_resolver_refuses_a_loader_outside_the_program(target):
    jax_package = "srcnn_cpp_tpu" in sys.modules
    with pytest.raises(ValueError):
        spec.program_function(target)
    # refused by its name, not imported: the JAX package stays unloaded
    assert ("srcnn_cpp_tpu" in sys.modules) == jax_package


@pytest.mark.parametrize("key,value", [
    ("reference", "no_such_reference"), ("reference", None),
    ("program_weights", "numpy:load"), ("program_weights", None)])
def test_a_cell_is_refused_when_it_is_built(monkeypatch, tmp_path, key,
                                            value):
    cfg = spec.read_json(spec.config_path("batch_1080p_to_4k"))
    if value is None:
        del cfg[key]        # stated explicitly: no default
    else:
        cfg[key] = value
    path = tmp_path / "batch_1080p_to_4k.json"
    path.write_text(json.dumps(cfg))
    monkeypatch.setattr(spec, "config_path", lambda name: path)
    with pytest.raises((KeyError, ValueError)):
        spec.cell("batch1080p.tensor")


def test_the_harness_names_no_network():
    """Outside ``reference/`` and the tests, no harness file imports the
    SRCNN reference or the program's SRCNN loader by name."""
    named = {"portbench.reference.srcnn", "portbench.reference.srcnn_bgr",
             "srcnn_cpp_tpu_torch.weights"}
    for path in SOURCES:
        rel = path.relative_to(spec.HERE).parts
        if rel[0] in ("reference", "tests"):
            continue
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                found = {a.name for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                package = ["portbench", *rel[:-1]]
                base = package[:len(package) + 1 - node.level] \
                    if node.level else []
                mod = ".".join([*base, *filter(None, [node.module])])
                found = {mod} | {f"{mod}.{a.name}" for a in node.names}
            else:
                continue
            assert not found & named, (path, found & named)


@pytest.mark.parametrize("planted", [False, True])
@pytest.mark.parametrize("seed", [2 ** 31 + 5, 4_000_000_007])
@pytest.mark.parametrize("name", CALL_CELLS)
def test_the_judge_reads_what_the_old_path_read(small_cell, monkeypatch,
                                                name, seed, planted):
    """``checks`` through the configuration's reference equal those of
    ``srcnn.load`` and ``srcnn_bgr.upscale_frame`` called by name, on the
    same frames the run kept; also where an altered answer makes them
    other than nought."""
    if planted:
        _plant(monkeypatch, altered)
    seen = {}
    real = judge.compare

    def recording(pairs, inputs, reference, *args, **kw):
        seen.update(pairs=list(pairs), inputs=inputs, args=args)
        return real(pairs, inputs, reference, *args, **kw)

    monkeypatch.setattr(judge, "compare", recording)
    cell = small_cell(name)
    r = run.run_cell(cell, seed, 1.0, False, "cpu")
    weights_file, scale = seen["args"][:2]
    w = srcnn.load(weights_file, "cpu")
    old = judge.Comparison()
    for i, out in seen["pairs"]:
        x = judge.as_tensor(seen["inputs"][i], "cpu")
        old.add(judge.as_tensor(out, "cpu"),
                srcnn_bgr.upscale_frame(x, w, scale))
    assert old.frames > 1
    assert r["checks"] == judge.checks(old.numbers(), cell.config["limits"])
    assert r["correct"] != planted, r


def test_the_trace_gets_the_references_macs(small_cell, monkeypatch):
    """A traced run hands ``trace.context`` the MACs of the configuration's
    reference: SRCNN's 8,032 a pixel."""
    got = {}

    @contextlib.contextmanager
    def recording(out):
        yield

    def context(events, frames, in_hw, out_hw, macs_per_px, peaks):
        got["macs"] = macs_per_px

    monkeypatch.setattr(trace, "recording", recording)
    monkeypatch.setattr(trace, "context", context)
    run.run_cell(small_cell("batch1080p.tensor"), 2 ** 33 + 1, 0.2, True,
                 "cpu")
    shapes = {k: tuple(v.shape) for k, v in
              srcnn.load(spec.HERE / "configs" / "srcnn955.npz",
                         "cpu").items()}
    assert got["macs"] == srcnn.macs_per_pixel(shapes) == 8032


@pytest.mark.parametrize("name", CALL_CELLS)
def test_the_configurations_reference_decides_correct(small_cell, tmp_path,
                                                      name):
    (tmp_path / "srcnn_rounded.py").write_text(ROUNDED)
    cell = small_cell(name)
    seed = 2 ** 32 + 17
    sound = run.run_cell(cell, seed, 0.3, False, "cpu")
    wrong = dataclasses.replace(
        cell, reference=spec.reference("srcnn_rounded", tmp_path))
    r = run.run_cell(wrong, seed, 0.3, False, "cpu")
    assert sound["correct"], sound
    assert not r["correct"], r
    assert r["checks"]["share_off"]["value"] \
        > 10 * sound["checks"]["share_off"]["value"]
