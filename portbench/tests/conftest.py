"""Fixtures of the benchmark's CPU tests.

Run them with ``python -m pytest portbench/tests -p no:cacheprovider -o
addopts=""``.  A cell is driven on the CPU, through the program's plain
path, at a small frame size and with few distinct frames.
"""

from __future__ import annotations

import dataclasses

import pytest

from portbench import spec

SMALL_HW = [24, 40]


#: a stream cell that BENCHMARK.json does not hold (PERF.md, Open
#: questions), built from its files so that the push protocol stays tested
STREAM = {"name": "stream4k30.host", "config": "stream_4k30",
          "traffic": "host_push", "chips": 1}


#: a cell of unbatched calls (``frames_per_call`` null): one host frame a
#: call into ``configs.single_8k``, the batch configuration's sizes
SINGLE = {"name": "single.host", "config": "batch_1080p_to_4k",
          "traffic": "host_batches", "chips": 1}


def small(name: str) -> spec.Cell:
    """The cell ``name`` at 24x40 input frames, 8 distinct, 4 to a call."""
    extra = {c["name"]: c for c in (STREAM, SINGLE)}
    cell = spec.build(extra[name], spec.load_benchmark()) \
        if name in extra else spec.cell(name)
    cfg = dict(cell.config, in_hw=SMALL_HW,
               out_hw=[2 * SMALL_HW[0], 2 * SMALL_HW[1]])
    if name == SINGLE["name"]:
        cfg.update(runner="single_8k", runner_kwargs={"scale": 2.0},
                   frames_per_call=None)
    elif cfg["protocol"] == "call":
        cfg.update(frames_per_call=4,
                   runner_kwargs=dict(cfg["runner_kwargs"], batch=4))
    return dataclasses.replace(cell, config=cfg,
                               traffic=dict(cell.traffic, distinct_frames=8))


@pytest.fixture
def small_cell():
    return small
