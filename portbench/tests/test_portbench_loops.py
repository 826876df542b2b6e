"""What a window keeps for the comparison, and what the end-to-end readers
read of it."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import judge, loops, run, spec


def _offer_all(seed: int, calls: int, per_call: int = 32,
               host: bool = False) -> loops.Reservoir:
    keep = loops.Reservoir(judge.CHECK_FRAMES, seed)
    for unit in range(calls):
        batch = torch.full((per_call, 2, 3, 3), unit % 251, dtype=torch.uint8)
        keep.offer(unit, batch.numpy() if host else batch)
    return keep


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 7, 4_000_000_007])
def test_one_frame_from_each_of_many_calls(seed):
    keep = _offer_all(seed, 565)
    units = sorted(u for u, _, _ in keep.items)
    assert keep.n == 565 and len(units) == judge.CHECK_FRAMES
    assert len(set(units)) == judge.CHECK_FRAMES          # 16 calls
    assert units[-1] - units[0] > 200                      # across the run
    assert len({j for _, j, _ in keep.items}) > 4          # frames vary
    for unit, j, frame in keep.items:
        assert 0 <= j < 32 and tuple(frame.shape) == (2, 3, 3)
        assert int(frame.max()) == unit % 251


def test_the_same_seed_keeps_the_same_frames():
    a, b = _offer_all(9, 300), _offer_all(9, 300)
    assert [(u, j) for u, j, _ in a.items] == [(u, j) for u, j, _ in b.items]
    c = _offer_all(10, 300)
    assert [(u, j) for u, j, _ in a.items] != [(u, j) for u, j, _ in c.items]


@pytest.mark.parametrize("host", [False, True])
def test_a_kept_frame_is_a_copy_of_its_batch(host):
    keep = loops.Reservoir(4, 3)
    batch = torch.zeros((8, 2, 2, 3), dtype=torch.uint8)
    batch = batch.numpy() if host else batch
    keep.offer(0, batch)
    batch[:] = 9
    assert int(keep.items[0][2].max()) == 0


def test_fewer_calls_than_the_sample_keeps_each():
    keep = _offer_all(5, 3)
    assert sorted(u for u, _, _ in keep.items) == [0, 1, 2]


def test_the_end_to_end_readers():
    win = loops.Window(start=1.0, end=3.0, issued=64, done=64,
                       latency_s=[i / 1000 for i in range(1, 101)])
    m = run.Measured(win, 2160 * 3840, 7.5)
    assert spec.end_to_end_reader("out_mpps")(m) == pytest.approx(
        64 * 2160 * 3840 / 1e6 / 2.0)
    assert spec.end_to_end_reader("out_mpps.host")(m) == \
        spec.end_to_end_reader("out_mpps")(m)
    assert spec.end_to_end_reader("frame_p95_ms")(m) == pytest.approx(
        float(np.percentile(win.latency_s, 95)) * 1e3)
    assert spec.end_to_end_reader("setup_s")(m) == 7.5
    empty = run.Measured(loops.Window(start=0.0, end=1.0), 4, 1.0)
    assert spec.end_to_end_reader("frame_p95_ms")(empty) is None
