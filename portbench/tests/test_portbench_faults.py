"""A run with the timed path broken underneath comes out not correct.

The harness is driven on the CPU, past its look for a card, through the
program's plain path at a small size; each fault the cells can have is
planted in the program's pipeline: an answer altered where it is made,
half of a batch left out (its frames given the other half's results), a
frame the stream drops.
"""

from __future__ import annotations

import pytest
import torch

from portbench import run

CELLS = ["batch1080p.tensor", "batch1080p.host", "stream4k30.host",
         "single.host"]


def _plant(monkeypatch, fault):
    from srcnn_cpp_tpu_torch import pipeline, stream

    real = pipeline.upscale_planar

    def broken(bgr_p, weights, out_hw):
        return fault(real, bgr_p, weights, out_hw)

    monkeypatch.setattr(pipeline, "upscale_planar", broken)
    monkeypatch.setattr(stream, "upscale_planar", broken)


def altered(real, bgr_p, weights, out_hw):
    out = real(bgr_p, weights, out_hw).clone()
    out[:, 1, 5:9, 7:15] += 7
    return out


def half_left_out(real, bgr_p, weights, out_hw):
    b = bgr_p.shape[0]
    half = real(bgr_p[:(b + 1) // 2], weights, out_hw)
    return torch.cat([half, half])[:b]


def _run(small_cell, name, seed=2 ** 31 + 99, seconds=0.3):
    return run.run_cell(small_cell(name), seed, seconds, False, "cpu")


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(small_cell, name):
    r = _run(small_cell, name)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0, r
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {m["name"]
                                 for m in small_cell(name).end_to_end}
    assert all(m["value"] > 0 for m in r["metrics"].values())


@pytest.mark.parametrize("name", CELLS)
def test_an_altered_answer_is_not_correct(small_cell, monkeypatch, name):
    _plant(monkeypatch, altered)
    r = _run(small_cell, name)
    assert not r["correct"] and r["checks"]["max_lsb"]["value"] == 7, r


@pytest.mark.parametrize("name", ["batch1080p.tensor", "batch1080p.host"])
def test_half_the_batch_left_out_is_not_correct(small_cell, monkeypatch,
                                                name):
    _plant(monkeypatch, half_left_out)
    # one frame of each of 16 sampled calls: a window of well over 16
    # calls misses the half left out with odds 2**-16
    r = _run(small_cell, name, seconds=2.0)
    assert not r["correct"], r


def test_a_dropped_frame_is_not_correct(small_cell, monkeypatch):
    from srcnn_cpp_tpu_torch.stream import StreamUpscaler

    real, count = StreamUpscaler.push, {"n": 0}

    def push(self, frame):
        count["n"] += 1
        return None if count["n"] % 2 == 0 else real(self, frame)

    monkeypatch.setattr(StreamUpscaler, "push", push)
    r = _run(small_cell, "stream4k30.host", seconds=1.0)
    assert not r["correct"] and r["failed"] > 0, r
