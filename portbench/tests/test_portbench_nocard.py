"""Without a card the measurement path measures nothing."""

from __future__ import annotations

import os
import subprocess
import sys

from portbench import spec


def _run(*args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m", "portbench", *args],
                          cwd=spec.ROOT, env=env, capture_output=True,
                          text=True, timeout=300)


def test_no_card_no_result():
    p = _run("--workload", "batch1080p.tensor", "--seed", "4294967311",
             "--seconds", "1", "--trace", "0")
    assert p.returncode == 2, p.stderr
    assert "{" not in p.stdout
    assert "nothing is measured on the CPU" in p.stderr


def test_an_unknown_cell_exits_non_zero():
    p = _run("--workload", "no.such.cell", "--seed", "1", "--seconds", "1")
    assert p.returncode != 0 and "{" not in p.stdout
