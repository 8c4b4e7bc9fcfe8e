"""Each cell end to end on the card, short: the command as the benchmark
runs it, its last line, and the control of each cell at the cell's own
size failing. Needs a CUDA card; skips without one.

    python3 -m pytest sdrbench/tests/test_sdrbench_card.py
"""

import json
import subprocess
import sys

import pytest
import torch

from sdrbench import run as R

CELLS = [w["name"] for w in R.load_spec()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _run(cell, seed, system="program", trace=0, seconds=3):
    out = subprocess.run(
        [sys.executable, "-m", "sdrbench.run", "--workload", cell,
         "--seed", str(seed), "--seconds", str(seconds), "--trace",
         str(trace), "--system", system],
        cwd=R.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell):
    res = _run(cell, 2 ** 31 + 101)
    assert res["correct"], res["compared"]
    assert res["device"]["platform"] == "gpu"
    traced = _run(cell, 2 ** 31 + 102, trace=1)
    assert traced["correct"] and traced["device"]["busy_s"] > 0
    assert traced["metrics"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(card, cell):
    res = _run(cell, 2 ** 31 + 103, system="control",
               seconds=20 if cell.endswith(".live") else 3)
    assert not res["correct"], res["compared"]
