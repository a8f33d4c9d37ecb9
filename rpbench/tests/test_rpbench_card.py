"""Each cell through ``rpbench/run.py`` on the card, as the benchmark runs
it, with a short window: one JSON line, ``correct`` true, the cell's
metrics.  Skips where there is no CUDA card."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
CELLS = ["config2_resident", "config4_bulk", "config4_open_loop",
         "config2_streamed"]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_runs_correct_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the cells run on the card only")
    r = subprocess.run(
        [sys.executable, "rpbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 101), "--seconds", "2", "--trace", str(trace)],
        cwd=REPO, capture_output=True, text=True, timeout=360)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert out["metrics"]
