"""The LSH cell through ``rpbench/run.py`` on the card, as the benchmark
runs it, with a short window: one JSON line, ``correct`` true, and traced,
its four per-layer metrics, K5's and K4's shares of their rooflines
between 0 and 100%.  Skips where there is no CUDA card."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_the_lsh_cell_runs_correct_on_the_card(trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the cells run on the card only")
    r = subprocess.run(
        [sys.executable, "rpbench/run.py", "--workload",
         "config4_lsh_probes16", "--seed", str(2**31 + 103), "--seconds",
         "3", "--trace", str(trace)],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"
    if trace:
        got = out["metrics"]
        assert set(got) == {"k5_roofline", "k4_roofline", "lsh_host_ms",
                            "device_idle_pct.queries"}, got
        assert 0 < got["k5_roofline"]["value"] <= 100
        assert 0 < got["k4_roofline"]["value"] <= 100
    else:
        assert out["metrics"]["queries_per_s"]["value"] > 0
