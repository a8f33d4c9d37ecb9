"""The readers of the program's spans, at toy sizes on the CPU: a traced
run of each cell they serve gives every one of them a value
(``gc_pause_pct.serve`` a share between 0 and 100), an untraced run
leaves the program's span store empty, and on the card each traced cell's
line carries them."""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from rpbench import harness, spans  # noqa: E402
from rpbench.tests.test_rpbench_harness import TOY  # noqa: E402
from randomprojection_tpu_torch.utils import observability  # noqa: E402

CPU = torch.device("cpu")
READ = {
    "config4_open_loop": ["serve_queue_wait_ms", "serve_host_ms",
                          "gc_pause_pct.serve"],
    "config4_bulk": ["index_host_ms"],
    "config2_resident": ["backend_dispatch_ms"],
}


def _run(cell, trace):
    observability.clear_spans()
    return harness.run_cell(cell, 2**31 + 29, 0.3, trace,
                            t_start=time.perf_counter(), device=CPU,
                            overrides=TOY[cell])


def test_each_reader_serves_the_cells_it_names():
    for entry in harness.benchmark()["per_layer"]:
        if entry["name"] in sum(READ.values(), []):
            assert entry["source"] == "program_span"
            assert [c for c, names in READ.items()
                    if entry["name"] in names] == entry["workloads"]


@pytest.mark.parametrize("cell", sorted(READ))
def test_a_traced_cell_reads_its_program_spans(cell):
    out = _run(cell, True)
    assert out["correct"] is True, out["checks"]
    for name in READ[cell]:
        assert out["metrics"][name]["value"] is not None, name
        assert out["metrics"][name]["value"] >= 0, name
    if cell == "config4_open_loop":
        assert 0 <= out["metrics"]["gc_pause_pct.serve"]["value"] <= 100
        # one queue wait a request of the window
        waits = spans.named("rp:serve/queue_wait")
        assert len(waits) == out["attempted"]


@pytest.mark.parametrize("cell", sorted(READ))
def test_an_untraced_cell_leaves_the_store_empty(cell):
    out = _run(cell, False)
    assert out["correct"] is True, out["checks"]
    assert observability.recorded_spans() == []
    assert observability.dropped_spans() == 0


def test_self_time_takes_out_the_waits_on_its_own_thread(monkeypatch):
    stored = [("rp:serve/batch", 1, 0, 100),
              ("rp:index/wait_tile", 1, 10, 30),
              ("rp:index/wait_tile", 1, 20, 40),   # overlaps the one before
              ("rp:index/wait_tile", 1, 90, 120),  # runs past the batch
              ("rp:index/wait_tile", 2, 50, 60),   # another thread
              ("rp:serve/batch", 2, 200, 300)]
    monkeypatch.setattr(observability, "recorded_spans", lambda: stored)
    got = spans.self_times_s("rp:serve/batch")
    assert got == pytest.approx([(100 - 30 - 10) / 1e9, 100 / 1e9])


def test_a_program_without_the_store_gives_nothing(monkeypatch):
    monkeypatch.delattr(observability, "recorded_spans")
    assert spans.named("rp:serve/batch") is None
    assert spans.self_times_s("rp:serve/batch") is None
    assert spans.gc_wall_s() is None
    ctx = harness.Context("config4_open_loop", 1, CPU, True,
                          TOY["config4_open_loop"])
    ctx.layer["trace"] = {"window_s": 1.0}
    for names in READ.values():
        for name in names:
            assert harness.metric_module(name).read(ctx) is None, name


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(READ))
def test_a_traced_cell_on_the_card_prints_its_span_metrics(cell):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the cells run on the card only")
    r = subprocess.run(
        [sys.executable, "rpbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 103), "--seconds", "2", "--trace", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=360)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    for name in READ[cell]:
        assert out["metrics"][name]["value"] is not None, name
