"""``k4_bound_share``: the reader and the program's counter it reads, on
the CPU (kept only while a profiler records and cleared with the span
store; a program without the counter, or a window with no tensor-core
scan, gives nothing; the plain version on the CPU scans nothing on the
tensor cores, so a toy cell's line leaves the metric out), and on the
card each of its cells' traced line carrying it."""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from rpbench import harness  # noqa: E402
from rpbench.tests import test_rpbench_lsh  # noqa: E402
from rpbench.tests.test_rpbench_harness import TOY  # noqa: E402
from randomprojection_tpu_torch.utils import observability  # noqa: E402

CPU = torch.device("cpu")
NAME = "k4_bound_share.queries"
CELLS = {"config4_bulk": TOY["config4_bulk"],
         "config4_lsh_probes16": test_rpbench_lsh.TOY}


@pytest.fixture(autouse=True)
def _empty_store():
    observability.clear_spans()
    yield
    observability.clear_spans()


def _read(cell="config4_bulk"):
    ctx = harness.Context(cell, 1, CPU, True, CELLS[cell])
    return harness.metric_module(NAME).read(ctx)


def test_the_entry_names_both_cells_in_the_kernels_layer():
    entries = {e["name"]: e for e in harness.benchmark()["per_layer"]}
    e = entries[NAME]
    assert (e["unit"], e["better"], e["source"], e["moves"]) == \
        ("%", "higher", "program_counter", "queries_per_s")
    assert e["layer"] == entries["k4_roofline"]["layer"]
    assert e["workloads"] == sorted(CELLS)
    for cell in CELLS:
        assert e in harness.per_layer(cell, ["queries_per_s"])
    assert e not in harness.per_layer("config4_open_loop", ["p99_latency_ms"])


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_reader_takes_tightened_row_tiles_over_row_tiles(cell):
    with profile(activities=[ProfilerActivity.CPU]):
        observability.count_survivors(64 * 128, (9_000, 300, 64 * 32, 1_600))
        observability.count_survivors(2048 * 33, (90_000, 4_000,
                                                  2048 * 118_372, 2 * 10**8))
    assert _read(cell) == pytest.approx(
        100 * (1_600 + 2 * 10**8) / (64 * 32 + 2048 * 118_372))


def test_the_counter_holds_only_what_a_profiler_saw():
    observability.count_survivors(16, (400, 20, 100, 25))
    assert _read() is None
    with profile(activities=[ProfilerActivity.CPU]):
        observability.count_survivors(16, (400, 20, 100, 25))
    assert _read() == pytest.approx(25.0)
    observability.clear_spans()
    assert _read() is None


def test_a_scan_counted_without_row_tiles_gives_nothing():
    with profile(activities=[ProfilerActivity.CPU]):
        observability.count_survivors(16, (400, 20))
    assert _read() is None


def test_a_program_without_the_counter_gives_nothing(monkeypatch):
    monkeypatch.delattr(observability, "bound_counts")
    for cell in CELLS:
        assert _read(cell) is None


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_toy_cell_on_the_cpu_leaves_the_metric_out(cell):
    out = harness.run_cell(cell, 2**31 + 47, 0.3, True,
                           t_start=time.perf_counter(), device=CPU,
                           overrides=CELLS[cell])
    assert out["correct"] is True, out["checks"]
    assert NAME not in out["metrics"]
    assert observability.bound_counts() == (0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_traced_cell_on_the_card_reads_its_bound_share(cell):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the cells run on the card only")
    r = subprocess.run(
        [sys.executable, "rpbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 227), "--seconds", "2", "--trace", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    # both cells' scans run many splits a query, and the bound binds
    assert 0 < out["metrics"][NAME]["value"] <= 100
