"""``k4_wave_fill``: the reader and the program's counter it reads, on the
CPU (kept only while a profiler records and cleared with the span store; a
program without the counter gives nothing; the plain version on the CPU
launches nothing, so a toy cell's line leaves the metric out), and on the
card each config-4 cell's traced line carrying it."""

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
from rpbench.tests.test_rpbench_harness import TOY  # noqa: E402
from randomprojection_tpu_torch.utils import observability  # noqa: E402

CPU = torch.device("cpu")
CELLS = {"config4_open_loop": ("k4_wave_fill.serve", "p99_latency_ms"),
         "config4_bulk": ("k4_wave_fill.queries", "queries_per_s")}


@pytest.fixture(autouse=True)
def _empty_store():
    observability.clear_spans()
    yield
    observability.clear_spans()


def _read(cell):
    ctx = harness.Context(cell, 1, CPU, True, TOY[cell])
    return harness.metric_module(CELLS[cell][0]).read(ctx)


def test_each_entry_names_its_cell_in_the_kernels_layer():
    entries = {e["name"]: e for e in harness.benchmark()["per_layer"]}
    layer = entries["k4_roofline"]["layer"]
    for cell, (name, moves) in CELLS.items():
        e = entries[name]
        assert (e["unit"], e["better"], e["source"]) == \
            ("%", "higher", "program_counter")
        assert (e["layer"], e["moves"], e["workloads"]) == (layer, moves,
                                                            [cell])
        assert e in harness.per_layer(cell, [moves])


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_reader_takes_blocks_over_wave_slots(cell):
    with profile(activities=[ProfilerActivity.CPU]):
        observability.count_waves("topk_mma_kernel", 132, 132)
        observability.count_waves("topk_mma_kernel", 32, 132)
        observability.count_waves("another_kernel", 1, 132)
    assert _read(cell) == pytest.approx(100.0 * 164 / 264)


def test_the_counter_holds_only_what_a_profiler_saw():
    observability.count_waves("topk_mma_kernel", 32, 132)
    assert _read("config4_open_loop") is None
    with profile(activities=[ProfilerActivity.CPU]):
        observability.count_waves("topk_mma_kernel", 528, 528)
    assert _read("config4_open_loop") == pytest.approx(100.0)
    observability.clear_spans()
    assert _read("config4_open_loop") is None


def test_a_program_without_the_counter_gives_nothing(monkeypatch):
    monkeypatch.delattr(observability, "launch_waves")
    for cell in CELLS:
        assert _read(cell) is None


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_toy_cell_on_the_cpu_leaves_the_metric_out(cell):
    out = harness.run_cell(cell, 2**31 + 41, 0.3, True,
                           t_start=time.perf_counter(), device=CPU,
                           overrides=TOY[cell])
    assert out["correct"] is True, out["checks"]
    assert CELLS[cell][0] not in out["metrics"]
    assert observability.launch_waves() == {}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_traced_cell_on_the_card_reads_its_wave_fill(cell):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the cells run on the card only")
    r = subprocess.run(
        [sys.executable, "rpbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 211), "--seconds", "2", "--trace", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=360)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert 0 < out["metrics"][CELLS[cell][0]]["value"] <= 100
