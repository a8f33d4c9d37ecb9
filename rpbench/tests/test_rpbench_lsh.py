"""The LSH cell ``config4_lsh_probes16`` on the CPU at toy size: through
``run.py``, traced and not, on both rungs; the controls that must read not
correct; the parent's refusal; K5's bytes; and the reference's copy that
the port's tests use."""

from __future__ import annotations

import io
import json
import sys
import time
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from rpbench import harness, probe_roofline, run  # noqa: E402
from rpbench.drivers import lsh_bulk  # noqa: E402

CPU = torch.device("cpu")
CELL = "config4_lsh_probes16"
TOY = {"config": {"n_codes": 20000},
       "traffic": {"call_queries": 256, "pool_calls": 3, "keep_calls": 2,
                   "check_tiles": 4}}
SEEDS = (3, 2**31 + 11)


def _toy(path="auto"):
    return {**TOY, "config": {**TOY["config"], "probe_path": path}}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("path", ["auto", "device"])
def test_the_cell_runs_through_run_py_and_is_correct(monkeypatch, trace,
                                                     path):
    real = harness.run_cell

    def on_cpu(cell, seed, seconds, trace, *, t_start):
        return real(cell, seed, seconds, trace, t_start=t_start, device=CPU,
                    overrides=_toy(path))

    monkeypatch.setattr(harness, "run_cell", on_cpu)
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = run.main(["--workload", CELL, "--seed", str(2**31 + 5),
                       "--seconds", "0.3", "--trace", str(trace)])
    assert rc == 0
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out["checks"]) == ["lsh_mismatches", "lsh_fallback_tiles",
                                   "recall_miss"]
    if trace:
        # no card: the device metrics stay silent, the host's is read
        assert set(out["metrics"]) == {"lsh_host_ms"}
        assert out["metrics"]["lsh_host_ms"]["value"] > 0
    else:
        assert set(out["metrics"]) == {"queries_per_s", "setup_s"}


def _checks(seed):
    """The checks of one toy run, and of each control on that run's
    answers: ``{control: {name: (value, limit)}}``, None the program's."""
    ctx = harness.Context(CELL, seed, CPU, False, TOY)
    drv = lsh_bulk.Driver(ctx)
    try:
        drv.setup()
        drv.window(0.2)
        drv.release()
        return {c: {n: (v, lim) for n, v, lim in drv.check(control=c)}
                for c in (None,) + lsh_bulk.CONTROLS}
    finally:
        drv.close()


@pytest.mark.parametrize("seed", SEEDS)
def test_the_controls_read_not_correct(seed):
    got = _checks(seed)
    sound = got[None]
    assert all(v <= lim for v, lim in sound.values()), sound
    for control in ("ties", "band"):
        assert got[control]["lsh_mismatches"][0] > 0, (control, got)
    # the exact answer reads not correct wherever recall is short of 1
    exact = got["exact"]
    assert exact["recall_miss"][0] == 0.0
    assert (exact["lsh_mismatches"][0] > 0) == (sound["recall_miss"][0] > 0)


def test_a_program_without_the_card_build_stops_before_any_code(monkeypatch):
    from randomprojection_tpu_torch.ops import probe_kernels

    monkeypatch.delattr(probe_kernels, "fold_band_csr")
    made = []
    monkeypatch.setattr(lsh_bulk, "make_codes",
                        lambda ctx: made.append(1))
    ctx = harness.Context(CELL, 1, CPU, False, TOY)
    t0 = time.perf_counter()
    with pytest.raises(ImportError):
        lsh_bulk.Driver(ctx).setup()
    assert made == [] and time.perf_counter() - t0 < 5


def test_k5_bytes_give_the_published_bound():
    # PERF.md: the bench tile (64 queries x 8 bands x 16 probes, 137,832
    # ids gathered, 2^19 slots) moves 2.72 MB, 0.000811 ms at 3.35 TB/s
    nbytes = probe_roofline.k5_bytes(64, 8, 16, 137_832, 1 << 19)
    assert nbytes == 2_716_672
    assert probe_roofline.k5_bound_s(64, 8, 16, 137_832, 1 << 19) * 1e3 == \
        pytest.approx(0.000811, abs=5e-7)
    # each term once: a run reads two indptr words, an id one word
    assert probe_roofline.k5_bytes(1, 1, 2, 5, 8) - \
        probe_roofline.k5_bytes(1, 1, 1, 5, 8) == 4 + 8


def test_k5_roofline_reads_the_counted_launches(monkeypatch):
    from randomprojection_tpu_torch.utils import observability

    reader = harness.metric_module("k5_roofline")
    ctx = harness.Context(CELL, 1, CPU, True, TOY)
    ctx.layer["trace"] = {"kernels": {
        "probe_runs_kernel(ProbeArgs, long long*)": [2, 1e-6],
        "probe_copy_kernel(ProbeArgs, int*)": [2, 3e-6],
        "topk_mma_kernel": [2, 1.0]}}
    monkeypatch.setattr(observability, "probe_launches",
                        lambda: [(64, 8, 16, 137_832, 1 << 19)] * 2)
    assert reader.read(ctx) == pytest.approx(
        100 * 2 * 8.1095e-7 / 4e-6, rel=1e-3)
    # a program without the counter, or a window without a launch: silent
    monkeypatch.setattr(observability, "probe_launches", lambda: [])
    assert reader.read(ctx) is None
    monkeypatch.delattr(observability, "probe_launches")
    assert reader.read(ctx) is None


def test_k4_roofline_reads_the_lsh_rerank():
    from randomprojection_tpu_torch.utils import telemetry

    reg = telemetry.registry()
    ctx = harness.Context(CELL, 5, CPU, True, TOY)
    drv = lsh_bulk.Driver(ctx)
    try:
        drv.setup()
        c0 = reg.counter("index.lsh.candidates")
        drv.window(0.2)
        cands = reg.counter("index.lsh.candidates") - c0
    finally:
        drv.close()
    k4 = ctx.layer["k4"]
    (tile, tiles), = k4["tiles"]
    # every query of the window's calls, in tiles of 64, each over the
    # window's mean candidate union
    assert tile == 64 and tiles * tile == drv.attempted
    assert k4["n_codes"] == pytest.approx(cands / tiles)
    assert 0 < k4["n_codes"] < 0.1 * TOY["config"]["n_codes"]
    assert (k4["n_bytes"], k4["m"]) == (32, 10)
    from rpbench import roofline

    ctx.layer["trace"] = {"kernels": {"topk_mma_kernel": [tiles, 0.5],
                                      "topk_merge_kernel": [tiles, 0.5]}}
    want = 100 * tiles * roofline.k4_bound_s(64, k4["n_codes"], 32, 10)
    assert harness.metric_module("k4_roofline").read(ctx) == \
        pytest.approx(want)


def test_the_ports_tests_hold_a_copy_of_the_reference():
    ours = (REPO / "rpbench" / "reference" / "lsh_topk.py").read_bytes()
    assert (REPO / "tests" / "lsh_topk_reference.py").read_bytes() == ours
