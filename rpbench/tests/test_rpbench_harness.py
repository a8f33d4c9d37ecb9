"""The harness on the CPU: files found by name, the result line, the
module check, the yardstick's arithmetic, and runs of each cell at toy
sizes with the kernels' plain versions."""

from __future__ import annotations

import ast
import io
import json
import shutil
import sys
import time
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from rpbench import harness, roofline, run, schedule  # noqa: E402

CPU = torch.device("cpu")
TOY = {
    "config2_resident": {"config": {"n_features": 512, "n_components": 64},
                         "traffic": {"rows": 1024, "batch_rows": 256,
                                     "keep_batches": 3}},
    "config2_streamed": {"config": {"n_features": 512, "n_components": 64},
                         "traffic": {"job_rows": 1024, "batch_rows": 256,
                                     "keep_batches": 3}},
    "config4_bulk": {"config": {"n_codes": 6000, "query_tile": 32},
                     "traffic": {"call_queries": 64, "pool_calls": 2,
                                 "check_queries": 48}},
    "config4_open_loop": {"config": {"n_codes": 6000},
                          "traffic": {"rate_rps": 40, "warm_rows_max": 64,
                                      "check_rows": 48}},
}
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def toy_run(cell, *, seconds=0.3, trace=False, seed=2**31 + 17):
    return harness.run_cell(cell, seed, seconds, trace,
                            t_start=time.perf_counter(), device=CPU,
                            overrides=TOY[cell])


def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", sorted(TOY))
def test_each_cell_runs_and_is_correct_at_toy_size(cell):
    out = toy_run(cell)
    assert list(out) == RESULT_KEYS + ["checks"]
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    want = {e["name"] for e in bench()["end_to_end"]
            if cell in e.get("workloads", [cell])}
    assert set(out["metrics"]) == want
    assert all(v["value"] > 0 for v in out["metrics"].values())


def test_every_cell_of_the_benchmark_has_its_files():
    b = bench()
    assert sorted(w["name"] for w in b["workloads"]) == harness.names(
        "workloads")
    for w in b["workloads"]:
        f = harness.load("workloads", w["name"])
        assert (f["config"], f["traffic"], f["chips"]) == (
            w["config"], w["traffic"], w["chips"])
        harness.load("traffic", w["traffic"])
    for c in b["configs"]:
        assert json.loads((REPO / c["file"]).read_text())["name"] == c["name"]
        assert sorted(c["reduced"]) == sorted(
            json.loads((REPO / c["file"]).read_text())["reduced"])
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert callable(harness.metric_module(m["name"]).read), m["name"]
        assert m["moves"] in e2e
    # every reader serves some entry
    readers = {m["name"] if (harness.ROOT / "metrics" / f"{m['name']}.py")
               .is_file() else m["name"].split(".")[0]
               for m in b["per_layer"]}
    assert readers == set(harness.names("metrics", ".py"))


def test_a_cell_reads_only_the_metrics_that_name_it():
    got = {w["name"]: [m["name"] for m in harness.per_layer(w["name"], ())]
           for w in bench()["workloads"]}
    assert got["config2_resident"] == [
        "k1_roofline", "backend_issue_ms", "device_idle_pct.rows"]
    assert got["config4_open_loop"] == [
        "serve_rows_per_batch", "device_idle_pct.serve"]
    # one reader stands for each cell's idle share
    assert harness.metric_module("device_idle_pct.rows").__file__ == \
        harness.metric_module("device_idle_pct.serve").__file__


def test_the_benchmark_file_keeps_the_contract_limits():
    b = bench()
    assert len(json.dumps(b)) < 64 * 1024
    for entry in b["configs"] + b["workloads"]:
        assert 1 <= len(entry["why"]) <= 200, entry["name"]
    for c in b["configs"]:
        assert 1 <= len(c["source"]) <= 200
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}


def test_a_dropped_in_cell_and_metric_are_found(tmp_path, monkeypatch):
    root = tmp_path / "rpbench"
    shutil.copytree(harness.ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "traffic" / "resident_small.json").write_text(json.dumps(
        {"rows": 512, "batch_rows": 256, "keep_batches": 2}))
    (root / "workloads" / "config2_small.json").write_text(json.dumps(
        {"config": "config2_sparse_rp", "traffic": "resident_small",
         "driver": "resident_projection", "chips": 1}))
    (root / "metrics" / "passes_seen.py").write_text(
        "def read(ctx):\n    return ctx.layer['k1_rows']['rows']\n")
    b = bench()
    b["per_layer"].append(
        {"name": "passes_seen", "unit": "rows", "better": "higher",
         "source": "program_counter", "layer": "harness",
         "moves": "rows_per_s", "workloads": ["config2_small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    monkeypatch.setattr(harness, "ROOT", root)
    assert "config2_small" in harness.names("workloads")
    small = {"config": {"n_features": 512, "n_components": 64}}
    out = harness.run_cell(
        "config2_small", 5, 0.2, True, t_start=time.perf_counter(),
        device=CPU, overrides=small)
    assert out["correct"] is True
    assert out["metrics"]["passes_seen"]["value"] % 512 == 0
    assert out["metrics"]["passes_seen"]["unit"] == "rows"
    # the cell that was there before reads the same metrics as it did
    old = harness.run_cell(
        "config2_resident", 5, 0.2, True, t_start=time.perf_counter(),
        device=CPU, overrides=TOY["config2_resident"])
    assert "passes_seen" not in old["metrics"]


def test_the_traced_line_carries_the_layer_metrics():
    out = toy_run("config2_resident", trace=True)
    assert list(out) == RESULT_KEYS + ["breakdown", "checks"]
    assert "backend_issue_ms" in out["metrics"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    # no card, so nothing ran on a device: the device metrics stay silent
    assert "k1_roofline" not in out["metrics"]
    assert "device_idle_pct.rows" not in out["metrics"]


def test_run_prints_the_checks_last_and_one_json_line(monkeypatch, capsys):
    real = harness.run_cell

    def on_cpu(cell, seed, seconds, trace, *, t_start):
        return real(cell, seed, seconds, trace, t_start=t_start, device=CPU,
                    overrides=TOY[cell])

    monkeypatch.setattr(harness, "run_cell", on_cpu)
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = run.main(["--workload", "config2_resident", "--seed",
                       str(2**31 + 5), "--seconds", "0.2", "--trace", "0"])
    assert rc == 0
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert list(line) == RESULT_KEYS + ["checks"]
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-1].startswith("check max_rel_gap:") and "limit" in err[-1]


def test_run_without_a_card_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs a machine without")
    assert run.main(["--workload", "config2_resident", "--seed", "1",
                     "--seconds", "1"]) == 3
    assert capsys.readouterr().out == ""


def test_the_module_check_compares_whole_top_level_names():
    assert harness.forbidden_modules(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
         "randomprojection_tpu.ops", "os"]) == [
        "flax", "jax", "jaxlib", "randomprojection_tpu"]
    assert harness.forbidden_modules(
        ["randomprojection_tpu_torch", "randomprojection_tpu_torch.ops",
         "jaxtyping", "flaxen", "torch"]) == []


def test_the_schedule_repeats_and_a_seed_only_reorders_it():
    kw = dict(seed=7, duration_s=3.0, rate_qps=120.0)
    a, b = schedule.build_schedule(**kw), schedule.build_schedule(**kw)
    assert schedule.schedule_digest(a) == schedule.schedule_digest(b)
    r1, r2 = schedule.reorder(a, 1), schedule.reorder(a, 2)
    assert schedule.schedule_digest(r1) != schedule.schedule_digest(r2)
    for r in (r1, r2):
        assert len(r) == len(a)
        assert sorted((x.rows, x.label) for x in r) == sorted(
            (x.rows, x.label) for x in a)
        assert r[-1].t == pytest.approx(a[-1].t)


def test_the_rooflines_give_the_published_bounds():
    # PERF.md: K1 split2 at 65,536 x 4096 -> 256 is bound by bytes at
    # 0.341 ms; K4 at 2,048 x 2**24 x 32 B by operations at 1.111 ms
    assert roofline.k1_bound_s(65536, 4096, 256, 1 / 3) * 1e3 == \
        pytest.approx(0.3406, abs=5e-4)
    assert roofline.k4_bound_s(2048, 1 << 24, 32, 16) * 1e3 == \
        pytest.approx(1.111, abs=5e-4)


def test_the_reference_imports_nothing_of_the_program_or_jax():
    bad = {"jax", "jaxlib", "flax", "randomprojection_tpu",
           "randomprojection_tpu_torch"}
    found = []
    for path in (harness.ROOT / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            found += [(path.name, m) for m in mods if m.split(".")[0] in bad]
    assert found == []


def test_the_harness_imports_no_jax():
    for path in harness.ROOT.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0] in ("jax", "jaxlib", "flax",
                                               "randomprojection_tpu")
                           for n in names), path


def test_the_trace_reduction_merges_and_names_gaps():
    from rpbench import trace

    assert trace.merge([(5, 7), (0, 2), (1, 3), (6, 9)]) == [[0, 3], [5, 9]]
    assert trace.idle_pct({"window_s": 2.0, "busy_s": 1.5}) == \
        pytest.approx(25.0)
    assert trace.idle_pct({"window_s": 2.0, "busy_s": 0.0}) is None
    red = {"kernels": {"void fused_project_kernel<1>(x)": [3, 0.3],
                       "mask_writer_kernel": [3, 0.01],
                       "Memcpy DtoD": [1, 0.5]}}
    n, s = trace.kernel_seconds(red, "fused_project_kernel",
                                "mask_writer_kernel")
    assert n == 6 and s == pytest.approx(0.31)
    assert trace.kernel_seconds(red, "topk_mma_kernel") is None

