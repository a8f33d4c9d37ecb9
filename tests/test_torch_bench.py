"""The port's bench (``randomprojection_tpu_torch/benchmark.py``) against
the JAX package's.

On the CPU, at small shapes: the pure functions give the reference's
outputs; the record I/O reads the committed ``BENCH_r*.json`` as the
reference does, and the reference reads the port's compact line; a whole
``run(device='cpu')`` at toy shapes has the reference's keys, plus the
stated additions and minus the stated absences, with every timing flag
set; the LSH curve, the tiered index and config 5 agree with the
reference's at its smoke shapes; config 2's distortion agrees with the
reference's ``measure_distortion`` on the same matrix.
"""

import ast
import functools
import inspect
import json
import os
import re
import textwrap
from pathlib import Path

import numpy as np
import pytest

from randomprojection_tpu import benchmark as ref
from randomprojection_tpu_torch import benchmark as port

REPO = Path(__file__).resolve().parents[1]
RECORDS = sorted(p.name for p in REPO.glob("BENCH_r*.json"))

TOY_TOPK = dict(n_idx=2048, q_tile=128, clients=2, req_rows=16,
                reqs_per_client=2, max_batch=64, shards=2, replicas=2)
TOY_LSH = dict(n_idx=512, n_bytes=8, cluster=8, nq=8, m=5, bands=4,
               band_bits=8, noise_bits=2, probe_counts=(1,), calls=1,
               rerank_tile=8)
TOY_TIER = dict(n_idx=1024, n_bytes=8, nq=8, m=5, calls=1, chunk_rows=256,
                budget_chunks=1, q_tile=8)
TOY_CONFIG3 = dict(batch=64, steps=1, calls=1)

# what the port's record adds to the reference's keys, and what it lacks
ADDED = {
    "run": {"device", "lazy_matrix_launches"},
    "config3": {"event_elapsed_s", "executed_on", "launches"},
    "config4": {"event_elapsed_s", "executed_on", "launches"},
    "topk_serving": {"executed_on", "launches",
                     "int8_timing_suspect",
                     "single_stream_int8_timing_suspect"},
    "sharded": {"executed_on", "launches"},
    "lsh": {"exact_ref_s", "launches"},
    "curve": set(),
    "tiered": {"launches", "resident_launches"},
    "config5": {"sketch_bakeoff_skipped", "first_batch_max_abs_err",
                "first_batch_ok"},
}


def _literal_keys(fn, *, assigned=None, appended=False) -> set:
    """The string keys of the dict literal a reference function returns
    (or assigns to ``assigned``, or appends): read from its source."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    for node in ast.walk(tree):
        value = None
        if assigned and isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == assigned for t in node.targets
        ):
            value = node.value
        elif appended and isinstance(node, ast.Call) and getattr(
            node.func, "attr", None
        ) == "append" and node.args and isinstance(node.args[0], ast.Dict):
            value = node.args[0]
        elif not assigned and not appended and isinstance(node, ast.Return):
            value = node.value
        if isinstance(value, ast.Dict):
            return {k.value for k in value.keys
                    if isinstance(k, ast.Constant)}
    raise AssertionError(f"no dict literal in {fn.__name__}")


# -- pure functions -----------------------------------------------------------

MODES = {
    "fast_bad": {"rows_per_s": 9.0, "distortion": 5e-3, "timing_suspect": False},
    "fast_sus": {"rows_per_s": 8.0, "distortion": 1e-6, "timing_suspect": True},
    "ok_slow": {"rows_per_s": 2.0, "distortion": 1e-5, "timing_suspect": False},
    "ok_fast": {"rows_per_s": 3.0, "distortion": 9e-4, "timing_suspect": False},
}


@pytest.mark.parametrize("names", [
    ("fast_bad", "fast_sus", "ok_slow", "ok_fast"),
    ("fast_bad", "fast_sus"),
    ("fast_sus",),
    ("fast_bad",),
])
@pytest.mark.parametrize("budget", [1e-3, 1e-6])
def test_select_headline_equals_the_reference(names, budget):
    results = {n: MODES[n] for n in names}
    assert port.select_headline(results, budget) == ref.select_headline(
        results, budget)


@pytest.mark.parametrize("elapsed,passes", [
    ((1.0, 1.05, 1.1), (1, 2, 3)),
    ((1.0, 2.0, 3.0), (1, 2, 3)),
    ((1.0, 1.01), (1, 1)),
    ((1.0,), (1,)),
    ((0.0, 0.0), (1, 3)),
])
def test_detect_pass_invariance_equals_the_reference(elapsed, passes):
    results = {f"m{i}": {"elapsed_s": e} for i, e in enumerate(elapsed)}
    mp = {f"m{i}": p for i, p in enumerate(passes)}
    assert port.detect_pass_invariance(results, mp) == \
        ref.detect_pass_invariance(results, mp)


@pytest.mark.parametrize("rates", [
    (10.0, 11.0, 12.0),
    (10.0, 1.0, 12.0, 11.0, 13.0, 14.0, 15.0),
    (1.0, 10.0, 1.0, 1.0, 10.0, 1.0, 1.0, 1.0),
    (0.0, 0.0, 0.0),
])
def test_host_best_of_equals_the_reference(rates):
    def sampler():
        it = iter(rates)
        return lambda: next(it)

    assert port._host_best_of(sampler()) == ref._host_best_of(sampler())


def test_pdist2_and_fold_cols_equal_the_reference():
    a = np.random.default_rng(5).normal(size=(40, 7))
    assert np.array_equal(port.pdist2(a), ref.pdist2(a))
    assert np.array_equal(port.pdist2(np.zeros((3, 2))),
                          ref.pdist2(np.zeros((3, 2))))
    for d in (1, 64, 100, 2048, 4096, 16384):
        assert port.harness_fold_cols(d) == ref.harness_fold_cols(d)


def test_shape_tables_are_the_reference():
    assert port.TOPK_BENCH_SHAPES == ref.TOPK_BENCH_SHAPES
    assert port.LSH_BENCH_SHAPES == ref.LSH_BENCH_SHAPES
    assert port.TIER_BENCH_SHAPES == ref.TIER_BENCH_SHAPES
    assert port.PRESETS == ref.PRESETS
    assert port.LSH_RECALL_GATE == ref.LSH_RECALL_GATE
    assert port.LSH_CANDIDATE_FRACTION_GATE == ref.LSH_CANDIDATE_FRACTION_GATE
    assert port.DISTORTION_BUDGET == ref.DISTORTION_BUDGET
    assert (port.COMPACT_MARKER, port.COMPACT_SCHEMA_VERSION,
            port.COMPACT_MAX_BYTES) == (ref.COMPACT_MARKER,
                                        ref.COMPACT_SCHEMA_VERSION,
                                        ref.COMPACT_MAX_BYTES)
    # config 3's harness shapes are the reference's inline ones
    src = re.sub(r"\s+", "", inspect.getsource(ref.measure_config3))
    for preset, cfg in port.CONFIG3_SHAPES.items():
        assert "dict(batch={batch},steps={steps},calls={calls})".format(
            **cfg) in src, preset


def test_peaks_and_the_harness_ceiling():
    # 18,432 bytes a row at d=4096, k=256, float32: 3.35e12 / 18,432
    assert port.harness_hbm_cap_rows_per_s(4096, 256) == pytest.approx(
        3.35e12 / 18432)
    # the same formula as the reference's, at the H100's memory rate
    for d, k, it in ((4096, 256, 4), (4096, 256, 2), (16384, 512, 4)):
        assert port.harness_hbm_cap_rows_per_s(d, k, it) == pytest.approx(
            ref.harness_hbm_cap_rows_per_s(d, k, it) * 3.35e12 / 819e9)
    assert set(port.MODE_ROUTES) == {
        "bf16", "bf16_split2", "f32_high", "lazy", "lazy_split2",
        "lazy_bf16", "lazy_f32_bf16data"}
    assert {u for _, u in port.MODE_ROUTES.values()} <= set(port.PEAKS)


# -- record I/O on the committed records --------------------------------------


def _load(fn, name):
    try:
        return fn(str(REPO / name))
    except (ValueError, json.JSONDecodeError) as e:
        return type(e).__name__


@pytest.mark.parametrize("name", RECORDS)
def test_record_io_equals_the_reference(name):
    got, want = _load(port.load_bench_record, name), _load(
        ref.load_bench_record, name)
    assert got == want
    if isinstance(want, dict):
        assert port.bench_rates(want) == ref.bench_rates(want)
        assert port.compact_summary(want) == ref.compact_summary(want)
    tail = json.loads((REPO / name).read_text()).get("tail", "")
    assert port.find_compact_line(tail) == ref.find_compact_line(tail)

    def recover(mod):
        try:
            return mod.recover_bench_tail(tail)
        except ValueError as e:
            return str(e)

    assert recover(port) == recover(ref)


def test_trajectory_and_regressions_equal_the_reference():
    assert port.bench_trajectory(str(REPO)) == ref.bench_trajectory(str(REPO))
    assert port.committed_bench_paths(str(REPO)) == \
        ref.committed_bench_paths(str(REPO))
    assert port.newest_committed_bench(str(REPO)) == \
        ref.newest_committed_bench(str(REPO))
    assert port.committed_bench_paths() == ref.committed_bench_paths()
    recs = [ref.load_bench_record(str(REPO / n)) for n in RECORDS]
    for prev, cur in zip(recs, recs[1:]):
        assert port.compute_regressions(cur, prev) == \
            ref.compute_regressions(cur, prev)
    for rec in recs:
        a, b = dict(rec), dict(rec)
        assert port.attach_regressions(a, str(REPO)) == \
            ref.attach_regressions(b, str(REPO))


# -- a whole run on the CPU -----------------------------------------------------


@pytest.fixture(scope="module")
def cpu_record():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(port.TOPK_BENCH_SHAPES, "smoke", TOY_TOPK)
        mp.setitem(port.LSH_BENCH_SHAPES, "smoke", TOY_LSH)
        mp.setitem(port.TIER_BENCH_SHAPES, "smoke", TOY_TIER)
        mp.setitem(port.CONFIG3_SHAPES, "smoke", TOY_CONFIG3)
        return port.run(preset="smoke", d=512, k=64, device="cpu")


def test_run_has_the_reference_keys(cpu_record):
    rec = cpu_record
    want = _literal_keys(ref.run, assigned="record") | {
        # the conditional config 3 and attach_regressions' keys
        "config3", "regressions", "regressions_vs", "regressions_skipped"}
    assert set(rec) == want | ADDED["run"]
    assert set(rec["config3"]) == _literal_keys(ref.measure_config3) | \
        ADDED["config3"]
    c4 = rec["config4"]
    assert set(c4) == _literal_keys(ref.measure_config4) | ADDED["config4"]
    tk = c4["topk_serving"]
    assert set(tk) == _literal_keys(ref.measure_config4_topk) | \
        ADDED["topk_serving"]
    # the sharded leg runs (the toy shape's 2 shards x 2 replicas)
    sh = tk["sharded"]
    assert set(sh) == _literal_keys(ref.measure_config4_topk,
                                    assigned="sharded") | ADDED["sharded"]
    assert sh["shards"] == TOY_TOPK["shards"]
    assert sh["replicas"] == TOY_TOPK["replicas"]
    assert len(sh["replica_batches"]) == sh["replicas"]
    assert sh["merges"] >= 1
    assert sh["shard_dispatches"] == sh["merges"] * sh["shards"]
    assert set(tk["lsh"]) == _literal_keys(ref.measure_topk_lsh) | \
        ADDED["lsh"]
    assert set(tk["lsh"]["curve"][0]) == _literal_keys(
        ref.measure_topk_lsh, appended=True)
    assert set(tk["tiered"]) == _literal_keys(ref.measure_topk_tiered) | \
        ADDED["tiered"]
    c5 = rec["config5"]
    assert set(c5) == _literal_keys(ref.measure_config5) | ADDED["config5"]
    # the bake-off lacks the doc-major route, and says why
    assert set(c5["sketch_bakeoff_docs_per_s"]) == {
        "flat_gather_scatter", "packed_gather_floor"}
    assert "docmajor" in c5["sketch_bakeoff_skipped"]
    assert c5["countsketch_kernel"] == "csr_flat_index_add"
    # all seven modes run, with the reference's per-mode keys
    assert set(rec["all_modes"]) == set(port.MODE_ROUTES)
    for mode in rec["all_modes"].values():
        assert {"rows_per_s", "distortion", "elapsed_s", "implied_tflops",
                "executed_tflops", "mxu_utilization",
                "harness_hbm_cap_rows_per_s", "timing_suspect"} <= set(mode)
    assert rec["device"] == "cpu" and rec["transform_dma"] == "auto"
    assert rec["regressions_vs"] is None
    assert "TPU" in rec["regressions_skipped"]


def test_every_timing_flag_is_set_on_the_cpu(cpu_record):
    rec = cpu_record
    assert rec["timing_suspect"] is True
    assert all(m["timing_suspect"] for m in rec["all_modes"].values())
    assert rec["config3"]["timing_suspect"] is True
    c4 = rec["config4"]
    tk = c4["topk_serving"]
    assert c4["timing_suspect"] and tk["timing_suspect"]
    assert tk["single_stream_timing_suspect"] and tk["topk_interpret"]
    assert tk["int8_timing_suspect"] and tk["single_stream_int8_timing_suspect"]
    assert tk["topk_impl"] == "plain"
    assert all(p["timing_suspect"] for p in tk["lsh"]["curve"])
    assert tk["tiered"]["timing_suspect"] is True
    assert tk["sharded"]["timing_suspect"] is True
    c5 = rec["config5"]
    for key in ("sketch_timing_suspect", "pipeline_timing_suspect",
                "prefetch_timing_suspect", "serial_timing_suspect"):
        assert c5[key] is True, key
    # correctness statements still hold on the CPU
    assert rec["config3"]["distortion"] <= port.DISTORTION_BUDGET
    assert c4["sign_mismatch_rate_vs_cpu"] <= 1e-4
    assert tk["tiered"]["parity_ok"] is True
    assert c5["first_batch_ok"] is True


def test_no_kernel_launches_on_the_cpu(cpu_record):
    """Each leg's launch counts are recorded, and on the CPU the wrappers
    run their plain versions: no kernel launches anywhere."""
    rec = cpu_record
    tk = rec["config4"]["topk_serving"]
    legs = [m["launches"] for m in rec["all_modes"].values()] + [
        rec["lazy_matrix_launches"], rec["config3"]["launches"],
        rec["config4"]["launches"], tk["launches"], tk["lsh"]["launches"],
        tk["tiered"]["launches"], tk["tiered"]["resident_launches"],
        tk["sharded"]["launches"]]
    assert legs == [{}] * len(legs)


def test_launch_counts_are_zeroed_and_read_per_leg():
    from randomprojection_tpu_torch.ops import (
        fused_kernels,
        probe_kernels,
        topk_kernels,
    )

    fused_kernels.LAUNCHES["rp_fused_project"] = 3
    topk_kernels.LAUNCHES["rp_topk_merge"] = 2
    probe_kernels.LAUNCHES["rp_probe"] = 1
    try:
        assert port._read_launches() == {
            "rp_fused_project": 3, "rp_topk_merge": 2, "rp_probe": 1}
    finally:
        port._zero_launches()
    assert port._read_launches() == {}
    for mod in (fused_kernels, topk_kernels, probe_kernels):
        assert set(mod.LAUNCHES.values()) == {0}


def test_compact_line_is_read_by_the_reference(cpu_record, capsys):
    port.emit_bench_output(cpu_record)
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-2]) == json.loads(json.dumps(cpu_record))
    last = lines[-1]
    assert len(last.encode()) <= port.COMPACT_MAX_BYTES
    compact = ref.find_compact_line(last)
    assert compact == json.loads(last) == port.find_compact_line(last)
    assert compact["mode"] == cpu_record["mode"]
    assert port.compact_summary(cpu_record) == ref.compact_summary(cpu_record)
    # the sharded leg's digest, as the reference writes it
    c4d = compact["config4"]
    sh = cpu_record["config4"]["topk_serving"]["sharded"]
    assert c4d["topk_sharded_shards"] == sh["shards"]
    assert c4d["topk_sharded_replicas"] == sh["replicas"]
    assert c4d["topk_sharded_timing_suspect"] is True
    assert "config4.topk.sharded_queries_per_s" in ref.bench_rates(cpu_record)
    assert ref.bench_rates(compact) == port.bench_rates(compact)
    assert port.bench_rates(cpu_record) == ref.bench_rates(cpu_record)


# -- the legs against the reference's smoke shapes ------------------------------


def test_lsh_smoke_curve_equals_the_reference(monkeypatch):
    """The same recall and candidate fraction at each probe count as the
    reference's smoke curve (its host probe rung, the scan re-rank: the
    same answers as its default kernel route, cheaper on the CPU)."""
    import randomprojection_tpu.ann as ref_ann

    monkeypatch.setattr(ref_ann, "LSHSimHashIndex", functools.partial(
        ref_ann.LSHSimHashIndex, topk_impl="scan"))
    got = port.measure_topk_lsh("smoke", device="cpu")
    want = ref.measure_topk_lsh("smoke")
    assert [(p["probes"], p["recall_at_m"], p["candidate_fraction"])
            for p in got["curve"]] == [
        (p["probes"], p["recall_at_m"], p["candidate_fraction"])
        for p in want["curve"]]
    assert got["recall_gate_ok"] is want["recall_gate_ok"] is True
    assert all(p["fallbacks"] == 0 for p in got["curve"])


def test_tiered_smoke_equals_the_reference(monkeypatch):
    import randomprojection_tpu.models.sketch as ref_sketch

    class ScanIndex(ref_sketch.SimHashIndex):
        def __init__(self, *a, **k):
            k.setdefault("topk_impl", "scan")
            super().__init__(*a, **k)

    monkeypatch.setattr(ref_sketch, "SimHashIndex", ScanIndex)
    got = port.measure_topk_tiered("smoke", device="cpu")
    want = ref.measure_topk_tiered("smoke")
    assert got["parity_ok"] is want["parity_ok"] is True
    assert (got["hot_chunks"], got["cold_chunks"]) == (
        want["hot_chunks"], want["cold_chunks"])
    assert got["fallbacks"] == 0


def test_config5_first_batch_and_stages():
    """The first batch within rtol = atol = 2e-5 of the host float64
    transform; the staged leg's stages are the reference's plus ``read``:
    the bench's sources are given ``stats=``, which opens the read stage
    the reference's sources never time."""
    got = port.measure_config5(n_docs=1024, device="cpu")
    want = ref.measure_config5(n_docs=1024)
    assert got["first_batch_ok"] is True
    assert got["first_batch_max_abs_err"] <= port.C5_TOL
    assert set(got["pipeline_stage_pct"]) == \
        set(want["pipeline_stage_pct"]) | {"read"}
    assert set(got["pipeline_stage_wall_s"]) == \
        set(want["pipeline_stage_wall_s"]) | {"read"}
    assert os.environ.get("RP_HASH_THREADS") is None


@pytest.mark.parametrize("name", ["f32_high", "bf16_split2", "bf16"])
def test_config2_distortion_equals_the_reference(name):
    import jax
    import jax.numpy as jnp
    import torch

    k, d, density = 64, 512, 1 / 3
    R = np.asarray(np.random.default_rng(9).choice(
        [-1.0, 0.0, 1.0], p=[1 / 6, 2 / 3, 1 / 6], size=(k, d)),
        dtype=np.float32) / np.float32(np.sqrt(density * k))
    scale = 1.0 / np.sqrt(density * k)
    x = np.random.default_rng(0).normal(size=(1024, d)).astype(np.float32)
    want = ref.measure_distortion(jax, jnp, jnp.asarray(R), x, name, scale)
    got = port.measure_distortion(torch.from_numpy(R), x, name, scale,
                                  device="cpu")
    assert abs(got - want) <= 1e-5
    if name != "bf16":  # bf16 x is over the budget in both packages
        assert got <= port.DISTORTION_BUDGET


@pytest.mark.parametrize("n_bytes", [32, 16, 3])
def test_lsh_exact_reference_equals_the_reference(n_bytes):
    """The bench's host brute force (a word column at a time, a partition
    before the sort) gives the reference's top-m, ties to the lower id."""
    rng = np.random.default_rng(n_bytes)
    codes = rng.integers(0, 256, size=(3000, n_bytes), dtype=np.uint8)
    codes[:1500] = codes[0]  # ties
    queries = rng.integers(0, 256, size=(40, n_bytes), dtype=np.uint8)
    got = port._lsh_exact_reference(queries, codes, 10, c_block=1024)
    want = ref._lsh_exact_reference(queries, codes, 10, c_block=1024)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
