"""Tiered hot/cold residency of the port against the JAX package.

- ``plan_residency`` orders and validates as the reference's does.
- At 4x over budget (one chunk of four hot) the port's tiered index
  answers bit for bit (distances and ids) like the port's resident index
  and the reference's tiered index, with tombstones across the hot/cold
  seam, after a synchronous demote, on the disk tier and under an
  injected staging failure (counted on ``index.tier.fallbacks``); the LSH
  tier likewise at partial and full probes.
- Tiered snapshots cross both ways: a port snapshot through the
  reference's ``verify_snapshot`` and ``load_index``, a reference tiered
  snapshot through the port's ``load_index`` with a budget.
- The tier-block validator, ``compact`` resetting the spill generation,
  an idempotent ``close`` that joins the ``rp-torch-tier-worker`` thread,
  the graphs dropped on every residency change, and a child killed at
  ``mid-demotion`` resumed through ``crash_smoke``.
- The sharded tier with a budget a shard (exact and LSH, host and disk
  cold tiers, a spill directory a shard) answers as the resident sharded
  index and the reference's tiered sharded index do.

Shapes follow the reference's ``tests/test_tiering.py``: 8-byte codes,
m = 5, 8 queries, 400 rows in 4 chunks of 100.
"""

import json
import os
import threading

import numpy as np
import pytest

from randomprojection_tpu import durable as ref_durable
from randomprojection_tpu import tiering as ref_tiering
from randomprojection_tpu.models import sketch as ref_sk
from randomprojection_tpu.utils import telemetry as ref_tel
from randomprojection_tpu_torch import durable, tier_smoke, tiering
from randomprojection_tpu_torch.ann import LSHSimHashIndex
from randomprojection_tpu_torch.models import sketch as sk
from randomprojection_tpu_torch.ops import topk_kernels as tk
from randomprojection_tpu_torch.utils import telemetry

N, NB, M, CHUNK = 400, 8, 5, 100
BUDGET = CHUNK * NB  # one chunk hot, three cold: 4x over budget
LSH_KW = dict(bands=4, band_bits=8, fallback_density=1.0, probe_path="host",
              device="cpu")


def _codes(seed=0, n=N):
    return np.random.default_rng(seed).integers(0, 256, size=(n, NB),
                                                dtype=np.uint8)


def _queries(seed=100):
    return np.random.default_rng(seed).integers(0, 256, size=(8, NB),
                                                dtype=np.uint8)


def _ingest(index, codes):
    for lo in range(0, codes.shape[0], CHUNK):
        index.add(codes[lo:lo + CHUNK])
    return index


def _tiered(codes, **kw):
    kw.setdefault("hbm_budget_bytes", BUDGET)
    return _ingest(sk.SimHashIndex(codes[:0], device="cpu", **kw), codes)


def _resident(codes):
    return _ingest(sk.SimHashIndex(codes[:0], device="cpu"), codes)


def _ref_tiered(codes, **kw):
    kw.setdefault("hbm_budget_bytes", BUDGET)
    return _ingest(ref_sk.SimHashIndex(codes[:0], topk_impl="scan", **kw), codes)


def _same(got, *wants):
    for want in wants:
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


# -- the planner ------------------------------------------------------------------


def test_plan_residency_greedy_by_score_then_ordinal():
    p = tiering.plan_residency([10, 10, 10], 20)
    assert p.hot == {0, 1} and p.hot_bytes == 20 and p.staging_bytes == 20
    assert tiering.plan_residency([10, 10, 10], 20,
                                  scores=[1.0, 5.0, 3.0]).hot == {1, 2}
    # greedy, not a knapsack: the best-scored chunk that fits is taken
    assert tiering.plan_residency([30, 10, 10], 20,
                                  scores=[9.0, 1.0, 1.0]).hot == {1, 2}
    rng = np.random.default_rng(1)
    for _ in range(50):
        sizes = rng.integers(1, 40, size=7).tolist()
        scores = rng.integers(0, 4, size=7).astype(float).tolist()
        budget = int(rng.integers(0, 120))
        got = tiering.plan_residency(sizes, budget, scores)
        want = ref_tiering.plan_residency(sizes, budget, scores)
        assert (got.hot, got.hot_bytes, got.staging_bytes) == (
            want.hot, want.hot_bytes, want.staging_bytes)


def test_plan_residency_everything_fits_or_nothing():
    p = tiering.plan_residency([10, 10], 100)
    assert p.hot == {0, 1} and p.staging_bytes == 0
    p = tiering.plan_residency([10, 10], 0)
    assert p.hot == frozenset() and p.hot_bytes == 0


def test_plan_residency_validation():
    with pytest.raises(ValueError):
        tiering.plan_residency([10], -1)
    with pytest.raises(ValueError):
        tiering.plan_residency([10, 10], 10, scores=[1.0])


# -- the manager ------------------------------------------------------------------


def test_tier_ctor_validation(tmp_path):
    with pytest.raises(ValueError):
        tiering.TieredResidency(-1)
    with pytest.raises(ValueError):
        tiering.TieredResidency(1024, cold_tier="lukewarm")
    with pytest.raises(ValueError):
        tiering.TieredResidency(1024, cold_tier="disk")  # no cold_dir
    t = tiering.TieredResidency(1024, cold_tier="disk",
                                cold_dir=str(tmp_path / "c"))
    assert os.path.isdir(tmp_path / "c")
    t.close()
    assert tiering.COLD_TIERS == ref_tiering.COLD_TIERS


def test_index_ctor_tier_validation():
    codes = _codes()
    with pytest.raises(ValueError):
        sk.SimHashIndex(codes, device="cpu", hbm_budget_bytes=1024,
                        cold_tier="bogus")
    with pytest.raises(ValueError):
        sk.SimHashIndex(codes, device="cpu", hbm_budget_bytes=1024,
                        cold_tier="disk")


def test_residency_and_manifest_block_equal_the_reference():
    codes = _codes()
    idx, ref = _tiered(codes), _ref_tiered(codes)
    try:
        r = idx._tier.residency()
        assert r["hbm_budget_bytes"] == BUDGET and r["hot_bytes"] <= BUDGET
        assert [c["tier"] for c in r["chunks"]] == ["hot"] + ["host"] * 3
        assert idx._tier.manifest_block() == ref._tier.manifest_block()
        assert r == ref._tier.residency()
    finally:
        idx.close()
        ref.close()


def test_untiered_index_has_no_tier():
    idx = sk.SimHashIndex(_codes(), device="cpu")
    assert idx._tier is None
    idx.close()  # safe untiered


# -- parity -----------------------------------------------------------------------


def test_exact_parity_4x_over_budget():
    codes, q = _codes(), _queries()
    tiered, ref = _tiered(codes), _ref_tiered(codes)
    reg = telemetry.registry()
    cold0 = reg.counter("index.tier.cold_rows")
    try:
        _same(tiered.query_topk(q, M), _resident(codes).query_topk(q, M),
              ref.query_topk(q, M))
        assert reg.counter("index.tier.cold_rows") - cold0 == 3 * CHUNK * 1
    finally:
        tiered.close()
        ref.close()


def test_exact_parity_with_seam_spanning_tombstones():
    codes, q = _codes(), _queries()
    dead = np.arange(CHUNK - 20, CHUNK + 20)  # spans the chunk seam
    resident, tiered, ref = _resident(codes), _tiered(codes), _ref_tiered(codes)
    try:
        for idx in (resident, tiered, ref):
            idx.delete(dead)
        got = tiered.query_topk(q, M)
        _same(got, resident.query_topk(q, M), ref.query_topk(q, M))
        assert not np.isin(got[1], dead).any()
    finally:
        tiered.close()
        ref.close()


def test_sync_demote_keeps_parity():
    codes, q = _codes(), _queries()
    tiered = _tiered(codes, hbm_budget_bytes=1 << 20)  # everything hot
    try:
        assert tiered._tier.demote(0) is True
        assert tiered._tier.demote(0) is False  # already cold
        assert tiered._tier.demote(99999) is False  # unknown row0
        tags = [c["tier"] for c in tiered._tier.residency()["chunks"]]
        assert tags == ["host", "hot", "hot", "hot"]
        _same(tiered.query_topk(q, M), _resident(codes).query_topk(q, M))
    finally:
        tiered.close()


def test_upload_failure_degrades_to_sync_fetch(monkeypatch):
    codes, q = _codes(), _queries()
    kw = {k: v for k, v in LSH_KW.items()}
    resident = _ingest(LSHSimHashIndex(codes[:0], **kw), codes)
    tiered = _ingest(LSHSimHashIndex(codes[:0], hbm_budget_bytes=BUDGET, **kw),
                     codes)

    def _boom(rows, **kw):
        raise RuntimeError("injected upload failure")

    try:
        want_lsh = resident.query_topk(q, M, probes=2)
        want_exact = resident.query_topk(q, M, probes=0)
        reg = telemetry.registry()
        fb0 = reg.counter("index.tier.fallbacks")
        monkeypatch.setattr(tk, "stage_rows", _boom)
        _same(tiered.query_topk(q, M, probes=2), want_lsh)
        fb1 = reg.counter("index.tier.fallbacks")
        assert fb1 > fb0
        # the device rung's cold side takes the same degraded rung
        _same(tiered.query_topk(q, M, probes=2, probe_path="device"),
              resident.query_topk(q, M, probes=2, probe_path="device"))
        assert reg.counter("index.tier.fallbacks") > fb1
        fb1 = reg.counter("index.tier.fallbacks")
        _same(tiered.query_topk(q, M, probes=0), want_exact)
        assert reg.counter("index.tier.fallbacks") > fb1
    finally:
        tiered.close()


@pytest.mark.parametrize("probe_path", ["host", "device"])
@pytest.mark.parametrize("probes", [2, 1 << 8])  # partial and full coverage
def test_lsh_parity_tiered_partial_and_full_probes(probes, probe_path):
    codes, q = _codes(), _queries()
    kw = dict(LSH_KW, probe_path=probe_path)
    resident = _ingest(LSHSimHashIndex(codes[:0], **kw), codes)
    tiered = _ingest(
        LSHSimHashIndex(codes[:0], hbm_budget_bytes=BUDGET, **kw), codes)
    reg = telemetry.registry()
    try:
        want = resident.query_topk(q, M, probes=probes)
        cold0 = reg.counter("index.tier.cold_rows")
        _same(tiered.query_topk(q, M, probes=probes), want)
        # the candidates' cold side was gathered and staged, not skipped
        assert reg.counter("index.tier.cold_rows") > cold0
        if probes == 1 << 8:  # full coverage is the exact answer
            _same(want, ref_sk.topk_bruteforce(q, codes, M))
        # the device rung (its plain version) serves with cold chunks
        assert tiered._lsh_probe_device(None) == (probe_path == "device")
    finally:
        tiered.close()


def test_lsh_tiered_device_rung_adaptive_and_disk_tier(tmp_path):
    codes, q = _codes(), _queries()
    kw = dict(LSH_KW, probe_path="device")
    resident = _ingest(LSHSimHashIndex(codes[:0], **kw), codes)
    tiered = _ingest(
        LSHSimHashIndex(codes[:0], hbm_budget_bytes=BUDGET, **kw), codes)
    disk = _ingest(
        LSHSimHashIndex(codes[:0], hbm_budget_bytes=BUDGET, cold_tier="disk",
                        cold_dir=str(tmp_path / "cold"), **kw), codes)
    try:
        for p in (1, 4, 1 << 8):
            want = resident.query_topk(q, M, probes=p, adaptive=True)
            _same(tiered.query_topk(q, M, probes=p, adaptive=True), want)
            _same(disk.query_topk(q, M, probes=p), resident.query_topk(
                q, M, probes=p))
        assert disk._tier.any_cold()
    finally:
        tiered.close()
        disk.close()


@pytest.mark.parametrize("probe_path", ["host", "device"])
def test_lsh_tiered_seam_tombstones_equal_masked_brute_force(probe_path):
    codes, q = _codes(), _queries()
    dead = np.arange(CHUNK - 30, CHUNK + 30)
    tiered = _ingest(
        LSHSimHashIndex(codes[:0], hbm_budget_bytes=BUDGET,
                        **dict(LSH_KW, probe_path=probe_path)), codes)
    try:
        tiered.delete(dead)
        d, i = tiered.query_topk(q, M, probes=1 << 8)
        D = ref_sk.pairwise_hamming(q, codes).astype(np.int64)
        D[:, dead] = NB * 8 + 1
        sel = np.argsort((D << 16) | np.arange(N), axis=1, kind="stable")[:, :M]
        np.testing.assert_array_equal(i, sel)
        np.testing.assert_array_equal(d, np.take_along_axis(D, sel, 1))
    finally:
        tiered.close()


# -- the disk tier and snapshots ------------------------------------------------------


def test_disk_tier_spills_and_port_snapshot_crosses(tmp_path):
    codes, q = _codes(), _queries()
    tiered = _tiered(codes, cold_tier="disk", cold_dir=str(tmp_path / "cold"))
    snap = str(tmp_path / "snap")
    try:
        spills = sorted(os.listdir(tmp_path / "cold"))
        assert len(spills) == 3 and all(
            s.startswith("chunk-") and s.endswith(".npy") for s in spills)
        assert isinstance(tiered._chunks[1].b, np.memmap)
        want = _resident(codes).query_topk(q, M)
        _same(tiered.query_topk(q, M), want)
        manifest = durable.save_index(tiered, snap)
        assert manifest["tier"]["cold_tier"] == "disk"
        for status in (durable.verify_snapshot(snap),
                       ref_durable.verify_snapshot(snap)):
            assert status["ok"], status
            assert status["tier"]["cold_chunks"] == 3
        _same(durable.load_index(snap, device="cpu").query_topk(q, M), want)
        back = ref_durable.load_index(snap, index_kwargs={"topk_impl": "scan"})
        _same(back.query_topk(q, M), want)
    finally:
        tiered.close()


def test_reference_tiered_snapshot_loads_under_a_budget(tmp_path):
    codes, q = _codes(), _queries()
    ref = _ref_tiered(codes, cold_tier="disk", cold_dir=str(tmp_path / "cold"))
    snap = str(tmp_path / "snap")
    try:
        ref_durable.save_index(ref, snap)
        want = ref.query_topk(q, M)
    finally:
        ref.close()
    back = durable.load_index(snap, device="cpu",
                              index_kwargs={"hbm_budget_bytes": 2 * BUDGET})
    try:
        tags = [c["tier"] for c in back._tier.residency()["chunks"]]
        assert tags == ["hot", "hot", "host", "host"]
        _same(back.query_topk(q, M), want)
    finally:
        back.close()


def test_tier_block_validator(tmp_path):
    codes = _codes()
    tiered = _tiered(codes)
    snap = str(tmp_path / "snap")
    try:
        durable.save_index(tiered, snap)
    finally:
        tiered.close()
    manifest = durable.read_manifest(snap)
    durable._check_tier_block(manifest)
    durable._check_tier_block({"chunks": []})  # no block: nothing to check
    for edit, match in (
        (lambda b: b.update(format=2), "format"),
        (lambda b: b.update(cold_tier="lukewarm"), "cold_tier"),
        (lambda b: b["chunks"][0].update(tier="lukewarm"), "residency tag"),
        (lambda b: b["chunks"][0].update(rows=b["chunks"][0]["rows"] + 1),
         "disagrees"),
    ):
        bad = json.loads(json.dumps(manifest))
        edit(bad["tier"])
        with pytest.raises(ValueError, match=match):
            durable._check_tier_block(bad)
        with pytest.raises(ValueError, match=match):
            ref_durable._check_tier_block(bad)
    path = os.path.join(snap, durable.MANIFEST_NAME)
    with open(path) as f:
        m = json.load(f)
    m["tier"]["chunks"][0]["tier"] = "lukewarm"
    with open(path, "w") as f:
        json.dump(m, f)
    with pytest.raises(ValueError, match="residency tag"):
        durable.load_index(snap, device="cpu")
    assert not durable.verify_snapshot(snap)["ok"]


def test_compact_resets_tier_generation(tmp_path):
    codes, q = _codes(), _queries()
    resident = _resident(codes)
    tiered = _tiered(codes, cold_tier="disk", cold_dir=str(tmp_path / "cold"))
    try:
        dead = np.arange(50)
        resident.delete(dead)
        tiered.delete(dead)
        np.testing.assert_array_equal(resident.compact(), tiered.compact())
        names = os.listdir(tmp_path / "cold")
        assert names and all("-000001-" not in n for n in names)
        assert tiered._tier.residency()["chunks"][0]["tier"] == "disk"
        _same(tiered.query_topk(q, M), resident.query_topk(q, M))
    finally:
        tiered.close()


# -- lifecycle ------------------------------------------------------------------


def _workers():
    return [t for t in threading.enumerate()
            if t.name.startswith(tiering.WORKER_NAME)]


def test_close_is_idempotent_and_joins_the_worker():
    codes, q = _codes(), _queries()
    tiered = _ingest(
        LSHSimHashIndex(codes[:0], hbm_budget_bytes=BUDGET, **LSH_KW), codes)
    want = _ingest(LSHSimHashIndex(codes[:0], **LSH_KW), codes)
    # skewed access: queries near chunk 2's codes re-plan residency, and
    # the worker moves chunks in the background while answers stay exact
    near = codes[2 * CHUNK:2 * CHUNK + 8] ^ np.uint8(1)
    for _ in range(3):
        _same(tiered.query_topk(near, M, probes=2),
              want.query_topk(near, M, probes=2))
    assert tiered._tier._thread is not None
    assert tiered._tier._thread.name == "rp-torch-tier-worker"
    tiered.close()
    tiered.close()
    assert not _workers()
    assert tiered._tier.residency()["hot_bytes"] <= BUDGET
    _same(tiered.query_topk(q, M, probes=2), want.query_topk(q, M, probes=2))


def test_residency_changes_drop_the_captured_tiles():
    codes = _codes()
    idx = _ingest(LSHSimHashIndex(codes[:0], hbm_budget_bytes=1 << 20, **LSH_KW),
                  codes)
    try:
        for change in (lambda: idx._tier.demote(CHUNK),
                       lambda: idx._tier._promote(idx._tier._entries[1]),
                       lambda: idx._tier.reset()):
            idx._lsh_graphs._graphs["stand-in"] = object()
            change()
            assert len(idx._lsh_graphs) == 0
    finally:
        idx.close()


def test_stage_rows_on_the_cpu_pads_and_reads_memmaps(tmp_path):
    rows = _codes(3, 37)
    np.save(tmp_path / "r.npy", rows)
    mm = np.load(tmp_path / "r.npy", mmap_mode="r")
    out, ev = tk.stage_rows(mm, device="cpu", pad_to=48)
    assert ev is None and out.shape == (48, NB)
    np.testing.assert_array_equal(out.numpy()[:37], rows)
    assert not out.numpy()[37:].any()
    tk.wait_staged(out, ev)  # a CPU stage has nothing to wait for
    with pytest.raises(ValueError, match="pad_to"):
        tk.stage_rows(rows, device="cpu", pad_to=8)


def test_tier_smoke_on_the_cpu():
    summary = tier_smoke.main("cpu")
    assert summary["cold_chunks"] == 3 and summary["fallbacks"] > 0


def test_tier_events_parse_with_the_reference_reader(tmp_path):
    path = str(tmp_path / "t.jsonl")
    codes, q = _codes(), _queries()
    telemetry.configure(path)
    try:
        tiered = _tiered(codes)
        tiered.query_topk(q, M)
        tiered._tier.demote(0)
        tiered._tier.note_fallback("test")
        tiered.close()
    finally:
        telemetry.shutdown()
    names = {e["event"] for e in ref_tel.read_events(path)}
    assert {"index.tier.hit", "index.tier.fetch", "index.tier.evict",
            "index.tier.fallback"} <= names
    for name in ("INDEX_TIER_HIT", "INDEX_TIER_FETCH", "INDEX_TIER_EVICT",
                 "INDEX_TIER_FALLBACK"):
        assert getattr(telemetry.EVENTS, name) == getattr(ref_tel.EVENTS, name)


def test_mid_demotion_child_resumes_through_crash_smoke(tmp_path):
    verdict = durable.crash_smoke(str(tmp_path), rows=64, batch_rows=16,
                                  device="cpu", points=("mid-demotion",),
                                  nth=2, timeout=120)
    assert verdict["ok"], verdict
    case = verdict["cases"][0]
    assert case["kill_at"] == "mid-demotion@2"
    assert case["crash_returncode"] == -9 and case["resume_returncode"] == 0
    assert case["bit_identical_codes"] and case["query_results_match"]


@pytest.mark.parametrize("cold_tier", ["host", "disk"])
def test_sharded_tier_with_a_budget_a_shard(tmp_path, cold_tier):
    """Every shard tiers its own memory under its own budget (the
    reference's knob is per shard too): two chunks a shard, one hot."""
    from randomprojection_tpu.serving import ShardedSimHashIndex as RefSharded
    from randomprojection_tpu_torch.ann import LSHShardedSimHashIndex
    from randomprojection_tpu_torch.serving import ShardedSimHashIndex

    codes, q = _codes(3, n=800), _queries()
    cold_dir = str(tmp_path / "cold") if cold_tier == "disk" else None
    kw = dict(devices=["cpu"], n_shards=4, hbm_budget_bytes=BUDGET,
              cold_tier=cold_tier, cold_dir=cold_dir)
    tiered = ShardedSimHashIndex(codes[:400], **kw)
    tiered.add(codes[400:])
    resident = ShardedSimHashIndex(codes, devices=["cpu"], n_shards=4)
    ref = RefSharded(codes[:400], n_shards=4, topk_impl="scan",
                     hbm_budget_bytes=BUDGET, cold_tier="host")
    ref.add(codes[400:])
    for idx in (tiered, resident, ref):
        idx.delete(np.arange(80, 130))  # across shard boundaries
    for s in tiered._shards:
        r = s._tier.residency()
        assert r["hot_bytes"] <= BUDGET
        assert [c["tier"] for c in r["chunks"]] == ["hot", cold_tier]
    if cold_dir:
        assert sorted(os.listdir(cold_dir)) == [f"shard-{s:02d}"
                                               for s in range(4)]
    want = resident.query_topk(q, M)
    for got in (tiered.query_topk(q, M), ref.query_topk(q, M)):
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
    lsh_kw = dict(bands=4, band_bits=8, fallback_density=1.0)
    ltier = LSHShardedSimHashIndex(codes, **kw, **lsh_kw)
    lres = LSHShardedSimHashIndex(codes, devices=["cpu"], n_shards=4, **lsh_kw)
    for p in (2, 1 << 8):
        for path in ("host", "device"):
            got = ltier.query_topk(q, M, probes=p, probe_path=path)
            want = lres.query_topk(q, M, probes=p, probe_path=path)
            assert np.array_equal(got[0], want[0])
            assert np.array_equal(got[1], want[1])
    for idx in (tiered, ltier, ref):
        idx.close()
