"""The port's program spans (``utils/observability``), on the CPU.

Off (no profiler recording) the span store stays empty through a
``TopKServer`` run and a ``transform``.  On, it holds one
``rp:serve/queue_wait`` a request and one ``rp:serve/batch`` a served
batch, the index's ``rp:index/wait_tile`` inside its ``query_topk`` on
the same thread, the backend's ``rp:backend/dispatch`` around its
``prepare`` and ``project``, one ``rp:gc/gen2`` for a forced collection
with the collection counters, spans on the profiler's own clock, a
ring that counts what it drops once full, the waves of counted kernel
launches and the top-k scan's survivors' counts (kept only while a
profiler records, cleared with the spans).
The LSH tier's spans (a call, and a device-rung tile's sizing, dispatch,
wait and ladder on its thread), a card build's span a band, and the probe
launches it counts: present under a profiler, absent without one.
"""

import collections
import gc
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import randomprojection_tpu_torch as rpt
from randomprojection_tpu_torch.models import sketch as sk
from randomprojection_tpu_torch.utils import observability as obs


@pytest.fixture(autouse=True)
def _empty_store():
    obs.clear_spans()
    yield
    obs.clear_spans()


def _codes(rows, nb, seed):
    return np.random.default_rng(seed).integers(0, 256, size=(rows, nb),
                                                dtype=np.uint8)


def _named(name):
    return [s for s in obs.recorded_spans() if s[0] == name]


def _traced():
    return profile(activities=[ProfilerActivity.CPU])


def _serve(n_requests):
    idx = sk.SimHashIndex(_codes(2000, 8, 0), device="cpu")
    q = _codes(n_requests, 8, 1)
    with sk.TopKServer(idx, 3, max_delay_s=0.002, name="spans") as srv:
        futs = [srv.submit(q[r]) for r in range(n_requests)]
        for f in futs:
            f.result(timeout=60)
        srv.close()
        return srv.stats()


def _model():
    return rpt.SparseRandomProjection(
        16, density=1 / 3, random_state=3,
        backend_options={"device": "cpu", "materialization": "lazy"},
    ).fit_schema(64, 128, dtype=np.dtype(np.float32))


def test_off_the_store_stays_empty():
    assert not obs.recording()
    st = _serve(10)
    _model().transform(torch.randn(64, 128))
    gc.collect()
    obs.record_span("rp:test/off", 1, 2)
    assert st["requests"] == 10
    assert obs.recorded_spans() == []
    assert obs.dropped_spans() == 0
    assert all(v == (0, 0) for v in obs.gc_collections().values())


def test_on_one_queue_wait_a_request_and_one_batch_a_batch():
    with _traced():
        assert obs.recording()
        st = _serve(24)
    waits, batches = _named("rp:serve/queue_wait"), _named("rp:serve/batch")
    assert len(waits) == st["requests"] == 24
    assert len(batches) == st["batches"] >= 1
    assert all(s[2] <= s[3] for s in waits + batches)
    # a request's wait ends at its batch's dispatch, inside that batch
    for _n, tid, t0, t1 in waits:
        assert any(b[1] == tid and b[2] <= t1 <= b[3] for b in batches)


def test_wait_tile_lies_inside_query_topk_on_its_thread():
    idx = sk.SimHashIndex(_codes(3000, 8, 2), device="cpu")
    with _traced():
        idx.query_topk(_codes(96, 8, 3), 4, tile=32)
    calls = _named("rp:index/query_topk")
    assert len(calls) == 1
    _n, tid, c0, c1 = calls[0]
    for name in ("rp:index/dispatch_tile", "rp:index/wait_tile",
                 "rp:index/merge_tile"):
        spans = _named(name)
        assert len(spans) == 3, name
        assert all(s[1] == tid and c0 <= s[2] <= s[3] <= c1 for s in spans)
    assert threading.get_native_id() == tid


def test_backend_dispatch_holds_prepare_and_project():
    est = _model()
    x = torch.randn(64, 128)
    with _traced():
        for _ in range(3):
            est.transform(x)
    outer = _named("rp:backend/dispatch")
    assert len(outer) == 3
    for name in ("rp:backend/prepare", "rp:backend/project"):
        inner = _named(name)
        assert len(inner) == 3
        for _n, tid, t0, t1 in inner:
            assert any(o[1] == tid and o[2] <= t0 <= t1 <= o[3]
                       for o in outer)


def test_a_forced_collection_is_one_gen2_span_and_counted():
    gc.collect()
    with _traced() as prof:
        gc.collect()
    gen2 = _named("rp:gc/gen2")
    counts = obs.gc_collections()
    assert len(gen2) == counts[2][0] >= 1
    assert counts[2][1] == sum(s[3] - s[2] for s in gen2) > 0
    # the profiler keeps its own thread's regions: this thread's
    mine = [s for s in gen2 if s[1] == threading.get_native_id()]
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("rp:gc/gen2") == len(mine) >= 1


def test_a_span_starts_where_its_profiler_echo_starts():
    with _traced() as prof:
        with obs.annotate("rp:test/warm"):
            pass
        for k in range(3):
            with obs.annotate(f"rp:test/probe{k}"):
                time.sleep(0.001)
    echo = {e.name(): e.start_ns()
            for e in prof.profiler.kineto_results.events()}
    gaps = [abs(s[2] - echo[s[0]]) for s in obs.recorded_spans()
            if s[0].startswith("rp:test/probe")]
    assert len(gaps) == 3
    assert min(gaps) < 100_000, gaps


def test_the_ring_counts_what_it_drops(monkeypatch):
    assert obs.SPAN_CAPACITY >= 2**20
    monkeypatch.setattr(obs, "_spans", collections.deque(maxlen=4))
    with _traced():
        for k in range(6):
            obs.record_span(f"rp:test/{k}", k, k + 1)
    assert obs.dropped_spans() == 2
    assert [s[0] for s in obs.recorded_spans()] == [
        f"rp:test/{k}" for k in range(2, 6)]


def test_launch_waves_are_counted_only_while_recording(monkeypatch):
    obs.count_waves("k", 132, 132)
    assert obs.launch_waves() == {}
    with _traced():
        obs.count_waves("k", 528, 528)   # four full waves of 132
        obs.count_waves("k", 32, 132)    # a quarter of one
        obs.count_waves("other", 133, 264)
    obs.count_waves("k", 1, 132)
    assert obs.launch_waves() == {"k": (2, 560, 660), "other": (1, 133, 264)}
    # off, the one recording() check is all a launch pays
    checks = []
    monkeypatch.setattr(obs, "recording", lambda: checks.append(1) or False)
    obs.count_waves("k", 7, 132)
    assert checks == [1] and obs.launch_waves()["k"] == (2, 560, 660)


def test_launch_waves_clear_with_the_spans():
    with _traced():
        obs.count_waves("k", 7, 8)
    assert obs.launch_waves() == {"k": (1, 7, 8)}
    obs.clear_spans()
    assert obs.launch_waves() == {}


class _CardCounts:
    """Stands in for the (4,) counts a scan on the card fills: read, with
    one copy, only when the totals are asked for."""

    is_cuda = True

    def __init__(self, keys, merges, row_tiles=0, tight=0):
        self.values, self.reads = [keys, merges, row_tiles, tight], 0

    def tolist(self):
        self.reads += 1
        return list(self.values)


def test_survivor_counts_are_kept_only_while_recording(monkeypatch):
    obs.count_survivors(64, (100, 5))
    assert obs.survivor_counts() == (0, 0, 0)
    card = _CardCounts(300, 20)
    with _traced():
        obs.count_survivors(64 * 128, (1000, 40))  # a graphed tile's stats
        obs.count_survivors(48 * 132, card)        # an eager launch
        assert card.reads == 0
    obs.count_survivors(1, (1, 1))
    assert obs.survivor_counts() == (64 * 128 + 48 * 132, 1300, 60)
    assert card.reads == 1
    assert obs.survivor_counts() == (64 * 128 + 48 * 132, 1300, 60)
    assert card.reads == 1  # read once
    # off, the one recording() check is all a launch pays
    checks = []
    monkeypatch.setattr(obs, "recording", lambda: checks.append(1) or False)
    obs.count_survivors(5, _CardCounts(5, 5))
    assert checks == [1]
    assert obs.survivor_counts() == (64 * 128 + 48 * 132, 1300, 60)


def test_survivor_counts_clear_with_the_spans():
    with _traced():
        obs.count_survivors(16, (32, 2))
        obs.count_survivors(16, _CardCounts(7, 1))
    obs.clear_spans()
    assert obs.survivor_counts() == (0, 0, 0)


def test_bound_counts_are_kept_only_while_recording(monkeypatch):
    """The row-tiles a scan tested and those its shared bound tightened:
    kept beside the survivors' counts while a profiler records, from the
    scan's four numbers or its (4,) counts on the card, read without a
    wait; a scan counted with keys and merges alone adds none; the
    survivors' totals stay three numbers."""
    obs.count_survivors(64, (100, 5, 40, 30))
    assert obs.bound_counts() == (0, 0)
    card = _CardCounts(300, 20, 6_000, 5_100)
    with _traced():
        obs.count_survivors(64 * 128, (1000, 40, 64 * 32, 900))
        obs.count_survivors(48 * 132, card)
        obs.count_survivors(16, (7, 1))
        assert card.reads == 0
    obs.count_survivors(1, (1, 1, 1, 1))
    assert obs.bound_counts() == (64 * 32 + 6_000, 900 + 5_100)
    assert card.reads == 1
    assert obs.survivor_counts() == (64 * 128 + 48 * 132 + 16, 1307, 61)
    assert card.reads == 1  # read once
    checks = []
    monkeypatch.setattr(obs, "recording", lambda: checks.append(1) or False)
    obs.count_survivors(5, _CardCounts(5, 5, 5, 5))
    assert checks == [1]
    assert obs.bound_counts() == (64 * 32 + 6_000, 900 + 5_100)


def test_bound_counts_clear_with_the_spans():
    with _traced():
        obs.count_survivors(16, (32, 2, 64, 10))
        obs.count_survivors(16, _CardCounts(7, 1, 9, 3))
    obs.clear_spans()
    assert obs.bound_counts() == (0, 0)
    assert obs.survivor_counts() == (0, 0, 0)


def test_a_device_tile_counts_its_rerank_from_its_stats(monkeypatch):
    """The LSH tier's device tile: the keys, merges, row-tiles and bound's
    tightened row-tiles its re-rank left in words 4-11 of the tile's
    stats, and its lists from the re-rank's plan, while a profiler records
    and for a card index only; a tile whose stats carry no keys (its
    re-rank ran eagerly and counted itself) adds nothing."""
    from randomprojection_tpu_torch.ann import lsh
    from randomprojection_tpu_torch.ops import probe_kernels as pk
    from randomprojection_tpu_torch.ops import topk_kernels as tk

    monkeypatch.setattr(tk, "_sm_count", lambda device: 132)
    assert pk.STATS_WORDS == 12
    stat = np.zeros(pk.STATS_WORDS, np.int32)
    stat[:3] = (975_000, 0, 960_000)
    stat[4:12] = np.array([2**33 + 5, 61_000, 2**32 + 7, 1_900],
                          np.int64).view(np.int32)
    assert pk.rerank_counts(stat) == (2**33 + 5, 61_000, 2**32 + 7, 1_900)
    card, cpu = torch.device("cuda"), torch.device("cpu")
    lsh._count_rerank(64, 1 << 20, 32, 10, stat, card)
    assert obs.survivor_counts() == (0, 0, 0)
    splits = tk.plan_fused(64, 1 << 20, 32, 10, sm_count=132).splits
    with _traced():
        lsh._count_rerank(64, 1 << 20, 32, 10, stat, card)
        lsh._count_rerank(64, 1 << 20, 32, 10, stat, cpu)
        lsh._count_rerank(64, 1 << 20, 32, 10,
                          np.zeros(pk.STATS_WORDS, np.int32), card)
    assert obs.survivor_counts() == (64 * splits, 2**33 + 5, 61_000)
    assert obs.bound_counts() == (2**32 + 7, 1_900)


def test_a_device_tile_plane_carries_the_widened_stats():
    """A device tile's stats, planes and per-query counts go to the host
    as one int32 plane and come back apart: the stats whole (K4's four
    counts included), nothing of them read as a distance."""
    from randomprojection_tpu_torch.ann import lsh
    from randomprojection_tpu_torch.ops import probe_kernels as pk

    nq, m = 3, 4
    stat = torch.arange(pk.STATS_WORDS, dtype=torch.int32) + 100
    d = torch.arange(nq * m, dtype=torch.int32).reshape(nq, m)
    gid = d + 1000
    cnt = torch.tensor([7, 8, 9], dtype=torch.int32)
    out = torch.cat([lsh._packed(stat, d, gid), cnt]).numpy()
    s, nd, ng = lsh._unpacked(out, nq, m)
    np.testing.assert_array_equal(s, stat.numpy())
    np.testing.assert_array_equal(nd, d.numpy())
    np.testing.assert_array_equal(ng, gid.numpy())
    np.testing.assert_array_equal(out[pk.STATS_WORDS + 2 * nq * m:], [7, 8, 9])


def test_a_cpu_index_counts_no_survivors():
    with _traced():
        _lsh_index().query_topk(_codes(40, 24, 6), 5, tile=16, probes=3,
                                probe_path="device")
        sk.SimHashIndex(_codes(2000, 8, 0), device="cpu").query_topk(
            _codes(5, 8, 1), 3)
    assert obs.survivor_counts() == (0, 0, 0)


def _lsh_index(**kw):
    from randomprojection_tpu_torch.ann import LSHSimHashIndex

    return LSHSimHashIndex(_codes(4000, 24, 5), device="cpu", bands=8,
                           band_bits=20, fallback_density=1.0, **kw)


def test_the_lsh_tier_spans_and_probe_launches_under_a_profiler():
    with _traced():
        idx = _lsh_index()
        q = _codes(40, 24, 6)
        idx.query_topk(q, 5, tile=16, probes=3, probe_path="device")
    calls = _named("rp:lsh/query_topk")
    assert len(calls) == 1
    _n, tid, c0, c1 = calls[0]
    for name in ("rp:lsh/size_tile", "rp:lsh/dispatch_tile",
                 "rp:lsh/wait_tile", "rp:lsh/finish_tile"):
        spans = _named(name)
        assert len(spans) == 3, name  # tiles of 16, 16 and 8 queries
        assert all(s[1] == tid and c0 <= s[2] <= s[3] <= c1 for s in spans)
    # a tile's wait comes before its ladder
    waits, ladders = _named("rp:lsh/wait_tile"), _named("rp:lsh/finish_tile")
    assert all(w[3] <= f[2] for w, f in zip(waits, ladders))
    launches = obs.probe_launches()
    assert [(r, b, p) for r, b, p, _g, _c in launches] == [
        (16, 8, 3), (16, 8, 3), (8, 8, 3)]
    # the runs' total sizes the slot budget: the gathered ids fit it
    assert all(0 < g <= c for _r, _b, _p, g, c in launches)
    obs.clear_spans()
    assert obs.probe_launches() == []


def test_the_card_build_is_a_span_a_band():
    from randomprojection_tpu_torch.ann import lsh

    plan = lsh.BandPlan(64, bands=3, band_bits=20)
    with _traced():
        lsh.BandedBuckets(plan).add(torch.from_numpy(_codes(500, 8, 7)))
    assert len(_named("rp:lsh/build")) == 3


def test_off_the_lsh_tier_stores_nothing(monkeypatch):
    idx = _lsh_index()
    idx.query_topk(_codes(40, 24, 6), 5, tile=16, probes=3,
                   probe_path="device")
    obs.count_probe(16, 8, 3, 100, 128)
    assert obs.recorded_spans() == [] and obs.probe_launches() == []
    # off, a span is the shared null context and a launch one check
    assert obs.annotate("rp:lsh/query_topk") is obs._NULL
    checks = []
    monkeypatch.setattr(obs, "recording", lambda: checks.append(1) or False)
    obs.count_probe(16, 8, 3, 100, 128)
    assert checks == [1] and obs.probe_launches() == []
