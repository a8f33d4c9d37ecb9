"""The port's program spans (``utils/observability``), on the CPU.

Off (no profiler recording) the span store stays empty through a
``TopKServer`` run and a ``transform``.  On, it holds one
``rp:serve/queue_wait`` a request and one ``rp:serve/batch`` a served
batch, the index's ``rp:index/wait_tile`` inside its ``query_topk`` on
the same thread, the backend's ``rp:backend/dispatch`` around its
``prepare`` and ``project``, one ``rp:gc/gen2`` for a forced collection
with the collection counters, spans on the profiler's own clock, a
ring that counts what it drops once full, and the waves of counted kernel
launches (kept only while a profiler records, cleared with the spans).
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
