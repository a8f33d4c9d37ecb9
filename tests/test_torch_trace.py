"""The port's per-batch traces read by the JAX package's trace tooling.

JSONL files written by the port's serial, prefetched and staged streams —
run to the end, broken mid-run and failed by a ``FaultInjectionSource`` —
parse with the reference's ``read_events`` and give its
``trace_report.build_report`` no orphan span start or end and no
malformed span: every trace root is complete, abandoned, failed or the
end-of-stream probe.  How far producer threads got before a break is not
asserted (a timing property, not a contract).  Also: the stream's and the
backend's events carry their batch's trace ids, span ids stay unique
across ``configure`` calls, ``batch_nbytes`` equals the reference's for
every sparse format, and ``StreamStats.summary()`` has the reference's
keys.
"""

import json

import numpy as np
import pytest
import scipy.sparse as sp

from randomprojection_tpu.utils import observability as ref_obs
from randomprojection_tpu.utils.telemetry import read_events
from randomprojection_tpu.utils.trace_report import build_report
from randomprojection_tpu_torch import GaussianRandomProjection
from randomprojection_tpu_torch.streaming import (
    ArraySource,
    FaultInjectionSource,
    PrefetchSource,
    StagedIngestSource,
    iter_traced,
    stream_transform,
)
from randomprojection_tpu_torch.utils import observability as obs
from randomprojection_tpu_torch.utils import telemetry

CPU = {"device": "cpu"}
N, D, BATCH = 640, 64, 64  # 10 batches


@pytest.fixture
def X():
    return np.random.default_rng(1).normal(size=(N, D)).astype(np.float32)


@pytest.fixture
def sink(tmp_path):
    path = str(tmp_path / "events.jsonl")
    telemetry.configure(path)
    try:
        yield path
    finally:
        telemetry.shutdown()


def _source(kind, inner, est):
    if kind == "prefetch":
        return PrefetchSource(inner, depth=2, prepare=est.prepare_batch)
    if kind == "staged":
        return StagedIngestSource(inner, workers=3, depth=2,
                                  prepare=est.prepare_batch)
    return inner


def _run(kind, outcome, X, est, stats):
    inner = ArraySource(X, BATCH)
    if outcome == "fault":
        inner = FaultInjectionSource(inner, fail_after_batches=4)
    src = _source(kind, inner, est)
    try:
        for i, _ in enumerate(stream_transform(est, src, stats=stats)):
            if outcome == "break" and i == 3:
                break
    except FaultInjectionSource.InjectedFault:
        assert outcome == "fault"


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("outcome", ["end", "break", "fault"])
@pytest.mark.parametrize("kind", ["serial", "prefetch", "staged"])
def test_every_span_closes_and_the_reference_reads_it(X, sink, kind, outcome,
                                                      backend):
    est = GaussianRandomProjection(
        8, random_state=0, backend=backend,
        backend_options=CPU if backend == "torch" else None).fit(X)
    _run(kind, outcome, X, est, obs.StreamStats())
    telemetry.shutdown()
    events = list(read_events(sink))
    starts = [e for e in events if e["event"] == "span_start"]
    roots = [e for e in starts if e["parent_id"] is None]
    ends = {e["span_id"]: e for e in events if e["event"] == "span_end"}
    assert roots and all(s["span_id"] in ends for s in starts)
    report = build_report(sink)
    assert report["spans"]["orphan_starts"] == 0
    assert report["spans"]["orphan_ends"] == 0
    assert report["spans"]["malformed"] == 0
    tr = report["traces"]
    assert tr["batches"] + tr["incomplete"] + tr["empty"] == len(roots)
    commits = [e for e in events if e["event"] == "stream.commit"]
    assert tr["batches"] == len(commits)
    if outcome == "end":
        assert tr["batches"] == N // BATCH and tr["incomplete"] == 0
    elif outcome == "break":
        assert tr["batches"] == 3 and tr["incomplete"] >= 1
    else:
        assert 0 < tr["batches"] < 4 and tr["incomplete"] >= 1
    # each committed root's span_end carries the commit's row
    by_trace = {e["trace_id"]: e for e in commits}
    for r in roots:
        end = ends[r["span_id"]]
        if r["trace_id"] in by_trace:
            assert end["row"] == by_trace[r["trace_id"]]["row"]
            assert not end.get("abandoned")


def test_children_parent_to_batch_roots_across_threads(X, sink):
    est = GaussianRandomProjection(8, random_state=0,
                                   backend_options=CPU).fit(X)
    list(stream_transform(est, StagedIngestSource(
        ArraySource(X, BATCH), workers=2, prepare=est.prepare_batch),
        stats=obs.StreamStats()))
    telemetry.shutdown()
    events = list(read_events(sink))
    spans = {e["span_id"]: e for e in events if e["event"] == "span_start"}
    roots = {k for k, v in spans.items() if v["parent_id"] is None}
    children = [v for v in spans.values() if v["parent_id"] is not None]
    assert {c["name"] for c in children} >= {"h2d", "dispatch", "d2h"}
    for c in children:
        assert c["parent_id"] in roots
        assert spans[c["parent_id"]]["name"] == "batch"
        assert c["trace_id"] == spans[c["parent_id"]]["trace_id"]
    # the backend's dispatch record joins the batch's trace through the
    # dispatch stage's span
    dispatch_spans = {k for k, v in spans.items() if v["name"] == "dispatch"}
    backend = [e for e in events if e["event"] == "backend.dispatch"]
    assert len(backend) == N // BATCH
    assert all(e["span_id"] in dispatch_spans for e in backend)
    stream_dispatch = [e for e in events if e["event"] == "stream.dispatch"]
    assert all("trace_id" in e for e in stream_dispatch)


def test_iter_traced_closes_the_end_probe_as_empty(X, sink):
    items = list(iter_traced(ArraySource(X, 256)))
    for _, _, root in items:
        telemetry.end_span(root)
    telemetry.shutdown()
    report = build_report(sink)
    assert report["traces"]["empty"] == 1
    assert report["spans"]["orphan_starts"] == 0


def test_span_ids_unique_across_configure(tmp_path):
    path = str(tmp_path / "two_runs.jsonl")
    ids = []
    try:
        for _ in range(2):
            telemetry.configure(path)
            with telemetry.span("batch", new_trace=True) as root:
                with telemetry.span("dispatch") as child:
                    assert telemetry.trace_fields() == {
                        "trace_id": root.trace_id, "span_id": child.span_id}
            ids += [root.span_id, child.span_id]
    finally:
        telemetry.shutdown()
    assert len(set(ids)) == 4
    assert telemetry.trace_fields() == {}
    assert telemetry.start_span("x") is None  # no sink: a no-op handle
    report = build_report(path)
    assert report["traces"]["batches"] == 2
    assert report["spans"]["complete"] == 4


def test_require_parent_opens_no_orphan_trace(sink):
    assert telemetry.start_span("hash", require_parent=True) is None
    with obs.stage(None, "hash") as s:
        assert s is None


def _formats():
    dense = np.zeros((64, 32), dtype=np.float32)
    dense[::2, ::4] = 1.5
    dense[1, 3] = -2.0
    return {
        "dense": dense,
        "csr": sp.csr_array(dense),
        "coo": sp.coo_array(dense),
        "lil": sp.lil_array(dense),
        "dok": sp.dok_array(dense),
        "csc": sp.csc_matrix(dense),
        "dia": sp.dia_array(dense),
    }


@pytest.mark.parametrize("fmt", sorted(_formats()))
def test_batch_nbytes_equals_the_reference(fmt):
    batch = _formats()[fmt]
    assert obs.batch_nbytes(batch) == ref_obs.batch_nbytes(batch) > 0


def test_stream_stats_summary_has_the_reference_keys():
    def drive(stats_mod):
        stats = stats_mod.StreamStats()
        stats.start()
        with stats.stage("dispatch"):
            pass
        stats.on_queue_depth(1)
        stats.on_commit(0, 128, np.zeros((4, 2), np.float32))
        return stats.summary()

    got, want = drive(obs), drive(ref_obs)
    assert set(got) == set(want)
    assert set(got["stage_wall_s"]) == set(want["stage_wall_s"])
    for key in ("batches", "rows", "bytes_in", "bytes_out",
                "queue_depth_max"):
        assert got[key] == want[key]


def test_stage_walls_reach_the_event_log(X, sink):
    est = GaussianRandomProjection(8, random_state=0,
                                   backend_options=CPU).fit(X)
    stats = obs.StreamStats()
    list(stream_transform(est, PrefetchSource(
        ArraySource(X, BATCH), prepare=est.prepare_batch, stats=stats),
        stats=stats))
    telemetry.shutdown()
    walls = [e for e in read_events(sink) if e["event"] == "stage.wall"]
    assert {e["stage"] for e in walls} == {"h2d", "dispatch", "d2h"}
    assert len(walls) == 3 * (N // BATCH)
    summary = json.loads(json.dumps(stats.summary()))
    assert summary["rows"] == N and summary["queue_depth_max"] <= 2
