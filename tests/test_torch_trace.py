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

import contextlib
import json
import time

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


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("kind", ["prefetch", "staged"])
def test_a_held_producer_span_ends_before_its_abandoned_root(
        X, sink, kind, backend, monkeypatch):
    """A producer that keeps its ``enqueue_wait`` span open after the
    hand-off (here for 0.2 s, long past the consumer's break) must still
    end it before the stream ends the batch's root as abandoned: the
    stream stops and joins its source before it abandons the roots."""
    held = telemetry.span

    @contextlib.contextmanager
    def hold_enqueue_wait(name, **kw):
        with held(name, **kw) as s:
            yield s
            if name == "enqueue_wait":
                time.sleep(0.2)

    monkeypatch.setattr(telemetry, "span", hold_enqueue_wait)
    est = GaussianRandomProjection(
        8, random_state=0, backend=backend,
        backend_options=CPU if backend == "torch" else None).fit(X)
    _run(kind, "break", X, est, obs.StreamStats())
    telemetry.shutdown()
    events = list(read_events(sink))
    starts = {e["span_id"]: e for e in events if e["event"] == "span_start"}
    roots = [e for e in starts.values() if e["parent_id"] is None]
    end_at = {e["span_id"]: i for i, e in enumerate(events)
              if e["event"] == "span_end"}
    assert any(e["name"] == "enqueue_wait" for e in starts.values())
    for s in starts.values():
        if s["parent_id"] is not None:
            assert end_at[s["span_id"]] < end_at[s["parent_id"]], s["name"]
    tr = build_report(sink)["traces"]
    assert tr["batches"] + tr["incomplete"] + tr["empty"] == len(roots)
    assert tr["batches"] == 3 and tr["incomplete"] >= 1


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


# -- a default stream's span names, and the port's build_report ----------------

TOKENS_PER_DOC, N_DOCS, DOC_BATCH = 5, 96, 32


def _span_names(path):
    return sorted(e["name"] for e in read_events(path)
                  if e["event"] == "span_start")


def _callable_stream(pkg, X, path):
    """A default ``CallableSource`` (no ``stats``) through the numpy
    backend of ``pkg``, traced into ``path``."""
    pkg.utils.telemetry.configure(path)
    try:
        est = pkg.GaussianRandomProjection(8, random_state=0,
                                           backend="numpy").fit(X)
        src = pkg.streaming.CallableSource(lambda lo, hi: X[lo:hi], N, D,
                                           batch_rows=BATCH)
        list(est.transform_stream(src))
    finally:
        pkg.utils.telemetry.shutdown()


def _token_stream(pkg, path):
    """A default ``TokenSource`` (no ``stats``) into a numpy-backend
    ``CountSketch`` of ``pkg``, traced into ``path``."""
    words = np.asarray([f"w{i}" for i in range(50)])
    toks = words[np.random.default_rng(2).integers(
        0, 50, size=N_DOCS * TOKENS_PER_DOC)]

    def read_tokens(lo, hi):
        return (toks[lo * TOKENS_PER_DOC: hi * TOKENS_PER_DOC],
                np.arange(0, (hi - lo) * TOKENS_PER_DOC + 1, TOKENS_PER_DOC,
                          dtype=np.int64))

    fh = pkg.ops.hashing.FeatureHasher(n_features=1 << 10,
                                       input_type="string", dtype=np.float32)
    src = pkg.streaming.TokenSource(read_tokens, N_DOCS, fh,
                                    batch_rows=DOC_BATCH)
    pkg.utils.telemetry.configure(path)
    try:
        cs = pkg.CountSketch(16, random_state=0, backend="numpy").fit_source(src)
        list(cs.transform_stream(src))
    finally:
        pkg.utils.telemetry.shutdown()


def _packages():
    import randomprojection_tpu as ref
    import randomprojection_tpu.ops.hashing  # noqa: F401
    import randomprojection_tpu.streaming  # noqa: F401
    import randomprojection_tpu.utils.telemetry  # noqa: F401
    import randomprojection_tpu_torch as port
    import randomprojection_tpu_torch.ops.hashing  # noqa: F401
    import randomprojection_tpu_torch.streaming  # noqa: F401

    return ref, port


@pytest.mark.parametrize("source", ["callable", "token"])
def test_default_stream_spans_equal_the_reference(tmp_path, X, source):
    """Without ``stats`` a source times no read: the batch traces carry the
    reference's span names, and no ``read`` span."""
    ref, port = _packages()
    names = {}
    for tag, pkg in (("ref", ref), ("port", port)):
        path = str(tmp_path / f"{tag}.jsonl")
        if source == "callable":
            _callable_stream(pkg, X, path)
        else:
            _token_stream(pkg, path)
        names[tag] = _span_names(path)
    assert "read" not in names["port"]
    assert names["port"] == names["ref"]


def test_stats_opens_the_read_stage(X, sink):
    """With ``stats`` the source's read is a stage of its own (the opt-in
    divergence): its wall is counted and its span is traced."""
    est = GaussianRandomProjection(8, random_state=0,
                                   backend_options=CPU).fit(X)
    stats = obs.StreamStats()
    from randomprojection_tpu_torch.streaming import CallableSource

    src = CallableSource(lambda lo, hi: X[lo:hi], N, D, batch_rows=BATCH,
                         stats=stats)
    list(stream_transform(est, src, stats=stats))
    telemetry.shutdown()
    assert "read" in stats.stage_wall
    assert _span_names(sink).count("read") == N // BATCH


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_build_report_equals_the_reference(tmp_path, X, writer):
    """The port's ``build_report`` returns the reference's dict on the same
    log: one written by a port stream, one by a reference stream (a
    prefetched stream with ``stats``, so queue depth and stages are in)."""
    from randomprojection_tpu_torch.utils.trace_report import (
        build_report as port_build_report,
    )

    ref, port = _packages()
    pkg = port if writer == "port" else ref
    path = str(tmp_path / "events.jsonl")
    pkg.utils.telemetry.configure(path)
    try:
        est = pkg.GaussianRandomProjection(8, random_state=0,
                                           backend="numpy").fit(X)
        stats = pkg.utils.observability.StreamStats()
        src = pkg.streaming.PrefetchSource(
            pkg.streaming.ArraySource(X, BATCH), depth=2,
            prepare=est.prepare_batch, stats=stats)
        list(est.transform_stream(src, stats=stats))
        pkg.utils.telemetry.emit("index.lsh.fallback", reason="dense")
    finally:
        pkg.utils.telemetry.shutdown()
    got = port_build_report(path)
    assert got == build_report(path)
    assert got["traces"]["batches"] == N // BATCH
    assert got["degraded"]["index.lsh.fallback"] == 1


def test_active_path_and_read_events_follow_the_sink(tmp_path):
    path = str(tmp_path / "events.jsonl")
    assert telemetry.active_path() is None
    telemetry.configure(path)
    try:
        assert telemetry.active_path() == path
        telemetry.emit("stream.commit", row=3)
    finally:
        telemetry.shutdown()
    assert telemetry.active_path() is None
    with open(path, "a") as f:
        f.write('{"v": 2, "ts": 1.0, "ev')  # a torn final line
    got = list(telemetry.read_events(path))
    assert got == list(read_events(path))
    assert [e["event"] for e in got] == ["stream.commit"]
