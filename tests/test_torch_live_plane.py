"""The port's live plane against the JAX package's: telemetry subscribers,
``LiveAggregator``, ``FlightRecorder``, the OpenMetrics exposition, the
metrics endpoint, the doctor's text views and the live smoke.

``MetricsRegistry.snapshot`` and ``to_openmetrics`` of the same metrics
are the reference's, byte for byte; ``LiveAggregator.snapshot(now)`` and
``registry_snapshot(now)`` return the reference's dicts on the same event
sequence; a port flight-recorder dump is read by the reference's
``build_postmortem`` into the port's dict, and ``render_report``/
``render_postmortem``/``render_live`` print the reference's text; a
``MetricsServer(port=0)`` scrape parses with the reference's
``parse_openmetrics`` and ``/health`` answers 200/503; a subscriber's
drops are counted and never block the emitter; a ``probe_policy`` server's
``serve.latency.request`` events carry ``probes`` with the reference's key
set; ``doctor`` (file, ``--json``,
``--postmortem``, ``--live``) runs; ``live_smoke --device cpu`` passes.
"""

import json
import os
import signal
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from randomprojection_tpu.utils import metrics_server as ref_ms
from randomprojection_tpu.utils import telemetry as ref_telemetry
from randomprojection_tpu.utils import trace_report as ref_report
from randomprojection_tpu_torch import cli
from randomprojection_tpu_torch.utils import health, metrics_server, telemetry
from randomprojection_tpu_torch.utils import trace_report
from randomprojection_tpu_torch.utils.telemetry import EVENTS


@pytest.fixture(autouse=True)
def _no_subscriber_left():
    """Every test leaves the port's live plane as it found it: no
    subscription (it would keep ``enabled()`` true for every later test
    of the worker), no sink, no metrics server."""
    assert not telemetry._SUBSCRIPTIONS and not telemetry.enabled()
    yield
    for sub in list(telemetry._SUBSCRIPTIONS):
        telemetry.unsubscribe(sub)
    telemetry.shutdown()
    assert cli._METRICS_SERVER is None


def _wait(predicate, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return False


# -- subscribers -----------------------------------------------------------------


def test_subscribe_activates_telemetry_without_a_sink():
    got = []
    sub = telemetry.subscribe(got.append, name="t-basic")
    try:
        assert telemetry.enabled()
        assert any(t.name == "rp-torch-telemetry-sub-t-basic"
                   for t in threading.enumerate())
        telemetry.emit(EVENTS.STREAM_COMMIT, row=7)
        with telemetry.span("batch", new_trace=True):
            pass
        assert _wait(lambda: len(got) >= 3)
        names = [r["event"] for r in got]
        assert EVENTS.STREAM_COMMIT in names
        assert EVENTS.SPAN_START in names and EVENTS.SPAN_END in names
    finally:
        telemetry.unsubscribe(sub)
    assert not telemetry.enabled()
    telemetry.emit(EVENTS.STREAM_COMMIT, row=8)
    assert not any(r.get("row") == 8 for r in got)
    telemetry.unsubscribe(sub)  # idempotent
    with pytest.raises(TypeError):
        telemetry.subscribe("not-callable")
    with pytest.raises(ValueError):
        telemetry.subscribe(lambda rec: None, maxsize=0)


def test_slow_subscriber_drops_are_counted_and_never_block():
    reg = telemetry.registry()
    before = reg.counter("telemetry.subscriber.dropped")
    before_named = reg.counter("telemetry.subscriber.t-slow.dropped")
    sub = telemetry.subscribe(lambda rec: time.sleep(0.05), maxsize=2,
                              name="t-slow")
    try:
        t0 = time.perf_counter()
        for i in range(300):
            telemetry.emit(EVENTS.STREAM_COMMIT, row=i)
        assert time.perf_counter() - t0 < 1.0
        st = sub.stats()
        assert st["dropped"] > 0
        assert reg.counter("telemetry.subscriber.dropped") - before \
            >= st["dropped"]
        assert reg.counter("telemetry.subscriber.t-slow.dropped") \
            - before_named == st["dropped"]
    finally:
        t0 = time.perf_counter()
        telemetry.unsubscribe(sub)
        assert time.perf_counter() - t0 < 2.0  # the backlog is discarded


def test_raising_subscriber_is_counted_and_delivery_continues():
    calls = []

    def bad(rec):
        calls.append(rec)
        raise RuntimeError("observer broke")

    sub = telemetry.subscribe(bad, name="t-raise")
    try:
        telemetry.emit(EVENTS.STREAM_COMMIT, row=1)
        telemetry.emit(EVENTS.STREAM_COMMIT, row=2)
        assert _wait(lambda: sub.stats()["delivered"] >= 2)
        assert sub.stats()["errors"] >= 2 and len(calls) == 2
    finally:
        telemetry.unsubscribe(sub)


# -- registry snapshot and OpenMetrics ----------------------------------------


def _fill(reg):
    reg.counter_inc("stream.rows", 4096)
    reg.counter_inc("serve.topk.batches", 3)
    reg.counter_inc("weird name/with:chars", 2.5)
    for v in (1, 7, 3):
        reg.gauge_set("stream.queue_depth", v)
    rng = np.random.default_rng(5)
    for v in rng.uniform(1e-6, 2e-1, size=300):
        reg.observe("serve.latency.sharded", float(v))
    reg.observe("stage.h2d", 0.0123)
    reg.observe("never.twice", 0.5)
    with reg.timer("timed.block"):
        pass


def test_snapshot_and_openmetrics_equal_the_reference():
    port_reg, ref_reg = telemetry.MetricsRegistry(), ref_telemetry.MetricsRegistry()
    _fill(port_reg)
    _fill(ref_reg)
    ps, rs = port_reg.snapshot(), ref_reg.snapshot()
    # the timer's wall differs between the two calls; all else is equal
    for s in (ps, rs):
        s["histograms"]["timed.block"] = {"count": s["histograms"][
            "timed.block"]["count"]}
    assert ps == rs
    assert json.loads(json.dumps(ps)) == ps
    ps, rs = port_reg.snapshot(), ref_reg.snapshot()
    ps["histograms"].pop("timed.block")
    rs["histograms"].pop("timed.block")
    assert telemetry.to_openmetrics(ps) == ref_telemetry.to_openmetrics(rs)
    extra = {"counters": {"stream.rows": 1}, "gauges": {
        "stream.queue_depth": {"last": 9, "max": 9, "sum": 9, "n": 1}},
        "histograms": {}}
    assert telemetry.to_openmetrics(ps, extra) == \
        ref_telemetry.to_openmetrics(rs, extra)
    assert telemetry.to_openmetrics().endswith("# EOF\n")


# -- LiveAggregator --------------------------------------------------------------


def _agg_events():
    t0 = 1000.0
    ev = []
    for i in range(12):
        ev.append({"v": 2, "ts": t0 + i, "event": EVENTS.SPAN_END,
                   "name": "dispatch" if i % 3 else "h2d", "dur_s": 0.1 * i})
        ev.append({"v": 2, "ts": t0 + i + 0.5, "event":
                   EVENTS.STREAM_PREFETCH_DELIVER if i % 2 else
                   EVENTS.STREAM_STAGED_DELIVER,
                   "queue_depth": i % 4, "capacity": 4 if i < 8 else None})
        ev.append({"v": 2, "ts": t0 + i + 0.7, "event": EVENTS.STREAM_COMMIT})
    ev.append({"event": "no-ts"})
    ev.append({"ts": t0, "event": 7})
    return ev


@pytest.mark.parametrize("window", [3.0, 10.0])
def test_live_aggregator_equals_the_reference(window):
    port_agg = telemetry.LiveAggregator(window_s=window)
    ref_agg = ref_telemetry.LiveAggregator(window_s=window)
    for rec in _agg_events():
        port_agg(dict(rec))
        ref_agg(dict(rec))
    for now in (1005.0, 1011.8, 1013.0, 1030.0):
        assert port_agg.snapshot(now) == ref_agg.snapshot(now)
        assert port_agg.registry_snapshot(now) == \
            ref_agg.registry_snapshot(now)
        assert telemetry.to_openmetrics(port_agg.registry_snapshot(now)) == \
            ref_telemetry.to_openmetrics(ref_agg.registry_snapshot(now))
    with pytest.raises(ValueError):
        telemetry.LiveAggregator(window_s=0)


# -- FlightRecorder and the postmortem ---------------------------------------------


def test_flight_recorder_dump_reads_alike_in_both_packages(tmp_path):
    rec = telemetry.FlightRecorder(capacity=16)
    sub = telemetry.subscribe(rec, name="t-pm")
    try:
        with telemetry.span("hash", new_trace=True):
            pass
        telemetry.emit(EVENTS.SPAN_START, name="dispatch", span_id="s1",
                       trace_id="t1")
        with telemetry.span("enqueue_wait", new_trace=True):
            pass
        telemetry.registry().counter_inc("test.flight.counter", 3)
        assert _wait(lambda: len(rec.snapshot()) >= 5)
    finally:
        telemetry.unsubscribe(sub)
    path = str(tmp_path / "d.json")
    rec.attach_health(lambda: [{"detector": EVENTS.HEALTH_STALL,
                                "key": "h2d", "critical": True}])
    assert rec.dump(path, reason="on_demand") == path
    assert os.listdir(tmp_path) == ["d.json"]  # tmp -> fsync -> replace
    with open(path) as f:
        dump = json.load(f)
    assert dump["format"] == "rp-flight-recorder" and dump["v"] == 1
    pm = trace_report.build_postmortem(dump)
    assert pm == ref_report.build_postmortem(dump)
    assert pm["last_active_stage"] == "dispatch"
    assert pm["counters"]["test.flight.counter"] >= 3
    text = trace_report.render_postmortem(pm)
    assert text == ref_report.render_postmortem(pm)
    assert "last active stage: dispatch" in text
    with pytest.raises(ValueError) as info:
        trace_report.build_postmortem({"format": "topk_slo"})
    with pytest.raises(ValueError) as want:
        ref_report.build_postmortem({"format": "topk_slo"})
    assert str(info.value) == str(want.value)


def test_flight_recorder_ring_and_install_restore(tmp_path):
    rec = telemetry.FlightRecorder(capacity=4)
    for i in range(10):
        rec({"event": "e", "i": i})
    assert [r["i"] for r in rec.snapshot()] == [6, 7, 8, 9]
    assert rec.dump() is None  # no path known
    prev_sig = signal.getsignal(signal.SIGUSR1)
    prev_hook = sys.excepthook
    rec.install(str(tmp_path / "d.json"), signals=(signal.SIGUSR1,))
    try:
        assert signal.getsignal(signal.SIGUSR1) is not prev_sig
        assert sys.excepthook is not prev_hook
    finally:
        rec.uninstall()
    assert signal.getsignal(signal.SIGUSR1) is prev_sig
    assert sys.excepthook is prev_hook
    rec.uninstall()  # idempotent
    with pytest.raises(ValueError):
        telemetry.FlightRecorder(capacity=0)


def test_a_failed_directory_fsync_is_not_a_crash(tmp_path, monkeypatch):
    def refuse(path, flags):
        raise PermissionError("no directory open here")

    rec = telemetry.FlightRecorder()
    monkeypatch.setattr(os, "open", refuse)
    assert rec.dump(str(tmp_path / "d.json")) == str(tmp_path / "d.json")


# -- the doctor's text on one file ----------------------------------------------


def _rich_log(path):
    """A telemetry file with a batch trace, serving latency, a loadgen run,
    health verdicts, a flight dump and a subscriber overflow."""
    telemetry.configure(path)
    try:
        root = telemetry.start_span("batch", new_trace=True)
        with telemetry.activate_span(root):
            for stage in ("read", "h2d", "dispatch", "d2h"):
                with telemetry.span(stage):
                    time.sleep(0.001)
        telemetry.end_span(root, row=64)
        for i in range(20):
            telemetry.emit(EVENTS.SERVE_LATENCY_REQUEST, server="sharded",
                           label="a" if i % 2 else "b", rows=4,
                           queue_wait_s=0.001, serve_s=0.002,
                           total_s=0.004 * (1 + i % 3), m=4)
        telemetry.emit(EVENTS.LOADGEN_RUN, requests=20, rows=80, rejects=1,
                       errors=0, elapsed_s=0.5, max_lag_s=0.0,
                       schedule_sha256="abc123")
        telemetry.emit(EVENTS.HEALTH_SLO_BURN, key="sharded[a]/fast",
                       status="firing")
        telemetry.emit(EVENTS.HEALTH_SLO_BURN, key="sharded[a]/fast",
                       status="cleared")
        telemetry.emit(EVENTS.HEALTH_STALL, key="h2d", status="firing")
        telemetry.emit(EVENTS.HEALTH_FLIGHT_DUMP, reason="watchdog:h2d",
                       path="/x", events=3)
        telemetry.emit(EVENTS.TELEMETRY_SUBSCRIBER_DROPPED,
                       subscriber="slow", dropped=2, dropped_total=5)
        telemetry.emit(EVENTS.SERVE_TOPK_BATCH, rows=8, padded=8,
                       requests=2, m=4, wall_s=0.001, probes=2)
    finally:
        telemetry.shutdown()


def test_render_report_prints_the_reference_text(tmp_path):
    path = str(tmp_path / "rich.jsonl")
    _rich_log(path)
    rep = trace_report.build_report(path)
    assert rep == ref_report.build_report(path)
    for tripwire in (None, {"error": "none committed"},
                     {"baseline": "B.json", "regressions": [],
                      "regressions_vs": "A.json"}):
        if tripwire is not None:
            rep["tripwire"] = tripwire
        assert trace_report.render_report(rep) == \
            ref_report.render_report(rep)
    text = trace_report.render_report(rep)
    assert "serve latency" in text and "health verdicts" in text


def test_doctor_cli_file_json_and_postmortem(tmp_path, capsys):
    path = str(tmp_path / "rich.jsonl")
    _rich_log(path)
    cli.main(["doctor", "--json", path])
    rep = json.loads(capsys.readouterr().out)
    want = ref_report.build_report(path)
    assert {k: v for k, v in rep.items() if k != "tripwire"} == want
    assert "H100" in rep["tripwire"]["error"]
    cli.main(["report", path])
    assert "regression tripwire: unavailable" in capsys.readouterr().out
    rec = telemetry.FlightRecorder()
    rec({"event": EVENTS.SPAN_START, "name": "h2d", "span_id": "1",
         "ts": time.time()})
    dump = rec.dump(str(tmp_path / "pm.json"))
    cli.main(["doctor", "--postmortem", dump])
    assert "last active stage: h2d" in capsys.readouterr().out
    for argv in (["doctor"], ["doctor", str(tmp_path / "none.jsonl")],
                 ["doctor", "--postmortem", path],
                 ["doctor", "--live", "nohost"],
                 ["doctor", "--live", "127.0.0.1:1", "--iterations", "1"]):
        with pytest.raises(SystemExit):
            cli.main(argv)


# -- the metrics endpoint ------------------------------------------------------------


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=5.0) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_metrics_server_scrape_parses_with_the_reference():
    reg = telemetry.MetricsRegistry()
    _fill(reg)
    agg = telemetry.LiveAggregator()
    agg({"v": 2, "ts": time.time(), "event": EVENTS.SPAN_END,
         "name": "dispatch", "dur_s": 0.5})
    spec = health.parse_slo_spec("10")
    eng = health.HealthEngine(slo=spec,
                              detectors=[health.BurnRateDetector(spec)])
    with metrics_server.MetricsServer(port=0, aggregator=agg,
                                      sources=[reg.snapshot],
                                      health=eng) as ms:
        assert any(t.name == "rp-torch-metrics-server"
                   for t in threading.enumerate())
        text = metrics_server.fetch_metrics("127.0.0.1", ms.port)
        assert _get(f"http://127.0.0.1:{ms.port}/nope")[0] == 404
        code, body = _get(f"http://127.0.0.1:{ms.port}/health")
        assert code == 200 and json.loads(body) == {
            "ok": True, "attached": True, "active": []}
        for i in range(20):
            eng._on_event({"event": EVENTS.SERVE_LATENCY_REQUEST,
                           "server": "sharded", "total_s": 0.5,
                           "ts": 1000.0 + i * 0.1})
        eng.evaluate(now=1002.5)
        code, body = _get(f"http://127.0.0.1:{ms.port}/health")
        assert code == 503 and json.loads(body)["active"]
        eng.evaluate(now=1300.0)
        assert _get(f"http://127.0.0.1:{ms.port}/health")[0] == 200
    eng.close()
    assert text.endswith("# EOF\n")
    plain, labeled = ref_ms.parse_openmetrics(text)
    assert (plain, labeled) == metrics_server.parse_openmetrics(text)
    assert plain["rp_live_span_dispatch_wall_s"] == 0.5
    assert 'quantile="0.99"' in labeled[
        "rp_serve_latency_sharded_seconds_quantile"]
    prev = dict(plain, rp_serve_topk_rejects_total=0.0)
    for kw in ({}, {"interval_s": 2.0, "endpoint": "h:1", "poll": 3}):
        assert metrics_server.render_live(plain, labeled, prev, **kw) == \
            ref_ms.render_live(plain, labeled, prev, **kw)
    assert metrics_server.live_snapshot_json(plain, labeled) == \
        ref_ms.live_snapshot_json(plain, labeled)


def test_health_endpoint_without_engine_is_honest():
    with metrics_server.MetricsServer(port=0) as ms:
        code, body = _get(f"http://127.0.0.1:{ms.port}/health")
    assert code == 200
    assert json.loads(body) == {"ok": True, "attached": False, "active": []}


def test_doctor_live_polls_a_real_endpoint(capsys):
    telemetry.registry().observe("serve.latency.live-doc", 0.004)
    with metrics_server.MetricsServer(port=0) as ms:
        assert cli.main(["doctor", "--live", f"127.0.0.1:{ms.port}",
                         "--iterations", "2", "--interval", "0.05"]) == 0
        out = capsys.readouterr().out
        assert "live doctor" in out and "poll #2" in out
        assert cli.main(["doctor", "--live", f"127.0.0.1:{ms.port}",
                         "--iterations", "1", "--json"]) == 0
        assert "metrics" in json.loads(capsys.readouterr().out)


# -- C2: probes on every serve.latency.request of a probe_policy server ----------


def _latency_keys(mod_sketch, mod_lsh, mod_tel, path, **index_kw):
    codes = np.random.default_rng(3).integers(0, 256, size=(400, 8),
                                              dtype=np.uint8)
    index = mod_lsh.LSHSimHashIndex(codes, bands=4, band_bits=4,
                                    fallback_density=1.0, **index_kw)
    mod_tel.configure(path)
    try:
        with mod_sketch.TopKServer(index, 5, max_delay_s=0.0,
                                   probe_policy={"a": 2, "b": 0},
                                   name="c2") as srv:
            q = codes[:8]
            for label in ("a", "b", None):
                srv.query(q, label=label)
    finally:
        mod_tel.shutdown()
    events = list(mod_tel.read_events(path))
    lat = [e for e in events if e["event"] == EVENTS.SERVE_LATENCY_REQUEST]
    batch = [e for e in events if e["event"] == EVENTS.SERVE_TOPK_BATCH]
    return ({e["label"]: sorted(e) for e in lat},
            {e.get("probes") for e in batch})


def test_probe_policy_latency_events_carry_probes(tmp_path):
    import randomprojection_tpu.ann.lsh as ref_ann
    import randomprojection_tpu_torch.ann.lsh as ann
    from randomprojection_tpu.models import sketch as ref_sketch
    from randomprojection_tpu_torch.models import sketch

    got = _latency_keys(sketch, ann, telemetry, str(tmp_path / "p.jsonl"),
                        device="cpu", probe_path="host")
    want = _latency_keys(ref_sketch, ref_ann, ref_telemetry,
                         str(tmp_path / "r.jsonl"), probe_path="host",
                         topk_impl="scan")
    assert got == want
    assert "probes" in got[0]["a"] and "probes" in got[0]["b"]
    assert "probes" not in got[0][None]


# -- the live smoke -----------------------------------------------------------------


def test_live_smoke_passes_on_the_cpu(capsys):
    from randomprojection_tpu_torch.utils import live_smoke

    assert live_smoke.main(["--device", "cpu"]) == 0
    assert "live-smoke OK" in capsys.readouterr().out
