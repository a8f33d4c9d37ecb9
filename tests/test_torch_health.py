"""The port's health plane (``randomprojection_tpu_torch/utils/health.py``)
against the JAX package's.

``parse_slo_spec`` gives the reference's dicts and raises its errors on a
table of specs; each detector and ``HealthEngine.evaluate(now)``, fed the
same ``(rec, now)`` sequence under an explicit clock, gives the
reference's transitions, firing keys, ``ok()``/``active()`` and mirrored
gauges; the engine's live subscription never blocks the emitter; a
watchdog trip dumps the attached recorder once a stage; and
``health_smoke --device cpu`` passes end to end (loadgen burn over real
HTTP, the stall watchdog, a SIGTERM'd stream-bench's postmortem).
"""

import subprocess
import sys
import time
from pathlib import Path

import pytest

from randomprojection_tpu.utils import health as ref_health
from randomprojection_tpu.utils import telemetry as ref_telemetry
from randomprojection_tpu_torch.utils import health, telemetry
from randomprojection_tpu_torch.utils.telemetry import EVENTS

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _no_subscriber_left():
    """Every test leaves the port's live plane as it found it: no
    subscription (which would keep ``enabled()`` true for the rest of the
    worker)."""
    assert not telemetry._SUBSCRIPTIONS
    yield
    for sub in list(telemetry._SUBSCRIPTIONS):
        telemetry.unsubscribe(sub)


def _latency(total_s, label=None, server="topk", ts=None):
    rec = {"event": EVENTS.SERVE_LATENCY_REQUEST, "total_s": total_s,
           "server": server}
    if label is not None:
        rec["label"] = label
    if ts is not None:
        rec["ts"] = ts
    return rec


def _deliver(depth, capacity=2):
    return {"event": EVENTS.STREAM_PREFETCH_DELIVER, "queue_depth": depth,
            "capacity": capacity}


def _span(name):
    return {"event": EVENTS.SPAN_END, "name": name, "dur_s": 0.01}


# -- parse_slo_spec ------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    None, "", "25", "25, tenant-a=10, budget=0.05, stall=2.5",
    "budget=0.01,fast=1,slow=5,fire=8,clear=4,stall=3,tick=0.1",
    "0.001,fast=1,slow=2.5,tick=0.1,stall=30", "tenant-a=3,tenant-b=7,,",
    "not-a-number", "tenant-a=fast", "tenant-a=0", "budget=-1", "-1", "=5",
])
def test_parse_slo_spec_equals_the_reference(spec):
    try:
        want = ref_health.parse_slo_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as info:
            health.parse_slo_spec(spec)
        assert str(info.value) == str(e)
        return
    assert health.parse_slo_spec(spec) == want


@pytest.mark.parametrize("spec", ["10,budget=2", "10,fast=60,slow=5",
                                  "10,fire=2,clear=3"])
def test_burn_rate_range_checks_equal_the_reference(spec):
    with pytest.raises(ValueError) as want:
        ref_health.BurnRateDetector(ref_health.parse_slo_spec(spec))
    with pytest.raises(ValueError) as got:
        health.BurnRateDetector(health.parse_slo_spec(spec))
    assert str(got.value) == str(want.value)


# -- detectors under an explicit clock ------------------------------------------


def _run_detector(make, steps):
    """Feed ``steps`` (``("event", rec, now)``, ``("observe", name, value,
    now)`` or ``("eval", now)``) to a detector; the transitions drained
    after each evaluation and the firing keys at the end."""
    det = make()
    seq = []
    for step in steps:
        if step[0] == "event":
            det.on_event(step[1], step[2])
        elif step[0] == "observe":
            det.observe(step[1], step[2], step[3])
        else:
            det.evaluate(step[1])
            seq.append(det.drain())
    return seq, det.firing_keys()


def _burn_steps():
    t0 = 1000.0
    steps = [("event", _latency(0.001), t0 + i * (50.0 / 300.0))
             for i in range(300)]
    steps += [("event", _latency(0.5, label="tenant-a"), t0 + 50.0 + i * 0.2)
              for i in range(20)]
    steps += [("event", _latency(0.5), t0 + 50.0 + i * 0.2) for i in range(20)]
    steps += [("eval", t0 + 55.0), ("eval", t0 + 56.0), ("eval", t0 + 62.0),
              ("eval", t0 + 90.0), ("eval", t0 + 200.0)]
    return steps


def _stall_steps():
    steps = [("event", _span("hash"), 1000.0 + i * 0.1) for i in range(5)]
    steps += [("event", _deliver(2), 1000.5), ("eval", 1001.0),
              ("eval", 1006.0), ("event", _span("hash"), 1007.0),
              ("eval", 1007.5), ("eval", 1013.0)]
    steps += [("event", _span("dispatch"), 1014.0 + i) for i in range(2)]
    steps += [("event", _deliver(0), 1020.0), ("eval", 1030.0)]
    return steps


def _pinned_steps():
    steps = [("event", _deliver(2), 1000.0 + i) for i in range(7)]
    steps += [("eval", 1004.0), ("eval", 1006.0), ("eval", 1007.0),
              ("event", _deliver(1), 1008.0), ("eval", 1008.5)]
    return steps


def _spike_steps():
    steps = [("observe", "c", 0.0, 1000.0 + i) for i in range(56)]
    steps += [("observe", "c", 25.0 * i, 1057.0 + i) for i in range(4)]
    steps += [("eval", 1060.0)]
    steps += [("observe", "c", 75.0, 1061.0 + i) for i in range(8)]
    steps += [("eval", 1069.0)]
    steps += [("observe", "s", 5.0 * i, 1000.0 + i) for i in range(61)]
    steps += [("eval", 1070.0)]
    return steps


@pytest.mark.parametrize("name,make,steps", [
    ("burn", lambda m: m.BurnRateDetector(
        m.parse_slo_spec("10,tenant-a=100,fast=5,slow=60"), refire_s=3.0),
     _burn_steps),
    ("burn_min_count", lambda m: m.BurnRateDetector(
        m.parse_slo_spec("10"), min_count=30), _burn_steps),
    ("stall", lambda m: m.StallWatchdog(timeout_s=5.0), _stall_steps),
    ("stall_no_queue", lambda m: m.StallWatchdog(
        timeout_s=2.0, require_queue=False), _stall_steps),
    ("pinned", lambda m: m.QueuePinnedDetector(window_s=5.0), _pinned_steps),
    ("spike", lambda m: m.DegradedSpikeDetector(
        counters=("c", "s"), fast_window_s=5.0, slow_window_s=60.0,
        min_rate=1.0, spike_ratio=10.0), _spike_steps),
])
def test_detector_verdicts_equal_the_reference(name, make, steps):
    got = _run_detector(lambda: make(health), steps())
    want = _run_detector(lambda: make(ref_health), steps())
    assert got == want
    assert any(seq for seq in got[0]), f"{name}: no transition exercised"


# -- the engine ------------------------------------------------------------------


def _engine_run(mod, tel, tag):
    """An engine with every detector kind, fed through ``_on_event`` and
    evaluated at explicit times; the spike detector polls two counters
    unique to ``tag`` that both registries advance alike."""
    spec = mod.parse_slo_spec("10,fast=5,slow=60,stall=2")
    counter = f"test.health.{tag}.degraded"
    eng = mod.HealthEngine(slo=spec, detectors=[
        mod.BurnRateDetector(spec),
        mod.StallWatchdog(timeout_s=2.0),
        mod.QueuePinnedDetector(window_s=2.0),
        mod.DegradedSpikeDetector(counters=(counter,), min_rate=1.0),
    ])
    reg = tel.registry()
    out = []
    for i in range(20):
        eng._on_event(_latency(0.5, label="a", ts=1000.0 + i * 0.1))
    for i in range(4):
        eng._on_event({**_span("h2d"), "ts": 1000.0 + i * 0.2})
        eng._on_event({**_deliver(2), "ts": 1000.0 + i * 0.2})
    # a verdict event fed back in must be ignored
    eng._on_event({"event": EVENTS.HEALTH_STALL, "ts": 1000.0,
                   "status": "firing"})
    for now, bump in ((1000.0, 0), (1002.5, 0), (1004.0, 40), (1005.0, 80),
                      (1009.0, 0), (1080.0, 0)):
        reg.counter_inc(counter, bump)
        trans = eng.evaluate(now=now)
        out.append((
            [{k: v for k, v in t.items()} for t in trans],
            eng.ok(),
            eng.active(),
            {d.event: reg.gauge(f"{d.event}.firing")["last"]
             for d in eng.detectors},
        ))
    eng.close()
    return out


def test_engine_evaluate_equals_the_reference():
    got = _engine_run(health, telemetry, "port")
    want = _engine_run(ref_health, ref_telemetry, "ref")
    # the spike detector's counter name carries the tag
    for g in (got, want):
        for trans, _, active, _ in g:
            for t in trans + active:
                for key in ("key", "counter"):
                    if isinstance(t.get(key), str):
                        t[key] = t[key].replace(".port.", ".").replace(
                            ".ref.", ".")
    assert got == want
    assert not got[1][1]  # a critical verdict fires by 1002.5 (503)
    statuses = {t["status"] for trans, *_ in got for t in trans}
    assert statuses == {"firing", "cleared"}


def test_engine_emits_verdicts_on_the_port_spine():
    got = []
    sub = telemetry.subscribe(got.append, name="t-health-spine")
    try:
        spec = health.parse_slo_spec("10")
        eng = health.HealthEngine(slo=spec,
                                  detectors=[health.BurnRateDetector(spec)])
        for i in range(20):
            eng._on_event(_latency(0.5, ts=1000.0 + i * 0.1))
        eng.evaluate(now=1002.5)
        deadline = time.monotonic() + 5.0
        while not got and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        telemetry.unsubscribe(sub)
    burns = [r for r in got if r["event"] == EVENTS.HEALTH_SLO_BURN]
    assert burns and burns[0]["status"] == "firing"
    assert telemetry.registry().gauge("health.slo_burn.firing")["last"] >= 1


def test_engine_thread_is_named_and_joined():
    eng = health.HealthEngine(tick_s=0.02).start()
    try:
        import threading

        names = {t.name for t in threading.enumerate()}
        assert "rp-torch-health-tick" in names
        assert "rp-torch-telemetry-sub-health-engine" in names
    finally:
        eng.close()
    eng.close()  # idempotent
    assert not telemetry._SUBSCRIPTIONS


def test_engine_subscription_never_blocks_the_emitter():
    """A wedged engine (its lock held) costs the emitter a dropped event,
    never a stall."""
    eng = health.HealthEngine(maxsize=2, tick_s=60.0).start()
    try:
        with eng._lock:
            t0 = time.perf_counter()
            for i in range(300):
                telemetry.emit(EVENTS.SERVE_LATENCY_REQUEST, server="w",
                               total_s=0.001)
            elapsed = time.perf_counter() - t0
        assert elapsed < 1.0
        assert eng._sub.stats()["dropped"] > 0
    finally:
        eng.close()


def test_watchdog_trip_dumps_the_recorder_once_a_stage(tmp_path):
    rec = telemetry.FlightRecorder()
    path = str(tmp_path / "wd.json")
    rec.install(path, signals=(), on_exception=False)
    try:
        eng = health.HealthEngine(
            detectors=[health.StallWatchdog(timeout_s=1.0)], recorder=rec)
        for i in range(4):
            eng._on_event({**_span("hash"), "ts": 1000.0 + i * 0.1})
            eng._on_event({**_deliver(2), "ts": 1000.0 + i * 0.1})
        eng.evaluate(now=1002.0)
        first = Path(path).stat().st_mtime_ns
        eng.evaluate(now=1040.0)  # still firing, re-emitted: no new dump
        assert Path(path).stat().st_mtime_ns == first
    finally:
        rec.uninstall()
    import json

    with open(path) as f:
        assert json.load(f)["reason"] == "watchdog:hash"


def test_health_smoke_passes_on_the_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "randomprojection_tpu_torch.utils.health_smoke",
         "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, timeout=240,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert "health-smoke OK" in r.stdout
