"""Health plane: typed verdicts over the live event stream (a copy of the
reference's ``randomprojection_tpu/utils/health.py``; the port imports
nothing of that package).

- **HealthEngine** subscribes to the live stream (``telemetry.subscribe``:
  a bounded queue that drops and never blocks the emitter) and folds
  events into detectors; a tick thread (``rp-torch-health-tick``)
  evaluates them on a fixed cadence, because a stall is exactly the case
  where no event arrives.  ``evaluate(now)`` may be driven with an
  explicit clock, with no thread.
- **Detectors**: each verdict is a registered ``health.*`` event with a
  firing/cleared lifecycle, emitted once a transition, re-emitted at most
  every ``refire_s`` while firing, and mirrored as a
  ``health.<detector>.firing`` gauge on the process registry.

  - ``BurnRateDetector`` (``health.slo_burn``): multi-window SLO burn
    rate over ``serve.latency.request``'s ``total_s``, per (server,
    label): the violation fraction over the error ``budget``; a fast and
    a slow window fire independently, each with hysteresis (fire at
    ``fire_burn``, clear at ``clear_burn``).
  - ``StallWatchdog`` (``health.stall``): a stage that was emitting spans
    goes silent for ``timeout_s`` while the last delivered queue depth is
    nonzero and stale; a firing trips the attached ``FlightRecorder``.
  - ``QueuePinnedDetector`` (``health.queue_pinned``): the queue depth at
    capacity for a whole window.
  - ``DegradedSpikeDetector`` (``health.degraded_spike``): a degraded
    counter's fast-window rate above ``min_rate`` and ``spike_ratio``
    times its slow-window baseline.

Concurrency: all detector state is guarded by one engine lock; events are
emitted and the recorder tripped outside it, and the engine ignores its
own ``health.*`` events.

``parse_slo_spec`` is the ``--health`` grammar: a bare number is the
default p99 target in ms, ``label=ms`` a per-label target, and the
reserved keys ``budget``/``fast``/``slow``/``fire``/``clear``/``stall``/
``tick`` tune the engine; ``loadgen`` records the same spec in its
``topk_slo`` record (``slo_targets``).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from randomprojection_tpu_torch.utils import telemetry
from randomprojection_tpu_torch.utils.telemetry import EVENTS

# Closed set of verdict names the engine may emit, one statically
# lintable call site per event (a dynamic name is unauditable).  A detector whose ``event``
# is missing here fails loudly at emit time instead of minting a rogue
# ``health.*`` name that no consumer folds.
_VERDICT_EMIT = {
    EVENTS.HEALTH_SLO_BURN:
        lambda **f: telemetry.emit(EVENTS.HEALTH_SLO_BURN, **f),
    EVENTS.HEALTH_STALL:
        lambda **f: telemetry.emit(EVENTS.HEALTH_STALL, **f),
    EVENTS.HEALTH_QUEUE_PINNED:
        lambda **f: telemetry.emit(EVENTS.HEALTH_QUEUE_PINNED, **f),
    EVENTS.HEALTH_DEGRADED_SPIKE:
        lambda **f: telemetry.emit(EVENTS.HEALTH_DEGRADED_SPIKE, **f),
}

__all__ = [
    "parse_slo_spec",
    "BurnRateDetector",
    "StallWatchdog",
    "QueuePinnedDetector",
    "DegradedSpikeDetector",
    "HealthEngine",
    "DEFAULT_DEGRADED_COUNTERS",
]

# reserved config keys in a --health spec; anything else on the left of
# '=' is a client label with a per-label target in ms
_SPEC_KEYS = ("budget", "fast", "slow", "fire", "clear", "stall", "tick")

# counters the spike detector polls by default — the same degraded
# ladder the doctor audits post-hoc, plus the serving-tier shed counter
DEFAULT_DEGRADED_COUNTERS = (
    "telemetry.subscriber.dropped",
    "serve.topk.rejects",
    "serve.topk.errors",
    "backend.vmem_oom_retries",
    "simhash.topk_dense_fallbacks",
    "simhash.topk_scan_fallbacks",
    "index.lsh.fallbacks",
)


def parse_slo_spec(text: Optional[str]) -> dict:
    """Parse a ``--health`` spec into
    ``{"default_ms", "labels": {label: ms}, "config": {key: float}}``.

    Grammar (comma-separated): a bare number = the default p99 target
    in milliseconds for every label; ``label=ms`` = a per-label target;
    reserved keys (``budget``, ``fast``, ``slow``, ``fire``,
    ``clear``, ``stall``, ``tick``) tune the engine instead of naming
    a label.  Empty/None = no latency targets (the burn-rate detector
    stays dormant; stall/queue/spike detectors still run).  Raises
    ``ValueError`` on malformed entries.
    """
    out: dict = {"default_ms": None, "labels": {}, "config": {}}
    if not text:
        return out
    for part in str(text).split(","):
        part = part.strip()
        if not part:
            continue
        key, eq, val = part.partition("=")
        key = key.strip()
        if not eq:
            try:
                default_ms = float(key)
            except ValueError:
                raise ValueError(
                    f"--health spec entry {part!r}: want a bare "
                    "default-target number, label=ms, or a reserved "
                    f"key={_SPEC_KEYS}"
                )
            if default_ms <= 0:
                raise ValueError(
                    f"--health spec entry {part!r}: values must be > 0"
                )
            out["default_ms"] = default_ms
            continue
        if not key:
            raise ValueError(
                f"--health spec entry {part!r}: empty label"
            )
        try:
            num = float(val)
        except ValueError:
            raise ValueError(
                f"--health spec entry {part!r}: {val!r} is not a number"
            )
        if num <= 0:
            raise ValueError(
                f"--health spec entry {part!r}: values must be > 0"
            )
        if key in _SPEC_KEYS:
            out["config"][key] = num
        else:
            out["labels"][key] = num
    return out


class _Hysteresis:
    """Per-key firing/cleared state machine shared by every detector:
    transitions are recorded once (dedup), still-firing keys re-emit at
    most every ``refire_s`` (rate limit).  Mutated only under the
    engine lock; the engine drains ``transitions`` outside it."""

    __slots__ = ("firing", "since", "last_emit", "fields")

    def __init__(self):
        self.firing = False
        self.since = 0.0
        self.last_emit = 0.0
        self.fields: dict = {}


class _Detector:
    """Base detector: owns per-key hysteresis state and the transition
    queue the engine drains.  Subclasses implement ``on_event`` (fold
    one event, under the engine lock) and ``evaluate`` (recompute each
    key's condition at ``now``, under the engine lock)."""

    #: the EVENTS-registered ``health.*`` name this detector emits
    event = ""
    #: a firing critical detector turns ``GET /health`` to 503
    critical = True

    def __init__(self, *, refire_s: float = 30.0):
        self.refire_s = float(refire_s)
        self._keys: Dict[str, _Hysteresis] = {}
        self._pending: List[dict] = []

    # -- under the engine lock ----------------------------------------------

    def on_event(self, rec: dict, now: float) -> None:
        pass

    def evaluate(self, now: float) -> None:
        raise NotImplementedError

    def _set(self, key: str, firing: bool, now: float, **fields) -> None:
        st = self._keys.get(key)
        if st is None:
            if not firing:
                return
            st = self._keys[key] = _Hysteresis()
        if firing and not st.firing:
            st.firing, st.since, st.last_emit = True, now, now
            st.fields = dict(fields)
            self._pending.append({
                "key": key, "status": "firing", "since": now, **fields,
            })
        elif firing and st.firing:
            st.fields = dict(fields)
            if now - st.last_emit >= self.refire_s:
                st.last_emit = now
                self._pending.append({
                    "key": key, "status": "firing", "since": st.since,
                    **fields,
                })
        elif not firing and st.firing:
            st.firing = False
            self._pending.append({
                "key": key, "status": "cleared", "since": st.since,
                "held_s": round(now - st.since, 3), **fields,
            })

    def drain(self) -> List[dict]:
        out, self._pending = self._pending, []
        return out

    def firing_keys(self) -> List[Tuple[str, dict]]:
        return [
            (k, {"since": st.since, **st.fields})
            for k, st in sorted(self._keys.items())
            if st.firing
        ]


class BurnRateDetector(_Detector):
    """Multi-window SLO burn-rate over ``serve.latency.request`` events
    (see module docstring for the burn-rate definition).  One sample
    deque per (server, label) key holds ``slow_window_s`` of
    ``(ts, violated)`` pairs; the fast window is a suffix of the same
    deque, so memory is one entry per request in the slow window."""

    event = EVENTS.HEALTH_SLO_BURN
    critical = True

    def __init__(self, spec: dict, *, budget: float = 0.01,
                 fast_window_s: float = 5.0, slow_window_s: float = 60.0,
                 fire_burn: float = 10.0, clear_burn: Optional[float] = None,
                 min_count: int = 10, refire_s: float = 30.0):
        super().__init__(refire_s=refire_s)
        cfg = spec.get("config") or {}
        self.default_ms = spec.get("default_ms")
        self.labels = dict(spec.get("labels") or {})
        self.budget = float(cfg.get("budget", budget))
        self.fast_window_s = float(cfg.get("fast", fast_window_s))
        self.slow_window_s = float(cfg.get("slow", slow_window_s))
        self.fire_burn = float(cfg.get("fire", fire_burn))
        self.clear_burn = float(
            cfg.get("clear", clear_burn if clear_burn is not None
                    else self.fire_burn / 2.0)
        )
        if not 0 < self.budget <= 1:
            raise ValueError(f"budget must be in (0, 1], got {self.budget}")
        if self.fast_window_s >= self.slow_window_s:
            raise ValueError(
                f"fast window ({self.fast_window_s}s) must be shorter "
                f"than slow ({self.slow_window_s}s)"
            )
        if self.clear_burn >= self.fire_burn:
            raise ValueError(
                f"clear_burn ({self.clear_burn}) must be below "
                f"fire_burn ({self.fire_burn}) — that gap IS the "
                "hysteresis"
            )
        self.min_count = int(min_count)
        self._samples: Dict[Tuple[str, str], deque] = {}

    def target_ms(self, label: Optional[str]) -> Optional[float]:
        if label is not None and label in self.labels:
            return self.labels[label]
        return self.default_ms

    def on_event(self, rec: dict, now: float) -> None:
        if rec.get("event") != EVENTS.SERVE_LATENCY_REQUEST:
            return
        total = rec.get("total_s")
        if not isinstance(total, (int, float)):
            return
        label = rec.get("label")
        target = self.target_ms(label)
        if target is None:
            return
        key = (str(rec.get("server") or "topk"), str(label or "*"))
        dq = self._samples.setdefault(key, deque())
        dq.append((now, total > target / 1e3))

    def _burn(self, dq: deque, now: float, window_s: float) -> Tuple[
        float, int
    ]:
        horizon = now - window_s
        count = violated = 0
        for ts, bad in reversed(dq):
            if ts < horizon:
                break
            count += 1
            violated += bad
        if count == 0:
            return 0.0, 0
        return (violated / count) / self.budget, count

    def evaluate(self, now: float) -> None:
        for (server, label), dq in self._samples.items():
            horizon = now - self.slow_window_s
            while dq and dq[0][0] < horizon:
                dq.popleft()
            for window, window_s in (("fast", self.fast_window_s),
                                     ("slow", self.slow_window_s)):
                burn, count = self._burn(dq, now, window_s)
                key = f"{server}[{label}]/{window}"
                st = self._keys.get(key)
                already = st.firing if st else False
                if already:
                    firing = burn > self.clear_burn
                else:
                    firing = burn >= self.fire_burn and (
                        count >= self.min_count
                    )
                self._set(
                    key, firing, now, server=server, label=label,
                    window=window, window_s=window_s,
                    burn=round(burn, 3), samples=count,
                    target_ms=self.target_ms(
                        None if label == "*" else label
                    ),
                    budget=self.budget,
                )


class StallWatchdog(_Detector):
    """Per-stage span-heartbeat timeout gated on a pinned queue (see
    module docstring).  ``min_events`` keeps a stage that never really
    started from counting as stalled; the queue guard keeps a finished
    run (queue drained) from counting as stalled."""

    event = EVENTS.HEALTH_STALL
    critical = True

    def __init__(self, *, timeout_s: float = 5.0, min_events: int = 3,
                 require_queue: bool = True, refire_s: float = 30.0):
        super().__init__(refire_s=refire_s)
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self.min_events = int(min_events)
        self.require_queue = bool(require_queue)
        self._stages: Dict[str, Tuple[float, int]] = {}  # last ts, count
        self._queue_depth = 0
        self._queue_ts: Optional[float] = None

    def on_event(self, rec: dict, now: float) -> None:
        name = rec.get("event")
        if name in (EVENTS.SPAN_START, EVENTS.SPAN_END):
            stage = str(rec.get("name"))
            _, n = self._stages.get(stage, (0.0, 0))
            self._stages[stage] = (now, n + 1)
        elif name in (EVENTS.STREAM_PREFETCH_DELIVER,
                      EVENTS.STREAM_STAGED_DELIVER):
            self._queue_depth = rec.get("queue_depth", 0) or 0
            self._queue_ts = now

    def _queue_pinned(self, now: float) -> bool:
        # the last delivered depth persists (the aggregator's time-
        # weighted queue idea): a wedged consumer means no new deliver events,
        # so a PINNED queue is exactly a stale nonzero last sample
        if self._queue_ts is None:
            return False
        return self._queue_depth >= 1 and (
            now - self._queue_ts >= self.timeout_s
        )

    def evaluate(self, now: float) -> None:
        queue_ok = (not self.require_queue) or self._queue_pinned(now)
        for stage, (last_ts, n) in self._stages.items():
            silent_s = now - last_ts
            firing = (
                n >= self.min_events
                and silent_s >= self.timeout_s
                and queue_ok
            )
            self._set(
                stage, firing, now, stage=stage,
                silent_s=round(silent_s, 3), events=n,
                timeout_s=self.timeout_s,
                queue_depth=self._queue_depth,
            )


class QueuePinnedDetector(_Detector):
    """The queue-depth signal has sat at capacity for a full window:
    backpressure collapse.  Pinned-ness is tracked as "time since the
    last sample BELOW capacity" over the persisted piecewise-constant
    depth signal; any sample below capacity clears immediately."""

    event = EVENTS.HEALTH_QUEUE_PINNED
    critical = False

    def __init__(self, *, window_s: float = 5.0, refire_s: float = 30.0):
        super().__init__(refire_s=refire_s)
        self.window_s = float(window_s)
        self._capacity: Optional[int] = None
        self._depth = 0
        self._pinned_since: Optional[float] = None

    def on_event(self, rec: dict, now: float) -> None:
        if rec.get("event") not in (EVENTS.STREAM_PREFETCH_DELIVER,
                                    EVENTS.STREAM_STAGED_DELIVER):
            return
        if rec.get("capacity") is not None:
            self._capacity = rec["capacity"]
        self._depth = rec.get("queue_depth", 0) or 0
        if self._capacity is None or self._depth < self._capacity:
            self._pinned_since = None
        elif self._pinned_since is None:
            self._pinned_since = now

    def evaluate(self, now: float) -> None:
        firing = (
            self._pinned_since is not None
            and now - self._pinned_since >= self.window_s
        )
        self._set(
            "queue", firing, now, depth=self._depth,
            capacity=self._capacity,
            pinned_s=(
                round(now - self._pinned_since, 3)
                if self._pinned_since is not None else 0.0
            ),
        )


class DegradedSpikeDetector(_Detector):
    """Degraded-counter spike vs its own baseline: the engine's tick
    samples each watched counter on the process registry; fire when the
    fast-window rate is both absolutely material (``min_rate``/s) and
    ``spike_ratio`` × the slow-window baseline rate (a counter that has
    ALWAYS ticked at 5/s is a known condition, not a spike)."""

    event = EVENTS.HEALTH_DEGRADED_SPIKE
    critical = False

    def __init__(self, counters=DEFAULT_DEGRADED_COUNTERS, *,
                 fast_window_s: float = 5.0, slow_window_s: float = 60.0,
                 min_rate: float = 1.0, spike_ratio: float = 10.0,
                 refire_s: float = 30.0):
        super().__init__(refire_s=refire_s)
        self.counters = tuple(counters)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.min_rate = float(min_rate)
        self.spike_ratio = float(spike_ratio)
        self._series: Dict[str, deque] = {}  # name -> (ts, value)

    def observe(self, name: str, value: float, now: float) -> None:
        """Record one counter sample (the engine's tick feeds these —
        polling the registry is NOT an event fold, so this detector has
        no ``on_event``)."""
        dq = self._series.setdefault(name, deque())
        dq.append((now, float(value)))
        horizon = now - self.slow_window_s
        # keep one pre-horizon sample as the slow window's left endpoint
        while len(dq) > 1 and dq[1][0] <= horizon:
            dq.popleft()

    def _rate(self, dq: deque, now: float, window_s: float) -> float:
        # per-second rate over the WINDOW (increments / window_s, not
        # / observed span): a series younger than the window reads as
        # if the missing history were zero increments, so a steady
        # counter's fast and slow rates converge to the same number
        # while a burst concentrated in the fast window reads
        # (slow_window/fast_window)× hotter there — the ratio the
        # spike threshold grades
        horizon = now - window_s
        base = None
        for ts, v in dq:
            if ts <= horizon:
                base = (ts, v)
            else:
                if base is None:
                    base = (ts, v)
                break
        if base is None:
            base = dq[0]
        last_v = dq[-1][1]
        return max(last_v - base[1], 0.0) / window_s

    def evaluate(self, now: float) -> None:
        for name, dq in self._series.items():
            if not dq:
                continue
            fast = self._rate(dq, now, self.fast_window_s)
            slow = self._rate(dq, now, self.slow_window_s)
            st = self._keys.get(name)
            already = st.firing if st else False
            threshold = self.min_rate if already else max(
                self.min_rate, self.spike_ratio * slow
            )
            # hysteresis: once firing, only a fast rate back under half
            # the absolute floor clears — a spike that plateaus at the
            # firing threshold must not flap
            firing = fast >= threshold if not already else (
                fast > self.min_rate / 2.0
            )
            self._set(
                name, firing, now, counter=name,
                fast_rate=round(fast, 3), baseline_rate=round(slow, 3),
            )


class HealthEngine:
    """The health plane's runtime (see module docstring): one live-
    stream subscription folding events into detectors + one tick thread
    evaluating them, emitting ``health.*`` verdicts and mirroring
    ``health.<detector>.firing`` gauges.

    Lifecycle: ``start()`` subscribes and spawns the tick thread;
    ``close()`` reverses both (idempotent).  ``evaluate(now)`` may also
    be driven manually with an explicit clock — the detector unit tests
    pin window math that way, no threads involved.

    ``ok()`` is False while any CRITICAL detector fires — the
    ``GET /health`` 503 condition; ``active()`` lists every firing
    verdict (critical or not) for ``/health``'s body, ``doctor
    --live``, and the flight recorder's health section."""

    def __init__(self, *, slo: Optional[dict] = None,
                 detectors: Optional[list] = None,
                 tick_s: float = 0.25, maxsize: int = 2048,
                 recorder=None):
        spec = slo or {"default_ms": None, "labels": {}, "config": {}}
        cfg = spec.get("config") or {}
        self.tick_s = float(cfg.get("tick", tick_s))
        if self.tick_s <= 0:
            raise ValueError(f"tick_s must be > 0, got {self.tick_s}")
        if detectors is None:
            stall_s = float(cfg.get("stall", 5.0))
            detectors = [
                BurnRateDetector(spec),
                StallWatchdog(timeout_s=stall_s),
                QueuePinnedDetector(window_s=stall_s),
                DegradedSpikeDetector(),
            ]
        self.detectors = list(detectors)
        self.spec = spec
        self.recorder = recorder
        self._maxsize = int(maxsize)
        self._lock = threading.Lock()
        self._sub: Optional[telemetry.Subscription] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._dumped_stalls: set = set()

    # -- live-stream face ----------------------------------------------------

    def start(self) -> "HealthEngine":
        if self._sub is not None:
            raise RuntimeError("HealthEngine already started")
        self._sub = telemetry.subscribe(
            self._on_event, maxsize=self._maxsize, name="health-engine"
        )
        self._thread = threading.Thread(
            target=self._run, name="rp-torch-health-tick", daemon=True
        )
        self._thread.start()
        return self

    def _on_event(self, rec: dict) -> None:
        # runs on the subscription's dispatch thread; the emitting hot
        # path already paid only a put_nowait
        name = rec.get("event")
        if not isinstance(name, str) or name.startswith("health."):
            return  # verdicts must not feed back into detectors
        ts = rec.get("ts")
        now = ts if isinstance(ts, (int, float)) else time.time()
        with self._lock:
            for d in self.detectors:
                d.on_event(rec, now)

    def _run(self) -> None:
        while not self._stop.wait(self.tick_s):
            self.evaluate()

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        """One detector pass at ``now`` (default: wall clock).  Returns
        the transitions emitted this pass (each also emitted as its
        detector's ``health.*`` event).  Callable directly with an
        explicit ``now`` for deterministic tests."""
        if now is None:
            now = time.time()
        reg = telemetry.registry()
        transitions: List[Tuple[str, dict]] = []
        gauges: List[Tuple[str, int]] = []
        with self._lock:
            for d in self.detectors:
                if isinstance(d, DegradedSpikeDetector):
                    for cname in d.counters:
                        d.observe(cname, reg.counter(cname), now)
                d.evaluate(now)
                for t in d.drain():
                    transitions.append((d.event, t))
                gauges.append((d.event, len(d.firing_keys())))
        # everything below runs OUTSIDE the lock: emit fans out to
        # subscriber queues and the dump writes a file (no blocking
        # call under a held lock)
        for gname, n in gauges:
            reg.gauge_set(f"{gname}.firing", n)
        out = []
        for event, t in transitions:
            _VERDICT_EMIT[event](**t)
            out.append({"event": event, **t})
            if (
                event == EVENTS.HEALTH_STALL
                and t["status"] == "firing"
                and self.recorder is not None
                and t["key"] not in self._dumped_stalls
            ):
                # one dump per distinct stalled stage: the wedge leaves
                # evidence even if the operator later kills -9
                self._dumped_stalls.add(t["key"])
                self.recorder.dump(reason=f"watchdog:{t['key']}")
        return out

    # -- verdict surface -----------------------------------------------------

    def active(self) -> List[dict]:
        """Every firing verdict, as plain dicts (``/health`` body,
        ``doctor --live``, flight-recorder health section)."""
        with self._lock:
            out = []
            for d in self.detectors:
                for key, fields in d.firing_keys():
                    out.append({
                        "detector": d.event, "key": key,
                        "critical": d.critical, **fields,
                    })
            return out

    def ok(self) -> bool:
        """False while any CRITICAL detector fires (``GET /health`` →
        503)."""
        with self._lock:
            return not any(
                d.critical and d.firing_keys() for d in self.detectors
            )

    def close(self) -> None:
        """Stop the tick thread and detach the subscription.
        Idempotent."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._sub is not None:
            telemetry.unsubscribe(self._sub)
            self._sub = None

    def __enter__(self) -> "HealthEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
