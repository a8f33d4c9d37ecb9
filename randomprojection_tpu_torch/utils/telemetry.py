"""Telemetry: metrics registry, JSONL event log and the live plane.

A copy of ``randomprojection_tpu/utils/telemetry.py`` (the port imports
nothing of that package): the ``EVENTS`` registry with the same names,
``MetricsRegistry`` (counters, gauges, log2 histograms, their quantiles
and ``snapshot``), the process-wide ``registry()``, the versioned JSONL
sink (``TelemetryLog``, ``configure``/``shutdown``/``enabled``/
``active_path``/``emit``), ``parse_event`` and ``read_events``, and the
tracing spans (``Span``, ``start_span``, ``end_span``, ``activate_span``,
``span``, ``current_span``, ``trace_fields``: one trace per streamed
batch, its child spans across threads).  Files it writes parse with the
reference's ``read_events`` and its ``trace_report``, as with the port's
own (``utils/trace_report.py``).

The live plane: ``subscribe(fn)`` registers a subscriber that receives
every emitted event and span as a plain dict through a bounded queue
drained by the subscription's own daemon thread
(``rp-torch-telemetry-sub-<name>``).  A full queue drops the event for
that subscriber only (counted in ``telemetry.subscriber.dropped``); the
emitting thread never blocks.  A registered subscriber makes
``enabled()`` true with no JSONL sink.  ``LiveAggregator`` folds the
stream into rolling windows (span walls, event rates, a time-weighted
queue depth), ``FlightRecorder`` keeps a ring of the last events and
dumps it atomically on a fatal signal, an unhandled exception or a
watchdog trip, and ``to_openmetrics`` renders registry snapshots as an
OpenMetrics text exposition (``utils/metrics_server.py`` serves it).
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import queue as _queue_mod
import re
import sys
import threading
import time
from collections import deque
from typing import Iterator, Optional

__all__ = [
    "SCHEMA_VERSION",
    "SUPPORTED_SCHEMA_VERSIONS",
    "EVENTS",
    "registered_event",
    "MetricsRegistry",
    "quantiles_from_buckets",
    "registry",
    "TelemetryLog",
    "configure",
    "shutdown",
    "enabled",
    "active_path",
    "emit",
    "parse_event",
    "read_events",
    "Span",
    "current_span",
    "trace_fields",
    "start_span",
    "end_span",
    "activate_span",
    "span",
    "to_openmetrics",
    "Subscription",
    "subscribe",
    "unsubscribe",
    "LiveAggregator",
    "FlightRecorder",
]

SCHEMA_VERSION = 2
# readers accept every version whose events they can represent; v1 files
# (committed telemetry fixtures, old runs) parse forever
SUPPORTED_SCHEMA_VERSIONS = frozenset({1, 2})

class EVENTS:
    """Central registry of every telemetry event name, the same names as
    the reference's, so its readers (``read_events``, the doctor) take
    the port's files.  Emit sites reference the constants, never fresh
    literals.

    ``FAMILIES`` registers dotted-name *prefixes* for names completed at
    runtime (the per-path ``hash.batches.<path>`` counters);
    ``registered_event()`` accepts a name when it is a member or extends
    a family.
    """

    # tracing span pair (schema v2)
    SPAN_START = "span_start"
    SPAN_END = "span_end"
    # streaming pipeline
    STAGE_WALL = "stage.wall"
    STREAM_COMMIT = "stream.commit"
    STREAM_DISPATCH = "stream.dispatch"
    STREAM_PREFETCH_DELIVER = "stream.prefetch.deliver"
    STREAM_PREFETCH_ERROR = "stream.prefetch.error"
    STREAM_PREFETCH_SHUTDOWN_TIMEOUT = "stream.prefetch.shutdown_timeout"
    STREAM_STAGED_DELIVER = "stream.staged.deliver"
    STREAM_STAGED_ERROR = "stream.staged.error"
    STREAM_STAGED_SHUTDOWN_TIMEOUT = "stream.staged.shutdown_timeout"
    # backend dispatch + degraded retries
    BACKEND_DISPATCH = "backend.dispatch"
    BACKEND_VMEM_OOM_RETRY = "backend.vmem_oom_retry"
    # fused transform kernel: per-host-dispatch route record
    # (DMA vs single-buffered, dispatch-fusion chain length), the
    # DMA→single-buffered scoped-VMEM fallback, and the backend's
    # multi-step dispatch-fusion record.
    KERNEL_DMA_DISPATCH = "kernel.dma.dispatch"
    KERNEL_DMA_FALLBACK = "kernel.dma.fallback"
    BACKEND_DISPATCH_FUSED = "backend.dispatch_fused"
    # ingest hashing
    HASH_BATCH = "hash.batch"
    # simhash query/serving
    SIMHASH_QUERY_TILE = "simhash.query_tile"
    SIMHASH_TOPK_TILE = "simhash.topk_tile"
    SIMHASH_TOPK_BLOCK_CLAMP = "simhash.topk_block_clamp"
    SIMHASH_TOPK_DENSE_FALLBACK = "simhash.topk_dense_fallback"
    # fused serving kernel: per-tile kernel dispatches, the
    # VMEM-OOM degraded retry, and fused->scan routing fallbacks
    TOPK_KERNEL_DISPATCH = "topk.kernel.dispatch"
    TOPK_KERNEL_VMEM_RETRY = "topk.kernel.vmem_retry"
    TOPK_KERNEL_SCAN_FALLBACK = "topk.kernel.scan_fallback"
    SERVE_TOPK_BATCH = "serve.topk_batch"
    SERVE_TOPK_ERROR = "serve.topk.error"
    # sharded serving tier: per-tile shard fanout, the
    # cross-shard candidate merge, and the replica-routed coalesced
    # dispatch.
    SHARD_TOPK_TILE = "shard.topk_tile"
    SHARD_MERGE = "shard.merge"
    SERVE_SHARD_BATCH = "serve.shard.batch"
    # durable index lifecycle (snapshot/restore + crash recovery)
    INDEX_SNAPSHOT_SAVE = "index.snapshot.save"
    INDEX_SNAPSHOT_LOAD = "index.snapshot.load"
    INDEX_COMPACT = "index.compact"
    RECOVER_RESUME = "recover.resume"
    RECOVER_CHECKSUM_MISMATCH = "recover.checksum_mismatch"
    RECOVER_ORPHAN_CHUNK = "recover.orphan_chunk"
    # live observability plane: subscriber overflow (emitted by the
    # dispatch thread, rate-limited — the emitting hot path only counts),
    # per-request serving latency (enqueue→dispatch→complete stamps from
    # TopKServer/ShardedTopKServer), and the open-loop load generator's
    # run summary.
    TELEMETRY_SUBSCRIBER_DROPPED = "telemetry.subscriber.dropped"
    SERVE_LATENCY_REQUEST = "serve.latency.request"
    LOADGEN_RUN = "loadgen.run"
    # multi-probe LSH candidate tier: per-tile candidate
    # generation record (probes, candidate fraction), the density/
    # starvation fallback to the exact-scan ladder rung (degraded-to-
    # exact — on the doctor's audit), and banded-bucket build folds.
    INDEX_LSH_DISPATCH = "index.lsh.dispatch"
    INDEX_LSH_FALLBACK = "index.lsh.fallback"
    INDEX_LSH_BUILD = "index.lsh.build"
    # device-fused candidate generation: per-tile fused
    # probe → gather → re-rank dispatch record, device-CSR mirror
    # (re-)uploads, and the adaptive per-query probing round summary
    # (probes-used, early exits, budget stops).
    INDEX_LSH_DEVICE_DISPATCH = "index.lsh.device_dispatch"
    INDEX_LSH_DEVICE_UPLOAD = "index.lsh.device_upload"
    INDEX_LSH_ADAPTIVE = "index.lsh.adaptive"
    # health plane: typed detector verdicts with a
    # firing/cleared lifecycle (utils/health.py emits, deduplicated and
    # rate-limited), plus the flight recorder's dump record.
    HEALTH_SLO_BURN = "health.slo_burn"
    HEALTH_STALL = "health.stall"
    HEALTH_QUEUE_PINNED = "health.queue_pinned"
    HEALTH_DEGRADED_SPIKE = "health.degraded_spike"
    HEALTH_FLIGHT_DUMP = "health.flight_dump"
    # tiered hot/cold residency: per-gather hot-tier
    # hit record, cold-tier row fetch (rows/bytes/wall, with the
    # overlapped-under-the-hot-kernel window), demotion/promotion churn,
    # and the synchronous-fetch fallback rung (degraded — on the
    # doctor's audit).
    INDEX_TIER_HIT = "index.tier.hit"
    INDEX_TIER_FETCH = "index.tier.fetch"
    INDEX_TIER_EVICT = "index.tier.evict"
    INDEX_TIER_FALLBACK = "index.tier.fallback"

    # runtime-completed name families.  ``*_FAMILY`` constants are the
    # prefixes callers build on (today: the per-kernel-path hash counter
    # family, ``hash.batches.strided`` / ``.list`` / ``.python``);
    # FAMILIES is the tuple ``registered_event`` prefix-matches against.
    HASH_BATCHES_FAMILY = "hash.batches."
    FAMILIES = (HASH_BATCHES_FAMILY,)


def _event_names() -> frozenset:
    return frozenset(
        v
        for k, v in vars(EVENTS).items()
        if k.isupper()
        and not k.endswith("_FAMILY")
        and k != "FAMILIES"
        and isinstance(v, str)
    )


_EVENT_NAMES = _event_names()


def registered_event(name: str) -> bool:
    """True when ``name`` is a registered event: an ``EVENTS`` member or
    an extension of a registered family prefix."""
    return name in _EVENT_NAMES or any(
        name.startswith(f) for f in EVENTS.FAMILIES
    )


class MetricsRegistry:
    """Thread-safe counters, gauges and log2 wall-clock histograms.

    - ``counter_inc(name, value)`` — monotone accumulators (batches,
      rows, bytes, dispatches, retries).
    - ``gauge_set(name, value)`` — point-in-time samples; the registry
      keeps ``last``/``max``/``sum``/``n`` so both extremes and means
      are recoverable (the prefetch queue-occupancy gauge needs max AND
      mean).
    - ``observe(name, seconds)`` — wall-clock
      histograms over fixed log2 buckets: bucket ``i`` holds samples in
      ``[2^i, 2^(i+1))`` microseconds, so buckets are comparable across
      processes and runs (no adaptive boundaries to drift).  ``sum``
      and ``count`` ride along, so totals (the ``StreamStats``
      stage-wall contract) are exact, not bucket-approximated.

    One registry per concern: ``StreamStats`` owns one per stream; the
    process-wide default (``registry()``) collects cross-cutting counts
    (backend dispatches, hash fallbacks, top-k clamps).
    """

    def __init__(self):
        # reentrant: the flight recorder's fatal-signal dump snapshots this
        # registry from the main thread, which may have been interrupted
        # while holding this very lock inside counter_inc
        self._lock = threading.RLock()
        self._counters: dict = {}
        self._gauges: dict = {}
        self._hists: dict = {}

    # -- counters -----------------------------------------------------------

    def counter_inc(self, name: str, value: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def counter(self, name: str):
        """Current value (0 when never incremented)."""
        with self._lock:
            return self._counters.get(name, 0)

    # -- gauges -------------------------------------------------------------

    def gauge_set(self, name: str, value: float) -> None:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = {"last": value, "max": value, "sum": 0.0, "n": 0}
                self._gauges[name] = g
            g["last"] = value
            if value > g["max"]:
                g["max"] = value
            g["sum"] += value
            g["n"] += 1

    def gauge(self, name: str) -> dict:
        """``{last, max, sum, n}`` (zeros when never set)."""
        with self._lock:
            g = self._gauges.get(name)
            return dict(g) if g else {"last": 0, "max": 0, "sum": 0.0, "n": 0}

    def gauge_max(self, name: str):
        return self.gauge(name)["max"]

    def gauge_mean(self, name: str) -> float:
        g = self.gauge(name)
        return g["sum"] / g["n"] if g["n"] else 0.0

    # -- histograms ---------------------------------------------------------

    @staticmethod
    def _bucket(seconds: float) -> int:
        """Fixed log2 bucket index: ``floor(log2(max(seconds, 1e-6) / 1e-6))``
        — bucket 0 is [1µs, 2µs), bucket 20 is [~1s, ~2s)."""
        us = max(seconds, 1e-6) / 1e-6
        return max(int(math.floor(math.log2(us))), 0)

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = {"sum": 0.0, "count": 0, "buckets": {}}
                self._hists[name] = h
            h["sum"] += seconds
            h["count"] += 1
            b = self._bucket(seconds)
            h["buckets"][b] = h["buckets"].get(b, 0) + 1

    @contextlib.contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0)

    def hist_sum(self, name: str) -> float:
        """Exact total seconds observed under ``name`` (0.0 when never)."""
        with self._lock:
            h = self._hists.get(name)
            return h["sum"] if h else 0.0

    def hist_sums(self, prefix: str = "") -> dict:
        """``{name_without_prefix: total_seconds}`` for every histogram
        whose name starts with ``prefix`` (the ``StreamStats.stage_wall``
        view is ``hist_sums('stage.')``)."""
        with self._lock:
            return {
                k[len(prefix):]: h["sum"]
                for k, h in self._hists.items()
                if k.startswith(prefix)
            }

    def hist_quantiles(self, name: str,
                       qs=(0.5, 0.9, 0.99, 0.999)) -> Optional[dict]:
        """HDR-style quantile extraction from a log2-bucket histogram:
        ``{"p50": seconds, "p90": ..., "count": exact, "sum": exact}``
        (see ``quantiles_from_buckets`` for the estimation contract), or
        None when the histogram was never observed."""
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                return None
            buckets = dict(h["buckets"])
            count, total = h["count"], h["sum"]
        return quantiles_from_buckets(buckets, count, total, qs)

    def snapshot(self) -> dict:
        """Plain-JSON view of every metric (bucket keys stringified so the
        result survives ``json.dumps`` then ``json.loads`` unchanged)."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": {k: dict(v) for k, v in self._gauges.items()},
                "histograms": {
                    k: {
                        "sum": h["sum"],
                        "count": h["count"],
                        "buckets": {
                            str(b): c for b, c in sorted(h["buckets"].items())
                        },
                    }
                    for k, h in self._hists.items()
                },
            }


def quantiles_from_buckets(buckets: dict, count: int, total: float,
                           qs=(0.5, 0.9, 0.99, 0.999)) -> dict:
    """Quantile extraction from a fixed-log2-bucket histogram snapshot
    (bucket ``i`` holds samples in ``[2^i, 2^(i+1))`` µs; ``count`` and
    ``total`` are the registry's EXACT tallies, never approximated).

    Returns ``{"p50": seconds, ..., "count": count, "sum": total,
    "mean": total/count}`` with one ``p<q*100>`` key per requested
    quantile.  Estimation contract:

    - ``count == 0`` → every quantile is None (an empty histogram has no
      quantiles; callers render "-", never 0.0 — a fake zero would read
      as a sub-microsecond latency).
    - ``count == 1`` → every quantile is EXACTLY ``total`` (the single
      sample's value is recoverable from the exact sum).
    - otherwise quantile rank ``q*(count-1)`` lands in a bucket by
      cumulative count and interpolates linearly inside it, clamped to
      the bucket edges — the estimate is within one bucket of the true
      value, i.e. a factor-of-2 relative error bound (bucket 0's lower
      edge is taken as 0 s: it also holds every sub-microsecond sample).

    Quantiles are monotone in ``q`` by construction (the cumulative walk
    never moves backwards), including under concurrent recording — the
    snapshot is taken under the registry lock.
    """
    out = {"count": int(count), "sum": total,
           "mean": (total / count) if count else None}
    if count <= 0:
        for q in qs:
            out[_q_key(q)] = None
        return out
    if count == 1:
        for q in qs:
            out[_q_key(q)] = total
        return out
    items = sorted((int(b), c) for b, c in buckets.items())
    for q in qs:
        rank = q * (count - 1)  # 0-based fractional rank
        cum = 0
        val = None
        for b, c in items:
            if cum + c > rank:
                lo = 0.0 if b == 0 else (1 << b) * 1e-6
                hi = (1 << (b + 1)) * 1e-6
                # linear interpolation by the rank's position within
                # this bucket's occupants
                frac = (rank - cum) / c if c > 1 else 0.5
                val = lo + frac * (hi - lo)
                break
            cum += c
        if val is None:  # rank beyond the last bucket (shouldn't happen)
            b = items[-1][0]  # pragma: no cover — defensive
            val = (1 << (b + 1)) * 1e-6  # pragma: no cover
        out[_q_key(q)] = val
    return out


def _q_key(q: float) -> str:
    """0.5 → "p50", 0.999 → "p99.9" (trailing zeros dropped)."""
    s = f"{q * 100:.4f}".rstrip("0").rstrip(".")
    return f"p{s}"


_DEFAULT_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide default registry (cross-cutting counters: backend
    dispatches, VMEM-OOM retries, hash fallbacks, top-k clamps)."""
    return _DEFAULT_REGISTRY


def _repair_torn_tail(path: str) -> None:
    """Make an existing event file append-safe before reopening it.

    A previous run that crashed mid-write leaves a torn final line with
    no trailing newline; appending onto it would merge it with the new
    run's first event into one corrupt MID-file line, which the strict
    reader rightly refuses — turning a lost-final-event file into an
    unreadable one.  A fragment that parses as a complete event (only
    the newline was lost) is terminated; a genuinely torn fragment is
    truncated away — that event was already lost at crash time — but
    ONLY when the preceding complete line proves the file is already a
    telemetry log: a user pointing ``--telemetry-jsonl`` at some other
    newline-less file must never have its content destroyed (the repair
    then just terminates the line and appends after it).
    """
    try:
        f = open(path, "r+b")
    except FileNotFoundError:
        return
    with f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        if size == 0:
            return
        f.seek(size - 1)
        if f.read(1) == b"\n":
            return
        window = min(size, 1 << 20)  # events are far smaller than 1 MB
        f.seek(size - window)
        tail = f.read(window)
        nl = tail.rfind(b"\n")
        if nl < 0 and size > window:  # pragma: no cover — >1 MB one-line
            f.write(b"\n")  # can't see the line start; don't destroy data
            return
        frag = tail[nl + 1:]

        def _parses(raw: bytes) -> bool:
            try:
                parse_event(raw.decode("utf-8"))
                return True
            except (ValueError, UnicodeDecodeError):
                return False

        if _parses(frag):
            f.write(b"\n")  # complete event, only the newline was lost
            return
        prev_is_event = nl >= 0 and _parses(
            tail[tail.rfind(b"\n", 0, nl) + 1 : nl]
        )
        # a run that crashed writing its very FIRST event leaves no
        # preceding line to prove ownership; the sink's own serialization
        # prefix is the next-best evidence (either direction of
        # startswith: the fragment may be shorter than the prefix)
        own_prefix = b'{"v":'
        frag_is_ours = frag.startswith(own_prefix) or own_prefix.startswith(
            frag
        )
        if prev_is_event or (nl < 0 and frag_is_ours):
            f.truncate(size - len(frag))  # our log's torn final event
        else:
            f.write(b"\n")  # not provably our log: preserve the content



class TelemetryLog:
    """Append-only JSONL event sink (versioned schema, thread-safe).

    Each ``emit`` writes exactly one ``\\n``-terminated line and flushes,
    so concurrent producer/consumer threads interleave whole events and
    a crash loses at most the event being written.  Reopening a file a
    crashed run left torn repairs the tail first (``_repair_torn_tail``),
    so multi-run files stay readable end to end.
    """

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        _repair_torn_tail(path)
        self._f = open(path, "a")

    def emit(self, event: str, **fields) -> None:
        rec = {"v": SCHEMA_VERSION, "ts": time.time(), "event": event}
        rec.update(fields)
        self.emit_record(rec)

    def emit_record(self, rec: dict) -> None:
        """Write one already-assembled event dict (the module ``emit()``
        builds the record once and hands it to the sink and to the live
        subscribers)."""
        line = json.dumps(rec, separators=(",", ":"))
        with self._lock:
            if self._f is None:  # pragma: no cover - emit after close
                return
            self._f.write(line + "\n")
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


_ACTIVE_LOG: Optional[TelemetryLog] = None


def configure(path: str) -> TelemetryLog:
    """Install the process-wide JSONL sink (replacing any previous one).
    Instrumented call sites all over the package start emitting into it
    immediately; ``shutdown()`` uninstalls and closes.  Each configure
    draws a fresh run token for span ids, so the runs appended to one
    file can never collide trace ids."""
    global _ACTIVE_LOG, _RUN_TOKEN
    if _ACTIVE_LOG is not None:
        _ACTIVE_LOG.close()
    with _SPAN_LOCK:
        # the token pairs with the span sequence under the same lock: a
        # span id drawn concurrently with configure() carries either the
        # old token or the new one, never a torn read
        _RUN_TOKEN = os.urandom(4).hex()
    _ACTIVE_LOG = TelemetryLog(path)
    return _ACTIVE_LOG


def shutdown() -> None:
    global _ACTIVE_LOG
    if _ACTIVE_LOG is not None:
        _ACTIVE_LOG.close()
        _ACTIVE_LOG = None


def enabled() -> bool:
    """True when a process-wide sink is installed or at least one live
    subscriber is registered.  Hot paths with non-trivial payload
    construction should guard on this."""
    return _ACTIVE_LOG is not None or bool(_SUBSCRIPTIONS)


def active_path() -> Optional[str]:
    """Path of the installed sink (None when telemetry is off) — lets a
    caller that needs a scoped sink (the bench's staged-ingest trace
    capture) restore the user's sink afterwards."""
    log = _ACTIVE_LOG
    return log.path if log is not None else None


def _finalizing() -> bool:
    """True when the interpreter is tearing down (or so far gone that we
    cannot even tell).  Emitting from a daemon thread or a ``__del__``
    at that point must drop the event, never traceback."""
    try:
        return sys is None or sys.is_finalizing()
    # rplint: allow[RP06] — teardown probe: the failure IS the answer
    except Exception:  # pragma: no cover — modules already demolished
        return True


def _fsync_dir(path: str) -> None:
    """Best-effort directory fsync after an ``os.replace``: without it the
    rename itself can be lost on a crash, which for the flight recorder
    means losing the postmortem the crash produced.  Tolerant: some
    filesystems refuse a read-only directory open, and a dump must never
    turn into a new crash."""
    try:
        fd = os.open(path or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def emit(event: str, **fields) -> None:
    """Emit one event to the process-wide sink and every live subscriber;
    no-op when neither is installed (two global reads, safe in hot paths).
    Subscriber delivery is a non-blocking bounded enqueue: a full queue
    drops the event for that subscriber (counted) and never stalls the
    emitter.  Safe during interpreter teardown: a late emit from a daemon
    thread or a ``__del__`` is dropped instead of raising into the
    finalizer."""
    log = _ACTIVE_LOG
    subs = _SUBSCRIPTIONS
    if log is None and not subs:
        return
    try:
        rec = {"v": SCHEMA_VERSION, "ts": time.time(), "event": event}
        rec.update(fields)
        if log is not None:
            log.emit_record(rec)
        for s in subs:
            s._offer(rec)
    except Exception:
        if _finalizing():
            return
        raise



# -- live subscribers ----------------------------------------------------------


class Subscription:
    """One live event subscriber: a bounded queue fed by ``emit()`` and
    drained by this subscription's own daemon dispatch thread, which
    calls ``fn(event_dict)`` for every delivered event.

    Delivery contract:

    - the emitting thread only ever does a non-blocking enqueue; when
      the queue is full the event is DROPPED for this subscriber
      (``telemetry.subscriber.dropped`` counter on the default
      registry + the per-subscription ``stats()`` tally) — overload
      degrades the observer, never the observed;
    - events arrive on the dispatch thread in emit order (per-queue
      FIFO); a raising ``fn`` is counted (``errors``) and delivery
      continues — one bad callback must not kill the plane;
    - the dispatch thread reports accumulated drops as a rate-limited
      ``telemetry.subscriber.dropped`` EVENT (at most one per
      ``_DROP_REPORT_S``) so overload is visible on the spine, not just
      in a counter nobody scrapes.

    Create with ``subscribe()``; detach with ``unsubscribe()`` /
    ``close()`` (drains nothing further, joins the dispatch thread).
    """

    _POLL_S = 0.05
    _DROP_REPORT_S = 1.0

    def __init__(self, fn, *, maxsize: int = 1024, name: str = ""):
        if not callable(fn):
            raise TypeError(f"subscriber fn must be callable, got {fn!r}")
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "subscriber")
        self._q: "_queue_mod.Queue" = _queue_mod.Queue(maxsize=maxsize)
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._dropped = 0
        self._delivered = 0
        self._errors = 0
        self._last_drop_report = 0.0
        self._reported_drops = 0
        self._thread = threading.Thread(
            target=self._run, name=f"rp-torch-telemetry-sub-{self.name}",
            daemon=True,
        )
        self._thread.start()

    # emitter side — called from emit() on ANY thread; must never block
    def _offer(self, rec: dict) -> None:
        try:
            self._q.put_nowait(rec)
        except _queue_mod.Full:
            with self._lock:
                self._dropped += 1
            _DEFAULT_REGISTRY.counter_inc("telemetry.subscriber.dropped")
            # per-subscriber tally: one aggregate
            # counter cannot say WHICH observer is chronically overrun —
            # doctor --live renders a drop rate per subscriber from these
            _DEFAULT_REGISTRY.counter_inc(
                f"telemetry.subscriber.{self.name}.dropped"
            )

    # dispatch side — this subscription's own daemon thread
    def _run(self) -> None:
        while True:
            # stop is checked every iteration, not only on an empty
            # queue: close() discards pending events (as documented)
            # instead of delivering a full queue's worth to a possibly
            # slow fn — close() on a wedged subscriber must not block
            # for queue-length × callback-wall
            if self._stop.is_set():
                return
            try:
                rec = self._q.get(timeout=self._POLL_S)
            except _queue_mod.Empty:
                continue
            try:
                self.fn(rec)
            except Exception:
                # a raising subscriber must not kill delivery; count it
                # so a silently-broken observer is still diagnosable
                with self._lock:
                    self._errors += 1
                _DEFAULT_REGISTRY.counter_inc("telemetry.subscriber.errors")
            with self._lock:
                self._delivered += 1
                drops = self._dropped - self._reported_drops
                now = time.monotonic()
                report = (
                    drops > 0
                    and now - self._last_drop_report >= self._DROP_REPORT_S
                )
                if report:
                    self._reported_drops = self._dropped
                    self._last_drop_report = now
                    total = self._dropped
            if report:
                # re-enters emit() from the dispatch thread (rate-
                # limited above); recursion is bounded: this event fans
                # out like any other and may itself be dropped
                emit(
                    EVENTS.TELEMETRY_SUBSCRIBER_DROPPED,
                    subscriber=self.name, dropped=int(drops),
                    dropped_total=int(total),
                )

    def stats(self) -> dict:
        """``{delivered, dropped, errors, queued}`` (thread-safe)."""
        with self._lock:
            return {
                "delivered": self._delivered,
                "dropped": self._dropped,
                "errors": self._errors,
                "queued": self._q.qsize(),
            }

    def close(self) -> None:
        """Detach from the live stream (equivalent to ``unsubscribe``),
        stop the dispatch thread (pending queued events are discarded)
        and join it.  Idempotent.  Detaching matters: a closed-but-
        registered subscription would keep ``enabled()`` True and its
        full queue would count a drop on every future emit forever."""
        with _SUB_LOCK:
            try:
                _SUBSCRIPTIONS.remove(self)
            except ValueError:
                pass
        self._stop.set()
        self._thread.join()

    def __enter__(self) -> "Subscription":
        return self

    def __exit__(self, *exc) -> None:
        unsubscribe(self)


# registered subscriptions: a plain list MUTATED under _SUB_LOCK (never
# rebound — the hot-path readers in emit()/enabled() iterate/test it
# lock-free, which is safe under the GIL for append/remove)
_SUBSCRIPTIONS: list = []
_SUB_LOCK = threading.Lock()


def subscribe(fn, *, maxsize: int = 1024, name: str = "") -> Subscription:
    """Register a live subscriber: ``fn(event_dict)`` will be called on
    a dedicated daemon dispatch thread for every event/span emitted
    from now on (bounded queue — see ``Subscription``).  Makes
    telemetry active even without a JSONL sink.  Returns the
    ``Subscription``; pass it to ``unsubscribe`` to detach."""
    sub = Subscription(fn, maxsize=maxsize, name=name)
    with _SUB_LOCK:
        _SUBSCRIPTIONS.append(sub)
    return sub


def unsubscribe(sub: Subscription) -> None:
    """Detach a subscription registered by ``subscribe`` and stop its
    dispatch thread (alias of ``Subscription.close``).  Unknown or
    already-removed subscriptions are a no-op (idempotent)."""
    sub.close()


class LiveAggregator:
    """The shipped live subscriber: folds the event/span stream into
    rolling-window aggregates — the doctor's per-stage critical-path
    inputs, computed incrementally while the run is still going.

    Usage: ``agg = LiveAggregator(); sub = subscribe(agg)`` (the
    instance is itself the subscriber callable).  All state is guarded
    by one lock; ``snapshot()`` / ``registry_snapshot()`` may be called
    from any thread (the metrics endpoint scrapes them).

    Windows (default 10 s, sliding):

    - **per-stage span wall** — every ``span_end`` lands in its name's
      window: count, summed wall, mean.
    - **event rates** — per-event-name occurrence count in the window.
    - **queue depth, TIME-WEIGHTED** — the satellite fix: the post-hoc
      report samples queue depth only AT ``stream.*.deliver`` events,
      so a stalled stage (no deliveries) is a blind spot exactly when
      depth matters most.  Here the last delivered depth PERSISTS: the
      window mean integrates the piecewise-constant depth signal up to
      ``now``, and ``age_s`` says how stale the last sample is — a
      consumer that stopped draining shows a pinned-full queue getting
      older, not silence.
    """

    def __init__(self, window_s: float = 10.0):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self.window_s = float(window_s)
        self._lock = threading.Lock()
        self._spans: dict = {}   # stage name -> deque[(ts, dur_s)]
        self._events: dict = {}  # event name -> deque[ts]
        self._queue: deque = deque()  # (ts, depth) samples, window+1 kept
        self._queue_capacity: Optional[int] = None
        self._n_seen = 0

    # the subscriber callable face
    def __call__(self, rec: dict) -> None:
        name = rec.get("event")
        ts = rec.get("ts")
        if not isinstance(name, str) or not isinstance(ts, (int, float)):
            return
        with self._lock:
            self._n_seen += 1
            dq = self._events.setdefault(name, deque())
            dq.append(ts)
            if name == EVENTS.SPAN_END and isinstance(
                rec.get("dur_s"), (int, float)
            ):
                sdq = self._spans.setdefault(
                    str(rec.get("name")), deque()
                )
                sdq.append((ts, rec["dur_s"]))
            elif name in (
                EVENTS.STREAM_PREFETCH_DELIVER,
                EVENTS.STREAM_STAGED_DELIVER,
            ):
                self._queue.append((ts, rec.get("queue_depth", 0) or 0))
                if rec.get("capacity") is not None:
                    self._queue_capacity = rec["capacity"]
            self._prune(ts)

    def _prune(self, now: float) -> None:
        # under self._lock.  The queue deque keeps ONE sample older than
        # the window: it carries the depth the window opened at (the
        # piecewise-constant signal needs a left endpoint).
        horizon = now - self.window_s
        for dq in self._spans.values():
            while dq and dq[0][0] < horizon:
                dq.popleft()
        for dq in self._events.values():
            while dq and dq[0] < horizon:
                dq.popleft()
        while len(self._queue) > 1 and self._queue[1][0] <= horizon:
            self._queue.popleft()

    def snapshot(self, now: Optional[float] = None) -> dict:
        """Rolling-window view as plain JSON: per-stage span stats,
        per-event rates, and the time-weighted queue-depth signal
        evaluated at ``now`` (default: wall clock — pass an explicit
        ``now`` for deterministic tests)."""
        if now is None:
            now = time.time()
        with self._lock:
            self._prune(now)
            horizon = now - self.window_s
            stages = {}
            for sname, dq in sorted(self._spans.items()):
                if not dq:
                    continue
                walls = [d for _, d in dq]
                stages[sname] = {
                    "count": len(walls),
                    "wall_s": round(sum(walls), 6),
                    "mean_s": round(sum(walls) / len(walls), 6),
                }
            rates = {
                ename: round(len(dq) / self.window_s, 3)
                for ename, dq in sorted(self._events.items())
                if dq
            }
            qinfo = None
            if self._queue:
                samples = list(self._queue)
                last_ts, last_depth = samples[-1]
                # integrate the piecewise-constant depth over
                # [horizon, now]: each sample holds until the next one,
                # the last holds until NOW — the stalled-consumer fix
                area = 0.0
                for (t0, d0), (t1, _) in zip(samples, samples[1:]):
                    lo, hi = max(t0, horizon), min(t1, now)
                    if hi > lo:
                        area += d0 * (hi - lo)
                lo = max(last_ts, horizon)
                if now > lo:
                    area += last_depth * (now - lo)
                span_len = min(self.window_s, max(now - samples[0][0], 0.0))
                qinfo = {
                    "last": last_depth,
                    "age_s": round(max(now - last_ts, 0.0), 3),
                    "time_weighted_mean": round(
                        area / span_len if span_len > 0 else float(last_depth),
                        3,
                    ),
                    "capacity": self._queue_capacity,
                }
            return {
                "window_s": self.window_s,
                "events_seen": self._n_seen,
                "stages": stages,
                "event_rates": rates,
                "queue": qinfo,
            }

    def registry_snapshot(self, now: Optional[float] = None) -> dict:
        """The rolling window rendered as a ``MetricsRegistry.snapshot``
        -shaped dict (gauges only) so ``to_openmetrics`` can merge it
        into a scrape: ``live.span.<stage>.wall_s`` /
        ``live.span.<stage>.mean_s`` / ``live.span.<stage>.count``,
        ``live.event.<name>.rate``, and the ``live.queue.*`` depth
        signal."""
        snap = self.snapshot(now)
        gauges: dict = {}

        def g(gname, value):
            gauges[gname] = {"last": value, "max": value,
                             "sum": value, "n": 1}

        for sname, st in snap["stages"].items():
            g(f"live.span.{sname}.wall_s", st["wall_s"])
            g(f"live.span.{sname}.mean_s", st["mean_s"])
            g(f"live.span.{sname}.count", st["count"])
        for ename, rate in snap["event_rates"].items():
            g(f"live.event.{ename}.rate", rate)
        q = snap["queue"]
        if q is not None:
            g("live.queue.depth", q["last"])
            g("live.queue.depth_age_s", q["age_s"])
            g("live.queue.depth_mean", q["time_weighted_mean"])
            if q.get("capacity") is not None:
                g("live.queue.capacity", q["capacity"])
        return {"counters": {}, "gauges": gauges, "histograms": {}}


class FlightRecorder:
    """Always-on crash evidence: a fixed-size in-memory ring
    of the last ``capacity`` events/spans — the cheapest possible
    subscriber (one deque append per event, no JSONL sink required) —
    dumped atomically to a self-describing postmortem file when the
    process dies.

    Usage: ``rec = FlightRecorder(); sub = subscribe(rec, ...)`` (the
    instance is itself the subscriber callable), then
    ``rec.install(path)`` to arm the fatal-signal (SIGTERM/SIGABRT)
    handlers and the unhandled-exception hook.  ``dump()`` can also be
    called on demand (the health watchdog trips it; see
    ``utils/health.py``).  ``cli doctor --postmortem <dump>``
    reconstructs the final seconds from the result.

    Signal safety: CPython
    runs signal handlers in the MAIN thread at bytecode boundaries — not
    in async-signal context — so file IO inside the handler is safe.
    Locks are the real hazard: the interrupted main-thread frame may
    HOLD any lock the hot path takes (the JSONL sink lock inside
    ``emit``, the subscriber-list lock, the registry lock inside
    ``counter_inc``), and a handler that blocks on one of those
    self-deadlocks — same thread, never released.  Three measures close
    every such path: (1) the signal-context dump never re-enters the
    event spine (``emit_event=False`` — no sink lock, no subscriber
    lock); (2) the two locks the dump DOES take (ring, registry) are
    reentrant, so an interrupted holder on the main thread is re-entry,
    not deadlock; (3) a signal arriving during a dump cannot re-enter
    the dump itself (the non-blocking ``_dump_guard`` makes the nested
    dump a no-op).  After dumping, the previous signal disposition is
    restored and the signal re-raised, so the process still dies with
    the correct exit status (``kill -TERM`` still exits 143).

    Dump format (one JSON object, written tmp→fsync→``os.replace`` — the
    durable-write discipline, so a crash mid-dump leaves the
    previous dump or nothing, never a torn file)::

        {"format": "rp-flight-recorder", "v": 1, "pid": ..., "ts": ...,
         "reason": "signal:SIGTERM" | "unhandled_exception:..." |
                   "watchdog:<detector>" | "on_demand",
         "capacity": N, "events": [<the ring, oldest first>],
         "counters": <registry().snapshot()>,
         "health": <active verdicts, when a health engine is attached>}
    """

    FORMAT = "rp-flight-recorder"
    VERSION = 1

    def __init__(self, capacity: int = 2048):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        # reentrant for the same reason as the registry lock: the
        # signal handler's dump copies the ring on the main thread,
        # which may have been interrupted inside install/attach_health
        self._lock = threading.RLock()
        # non-blocking reentrancy guard: a signal landing mid-dump must
        # skip the nested dump, not deadlock on it
        self._dump_guard = threading.Lock()
        self._path: Optional[str] = None
        self._health = None  # zero-arg callable -> active verdict list
        self._prev_handlers: dict = {}
        self._prev_excepthook = None
        self._installed_signals: tuple = ()

    # the subscriber callable face — one bounded append, never blocks
    def __call__(self, rec: dict) -> None:
        with self._lock:
            self._ring.append(rec)

    def attach_health(self, fn) -> None:
        """Attach a zero-arg callable returning the active health
        verdicts (``HealthEngine.active``); its result rides in every
        dump so the postmortem names the detectors firing at death."""
        with self._lock:
            self._health = fn

    def snapshot(self) -> list:
        """The ring's current contents, oldest first (thread-safe)."""
        with self._lock:
            return list(self._ring)

    def dump(self, path: Optional[str] = None,
             reason: str = "on_demand", *,
             emit_event: bool = True) -> Optional[str]:
        """Write the postmortem file atomically and return its path.
        Returns None when no path is known or a dump is already in
        progress (a signal arriving mid-dump).  Never raises during
        interpreter teardown — the dump is best-effort evidence, not a
        new crash.

        ``emit_event=False`` is the SIGNAL-CONTEXT mode: the handler
        may have interrupted the main thread while it held the JSONL
        sink lock or the subscriber-list lock inside ``emit()``, so the
        dump must never re-enter the event spine from there — the file
        itself is the evidence."""
        with self._lock:
            path = path or self._path
        if path is None:
            return None
        if not self._dump_guard.acquire(blocking=False):
            return None  # nested dump (signal during dump): skip
        try:
            with self._lock:
                events = list(self._ring)
                health_fn = self._health
            health = None
            if health_fn is not None:
                try:
                    health = health_fn()
                except Exception:
                    # the postmortem must still land when the engine is
                    # mid-teardown; record that the section is missing
                    _DEFAULT_REGISTRY.counter_inc(
                        "telemetry.flight.health_snapshot_errors"
                    )
            rec = {
                "format": self.FORMAT,
                "v": self.VERSION,
                "pid": os.getpid(),
                "ts": time.time(),
                "reason": reason,
                "capacity": self.capacity,
                "events": events,
                "counters": _DEFAULT_REGISTRY.snapshot(),
                "health": health,
            }
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(rec, f, separators=(",", ":"))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            _fsync_dir(os.path.dirname(os.path.abspath(path)))
            _DEFAULT_REGISTRY.counter_inc("telemetry.flight.dumps")
            if emit_event:
                emit(
                    EVENTS.HEALTH_FLIGHT_DUMP, reason=reason, path=path,
                    events=len(events),
                )
            return path
        except Exception:
            if _finalizing():
                return None
            raise
        finally:
            self._dump_guard.release()

    # -- fatal-path arming ---------------------------------------------------

    def install(self, path: str, *, signals: Optional[tuple] = None,
                on_exception: bool = True) -> None:
        """Arm the recorder: dump to ``path`` on SIGTERM/SIGABRT (or the
        given ``signals``) and — with ``on_exception`` — on any unhandled
        exception.  Must run on the MAIN thread (CPython delivers
        signals there; ``signal.signal`` enforces it).  The previous
        dispositions are saved and re-raised after the dump, so exit
        codes are preserved.  ``uninstall()`` restores everything."""
        import signal as _signal

        if signals is None:
            signals = (_signal.SIGTERM, _signal.SIGABRT)
        with self._lock:
            self._path = path

        def _on_signal(signum, frame):
            try:
                name = _signal.Signals(signum).name
            except ValueError:  # pragma: no cover — unnamed signal
                name = str(signum)
            # emit_event=False: the spine's locks may be held by the
            # very frame this handler interrupted (see dump docstring)
            self.dump(reason=f"signal:{name}", emit_event=False)
            # restore the pre-install disposition and re-raise so the
            # process still dies with the right exit status (TERM→143).
            # A None previous handler means it was installed at the C
            # level (e.g. faulthandler) — SIG_DFL is the only honest
            # restore signal.signal accepts for it
            prev = self._prev_handlers.get(signum)
            _signal.signal(
                signum, prev if prev is not None else _signal.SIG_DFL
            )
            os.kill(os.getpid(), signum)

        for signum in signals:
            self._prev_handlers[signum] = _signal.signal(
                signum, _on_signal
            )
        self._installed_signals = tuple(signals)
        if on_exception:
            prev_hook = sys.excepthook
            self._prev_excepthook = prev_hook

            def _on_exception(exc_type, exc, tb):
                self.dump(
                    reason=f"unhandled_exception:{exc_type.__name__}"
                )
                prev_hook(exc_type, exc, tb)

            sys.excepthook = _on_exception

    def uninstall(self) -> None:
        """Restore the previous signal dispositions and excepthook.
        Idempotent."""
        import signal as _signal

        for signum in self._installed_signals:
            prev = self._prev_handlers.pop(signum, None)
            if prev is not None:
                _signal.signal(signum, prev)
        self._installed_signals = ()
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
            self._prev_excepthook = None


# -- tracing spans (schema v2) ------------------------------------------------


class Span:
    """One in-flight span: identity + start time.  Create with
    ``start_span``/``span``; ids are run-unique strings (run token from
    ``configure()`` + a process-wide sequence)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t0")

    def __init__(self, name, trace_id, span_id, parent_id, t0):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = t0

    def __repr__(self):  # pragma: no cover — debugging aid
        return (
            f"Span({self.name!r}, trace={self.trace_id}, "
            f"span={self.span_id}, parent={self.parent_id})"
        )


_SPAN_TLS = threading.local()  # .current: the active Span of this thread
_SPAN_LOCK = threading.Lock()
_SPAN_SEQ = 0
# run token: regenerated by configure() so ids stay unique across the
# multiple runs that may append to one telemetry file
_RUN_TOKEN = "0"


def _new_span_id() -> str:
    global _SPAN_SEQ
    with _SPAN_LOCK:
        _SPAN_SEQ += 1
        return f"{_RUN_TOKEN}-{_SPAN_SEQ:x}"


def current_span() -> Optional[Span]:
    """This thread's innermost active span (set by ``span()`` /
    ``activate_span``), or None."""
    return getattr(_SPAN_TLS, "current", None)


def trace_fields() -> dict:
    """``{"trace_id", "span_id"}`` of the thread's active span — splice
    into flat events (``emit(..., **trace_fields())``) so dispatches,
    hash batches and tier fetches correlate with their batch trace.
    Empty when no span is active (the event stays v1-shaped)."""
    cur = current_span()
    if cur is None:
        return {}
    return {"trace_id": cur.trace_id, "span_id": cur.span_id}


def start_span(name: str, *, parent: Optional[Span] = None,
               new_trace: bool = False, require_parent: bool = False,
               **attrs) -> Optional[Span]:
    """Open a span and emit its ``span_start``; returns None (a no-op
    handle) when no sink is installed.

    Parenting: explicit ``parent=`` wins; otherwise the thread's active
    span; ``new_trace=True`` forces a fresh trace root (``parent_id``
    null).  ``require_parent=True`` skips the span entirely when there
    is no parent in scope — used by instrumented stages that only make
    sense inside a batch trace.  Close with ``end_span`` (any thread).
    """
    if not enabled():
        return None
    try:
        if parent is None and not new_trace:
            parent = current_span()
        if parent is None and require_parent and not new_trace:
            return None
        span_id = _new_span_id()
        if new_trace or parent is None:
            trace_id, parent_id = span_id, None
        else:
            trace_id, parent_id = parent.trace_id, parent.span_id
        s = Span(name, trace_id, span_id, parent_id, time.perf_counter())
        emit(
            EVENTS.SPAN_START, name=name, trace_id=trace_id,
            span_id=span_id, parent_id=parent_id, **attrs,
        )
        return s
    except Exception:
        if _finalizing():
            return None
        raise


def end_span(span_: Optional[Span], **attrs) -> None:
    """Emit the ``span_end`` for a span returned by ``start_span`` (from
    any thread).  None (disabled-telemetry handle) is a no-op; safe at
    interpreter teardown."""
    if span_ is None:
        return
    try:
        emit(
            EVENTS.SPAN_END, name=span_.name, trace_id=span_.trace_id,
            span_id=span_.span_id,
            dur_s=round(time.perf_counter() - span_.t0, 9), **attrs,
        )
    except Exception:
        if _finalizing():
            return
        raise


@contextlib.contextmanager
def activate_span(span_: Optional[Span]):
    """Make ``span_`` this thread's active span for the block — the
    explicit cross-thread propagation primitive: a consumer adopting a
    trace root the producer created re-activates it around its own
    stages so their spans parent correctly.  Does NOT end the span.
    None (telemetry disabled) is a cheap no-op."""
    if span_ is None:
        yield None
        return
    prev = getattr(_SPAN_TLS, "current", None)
    _SPAN_TLS.current = span_
    try:
        yield span_
    finally:
        _SPAN_TLS.current = prev


@contextlib.contextmanager
def span(name: str, *, parent: Optional[Span] = None,
         new_trace: bool = False, require_parent: bool = False, **attrs):
    """Context manager: ``start_span`` + thread-local activation +
    ``end_span``.  Yields the ``Span`` (None when telemetry is off)."""
    s = start_span(
        name, parent=parent, new_trace=new_trace,
        require_parent=require_parent, **attrs,
    )
    if s is None:
        yield None
        return
    try:
        with activate_span(s):
            yield s
    finally:
        end_span(s)


def parse_event(line: str) -> dict:
    """Parse + validate one JSONL event line (the shipped round-trip
    parser: anything ``TelemetryLog.emit`` writes, this loads back).
    Raises ``ValueError`` on malformed lines or unsupported versions."""
    try:
        rec = json.loads(line)
    except json.JSONDecodeError as e:
        raise ValueError(f"not a JSON event line: {line!r}") from e
    if not isinstance(rec, dict):
        raise ValueError(f"event line is not an object: {line!r}")
    if rec.get("v") not in SUPPORTED_SCHEMA_VERSIONS:
        raise ValueError(
            f"unsupported telemetry schema version {rec.get('v')!r} "
            f"(supported: {sorted(SUPPORTED_SCHEMA_VERSIONS)})"
        )
    if not isinstance(rec.get("event"), str) or not isinstance(
        rec.get("ts"), (int, float)
    ):
        raise ValueError(f"event line missing 'event'/'ts': {line!r}")
    return rec


def read_events(path: str) -> Iterator[dict]:
    """Iterate the validated events of a JSONL telemetry file.  A torn
    FINAL line (crash mid-write) is tolerated and skipped; a torn line
    anywhere else raises — that file is corrupt, not merely truncated.
    Streams with one line of lookahead (O(1) memory)."""
    with open(path) as f:
        pending: Optional[str] = None
        for line in f:
            line = line.rstrip("\n")
            if not line.strip():
                continue
            if pending is not None:
                yield parse_event(pending)  # non-final: torn ⇒ raise
            pending = line
        if pending is not None:
            try:
                yield parse_event(pending)
            except ValueError:  # torn final line: tolerated
                return


# -- OpenMetrics / Prometheus text exposition --------------------------------


def _om_name(name: str) -> str:
    """Metric name → OpenMetrics-legal name (``rp_`` namespace, dots and
    other separators to underscores)."""
    return "rp_" + re.sub(r"[^a-zA-Z0-9_]", "_", name)


def _om_num(v) -> str:
    """Render a sample value; OpenMetrics wants plain decimal/scientific
    (repr of a Python float qualifies; ints stay ints)."""
    if isinstance(v, bool):  # pragma: no cover — no bool metrics today
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return repr(float(v))


def _merge_snapshots(snapshots) -> dict:
    """Merge ``MetricsRegistry.snapshot()`` dicts (the default registry
    plus per-stream registries) into one: counters and histogram
    sums/counts/buckets add; gauges combine max-of-max, sum/n add, and
    the later snapshot's ``last`` wins."""
    out = {"counters": {}, "gauges": {}, "histograms": {}}
    for snap in snapshots:
        for k, v in (snap.get("counters") or {}).items():
            out["counters"][k] = out["counters"].get(k, 0) + v
        for k, g in (snap.get("gauges") or {}).items():
            m = out["gauges"].setdefault(
                k, {"last": 0, "max": 0, "sum": 0.0, "n": 0}
            )
            m["last"] = g["last"]
            m["max"] = max(m["max"], g["max"]) if m["n"] else g["max"]
            m["sum"] += g["sum"]
            m["n"] += g["n"]
        for k, h in (snap.get("histograms") or {}).items():
            m = out["histograms"].setdefault(
                k, {"sum": 0.0, "count": 0, "buckets": {}}
            )
            m["sum"] += h["sum"]
            m["count"] += h["count"]
            for b, c in (h.get("buckets") or {}).items():
                m["buckets"][str(b)] = m["buckets"].get(str(b), 0) + c
    return out


def to_openmetrics(*snapshots: dict) -> str:
    """Render one or more ``MetricsRegistry.snapshot()`` dicts as an
    OpenMetrics/Prometheus text exposition (pure text — scrape it from a
    file or paste it into a pushgateway; no HTTP server involved).

    Mapping: counters → ``<name>_total``; gauges → three gauges
    (``<name>`` = last sample, ``<name>_max``, ``<name>_mean``);
    wall-clock histograms → a ``<name>_seconds`` histogram whose
    ``le`` boundaries are the registry's fixed log2 bucket upper edges
    (bucket *i* = ``[2^i, 2^(i+1))`` µs ⇒ ``le = 2^(i+1)·1e-6`` s),
    cumulative per the spec, with exact ``_sum``/``_count`` — PLUS a
    sibling ``<name>_seconds_quantile`` summary carrying
    p50/p90/p99/p99.9 extracted from the buckets
    (``quantiles_from_buckets``: exact for 0/1 samples, within one log2
    bucket otherwise), the serve-latency tail numbers a scrape needs
    without re-deriving them from bucket math.  Output is
    deterministically ordered and ends with ``# EOF``.
    """
    m = _merge_snapshots(snapshots)
    lines = []
    for name in sorted(m["counters"]):
        om = _om_name(name)
        lines.append(f"# TYPE {om} counter")
        lines.append(f"{om}_total {_om_num(m['counters'][name])}")
    for name in sorted(m["gauges"]):
        g = m["gauges"][name]
        om = _om_name(name)
        mean = g["sum"] / g["n"] if g["n"] else 0.0
        for suffix, v in (("", g["last"]), ("_max", g["max"]),
                          ("_mean", mean)):
            lines.append(f"# TYPE {om}{suffix} gauge")
            lines.append(f"{om}{suffix} {_om_num(v)}")
    for name in sorted(m["histograms"]):
        h = m["histograms"][name]
        om = _om_name(name) + "_seconds"
        lines.append(f"# TYPE {om} histogram")
        cum = 0
        for b in sorted(int(k) for k in h["buckets"]):
            cum += h["buckets"][str(b)]
            le = _om_num((1 << (b + 1)) * 1e-6)
            lines.append(f'{om}_bucket{{le="{le}"}} {cum}')
        lines.append(f'{om}_bucket{{le="+Inf"}} {h["count"]}')
        lines.append(f"{om}_sum {_om_num(h['sum'])}")
        lines.append(f"{om}_count {h['count']}")
        qs = quantiles_from_buckets(h["buckets"], h["count"], h["sum"])
        if qs["count"]:
            qom = om + "_quantile"
            lines.append(f"# TYPE {qom} summary")
            for q, key in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99"),
                           (0.999, "p99.9")):
                lines.append(
                    f'{qom}{{quantile="{q}"}} {_om_num(qs[key])}'
                )
            lines.append(f"{qom}_sum {_om_num(h['sum'])}")
            lines.append(f"{qom}_count {h['count']}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"
