"""Telemetry core: metrics registry and JSONL event log.

A copy of the core of ``randomprojection_tpu/utils/telemetry.py`` (the
port imports nothing of that package): the ``EVENTS`` registry with the
same names, ``MetricsRegistry`` (counters, gauges, log2 histograms and
their quantiles), the process-wide ``registry()``, the versioned JSONL
sink (``TelemetryLog``, ``configure``/``shutdown``/``enabled``/``emit``)
``parse_event`` and the tracing spans (``Span``, ``start_span``,
``end_span``, ``activate_span``, ``span``, ``current_span``,
``trace_fields``: one trace per streamed batch, its child spans across
threads).  Files it writes parse with the reference's ``read_events`` and
its ``trace_report.build_report``.  Live subscribers, ``LiveAggregator``,
``FlightRecorder`` and the OpenMetrics exposition are a later slice
(ROADMAP A13); until then ``emit`` writes to the JSONL sink alone and is
a no-op without one.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import sys
import threading
import time
from typing import Optional

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
    "emit",
    "parse_event",
    "Span",
    "current_span",
    "trace_fields",
    "start_span",
    "end_span",
    "activate_span",
    "span",
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
        self._lock = threading.Lock()
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
    """True when a process-wide sink is installed.  Hot paths with
    non-trivial payload construction should guard on this."""
    return _ACTIVE_LOG is not None


def _finalizing() -> bool:
    """True when the interpreter is tearing down (or so far gone that we
    cannot even tell).  Emitting from a daemon thread or a ``__del__``
    at that point must drop the event, never traceback."""
    try:
        return sys is None or sys.is_finalizing()
    # rplint: allow[RP06] — teardown probe: the failure IS the answer
    except Exception:  # pragma: no cover — modules already demolished
        return True


def emit(event: str, **fields) -> None:
    """Emit one event to the process-wide sink; no-op when none is
    installed (one global read — safe in hot paths).  Safe during
    interpreter teardown: a late emit from a daemon thread or a
    ``__del__`` is dropped instead of raising into the finalizer."""
    log = _ACTIVE_LOG
    if log is None:
        return
    try:
        log.emit(event, **fields)
    except Exception:
        if _finalizing():
            return
        raise



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
