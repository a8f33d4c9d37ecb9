"""Observability: per-batch stream counters and profiler hooks.

The counterpart of ``randomprojection_tpu/utils/observability.py``:
``StreamStats`` (commit counters, per-stage wall histograms, the
queue-occupancy gauge, the overlap ratio) on a
``telemetry.MetricsRegistry``, double-writing to the process-wide JSONL
event log when one is configured, ``batch_nbytes``, ``stage``, and the
profiler hooks on ``torch.profiler``: ``profile_trace`` writes a
Chrome/Perfetto trace, ``annotate`` names a region in its timeline and,
while a profiler records, keeps it in an in-memory span store beside the
interpreter's collections and the waves of counted kernel launches
(``recorded_spans``, ``gc_collections``, ``launch_waves``).
"""

from __future__ import annotations

import collections
import contextlib
import gc
import logging
import os
import sys
import threading
import time
from typing import Optional

from randomprojection_tpu_torch.utils import telemetry
from randomprojection_tpu_torch.utils.telemetry import EVENTS, MetricsRegistry

#: the port's logger (the JAX package logs to "randomprojection_tpu")
logger = logging.getLogger("randomprojection_tpu_torch")

__all__ = [
    "StreamStats", "batch_nbytes", "profile_trace", "annotate", "logger",
    "stage", "recording", "record_span", "perf_offset_ns", "recorded_spans",
    "dropped_spans", "gc_collections", "clear_spans", "count_waves",
    "launch_waves",
]


def batch_nbytes(batch) -> int:
    """Payload bytes of one (dense, tensor or scipy-sparse) batch.

    scipy sparse carries its payload in per-format component arrays and
    exposes no ``.nbytes`` itself.  CSR/CSC/BSR count
    data+indices+indptr, COO data+coords (or row/col on pre-array scipy),
    DIA data+offsets.  Formats without flat numeric component arrays
    (LIL's object-dtype row lists, DOK's dict) are *estimated* as
    ``nnz · (itemsize + index bytes)``, so no sparse stream records 0."""
    import numpy as np
    import scipy.sparse as sp

    if not sp.issparse(batch):
        return int(getattr(batch, "nbytes", 0))
    data = getattr(batch, "data", None)
    if not isinstance(data, np.ndarray) or data.dtype == object:
        # LIL/DOK: no flat payload arrays to count — estimate the
        # COO-equivalent payload, one value + a (row, col) intp pair per
        # stored element
        return int(batch.nnz) * (
            np.dtype(batch.dtype).itemsize + 2 * np.dtype(np.intp).itemsize
        )
    total = int(data.nbytes)
    coords = getattr(batch, "coords", None)
    if isinstance(coords, tuple):  # COO; .row/.col are views of .coords
        return total + sum(int(c.nbytes) for c in coords)
    for a in ("indices", "indptr", "row", "col", "offsets"):
        v = getattr(batch, a, None)
        if isinstance(v, np.ndarray):
            total += int(v.nbytes)
    return total


def stage(stats: Optional["StreamStats"], name: str):
    """``stats.stage(name)`` when stats is given, else a span-only
    context — so pipeline stages can be instrumented unconditionally.
    Either way the region emits a tracing span when a batch trace is
    active on this thread (``require_parent``: stray stage timings
    outside any trace never start orphan traces)."""
    if stats is None:
        return telemetry.span(name, require_parent=True)
    return stats.stage(name)


class StreamStats:
    """Running counters for a streamed transform.

    Pass to ``stream_transform(..., stats=...)``; updated at every commit
    (host materialization), so throughput includes the full h2d →
    kernel → d2h pipeline, not just dispatch.

    Storage is a ``telemetry.MetricsRegistry`` (one per StreamStats, or a
    shared one passed as ``registry=``): commit counters are registry
    counters, stage walls are log2 wall-clock histograms (their exact
    ``sum`` is the ``stage_wall`` value), the queue-occupancy samples are a
    gauge.  ``batches``/``rows``/``bytes_in``/``bytes_out``/``stage_wall``/
    ``queue_depth_max`` are read-only views of the registry.

    Per-stage wall attribution: pipeline stages (``read`` in
    ``CallableSource`` and ``TokenSource`` given ``stats``, ``hash`` in
    ``TokenSource``, ``h2d`` in the ingest sources' prepare step,
    ``dispatch``/``d2h`` in ``stream_transform``) wrap themselves in
    ``stage(name)``, accumulating wall-clock — the producer stages run on
    worker threads, the consumer stages on the caller's, so with an
    overlapped pipeline the stage walls can legitimately sum to MORE than
    the end-to-end elapsed time.  That excess is the measured overlap:
    ``overlap_ratio() = 1 - elapsed / Σ stage_wall`` (clamped at 0) — 0 for
    a fully serial pipeline, → 0.5 when two equal stages fully overlap.
    ``on_queue_depth`` is the ingest queue-occupancy gauge, sampled by the
    producer at each delivery: a max that sits at 0 means the consumer
    always had the queue drained (producer-bound stream); the queue
    capacity means the producer had to wait for space (consumer-bound).
    """

    def __init__(self, log_every: int = 0,
                 registry: Optional[MetricsRegistry] = None):
        self.log_every = log_every
        self.registry = registry if registry is not None else MetricsRegistry()
        self._t0: Optional[float] = None
        self._t_last: Optional[float] = None

    # -- registry-backed views ------------------------------------------------

    @property
    def batches(self) -> int:
        return int(self.registry.counter("stream.batches"))

    @property
    def rows(self) -> int:
        return int(self.registry.counter("stream.rows"))

    @property
    def bytes_in(self) -> int:
        return int(self.registry.counter("stream.bytes_in"))

    @property
    def bytes_out(self) -> int:
        return int(self.registry.counter("stream.bytes_out"))

    @property
    def stage_wall(self) -> dict:
        return self.registry.hist_sums("stage.")

    @property
    def queue_depth_max(self) -> int:
        return int(self.registry.gauge_max("stream.queue_depth"))

    def queue_depth_mean(self) -> float:
        return self.registry.gauge_mean("stream.queue_depth")

    # -- recording ----------------------------------------------------------

    def start(self) -> None:
        """Start the clock — called by ``stream_transform`` before the first
        batch is dispatched, so throughput includes the first batch's full
        h2d → kernel → d2h time (not just inter-commit gaps)."""
        self._t0 = time.perf_counter()

    def on_commit(self, start_row: int, bytes_in: int, batch_out) -> None:
        now = time.perf_counter()
        if self._t0 is None:  # standalone use without start(): degrade
            self._t0 = now
        self._t_last = now
        n = getattr(batch_out, "shape", (0,))[0]
        out_bytes = batch_nbytes(batch_out)
        r = self.registry
        r.counter_inc("stream.batches")
        r.counter_inc("stream.rows", n)
        r.counter_inc("stream.bytes_in", bytes_in)
        r.counter_inc("stream.bytes_out", out_bytes)
        telemetry.emit(
            EVENTS.STREAM_COMMIT, row=int(start_row), rows=int(n),
            bytes_in=int(bytes_in), bytes_out=int(out_bytes),
            **telemetry.trace_fields(),
        )
        if self.log_every and self.batches % self.log_every == 0:
            logger.info(
                "stream: %d batches, %d rows, %.0f rows/s",
                self.batches, self.rows, self.rows_per_s(),
            )

    @contextlib.contextmanager
    def stage(self, name: str):
        """Attribute the wrapped region's wall-clock to pipeline stage
        ``name``.  Thread-safe: producer stages record from worker threads
        concurrently with the consumer's dispatch/d2h stages.  When a
        batch trace is active on this thread the region also emits a
        child span, so the per-batch critical path is reconstructable —
        ``require_parent`` keeps standalone stage timings from opening
        orphan traces."""
        t0 = time.perf_counter()
        with telemetry.span(name, require_parent=True):
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                self.registry.observe("stage." + name, dt)
                telemetry.emit(
                    EVENTS.STAGE_WALL, stage=name, wall_s=round(dt, 6)
                )

    def on_queue_depth(self, depth: int) -> None:
        """Record one ingest-queue occupancy sample (taken by the producer
        at each delivery)."""
        self.registry.gauge_set("stream.queue_depth", depth)

    def overlap_ratio(self) -> float:
        """Fraction of attributed stage wall hidden by overlap:
        ``1 - elapsed / Σ stage_wall``, clamped at 0.  Exactly 0 when the
        stages ran back-to-back on one thread; approaches ``1 - 1/n`` when
        ``n`` equal stages run fully concurrently.  Only attributed stages
        count, so unattributed host work outside any ``stage()`` region
        biases the ratio DOWN (never fakes overlap)."""
        total = sum(self.stage_wall.values())
        elapsed = self.elapsed_s()
        if total <= 0.0 or elapsed <= 0.0:
            return 0.0
        return max(0.0, 1.0 - elapsed / total)

    def elapsed_s(self) -> float:
        if self._t0 is None or self._t_last is None:
            return 0.0
        return max(self._t_last - self._t0, 1e-9)

    def rows_per_s(self) -> float:
        return self.rows / self.elapsed_s() if self.rows else 0.0

    def summary(self) -> dict:
        out = {
            "batches": self.batches,
            "rows": self.rows,
            "bytes_in": self.bytes_in,
            "bytes_out": self.bytes_out,
            "elapsed_s": round(self.elapsed_s(), 4),
            "rows_per_s": round(self.rows_per_s(), 1),
        }
        stage_wall = self.stage_wall
        if stage_wall:
            out["stage_wall_s"] = {
                k: round(v, 4) for k, v in sorted(stage_wall.items())
            }
            out["pipeline_overlap_ratio"] = round(self.overlap_ratio(), 3)
        if self.registry.gauge("stream.queue_depth")["n"]:
            out["queue_depth_max"] = self.queue_depth_max
            out["queue_depth_mean"] = round(self.queue_depth_mean(), 2)
        return out


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """Record the region with ``torch.profiler`` (the host and, where a
    card is present, its kernels and copies) and write the timeline to
    ``log_dir/trace.json`` in the Chrome trace format Perfetto opens.
    A no-op when ``log_dir`` is falsy, so callers can thread a
    ``--profile-dir`` flag unconditionally."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """The port's program span: a named region visible in profiler
    timelines (``torch.profiler.record_function``) and kept in the span
    store (``recorded_spans``).

    A shared null context unless a profiler is recording: with none
    active the hot path pays one attribute read, and a numpy-only run
    never imports torch for it."""
    prof = _PROFILER or _bind_profiler()
    if prof is None or not prof._is_profiler_enabled:
        return _NULL
    return _Span(name)


_NULL = contextlib.nullcontext()

# -- the span store --------------------------------------------------------
#
# While a profiler records, every program span lands here as ``(name,
# native thread id, start_ns, end_ns)`` on the profiler's own clock:
# kineto stamps host events in Unix-epoch nanoseconds, which is
# ``time.time_ns()``, so a span and its ``record_function`` echo agree.
# The profiler keeps the ``record_function`` regions of the thread that
# started it only; the store keeps every thread's (a server's
# dispatcher, a pipeline's workers).
# Nothing is written while no profiler records, and nothing here clears
# the store but ``clear_spans``: a reader that runs after a traced window
# sees exactly what that window recorded.

#: entries the ring holds before it drops the oldest
SPAN_CAPACITY = 1 << 20

_PROFILER = None  # ``torch.autograd.profiler`` once torch is imported
_spans: collections.deque = collections.deque(maxlen=SPAN_CAPACITY)
# re-entrant: a collection's callback may append on a thread that is
# inside ``_store``
_spans_lock = threading.RLock()
_dropped = 0
# generation -> [collections, summed wall ns], while recording
_gc_totals = {g: [0, 0] for g in range(3)}
_gc_open = None  # (generation, start_ns, record_function or None)
# kernel -> [launches, blocks, wave slots], while recording
_waves: dict = {}


def _bind_profiler():
    """``torch.autograd.profiler`` if torch is loaded (bound once)."""
    global _PROFILER
    _PROFILER = sys.modules.get("torch.autograd.profiler")
    return _PROFILER


def recording() -> bool:
    """Whether a profiler records (and so the span store is written)."""
    prof = _PROFILER or _bind_profiler()
    return prof is not None and bool(prof._is_profiler_enabled)


_thread = threading.local()


def _tid() -> int:
    """This thread's native id, as the profiler names threads (a system
    call, of microseconds on some hosts: made once a thread)."""
    try:
        return _thread.tid
    except AttributeError:
        _thread.tid = tid = threading.get_native_id()
        return tid


def _store(name: str, tid: int, start_ns: int, end_ns: int) -> None:
    global _dropped
    with _spans_lock:
        if len(_spans) == _spans.maxlen:
            _dropped += 1
        _spans.append((name, tid, start_ns, end_ns))


class _Span:
    """``record_function(name)`` that also stores its interval."""

    __slots__ = ("name", "_rf", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        import torch

        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        self._rf.__exit__(*exc)
        _store(self.name, _tid(), self._t0, t1)
        return False


def record_span(name: str, start_ns: int, end_ns: int) -> None:
    """Store an interval that ``record_function`` cannot hold (it began on
    another thread), on the profiler's clock (``perf_offset_ns``), under
    the calling thread.  Dropped while no profiler records."""
    if recording():
        _store(name, _tid(), int(start_ns), int(end_ns))


def perf_offset_ns() -> int:
    """Add to ``time.perf_counter()`` nanoseconds to land on the
    profiler's clock: stamps already taken on ``perf_counter`` become
    spans with ``int(t * 1e9) + offset``."""
    return time.time_ns() - time.perf_counter_ns()


def recorded_spans() -> list:
    """The stored spans, oldest first: ``(name, native thread id,
    start_ns, end_ns)``."""
    with _spans_lock:
        return list(_spans)


def dropped_spans() -> int:
    """Spans the full ring dropped since the last ``clear_spans``."""
    return _dropped


def gc_collections() -> dict:
    """The interpreter's collections while recording: ``{generation:
    (collections, summed wall ns)}``."""
    with _spans_lock:
        return {g: tuple(v) for g, v in _gc_totals.items()}


def count_waves(kernel: str, blocks: int, slots: int) -> None:
    """Count one launch of ``kernel``: its grid's ``blocks`` and the block
    ``slots`` of its waves (``ceil(blocks / SMs) · SMs`` for a kernel that
    runs one block an SM).  Dropped while no profiler records."""
    if not recording():
        return
    with _spans_lock:
        tot = _waves.setdefault(kernel, [0, 0, 0])
        tot[0] += 1
        tot[1] += blocks
        tot[2] += slots


def launch_waves() -> dict:
    """The launches counted while recording: ``{kernel: (launches, blocks,
    wave slots)}``."""
    with _spans_lock:
        return {k: tuple(v) for k, v in _waves.items()}


def clear_spans() -> None:
    """Empty the store, its drop counter, the collection counters and the
    launches' waves."""
    global _dropped
    with _spans_lock:
        _spans.clear()
        _dropped = 0
        for v in _gc_totals.values():
            v[0] = v[1] = 0
        _waves.clear()


def _gc_hook(phase: str, info: dict) -> None:
    """The interpreter's collections while a profiler records: counted and
    timed a generation, and a generation-2 collection (every thread
    stops) is the span ``rp:gc/gen2`` in the store and the profiler."""
    global _gc_open
    prof = _PROFILER or _bind_profiler()
    if (prof is None or not prof._is_profiler_enabled) and _gc_open is None:
        return
    if phase == "start":
        gen, rf = info["generation"], None
        if gen == 2:
            import torch

            rf = torch.profiler.record_function("rp:gc/gen2")
            rf.__enter__()
        _gc_open = (gen, time.time_ns(), rf)
        return
    if _gc_open is None:
        return
    t1 = time.time_ns()
    gen, t0, rf = _gc_open
    _gc_open = None
    if rf is not None:
        rf.__exit__(None, None, None)
    with _spans_lock:
        tot = _gc_totals[gen]
        tot[0] += 1
        tot[1] += t1 - t0
        if gen == 2:
            _store("rp:gc/gen2", _tid(), t0, t1)


if _gc_hook not in gc.callbacks:
    gc.callbacks.append(_gc_hook)
