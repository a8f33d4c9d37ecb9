"""Streamed row-batch transform (layer L2) with checkpoint/resume.

The counterpart of ``randomprojection_tpu/streaming.py``: seekable
sources (the raw-token ``TokenSource`` of config 5 among them), the
fault-injection wrapper, the host-fed ingest pipelines, the stream
cursor, ``stream_transform``'s ack-after-yield commit and the per-batch
traces.

- **Seekable sources.**  A ``RowBatchSource`` yields fixed-size row batches
  *starting from any row offset*.
- **Cursor checkpointing.**  Progress is just ``rows_done``.  The matrix
  is derived from the seed and batches are pure functions of their row
  range, so a run resumed from its cursor produces **bit-identical**
  output.
- **Pipelining.**  ``pipeline_depth`` batches are in flight: batch
  ``i+1`` is uploaded and launched while batch ``i``'s output is still
  being copied to the host.  A card output's copy starts right after its
  kernel, into pinned host memory, so waiting for batch ``i`` never
  waits for batch ``i+1``'s kernel.
- **Host-fed ingest.**  ``PrefetchSource`` runs the source (and an
  optional ``prepare`` step, the estimator's ``prepare_batch``: the
  batch's host→device copy, queued on the backend's copy stream with an
  event behind it) on one worker thread behind a bounded queue;
  ``StagedIngestSource`` splits production over a pool of workers
  (disjoint batches, reassembled in row order — bit-identical to serial)
  feeding one uploader thread.  Prefetch changes *when* batches are
  produced, never when they are committed: ``rows_done`` advances only
  after the consumer has processed a batch, and a resume recomputes
  whatever was produced ahead.
- **Per-batch tracing.**  With a telemetry sink configured, every batch
  carries one trace: a root span opened where production starts (a
  worker thread, for an overlapped pipeline) whose child spans cover
  hash, enqueue-wait, h2d, dispatch and d2h across threads, closed at
  commit or as ``abandoned`` on a break or an exception.
"""

from __future__ import annotations

import dataclasses
import json
import numbers
import os
import queue
import sys
import threading
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import scipy.sparse as sp

from randomprojection_tpu_torch.utils import telemetry
from randomprojection_tpu_torch.utils.observability import (
    annotate,
    batch_nbytes,
    logger,
    stage as _stage,
)
from randomprojection_tpu_torch.utils.telemetry import EVENTS

__all__ = [
    "RowBatchSource",
    "ArraySource",
    "CallableSource",
    "TokenSource",
    "FaultInjectionSource",
    "PrefetchSource",
    "StagedIngestSource",
    "StreamCursor",
    "iter_traced",
    "stream_transform",
    "stream_to_array",
    "stream_to_memmap",
]


def _fsync_dir(dirpath: str) -> None:
    """fsync a DIRECTORY so a just-``os.replace``'d entry survives a
    machine crash, not only a process crash.  Best-effort on filesystems
    that refuse to fsync directories."""
    try:
        fd = os.open(dirpath or ".", os.O_RDONLY)
    except OSError:  # pragma: no cover — unopenable dir (exotic fs)
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover — fs refuses directory fsync
        pass
    finally:
        os.close(fd)


def _batch_rows(batch, default: Optional[int] = None) -> Optional[int]:
    """Row count of one in-flight batch, tolerant of prepared operands.

    ``prepare_batch`` hooks may replace the raw batch with a device-side
    carrier (``models.sketch.DeviceBatch`` mirrors ``.shape``; other
    carriers may not).  Resolution order: a real leading ``shape``
    dimension, then an integral ``.n``, then ``default``.
    """
    shape = getattr(batch, "shape", None)
    if shape is not None:
        try:
            return int(shape[0])
        except (TypeError, IndexError, ValueError):
            pass
    n = getattr(batch, "n", None)
    if isinstance(n, numbers.Integral):
        return int(n)
    return default


def iter_traced(source, start_row: int = 0):
    """Iterate a source as ``(start_row, batch, trace_root)`` triples —
    the tracing-aware face of ``iter_batches``.

    Every batch gets ONE trace: a root span named ``batch`` opened when
    production of that batch begins and closed by whoever finishes the
    batch's lifecycle (``stream_transform`` ends it at commit; the plain
    ``iter_batches`` wrappers end it when the consumer's loop body
    returns).  Production runs with the root activated on the producing
    thread, so instrumented stages inside the source (``TokenSource``'s
    hash) emit correctly-parented child spans.  Sources that own a
    producer thread implement ``iter_batches_traced`` and are deferred
    to — the root then travels explicitly from the worker thread through
    the queue.  With no telemetry sink installed the roots are all None.
    """
    traced = getattr(source, "iter_batches_traced", None)
    if traced is not None:
        yield from traced(start_row)
        return
    it = source.iter_batches(start_row)
    try:
        while True:
            root = telemetry.start_span("batch", new_trace=True)
            try:
                with telemetry.activate_span(root):
                    try:
                        item = next(it)
                    except StopIteration:
                        # production began but there was no next batch:
                        # close the root as empty, not as an orphan
                        telemetry.end_span(root, empty=True)
                        return
            except BaseException:
                telemetry.end_span(root, error=True)
                raise
            yield item[0], item[1], root
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()


def _check_start_row(start_row: int, batch_rows: int, n_rows: int) -> None:
    """Resume offsets must land on a batch boundary — or be the end of the
    stream (a completed run's cursor equals n_rows)."""
    if start_row == n_rows:
        return
    if start_row % batch_rows:
        raise ValueError(
            f"start_row={start_row} must be a multiple of batch_rows="
            f"{batch_rows} or n_rows={n_rows} (cursors always are)"
        )


class RowBatchSource:
    """Protocol: a seekable, schema-bearing stream of row batches.

    Subclasses provide ``n_rows``, ``n_features``, ``dtype`` and
    ``iter_batches(start_row)`` yielding ``(start_row, batch)`` pairs where
    every batch has ``batch_rows`` rows except possibly the last.
    """

    batch_rows: int
    n_rows: int
    n_features: int
    dtype: np.dtype

    def iter_batches(self, start_row: int = 0) -> Iterator[Tuple[int, np.ndarray]]:
        raise NotImplementedError

    def schema(self) -> Tuple[int, int, np.dtype]:
        """(n_rows, n_features, dtype) — all that fit() needs."""
        return self.n_rows, self.n_features, self.dtype


class ArraySource(RowBatchSource):
    """In-memory ndarray/CSR source — slicing is the seek."""

    def __init__(self, X, batch_rows: int = 65536):
        if batch_rows <= 0:
            raise ValueError(f"batch_rows must be positive, got {batch_rows}")
        if not sp.issparse(X):
            X = np.asarray(X)
        if X.ndim != 2:
            raise ValueError(f"Expected 2D input, got shape {getattr(X, 'shape', None)}")
        self._X = X
        self.batch_rows = batch_rows
        self.n_rows, self.n_features = X.shape
        self.dtype = X.dtype

    def iter_batches(self, start_row: int = 0):
        _check_start_row(start_row, self.batch_rows, self.n_rows)
        for lo in range(start_row, self.n_rows, self.batch_rows):
            hi = min(lo + self.batch_rows, self.n_rows)
            yield lo, self._X[lo:hi]


class CallableSource(RowBatchSource):
    """Out-of-core source: ``read(lo, hi) -> (hi-lo, d) array``.

    The callable abstracts any seekable storage (memory-mapped file, object
    store with range reads, database pagination).  It must be deterministic
    in ``(lo, hi)`` for resume to be exact.  ``stats`` (a ``StreamStats``)
    attributes the read's wall to the ``'read'`` stage, so the stream's
    overlap ratio counts the read among the stages it overlaps.
    """

    def __init__(self, read: Callable[[int, int], np.ndarray], n_rows: int,
                 n_features: int, dtype=np.float32, batch_rows: int = 65536,
                 *, stats=None):
        if batch_rows <= 0:
            raise ValueError(f"batch_rows must be positive, got {batch_rows}")
        self._read = read
        self.batch_rows = batch_rows
        self.n_rows = n_rows
        self.n_features = n_features
        self.dtype = np.dtype(dtype)
        self.stats = stats

    def iter_batches(self, start_row: int = 0):
        _check_start_row(start_row, self.batch_rows, self.n_rows)
        for lo in range(start_row, self.n_rows, self.batch_rows):
            hi = min(lo + self.batch_rows, self.n_rows)
            with _stage(self.stats, "read"):
                batch = self._read(lo, hi)
            if tuple(batch.shape) != (hi - lo, self.n_features):
                raise ValueError(
                    f"Source returned shape {tuple(batch.shape)} for rows "
                    f"[{lo},{hi}); expected {(hi - lo, self.n_features)}"
                )
            yield lo, batch


class TokenSource(RowBatchSource):
    """Raw-token documents → hashed CSR batches (the config-5 pipeline,
    "streaming TF-IDF").

    ``read_tokens(lo, hi)`` returns the tokens of documents ``[lo, hi)`` as
    ``(tokens, indptr)`` or ``(tokens, indptr, values)``: ``tokens`` a flat
    array or sequence, ``indptr`` LOCAL row pointers of length ``hi-lo+1``
    (``indptr[0] == 0``).  ``hasher`` (``ops.hashing.FeatureHasher``)
    hashes each batch into a CSR; composed with
    ``CountSketch.transform_stream`` this is tokens → murmur3 (C++) → the
    sketch on the card, with the cursor's checkpoint and resume (the
    cursor counts documents; ``read_tokens`` must be deterministic in
    ``(lo, hi)``).  ``hash_threads`` pins the C++ kernel's worker count
    for each batch's hash (bit-identical at any count; ``None`` keeps the
    ambient default).  ``stats`` (a ``StreamStats``) attributes the token
    read's wall to the ``'read'`` stage and the hash's to the ``'hash'``
    stage; composed with an ingest source both run on a worker thread,
    overlapping the card's work.
    """

    def __init__(self, read_tokens: Callable, n_rows: int, hasher,
                 batch_rows: int = 65536, *,
                 hash_threads: Optional[int] = None, stats=None):
        if batch_rows <= 0:
            raise ValueError(f"batch_rows must be positive, got {batch_rows}")
        if hash_threads is not None and int(hash_threads) < 1:
            raise ValueError(
                f"hash_threads must be >= 1 or None, got {hash_threads!r}"
            )
        self._read_tokens = read_tokens
        self.hasher = hasher
        self.batch_rows = batch_rows
        self.n_rows = n_rows
        self.n_features = hasher.n_features
        self.dtype = np.dtype(hasher.dtype)
        self.hash_threads = hash_threads
        self.stats = stats

    def iter_batches(self, start_row: int = 0):
        from randomprojection_tpu_torch.ops.hashing import hash_threads_override

        _check_start_row(start_row, self.batch_rows, self.n_rows)
        for lo in range(start_row, self.n_rows, self.batch_rows):
            hi = min(lo + self.batch_rows, self.n_rows)
            with _stage(self.stats, "read"):
                out = self._read_tokens(lo, hi)
            tokens, indptr = out[0], out[1]
            values = out[2] if len(out) > 2 else None
            with annotate("rp:stream/hash_tokens"), \
                    _stage(self.stats, "hash"), \
                    hash_threads_override(self.hash_threads):
                batch = self.hasher.transform_tokens(tokens, indptr, values)
            if batch.shape != (hi - lo, self.n_features):
                raise ValueError(
                    f"read_tokens produced a {batch.shape} batch for rows "
                    f"[{lo},{hi}); expected {(hi - lo, self.n_features)} — "
                    "indptr must be local with indptr[0]=0"
                )
            yield lo, batch


class FaultInjectionSource(RowBatchSource):
    """Test wrapper: raises at the ``fail_after_batches``-th GLOBAL batch.

    The fault-injection harness: crash a stream mid-flight, resume from
    the checkpoint cursor, assert bit-identical output.  The fault fires
    on the batch's global index (``lo // batch_rows``), not on a per-
    iterator yield count, so a resumed iteration that starts past the
    threshold fails at once until ``disarm()``.
    """

    class InjectedFault(RuntimeError):
        pass

    def __init__(self, inner: RowBatchSource, fail_after_batches: int):
        self._inner = inner
        self.fail_after_batches = fail_after_batches
        self.batch_rows = inner.batch_rows
        self.n_rows = inner.n_rows
        self.n_features = inner.n_features
        self.dtype = inner.dtype
        self._armed = True

    def disarm(self):
        self._armed = False

    def iter_batches(self, start_row: int = 0):
        for lo, batch in self._inner.iter_batches(start_row):
            if self._armed and lo // self.batch_rows >= self.fail_after_batches:
                raise self.InjectedFault(
                    f"injected fault before batch {lo // self.batch_rows} "
                    f"(row {lo})"
                )
            yield lo, batch


class PrefetchSource(RowBatchSource):
    """Asynchronous producer stage: run ``inner.iter_batches`` (and an
    optional ``prepare`` step) on a background worker thread, feeding the
    consumer through a bounded queue.

    With a ``TokenSource`` inner, hashing of batch ``i+1`` runs while the
    consumer dispatches batch ``i``; with ``prepare=
    estimator.prepare_batch``, batch ``i+1``'s host→device copy is also
    issued from the worker, on the backend's copy stream, so by dispatch
    time it is on its way to the card (or there) and the consumer's
    stream only waits for its event.

    Contract:

    - **Ordering** is the inner source's (one worker, FIFO queue).
    - **Cursor safety**: prefetch advances only *production*.  Commit
      (``StreamCursor``) stays with the consumer's ack-after-yield in
      ``stream_transform``; a batch produced ahead but never consumed is
      recomputed on resume.
    - **Exception propagation**: a worker-thread failure (source read,
      hash, prepare — a CUDA error in the copy among them) is re-raised in
      the consumer, with its traceback, *after* the batches produced
      before it: the serial prefix-then-raise behaviour.
    - **Clean shutdown**: closing the generator (consumer ``break``,
      exception, or GC) stops and joins the worker.  ``depth`` bounds
      host memory at ``depth + 1`` produced batches (queue plus the one
      in the worker's hands).

    ``stats`` (a ``StreamStats``) records the ``'h2d'`` stage wall for
    ``prepare`` and a queue-occupancy gauge sampled by the producer at
    each delivery: max 0 means producer-bound, ``depth`` consumer-bound.
    """

    _DONE = object()  # worker sentinel: inner iterator exhausted
    _POLL_S = 0.05  # put/get poll so shutdown never deadlocks on a full/empty queue

    def __init__(self, inner: RowBatchSource, *, depth: int = 2,
                 prepare: Optional[Callable] = None, stats=None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._inner = inner
        self.depth = depth
        self.prepare = prepare
        self.stats = stats
        self.batch_rows = inner.batch_rows
        self.n_rows = inner.n_rows
        self.n_features = inner.n_features
        self.dtype = inner.dtype

    def iter_batches(self, start_row: int = 0):
        it = self.iter_batches_traced(start_row)
        try:
            for lo, batch, root in it:
                try:
                    yield lo, batch
                finally:
                    # direct (untraced) consumers end the batch trace when
                    # their loop body returns; stream_transform consumes
                    # the traced face instead and ends roots at commit
                    telemetry.end_span(root, row=int(lo))
        finally:
            it.close()

    def iter_batches_traced(self, start_row: int = 0):
        """``iter_traced`` face: ``(lo, batch, trace_root)`` triples.

        The batch's trace root is created ON THE WORKER THREAD when
        production begins (so the inner source's hash span parents
        correctly), carried through the queue, and handed to the
        consumer, which owns ending it.  Worker-side child spans: the
        inner production stages, ``h2d`` for the prepare step, and
        ``enqueue_wait`` for time the producer waited for queue space
        (idle, not work: deliberately not a ``StreamStats`` stage).
        """
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()

        def _put(item) -> bool:
            # bounded put that notices shutdown: never blocks forever on a
            # queue the consumer stopped draining
            while not stop.is_set():
                try:
                    q.put(item, timeout=self._POLL_S)
                    return True
                except queue.Full:
                    pass
            return False

        def work():
            try:
                produced = iter_traced(self._inner, start_row)
                try:
                    for lo, batch, root in produced:
                        if self.prepare is not None:
                            with telemetry.activate_span(root), \
                                    _stage(self.stats, "h2d"):
                                batch = self.prepare(batch)
                        depth_now = q.qsize()
                        if self.stats is not None:
                            self.stats.on_queue_depth(depth_now)
                        telemetry.registry().gauge_set(
                            "stream.queue.depth", depth_now
                        )
                        telemetry.emit(
                            EVENTS.STREAM_PREFETCH_DELIVER, row=int(lo),
                            queue_depth=int(depth_now), capacity=self.depth,
                            **(
                                {"trace_id": root.trace_id}
                                if root is not None else {}
                            ),
                        )
                        with telemetry.span(
                            "enqueue_wait", parent=root, require_parent=True,
                        ):
                            delivered = _put((lo, batch, root))
                        if not delivered:
                            # consumer went away; close the in-flight trace
                            telemetry.end_span(root, row=int(lo),
                                               abandoned=True)
                            return
                finally:
                    produced.close()
                _put(self._DONE)
            except BaseException as e:  # propagate to the consumer thread
                telemetry.emit(EVENTS.STREAM_PREFETCH_ERROR, error=repr(e))
                _put((self._DONE, e))

        worker = threading.Thread(
            target=work, name="rp-torch-prefetch-worker", daemon=True
        )
        worker.start()
        try:
            while True:
                # poll so a worker that died without posting cannot hang
                # the consumer
                try:
                    item = q.get(timeout=self._POLL_S)
                except queue.Empty:
                    if worker.is_alive():
                        continue
                    try:  # the worker may have posted right before exiting
                        item = q.get_nowait()
                    except queue.Empty:
                        raise RuntimeError(
                            "prefetch worker died without a result"
                        ) from None
                if item is self._DONE:
                    return
                if isinstance(item, tuple) and item[0] is self._DONE:
                    raise item[1]
                yield item
        finally:
            stop.set()
            # bounded join: a worker stuck inside the inner source's read
            # or a hung prepare() never reaches the stop-aware _put, and
            # an unbounded join would hang the CONSUMER on abandon
            worker.join(timeout=5.0)
            # batches produced into the queue but never handed to the
            # consumer: close their traces as abandoned (resume recomputes
            # them) so an abandoned stream leaves no orphan spans
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
                if isinstance(item, tuple) and len(item) == 3:
                    telemetry.end_span(item[2], row=int(item[0]),
                                       abandoned=True)
            if worker.is_alive():  # pragma: no cover — needs a hung read
                logger.warning(
                    "prefetch worker did not stop within 5s of shutdown "
                    "(inner source read or prepare() appears hung); "
                    "abandoning the daemon thread"
                )
                telemetry.emit(EVENTS.STREAM_PREFETCH_SHUTDOWN_TIMEOUT)


class StagedIngestSource(RowBatchSource):
    """Staged multi-worker ingest: a POOL of hash workers producing
    disjoint batches, reassembled in row order, feeding a dedicated
    prepare/H2D uploader stage through bounded queues.

    ``PrefetchSource`` moves production off the consumer thread but keeps
    it on ONE worker: reading, hashing, the CSR build and the upload
    serialize there.  This source splits the pipeline into stages:

    - **hash pool** — ``workers`` threads; worker ``w`` owns batch
      indices ``w, w+N, w+2N, …`` and produces each by seeking the inner
      source (``iter_batches(lo)``, first batch only).  Output is
      **bit-identical to serial** because every shipped source is a pure
      function of its row range ``(lo, hi)`` — the determinism the
      cursor-resume contract already requires.
    - **uploader** — one thread reassembling the workers' outputs in
      batch order (worker queues drained round-robin by index, so the
      order is deterministic) and running the optional ``prepare`` step
      (the copy to the card, on the backend's copy stream) before
      delivering into the final bounded queue the consumer drains.

    Contract (same as ``PrefetchSource``, held across every stage
    boundary): row order; the cursor commits only consumed batches; a
    failure producing (or preparing) batch ``i`` reaches the consumer,
    with its traceback, *after* batches ``0..i-1``; closing the
    generator stops and joins every stage thread, and batches queued
    ahead close their traces as ``abandoned``.  Each batch's trace root
    is created on the hash worker that produces it and is ended by the
    consumer at commit.

    The inner source must be seekable, deterministic in ``(lo, hi)``
    and safe for **concurrent** iteration from several threads (all
    shipped sources are; a custom reader must not share unsynchronized
    mutable state).  Host memory is bounded by ``~2·workers + depth + 1``
    produced batches.
    """

    _DONE = object()
    _POLL_S = 0.05  # stop-aware put/get poll (see PrefetchSource)

    def __init__(self, inner: RowBatchSource, *, workers: int = 2,
                 depth: int = 2, prepare: Optional[Callable] = None,
                 stats=None):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._inner = inner
        self.workers = workers
        self.depth = depth
        self.prepare = prepare
        self.stats = stats
        self.batch_rows = inner.batch_rows
        self.n_rows = inner.n_rows
        self.n_features = inner.n_features
        self.dtype = inner.dtype

    def iter_batches(self, start_row: int = 0):
        it = self.iter_batches_traced(start_row)
        try:
            for lo, batch, root in it:
                try:
                    yield lo, batch
                finally:
                    telemetry.end_span(root, row=int(lo))
        finally:
            it.close()

    def _produce_one(self, lo: int):
        """Produce the single batch starting at ``lo`` with its trace
        root opened on THIS (worker) thread, so the inner source's
        instrumented stages (TokenSource's hash) parent correctly."""
        root = telemetry.start_span("batch", new_trace=True)
        try:
            with telemetry.activate_span(root):
                it = self._inner.iter_batches(lo)
                try:
                    try:
                        got_lo, batch = next(it)
                    except StopIteration:
                        raise RuntimeError(
                            f"inner source yielded no batch at row {lo}"
                        ) from None
                finally:
                    close = getattr(it, "close", None)
                    if close is not None:
                        close()
            if got_lo != lo:
                raise RuntimeError(
                    f"inner source yielded row {got_lo}, expected {lo} "
                    "(seekable-source contract violation)"
                )
        except BaseException:
            telemetry.end_span(root, error=True)
            raise
        return batch, root

    def iter_batches_traced(self, start_row: int = 0):
        """``iter_traced`` face: ``(lo, batch, trace_root)`` in row order.
        The caller owns ending each root (``stream_transform`` ends them
        at commit)."""
        _check_start_row(start_row, self.batch_rows, self.n_rows)
        remaining = max(self.n_rows - start_row, 0)
        n_batches = -(-remaining // self.batch_rows) if remaining else 0
        n_workers = max(1, min(self.workers, n_batches or 1))
        # worker queues are tiny (each worker runs at most ~2 batches
        # ahead); the final queue carries the consumer-facing depth
        worker_qs = [queue.Queue(maxsize=1) for _ in range(n_workers)]
        out_q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()

        def _put(q: queue.Queue, item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=self._POLL_S)
                    return True
                except queue.Full:
                    pass
            return False

        def _get(q: queue.Queue, producer: threading.Thread):
            """Stop-aware get that notices a dead producer; None means a
            shutdown was requested."""
            while not stop.is_set():
                try:
                    return q.get(timeout=self._POLL_S)
                except queue.Empty:
                    if producer.is_alive():
                        continue
                    try:  # it may have posted right before exiting
                        return q.get_nowait()
                    except queue.Empty:
                        raise RuntimeError(
                            f"staged {producer.name} died without a result"
                        ) from None
            return None

        def hash_work(w: int):
            try:
                for i in range(w, n_batches, n_workers):
                    lo = start_row + i * self.batch_rows
                    batch, root = self._produce_one(lo)
                    if not _put(worker_qs[w], (i, lo, batch, root)):
                        # consumer went away mid-delivery
                        telemetry.end_span(root, row=int(lo), abandoned=True)
                        return
            except BaseException as e:
                telemetry.emit(
                    EVENTS.STREAM_STAGED_ERROR, stage="hash", worker=w,
                    error=repr(e),
                )
                _put(worker_qs[w], (self._DONE, e))

        hash_threads = [
            threading.Thread(
                target=hash_work, args=(w,),
                name=f"rp-torch-staged-hash-{w}", daemon=True,
            )
            for w in range(n_workers)
        ]

        def upload_work():
            try:
                for i in range(n_batches):
                    item = _get(worker_qs[i % n_workers],
                                hash_threads[i % n_workers])
                    if item is None:  # shutdown requested
                        return
                    if isinstance(item, tuple) and item[0] is self._DONE:
                        # worker failure at this batch index: forward it
                        # AFTER the in-order prefix already delivered
                        _put(out_q, (self._DONE, item[1]))
                        return
                    _i, lo, batch, root = item
                    try:
                        if self.prepare is not None:
                            with telemetry.activate_span(root), \
                                    _stage(self.stats, "h2d"):
                                batch = self.prepare(batch)
                    except BaseException:
                        telemetry.end_span(root, row=int(lo), error=True)
                        raise
                    depth_now = out_q.qsize()
                    if self.stats is not None:
                        self.stats.on_queue_depth(depth_now)
                    telemetry.registry().gauge_set(
                        "stream.queue.depth", depth_now
                    )
                    telemetry.emit(
                        EVENTS.STREAM_STAGED_DELIVER, row=int(lo),
                        queue_depth=int(depth_now), capacity=self.depth,
                        workers=n_workers,
                        **(
                            {"trace_id": root.trace_id}
                            if root is not None else {}
                        ),
                    )
                    with telemetry.span(
                        "enqueue_wait", parent=root, require_parent=True,
                    ):
                        delivered = _put(out_q, (lo, batch, root))
                    if not delivered:
                        telemetry.end_span(root, row=int(lo), abandoned=True)
                        return
                _put(out_q, self._DONE)
            except BaseException as e:
                telemetry.emit(
                    EVENTS.STREAM_STAGED_ERROR, stage="upload", error=repr(e)
                )
                _put(out_q, (self._DONE, e))

        uploader = threading.Thread(
            target=upload_work, name="rp-torch-staged-upload", daemon=True
        )
        for t in hash_threads:
            t.start()
        uploader.start()
        all_threads = (*hash_threads, uploader)
        try:
            while True:
                try:
                    item = out_q.get(timeout=self._POLL_S)
                except queue.Empty:
                    if uploader.is_alive():
                        continue
                    try:
                        item = out_q.get_nowait()
                    except queue.Empty:
                        raise RuntimeError(
                            "staged upload worker died without a result"
                        ) from None
                if item is self._DONE:
                    return
                if isinstance(item, tuple) and item[0] is self._DONE:
                    raise item[1]
                yield item
        finally:
            stop.set()
            for t in all_threads:
                # bounded join, as PrefetchSource's: a worker stuck in a
                # hung read/prepare must not hang the consumer
                t.join(timeout=5.0)
            # close the traces of batches produced but never handed to
            # the consumer — a clean break leaves no orphan spans
            for q in (*worker_qs, out_q):
                while True:
                    try:
                        item = q.get_nowait()
                    except queue.Empty:
                        break
                    if isinstance(item, tuple) and len(item) == 4:
                        telemetry.end_span(
                            item[3], row=int(item[1]), abandoned=True
                        )
                    elif isinstance(item, tuple) and len(item) == 3:
                        telemetry.end_span(
                            item[2], row=int(item[0]), abandoned=True
                        )
            if any(t.is_alive() for t in all_threads):  # pragma: no cover
                logger.warning(
                    "staged ingest worker(s) did not stop within 5s of "
                    "shutdown (inner source read or prepare() appears "
                    "hung); abandoning the daemon thread(s)"
                )
                telemetry.emit(EVENTS.STREAM_STAGED_SHUTDOWN_TIMEOUT)


@dataclasses.dataclass
class StreamCursor:
    """Resumable position in a stream; serializes to a tiny JSON file.

    ``rows_done`` always lands on a batch boundary — a batch is committed
    only after the *consumer* has finished processing it (control returned
    from the yield), so a crash at any point loses at most uncommitted
    work, which the resume recomputes identically.
    """

    rows_done: int = 0

    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"version": 1, "rows_done": self.rows_done}, f)
            # fsync data BEFORE the rename: os.replace alone is atomic
            # against a process crash, but a machine crash could persist
            # the rename while the new file's blocks never hit disk
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)  # atomic: a crash never leaves a torn cursor
        _fsync_dir(os.path.dirname(os.path.abspath(path)))

    @classmethod
    def load(cls, path: str) -> "StreamCursor":
        with open(path) as f:
            d = json.load(f)
        if d.get("version") != 1:
            raise ValueError(f"Unsupported cursor version in {path}: {d!r}")
        return cls(rows_done=int(d["rows_done"]))


class _HostFetch:
    """A batch output on its way to the host.

    A card tensor's copy into pinned host memory is queued right behind
    its kernel on the current stream, with an event after it; ``result``
    waits for that event alone, then copies into pageable memory so the
    pinned block goes back to torch's allocator.  Host outputs (numpy
    arrays, CSR, CPU tensors) pass through.
    """

    __slots__ = ("_y", "_done")

    def __init__(self, y):
        self._done = None
        torch = sys.modules.get("torch")
        if torch is not None and isinstance(y, torch.Tensor) and y.is_cuda:
            host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
            host.copy_(y, non_blocking=True)
            self._done = torch.cuda.Event()
            self._done.record()
            y = host
        self._y = y

    def result(self, out_dtype):
        y = self._y
        if self._done is not None:
            self._done.synchronize()
        torch = sys.modules.get("torch")
        if torch is not None and isinstance(y, torch.Tensor):
            if y.dtype == torch.bfloat16:
                y = y.float()
            y = np.array(y.numpy(), dtype=out_dtype, copy=True)
        elif not sp.issparse(y):
            y = np.asarray(y)
            if out_dtype is not None:
                y = y.astype(out_dtype, copy=False)
        return y


def stream_transform(
    estimator,
    source: RowBatchSource,
    *,
    cursor: Optional[StreamCursor] = None,
    checkpoint_path: Optional[str] = None,
    pipeline_depth: int = 2,
    stats=None,
) -> Iterator[Tuple[int, np.ndarray]]:
    """Project a stream, yielding ``(start_row, Y_batch)`` in row order.

    ``estimator`` is a fitted projection estimator (any backend).  Pass a
    ``cursor`` (or a ``checkpoint_path`` holding one) to resume; batch i's
    cursor is advanced (and saved to ``checkpoint_path`` when given) only
    once the consumer asks for batch i+1 — acknowledging that batch i's
    yielded output was handled — so a crash inside the consumer never
    drops a row range on resume.

    ``pipeline_depth`` > 1 keeps that many batches in flight on the torch
    backend; the numpy backend is synchronous and unaffected.  Output
    batches are host ndarrays in the spec's dtype.  ``stats`` (a
    ``StreamStats``) times the ``dispatch`` and ``d2h`` stages and counts
    every commit (the ``stream.commit`` event).
    """
    if pipeline_depth < 1:
        raise ValueError(f"pipeline_depth must be >= 1, got {pipeline_depth}")
    if cursor is None:
        if checkpoint_path is not None and os.path.exists(checkpoint_path):
            cursor = StreamCursor.load(checkpoint_path)
        else:
            cursor = StreamCursor()

    estimator._check_is_fitted()
    out_dtype = estimator._stream_out_dtype()

    if stats is not None:
        stats.start()

    pending: list = []  # [(start_row, n_rows, _HostFetch, in_nbytes, root)]

    def emit(entry):
        # Yield the batch FIRST; advance/save the cursor (and count the
        # commit) only after control returns from the yield — i.e. after
        # the consumer's loop body has completed for this batch.
        # Committing before the yield would let a crash inside the
        # consumer silently drop the batch's row range on resume.
        start_row, n_rows, fetch, in_nbytes, root = entry
        # re-activate the batch's trace root (created on whichever thread
        # produced the batch) so the d2h span joins its trace
        with telemetry.activate_span(root), \
                annotate("rp:stream/fetch_d2h"), _stage(stats, "d2h"):
            y = fetch.result(out_dtype)
        committed = False
        try:
            yield start_row, y
            cursor.rows_done = start_row + n_rows
            if checkpoint_path is not None:
                cursor.save(checkpoint_path)
            with telemetry.activate_span(root):
                # commit inside the trace so stream.commit correlates
                if stats is not None:
                    stats.on_commit(start_row, in_nbytes, y)
            # the batch's trace ends at commit: production → dispatch →
            # d2h → consumer ack, one root span per batch
            telemetry.end_span(root, row=int(start_row), rows=int(n_rows))
            committed = True
        finally:
            if not committed:
                # consumer broke/crashed mid-yield (or the commit write
                # failed): close the trace as abandoned.  The CURSOR stays
                # put by design: resume recomputes this batch.
                telemetry.end_span(root, row=int(start_row), abandoned=True)

    batches = iter_traced(source, cursor.rows_done)
    try:
        for start_row, batch, root in batches:
            # the batch's trace root is re-activated so the dispatch span
            # (and the backend's own dispatch event) join its trace
            with telemetry.activate_span(root), \
                    annotate("rp:stream/dispatch"), _stage(stats, "dispatch"):
                y = estimator._transform_async(batch)
                # the row count feeds the CURSOR as well as telemetry, so
                # undeterminable rows must fail loudly: a defaulted 0
                # would freeze rows_done
                n_rows = _batch_rows(batch)
                if n_rows is None:
                    n_rows = _batch_rows(y)
                if n_rows is None:
                    raise TypeError(
                        f"cannot determine the row count of batch "
                        f"{type(batch).__name__!r} (no usable .shape or "
                        f".n) or its transform output "
                        f"{type(y).__name__!r}; prepared batch carriers "
                        "must expose one or the other"
                    )
                telemetry.emit(
                    EVENTS.STREAM_DISPATCH, row=int(start_row),
                    rows=int(n_rows), **telemetry.trace_fields(),
                )
                # the d2h starts right behind the kernel, so it overlaps
                # the next batch's work; keep only the input's byte count
                # (retaining the batch would pin pipeline_depth extra
                # input batches of host memory)
                pending.append((start_row, n_rows, _HostFetch(y),
                                batch_nbytes(batch), root))
            if len(pending) >= pipeline_depth:
                yield from emit(pending.pop(0))
        while pending:
            yield from emit(pending.pop(0))
    finally:
        # abandoned mid-flight (break or exception): close the traces of
        # batches that were dispatched but never reached the consumer —
        # their work is recomputed on resume
        for entry in pending:
            telemetry.end_span(entry[4], row=int(entry[0]), abandoned=True)
        # deterministic producer shutdown: an ingest source's worker
        # threads are stopped and joined even when the consumer abandons
        # the stream mid-flight (break or exception)
        close = getattr(batches, "close", None)
        if close is not None:
            close()


def stream_to_memmap(
    estimator,
    source: RowBatchSource,
    out_path: str,
    *,
    checkpoint_path: str,
    stats=None,
    pipeline_depth: int = 2,
) -> np.ndarray:
    """Stream into a durable on-disk ``.npy`` memmap, resumable mid-run.

    The durability contract: each batch is written to ``out_path`` and
    **flushed before** the stream cursor commits it (the cursor advances
    only when the next batch is requested — see ``stream_transform``), so a
    crash at any point — transform, write, or cursor save — resumes from
    the checkpoint without losing or duplicating rows.

    A fresh run creates the memmap from the first batch's dtype/width; a
    resume (``checkpoint_path`` has ``0 < rows_done < n_rows``) requires
    the memmap from the original run at ``out_path`` and the caller is
    responsible for verifying the estimator parameters match that run (see
    ``cli.cmd_project`` for a fingerprint sidecar).  Re-running a
    completed checkpoint is a no-op returning the existing memmap.
    Sparse output batches are densified into the memmap.
    """
    if not out_path.endswith(".npy"):
        raise ValueError(f"out_path must end in .npy, got {out_path!r}")
    rows_done = 0
    if os.path.exists(checkpoint_path):
        rows_done = StreamCursor.load(checkpoint_path).rows_done
    out = None
    if rows_done > 0:
        if not os.path.exists(out_path):
            raise ValueError(
                f"checkpoint {checkpoint_path} records progress "
                f"(rows_done={rows_done}) but {out_path} does not exist; "
                f"delete the checkpoint to restart"
            )
        out = np.lib.format.open_memmap(out_path, mode="r+")
        if out.shape[0] != source.n_rows:
            raise ValueError(
                f"{out_path} has {out.shape[0]} rows but the source has "
                f"{source.n_rows}; it belongs to a different run"
            )
        # a same-rows file written by a DIFFERENT estimator would silently
        # mix two projections; width/dtype are the library-level fingerprint
        want_width = estimator._stream_out_width()
        want_dtype = estimator._stream_out_dtype()
        if want_dtype is not None:
            # .npy headers cannot express ml_dtypes names: a bf16 stream
            # reloads as raw void ('|V2'); restore the typed view
            from randomprojection_tpu_torch.utils.validation import (
                restore_void_dtype,
            )

            out = restore_void_dtype(out, want_dtype)
        if out.ndim != 2 or out.shape[1] != want_width or (
            want_dtype is not None and out.dtype != np.dtype(want_dtype)
        ):
            raise ValueError(
                f"{out_path} has shape {out.shape} dtype {out.dtype} but this "
                f"estimator streams ({source.n_rows}, {want_width}) "
                f"{want_dtype if want_dtype is not None else out.dtype}; "
                f"resuming would mix two projections — delete the checkpoint "
                f"and output to restart"
            )
    for lo, y in stream_transform(
        estimator, source, checkpoint_path=checkpoint_path,
        stats=stats, pipeline_depth=pipeline_depth,
    ):
        if sp.issparse(y):
            y = y.toarray()
        if out is None:
            out = np.lib.format.open_memmap(
                out_path, mode="w+", dtype=y.dtype,
                shape=(source.n_rows, y.shape[1]),
            )
        out[lo : lo + y.shape[0]] = y
        out.flush()  # durable before the cursor commits this batch
    if out is None:  # 0-row source: nothing streamed, emit the empty file
        out = np.lib.format.open_memmap(
            out_path, mode="w+",
            dtype=estimator._stream_out_dtype() or np.float64,
            shape=(source.n_rows, estimator._stream_out_width()),
        )
    return out


def stream_to_array(estimator, source, out=None, **kwargs) -> np.ndarray:
    """Convenience: run ``stream_transform`` into one preallocated array.

    ``out`` defaults to a new ndarray of the stream's full output shape —
    only sensible when that fits in host memory.  Resuming a
    partially-complete checkpoint REQUIRES passing the ``out`` buffer from
    the earlier run (a fresh buffer would leave the already-committed rows
    uninitialized); a fully-complete checkpoint returns ``out`` unchanged
    (or an empty array when no buffer is given).
    """
    cursor = kwargs.get("cursor")
    checkpoint_path = kwargs.get("checkpoint_path")
    if cursor is None and checkpoint_path is not None and os.path.exists(
        checkpoint_path
    ):
        cursor = StreamCursor.load(checkpoint_path)
    resume_start = cursor.rows_done if cursor is not None else 0
    if out is None and 0 < resume_start < source.n_rows:
        raise ValueError(
            f"Resuming from rows_done={resume_start} without the output "
            "buffer of the interrupted run would leave earlier rows "
            "uninitialized; pass out= (or clear the checkpoint to restart)"
        )

    chunks = []
    for start_row, y in stream_transform(estimator, source, **kwargs):
        if out is None and not chunks and not sp.issparse(y):
            out = np.empty((source.n_rows, y.shape[1]), dtype=y.dtype)
        if out is not None:
            out[start_row : start_row + y.shape[0]] = (
                y.toarray() if sp.issparse(y) else y
            )
        else:
            chunks.append(y)
    if out is not None:
        return out
    if chunks:
        return (
            sp.vstack(chunks) if sp.issparse(chunks[0]) else np.concatenate(chunks)
        )
    width = estimator._stream_out_width()
    dtype = estimator._stream_out_dtype() or np.float64
    return np.empty((0, width), dtype=dtype)
