"""Streamed row-batch transform (layer L2) with checkpoint/resume.

The counterpart of the core of ``randomprojection_tpu/streaming.py``:
seekable sources (the raw-token ``TokenSource`` of config 5 among them),
the fault-injection wrapper, the stream cursor, and ``stream_transform``'s
ack-after-yield commit (prefetch/staged ingest and the telemetry spans
are later slices).

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
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import scipy.sparse as sp

__all__ = [
    "RowBatchSource",
    "ArraySource",
    "CallableSource",
    "TokenSource",
    "FaultInjectionSource",
    "StreamCursor",
    "stream_transform",
    "stream_to_array",
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
    in ``(lo, hi)`` for resume to be exact.
    """

    def __init__(self, read: Callable[[int, int], np.ndarray], n_rows: int,
                 n_features: int, dtype=np.float32, batch_rows: int = 65536):
        if batch_rows <= 0:
            raise ValueError(f"batch_rows must be positive, got {batch_rows}")
        self._read = read
        self.batch_rows = batch_rows
        self.n_rows = n_rows
        self.n_features = n_features
        self.dtype = np.dtype(dtype)

    def iter_batches(self, start_row: int = 0):
        _check_start_row(start_row, self.batch_rows, self.n_rows)
        for lo in range(start_row, self.n_rows, self.batch_rows):
            hi = min(lo + self.batch_rows, self.n_rows)
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
    ambient default).
    """

    def __init__(self, read_tokens: Callable, n_rows: int, hasher,
                 batch_rows: int = 65536, *,
                 hash_threads: Optional[int] = None):
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

    def iter_batches(self, start_row: int = 0):
        from randomprojection_tpu_torch.ops.hashing import hash_threads_override

        _check_start_row(start_row, self.batch_rows, self.n_rows)
        for lo in range(start_row, self.n_rows, self.batch_rows):
            hi = min(lo + self.batch_rows, self.n_rows)
            out = self._read_tokens(lo, hi)
            tokens, indptr = out[0], out[1]
            values = out[2] if len(out) > 2 else None
            with hash_threads_override(self.hash_threads):
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
    batches are host ndarrays in the spec's dtype.
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
    pending: list = []  # [(start_row, n_rows, _HostFetch)]

    def emit(entry):
        # Yield the batch FIRST; advance/save the cursor only after control
        # returns from the yield — i.e. after the consumer's loop body has
        # completed for this batch.  Committing before the yield would let
        # a crash inside the consumer silently drop the batch's row range
        # on resume.
        start_row, n_rows, fetch = entry
        yield start_row, fetch.result(out_dtype)
        cursor.rows_done = start_row + n_rows
        if checkpoint_path is not None:
            cursor.save(checkpoint_path)

    batches = source.iter_batches(cursor.rows_done)
    try:
        for start_row, batch in batches:
            y = estimator._transform_async(batch)
            pending.append((start_row, int(batch.shape[0]), _HostFetch(y)))
            if len(pending) >= pipeline_depth:
                yield from emit(pending.pop(0))
        while pending:
            yield from emit(pending.pop(0))
    finally:
        # deterministic producer shutdown even when the consumer abandons
        # the stream mid-flight (break or exception)
        close = getattr(batches, "close", None)
        if close is not None:
            close()


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
