"""Tiered hot/cold chunk residency for the serving indexes.

The port of ``randomprojection_tpu/tiering.py``.  Without it a
``SimHashIndex`` holds every chunk on the card, so a corpus is bounded by
the card's memory.  With a budget (``SimHashIndex(...,
hbm_budget_bytes=...)``) chunks past it leave the card without leaving the
index:

- **hot**: a chunk resident on the index's device, exactly the untiered
  path.
- **cold (host)**: the chunk's packed codes in host memory, in a PINNED
  tensor on a card (filled once, at ``place_cold`` or ``_demote``), so its
  upload is a ``non_blocking`` copy that overlaps the kernels.
- **cold (disk)**: the host copy demoted once more into the durable
  snapshot's spill format (``chunk-GGGGGG-SSSSSSSS.npy``, checksummed,
  generation-numbered, written write-tmp → fsync → replace) and served
  through a read-only ``np.load(mmap_mode='r')`` view.  A memmap cannot be
  pinned, so its rows go up through pinned bounce buffers, at most two in
  flight (``ops.topk_kernels.stage_rows``).

Residency never changes answers: every path re-ranks with the same top-k
kernel under the same (distance, lower-global-id) order, and the hot/cold
split merges through the union-of-top-m identity.  A failed staging
upload degrades to a synchronous fetch on the current stream
(``index.tier.fallback``), never to a wrong answer or to the CPU.

Admission and eviction: chunks are admitted hot at append until the
budget is full; after that the access counts folded from the serving
gathers drive a greedy re-plan (``plan_residency``), and promotions and
demotions run as bounded background work: one worker thread
(``rp-torch-tier-worker``) behind a bounded queue with a sentinel and a
joined ``close()``.  A rebalance that finds the queue full is dropped; the
next access re-plans.

Streams and threads.  The manager's state (residency table, scores, spill
map) is lock-protected, and ``chunk.b`` swaps under that lock, but
serving threads read ``chunk.b`` without it: a single attribute load.
Torch does not upload a host tensor implicitly, so every serving path
checks the binding it read and stages a host one itself (a synchronous
upload, counted on the fallback audit).  The worker finishes a
promotion's upload (an event it waits on) before it swaps the device
tensor in, and a demotion's copy to the host before it swaps the host
copy in.  A demoted device tensor that a dispatched kernel still reads is
freed into the caching allocator's pool of the stream it was made on,
the stream that kernel runs on, so its memory is reused only behind that
kernel.  ``on_change`` (the LSH tier's hook) runs after every swap and
``reset``: the captured CUDA graphs bake chunk pointers in.  Telemetry is
emitted outside the lock.

Telemetry (the reference's names): events ``index.tier.hit``,
``index.tier.fetch``, ``index.tier.evict``, ``index.tier.fallback``;
counters ``index.tier.{hot_rows,cold_rows,fetches,fallbacks,promotions,
evictions,rebalance_drops,close_timeouts}``; gauge
``index.tier.hot_fraction``; histograms ``index.tier.fetch_s`` and
``index.tier.overlap_s``.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Callable, Optional

import numpy as np

from randomprojection_tpu_torch.utils import telemetry
from randomprojection_tpu_torch.utils.telemetry import EVENTS

__all__ = ["COLD_TIERS", "ResidencyPlan", "plan_residency",
           "TieredResidency", "WORKER_NAME"]

COLD_TIERS = ("host", "disk")

#: the background worker's thread name (the reference's is
#: ``rp-tier-worker``; a distinct prefix keeps the two apart in one process)
WORKER_NAME = "rp-torch-tier-worker"

# bounded background work: at most this many promote/demote ops pending;
# the queue is sized one larger so close()'s sentinel always has a slot
_MAX_PENDING_OPS = 2


class ResidencyPlan:
    """Which chunks the budget keeps hot: ``hot`` is the set of chunk
    ordinals, ``hot_bytes`` their payload total, ``staging_bytes`` the
    transient headroom the serving paths may occupy on top for the two
    staged cold chunks in flight (reported, not charged against
    admission)."""

    __slots__ = ("hot", "hot_bytes", "budget_bytes", "staging_bytes")

    def __init__(self, hot, hot_bytes: int, budget_bytes: int,
                 staging_bytes: int):
        self.hot = frozenset(hot)
        self.hot_bytes = int(hot_bytes)
        self.budget_bytes = int(budget_bytes)
        self.staging_bytes = int(staging_bytes)


def plan_residency(chunk_bytes, budget_bytes: int,
                   scores=None) -> ResidencyPlan:
    """Greedily admit chunks hot in descending access-score order (ties to
    the LOWER ordinal) until the next chunk would overflow
    ``budget_bytes``.  ``scores=None`` plans by ordinal alone (append
    order).  ``staging_bytes`` is twice the largest cold chunk."""
    sizes = [int(b) for b in chunk_bytes]
    if budget_bytes < 0:
        raise ValueError(f"budget_bytes must be >= 0, got {budget_bytes}")
    n = len(sizes)
    sc = [0.0] * n if scores is None else [float(s) for s in scores]
    if len(sc) != n:
        raise ValueError(f"scores has {len(sc)} entries for {n} chunks")
    hot = set()
    hot_bytes = 0
    for i in sorted(range(n), key=lambda i: (-sc[i], i)):
        if hot_bytes + sizes[i] <= budget_bytes:
            hot.add(i)
            hot_bytes += sizes[i]
    cold_max = max((sizes[i] for i in range(n) if i not in hot), default=0)
    return ResidencyPlan(hot, hot_bytes, budget_bytes, 2 * cold_max)


def is_resident(b, device) -> bool:
    """True when the binding ``b`` is a tensor on ``device`` (a hot chunk,
    or, on a CPU index, a host-tier one)."""
    import torch

    return isinstance(b, torch.Tensor) and b.device.type == device.type


def host_view(b) -> np.ndarray:
    """A cold binding (a CPU tensor or a memmap) as a host array, no copy."""
    import torch

    if isinstance(b, torch.Tensor):
        return b.numpy()
    return b


def pinned_copy(codes: np.ndarray, device):
    """``codes`` in a fresh host tensor: page-locked when ``device`` is a
    card, so its uploads are ``non_blocking`` copies."""
    import torch

    out = torch.empty(codes.shape, dtype=torch.uint8,
                      pin_memory=device.type == "cuda")
    out.numpy()[...] = codes
    return out


class _Entry:
    """Per-chunk residency record: the chunk, its payload bytes, whether it
    is device-resident, its access score, and (disk tier) its spill
    manifest entry."""

    __slots__ = ("chunk", "nbytes", "hot", "score", "spill")

    def __init__(self, chunk, nbytes: int, hot: bool):
        self.chunk = chunk
        self.nbytes = int(nbytes)
        self.hot = bool(hot)
        self.score = 0.0
        self.spill: Optional[dict] = None


class TieredResidency:
    """Hot/cold residency manager of one index's chunk list (see the module
    docstring).  ``SimHashIndex`` creates it when ``hbm_budget_bytes`` is
    set, funnels every append through ``admit``/``place_cold``/``register``
    and every serving gather through ``note_gather``/``note_fetch``, and
    calls ``close()`` (which joins the worker) from its own ``close()``."""

    _SENTINEL = object()

    def __init__(self, budget_bytes: int, *, cold_tier: str = "host",
                 cold_dir: Optional[str] = None, device=None):
        import torch

        if budget_bytes < 0:
            raise ValueError(f"hbm_budget_bytes must be >= 0, got {budget_bytes}")
        if cold_tier not in COLD_TIERS:
            raise ValueError(
                f"cold_tier must be one of {COLD_TIERS}, got {cold_tier!r}"
            )
        if cold_tier == "disk":
            if not cold_dir:
                raise ValueError(
                    "cold_tier='disk' requires cold_dir= (the spill "
                    "directory for demoted chunks)"
                )
            os.makedirs(cold_dir, exist_ok=True)
        self.budget_bytes = int(budget_bytes)
        self.cold_tier = cold_tier
        self.cold_dir = cold_dir
        self.device = torch.device("cpu") if device is None else torch.device(device)
        #: called (outside the lock) after every residency swap and reset
        self.on_change: Optional[Callable[[], None]] = None
        self._lock = threading.Lock()
        self._entries: list = []       # _Entry per chunk, append order
        self._by_row0: dict = {}       # chunk.row0 -> _Entry
        self._hot_bytes = 0
        self._gen = 1                  # spill generation (bumped on reset)
        self._spill_seq = 0
        self._pending_spill: Optional[dict] = None
        self._q: queue.Queue = queue.Queue(maxsize=_MAX_PENDING_OPS + 1)
        self._closed = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- append-time admission ------------------------------------------------

    def admit(self, nbytes: int) -> bool:
        """True when a new chunk of ``nbytes`` fits the budget beside the hot
        set (it then uploads as an untiered chunk); False routes it cold."""
        with self._lock:
            return self._hot_bytes + int(nbytes) <= self.budget_bytes

    def place_cold(self, codes: np.ndarray):
        """A cold chunk's binding: the host tier's pinned copy, or the disk
        tier's spill as a read-only memmap (``register`` records the spill
        entry)."""
        codes = np.ascontiguousarray(codes, dtype=np.uint8)
        if self.cold_tier == "host":
            return pinned_copy(codes, self.device)
        arr, self._pending_spill = self._spill_to_disk(codes)
        return arr

    def register(self, chunk, nbytes: int, hot: bool) -> None:
        """Record a freshly appended chunk's residency."""
        e = _Entry(chunk, nbytes, hot)
        if not hot and self.cold_tier == "disk":
            e.spill, self._pending_spill = self._pending_spill, None
        with self._lock:
            self._entries.append(e)
            self._by_row0[chunk.row0] = e
            if hot:
                self._hot_bytes += e.nbytes
            frac = self._hot_fraction_locked()
        telemetry.registry().gauge_set("index.tier.hot_fraction", frac)

    # -- residency queries (serving path, lock held briefly) --------------------

    def chunk_is_hot(self, chunk) -> bool:
        with self._lock:
            e = self._by_row0.get(chunk.row0)
            return e is None or e.hot

    def any_cold(self) -> bool:
        with self._lock:
            return any(not e.hot for e in self._entries)

    def residency(self) -> dict:
        """Per-chunk tier tags plus byte accounting (the manifest block and
        the smoke checks read this)."""
        with self._lock:
            chunks = [
                {"row0": int(e.chunk.row0), "rows": int(e.chunk.n),
                 "tier": "hot" if e.hot else self.cold_tier}
                for e in self._entries
            ]
            hot_bytes = self._hot_bytes
        return {
            "cold_tier": self.cold_tier,
            "hbm_budget_bytes": self.budget_bytes,
            "hot_bytes": hot_bytes,
            "chunks": chunks,
        }

    def manifest_block(self) -> dict:
        """The ``tier`` block ``durable.save_index`` writes: format 1, the
        budget, the cold tier and each chunk's residency at snapshot time (a
        restore re-tiers under its own budget)."""
        r = self.residency()
        return {"tier": {
            "format": 1,
            "cold_tier": r["cold_tier"],
            "hbm_budget_bytes": r["hbm_budget_bytes"],
            "chunks": r["chunks"],
        }}

    def _hot_fraction_locked(self) -> float:
        total = sum(e.nbytes for e in self._entries)
        return (self._hot_bytes / total) if total else 1.0

    # -- access accounting and background rebalance -------------------------------

    def note_gather(self, hot_rows: int, cold_rows: int,
                    per_chunk_rows: dict) -> None:
        """Fold one serving gather into the access statistics (rows per side,
        rows per touched chunk keyed by ``chunk.row0``), then re-plan."""
        with self._lock:
            for row0, rows in per_chunk_rows.items():
                e = self._by_row0.get(row0)
                if e is not None:
                    e.score += float(rows)
        reg = telemetry.registry()
        reg.counter_inc("index.tier.hot_rows", int(hot_rows))
        reg.counter_inc("index.tier.cold_rows", int(cold_rows))
        if telemetry.enabled():
            telemetry.emit(EVENTS.INDEX_TIER_HIT, hot_rows=int(hot_rows),
                           cold_rows=int(cold_rows),
                           **telemetry.trace_fields())
        self._maybe_rebalance()

    def note_fetch(self, *, rows: int, nbytes: int, wall_s: float,
                   overlap_s: float, source: str, sync: bool,
                   promote: bool = False) -> None:
        """Record one cold-tier fetch: the host-side gather and stage wall,
        and the window the upload had to hide under (0 when synchronous)."""
        reg = telemetry.registry()
        reg.counter_inc("index.tier.fetches")
        reg.observe("index.tier.fetch_s", float(wall_s))
        if overlap_s > 0:
            reg.observe("index.tier.overlap_s", float(overlap_s))
        if telemetry.enabled():
            telemetry.emit(
                EVENTS.INDEX_TIER_FETCH, rows=int(rows), bytes=int(nbytes),
                wall_s=round(float(wall_s), 6),
                overlap_s=round(float(overlap_s), 6), source=source,
                sync=bool(sync), promote=bool(promote),
                **telemetry.trace_fields(),
            )

    def note_fallback(self, reason: str, *, rows: int = 0) -> None:
        """The degraded rung: a failed staging upload, or a binding that
        turned cold under a dispatch, served by a synchronous upload."""
        telemetry.registry().counter_inc("index.tier.fallbacks")
        telemetry.emit(EVENTS.INDEX_TIER_FALLBACK, reason=reason,
                       rows=int(rows),
                       **telemetry.trace_fields())

    def demote(self, row0: int) -> bool:
        """Synchronously demote the chunk whose first global id is ``row0``
        (the maintenance and fault-harness surface; serving demotes in the
        background).  True when the chunk was hot and is now cold."""
        with self._lock:
            e = self._by_row0.get(row0)
        if e is None or not e.hot:
            return False
        self._demote(e)
        return not e.hot

    def _changed(self) -> None:
        hook = self.on_change
        if hook is not None:
            hook()

    def _maybe_rebalance(self) -> None:
        """Re-plan from the current scores and enqueue the difference as
        bounded background work; a full queue drops the rebalance."""
        with self._lock:
            if self._closed.is_set():
                return
            sizes = [e.nbytes for e in self._entries]
            # current residency wins exact ties: no churn between equals
            scores = [e.score + (0.5 if e.hot else 0.0) for e in self._entries]
            plan = plan_residency(sizes, self.budget_bytes, scores)
            ops = [
                ("promote" if i in plan.hot else "demote", e)
                for i, e in enumerate(self._entries)
                if (i in plan.hot) != e.hot
            ]
            if not ops:
                return
            start_worker = self._thread is None
            if start_worker:
                self._thread = threading.Thread(
                    target=self._run, name=WORKER_NAME, daemon=True
                )
        # enqueue outside the lock; the qsize bound keeps the sentinel's
        # slot free and the backlog at _MAX_PENDING_OPS
        for op in ops:
            if self._q.qsize() >= _MAX_PENDING_OPS:
                telemetry.registry().counter_inc("index.tier.rebalance_drops")
                break
            self._q.put_nowait(op)
        if start_worker:
            self._thread.start()

    # -- the background worker ---------------------------------------------------

    def _run(self) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.set_device(self.device)
        while True:
            item = self._q.get()
            if item is self._SENTINEL:
                return
            op, entry = item
            try:
                if op == "promote":
                    self._promote(entry)
                else:
                    self._demote(entry)
            except Exception as e:
                # a failed byte movement leaves the chunk where it was
                # (every serving path takes either residency)
                self.note_fallback(f"{op}_failed:{type(e).__name__}")

    def _upload(self, b):
        """A cold binding on the device, the upload complete."""
        import torch

        if self.device.type == "cpu":
            return torch.from_numpy(np.array(host_view(b), copy=True))
        if isinstance(b, torch.Tensor) and b.is_pinned():
            dev = b.to(self.device, non_blocking=True)
        else:
            dev = pinned_copy(np.asarray(b), self.device).to(
                self.device, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
        return dev

    def _promote(self, entry: _Entry) -> None:
        chunk = entry.chunk
        with self._lock:
            if entry.hot or self._closed.is_set():
                return
            if self._hot_bytes + entry.nbytes > self.budget_bytes:
                return  # the plan went stale; the next access re-plans
            b = chunk.b
        t0 = time.perf_counter()
        dev = self._upload(b)
        with self._lock:
            if entry.hot:
                return
            chunk.b = dev
            entry.hot = True
            self._hot_bytes += entry.nbytes
            spill, entry.spill = entry.spill, None
            frac = self._hot_fraction_locked()
        self._changed()
        if spill is not None and self.cold_dir:
            try:
                os.unlink(os.path.join(self.cold_dir, spill["file"]))
            except OSError:
                pass  # a leftover spill is debris, not corruption
        reg = telemetry.registry()
        reg.counter_inc("index.tier.promotions")
        reg.gauge_set("index.tier.hot_fraction", frac)
        self.note_fetch(rows=int(chunk.n), nbytes=entry.nbytes,
                        wall_s=time.perf_counter() - t0, overlap_s=0.0,
                        source=self.cold_tier, sync=False, promote=True)

    def _host_copy(self, b) -> np.ndarray:
        """A hot binding's rows on the host: through pinned memory and an
        event on a card (the worker waits for that copy alone)."""
        import torch

        if b.device.type == "cpu":
            return b.numpy().copy()
        host = torch.empty(tuple(b.shape), dtype=b.dtype, pin_memory=True)
        host.copy_(b, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
        return host.numpy()

    def _demote(self, entry: _Entry) -> None:
        from randomprojection_tpu_torch import durable

        chunk = entry.chunk
        with self._lock:
            if not entry.hot or self._closed.is_set():
                return
            b = chunk.b
        t0 = time.perf_counter()
        host = self._host_copy(b)[: chunk.n]
        if self.cold_tier == "disk":
            arr, spill = self._spill_to_disk(host)
            # fault-injection point: the spill file exists but the swap
            # (and any manifest that would name the demotion) has not
            # happened; a SIGKILL here must leave a loadable snapshot
            durable._maybe_kill("mid-demotion")
        else:
            arr, spill = pinned_copy(host, self.device), None
        with self._lock:
            if not entry.hot:
                return
            chunk.b = arr
            entry.hot = False
            entry.spill = spill
            self._hot_bytes -= entry.nbytes
            frac = self._hot_fraction_locked()
        self._changed()
        reg = telemetry.registry()
        reg.counter_inc("index.tier.evictions")
        reg.gauge_set("index.tier.hot_fraction", frac)
        telemetry.emit(EVENTS.INDEX_TIER_EVICT, rows=int(chunk.n),
                       bytes=entry.nbytes, tier=self.cold_tier,
                       wall_s=round(time.perf_counter() - t0, 6),
                       **telemetry.trace_fields())

    def _spill_to_disk(self, codes: np.ndarray):
        """Write one cold chunk in the spill format (atomic, checksummed,
        generation-numbered) and return ``(memmap_view, manifest_entry)``;
        the file is read back and re-hashed before it replaces anything."""
        from randomprojection_tpu_torch import durable

        with self._lock:
            gen, seq = self._gen, self._spill_seq
            self._spill_seq += 1
        fname = f"chunk-{gen:06d}-{seq:08d}.npy"
        path = os.path.join(self.cold_dir, fname)
        sha = durable._sha256(codes)
        durable._write_npy_atomic(path, codes)
        arr = np.load(path, mmap_mode="r")
        if durable._sha256(np.asarray(arr)) != sha:
            raise ValueError(
                f"cold-tier spill {path} failed read-back verification"
            )
        return arr, {"file": fname, "rows": int(codes.shape[0]), "sha256": sha}

    # -- lifecycle ------------------------------------------------------------------

    def close(self, timeout: float = 10.0) -> None:
        """Stop the worker (idempotent): mark closed, send the sentinel,
        join.  An operation in flight finishes; queued ones see the closed
        flag and do nothing."""
        if self._closed.is_set():
            return
        self._closed.set()
        # the sentinel's slot is reserved (producers stop at
        # _MAX_PENDING_OPS), and none enqueues once the flag is set
        self._q.put(self._SENTINEL)
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():  # pragma: no cover — wedged copy
                telemetry.registry().counter_inc("index.tier.close_timeouts")

    def reset(self) -> None:
        """Forget every chunk (the compaction path; the caller guarantees
        quiescence) and unlink this manager's spill files; the rebuild
        registers its chunks under a fresh spill generation."""
        with self._lock:
            spills = [e.spill for e in self._entries if e.spill]
            self._entries = []
            self._by_row0 = {}
            self._hot_bytes = 0
            self._gen += 1
            self._spill_seq = 0
        self._changed()
        for spill in spills:
            try:
                os.unlink(os.path.join(self.cold_dir, spill["file"]))
            except OSError:
                pass  # debris, swept by the durable orphan scan


class _TileStager:
    """Double-buffered cold-chunk staging for the exact serving path
    (``SimHashIndex._topk_dispatch_tile``): ``resolve(i)`` returns the
    device tensor to score chunk ``i`` with (None: the chunk is hot, use
    its resident binding), with the consuming stream already waiting on its
    upload, and starts the NEXT cold chunk's upload on the side stream
    before it returns, so that copy runs under chunk ``i``'s kernel.  At
    most two staged chunks exist at once (``ResidencyPlan.staging_bytes``).
    A failed upload degrades to a synchronous one on the current stream,
    on the fallback audit.  One stager serves one tile on one thread."""

    def __init__(self, chunks, tier: TieredResidency, sync_upload):
        self._chunks = chunks
        self._tier = tier
        self._sync_upload = sync_upload
        self._cold = [i for i, c in enumerate(chunks)
                      if not tier.chunk_is_hot(c)]
        self._staged: dict = {}  # ordinal -> (tensor, event, wall_s, t_started)
        self._hot_rows = 0
        self._cold_rows = 0
        self._per_chunk: dict = {}

    def _stage(self, i: int) -> None:
        from randomprojection_tpu_torch.ops import topk_kernels

        if i in self._staged or len(self._staged) >= 2:
            return
        c = self._chunks[i]
        b = c.b  # one read: the worker may swap it
        t0 = time.perf_counter()
        if is_resident(b, self._tier.device) and self._tier.device.type == "cuda":
            # promoted since the tile began: already on the card
            dev, ev = b, None
        else:
            try:
                dev, ev = topk_kernels.stage_rows(b, device=self._tier.device)
            except Exception as e:
                self._tier.note_fallback(f"upload:{type(e).__name__}",
                                         rows=int(c.n))
                dev, ev = self._sync_upload(b), None
        self._staged[i] = (dev, ev, time.perf_counter() - t0,
                           time.perf_counter())

    def resolve(self, i: int):
        from randomprojection_tpu_torch.ops import topk_kernels

        c = self._chunks[i]
        if i not in self._cold:
            self._hot_rows += int(c.n)
            b = None
        else:
            ent = self._staged.pop(i, None)
            prestaged = ent is not None
            if not prestaged:
                self._stage(i)
                ent = self._staged.pop(i)
            b, ev, wall_s, t_started = ent
            topk_kernels.wait_staged(b, ev)
            overlap = (time.perf_counter() - t_started) if prestaged else 0.0
            self._cold_rows += int(c.n)
            self._tier.note_fetch(
                rows=int(c.n), nbytes=int(c.n) * int(b.shape[1]),
                wall_s=wall_s, overlap_s=overlap,
                source=self._tier.cold_tier, sync=not prestaged,
            )
        self._per_chunk[c.row0] = self._per_chunk.get(c.row0, 0) + int(c.n)
        # start the next cold chunk's upload before this chunk's kernel is
        # launched: that copy runs under the kernel
        for j in self._cold:
            if j > i and j not in self._staged:
                self._stage(j)
                break
        return b

    def finish(self) -> None:
        """Fold this tile's access pattern into the residency manager once
        the dispatch loop is done."""
        self._tier.note_gather(self._hot_rows, self._cold_rows, self._per_chunk)
