"""Sharded SimHash index: per-shard top-k, one cross-shard merge.

The port of ``randomprojection_tpu/serving/sharded_index.py``.
``SimHashIndex`` (``models/sketch.py``) is one device's worth of serving:
its codes live on one device and its ids are int32, so it refuses growth
past ``2**31 - 1`` codes.  ``ShardedSimHashIndex`` is the tier above it:

- **Row sharding, per device.**  The corpus row-shards over a list of
  shard devices (a ``parallel.Mesh``'s data axis, an explicit device
  list, or ``n_shards`` over the CUDA cards).  Each shard is a complete
  single-device ``SimHashIndex`` on its device, so every shard serves
  through the fused top-k kernel (``csrc/topk.cu``).  Several shards may
  share one device: on one H100 the eight shards of config 4's bench
  share the card, and the CPU tests run ``devices=['cpu'], n_shards=8``.
  No shard moves to another device, and nothing catches a shard's failed
  dispatch to serve another route.
- **Global int64 / local int32 ids.**  Global ids are assigned in
  insertion order across the corpus and surface as int64; each shard
  keeps int32 locals for its kernel, and the ``2**31 - 1`` refusal is a
  per-shard invariant (the shard names itself in the error).
  ``id_offset`` starts the global id space anywhere in int64.
- **One cross-shard merge.**  A query tile is dispatched to every live
  shard (each shard's kernels queue on its device), each returns its
  top-``min(m, shard live)`` candidates, and the candidate lists' host
  merge (``topk_kernels.merge_topm``) finishes the tile: bit for bit
  ``topk_bruteforce`` on the concatenated corpus, because a shard's top-m
  under that order holds every global top-m member of the shard.  One
  live shard needs no merge: its answer is already in that order.  Tiles
  finish one behind (``ops.staging.tile_pipeline``), so tile ``i``'s
  copies and merge ride under tile ``i+1``'s kernels.

The reference sends a shard whose shape its kernel cannot plan to a dense
host leg; the port's card index has no such route and refuses past the
kernel's ``MAX_M``, naming the shard (a standing divergence, ROADMAP C).

Tombstones (``delete``) take global ids, translate through the segment
map and land in each owning shard's bitmap, so a deleted range spanning
shard boundaries filters exactly as on one device.  Snapshots
(``save``/``load``) spill the corpus in global id order: a snapshot
saved under one layout restores under any other shard count, or as a
plain ``SimHashIndex``, with the same answers, in either package
(``durable.save_sharded_index``).

Thread-safety matches ``SimHashIndex``: concurrent queries are fine,
mutation (``add``/``delete``/``compact``) requires quiescence.

Telemetry: ``shard.topk_tile`` a tile, ``shard.merge`` a merge, the
``shard.dispatches`` counter and the ``serve.shard.merge_wall_s`` gauge.
"""

from __future__ import annotations

import contextlib
import numbers
import os
import threading
import time
from typing import Optional

import numpy as np

from randomprojection_tpu_torch.models.sketch import SimHashIndex
from randomprojection_tpu_torch.ops import topk_kernels
from randomprojection_tpu_torch.ops.staging import tile_pipeline
from randomprojection_tpu_torch.utils import telemetry
from randomprojection_tpu_torch.utils.telemetry import EVENTS

__all__ = ["ShardedSimHashIndex", "shard_devices"]

def shard_devices(mesh=None, devices=None, n_shards: Optional[int] = None,
                  data_axis: str = "data") -> list:
    """The shard device list, as checked ``torch.device``s: one device
    per ``data_axis`` index of ``mesh``, an explicit ``devices`` sequence,
    or ``n_shards`` over the CUDA cards (round-robin when shards outnumber
    devices: several shards may share one device).  With nothing given,
    one shard per CUDA card; with no card that raises (``devices=['cpu']``
    asks for the CPU).

    ``mesh`` fixes the layout by itself, so combining it with ``devices=``
    or ``n_shards=`` raises; ``devices`` with ``n_shards`` is the
    round-robin form."""
    from randomprojection_tpu_torch.parallel.mesh import (
        _local_devices,
        data_axis_devices,
        resolve_devices,
    )

    if mesh is not None and (devices is not None or n_shards is not None):
        raise ValueError(
            "mesh= already fixes the shard layout (one shard per "
            f"{data_axis!r}-axis index); it cannot be combined with "
            "devices= or n_shards="
        )
    if n_shards is not None and n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if devices is not None:
        devices = list(devices)
        if not devices:
            raise ValueError("devices= must name at least one device")
        devices = resolve_devices(devices)
        if n_shards is None:
            return devices
        return [devices[i % len(devices)] for i in range(int(n_shards))]
    if mesh is not None:
        return data_axis_devices(mesh, data_axis)
    local = _local_devices()
    if n_shards is None:
        return local
    return [local[i % len(local)] for i in range(int(n_shards))]


def _on(device):
    """The context a shard's launches run in: its card made current (its
    stream is then the one the kernels and copy events queue on)."""
    if device.type == "cuda":
        import torch

        return torch.cuda.device(device)
    return contextlib.nullcontext()


class _Segment:
    """One contiguous run of global ids living contiguously in one shard:
    global ids ``[g0, g0 + rows)`` are shard ``shard``'s local ids
    ``[l0, l0 + rows)``.  Segments tile ``[0, n_codes)`` in order and map
    1:1 (per shard, in order) to the shard's chunks: every ``add``
    appends at most one chunk and one segment per shard."""

    __slots__ = ("g0", "rows", "shard", "l0")

    def __init__(self, g0: int, rows: int, shard: int, l0: int):
        self.g0 = g0
        self.rows = rows
        self.shard = shard
        self.l0 = l0


class ShardedSimHashIndex:
    """A SimHash code index row-sharded over many devices (see the module
    docstring).  Its API mirrors ``SimHashIndex`` with ids widened to
    int64: ``query_topk`` returns ``(dist int32, idx int64)``,
    ``delete``/``compact`` speak global ids, ``query`` returns the dense
    matrix with columns in global id order.

    The kernel is the one top-k route: the reference's ``topk_impl``
    (its ``'scan'`` route) has no counterpart.  ``hbm_budget_bytes`` (with ``cold_tier``/``cold_dir``) tiers each
    shard under its own budget; ``close()`` joins their workers."""

    def __init__(self, codes, *, mesh=None, devices=None,
                 n_shards: Optional[int] = None, data_axis: str = "data",
                 n_bits: Optional[int] = None, id_offset: int = 0,
                 hbm_budget_bytes: Optional[int] = None,
                 cold_tier: str = "host", cold_dir: Optional[str] = None):
        codes = np.asarray(codes, dtype=np.uint8)
        if codes.ndim != 2:
            raise ValueError(f"codes must be (n, nbytes), got {codes.shape}")
        if not isinstance(id_offset, numbers.Integral) or id_offset < 0:
            raise ValueError(
                f"id_offset must be a non-negative int, got {id_offset!r}"
            )
        self.n_bytes = codes.shape[1]
        self.n_bits = self.n_bytes * 8 if n_bits is None else int(n_bits)
        if not 0 < self.n_bits <= self.n_bytes * 8:
            raise ValueError(
                f"n_bits={self.n_bits} outside (0, {self.n_bytes * 8}]"
            )
        self.id_offset = int(id_offset)
        self.data_axis = data_axis
        # the budget is per shard: each shard tiers its own device memory
        self.hbm_budget_bytes = hbm_budget_bytes
        self.cold_tier = cold_tier
        self.cold_dir = cold_dir
        self._devices = shard_devices(mesh, devices, n_shards, data_axis)
        self._shards = [
            self._make_shard(s, dev) for s, dev in enumerate(self._devices)
        ]
        self._segments: list = []
        self._shard_seg_cache: dict = {}
        self.n_codes = 0
        self._merges = 0
        self._merge_wall_s = 0.0
        # the merge tallies are the one state concurrent queries share
        self._merge_stats_lock = threading.Lock()
        if codes.shape[0]:
            self.add(codes)

    def _make_shard(self, s: int, dev) -> SimHashIndex:
        """One empty shard on ``dev``: the one construction point
        (``__init__`` and ``compact``), and the hook the LSH tier
        (``ann.LSHShardedSimHashIndex``) overrides."""
        return SimHashIndex(
            np.empty((0, self.n_bytes), np.uint8),
            n_bits=self.n_bits, device=dev,
            label=f"shard {s}/{len(self._devices)} on {dev}",
            **self._tier_kwargs(s),
        )

    def _tier_kwargs(self, s: int) -> dict:
        """A shard's tiered-residency kwargs (empty when untiered); a disk
        cold tier gets a subdirectory a shard, so spills never collide."""
        if self.hbm_budget_bytes is None:
            return {}
        cold_dir = self.cold_dir
        if cold_dir is not None:
            cold_dir = os.path.join(cold_dir, f"shard-{s:02d}")
        return {
            "hbm_budget_bytes": self.hbm_budget_bytes,
            "cold_tier": self.cold_tier, "cold_dir": cold_dir,
        }

    def close(self) -> None:
        """Join every shard's tiered-residency worker (idempotent; a no-op
        untiered)."""
        for s in self._shards:
            s.close()

    # -- shape and accounting -------------------------------------------------

    @property
    def n_shards(self) -> int:
        return len(self._shards)

    @property
    def devices(self) -> list:
        return list(self._devices)

    @property
    def n_deleted(self) -> int:
        return sum(s.n_deleted for s in self._shards)

    @property
    def n_live(self) -> int:
        return self.n_codes - self.n_deleted

    def stats(self) -> dict:
        """Per-shard row and live counts, the cross-shard merges and their
        summed wall (the host cost the tier adds to the shards' kernels)."""
        with self._merge_stats_lock:
            merges, merge_wall = self._merges, self._merge_wall_s
        return {
            "shards": self.n_shards,
            "n_codes": int(self.n_codes),
            "n_live": int(self.n_live),
            "shard_rows": [int(s.n_codes) for s in self._shards],
            "shard_live": [int(s.n_live) for s in self._shards],
            "merges": merges,
            "merge_wall_s": round(merge_wall, 6),
        }

    def _check_queries(self, A):
        A = np.asarray(A, dtype=np.uint8)
        if A.ndim != 2 or A.shape[1] != self.n_bytes:
            raise ValueError(
                f"queries must be (n, {self.n_bytes}), got {A.shape}"
            )
        return A

    # -- growth ------------------------------------------------------------------

    def _split_for_add(self, n_new: int) -> list:
        """Rows each shard takes of an ``n_new``-row append: the emptiest
        shards first, so sizes stay balanced (to ±1 once every shard has
        caught up) and no resident row ever moves."""
        p = self.n_shards
        sizes = [s.n_codes for s in self._shards]
        base, rem = divmod(self.n_codes + n_new, p)
        counts = [0] * p
        remaining = n_new
        for s in range(p):
            target = base + (1 if s < rem else 0)
            take = min(max(target - sizes[s], 0), remaining)
            counts[s] = take
            remaining -= take
        # the targets sum to the new total, so the deficits cover n_new
        return counts

    def add(self, codes) -> "ShardedSimHashIndex":
        """Append codes: global ids continue in insertion order and the rows
        split contiguously across the shards, balancing their sizes (one
        new chunk a receiving shard)."""
        codes = np.asarray(codes, dtype=np.uint8)
        if codes.ndim != 2 or codes.shape[1] != self.n_bytes:
            raise ValueError(
                f"codes must be (n, {self.n_bytes}), got {codes.shape}"
            )
        n = codes.shape[0]
        if n == 0:
            return self
        lo, g = 0, self.n_codes
        for s, c in enumerate(self._split_for_add(n)):
            if c == 0:
                continue
            shard = self._shards[s]
            l0 = shard.n_codes
            shard.add(codes[lo: lo + c])
            self._segments.append(_Segment(g, c, s, l0))
            lo += c
            g += c
        self.n_codes += n
        self._shard_seg_cache.clear()
        return self

    # -- id translation ------------------------------------------------------------

    def _seg_arrays(self):
        """``(g0s, rows, shards, l0s)`` int64 over the segments in global
        id order: the global → local tables."""
        cached = self._shard_seg_cache.get("global")
        if cached is None:
            cached = tuple(
                np.array([getattr(s, f) for s in self._segments],
                         dtype=np.int64)
                for f in ("g0", "rows", "shard", "l0")
            )
            self._shard_seg_cache["global"] = cached
        return cached

    def _shard_tables(self, si: int):
        """``(l0s, g0s)`` of shard ``si``'s segments by local start: the
        local → global table."""
        cached = self._shard_seg_cache.get(si)
        if cached is None:
            segs = sorted((s for s in self._segments if s.shard == si),
                          key=lambda s: s.l0)
            cached = (
                np.array([s.l0 for s in segs], dtype=np.int64),
                np.array([s.g0 for s in segs], dtype=np.int64),
            )
            self._shard_seg_cache[si] = cached
        return cached

    def _local_to_global(self, si: int, local_ids: np.ndarray) -> np.ndarray:
        """Shard-local int32 ids → 0-based global int64 ids (``id_offset``
        is added at the API boundary)."""
        l0s, g0s = self._shard_tables(si)
        li = local_ids.astype(np.int64)
        k = np.searchsorted(l0s, li, side="right") - 1
        return g0s[k] + (li - l0s[k])

    def _shard_gids(self, si: int) -> np.ndarray:
        """0-based global ids of shard ``si``'s locals ``0..n_s-1``."""
        return self._local_to_global(
            si, np.arange(self._shards[si].n_codes, dtype=np.int64)
        )

    # -- mutation --------------------------------------------------------------------

    def delete(self, ids) -> int:
        """Tombstone codes by global id (``id_offset`` included); returns how
        many were newly deleted.  The ids translate through the segment map
        into each owning shard's bitmap."""
        ids = np.atleast_1d(np.asarray(ids))
        if ids.size == 0:
            return 0
        if not np.issubdtype(ids.dtype, np.integer):
            raise ValueError(
                f"delete ids must be integers, got dtype {ids.dtype}"
            )
        ids0 = np.unique(ids.astype(np.int64)) - self.id_offset
        lo, hi = int(ids0.min()), int(ids0.max())
        if lo < 0 or hi >= self.n_codes:
            raise ValueError(
                f"delete ids must be in [{self.id_offset}, "
                f"{self.id_offset + self.n_codes}), got "
                f"[{lo + self.id_offset}, {hi + self.id_offset}]"
            )
        g0s, _rows, shards, l0s = self._seg_arrays()
        k = np.searchsorted(g0s, ids0, side="right") - 1
        local = l0s[k] + (ids0 - g0s[k])
        owner = shards[k]
        newly = 0
        for si in np.unique(owner):
            newly += self._shards[int(si)].delete(local[owner == si])
        return newly

    def _iter_segment_host(self):
        """``(global_row0, host_rows)`` a segment in global id order, for
        the maintenance paths (compact, snapshot): one segment is one shard
        chunk, so a snapshot streams the corpus without holding it whole."""
        seen: dict = {}
        for seg in self._segments:
            shard = self._shards[seg.shard]
            j = seen.get(seg.shard, 0)
            seen[seg.shard] = j + 1
            chunk = shard._chunks[j]
            if chunk.n != seg.rows or chunk.row0 != seg.l0:
                raise RuntimeError(
                    "segment/chunk map out of step (every add appends one "
                    "chunk and one segment a shard) at shard "
                    f"{seg.shard} chunk {j}"
                )
            yield seg.g0, shard._fetch_chunk_host(chunk)

    def _codes_host(self) -> np.ndarray:
        """The whole corpus on the host in global id order."""
        parts = [rows for _, rows in self._iter_segment_host()]
        if not parts:
            return np.empty((0, self.n_bytes), np.uint8)
        return np.concatenate(parts, axis=0)

    def _dead_global(self) -> Optional[np.ndarray]:
        """The global tombstone bitmap in id order (None when nothing is
        deleted)."""
        if self.n_deleted == 0:
            return None
        dead = np.zeros(self.n_codes, dtype=bool)
        for seg in self._segments:
            sl = self._shards[seg.shard]._dead
            if sl is not None:
                dead[seg.g0: seg.g0 + seg.rows] = sl[seg.l0: seg.l0 + seg.rows]
        return dead

    def compact(self) -> np.ndarray:
        """Fold tombstones and re-balance: the live corpus re-shards as one
        chunk a shard; returns the old global ids (``id_offset`` included)
        of the survivors in their new id order.  A host rebuild: requires
        quiescence."""
        codes = self._codes_host()
        dead = self._dead_global()
        if dead is not None:
            mapping = np.flatnonzero(~dead).astype(np.int64)
            codes = codes[~dead]
        else:
            mapping = np.arange(self.n_codes, dtype=np.int64)
        old_n = self.n_codes
        chunks_before = sum(len(s._chunks) for s in self._shards)
        self.close()
        self._shards = [
            self._make_shard(s, dev) for s, dev in enumerate(self._devices)
        ]
        self._segments = []
        self._shard_seg_cache.clear()
        self.n_codes = 0
        if codes.shape[0]:
            self.add(codes)
        telemetry.registry().counter_inc("simhash.compactions")
        telemetry.emit(
            EVENTS.INDEX_COMPACT, chunks_before=chunks_before,
            chunks_after=sum(len(s._chunks) for s in self._shards),
            n_codes=int(self.n_codes), dropped=int(old_n - self.n_codes),
        )
        return mapping + self.id_offset

    # -- durable snapshot and restore (durable.py) -------------------------------------

    def save(self, path: str) -> dict:
        """Durable snapshot in global id order (``durable.save_sharded_index``):
        it loads under any shard count, or as a plain ``SimHashIndex`` when
        ``id_offset`` is 0, in either package."""
        from randomprojection_tpu_torch import durable

        return durable.save_sharded_index(self, path)

    @classmethod
    def load(cls, path: str, *, mesh=None, devices=None,
             n_shards: Optional[int] = None, data_axis: str = "data"):
        """Restore a snapshot (sharded or plain) onto any shard layout: the
        checksums verify before upload, the codes re-shard balanced, the
        tombstones re-arm, and the answers equal the saved index's."""
        from randomprojection_tpu_torch import durable

        return durable.load_sharded_index(
            path, mesh=mesh, devices=devices, n_shards=n_shards,
            data_axis=data_axis,
        )

    # -- the dense analysis surface ---------------------------------------------------

    def query(self, A, *, tile: int = 2048):
        """Dense Hamming distances ``(n_queries, n_codes)`` with columns in
        global id order (column ``j`` is global id ``id_offset + j``).
        Analysis scale; the shards serve one after another."""
        A = self._check_queries(A)
        out = np.empty((A.shape[0], self.n_codes), dtype=np.int32)
        for si, shard in enumerate(self._shards):
            if shard.n_codes == 0:
                continue
            with _on(shard.device):
                out[:, self._shard_gids(si)] = shard.query(A, tile=tile)
        return out

    def query_cosine(self, A, *, tile: int = 2048):
        """SimHash cosine estimates against the sharded corpus."""
        from randomprojection_tpu_torch.models.sketch import cosine_from_hamming

        return cosine_from_hamming(self.query(A, tile=tile), self.n_bits)

    # -- the serving path --------------------------------------------------------------

    def _merge_tile(self, d_parts: list, g_parts: list, m_eff: int):
        """The cross-shard merge: the shards' ``(dist, 0-based global id)``
        candidate columns, the top ``m_eff`` a row under the exact
        (distance, lower-global-id) order (``topk_kernels.merge_topm``).
        One shard's columns pass as they are: they are in that order
        already (local → global ids rise together).  Returns ``(dist,
        idx)`` with ``id_offset`` added.
        Shared with the LSH tier (``ann.LSHShardedSimHashIndex``); owns the
        merge tallies and the ``shard.merge`` event."""
        t0 = time.perf_counter()
        out_d, out_i = topk_kernels.merge_topm(d_parts, g_parts, m_eff)
        out_i = out_i + self.id_offset
        t, k = out_d.shape[0], sum(d.shape[1] for d in d_parts)
        wall = time.perf_counter() - t0
        with self._merge_stats_lock:
            self._merges += 1
            self._merge_wall_s += wall
        telemetry.registry().gauge_set("serve.shard.merge_wall_s", wall)
        if telemetry.enabled():
            telemetry.emit(
                EVENTS.SHARD_MERGE, queries=int(t), candidates=int(k),
                shards=len(d_parts), m=int(m_eff), wall_s=round(wall, 6),
                **telemetry.trace_fields(),
            )
        return out_d, out_i

    def _live_shards(self, m_eff: int) -> list:
        """``(shard index, m_s)`` of every shard with live codes, each
        checked against the kernel's largest ``m`` before any dispatch."""
        live = []
        for si, shard in enumerate(self._shards):
            if shard.n_live == 0:
                continue  # empty or fully tombstoned
            m_s = int(min(m_eff, shard.n_live))
            shard._check_m(m_s)
            live.append((si, m_s))
        return live

    def _note_tile(self, queries: int, m_eff: int, shards: int) -> None:
        telemetry.registry().counter_inc("shard.dispatches", shards)
        if telemetry.enabled():
            telemetry.emit(
                EVENTS.SHARD_TOPK_TILE, queries=int(queries), m=int(m_eff),
                shards=int(shards), n_codes=int(self.n_codes),
                **telemetry.trace_fields(),
            )

    def _check_query(self, A, m):
        """The shared front of ``query_topk``: ``(queries, m_eff)``."""
        if not isinstance(m, numbers.Integral) or m <= 0:
            raise ValueError(f"m must be a positive int, got {m!r}")
        A = self._check_queries(A)
        if self.n_codes == 0:
            raise ValueError("query_topk on an empty index")
        if self.n_live == 0:
            raise ValueError(
                "query_topk on an index whose codes are all deleted "
                "(tombstoned); compact() or add() live codes first"
            )
        return A, int(min(m, self.n_live))

    def query_topk(self, A, m: int, *, tile: int = 2048):
        """Top-``m`` nearest codes a query across every shard.

        Returns ``(dist, idx)``: ``dist`` ``(n_queries, m_eff)`` int32,
        ``idx`` int64 global ids (``id_offset`` included), ``m_eff =
        min(m, n_live)``, sorted by (distance, lower global id): bit for bit
        ``topk_bruteforce`` on the concatenated corpus, for any shard count,
        chunk layout or tiling.

        A tile is dispatched to every live shard first (each shard's K4
        launches, one scan and one merge a chunk, queue on its device),
        then one host merge of the ``Σ min(m_eff, live_s)`` candidates
        finishes it; tiles finish one behind."""
        A, m_eff = self._check_query(A, m)
        return self._serve_tiles(
            A, m_eff, self._live_shards(m_eff), tile,
            lambda shard, a, m_s: shard._topk_dispatch_tile(a, m_s),
            lambda shard, handles, m_s: shard._topk_finish_tile(handles, m_s),
        )

    def _serve_tiles(self, A, m_eff: int, live: list, tile: int,
                     dispatch, finish):
        """The tile pipeline of both tiers: ``dispatch(shard, rows, m_s)``
        queues a tile on every live shard (on its device), ``finish(shard,
        payload, m_s)`` waits for one shard's ``(dist, local id)`` columns,
        and the cross-shard merge finishes the tile, one tile behind the
        dispatches.  The LSH tier passes its own pair
        (``ann.LSHShardedSimHashIndex``)."""
        nq = A.shape[0]
        out_d = np.empty((nq, m_eff), dtype=np.int32)
        out_i = np.empty((nq, m_eff), dtype=np.int64)

        def dispatch_tile(lo, hi):
            per_shard = []  # [(shard index, payload, m_s)]
            for si, m_s in live:
                shard = self._shards[si]
                with _on(shard.device):
                    per_shard.append((si, dispatch(shard, A[lo:hi], m_s), m_s))
            self._note_tile(hi - lo, m_eff, len(per_shard))
            return per_shard

        def finish_tile(lo, hi, per_shard):
            d_parts, g_parts = [], []
            for si, payload, m_s in per_shard:
                d_s, li_s = finish(self._shards[si], payload, m_s)
                d_parts.append(d_s)
                g_parts.append(self._local_to_global(si, li_s))
            out_d[lo:hi], out_i[lo:hi] = self._merge_tile(
                d_parts, g_parts, m_eff)

        tile_pipeline(nq, tile, dispatch_tile, finish_tile)
        return out_d, out_i
