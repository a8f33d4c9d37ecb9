"""Multi-probe LSH candidate tier over SimHash code indexes.

The port of ``randomprojection_tpu/ann/lsh.py`` (the single-device tier).
SimHash codes are an LSH family (Charikar 2002; multi-probe after Lv et al.
2007): two codes that agree on a contiguous ``b``-bit band of their sign
bits are close with a probability that rises steeply as their angle
shrinks, so bucketing every code by ``L`` disjoint band keys turns
candidate generation into bucket lookups, and the exact top-k kernel
re-ranks only the candidates.

- **Band keys** (``band_keys``): code bits ``[j·b, (j+1)·b)`` of each
  packed code form band ``j``'s key (little-endian within each byte).
- **Banded CSR buckets** (``BandedBuckets``): per band, a counting-sorted
  ``indptr (2^b + 1) → ids`` layout with ids ascending within every
  bucket, kept on the host; ``add`` merges new rows incrementally.
- **Multi-probe** (``probe_masks``): each band probes its exact bucket and
  the nearest ``P-1`` perturbations, XOR masks in (popcount, ascending
  value) order.  ``P ≥ 2^b`` probes every bucket: the candidate set is
  the whole live corpus and the answer equals brute force bit for bit.
- **Exact re-rank** (``LSHSimHashIndex.query_topk``): per query tile, two
  rungs produce the same candidate union and re-rank it with the top-k
  kernel K4.  The **device rung** runs the whole tile on the index's
  device (``ops/probe_kernels.device_probe_topk``: band keys, the CSR
  probe kernel K5, sort-dedup, tombstone mask, chunk gather, K4), on a
  card as one CUDA-graph replay a tile (``probe_kernels.TileGraphs``: a
  graph per tile key, all dropped on every mutation); the
  **host rung** probes the CSR with numpy and re-ranks the gathered rows.
  ``probe_path='auto'`` is the device rung for an index on a card and the
  host rung on the CPU; ``'device'`` on a CPU index runs K5's plain
  version inside the same composite.
- **Fallback ladder**: a tile whose candidate union is denser than
  ``fallback_density · n_live`` (``dense``) or holds fewer than ``m``
  (``starved``), and a tile whose slots overflow (``device_budget``),
  serve through the exact path: the tier never serves worse than the
  exact path, and every rung re-ranks with K4 on a card.  The device
  rung takes the reference planner's tile and slot budget where it has
  one; a shape whose TPU budget it refuses (the reference's
  ``device_plan``, served on the host) is sized by its runs' exact total
  and stays on the device, with the host rung's answer.
- **Adaptive probing** (``adaptive=True``): per-query escalation over
  popcount levels with an early-exit distance bound and an optional
  ``candidate_budget``; exact at the full ceiling, recall monotone in the
  budget.

Not ported (ROADMAP): the sharded tier ``LSHShardedSimHashIndex`` (A10),
snapshots of the band keys (A9), the tiered re-rank (A12).  The reference's
host-select rung for a re-rank that overflowed the TPU's scoped VMEM has
no counterpart: the card's kernel plans fit by construction.

Telemetry: ``index.lsh.dispatch``, ``index.lsh.fallback`` (with its
reason), ``index.lsh.build``, ``index.lsh.device_dispatch``,
``index.lsh.device_upload`` and ``index.lsh.adaptive`` events, and the
``index.lsh.*`` counters and ``index.lsh.probe.{host,dispatch}_s``
histograms on the process registry.
"""

from __future__ import annotations

import itertools
import math
import numbers
import time
from typing import Optional

import numpy as np

from randomprojection_tpu_torch.models.sketch import SimHashIndex
from randomprojection_tpu_torch.ops import probe_kernels, topk_kernels
# a tensor's copy to the host, started at dispatch and read one tile behind
from randomprojection_tpu_torch.streaming import _HostFetch
from randomprojection_tpu_torch.utils import telemetry
from randomprojection_tpu_torch.utils.telemetry import EVENTS

__all__ = [
    "BandPlan",
    "band_keys",
    "probe_masks",
    "BandedBuckets",
    "LSHSimHashIndex",
]

# bucket-space ceiling: indptr is 2^b + 1 offsets a band
_MAX_BAND_BITS = 20
# band-key extraction block: bounds the unpacked bit matrix however large
# one add() is
_KEY_EXTRACT_BLOCK = 1 << 16
_INT32_MAX = np.int32(2**31 - 1)

_PROBE_PATHS = ("auto", "host", "device")


def _check_probe_path(probe_path) -> str:
    if probe_path not in _PROBE_PATHS:
        raise ValueError(
            f"probe_path must be one of {_PROBE_PATHS}, got {probe_path!r}"
        )
    return str(probe_path)


def _check_ctor_probes(probes) -> int:
    """Constructor ``probes``: a strictly positive int (a bool is refused:
    ``probes=True`` almost certainly meant a count)."""
    if (isinstance(probes, bool) or not isinstance(probes, numbers.Integral)
            or probes < 1):
        raise ValueError(f"probes must be a positive int, got {probes!r}")
    return int(probes)


def _check_budget(budget) -> Optional[int]:
    """Adaptive per-query candidate budget: None (uncapped) or a strictly
    positive int."""
    if budget is None:
        return None
    if (isinstance(budget, bool) or not isinstance(budget, numbers.Integral)
            or budget < 1):
        raise ValueError(
            f"candidate_budget must be a positive int or None, got {budget!r}"
        )
    return int(budget)


def _check_probes(probes, default: int) -> int:
    """Per-call ``probes``: None → the serving default, else a
    non-negative int (0 = the exact path)."""
    if probes is None:
        return default
    if (isinstance(probes, bool) or not isinstance(probes, numbers.Integral)
            or probes < 0):
        raise ValueError(f"probes must be a non-negative int, got {probes!r}")
    return int(probes)


def _host_rows(a) -> np.ndarray:
    """A query tile as host uint8 rows (a tensor is copied to the host)."""
    return a if isinstance(a, np.ndarray) else a.cpu().numpy()


class BandPlan:
    """Resolved band layout: ``bands`` disjoint ``band_bits``-bit key
    slices over the leading ``bands·band_bits`` code bits.

    Defaults: ``band_bits = min(16, n_bits)`` and ``bands = min(8, n_bits
    // band_bits)``.  Bands must fit the real bit count, so ragged codes
    never key on pad bits."""

    __slots__ = ("n_bits", "bands", "band_bits")

    def __init__(self, n_bits: int, *, bands: Optional[int] = None,
                 band_bits: Optional[int] = None):
        n_bits = int(n_bits)
        if n_bits < 1:
            raise ValueError(f"n_bits must be >= 1, got {n_bits}")
        if band_bits is None:
            band_bits = min(16, n_bits)
        band_bits = int(band_bits)
        if not 1 <= band_bits <= _MAX_BAND_BITS:
            raise ValueError(
                f"band_bits must be in [1, {_MAX_BAND_BITS}], got {band_bits}"
            )
        if bands is None:
            bands = max(1, min(8, n_bits // band_bits))
        bands = int(bands)
        if bands < 1:
            raise ValueError(f"bands must be >= 1, got {bands}")
        if bands * band_bits > n_bits:
            raise ValueError(
                f"bands={bands} x band_bits={band_bits} needs "
                f"{bands * band_bits} code bits but the codes carry only "
                f"{n_bits}; bands are disjoint slices of the real bits"
            )
        self.n_bits = n_bits
        self.bands = bands
        self.band_bits = band_bits

    def __eq__(self, other):
        return (
            isinstance(other, BandPlan)
            and (self.n_bits, self.bands, self.band_bits)
            == (other.n_bits, other.bands, other.band_bits)
        )

    def __repr__(self):
        return (f"BandPlan(n_bits={self.n_bits}, bands={self.bands}, "
                f"band_bits={self.band_bits})")


def band_keys(codes, plan: BandPlan) -> np.ndarray:
    """Band keys of packed codes on the host: ``(bands, n)`` uint32, key
    ``j`` of a row being its code bits ``[j·b, (j+1)·b)``, little-endian
    within each byte (``np.packbits(bitorder='little')``)."""
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    if codes.ndim != 2:
        raise ValueError(f"codes must be (n, nbytes), got {codes.shape}")
    n = codes.shape[0]
    b = plan.band_bits
    out = np.empty((plan.bands, n), np.uint32)
    w = np.uint32(1) << np.arange(b, dtype=np.uint32)
    for lo in range(0, n, _KEY_EXTRACT_BLOCK):
        hi = min(lo + _KEY_EXTRACT_BLOCK, n)
        bits = np.unpackbits(codes[lo:hi], axis=1, bitorder="little")
        for j in range(plan.bands):
            sl = bits[:, j * b: (j + 1) * b].astype(np.uint32)
            out[j, lo:hi] = (sl * w[None, :]).sum(axis=1, dtype=np.uint32)
    return out


def probe_masks(band_bits: int, probes: int) -> np.ndarray:
    """The first ``probes`` XOR masks of the perturbation sequence: the
    exact bucket first, then masks in (popcount, ascending value) order.
    Sign-only codes make every bit equally confident, so the order is
    data-independent; ``probes ≥ 2^band_bits`` enumerates every bucket."""
    if not isinstance(probes, numbers.Integral) or probes < 1:
        raise ValueError(f"probes must be a positive int, got {probes!r}")
    band_bits = int(band_bits)
    probes = int(min(probes, 1 << band_bits))
    out = [0]
    flips = 1
    while len(out) < probes and flips <= band_bits:
        vals = sorted(
            sum(1 << p for p in combo)
            for combo in itertools.combinations(range(band_bits), flips)
        )
        out.extend(vals[: probes - len(out)])
        flips += 1
    return np.asarray(out, dtype=np.uint32)


class BandedBuckets:
    """Per-band CSR inverted bucket index over one index's id space.

    Per band: ``indptr`` ``(2^b + 1,)`` int64 and ``ids`` ``(n,)`` int32,
    counting-sorted by bucket with ids ASCENDING within every bucket (what
    makes candidate unions id-sorted and the re-rank's tie rule exact).
    ``keys`` ``(bands, n)`` uint32 holds every row's band keys in id order,
    which ``compact()``'s id remap folds without re-extraction."""

    __slots__ = ("plan", "n", "keys", "_indptr", "_ids")

    def __init__(self, plan: BandPlan):
        self.plan = plan
        self.n = 0
        self.keys = np.empty((plan.bands, 0), np.uint32)
        nb = 1 << plan.band_bits
        self._indptr = [np.zeros(nb + 1, np.int64) for _ in range(plan.bands)]
        self._ids = [np.empty(0, np.int32) for _ in range(plan.bands)]

    @classmethod
    def from_keys(cls, plan: BandPlan, keys: np.ndarray) -> "BandedBuckets":
        """Rebuild from a key matrix (one counting sort a band, no code
        bytes touched)."""
        keys = np.ascontiguousarray(keys, dtype=np.uint32)
        if keys.ndim != 2 or keys.shape[0] != plan.bands:
            raise ValueError(f"keys must be ({plan.bands}, n), got {keys.shape}")
        b = cls(plan)
        b._append_keys(keys)
        return b

    def add(self, codes) -> int:
        """Fold new rows (local ids ``[n, n+rows)``) into every band's CSR:
        keys of the NEW rows only, spliced in with a vectorized merge.
        Returns the number of rows folded."""
        new_keys = band_keys(codes, self.plan)
        self._append_keys(new_keys)
        return new_keys.shape[1]

    def _append_keys(self, new_keys: np.ndarray) -> None:
        m = new_keys.shape[1]
        if m == 0:
            return
        row0 = self.n
        if row0 + m > 2**31 - 1:
            raise ValueError(
                "BandedBuckets ids are int32; "
                f"have {row0}, adding {m} would overflow"
            )
        nb = 1 << self.plan.band_bits
        for j in range(self.plan.bands):
            k = new_keys[j].astype(np.int64)
            counts = np.bincount(k, minlength=nb)
            csum = np.concatenate(([0], np.cumsum(counts)))
            old_indptr = self._indptr[j]
            old_ids = self._ids[j]
            old_counts = np.diff(old_indptr)
            indptr = old_indptr + csum
            out = np.empty(old_ids.size + m, np.int32)
            if old_ids.size:
                # old bucket k's run shifts right by the new rows landing in
                # buckets < k
                shift = np.repeat(csum[:-1], old_counts)
                out[np.arange(old_ids.size, dtype=np.int64) + shift] = old_ids
            # a stable sort groups new rows by bucket in id order, and every
            # new id exceeds every old one: ids stay ascending in a bucket
            order = np.argsort(k, kind="stable")
            grp_start = np.repeat(csum[:-1], counts)
            within = np.arange(m, dtype=np.int64) - grp_start
            dest = np.repeat(indptr[:-1] + old_counts, counts) + within
            out[dest] = (row0 + order).astype(np.int32)
            self._indptr[j] = indptr
            self._ids[j] = out
        self.keys = np.concatenate([self.keys, new_keys], axis=1)
        self.n += m

    def candidates(self, qkeys: np.ndarray, masks: np.ndarray):
        """Union candidate ids of one query tile: bucket ``qkey ^ mask`` of
        every band for every mask, deduplicated across bands, probes and
        the tile's queries.  Returns ``(ids, gathered)``: ``ids`` ascending
        int32, ``gathered`` the count before dedup."""
        parts = []
        gathered = 0
        for j in range(self.plan.bands):
            buckets = (
                (qkeys[j][:, None] ^ masks[None, :]).ravel().astype(np.int64)
            )
            indptr = self._indptr[j]
            starts = indptr[buckets]
            lens = indptr[buckets + 1] - starts
            total = int(lens.sum())
            if total == 0:
                continue
            csum = np.concatenate(([0], np.cumsum(lens)))
            take = np.repeat(starts - csum[:-1], lens) + np.arange(
                total, dtype=np.int64
            )
            parts.append(self._ids[j][take])
            gathered += total
        if not parts:
            return np.empty(0, np.int32), 0
        return np.unique(np.concatenate(parts)), gathered

    def gathered(self, qkeys: np.ndarray, masks: np.ndarray) -> int:
        """``candidates``'s ``gathered`` count alone: the probed runs'
        lengths summed, with no id read."""
        total = 0
        for j in range(self.plan.bands):
            buckets = (
                (qkeys[j][:, None] ^ masks[None, :]).ravel().astype(np.int64)
            )
            indptr = self._indptr[j]
            total += int((indptr[buckets + 1] - indptr[buckets]).sum())
        return total

    def bucket_ids(self, band: int, key: int) -> np.ndarray:
        """One bucket's id run (ascending)."""
        indptr = self._indptr[band]
        return self._ids[band][indptr[key]: indptr[key + 1]].copy()


def _merge_topm_rows(bd, bg, nd, ng, sentinel: int):
    """Row-wise exact merge of two (dist, id) top-m planes under the
    (distance, lower-global-id) order, deduplicating ids: ``top_m(A ∪ B) =
    top_m(top_m(A) ∪ top_m(B))`` makes the adaptive rounds exact over
    their cumulative candidates.  A duplicate id has one distance, so it
    is key-identical and adjacent after the sort; all but the first
    re-key to the empty-slot pair."""
    m = bd.shape[1]
    d = np.concatenate([bd, nd], axis=1).astype(np.int64)
    g = np.concatenate([bg, ng], axis=1).astype(np.int64)
    key = (d << 32) | g
    key.sort(axis=1)
    dup = np.zeros(key.shape, bool)
    dup[:, 1:] = key[:, 1:] == key[:, :-1]
    key[dup] = (np.int64(sentinel) << 32) | int(_INT32_MAX)
    key.sort(axis=1)
    key = key[:, :m]
    return (
        (key >> 32).astype(np.int32),
        (key & 0x7FFFFFFF).astype(np.int32),
    )


def _level_size(band_bits: int, f: int) -> int:
    """Masks of ``band_bits`` bits with popcount ``f``: popcount level
    ``f``'s full size."""
    return math.comb(band_bits, f)


class LSHSimHashIndex(SimHashIndex):
    """``SimHashIndex`` with a banded multi-probe LSH candidate tier:
    ``query_topk`` probes the bucket index, re-ranks only the candidates
    exactly with the top-k kernel, and falls back to the exact path when
    the candidate set is too dense or too starved (see the module
    docstring).

    ``probes`` is the recall/q-s knob: buckets probed a band (1 = the
    exact bucket; ``2^band_bits`` = full coverage = brute force).  The
    constructor's value is the serving default (a ``TopKServer`` uses it)
    and ``query_topk(probes=...)`` overrides it per call (0 = the exact
    path).  ``fallback_density`` is the ladder's threshold on the
    candidate union's share of the live corpus.

    The bucket index follows every mutation: ``add`` folds new rows
    incrementally (through the base index's ``_codes_appended`` hook),
    ``delete`` needs no bucket work (tombstones are masked at the
    re-rank), and ``compact`` folds the id remap.  Single-device."""

    def __init__(self, codes, *, bands: Optional[int] = None,
                 band_bits: Optional[int] = None, probes: int = 8,
                 fallback_density: float = 0.1, probe_path: str = "auto",
                 adaptive: bool = False,
                 candidate_budget: Optional[int] = None, **kw):
        if kw.get("mesh") is not None:
            raise ValueError(
                "mesh is not ported yet (ROADMAP A10, the sharded tier "
                "LSHShardedSimHashIndex); LSHSimHashIndex is single-device"
            )
        self.probes = _check_ctor_probes(probes)
        if not 0.0 < float(fallback_density) <= 1.0:
            raise ValueError(
                f"fallback_density must be in (0, 1], got {fallback_density!r}"
            )
        self.fallback_density = float(fallback_density)
        self.probe_path = _check_probe_path(probe_path)
        self.adaptive = bool(adaptive)
        self.candidate_budget = _check_budget(candidate_budget)
        self._lsh_suspend = False
        self._masks_cache: dict = {}
        # device-side probe state: the CSR mirror follows a revision clock
        # bumped by every bucket mutation, the tombstone plane the
        # (n_codes, tombstone revision) pair.  Set before the base
        # constructor, whose upload fires the append hook.
        self._lsh_dev_rev = 0
        self._lsh_dev_csr = None        # (rev, indptr, ids)
        self._lsh_dev_masks: dict = {}  # probes -> (1, P) int32
        self._lsh_dev_dead = None       # (key, dead)
        self._lsh_dev_active: dict = {}  # tile rows -> (1, tq) int32 ones
        # the card's captured tiles; they bake the CSR, tombstones and
        # chunks in, so every mutation drops them
        self._lsh_graphs = probe_kernels.TileGraphs()
        codes = self._check_codes(codes, None)
        n_bits = kw.get("n_bits")
        n_bits = codes.shape[1] * 8 if n_bits is None else int(n_bits)
        self.band_plan = BandPlan(n_bits, bands=bands, band_bits=band_bits)
        self._buckets = BandedBuckets(self.band_plan)
        super().__init__(codes, **kw)
        self._lsh_graphs.device = self.device

    # -- bucket maintenance (hooks off the base mutation paths) ---------------

    def _codes_appended(self, codes, row0: int) -> None:
        if not self._lsh_suspend:
            self._lsh_fold(_host_rows(codes))

    def _lsh_buckets_changed(self) -> None:
        """Invalidate the device CSR mirror and the captured tiles: the
        next device dispatch re-uploads the CSR from the host buckets."""
        self._lsh_dev_rev += 1
        self._lsh_graphs.clear()

    def delete(self, ids) -> int:
        """The base ``delete``; new tombstones also drop the captured tiles
        (they bake the tombstone plane in)."""
        newly = super().delete(ids)
        if newly:
            self._lsh_graphs.clear()
        return newly

    def _lsh_fold(self, codes: np.ndarray) -> None:
        rows = self._buckets.add(codes)
        self._lsh_buckets_changed()
        telemetry.registry().counter_inc("index.lsh.builds")
        telemetry.emit(
            EVENTS.INDEX_LSH_BUILD, rows=int(rows), n=int(self._buckets.n),
            bands=self.band_plan.bands, band_bits=self.band_plan.band_bits,
        )

    def _rebuild_from_host(self, codes: np.ndarray) -> None:
        # a wholesale replacement starts the bucket index over, unless
        # compact() is folding the id remap itself (suspended)
        if not self._lsh_suspend:
            self._buckets = BandedBuckets(self.band_plan)
            self._lsh_buckets_changed()
        super()._rebuild_from_host(codes)

    def compact(self) -> np.ndarray:
        """The base ``compact``, then the returned old→new id mapping folded
        through the bucket index: surviving rows keep their band keys
        (``keys[:, mapping]``), renumbered, with no re-hash."""
        old_keys = self._buckets.keys
        self._lsh_suspend = True
        try:
            mapping = super().compact()
        finally:
            self._lsh_suspend = False
        self._buckets = BandedBuckets.from_keys(self.band_plan,
                                                old_keys[:, mapping])
        self._lsh_buckets_changed()
        telemetry.registry().counter_inc("index.lsh.builds")
        telemetry.emit(
            EVENTS.INDEX_LSH_BUILD, rows=int(self._buckets.n),
            n=int(self._buckets.n), bands=self.band_plan.bands,
            band_bits=self.band_plan.band_bits, remapped=True,
        )
        return mapping

    # -- the candidate tier ----------------------------------------------------

    def _probe_masks(self, probes: int) -> np.ndarray:
        masks = self._masks_cache.get(probes)
        if masks is None:
            masks = probe_masks(self.band_plan.band_bits, probes)
            self._masks_cache[probes] = masks
        return masks

    def lsh_stats(self) -> dict:
        """Process-registry candidate-tier tallies (shared across indexes
        of one process, like every registry counter)."""
        reg = telemetry.registry()
        return {
            "dispatches": reg.counter("index.lsh.dispatches"),
            "fallbacks": reg.counter("index.lsh.fallbacks"),
            "candidates": reg.counter("index.lsh.candidates"),
            "probe_buckets": reg.counter("index.lsh.probe_buckets"),
            "builds": reg.counter("index.lsh.builds"),
            "device_dispatches": reg.counter("index.lsh.device.dispatches"),
            "device_uploads": reg.counter("index.lsh.device.uploads"),
            "adaptive_tiles": reg.counter("index.lsh.adaptive.tiles"),
        }

    def query_topk(self, A, m: int, *, tile: int = 2048,
                   probes: Optional[int] = None,
                   probe_path: Optional[str] = None,
                   adaptive: Optional[bool] = None,
                   candidate_budget: Optional[int] = None):
        """Top-``m`` through the candidate tier: the contract of
        ``SimHashIndex.query_topk`` (``(dist, idx)`` int32, ``m_eff =
        min(m, n_live)`` columns, (distance, lower-global-id) order), but a
        tile touches only its candidate union unless the ladder sends it
        to the exact path.  ``probes`` overrides the serving default (0 =
        the exact path); ``tile`` is also the candidate union's grain.

        ``probe_path`` (the constructor's otherwise): ``'device'`` runs the
        device rung (K5's plain version on a CPU index), ``'host'`` the
        host rung, ``'auto'`` the device rung on a card.  ``adaptive`` and
        ``candidate_budget`` drive per-query escalation on the device rung
        and are inert on the host rung.

        Under PARTIAL probes an answer depends on the (query set, tile):
        grouping a query with other queries can only enlarge its candidate
        set, so answers can only get closer, and at full coverage grouping
        does not matter."""
        p = _check_probes(probes, self.probes)
        if p == 0:
            return super().query_topk(A, m, tile=tile)
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
        device = self._lsh_probe_device(probe_path)
        adaptive_eff = self.adaptive if adaptive is None else bool(adaptive)
        budget_eff = (self.candidate_budget if candidate_budget is None
                      else _check_budget(candidate_budget))
        m_eff = int(min(m, self.n_live))
        if self.device.type == "cuda" and m_eff > topk_kernels.MAX_M:
            raise ValueError(
                f"query_topk m={m_eff} exceeds the kernel's largest m "
                f"(MAX_M={topk_kernels.MAX_M}) for an index on {self.device}"
            )
        masks = self._probe_masks(p)
        if device:
            tile = self._lsh_device_tile(tile, p, m_eff)
        nq = A.shape[0]
        out_d = np.empty((nq, m_eff), dtype=np.int32)
        out_i = np.empty((nq, m_eff), dtype=np.int32)
        # tiles finish one behind: tile i's copy to the host and its ladder
        # ride under tile i+1's probe and kernels
        pending: list = []

        def finish(entry):
            lo, hi, kind, payload = entry
            if kind == "lsh":
                d, i = self._lsh_finish_tile(payload)
            elif kind == "lsh_dev":
                d, i = self._lsh_finish_device_tile(payload, m_eff)
            elif kind == "exact":
                d, i = self._topk_finish_tile(payload, m_eff)
            else:  # 'done': served whole (adaptive rounds)
                d, i = payload
            out_d[lo:hi] = d
            out_i[lo:hi] = i

        for lo in range(0, nq, tile):
            hi = min(lo + tile, nq)
            kind, payload = self._lsh_tile_entry(
                A[lo:hi], m_eff, masks, p, tile, device, adaptive_eff,
                budget_eff,
            )
            pending.append((lo, hi, kind, payload))
            if len(pending) >= 2:
                finish(pending.pop(0))
        while pending:
            finish(pending.pop(0))
        return out_d, out_i

    # -- the host rung -----------------------------------------------------------

    def _lsh_dispatch_tile(self, a, m_eff: int, masks: np.ndarray):
        """Host probe + re-rank dispatch of one query tile.  Returns
        ``('lsh', payload)`` for a dispatched candidate re-rank, or
        ``('exact', handles)`` when the ladder fell back to the exact
        path."""
        t0 = time.perf_counter()
        a_np = _host_rows(a)
        qkeys = band_keys(a_np, self.band_plan)
        cand, gathered = self._buckets.candidates(qkeys, masks)
        if self._dead is not None and cand.size:
            # a deleted code is never gathered, so it can never win
            cand = cand[~self._dead[cand]]
        n_cand = int(cand.size)
        reg = telemetry.registry()
        # host-probe wall: key extraction, CSR walk, dedup, tombstones
        reg.observe("index.lsh.probe.host_s", time.perf_counter() - t0)
        nq = int(a_np.shape[0])
        if n_cand < m_eff or n_cand > self.fallback_density * self.n_live:
            reason = "starved" if n_cand < m_eff else "dense"
            reg.counter_inc("index.lsh.fallbacks")
            telemetry.emit(
                EVENTS.INDEX_LSH_FALLBACK, reason=reason, queries=nq,
                probes=int(masks.size), candidates=n_cand,
                n_live=int(self.n_live), threshold=self.fallback_density,
            )
            return "exact", self._topk_dispatch_tile(a, m_eff)
        frac = n_cand / max(self.n_live, 1)
        reg.counter_inc("index.lsh.dispatches")
        reg.counter_inc("index.lsh.probe_buckets",
                        nq * self.band_plan.bands * int(masks.size))
        reg.counter_inc("index.lsh.candidates", n_cand)
        reg.gauge_set("index.lsh.candidate_fraction", frac)
        if telemetry.enabled():
            telemetry.emit(
                EVENTS.INDEX_LSH_DISPATCH, queries=nq, m=int(m_eff),
                probes=int(masks.size), bands=self.band_plan.bands,
                candidates=n_cand, gathered=int(gathered),
                candidate_fraction=round(frac, 6),
            )
        t1 = time.perf_counter()
        payload = self._lsh_rerank_dispatch(a, cand, m_eff)
        reg.observe("index.lsh.probe.dispatch_s", time.perf_counter() - t1)
        return "lsh", payload

    def _gather_codes_device(self, cand: np.ndarray):
        """The candidate code rows, gathered on the index's device from the
        resident chunks (only the ascending candidate ids cross)."""
        import torch

        parts = []
        for c in self._chunks:
            lo = np.searchsorted(cand, c.row0)
            hi = np.searchsorted(cand, c.row0 + c.n)
            if hi > lo:
                local = self._to_device((cand[lo:hi] - c.row0).astype(np.int64))
                parts.append(c.b[local])
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def _lsh_rerank_dispatch(self, a, cand: np.ndarray, m_eff: int):
        """The exact re-rank of one tile against its gathered candidates
        with the top-k kernel, and the start of the copies to the host."""
        d, i = topk_kernels.fused_topk(
            self._to_device(a), self._gather_codes_device(cand),
            int(cand.size), m_eff,
        )
        return _HostFetch(d), _HostFetch(i), cand

    def _lsh_finish_tile(self, payload):
        """Wait for one re-rank and map candidate positions back to global
        ids: ``cand`` is ascending, so the kernel's lower-position tie rule
        is the lower-global-id rule."""
        d, i, cand = payload
        return d.result(None), cand[i.result(None)].astype(np.int32)

    # -- the device rung ---------------------------------------------------------

    def _lsh_probe_device(self, probe_path: Optional[str]) -> bool:
        """The per-call probe path: ``'device'`` runs the device rung (its
        plain version on a CPU index), ``'host'`` the host rung, ``'auto'``
        the device rung for an index on a card."""
        path = (self.probe_path if probe_path is None
                else _check_probe_path(probe_path))
        if path == "auto":
            return self.device.type == "cuda"
        return path == "device"

    def _lsh_device_tile(self, tile: int, p: int, m_eff: int) -> int:
        """Clamp the serving tile to the probe plan's ``tq``, so every tile
        fits one device dispatch rather than degrading to the host rung."""
        pplan = probe_kernels.plan_probe(
            min(int(tile), 1024), max(int(self._buckets.n), 1),
            self.band_plan.bands, self.band_plan.band_bits, p, m_eff,
        )
        if pplan is not None:
            tile = min(int(tile), pplan.tq)
        return int(tile)

    def _lsh_device_csr(self):
        """The banded CSR on the index's device: ``indptr`` ``(bands, 2^b +
        1)`` int32 (ids are int32, so offsets fit) and ``ids`` ``(bands,
        n)`` int32 (every row keys into every band, so each band holds
        exactly ``n`` ids).  Cached against the bucket revision; an upload
        emits ``index.lsh.device_upload``."""
        cached = self._lsh_dev_csr
        if cached is not None and cached[0] == self._lsh_dev_rev:
            return cached[1], cached[2]
        t0 = time.perf_counter()
        b = self._buckets
        indptr = np.stack([ip.astype(np.int32) for ip in b._indptr])
        ids = np.stack(b._ids)
        indptr_dev = self._to_device(indptr)
        ids_dev = self._to_device(ids)
        self._lsh_dev_csr = (self._lsh_dev_rev, indptr_dev, ids_dev)
        telemetry.registry().counter_inc("index.lsh.device.uploads")
        if telemetry.enabled():
            telemetry.emit(
                EVENTS.INDEX_LSH_DEVICE_UPLOAD, rows=int(b.n),
                bands=self.band_plan.bands, band_bits=self.band_plan.band_bits,
                bytes=int(indptr.nbytes + ids.nbytes),
                wall_s=round(time.perf_counter() - t0, 6),
            )
        return indptr_dev, ids_dev

    def _lsh_device_dead(self):
        """The full tombstone plane on the device (``(n_codes,)`` uint8,
        zeros when nothing is deleted), cached against the ``(n_codes,
        tombstone revision)`` pair."""
        key = (int(self.n_codes), int(self._dead_rev))
        cached = self._lsh_dev_dead
        if cached is not None and cached[0] == key:
            return cached[1]
        if self._dead is None:
            dead = np.zeros(self.n_codes, np.uint8)
        else:
            dead = self._dead.astype(np.uint8)
        dead_dev = self._to_device(dead)
        self._lsh_dev_dead = (key, dead_dev)
        return dead_dev

    def _lsh_device_masks(self, masks: np.ndarray):
        """A ``(1, P)`` int32 probe-mask plane on the device, cached per
        probe count."""
        dev = self._lsh_dev_masks.get(masks.size)
        if dev is None:
            dev = self._to_device(masks.astype(np.int32)[None, :])
            self._lsh_dev_masks[masks.size] = dev
        return dev

    def _lsh_device_ones(self, nq: int):
        """A ``(1, nq)`` int32 all-active plane on the device, cached per
        tile height."""
        import torch

        dev = self._lsh_dev_active.get(nq)
        if dev is None:
            dev = torch.ones((1, nq), dtype=torch.int32, device=self.device)
            self._lsh_dev_active[nq] = dev
        return dev

    def _lsh_chunk_planes(self) -> list:
        return [(c.b, c.row0, c.n) for c in self._chunks]

    def _lsh_graph_key(self, nq: int, n_probes: int, cap: int,
                       m_eff: int) -> tuple:
        """The key of a captured tile: every shape the composite depends on
        (tile rows, width, probes, ``cap``, ``m``, band plan, corpus size,
        chunk layout) and the index state baked into it (CSR and tombstone
        revisions, chunk tensors)."""
        return (int(nq), self.n_bytes, int(n_probes), int(cap), int(m_eff),
                self.band_plan.bands, self.band_plan.band_bits,
                int(self.n_codes), self._lsh_dev_rev, self._dead_rev,
                tuple((c.row0, c.n, c.b.data_ptr()) for c in self._chunks))

    def _lsh_device_composite(self, q, masks_dev, act_dev, m_eff: int,
                              cap: int, fetch):
        """One tile through ``device_probe_topk`` on the index's device;
        returns ``fetch(dist, gid, stats, counts)``.  On a card the tile is
        one replay of its key's CUDA graph (captured at the key's first
        tile) and ``fetch`` runs under the cache's lock; there is no eager
        route on a card.  ``q`` is the host tile (or a tensor)."""
        indptr_dev, ids_dev = self._lsh_device_csr()
        dead_dev = self._lsh_device_dead()
        chunks = self._lsh_chunk_planes()
        bb = self.band_plan.band_bits
        if self.device.type == "cuda":
            key = self._lsh_graph_key(q.shape[0], masks_dev.shape[1], cap,
                                      m_eff)
            return self._lsh_graphs.run(
                key, self._staged(q), masks_dev, act_dev, indptr_dev, ids_dev,
                dead_dev, chunks, m_eff, cap=cap, band_bits=bb, fetch=fetch,
            )
        return fetch(*probe_kernels.device_probe_topk(
            self._to_device(q), masks_dev, act_dev, indptr_dev, ids_dev,
            dead_dev, chunks, m_eff, cap=cap, band_bits=bb,
        ))

    @staticmethod
    def _staged(a):
        """A host tile as a pinned tensor, copied to the card by the
        replay's input copy (one non-blocking copy); a tensor as it is."""
        import torch

        if isinstance(a, torch.Tensor):
            return a
        return torch.from_numpy(np.ascontiguousarray(a)).pin_memory()

    def _lsh_device_cap(self, a, masks: np.ndarray, m_eff: int, *,
                        planned: bool = True) -> Optional[int]:
        """The slot budget of one device dispatch of tile ``a`` with
        ``masks``.  Where the reference's planner tiles the shape, its
        ``cap``: the overflow verdict that cap gives is part of the
        reference's answer.  Elsewhere (the planner's TPU budget refuses
        the shape, or ``planned`` is False) the runs' exact total, counted
        on the host CSR, sizes it (``probe_kernels.runs_cap``): such a
        dispatch cannot overflow and answers as the host rung does, on the
        card.  None when the runs pass ``probe_kernels.MAX_CAP``."""
        nq = int(a.shape[0])
        if planned:
            pplan = probe_kernels.plan_probe(
                nq, int(self._buckets.n), self.band_plan.bands,
                self.band_plan.band_bits, int(masks.size), m_eff,
            )
            if pplan is not None and pplan.tq >= nq:
                return pplan.cap
        total = self._buckets.gathered(
            band_keys(_host_rows(a), self.band_plan), masks)
        cap = probe_kernels.runs_cap(total, m_eff)
        return cap if cap <= probe_kernels.MAX_CAP else None

    def _lsh_device_dispatch_tile(self, a, m_eff: int, masks: np.ndarray,
                                  p: int, tile: int, *, planned: bool = True):
        """One device-rung dispatch: upload the queries (the only per-tile
        host bytes), launch the probe → dedup → gather → re-rank composite
        and start the copies to the host.  Returns ``('lsh_dev',
        payload)``, or, when the runs pass what one dispatch holds
        (fallback reason ``device_budget``), ``('exact', handles)`` of the
        exact path.  ``planned`` as ``_lsh_device_cap``."""
        nq = int(a.shape[0])
        reg = telemetry.registry()
        t0 = time.perf_counter()
        cap = self._lsh_device_cap(a, masks, m_eff, planned=planned)
        if cap is None:
            reg.counter_inc("index.lsh.fallbacks")
            telemetry.emit(
                EVENTS.INDEX_LSH_FALLBACK, reason="device_budget", queries=nq,
                probes=int(p), n_live=int(self.n_live),
                threshold=self.fallback_density,
            )
            return "exact", self._topk_dispatch_tile(a, m_eff)
        masks_dev = self._lsh_device_masks(masks)
        act_dev = self._lsh_device_ones(nq)
        # the device rung's host wall: sizing and upload prep only
        reg.observe("index.lsh.probe.host_s", time.perf_counter() - t0)
        t1 = time.perf_counter()
        # the copies to the host are queued right behind the tile's work on
        # the same stream: the next replay of the same graph (the next tile
        # of the pipeline) overwrites its outputs only after they landed
        fetches = self._lsh_device_composite(
            a, masks_dev, act_dev, m_eff, cap,
            fetch=lambda d, gid, stat, _cnt: (_HostFetch(d), _HostFetch(gid),
                                              _HostFetch(stat)),
        )
        payload = (*fetches, nq, p, tile, a)
        reg.observe("index.lsh.probe.dispatch_s", time.perf_counter() - t1)
        return "lsh_dev", payload

    def _lsh_finish_device_tile(self, payload, m_eff: int):
        """Wait for one device dispatch and apply the ladder after the
        fact (the candidate count is the dispatch's output): slot overflow
        → ``device_budget``, fewer live candidates than ``m_eff`` →
        ``starved``, a union denser than the threshold → ``dense``; each
        serves the tile through the exact path."""
        d, gid, stat, nq, p, tile, a = payload
        stat = stat.result(None)
        overflow = int(stat[1]) != 0
        n_cand = int(stat[2])
        reg = telemetry.registry()
        dense = n_cand > self.fallback_density * self.n_live
        if overflow or n_cand < m_eff or dense:
            reason = ("device_budget" if overflow
                      else "starved" if n_cand < m_eff else "dense")
            reg.counter_inc("index.lsh.fallbacks")
            telemetry.emit(
                EVENTS.INDEX_LSH_FALLBACK, reason=reason, queries=nq,
                probes=int(p), candidates=n_cand, n_live=int(self.n_live),
                threshold=self.fallback_density,
            )
            return SimHashIndex.query_topk(self, a, m_eff, tile=tile)
        frac = n_cand / max(self.n_live, 1)
        reg.counter_inc("index.lsh.dispatches")
        reg.counter_inc("index.lsh.device.dispatches")
        reg.counter_inc("index.lsh.probe_buckets",
                        nq * self.band_plan.bands * p)
        reg.counter_inc("index.lsh.candidates", n_cand)
        reg.gauge_set("index.lsh.candidate_fraction", frac)
        if telemetry.enabled():
            telemetry.emit(
                EVENTS.INDEX_LSH_DEVICE_DISPATCH, queries=nq, m=int(m_eff),
                probes=int(p), bands=self.band_plan.bands, candidates=n_cand,
                gathered=int(stat[0]), candidate_fraction=round(frac, 6),
            )
        return d.result(None), gid.result(None)

    def _lsh_tile_entry(self, a, m_eff: int, masks: np.ndarray, p: int,
                        tile: int, device: bool, adaptive: bool,
                        budget: Optional[int]):
        """Route one query tile down the ladder: adaptive device rounds →
        the fixed device dispatch, or the host rung when the device rung is
        not asked for (each falls back to the exact path itself).  Where
        the adaptive rounds overflow, the fixed dispatch sized by the
        tile's runs serves: the host rung's answer, on the device.
        Adaptive probing is a device-rung feature: on the host rung the
        fixed ``probes`` serve."""
        if not device:
            return self._lsh_dispatch_tile(a, m_eff, masks)
        if adaptive:
            served = self._lsh_adaptive_tile(a, m_eff, p, tile, budget)
            if served is not None:
                return served
            return self._lsh_device_dispatch_tile(a, m_eff, masks, p, tile,
                                                  planned=False)
        return self._lsh_device_dispatch_tile(a, m_eff, masks, p, tile)

    def _lsh_adaptive_tile(self, a, m_eff: int, p: int, tile: int,
                           budget: Optional[int]):
        """Adaptive per-query probing: host-orchestrated ROUNDS of the
        device dispatch, one per popcount LEVEL of the probe sequence, with
        a per-query active mask: easy queries retire early, hard ones
        escalate toward the ``probes`` ceiling.

        Safe by construction.  (1) After every popcount-``f`` mask was
        probed, a candidate unseen by query ``q`` differs from ``q``'s key
        by ≥ ``f+1`` bits in EVERY band, and bands are disjoint, so its
        distance is ≥ ``bands·(f+1)``: a query whose running m-th distance
        is STRICTLY below that bound is final (strictness covers the tie
        rule).  (2) Rounds merge exactly (``_merge_topm_rows``).  (3) A
        larger budget never retires a query earlier, so recall is monotone
        in ``candidate_budget``.  A truncated last level never exits on
        its own bound.

        Returns None (the caller serves the fixed path) when a level's
        runs pass what one dispatch holds or a round overflows its slots
        (``device_budget``); queries still starved after the last round
        are served exactly (``starved``)."""
        nq = int(a.shape[0])
        bands = self.band_plan.bands
        reg = telemetry.registry()
        masks = self._probe_masks(p)
        pc = np.array([bin(int(x)).count("1") for x in masks], np.int64)
        # level f = the run of masks with popcount f; the ceiling p may
        # truncate the last level
        bnd = np.flatnonzero(np.diff(pc)) + 1
        levels = list(zip(np.concatenate(([0], bnd)),
                          np.concatenate((bnd, [masks.size]))))
        t0 = time.perf_counter()
        caps = [self._lsh_device_cap(a, masks[lo:hi], m_eff)
                for lo, hi in levels]
        if None in caps:
            reg.counter_inc("index.lsh.fallbacks")
            telemetry.emit(
                EVENTS.INDEX_LSH_FALLBACK, reason="device_budget",
                queries=nq, probes=int(p), n_live=int(self.n_live),
                adaptive=True,
            )
            return None
        sent_d = np.int32(self.n_bits + 1)
        best_d = np.full((nq, m_eff), sent_d, np.int32)
        best_g = np.full((nq, m_eff), _INT32_MAX, np.int32)
        active = np.ones(nq, bool)
        used = np.zeros(nq, np.int64)
        yielded = np.zeros(nq, np.int64)
        early_exits = budget_stops = rounds = 0
        live_cands = probe_buckets = 0
        import torch

        q_dev = self._to_device(a)
        reg.observe("index.lsh.probe.host_s", time.perf_counter() - t0)

        def fetch(d, gid, stat, cnt):
            # the round's outputs in one copy to the host
            return torch.cat([stat, d.reshape(-1), gid.reshape(-1), cnt]).cpu()

        for f, (lo, hi) in enumerate(levels):
            if not active.any():
                break
            t1 = time.perf_counter()
            # the round's overflow verdict, merge and exit bound decide the
            # next launch: this wait is the orchestration point
            out = self._lsh_device_composite(
                q_dev, self._to_device(masks[lo:hi].astype(np.int32)[None, :]),
                self._to_device(active.astype(np.int32)[None, :]), m_eff,
                caps[f], fetch,
            ).numpy()
            stat = out[:8]
            nd = out[8: 8 + nq * m_eff].reshape(nq, m_eff)
            ng = out[8 + nq * m_eff: 8 + 2 * nq * m_eff].reshape(nq, m_eff)
            cnt = out[8 + 2 * nq * m_eff:]
            reg.observe("index.lsh.probe.dispatch_s", time.perf_counter() - t1)
            rounds += 1
            reg.counter_inc("index.lsh.device.dispatches")
            if int(stat[1]) != 0:
                reg.counter_inc("index.lsh.fallbacks")
                telemetry.emit(
                    EVENTS.INDEX_LSH_FALLBACK, reason="device_budget",
                    queries=nq, probes=int(hi - lo), n_live=int(self.n_live),
                    adaptive=True,
                )
                return None
            # merge ACTIVE rows only: retired rows stay frozen, which is
            # what makes the budget's superset argument hold
            best_d[active], best_g[active] = _merge_topm_rows(
                best_d[active], best_g[active], nd[active], ng[active],
                int(sent_d),
            )
            used[active] += int(hi - lo)
            yielded[active] += cnt[active]
            live_cands += int(stat[2])
            probe_buckets += int(active.sum()) * bands * int(hi - lo)
            if int(hi - lo) == _level_size(self.band_plan.band_bits, f):
                # a complete level: the bands·(f+1) bound holds
                exiting = active & (best_d[:, m_eff - 1] < bands * (f + 1))
                early_exits += int(exiting.sum())
                active &= ~exiting
            if budget is not None:
                stops = active & (yielded >= budget)
                budget_stops += int(stops.sum())
                active &= ~stops
        starved = best_g[:, m_eff - 1] == _INT32_MAX
        if starved.any():
            reg.counter_inc("index.lsh.fallbacks")
            telemetry.emit(
                EVENTS.INDEX_LSH_FALLBACK, reason="starved",
                queries=int(starved.sum()), probes=int(p),
                n_live=int(self.n_live), adaptive=True,
            )
            sd, si = SimHashIndex.query_topk(
                self, np.ascontiguousarray(_host_rows(a)[starved]), m_eff,
                tile=tile,
            )
            best_d[starved] = sd
            best_g[starved] = si
        frac = live_cands / max(self.n_live, 1)
        reg.counter_inc("index.lsh.dispatches")
        reg.counter_inc("index.lsh.adaptive.tiles")
        reg.counter_inc("index.lsh.probe_buckets", probe_buckets)
        reg.counter_inc("index.lsh.candidates", live_cands)
        reg.gauge_set("index.lsh.candidate_fraction", frac)
        for u in used:
            reg.observe("index.lsh.adaptive.probes_used", float(u))
        if telemetry.enabled():
            telemetry.emit(
                EVENTS.INDEX_LSH_ADAPTIVE, queries=nq, m=int(m_eff),
                probes_ceiling=int(p), rounds=rounds,
                probes_used_mean=round(float(used.mean()), 3),
                probes_used_max=int(used.max()), early_exits=early_exits,
                budget_stops=budget_stops, starved=int(starved.sum()),
                candidates=live_cands, candidate_fraction=round(frac, 6),
            )
        return "done", (best_d, best_g)
