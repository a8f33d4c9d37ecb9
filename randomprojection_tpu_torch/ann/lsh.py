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
  bucket; ``add`` merges new rows incrementally.  It is built and grown
  on the index's device (``probe_kernels.fold_band_csr``: a stable sort a
  band), where the device rung reads it; the host keeps the indptr that
  sizes a tile, and makes its ids and the band keys only when a host path
  reads them.
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

Snapshots: ``save`` spills the band keys beside the chunks
(``durable.save_index``'s extra hook) and ``load_lsh_index`` restores the
tier, verifying the persisted keys against the ones rebuilt from the
codes; a snapshot without keys (a plain index's) rebuilds the bands.

Tiered residency: an index with a budget (``hbm_budget_bytes``) that
holds cold chunks splits each tile's candidate union by residency.  On
the device rung (``_lsh_device_tiered``) K5 and the dedup run on the
device as before, K4 re-ranks the hot slots from the resident chunks,
and under that kernel the host gathers the cold candidate rows and
stages them on a side stream for K4 over the cold side; the two top-m
planes merge on the device under the (distance, lower-global-id) order.
That rung is eager (a graph would bake in the host sync and the staged
rows).  The host rung's re-rank (``_lsh_rerank_tiered``) splits the same
way.  Every promotion, demotion and ``reset`` drops the captured tiles.

The sharded tier, ``LSHShardedSimHashIndex``: a ``ShardedSimHashIndex``
whose shards are ``LSHSimHashIndex``es; a tile probes every shard's bucket
index, each shard re-ranks its own candidates on its own ladder (the
device rung on a card), and the shards' candidates merge through the
exact tier's ``_merge_tile``.  Its snapshots spill the band keys in
global id order (``load_lsh_sharded_index`` restores them onto any
layout).  The reference's host-select rung for a re-rank that overflowed the TPU's
scoped VMEM has no counterpart: the card's kernel plans fit by
construction.

Traced (``utils/observability``): a bucket build's band is the span
``rp:lsh/build``, a call ``rp:lsh/query_topk``, a device-rung tile
``rp:lsh/size_tile``, ``rp:lsh/dispatch_tile``, ``rp:lsh/wait_tile`` and
``rp:lsh/finish_tile``, and each probe launch is counted
(``count_probe``), as is each re-rank's tensor-core scan
(``count_survivors``, from the counts it leaves in the tile's stats).

Telemetry: ``index.lsh.dispatch``, ``index.lsh.fallback`` (with its
reason), ``index.lsh.build``, ``index.lsh.device_dispatch`` and
``index.lsh.adaptive`` events, and the
``index.lsh.*`` counters and ``index.lsh.probe.{host,dispatch}_s``
histograms on the process registry.
"""

from __future__ import annotations

import itertools
import math
import numbers
import os
import time
from typing import Optional

import numpy as np

from randomprojection_tpu_torch.models.sketch import SimHashIndex
from randomprojection_tpu_torch.ops import probe_kernels, topk_kernels
# a tensor's copy to the host, started at dispatch and read tiles behind
from randomprojection_tpu_torch.ops.staging import HostFetch, tile_pipeline
from randomprojection_tpu_torch.serving.sharded_index import ShardedSimHashIndex
from randomprojection_tpu_torch.utils import observability, telemetry
from randomprojection_tpu_torch.utils.observability import annotate
from randomprojection_tpu_torch.utils.telemetry import EVENTS

__all__ = [
    "BandPlan",
    "band_keys",
    "probe_masks",
    "BandedBuckets",
    "LSHSimHashIndex",
    "LSHShardedSimHashIndex",
    "load_lsh_index",
    "load_lsh_sharded_index",
]

# bucket-space ceiling: indptr is 2^b + 1 offsets a band
_MAX_BAND_BITS = 20
# band-key extraction block: bounds the unpacked bit matrix however large
# one add() is
_KEY_EXTRACT_BLOCK = 1 << 16

_PROBE_PATHS = ("auto", "host", "device")

# tiles a query_topk dispatches before it finishes the oldest: a device-rung
# tile of 64 queries over 125M codes takes ~0.7 ms on an H100, so eight
# queued behind the one running keep ~5.5 ms of work on the card against
# the host's stalls (its own work a tile is ~0.4 ms; on an H100's host a
# tile's dispatch now and then stalls for 2-20 ms); each queued tile holds
# only its pinned copies
_TILES_AHEAD = 8


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
    b, bands = plan.band_bits, plan.bands
    out = np.empty((bands, n), np.uint32)
    w = np.uint32(1) << np.arange(b, dtype=np.uint32)
    for lo in range(0, n, _KEY_EXTRACT_BLOCK):
        hi = min(lo + _KEY_EXTRACT_BLOCK, n)
        bits = np.unpackbits(codes[lo:hi], axis=1, bitorder="little")
        # every band at once: a query tile's keys are one product
        sl = bits[:, : bands * b].reshape(hi - lo, bands, b).astype(np.uint32)
        out[:, lo:hi] = (sl * w).sum(axis=2, dtype=np.uint32).T
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

    Per band: ``indptr`` ``(2^b + 1,)`` int64 (a row of ``_indptr``) and
    ``ids`` ``(n,)`` int32,
    counting-sorted by bucket with ids ASCENDING within every bucket (what
    makes candidate unions id-sorted and the re-rank's tie rule exact).

    The CSR is built and grown where it is folded
    (``probe_kernels.fold_band_csr``: a stable sort a band), and lives there
    as ``dev`` (``indptr`` ``(bands, 2^b + 1)`` and ``ids`` ``(bands, n)``,
    int32 tensors), which the device rung reads as they are.  The host
    keeps the indptr, which sizes a tile; the host ``ids`` (the host rung)
    and ``keys`` ``(bands, n)`` uint32 (every row's band keys in id order,
    for a snapshot) are made from ``dev`` and the folded code planes when
    first read."""

    __slots__ = ("plan", "n", "_keys", "_indptr", "_ids", "dev", "_folded",
                 "_probed")

    def __init__(self, plan: BandPlan):
        self.plan = plan
        self.n = 0
        self._keys = np.empty((plan.bands, 0), np.uint32)
        nb = 1 << plan.band_bits
        self._indptr = np.zeros((plan.bands, nb + 1), np.int64)
        self._ids = [np.empty(0, np.int32) for _ in range(plan.bands)]
        self.dev = None
        # the code planes folded, in id order
        self._folded: list = []
        # mask set -> each bucket's probed total a band (``gathered``)
        self._probed: dict = {}

    @property
    def keys(self) -> np.ndarray:
        if self._keys is None:
            self._keys = np.concatenate(
                [_host_band_keys(c, self.plan) for c in self._folded], axis=1)
        return self._keys

    @property
    def ids(self) -> list:
        """Each band's id runs on the host (copied from ``dev`` once)."""
        if self._ids is None:
            self._ids = list(self.dev[1].cpu().numpy())
        return self._ids

    def add(self, codes, device=None) -> int:
        """Fold new rows (local ids ``[n, n+rows)``) into every band's CSR:
        ``codes`` a uint8 host array (copied) or tensor (kept for the
        keys), folded on ``device`` (the codes' own by default; the first
        fold's for every later one).  The host takes the new indptr and
        drops its ids and keys.  Returns the number of rows folded."""
        import torch

        if not isinstance(codes, torch.Tensor):
            codes = torch.from_numpy(np.array(codes, dtype=np.uint8))
        if codes.ndim != 2:
            raise ValueError(
                f"codes must be (n, nbytes), got {tuple(codes.shape)}")
        m = int(codes.shape[0])
        if self.n + m > 2**31 - 1:
            raise ValueError(
                "BandedBuckets ids are int32; "
                f"have {self.n}, adding {m} would overflow"
            )
        if not m:
            return 0
        ip, ids = self.dev if self.dev is not None else (None, None)
        if ids is not None:
            device = ids.device
        self.dev = probe_kernels.fold_band_csr(
            ip, ids, codes if device is None else codes.to(device), self.n,
            self.plan.bands, self.plan.band_bits)
        self._indptr = self.dev[0].cpu().numpy().astype(np.int64)
        self._ids = self._keys = None
        self._probed = {}
        self._folded.append(codes)
        self.n += m
        return m

    def candidates(self, qkeys: np.ndarray, masks: np.ndarray):
        """Union candidate ids of one query tile: bucket ``qkey ^ mask`` of
        every band for every mask, deduplicated across bands, probes and
        the tile's queries.  Returns ``(ids, gathered)``: ``ids`` ascending
        int32, ``gathered`` the count before dedup."""
        parts = []
        gathered = 0
        ids = self.ids
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
            parts.append(ids[j][take])
            gathered += total
        if not parts:
            return np.empty(0, np.int32), 0
        return np.unique(np.concatenate(parts)), gathered

    def gathered(self, qkeys: np.ndarray, masks: np.ndarray) -> int:
        """``candidates``'s ``gathered`` count alone: the probed runs'
        lengths summed, with no id read.  Where a mask set's table of
        every bucket's probed total is small (``_PROBED_TABLE_ENTRIES``),
        one lookup a (query, band) in it, made once a mask set; else two
        lookups a run."""
        table = self._probed_totals(masks)
        if table is not None:
            return int(np.take_along_axis(table, qkeys.astype(np.int64),
                                          1).sum())
        total = 0
        for j in range(self.plan.bands):
            buckets = (
                (qkeys[j][:, None] ^ masks[None, :]).ravel().astype(np.int64)
            )
            indptr = self._indptr[j]
            total += int((indptr[buckets + 1] - indptr[buckets]).sum())
        return total

    def _probed_totals(self, masks: np.ndarray):
        """``(bands, 2^b)`` int32: bucket ``k``'s total over the runs
        ``k ^ mask`` (at most the rows, as the masks are distinct), for
        the last few mask sets; None where the table would pass
        ``_PROBED_TABLE_ENTRIES`` entries of work a band."""
        nb = 1 << self.plan.band_bits
        if masks.size * nb > _PROBED_TABLE_ENTRIES:
            return None
        key = masks.tobytes()
        table = self._probed.get(key)
        if table is None:
            counts = np.diff(self._indptr, axis=1).astype(np.int32)
            table = np.zeros_like(counts)
            for mk in masks:
                table += _xor_buckets(counts, int(mk))
            if len(self._probed) >= 4:
                self._probed.pop(next(iter(self._probed)))
            self._probed[key] = table
        return table

    def bucket_ids(self, band: int, key: int) -> np.ndarray:
        """One bucket's id run (ascending)."""
        indptr = self._indptr[band]
        return self.ids[band][indptr[key]: indptr[key + 1]].copy()


def _xor_buckets(plane: np.ndarray, mask: int) -> np.ndarray:
    """``plane[:, k ^ mask]`` for every bucket ``k`` of a ``(bands, 2^b)``
    plane: a set bit ``i`` of the mask swaps the halves of every block of
    ``2^(i+1)`` buckets (a strided copy, no gather)."""
    bands, nb = plane.shape
    for i in range(nb.bit_length() - 1):
        if mask >> i & 1:
            plane = plane.reshape(bands, -1, 2, 1 << i)[:, :, ::-1]
            plane = plane.reshape(bands, nb)
    return plane


# the work a band (masks x buckets) of the largest probed-total table
# ``BandedBuckets.gathered`` makes: 32 masks of 20-bit bands
_PROBED_TABLE_ENTRIES = 1 << 25

# rows whose band keys cross from the card to the host at once
_HOST_KEYS_BLOCK = 1 << 24


def _host_band_keys(codes, plan: BandPlan) -> np.ndarray:
    """``band_keys`` of a code plane on its device, made there a block of
    rows at a time: ``(bands, n)`` uint32 on the host."""
    n = int(codes.shape[0])
    out = np.empty((plan.bands, n), np.uint32)
    for lo in range(0, n, _HOST_KEYS_BLOCK):
        hi = min(lo + _HOST_KEYS_BLOCK, n)
        for j in range(plan.bands):
            # rplint: allow[RP03] — the keys of a snapshot, made once on the codes' device and copied to the host block by block: a maintenance path, never a query's
            out[j, lo:hi] = probe_kernels.band_key(
                codes[lo:hi], j, plan.band_bits).cpu().numpy().view(np.uint32)
    return out


def _binding_key(b) -> int:
    """A chunk binding's identity in a tile key: a tensor's data pointer
    (what a captured graph bakes in), else the host copy's ``id``."""
    return b.data_ptr() if hasattr(b, "data_ptr") else id(b)


def _packed(stat, d, gid):
    """A device tile's stats and ``(dist, gid)`` planes as one int32 plane,
    for one copy to the host (``_unpacked`` splits it)."""
    import torch

    return torch.cat([stat, d.reshape(-1), gid.reshape(-1)])


def _count_rerank(nq: int, cap: int, n_bytes: int, m: int, stat,
                  device) -> None:
    """Count a device tile's re-rank (``observability.count_survivors``)
    while a profiler records: its query rows times the splits of its K4
    plan, and the keys and merges the scan added to the tile's stats
    (``probe_kernels.rerank_counts``).  A graph replay launches K4 where
    the host does not see it; a tile whose stats carry no keys took its
    re-rank eagerly (the tiered rung), which counts itself."""
    if not observability.recording() or device.type != "cuda":
        return
    keys, merges = probe_kernels.rerank_counts(stat)
    plan = topk_kernels.plan_fused(nq, cap, n_bytes, m,
                                   sm_count=topk_kernels._sm_count(device))
    if keys and plan is not None and plan.route == "wgmma":
        observability.count_survivors(nq * plan.splits, (keys, merges))


def _unpacked(out: np.ndarray, nq: int, m: int):
    """``(stats (8,), dist (nq, m), gid (nq, m))`` of a ``_packed`` plane
    on the host (anything after them is left)."""
    k = nq * m
    return (out[:8], out[8: 8 + k].reshape(nq, m),
            out[8 + k: 8 + 2 * k].reshape(nq, m))


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
    re-rank), and ``compact`` builds it anew over the compacted chunk.
    Single-device: one
    banded index is one shard (``LSHShardedSimHashIndex`` shards a
    corpus)."""

    def __init__(self, codes, *, bands: Optional[int] = None,
                 band_bits: Optional[int] = None, probes: int = 8,
                 fallback_density: float = 0.1, probe_path: str = "auto",
                 adaptive: bool = False,
                 candidate_budget: Optional[int] = None, **kw):
        if kw.get("mesh") is not None:
            raise ValueError(
                "LSHSimHashIndex is single-device (one banded index is "
                "one shard); shard a corpus with ann.LSHShardedSimHashIndex"
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
        self._masks_cache: dict = {}
        # device-side probe state: a revision clock bumped by every bucket
        # mutation (it keys the captured tiles), the tombstone plane the
        # (n_codes, tombstone revision) pair.  Set before the base
        # constructor, whose upload fires the append hook.
        self._lsh_dev_rev = 0
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
        self._lsh_fold(codes)

    def _lsh_buckets_changed(self) -> None:
        """A new bucket revision: the captured tiles bake the CSR in, so
        they go."""
        self._lsh_dev_rev += 1
        self._lsh_graphs.clear()

    def delete(self, ids) -> int:
        """The base ``delete``; new tombstones also drop the captured tiles
        (they bake the tombstone plane in)."""
        newly = super().delete(ids)
        if newly:
            self._lsh_graphs.clear()
        return newly

    def _restore_tombstones(self, dead: np.ndarray) -> None:
        """The base re-arm; the captured tiles bake the tombstone plane in,
        so they go too."""
        super()._restore_tombstones(dead)
        self._lsh_graphs.clear()

    def _residency_changed(self) -> None:
        """A tier swap or reset: the captured tiles bake the chunks' device
        pointers in, so they go."""
        self._lsh_graphs.clear()

    def _lsh_fold(self, codes) -> None:
        """Fold the chunk just appended into the buckets, on the index's
        device.  An untiered index folds the chunk as it lies there; a tier
        moves chunks between the device and the host, so a tiered index
        folds a host copy of the rows (kept for the band keys)."""
        if self._tier is None:
            rows = self._buckets.add(self._chunks[-1].b)
        else:
            rows = self._buckets.add(_host_rows(codes), device=self.device)
        self._lsh_buckets_changed()
        telemetry.registry().counter_inc("index.lsh.builds")
        telemetry.emit(
            EVENTS.INDEX_LSH_BUILD, rows=int(rows), n=int(self._buckets.n),
            bands=self.band_plan.bands, band_bits=self.band_plan.band_bits,
        )

    def _rebuild_from_host(self, codes: np.ndarray) -> None:
        # a wholesale replacement (``compact``) starts the bucket index
        # over; the new chunk's upload folds it anew
        self._buckets = BandedBuckets(self.band_plan)
        self._lsh_buckets_changed()
        super()._rebuild_from_host(codes)

    # -- durable persistence (durable.save_index's extra hook) ----------------

    def _durable_extra(self, dirpath: str, gen: int) -> dict:
        """Manifest extras for ``durable.save_index``: the band keys (id
        order) spilled beside the chunks, checksummed like them, plus the
        band layout and serving knobs."""
        return _spill_lsh_keys(self, dirpath, gen, self._buckets.keys)

    @classmethod
    def load(cls, path: str, *, bands: Optional[int] = None,
             band_bits: Optional[int] = None, probes: Optional[int] = None,
             fallback_density: Optional[float] = None, device=None,
             mesh=None, **kwargs):
        """Restore an LSH index from a snapshot directory — LSH-format or a
        plain index's (the banded index is then rebuilt from the codes).
        See ``load_lsh_index``."""
        if mesh is not None:
            raise ValueError(
                "LSHSimHashIndex is single-device; load a sharded "
                "snapshot with ann.load_lsh_sharded_index"
            )
        return load_lsh_index(
            path, bands=bands, band_bits=band_bits, probes=probes,
            fallback_density=fallback_density, device=device, **kwargs,
        )

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
            # the reference's count of CSR uploads: the port builds the CSR
            # where it serves it, so none happens and the key reads 0
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
        does not matter.

        Traced, a call is the span ``rp:lsh/query_topk`` and a device-rung
        tile ``rp:lsh/size_tile`` (its runs counted on the host),
        ``rp:lsh/dispatch_tile`` (staging, the replay, the copies started),
        ``rp:lsh/wait_tile`` and ``rp:lsh/finish_tile`` (the ladder and
        the copy-out); each probe launch is counted
        (``observability.count_probe``)."""
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

        def dispatch(lo, hi):
            return self._lsh_tile_entry(A[lo:hi], m_eff, masks, p, tile,
                                        device, adaptive_eff, budget_eff)

        def finish(lo, hi, entry):
            out_d[lo:hi], out_i[lo:hi] = _finish_lsh_entry(self, entry, m_eff)

        with annotate("rp:lsh/query_topk"):
            # tiles finish _TILES_AHEAD behind: tile i's copy to the host
            # and its ladder ride under the later tiles' probe and kernels
            tile_pipeline(nq, tile, dispatch, finish, behind=_TILES_AHEAD)
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
                **telemetry.trace_fields(),
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
                **telemetry.trace_fields(),
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
                parts.append(self._resident_codes(c, audit=True)[local])
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def _lsh_rerank_dispatch(self, a, cand: np.ndarray, m_eff: int):
        """The exact re-rank of one tile against its gathered candidates
        with the top-k kernel, and the start of the copies to the host.  A
        tiered index holding cold chunks splits the candidates by
        residency (``_lsh_rerank_tiered``)."""
        a = self._to_device(a)
        if self._tier is not None and self._tier.any_cold():
            return self._lsh_rerank_tiered(a, cand, m_eff)
        return self._lsh_rerank_one(a, cand, self._gather_codes_device(cand),
                                    m_eff)

    @staticmethod
    def _lsh_rerank_one(a, cand: np.ndarray, cand_dev, m_eff: int):
        """One K4 re-rank against one gathered candidate plane (the tile's
        whole union, or one residency side of it)."""
        d, i = topk_kernels.fused_topk(a, cand_dev, int(cand.size), m_eff)
        return HostFetch(d), HostFetch(i), cand

    def _lsh_rerank_tiered(self, a, cand: np.ndarray, m_eff: int):
        """The tiered re-rank: split the candidate union by chunk residency,
        gather the cold rows on the host (a RAM read for the host tier,
        the touched pages for a disk memmap), start their upload on the
        side stream FIRST, launch the hot side's K4 (the upload runs under
        it), then the cold side's K4 on the landed rows.  Each side selects
        its own top-``min(m_eff, side)`` and ``_lsh_finish_tile`` merges
        the planes: exact by the union-of-top-m identity, and full because
        the starved gate already guaranteed ``|hot| + |cold| ≥ m_eff``.  A
        failed upload degrades to a synchronous one (fallback audit)."""
        import torch

        from randomprojection_tpu_torch.tiering import host_view, is_resident

        tier = self._tier
        t0 = time.perf_counter()
        per_chunk: dict = {}
        hot_ids, hot_parts, cold_ids, cold_parts = [], [], [], []
        for c in self._chunks:
            lo = np.searchsorted(cand, c.row0)
            hi = np.searchsorted(cand, c.row0 + c.n)
            if hi <= lo:
                continue
            per_chunk[c.row0] = int(hi - lo)
            local = (cand[lo:hi] - c.row0).astype(np.int64)
            b = c.b  # one read: the worker may swap the binding
            if self.device.type == "cuda":
                hot = is_resident(b, self.device)
            else:
                hot = tier.chunk_is_hot(c) and is_resident(b, self.device)
            if hot:
                hot_ids.append(cand[lo:hi])
                hot_parts.append(b[self._to_device(local)])
            else:
                cold_ids.append(cand[lo:hi])
                # rplint: allow[RP09] — host gather of a host-resident cold chunk: host_view's .numpy() views a CPU tensor (or passes a memmap on), no device sync
                cold_parts.append(host_view(b)[local])
        cand_hot = (np.concatenate(hot_ids) if hot_ids
                    else np.empty(0, cand.dtype))
        cand_cold = (np.concatenate(cold_ids) if cold_ids
                     else np.empty(0, cand.dtype))
        tier.note_gather(int(cand_hot.size), int(cand_cold.size), per_chunk)
        hot_dev = None
        if hot_parts:
            hot_dev = hot_parts[0] if len(hot_parts) == 1 else torch.cat(hot_parts)
        if cand_cold.size == 0:
            # the whole union is resident (a promotion raced the check)
            return self._lsh_rerank_one(a, cand, hot_dev, m_eff)
        cold_rows = (cold_parts[0] if len(cold_parts) == 1
                     else np.concatenate(cold_parts, axis=0))
        sync = False
        try:
            cold_dev, ev = topk_kernels.stage_rows(cold_rows, device=self.device)
        except Exception as e:
            tier.note_fallback(f"upload:{type(e).__name__}",
                               rows=int(cand_cold.size))
            sync = True
            cold_dev, ev = self._sync_upload(cold_rows), None
        wall_s = time.perf_counter() - t0
        t_staged = time.perf_counter()
        hot_payload, m_hot = None, 0
        if cand_hot.size:
            # the hot side's kernel is launched while the cold rows go up
            m_hot = int(min(m_eff, cand_hot.size))
            hot_payload = self._lsh_rerank_one(a, cand_hot, hot_dev, m_hot)
        overlap_s = 0.0 if sync else time.perf_counter() - t_staged
        topk_kernels.wait_staged(cold_dev, ev)
        m_cold = int(min(m_eff, cand_cold.size))
        cold_payload = self._lsh_rerank_one(a, cand_cold, cold_dev, m_cold)
        tier.note_fetch(rows=int(cand_cold.size),
                        nbytes=int(cand_cold.size) * self.n_bytes,
                        wall_s=wall_s, overlap_s=overlap_s,
                        source=tier.cold_tier, sync=sync)
        return ("tiered", (hot_payload, m_hot), (cold_payload, m_cold))

    def _lsh_finish_tile(self, payload, m_eff: int):
        """Wait for one re-rank and map candidate positions back to global
        ids: ``cand`` is ascending, so the kernel's lower-position tie rule
        is the lower-global-id rule.  A ``'tiered'`` payload finishes each
        residency side the same way and merges the two under the
        (distance, lower-global-id) order (``topk_kernels.merge_topm``);
        the sides are disjoint, and together at least ``m_eff`` wide."""
        if payload[0] == "tiered":
            _, (hp, m_hot), (cp, m_cold) = payload
            cd, ci = self._lsh_finish_tile(cp, m_cold)
            if hp is None:
                return cd, ci  # all cold: the gate gave m_cold == m_eff
            hd, hi_ = self._lsh_finish_tile(hp, m_hot)
            return topk_kernels.merge_topm([hd, cd], [hi_, ci], m_eff)
        d, i, cand = payload
        return d.result(None), cand[i.result(None)].astype(np.int32)

    # -- the device rung ---------------------------------------------------------

    def _lsh_probe_device(self, probe_path: Optional[str]) -> bool:
        """The per-call probe path: ``'device'`` runs the device rung (its
        plain version on a CPU index), ``'host'`` the host rung, ``'auto'``
        the device rung for an index on a card."""
        path = (self.probe_path if probe_path is None
                else _check_probe_path(probe_path))
        if path == "host":
            return False
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
        """The banded CSR on the index's device, where it is built:
        ``indptr`` ``(bands, 2^b + 1)`` int32 (ids are int32, so offsets
        fit) and ``ids`` ``(bands, n)`` int32 (every row keys into every
        band, so each band holds exactly ``n`` ids).  A query reaches it
        only once a row is folded (an empty index refuses first)."""
        return self._buckets.dev

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
        return [(self._resident_codes(c, audit=True), c.row0, c.n)
                for c in self._chunks]

    def _lsh_graph_key(self, nq: int, n_probes: int, cap: int,
                       m_eff: int) -> tuple:
        """The key of a captured tile: every shape the composite depends on
        (tile rows, width, probes, ``cap``, ``m``, band plan, corpus size,
        chunk layout) and the index state baked into it (CSR and tombstone
        revisions, chunk tensors)."""
        return (int(nq), self.n_bytes, int(n_probes), int(cap), int(m_eff),
                self.band_plan.bands, self.band_plan.band_bits,
                int(self.n_codes), self._lsh_dev_rev, self._dead_rev,
                tuple((c.row0, c.n, _binding_key(c.b)) for c in self._chunks))

    def _lsh_device_composite(self, q, masks_dev, act_dev, m_eff: int,
                              cap: int, fetch):
        """One tile through ``device_probe_topk`` on the index's device;
        returns ``fetch(dist, gid, stats, counts)``.  On a card the tile is
        one replay of its key's CUDA graph (captured at the key's first
        tile) and ``fetch`` runs under the cache's lock; the one eager
        route on a card is an index holding cold chunks
        (``_lsh_device_tiered``).  ``q`` is the host tile (or a tensor)."""
        if self._tier is not None and self._tier.any_cold():
            return fetch(*self._lsh_device_tiered(q, masks_dev, act_dev, m_eff,
                                                  cap))
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

    def _lsh_device_tiered(self, q, masks_dev, act_dev, m_eff: int, cap: int):
        """The device rung of an index holding cold chunks, eager: band
        keys, K5 and the slot sort on the device as ``device_probe_topk``
        runs them, then the live slots split by residency.  The slot ids
        and their sides start to the host, K4 re-ranks the hot slots
        gathered from the resident chunks, and under that kernel the host
        gathers the cold candidate rows (a RAM read for the host tier, the
        touched pages of a disk memmap) and stages them on the side stream
        for K4 over the cold side.  The two top-``m`` planes merge on the
        device under the (distance, lower-global-id) order; they are
        disjoint, so the merge is exact.  Returns ``(dist, gid, stats,
        counts)`` as ``device_probe_topk`` does.  A failed upload degrades
        to a synchronous one (fallback audit)."""
        import torch

        from randomprojection_tpu_torch.tiering import host_view, is_resident

        tier = self._tier
        q = self._to_device(q)
        indptr_dev, ids_dev = self._lsh_device_csr()
        hot, cold = [], []
        for c in self._chunks:
            b = c.b  # one read: the worker may swap the binding
            if is_resident(b, self.device) and (self.device.type == "cuda"
                                                or tier.chunk_is_hot(c)):
                hot.append((b, c.row0, c.n))
            else:
                cold.append((b, c.row0, c.n))
        s, sc, dead, stat, cnt = probe_kernels.device_probe_slots(
            q, masks_dev, act_dev, indptr_dev, ids_dev,
            self._lsh_device_dead(), cap=cap,
            band_bits=self.band_plan.band_bits)
        in_hot = torch.zeros_like(dead)
        for _, row0, n in hot:
            in_hot |= (sc >= row0) & (sc < row0 + n)
        live = ~dead
        # each slot's side (0 dead, 1 hot, 2 cold), to the host with the ids
        # ahead of the hot side's kernel
        side = live.to(torch.int32) + (live & ~in_hot).to(torch.int32)
        ids_h, side_h = HostFetch(s), HostFetch(side)
        sent = topk_kernels.empty_dist(self.n_bits)
        if hot:
            d, gid = probe_kernels.rerank_slots(
                q, probe_kernels.gather_rows(hot, sc), s, ~(live & in_hot),
                m_eff)
        else:
            d = torch.full((q.shape[0], m_eff), sent, dtype=torch.int32,
                           device=self.device)
            gid = torch.full_like(d, topk_kernels.EMPTY_ID)
        ids_np, side_np = ids_h.result(None), side_h.result(None)
        t0 = time.perf_counter()
        cand = ids_np[side_np > 0].astype(np.int64)
        cold_ids = ids_np[side_np == 2].astype(np.int64)
        per_chunk = {}
        for c in self._chunks:
            k = int(np.searchsorted(cand, c.row0 + c.n)
                    - np.searchsorted(cand, c.row0))
            if k:
                per_chunk[c.row0] = k
        tier.note_gather(int(cand.size - cold_ids.size), int(cold_ids.size),
                         per_chunk)
        if cold_ids.size == 0:
            return d, gid, stat, cnt
        parts = []
        for b, row0, n in cold:
            lo, hi = np.searchsorted(cold_ids, (row0, row0 + n))
            if hi > lo:
                # rplint: allow[RP09] — host gather of a host-resident cold chunk: host_view's .numpy() views a CPU tensor (or passes a memmap on), no device sync
                parts.append(host_view(b)[cold_ids[lo:hi] - row0])
        rows = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
        sync = False
        try:
            rows_dev, ev = topk_kernels.stage_rows(rows, device=self.device)
        except Exception as e:
            tier.note_fallback(f"upload:{type(e).__name__}",
                               rows=int(cold_ids.size))
            sync = True
            rows_dev, ev = self._sync_upload(rows), None
        wall_s = time.perf_counter() - t0
        t_staged = time.perf_counter()
        gid_dev = self._to_device(cold_ids.astype(np.int32))
        topk_kernels.wait_staged(rows_dev, ev)
        m_cold = int(min(m_eff, cold_ids.size))
        cd, ci = topk_kernels.fused_topk(q, rows_dev, int(cold_ids.size), m_cold)
        cg = gid_dev[ci.long()]
        if m_cold < m_eff:
            pad = (0, m_eff - m_cold)
            cd = torch.nn.functional.pad(cd, pad, value=sent)
            cg = torch.nn.functional.pad(cg, pad, value=topk_kernels.EMPTY_ID)
        key = torch.cat([(d.long() << 32) | gid.long(),
                         (cd.long() << 32) | cg.long()], dim=1)
        key = torch.sort(key, dim=1).values[:, :m_eff]
        tier.note_fetch(rows=int(cold_ids.size),
                        nbytes=int(cold_ids.size) * self.n_bytes,
                        wall_s=wall_s,
                        overlap_s=0.0 if sync else time.perf_counter() - t_staged,
                        source=tier.cold_tier, sync=sync)
        return ((key >> 32).to(torch.int32),
                (key & 0x7FFFFFFF).to(torch.int32), stat, cnt)

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
        with annotate("rp:lsh/size_tile"):
            cap = self._lsh_device_cap(a, masks, m_eff, planned=planned)
        if cap is None:
            reg.counter_inc("index.lsh.fallbacks")
            telemetry.emit(
                EVENTS.INDEX_LSH_FALLBACK, reason="device_budget", queries=nq,
                probes=int(p), n_live=int(self.n_live),
                threshold=self.fallback_density,
                **telemetry.trace_fields(),
            )
            return "exact", self._topk_dispatch_tile(a, m_eff)
        with annotate("rp:lsh/dispatch_tile"):
            masks_dev = self._lsh_device_masks(masks)
            act_dev = self._lsh_device_ones(nq)
            # the device rung's host wall: sizing and upload prep only
            reg.observe("index.lsh.probe.host_s", time.perf_counter() - t0)
            t1 = time.perf_counter()
            # the tile's stats and planes go to the host as one copy, queued
            # right behind its work on the same stream: the next replay of
            # the same graph (the next tile of the pipeline) overwrites its
            # outputs only after they landed
            fetch = self._lsh_device_composite(
                a, masks_dev, act_dev, m_eff, cap,
                fetch=lambda d, gid, stat, _cnt: HostFetch(_packed(
                    stat, d, gid)),
            )
        payload = (fetch, nq, p, tile, a, cap)
        reg.observe("index.lsh.probe.dispatch_s", time.perf_counter() - t1)
        return "lsh_dev", payload

    def _lsh_finish_device_tile(self, payload, m_eff: int):
        """Wait for one device dispatch and apply the ladder after the
        fact (the candidate count is the dispatch's output): slot overflow
        → ``device_budget``, fewer live candidates than ``m_eff`` →
        ``starved``, a union denser than the threshold → ``dense``; each
        serves the tile through the exact path."""
        fetch, nq, p, tile, a, cap = payload
        with annotate("rp:lsh/wait_tile"):
            out = fetch.result(None)
        with annotate("rp:lsh/finish_tile"):
            stat, d, gid = _unpacked(out, nq, m_eff)
            observability.count_probe(nq, self.band_plan.bands, p, stat[0], cap)
            _count_rerank(nq, cap, self.n_bytes, m_eff, stat, self.device)
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
                    **telemetry.trace_fields(),
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
                    **telemetry.trace_fields(),
                )
            return d, gid

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
        rule).  (2) Rounds merge exactly (``topk_kernels.merge_topm``,
        repeated candidates kept once).  (3) A
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
                **telemetry.trace_fields(),
            )
            return None
        best_d = np.full((nq, m_eff), topk_kernels.empty_dist(self.n_bits),
                         np.int32)
        best_g = np.full((nq, m_eff), topk_kernels.EMPTY_ID, np.int32)
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
            return torch.cat([_packed(stat, d, gid), cnt]).cpu()

        for f, (lo, hi) in enumerate(levels):
            if not active.any():
                break
            t1 = time.perf_counter()
            # rplint: allow[RP03] — host-orchestrated round: the round's overflow verdict, merge and exit bound decide whether and what the NEXT level launches, so this wait IS the orchestration point
            out = self._lsh_device_composite(
                q_dev, self._to_device(masks[lo:hi].astype(np.int32)[None, :]),
                self._to_device(active.astype(np.int32)[None, :]), m_eff,
                caps[f], fetch,
            ).numpy()
            stat, nd, ng = _unpacked(out, nq, m_eff)
            observability.count_probe(nq, bands, hi - lo, stat[0], caps[f])
            _count_rerank(nq, caps[f], self.n_bytes, m_eff, stat, self.device)
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
                    **telemetry.trace_fields(),
                )
                return None
            # merge ACTIVE rows only: retired rows stay frozen, which is
            # what makes the budget's superset argument hold
            best_d[active], best_g[active] = topk_kernels.merge_topm(
                [best_d[active], nd[active]], [best_g[active], ng[active]],
                m_eff, dedup=True, n_bits=self.n_bits,
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
        starved = best_g[:, m_eff - 1] == topk_kernels.EMPTY_ID
        if starved.any():
            reg.counter_inc("index.lsh.fallbacks")
            telemetry.emit(
                EVENTS.INDEX_LSH_FALLBACK, reason="starved",
                queries=int(starved.sum()), probes=int(p),
                n_live=int(self.n_live), adaptive=True,
                **telemetry.trace_fields(),
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
                **telemetry.trace_fields(),
            )
        return "done", (best_d, best_g)


# -- the sharded tier ------------------------------------------------------------


class LSHShardedSimHashIndex(ShardedSimHashIndex):
    """``ShardedSimHashIndex`` whose shards carry banded multi-probe LSH
    tiers: a query tile probes every shard's bucket index, each shard
    re-ranks its own candidates exactly on its own ladder (a dense shard
    falls back to its exact path while the others stay on their rung), and
    the shards' candidates merge through the exact tier's ``_merge_tile``,
    so cross-shard tombstones, int64 global ids and ``id_offset`` behave
    as there, and full probe coverage equals ``topk_bruteforce`` on the
    concatenated corpus bit for bit.

    It plugs into ``ShardedTopKServer`` as it is; ``probes`` at
    construction is the serving default, ``query_topk(probes=)``
    overrides it, 0 is the exact path."""

    def __init__(self, codes, *, bands: Optional[int] = None,
                 band_bits: Optional[int] = None, probes: int = 8,
                 fallback_density: float = 0.1, probe_path: str = "auto",
                 adaptive: bool = False,
                 candidate_budget: Optional[int] = None, **kw):
        self.probes = _check_ctor_probes(probes)
        if not 0.0 < float(fallback_density) <= 1.0:
            raise ValueError(
                f"fallback_density must be in (0, 1], got {fallback_density!r}"
            )
        self.fallback_density = float(fallback_density)
        self.probe_path = _check_probe_path(probe_path)
        self.adaptive = bool(adaptive)
        self.candidate_budget = _check_budget(candidate_budget)
        self._lsh_cfg = (bands, band_bits)
        super().__init__(codes, **kw)
        self.band_plan = self._shards[0].band_plan

    def _make_shard(self, s: int, dev):
        bands, band_bits = self._lsh_cfg
        return LSHSimHashIndex(
            np.empty((0, self.n_bytes), np.uint8),
            n_bits=self.n_bits, device=dev,
            label=f"shard {s}/{len(self._devices)} on {dev}",
            bands=bands, band_bits=band_bits, probes=self.probes,
            fallback_density=self.fallback_density,
            probe_path=self.probe_path, adaptive=self.adaptive,
            candidate_budget=self.candidate_budget,
            **self._tier_kwargs(s),
        )

    def _lsh_global_keys(self) -> np.ndarray:
        """Every row's band keys in global id order: the layout-agnostic
        durable state (the segments place each shard's local key columns
        at their global positions)."""
        out = np.empty((self.band_plan.bands, self.n_codes), np.uint32)
        for seg in self._segments:
            ks = self._shards[seg.shard]._buckets.keys
            out[:, seg.g0: seg.g0 + seg.rows] = ks[:, seg.l0: seg.l0 + seg.rows]
        return out

    def _durable_extra(self, dirpath: str, gen: int) -> dict:
        return _spill_lsh_keys(self, dirpath, gen, self._lsh_global_keys())

    @classmethod
    def load(cls, path: str, *, mesh=None, devices=None,
             n_shards: Optional[int] = None, data_axis: str = "data",
             bands: Optional[int] = None,
             band_bits: Optional[int] = None,
             probes: Optional[int] = None,
             fallback_density: Optional[float] = None):
        """Restore onto any shard layout, from an LSH or a plain snapshot,
        sharded or not.  See ``load_lsh_sharded_index``."""
        return load_lsh_sharded_index(
            path, mesh=mesh, devices=devices, n_shards=n_shards,
            data_axis=data_axis, bands=bands,
            band_bits=band_bits, probes=probes,
            fallback_density=fallback_density,
        )

    def query_topk(self, A, m: int, *, tile: int = 2048,
                   probes: Optional[int] = None,
                   probe_path: Optional[str] = None,
                   adaptive: Optional[bool] = None,
                   candidate_budget: Optional[int] = None):
        """Top-``m`` across every shard: each shard's candidate tier and
        exact re-rank, then the (distance, lower-global-id) cross-shard
        merge.  The exact tier's contract (``dist`` int32, ``idx`` int64
        global ids, ``m_eff = min(m, n_live)``); ``probe_path``,
        ``adaptive`` and ``candidate_budget`` drive every shard's ladder
        as on ``LSHSimHashIndex.query_topk``."""
        p = _check_probes(probes, self.probes)
        if p == 0:
            return super().query_topk(A, m, tile=tile)
        A, m_eff = self._check_query(A, m)
        device = self._shards[0]._lsh_probe_device(probe_path)
        adaptive_eff = self.adaptive if adaptive is None else bool(adaptive)
        budget_eff = (self.candidate_budget if candidate_budget is None
                      else _check_budget(candidate_budget))
        live = self._live_shards(m_eff)
        # the shards share one band plan, so shard 0's mask cache serves
        masks = self._shards[0]._probe_masks(p)
        if device:
            # one tile feeds every shard, so it clamps to the tightest
            # shard's probe plan
            for si, m_s in live:
                tile = self._shards[si]._lsh_device_tile(tile, p, m_s)

        def dispatch(shard, a, m_s):
            return shard._lsh_tile_entry(a, m_s, masks, p, tile, device,
                                         adaptive_eff, budget_eff)

        return self._serve_tiles(A, m_eff, live, tile, dispatch,
                                 _finish_lsh_entry)


def _finish_lsh_entry(shard, entry, m_s: int):
    """Finish one ``_lsh_tile_entry`` of an index (a shard, in the sharded
    tier): ``(dist, local id)``."""
    kind, payload = entry
    if kind == "lsh":
        return shard._lsh_finish_tile(payload, m_s)
    if kind == "lsh_dev":
        return shard._lsh_finish_device_tile(payload, m_s)
    if kind == "exact":
        return shard._topk_finish_tile(payload, m_s)
    return payload  # 'done': served whole (adaptive rounds)


# -- durable spill and restore -------------------------------------------------


def _spill_lsh_keys(index, dirpath: str, gen: int, keys: np.ndarray) -> dict:
    """THE ``lsh`` manifest block: write the keys spill atomically beside
    the chunks and return the checksummed entry plus the band layout and
    serving knobs."""
    from randomprojection_tpu_torch import durable

    fname = f"lsh-{gen:06d}.npy"
    durable._write_npy_atomic(os.path.join(dirpath, fname), keys)
    return {"lsh": {
        "file": fname,
        "sha256": durable._sha256(keys),
        "rows": int(keys.shape[1]),
        "bands": index.band_plan.bands,
        "band_bits": index.band_plan.band_bits,
        "probes": index.probes,
        "fallback_density": index.fallback_density,
    }}


def _resolve_lsh_kwargs(manifest: dict, bands, band_bits, probes,
                        fallback_density):
    """Band layout / serving knobs for a restore: explicit kwargs win, the
    manifest's ``lsh`` block fills the gaps, the library defaults the rest
    (a snapshot without keys)."""
    meta = manifest.get("lsh") or {}
    kw = {
        "bands": meta.get("bands") if bands is None else int(bands),
        "band_bits": (
            meta.get("band_bits") if band_bits is None else int(band_bits)
        ),
        "probes": (
            int(meta.get("probes", 8)) if probes is None else int(probes)
        ),
        "fallback_density": (
            float(meta.get("fallback_density", 0.1))
            if fallback_density is None
            else float(fallback_density)
        ),
    }
    return kw, meta


def _verify_lsh_keys(dirpath: str, meta: dict, plan: BandPlan,
                     keys: np.ndarray) -> None:
    """Hold the keys rebuilt from the restored codes to the snapshot's
    spill: present with the same band layout → bit for bit (checksum
    first), else ``ValueError``.  Absent (a snapshot without keys) or
    re-banded by the caller → the rebuild stands on its own."""
    if not meta:
        telemetry.emit(
            EVENTS.INDEX_LSH_BUILD, path=dirpath, rows=int(keys.shape[1]),
            n=int(keys.shape[1]), bands=plan.bands,
            band_bits=plan.band_bits, rebuilt="pre-lsh-snapshot",
        )
        return
    if meta.get("bands") != plan.bands or meta.get("band_bits") != plan.band_bits:
        return
    from randomprojection_tpu_torch import durable

    arr = durable._load_chunk_verified(dirpath, meta)
    if arr.shape != keys.shape or arr.dtype != np.uint32:
        raise ValueError(
            f"persisted LSH band keys in {dirpath} have shape "
            f"{arr.shape}/{arr.dtype}, expected {keys.shape}/uint32"
        )
    if not np.array_equal(arr, keys):
        raise ValueError(
            f"persisted LSH band keys in {dirpath} disagree with keys "
            "rebuilt from the restored codes — the snapshot is corrupt or "
            "the key extraction drifted; refusing to serve a wrong bucket "
            "index"
        )


def load_lsh_index(path: str, *, bands: Optional[int] = None,
                   band_bits: Optional[int] = None,
                   probes: Optional[int] = None,
                   fallback_density: Optional[float] = None, device=None,
                   **kwargs) -> LSHSimHashIndex:
    """Restore a single-device LSH index from a snapshot directory onto
    ``device`` (None: the card).

    LSH-format snapshots restore their band layout and serving knobs from
    the manifest, and the persisted keys are verified bit for bit against
    the rebuild; a plain index's snapshot rebuilds the banded index from
    the codes (explicit kwargs or the defaults pick the layout).  Chunk
    checksums, coverage and tombstones verify as ``durable.load_index``.
    ``kwargs`` are further constructor options (``probe_path``, ...)."""
    from randomprojection_tpu_torch import durable

    manifest = durable.read_manifest(path)
    kw, meta = _resolve_lsh_kwargs(
        manifest, bands, band_bits, probes, fallback_density
    )
    index = durable.load_index(
        path, device=device, index_cls=LSHSimHashIndex,
        index_kwargs={**kwargs, **kw},
    )
    _verify_lsh_keys(path, meta, index.band_plan, index._buckets.keys)
    return index


def load_lsh_sharded_index(path: str, *, mesh=None, devices=None,
                           n_shards: Optional[int] = None,
                           data_axis: str = "data",
                           bands: Optional[int] = None,
                           band_bits: Optional[int] = None,
                           probes: Optional[int] = None,
                           fallback_density: Optional[float] = None
                           ) -> LSHShardedSimHashIndex:
    """Restore a sharded LSH index onto any shard layout: the corpus
    re-shards balanced, each shard rebuilds its banded index over its
    local rows, and the snapshot's keys (global id order) are verified
    against the rebuilt global view, so the buckets are the same whatever
    layout wrote or reads the snapshot.  A snapshot without keys (a plain
    or an older one) loads with the bands rebuilt."""
    from randomprojection_tpu_torch import durable

    manifest = durable.read_manifest(path)
    kw, meta = _resolve_lsh_kwargs(
        manifest, bands, band_bits, probes, fallback_density
    )
    index = durable.load_sharded_index(
        path, mesh=mesh, devices=devices, n_shards=n_shards,
        data_axis=data_axis, index_cls=LSHShardedSimHashIndex, index_kwargs=kw,
    )
    _verify_lsh_keys(path, meta, index.band_plan, index._lsh_global_keys())
    return index
