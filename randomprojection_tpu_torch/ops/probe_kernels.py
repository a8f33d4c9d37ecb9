"""Device-fused LSH candidate generation: the CSR multi-probe gather.

The port of ``randomprojection_tpu/ops/probe_kernels.py``.  One query tile
of the multi-probe LSH tier (``ann/lsh.py``) runs, on the index's device
and with no host sync:

1. **Band keys** (``device_band_keys``): the packed query tile unpacks to
   bits and reduces to per-band keys, little-endian within each byte,
   equal to the host ``ann.lsh.band_keys``.  Torch ops, as the reference
   left them to XLA.
2. **The CSR probe walk** (``probe_gather``, the kernel K5): for every run
   ``t = (query q, band j, probe p)`` in query-major order, the bucket
   ``qkeys[j, q] ^ masks[p]`` of band ``j``'s CSR yields the id run
   ``ids[j, indptr[j, key] : indptr[j, key + 1]]`` (empty for an inactive
   query); ``counts[q]`` sums the run lengths, and the runs are packed in
   order into a slot buffer of ``cap`` ids filled past the last run with
   the sentinel ``2³¹−1``.
3. **Dedup, mask, gather, re-rank** (``device_probe_topk``): the slots
   sort ascending (the sentinel sorts last), duplicates, sentinels and
   tombstones go dead, the candidate code rows gather from the resident
   chunks (``gather_rows``: whole rows as 8-, 4- or 2-byte words where the
   width allows, one elementwise ``take`` a chunk), and the top-k kernel K4
   (``topk_kernels.fused_topk``) re-ranks the tile against the ``cap``
   candidate rows with the dead mask; local positions map back to global
   ids on the device.  Ascending slot order is ascending global id, so
   K4's lower-local-id tie rule is the documented lower-global-id rule.

The bucket index
----------------
``fold_band_csr`` builds (and grows) the banded CSR the walk reads on the
codes' own device, a band at a time: ``band_key`` over every row, a
stable sort, a bincount's cumulative sum, with no copy of the codes to
the host (``ann.lsh.BandedBuckets.add``, for every index: on a card or
on the CPU).

Kernel and plain version
------------------------
``rp_probe_gather`` launches the two kernels of ``csrc/probe.cu`` (the
runs' offsets, then the scan of the block totals and the copy balanced
over the output slots; one launch when the tile has no run), each counted
in ``LAUNCHES``.  ``probe_plain`` computes the same function with torch
ops: the run lengths, ``cumsum`` for the offsets and ``repeat_interleave``
to expand the runs.  The public wrapper ``probe_gather`` dispatches on the
device: a CPU tensor goes to the plain version, a CUDA tensor to the
kernel, anything else raises.

The tile as one CUDA graph
--------------------------
On a card the whole composite of ``device_probe_topk`` (band keys, K5,
sort, dedup, gather, K4's two launches, the id map) is captured once per
tile key and replayed per tile (``TileGraphs``): the counterpart of the
reference's one jitted dispatch a tile.  The queries, masks and active
flags are buffers of the graph, copied in before each replay; the index's
CSR, tombstones and chunks are baked into it, so the index drops its
graphs on every ``add``, ``delete`` and ``compact``.  A new key runs the
composite once eagerly (the warm-up: builds, plans and lazy loads stay out
of the capture, and its launches count because they ran), is captured
(which counts nothing) and replayed; each replay adds the launches the
graph holds to ``LAUNCHES`` and ``topk_kernels.LAUNCHES``, one to
``GRAPH_REPLAYS``.  The eager composite serves the CPU, the warm-up, and
the tests that hold a replay to it.

Overflow: a deliberate divergence
---------------------------------
The TPU kernel walks the runs greedily and SKIPS a run that would pass
``cap``, packing later runs that still fit, and reports ``overflow``.
This kernel computes every run's offset with a prefix sum instead, so
when the runs' total passes ``cap`` it writes no run at all: every slot
is the sentinel and ``stats = [0, 1, 0, ...]``.  ``counts`` stays exact
either way.  The tier's ladder reads neither the slots nor ``written``
after an overflow (the fixed path falls back to the exact path, the
adaptive path to the fixed one), so the one visible difference is the
``candidates`` field of the ``device_budget`` fallback event.  When the
total fits, the prefix sum puts every run exactly where the greedy loop
puts it: slots, counts and stats are bit-identical to the reference's.
"""

from __future__ import annotations

import collections
import ctypes
import threading
from typing import NamedTuple, Optional

from randomprojection_tpu_torch.ops import _build, topk_kernels

__all__ = [
    "GRAPH_CACHE_SIZE",
    "GRAPH_CAPTURES",
    "GRAPH_REPLAYS",
    "LAUNCHES",
    "MAX_CAP",
    "ProbePlan",
    "STATS_WORDS",
    "TileGraphs",
    "band_key",
    "capture_tile",
    "device_band_keys",
    "device_probe_topk",
    "fold_band_csr",
    "gather_rows",
    "plan_probe",
    "probe_gather",
    "probe_plain",
    "rerank_counts",
    "reset_launches",
    "rp_probe_gather",
    "runs_cap",
]

#: kernel launches since the last ``reset_launches()`` (two per
#: ``rp_probe_gather`` call: the runs, then the copy; one for a tile with no
#: run); only the CUDA launcher and a graph replay add to it
LAUNCHES = {"rp_probe": 0}
#: device-rung tiles replayed from a CUDA graph, and graphs captured, since
#: the last ``reset_launches()``
GRAPH_REPLAYS = 0
GRAPH_CAPTURES = 0
#: captured tiles an index keeps (least recently used dropped first); a
#: graph holds its composite's intermediates, about 25 MB at the bench tile
#: (64 queries, cap 2^19, 32-byte rows), so at most ~200 MB an index there
GRAPH_CACHE_SIZE = 8

#: int32 words of a device tile's stats: K5's gathered total and overflow,
#: the live candidates, a zero, then K4's four int64 counts (keys, merges,
#: row-tiles, bound tighter) in two words each
STATS_WORDS = 12

#: the largest slot budget of one dispatch: K4 returns candidate-local
#: positions as int32, and the next power of two would not fit them
MAX_CAP = 1 << 30

# the reference's planner constants, kept unchanged: the plan decides each
# tile's query grouping (its candidate union) and its slot budget (its
# overflow verdict), so equal plans give equal answers on both packages
_VMEM_LIMIT = 16 << 20
_VMEM_HEADROOM = 3 << 20
_MIN_BLK = 64  # the TPU kernel's smallest DMA block
_CAP_SLACK = 4
_CAP_CEILING = 1 << 22

_SRC = "probe"


class ProbePlan(NamedTuple):
    """One device-probe tiling: ``tq`` query rows per dispatch (the tier
    clamps its serving tile to it) and ``cap`` the pow2 candidate-slot
    budget of a tile (overflow falls back to the exact path)."""

    tq: int
    cap: int


def reset_launches() -> None:
    global GRAPH_REPLAYS, GRAPH_CAPTURES
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    GRAPH_REPLAYS = GRAPH_CAPTURES = 0


def _ceil_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def plan_probe(nq: int, rows: int, bands: int, band_bits: int,
               n_probes: int, m: int) -> Optional[ProbePlan]:
    """The reference's ``plan_probe``, its ``tq``/``cap`` arithmetic
    unchanged: the largest ``(tq, cap)`` whose buffers fit the TPU
    kernel's 16 MiB scoped-VMEM budget at its smallest DMA block, or None
    when none does.  The tier sizes a shape without a plan by its runs
    instead (``runs_cap``).

    The budget bounds nothing on the card.  It is kept because ``tq``
    sets which queries share a candidate union and ``cap`` sets when a
    tile overflows: both decide the answer a partial-probe query gets, so
    the port answers as the reference does only under the same plan.
    ``cap`` is ``_CAP_SLACK``× the average-bucket gather, exact at full
    probe coverage, at least ``4·m``."""
    if nq <= 0 or rows <= 0 or m <= 0 or n_probes <= 0:
        return None
    if bands < 1 or band_bits < 1:
        return None
    nb = 1 << band_bits
    n_probes = min(int(n_probes), nb)
    indptr_bytes = bands * (nb + 1) * 4
    bucket = max(1, -(-rows // nb))  # ceil average bucket size
    tq_cands = [t for t in (1024, 512, 256, 128, 64, 32, 16, 8, 4, 2, 1)
                if t <= max(_ceil_pow2(nq), 1)]
    for tq in tq_cands:
        expected = tq * bands * n_probes * bucket
        cap_req = min(tq * bands * rows, _CAP_SLACK * expected)
        cap = _ceil_pow2(max(cap_req, 4 * m, 128))
        if cap > _CAP_CEILING:
            continue
        # keys, masks, active and counts, the slot buffer and the id
        # block's two DMA slots
        usage = (
            indptr_bytes
            + bands * tq * 4
            + _ceil_pow2(n_probes) * 4
            + 2 * tq * 4
            + (cap + 3 * _MIN_BLK) * 4
            + _VMEM_HEADROOM
        )
        if usage <= _VMEM_LIMIT:
            return ProbePlan(tq, cap)
    return None


def runs_cap(total: int, m: int) -> int:
    """The slot budget of a dispatch whose runs hold ``total`` ids: their
    pow2 ceiling, at least ``4·m`` and 128 as a plan's.  A dispatch so
    sized cannot overflow.  Past ``MAX_CAP`` one dispatch cannot hold the
    runs."""
    return _ceil_pow2(max(int(total), 4 * int(m), 128))


def band_key(codes, band: int, band_bits: int):
    """Band ``band``'s key of every row of a packed uint8 code plane on its
    device: ``(n,)`` int32, the row's code bits ``[j·b, (j+1)·b)``.  Bits
    are little-endian within each byte and bytes in order, so the key is
    the bytes that hold the band read as a little-endian integer, shifted
    and masked (at most 4 bytes for ``b ≤ 20``): a few passes over the
    rows, for a bucket build over many rows (``device_band_keys`` makes a
    query tile's keys in fewer launches)."""
    import torch

    lo = band * band_bits
    first, shift = lo >> 3, lo & 7
    acc = codes[:, first].to(torch.int64)
    for t in range(1, ((shift + band_bits - 1) >> 3) + 1):
        acc |= codes[:, first + t].to(torch.int64) << (8 * t)
    return ((acc >> shift) & ((1 << band_bits) - 1)).to(torch.int32)


def device_band_keys(codes, bands: int, band_bits: int):
    """Band keys of a packed uint8 code tile on its device: ``(bands, n)``
    int32, key ``j`` of a row being its code bits ``[j·b, (j+1)·b)``,
    little-endian within each byte (equal to the host
    ``ann.lsh.band_keys`` and to ``band_key``).  The tile's bits unpacked
    whole: a handful of launches, the least for the few rows of a query
    tile."""
    import torch

    n = codes.shape[0]
    shifts = torch.arange(8, dtype=torch.int32, device=codes.device)
    bits = (codes.to(torch.int32)[:, :, None] >> shifts) & 1
    bits = bits.reshape(n, -1)[:, : bands * band_bits]
    w = torch.ones((), dtype=torch.int32, device=codes.device) << torch.arange(
        band_bits, dtype=torch.int32, device=codes.device)
    keys = (bits.reshape(n, bands, band_bits) * w).sum(dim=2, dtype=torch.int32)
    return keys.T.contiguous()


#: rows whose band keys are made at once by ``fold_band_csr``: bounds its
#: int64 temporaries (256 MiB each) however large the fold
_KEY_BLOCK = 1 << 25


def fold_band_csr(indptr, ids, codes, row0: int, bands: int, band_bits: int):
    """Fold code rows ``row0, row0 + 1, ...`` into a banded CSR on the
    codes' device, in the reference's layout (ids ascending within each
    bucket).  ``indptr`` ``(bands, 2^b + 1)`` int32 and
    ``ids`` ``(bands, n_old)`` int32 are the CSR so far (None: empty),
    every id below ``row0``; ``codes`` ``(m, n_bytes)`` uint8.  Returns the
    new ``(indptr, ids)``.

    A band at a time: its keys, a stable sort of them (new rows grouped by
    bucket, ids ascending), and the offsets from a bincount's cumulative
    sum.  Bucket ``k``'s old run moves right by the new rows of the buckets
    below ``k``, and the new rows of ``k`` follow its old run, so ids stay
    ascending in every bucket.  Traced, a band is the span
    ``rp:lsh/build``."""
    import torch

    from randomprojection_tpu_torch.utils.observability import annotate

    dev = codes.device
    nb = 1 << band_bits
    m = int(codes.shape[0])
    n_old = 0 if ids is None else int(ids.shape[1])
    out_ip = torch.empty((bands, nb + 1), dtype=torch.int32, device=dev)
    out_ids = torch.empty((bands, n_old + m), dtype=torch.int32, device=dev)
    key = torch.empty(m, dtype=torch.int32, device=dev)
    for j in range(bands):
        with annotate("rp:lsh/build"):
            for lo in range(0, m, _KEY_BLOCK):
                key[lo:lo + _KEY_BLOCK] = band_key(codes[lo:lo + _KEY_BLOCK],
                                                   j, band_bits)
            srt = torch.sort(key, stable=True)
            csum = torch.zeros(nb + 1, dtype=torch.int64, device=dev)
            torch.cumsum(torch.bincount(key, minlength=nb), 0, out=csum[1:])
            if n_old == 0:
                out_ip[j] = csum
                out_ids[j] = srt.indices + row0
                continue
            old_ip = indptr[j].long()
            out_ip[j] = old_ip + csum
            old_counts = old_ip.diff()
            shift = torch.repeat_interleave(csum[:-1], old_counts,
                                            output_size=n_old)
            shift += torch.arange(n_old, device=dev)
            out_ids[j].scatter_(0, shift, ids[j])
            # the new row at sorted position r, of bucket k, lands right
            # after k's old run: old_ip[k + 1] + r
            dest = old_ip[srt.values.long() + 1]
            dest += torch.arange(m, device=dev)
            out_ids[j].scatter_(0, dest, (srt.indices + row0).to(torch.int32))
    return out_ip, out_ids


def _validate(qkeys, masks, active, indptr, ids, cap):
    """The shared argument checks: int32 planes of matching shapes."""
    import torch

    planes = (("qkeys", qkeys), ("masks", masks), ("active", active),
              ("indptr", indptr), ("ids", ids))
    for name, t in planes:
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 or t.dim() != 2:
            raise ValueError(f"{name} must be a 2-D int32 tensor, got "
                             f"{getattr(t, 'dtype', type(t))} "
                             f"{tuple(getattr(t, 'shape', ()))}")
    bands, tq = qkeys.shape
    if masks.shape[0] != 1 or active.shape != (1, tq):
        raise ValueError(f"masks must be (1, P) and active (1, {tq}), got "
                         f"{tuple(masks.shape)} and {tuple(active.shape)}")
    nb1 = indptr.shape[1]
    if indptr.shape[0] != bands or ids.shape[0] != bands or nb1 < 2 or (
            (nb1 - 1) & (nb1 - 2)):
        raise ValueError(f"indptr must be ({bands}, 2^b + 1) and ids "
                         f"({bands}, n), got {tuple(indptr.shape)} and "
                         f"{tuple(ids.shape)}")
    if int(cap) < 0:
        raise ValueError(f"cap must be >= 0, got {cap}")


def probe_plain(qkeys, masks, active, indptr, ids, *, cap: int):
    """The plain torch version of K5, the same algorithm: per-run lengths,
    their exclusive ``cumsum`` as offsets, ``repeat_interleave`` to expand
    the runs, and no run written when their total passes ``cap``."""
    import torch

    _validate(qkeys, masks, active, indptr, ids, cap)
    dev = qkeys.device
    bands, tq = qkeys.shape
    n_probes = masks.shape[1]
    nb1 = indptr.shape[1]
    # runs in (query, band, probe) order; a key is read modulo 2^b, as
    # the kernel reads it
    key = (qkeys.T[:, :, None] ^ masks[0][None, None, :]).long() & (nb1 - 2)
    band = torch.arange(bands, device=dev, dtype=torch.int64)[None, :, None]
    flat = (band * nb1 + key).reshape(tq, bands * n_probes)
    ip = indptr.reshape(-1).long()
    start = ip[flat]
    ln = (ip[flat + 1] - start) * (active[0] != 0).long()[:, None]
    counts = ln.sum(dim=1).to(torch.int32)
    start, ln = start.reshape(-1), ln.reshape(-1)
    total = int(ln.sum())
    slots = torch.full((int(cap),), topk_kernels.EMPTY_ID, dtype=torch.int32,
                       device=dev)
    stats = torch.zeros(8, dtype=torch.int32, device=dev)
    if total > cap:
        stats[1] = 1
        return slots, counts, stats
    if total:
        offs = torch.cumsum(ln, 0) - ln
        run = torch.repeat_interleave(torch.arange(ln.numel(), device=dev), ln)
        within = torch.arange(total, device=dev) - offs[run]
        row = band.expand(tq, bands, n_probes).reshape(-1)[run]
        slots[:total] = ids.reshape(-1)[row * ids.shape[1] + start[run] + within]
    stats[0] = total
    return slots, counts, stats


# -- the CUDA kernel -------------------------------------------------------------

_DECLARED: set = set()


def _lib():
    lib, _ = _build.load(_SRC)
    if _SRC not in _DECLARED:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.rp_probe_scratch_words.argtypes = [i32, i32, i32, i32]
        lib.rp_probe_scratch_words.restype = i64
        lib.rp_probe_gather.argtypes = [p, p, p, p, p, i32, i32, i32, i32, i64,
                                        i64, p, p, p, p, p,
                                        ctypes.POINTER(i32)]
        lib.rp_probe_gather.restype = i32
        lib.rp_probe_error_string.argtypes = [i32]
        lib.rp_probe_error_string.restype = ctypes.c_char_p
        _DECLARED.add(_SRC)
    return lib


def _check_launch(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{what} launch failed: CUDA error {rc} "
            f"({lib.rp_probe_error_string(rc).decode()})"
        )


def rp_probe_gather(qkeys, masks, active, indptr, ids, *, cap: int):
    """Launch K5 on the tensors' card: the runs' offsets and id starts, then
    the scan of the block totals (the total decides overflow, ``stats`` and
    ``counts``) and the copy of every slot, balanced over the slots.  Every
    plane is a contiguous CUDA int32 tensor on one device; the kernels
    write every word of the outputs.  Returns ``(slots (cap,), counts
    (tq,), stats (8,))``."""
    import torch

    _validate(qkeys, masks, active, indptr, ids, cap)
    planes = (qkeys, masks, active, indptr, ids)
    if not all(t.is_cuda and t.device == qkeys.device and t.is_contiguous()
               for t in planes):
        raise ValueError("rp_probe_gather takes contiguous CUDA tensors on one device")
    dev = qkeys.device
    bands, tq = qkeys.shape
    n_probes = masks.shape[1]
    nb = indptr.shape[1] - 1
    lib = _lib()
    words = lib.rp_probe_scratch_words(tq, bands, n_probes, nb)
    if words < 0:
        raise ValueError(f"rp_probe_gather: no launch for tq={tq}, "
                         f"bands={bands}, P={n_probes}, 2^b={nb}")
    scratch = torch.empty(words, dtype=torch.int64, device=dev)
    slots = torch.empty(int(cap), dtype=torch.int32, device=dev)
    counts = torch.empty(tq, dtype=torch.int32, device=dev)
    stats = torch.empty(8, dtype=torch.int32, device=dev)
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = lib.rp_probe_gather(
            qkeys.data_ptr(), masks.data_ptr(), active.data_ptr(),
            indptr.data_ptr(), ids.data_ptr(), tq, bands, n_probes, nb,
            ids.shape[1], int(cap), scratch.data_ptr(), slots.data_ptr(),
            counts.data_ptr(), stats.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream, ctypes.byref(launched),
        )
    LAUNCHES["rp_probe"] += launched.value
    _check_launch(lib, rc, "rp_probe_gather")
    return slots, counts, stats


# -- public wrappers ---------------------------------------------------------------


def probe_gather(qkeys, masks, active, indptr, ids, *, cap: int):
    """Probe-walk one query tile against a banded CSR on one device.

    ``qkeys`` (bands, tq) int32 band keys, ``masks`` (1, P) int32 XOR
    probe masks, ``active`` (1, tq) int32 (0: the query's runs are empty),
    ``indptr`` (bands, 2^b + 1) int32 bucket offsets, ``ids`` (bands, n)
    int32 id runs (bucket by bucket, ascending within each).  Returns
    ``(slots, counts, stats)``: the packed pre-dedup candidate ids
    (``cap``, the sentinel past the last run), the attempted yield per
    query, and ``[written, overflow, 0, ...]``.  A CPU tensor is computed
    by ``probe_plain``, a CUDA tensor by the kernel."""
    if qkeys.device.type == "cpu":
        return probe_plain(qkeys, masks, active, indptr, ids, cap=cap)
    if qkeys.device.type == "cuda":
        return rp_probe_gather(qkeys, masks, active, indptr, ids, cap=cap)
    raise ValueError(f"no probe kernel for device {qkeys.device}")


def _row_words(codes):
    """A chunk's rows as the widest words (8, 4, 2 or 1 bytes) that divide
    its width and its base address: ``(rows, n_bytes / w)``."""
    import torch

    n_bytes = codes.shape[1]
    for dtype, w in ((torch.int64, 8), (torch.int32, 4), (torch.int16, 2)):
        if n_bytes % w == 0 and codes.data_ptr() % w == 0:
            return codes.view(dtype)
    return codes


def gather_rows(chunks, sc):
    """The code rows of global ids ``sc`` (int64, clamped to the index)
    from the resident chunks ``[(codes, row0, rows), ...]``: ``(len(sc),
    n_bytes)`` uint8.  Each chunk's rows are taken as whole words with one
    elementwise ``torch.take`` of their word indices: a row gather
    (``index_select``, or indexing rows) runs a block a row on the card,
    which for 2^19 rows of 32 bytes took 317 µs of an LSH tile.  A position
    outside every chunk keeps chunk 0's row (the caller masks it dead)."""
    import torch

    g = None
    for codes, row0, rows in chunks:
        words = _row_words(codes)
        nw = words.shape[1]
        local = (sc - row0).clamp(0, rows - 1)
        at = local[:, None] * nw + torch.arange(nw, device=sc.device)
        rows_c = torch.take(words, at)
        if g is None:
            g = rows_c
        else:
            g = torch.where(((sc >= row0) & (sc < row0 + rows))[:, None],
                            rows_c.view(g.dtype), g)
    return g.view(torch.uint8)


def device_probe_topk(q, masks, active, indptr, ids, dead_full, chunks, m: int,
                      *, cap: int, band_bits: int):
    """The probe → dedup → gather → re-rank composite for one query tile,
    on the tile's device with no host sync (on a card, ``TileGraphs``
    captures and replays it).

    ``q`` (tq, n_bytes) uint8 queries, ``masks``/``active``/``indptr``/
    ``ids`` as ``probe_gather``, ``dead_full`` (n_total,) uint8 tombstones
    over global ids, ``chunks`` ``[(codes, row0, rows), ...]`` the resident
    code chunks.  Returns device tensors ``(dist (tq, m), gid (tq, m),
    stats (12,), counts (tq,))``, ``stats = [gathered, overflow,
    live_candidates, 0, k4_keys, k4_merges, k4_row_tiles,
    k4_bound_tighter]`` (the last four int64, each in two words:
    ``rerank_counts``); the caller applies the fallback ladder (overflow,
    starved, dense) before trusting the tile."""
    import torch

    s, sc, dead_c, stat, cnt = device_probe_slots(
        q, masks, active, indptr, ids, dead_full, cap=cap, band_bits=band_bits)
    # each live id lies in exactly one chunk's rows; dead slots keep any row
    d, gid = rerank_slots(q, gather_rows(chunks, sc), s, dead_c, m,
                          counts=stat[4:].view(torch.int64) if stat.is_cuda
                          else None)
    return d, gid, stat, cnt


def rerank_counts(stats) -> tuple:
    """``(keys, merges, row_tiles, bound_tighter)`` that the re-rank's
    tensor-core scan added to a tile's stats (words 4–11, four int64, as
    ``rp_fused_topk``'s ``counts``; 0 where none ran on the card), from the
    stats on the host as int32."""
    import numpy as np

    return tuple(int(v) for v in np.ascontiguousarray(
        stats[4:STATS_WORDS]).view(np.int64))


def device_probe_slots(q, masks, active, indptr, ids, dead_full, *, cap: int,
                       band_bits: int):
    """The probe and dedup half of ``device_probe_topk``: band keys, K5 and
    the slot sort.  Returns ``(s, sc, dead, stats, counts)``: the sorted
    slots ``s`` (``cap``, int32; ascending slot order is ascending global
    id, the tie rule), ``sc`` the same as int64 clamped to the index, the
    dead plane (every duplicate, sentinel or tombstoned slot) and ``stats
    = [gathered, overflow, live_candidates, 0, ...]`` (``STATS_WORDS``
    int32, zero past K5's first three)."""
    import torch

    n_total = int(dead_full.shape[0])
    qkeys = device_band_keys(q, int(indptr.shape[0]), band_bits)
    slots, cnt, stat = probe_gather(qkeys, masks, active, indptr, ids, cap=cap)
    s = torch.sort(slots).values
    dup = torch.zeros_like(s, dtype=torch.bool)
    dup[1:] = s[1:] == s[:-1]
    sc = s.clamp(0, max(n_total - 1, 0)).long()
    dead_c = (s >= n_total) | dup | (dead_full[sc] != 0)
    n_live = (~dead_c).sum(dtype=torch.int32)
    stat = torch.cat([stat[:2], n_live.reshape(1), stat[3:],
                      stat.new_zeros(STATS_WORDS - stat.shape[0])])
    return s, sc, dead_c, stat, cnt


def rerank_slots(q, rows, s, dead, m: int, *, counts=None):
    """K4 over gathered slot rows (``rows`` ``(cap, n_bytes)``, ``dead``
    the slots that may not win) and the winners' global ids from the
    sorted slots ``s``: ``(dist (tq, m), gid (tq, m))``, empty slots
    ``(n_bits + 1, 2³¹−1)``.  ``counts`` as ``fused_topk``'s."""
    import torch

    cap = int(s.shape[0])
    d, idx = topk_kernels.fused_topk(q, rows, cap, m, dead=dead.to(torch.uint8),
                                     counts=counts)
    gid = torch.where(idx >= cap, topk_kernels.EMPTY_ID,
                      s[idx.long().clamp(0, cap - 1)])
    return d, gid


# -- the tile as one CUDA graph ------------------------------------------------------


def launch_counters() -> tuple:
    """Every launch counter the composite moves: K5's and K4's."""
    return (LAUNCHES, topk_kernels.LAUNCHES)


def counted_launches(counters, run):
    """Call ``run()`` and return ``(its result, the launches it added to
    each of ``counters``)``, leaving every counter as it was before: what a
    capture records is launched by its replays, not by the capture."""
    before = [dict(c) for c in counters]
    try:
        out = run()
        added = [{k: c[k] - b[k] for k in c} for c, b in zip(counters, before)]
    finally:
        for c, b in zip(counters, before):
            c.update(b)
    return out, added


def credit_launches(counters, added) -> None:
    """Add a replay's launches (``counted_launches``'s record) to
    ``counters``."""
    for c, a in zip(counters, added):
        for k, v in a.items():
            c[k] += v


class _GraphedTile:
    """One captured composite: the graph, its input buffers ``(q, masks,
    active)``, its outputs, the launches it holds, the warm-up's eager
    outputs and the index tensors baked into it (kept alive with it)."""

    __slots__ = ("graph", "inputs", "outputs", "launches", "warmup", "baked")

    def __init__(self, graph, inputs, outputs, launches, warmup, baked):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.launches = launches
        self.warmup = warmup
        self.baked = baked

    def replay(self, q, masks, active):
        """Copy the tile's inputs into the graph's buffers and replay it,
        both on the current stream; returns the graph's output tensors,
        which the next replay overwrites (stream order keeps a copy queued
        behind this replay from seeing the next one)."""
        global GRAPH_REPLAYS
        for buf, src in zip(self.inputs, (q, masks, active)):
            # rplint: allow[RP07] — stream order is the wait: the copy into the graph's input buffer and the replay that reads it are queued on the same stream
            buf.copy_(src, non_blocking=True)
        self.graph.replay()
        credit_launches(launch_counters(), self.launches)
        GRAPH_REPLAYS += 1
        return self.outputs


def capture_tile(q, masks, active, indptr, ids, dead_full, chunks, m: int, *,
                 cap: int, band_bits: int) -> _GraphedTile:
    """Capture ``device_probe_topk`` for one tile key on the card of
    ``indptr``: input buffers shaped as ``q``, ``masks`` and ``active``
    (host or card tensors, copied in), one eager warm-up on them (it counts
    its launches; its outputs stay on the entry as ``warmup``), then the
    capture in a memory pool of the graph's own, which counts none."""
    import torch

    global GRAPH_CAPTURES
    dev = indptr.device
    rest = (indptr, ids, dead_full, chunks)
    graph = torch.cuda.CUDAGraph()

    def capture():
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            return device_probe_topk(*inputs, *rest, m, cap=cap,
                                     band_bits=band_bits)

    with torch.cuda.device(dev):
        inputs = tuple(torch.empty(t.shape, dtype=t.dtype, device=dev)
                       for t in (q, masks, active))
        for buf, src in zip(inputs, (q, masks, active)):
            # rplint: allow[RP07] — stream order is the wait: the copy into the graph's input buffer and the warm-up and capture that read it are queued on the same stream
            buf.copy_(src, non_blocking=True)
        warmup = device_probe_topk(*inputs, *rest, m, cap=cap,
                                   band_bits=band_bits)
        outputs, launches = counted_launches(launch_counters(), capture)
    GRAPH_CAPTURES += 1
    return _GraphedTile(graph, inputs, outputs, launches, warmup, rest)


class TileGraphs:
    """The captured device-rung tiles of one index: at most
    ``GRAPH_CACHE_SIZE`` graphs (``capture_tile``), least recently used
    dropped first, keyed by
    the caller (the tier keys by tile shape, probe count, ``cap``, ``m``,
    band plan, chunk layout and the index's CSR and tombstone revisions).

    ``run`` replays a key's graph with a tile's inputs and hands the
    outputs to ``fetch`` under the cache's lock, so another thread's replay
    of the same graph is queued only after this tile's copies.  ``clear``
    (on every ``add``, ``delete`` and ``compact`` of the index) waits for
    the card, then drops every graph and the tensors baked into it.  The
    cache itself is plain Python: ``capture`` may be replaced (the CPU
    tests do)."""

    def __init__(self, device=None, capture=capture_tile):
        self.device = device
        self._capture = capture
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._graphs)

    def keys(self) -> list:
        """Keys, least recently used first."""
        return list(self._graphs)

    def clear(self) -> None:
        with self._lock:
            if self._graphs and getattr(self.device, "type", None) == "cuda":
                import torch

                # a replay still in flight reads the baked tensors
                torch.cuda.synchronize(self.device)
            self._graphs.clear()

    def run(self, key, q, masks, active, indptr, ids, dead_full, chunks,
            m: int, *, cap: int, band_bits: int, fetch):
        """Replay ``key``'s graph (captured from these planes first when the
        key is new) with ``q``, ``masks`` and ``active``; returns
        ``fetch(dist, gid, stats, counts)``."""
        with self._lock:
            entry = self._graphs.get(key)
            if entry is None:
                entry = self._capture(q, masks, active, indptr, ids, dead_full,
                                      chunks, m, cap=cap, band_bits=band_bits)
                self._graphs[key] = entry
                while len(self._graphs) > GRAPH_CACHE_SIZE:
                    self._graphs.popitem(last=False)
            else:
                self._graphs.move_to_end(key)
            return fetch(*entry.replay(q, masks, active))
