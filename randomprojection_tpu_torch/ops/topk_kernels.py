"""Exact Hamming top-m of packed SimHash codes: the serving kernel.

The port of ``randomprojection_tpu/ops/topk_kernels.py``.  ``fused_topk``
returns, for each query row, the ``m`` nearest code rows of one chunk by
Hamming distance, ascending, with exact ties broken by the LOWER
chunk-local id.  Rows with id ``>= n_real`` and rows with ``dead[id] == 1``
never displace a live row; a slot no live row fills is exactly the empty
pair ``(empty_dist(n_bytes·8), EMPTY_ID)`` = ``(n_bytes·8 + 1, 2³¹−1)``.
Bit for bit the contract of the reference's ``fused_topk``.

The candidate list
------------------
Every serving path speaks the list this kernel writes: ``(distance, id)``
rows in (distance, lower id) order, empty slots last as the empty pair.
``merge_topm`` is its one host merge: the index's chunks, the sharded
tier's shards, the LSH tier's residency sides and its adaptive rounds all
finish through it.

Kernel and plain version
------------------------
``rp_fused_topk`` launches the two passes of ``csrc/topk.cu`` on the
tensors' card (a scan over (query tile × row split), then a per-query
merge of the splits) and counts each launch in ``LAUNCHES``, the scan
under its route's name.  ``topk_plain`` computes the same function with
torch ops: rows in blocks, xor, a 256-entry popcount table, a sum, the
mask, the int64 key ``dist·2^s + id``, ``torch.topk`` and a merge with the
carry.  The public wrapper ``fused_topk`` dispatches on the device: a CPU
tensor goes to the plain version, a CUDA tensor to the kernel, anything
else raises.

Routes and plan
---------------
The scan has two routes, and ``plan_fused`` picks one from the shape alone
(never from a failed build or launch):

* ``'wgmma'``: the distance product on the tensor cores (1-bit ``wgmma``
  ``.and.popc`` on the packed bytes and their complements,
  ``popc(q & ~c) + popc(~q & c)``; ``and_popc_distances`` is that identity
  in torch ops), selection from the accumulator registers, survivors
  appended a register at a time to a buffer of ``buf`` keys a query row
  and merged into its sorted list by a warp sort when the buffer would
  overflow.  A block holds ``tq`` = 128 or 64 queries and scans tiles of
  256 rows through a ring of 2–8 stages.  It takes every width and
  alignment; its limit is shared memory, the ``tq·m`` int64 keys of its
  lists and the ``tq·(buf + 1)`` of its buffers beside the ring (m ≤ 369
  for rows of at most 32 bytes, 361 for wider ones).
* ``'popc'``: the scan on the CUDA cores (``tq`` = 16, 32 or 64 queries,
  tiles of 128 rows), for larger ``m`` up to ``MAX_M``.

Past ``MAX_M``, or past 2²⁴ bits a row (the reference's bound), there is
no plan and the launcher raises.  The plan also sizes the row splits,
bounded by the row tiles, by ``_SCRATCH_BYTES`` of split lists and by a
launch's grid (the merge takes any number of lists a query): for
``'wgmma'``, one block an SM, the count that leaves the fewest tile steps
on the longest-running SM over whole waves of the card, each split's
warm-up of its lists counted (``wave_steps``); for ``'popc'`` about four
blocks an SM.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np

from randomprojection_tpu_torch.ops import _build
from randomprojection_tpu_torch.utils import observability

__all__ = [
    "EMPTY_ID",
    "LAUNCHES",
    "MAX_M",
    "SPLIT_WARMUP_TILES",
    "TopkPlan",
    "and_popc_distances",
    "empty_dist",
    "fused_topk",
    "hamming_counts",
    "merge_topm",
    "mma_scan_plain",
    "plan_fused",
    "reset_launches",
    "rp_fused_topk",
    "smem_bytes",
    "stage_rows",
    "topk_plain",
    "wait_staged",
    "wave_slots",
    "wave_steps",
]

#: kernel launches since the last ``reset_launches()``: an
#: ``rp_fused_topk`` call adds one to its scan route's count and one to the
#: merge's; only the CUDA launcher adds to them
LAUNCHES = {"rp_fused_topk_wgmma": 0, "rp_fused_topk_popc": 0,
            "rp_topk_merge": 0}

MAX_M = 1024  # largest m a plan serves (popc route, tq = 16: 16·1024 keys)
_MAX_BITS_EXACT = 1 << 24  # the reference's bound on a plannable row width
#: the id of an empty slot: past every device-local (int32) id
EMPTY_ID = (1 << 31) - 1
_SMEM_LIMIT = 232_448  # dynamic shared memory a block may use on Hopper
_MAX_SPLITS = 65_535  # kMaxSplits: a launch's grid y, one split a block row
_SCRATCH_BYTES = 256 << 20  # bound on the (nq, splits, m) int64 split lists
_PLAIN_BLOCK_ELEMS = 1 << 23  # xor elements per block of the plain version
_SRC = "topk"
# the popc route (topk_scan_kernel)
_BLOCKS_PER_SM = 4  # its plan aims at this many scan blocks per SM
_ROWS_PER_TILE = 128  # kRows
_CHUNK_WORDS = 32  # kChunkWords
# the wgmma route (topk_mma_kernel)
_MMA_TILE_ROWS = 256  # kTileN
_MMA_STEP_BYTES = 32  # kStepBytes: one k-step of a row
_MMA_MAX_STAGES = 8  # kMaxStages
_MMA_MIN_STAGES = 4  # a shallower ring is taken only where no tile fits this
_MMA_BUFS = (32, 16, 8)  # keys a row's buffer may hold, the planner's choices
_MMA_MIN_BUF = _MMA_BUFS[-1]  # kMinBuf
#: W, what one row split of the tensor-core scan spends beyond its tiles,
#: in tile steps: its lists' warm-up (the survivors' buffers filled and
#: merged while the lists fill), paid once a block and so once a wave on an
#: SM.  Measured on an H100 80GB HBM3 at 700 W (torch_experiments/
#: k4_waves.py; PERF.md §6): 1,291, 1,716 and 1,640 steps at 48 and 256
#: queries over 125M codes and 2,048 over 2^24, their mean taken (1,850
#: with one sorted insert a survivor); 85 at one query and 70 at an LSH
#: tile, where one wave holds every split and W decides nothing.
SPLIT_WARMUP_TILES = 1550
# kSmemSlack: alignment, barriers, 8 stages' row-liveness bits
_MMA_SLACK = 1024 + 128 + 8 * 64
_ROUTE_CODES = {"popc": 0, "wgmma": 1}


class TopkPlan(NamedTuple):
    """One launch configuration: the scan ``route`` (``'wgmma'`` or
    ``'popc'``), ``tq`` queries per block, ``splits`` row splits (grid
    ``ceil(nq/tq) × splits``), ``tiles_per_split`` tiles of ``tile_rows``
    rows each split scans, the ring's ``stages`` (0 on the popc route) and
    the block's dynamic shared memory; on the tensor-core route ``buf``,
    the keys each query row's buffer holds (0 on the popc route)."""

    route: str
    tq: int
    splits: int
    tiles_per_split: int
    tile_rows: int
    stages: int
    smem_bytes: int
    buf: int = 0


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def smem_bytes(route: str, tq: int, m: int, stages: int = 0,
               n_bytes: int = 32, buf: int = _MMA_MIN_BUF) -> int:
    """Dynamic shared memory of one scan block, the formulas of
    ``csrc/topk.cu``.  ``'popc'`` (``scan_smem_bytes``): the lists, the
    query and code word tiles (rows padded to an odd stride) and the tile's
    distances.  ``'wgmma'`` (``mma_smem_bytes``): alignment, barriers and
    the stages' row-liveness bits; ``stages`` × a 256-row code tile's k-step
    and its complement; the queries' k-step and its complement (one slot
    where a row is one step, ``n_bytes`` ≤ 32, else a slot a stage); the
    lists; and the rows' buffers of ``buf`` keys and one of padding (the
    least buffer by default: what the route needs at the least)."""
    if route == "wgmma":
        q_slots = stages if n_bytes > _MMA_STEP_BYTES else 1
        return (_MMA_SLACK + stages * 2 * _MMA_TILE_ROWS * _MMA_STEP_BYTES
                + q_slots * 2 * tq * _MMA_STEP_BYTES + tq * m * 8
                + tq * (buf + 1) * 8)
    return (tq * m * 8 + (tq + _ROWS_PER_TILE) * (_CHUNK_WORDS + 1) * 4
            + tq * _ROWS_PER_TILE * 4)


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    """The streaming multiprocessors of a CUDA device (cached per device)."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def wave_steps(q_tiles: int, n_tiles: int, splits: int, sm_count: int) -> int:
    """Tile steps on the longest-running SM of a tensor-core scan of
    ``q_tiles × splits`` blocks, one block an SM: its waves, each a split's
    tiles and the split's warm-up (``SPLIT_WARMUP_TILES``)."""
    return (-(-q_tiles * splits // sm_count)
            * (-(-n_tiles // splits) + SPLIT_WARMUP_TILES))


def _plan_wgmma(nq: int, rows: int, n_bytes: int, m: int, sm_count: int):
    """The tensor-core route's plan, or None when its lists and the least
    buffers do not fit beside a ring of two stages.  128 queries a block
    (two consumer warpgroups sharing each code tile) where there are more
    than 64 queries and a ring of at least four stages fits beside their
    lists, else 64; the deepest ring that fits, up to 8, with the least
    buffers; the largest buffer that keeps that ring (32 keys wherever m is
    small); then the row splits that leave the fewest ``wave_steps``, ties
    to fewer splits."""
    def deepest(tq):
        return next((s for s in range(_MMA_MAX_STAGES, 1, -1)
                     if smem_bytes("wgmma", tq, m, s, n_bytes) <= _SMEM_LIMIT), 0)

    tq, stages = 64, deepest(64)
    if nq > 64 and deepest(128) >= _MMA_MIN_STAGES:
        tq, stages = 128, deepest(128)
    if stages == 0:
        return None
    buf = next(b for b in _MMA_BUFS
               if smem_bytes("wgmma", tq, m, stages, n_bytes, b) <= _SMEM_LIMIT)
    q_tiles = -(-nq // tq)
    n_tiles = -(-rows // _MMA_TILE_ROWS)
    most = min(_MAX_SPLITS, n_tiles, max(1, _SCRATCH_BYTES // (nq * m * 8)))
    splits, best = 1, wave_steps(q_tiles, n_tiles, 1, sm_count)
    for s in range(2, most + 1):
        # no count from here on can beat the best: its waves are at least
        # q_tiles·s / SMs, each at least n_tiles / s + W steps
        if q_tiles * (n_tiles + s * SPLIT_WARMUP_TILES) > best * sm_count:
            break
        steps = wave_steps(q_tiles, n_tiles, s, sm_count)
        if steps < best:
            splits, best = s, steps
    tiles_per_split = -(-n_tiles // splits)
    splits = -(-n_tiles // tiles_per_split)
    return TopkPlan("wgmma", tq, splits, tiles_per_split, _MMA_TILE_ROWS,
                    stages, smem_bytes("wgmma", tq, m, stages, n_bytes, buf),
                    buf)


def _plan_popc(nq: int, rows: int, m: int, sm_count: int) -> TopkPlan:
    """The popc route's plan: the largest query tile whose blocks can
    still reach about four per SM (fewer query tiles re-read the codes
    fewer times), then the splits that reach that count, bounded by the
    row tiles, by 256 MiB of split lists and by a launch's grid."""
    target = _BLOCKS_PER_SM * sm_count
    n_tiles = -(-rows // _ROWS_PER_TILE)
    most = min(_MAX_SPLITS, n_tiles, max(1, _SCRATCH_BYTES // (nq * m * 8)))
    for tq in (64, 32, 16):
        if smem_bytes("popc", tq, m) > _SMEM_LIMIT:
            continue
        q_tiles = -(-nq // tq)
        if q_tiles * most >= target or tq == 16:
            break
    splits = min(most, -(-target // q_tiles))
    tiles_per_split = -(-n_tiles // splits)
    splits = -(-n_tiles // tiles_per_split)
    return TopkPlan("popc", tq, splits, tiles_per_split, _ROWS_PER_TILE, 0,
                    smem_bytes("popc", tq, m))


def wave_slots(plan: TopkPlan, nq: int, sm_count: int):
    """``(blocks, slots)`` of a tensor-core scan launch: its grid's blocks
    and the block slots of its waves, ``ceil(blocks / SMs) · SMs`` (one
    block an SM)."""
    blocks = -(-nq // plan.tq) * plan.splits
    return blocks, -(-blocks // sm_count) * sm_count


@functools.lru_cache(maxsize=4096)
def plan_fused(nq: int, rows: int, n_bytes: int, m: int, *,
               sm_count: int) -> Optional[TopkPlan]:
    """The kernel's configuration for ``nq`` queries against ``rows`` codes
    of ``n_bytes`` on a card of ``sm_count`` SMs, or None when it cannot
    serve the shape (``m > MAX_M``, or rows wider than 2²⁴ bits): the
    tensor-core route where its lists fit in shared memory, else the popc
    route.  A function of its arguments alone, kept a shape (a serving
    path asks again for every batch)."""
    if nq <= 0 or rows <= 0 or n_bytes <= 0 or m <= 0:
        return None
    if n_bytes * 8 > _MAX_BITS_EXACT or m > MAX_M:
        return None
    return (_plan_wgmma(nq, rows, n_bytes, m, sm_count)
            or _plan_popc(nq, rows, m, sm_count))


def _validate(q, codes, n_real, m, dead):
    """The shared argument checks: 2-D uint8 codes of one width, ``m``
    positive, ``n_real`` within the rows, ``dead`` a (rows,) uint8 mask."""
    import torch

    for name, t in (("q", q), ("codes", codes)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.uint8 or t.dim() != 2:
            raise ValueError(f"{name} must be a 2-D uint8 tensor, got "
                             f"{getattr(t, 'dtype', type(t))} "
                             f"{tuple(getattr(t, 'shape', ()))}")
    if q.shape[1] != codes.shape[1]:
        raise ValueError(f"q has {q.shape[1]} bytes a row, codes {codes.shape[1]}")
    if int(m) <= 0:
        raise ValueError(f"m must be positive, got {m}")
    if not 0 <= int(n_real) <= codes.shape[0]:
        raise ValueError(f"n_real={n_real} outside [0, {codes.shape[0]}]")
    if dead is not None and (
        not isinstance(dead, torch.Tensor) or dead.dtype != torch.uint8
        or tuple(dead.shape) != (codes.shape[0],)
    ):
        raise ValueError(f"dead must be a ({codes.shape[0]},) uint8 tensor")


def _popcount_table(device):
    import torch

    return torch.tensor([bin(i).count("1") for i in range(256)],
                        dtype=torch.int32, device=device)


def hamming_counts(a, b, *, table=None):
    """``(n1, n_bytes)`` × ``(n2, n_bytes)`` uint8 → ``(n1, n2)`` int32
    Hamming distances: xor, the 256-entry popcount table, a sum; ``b`` is
    taken in row blocks so the xor never holds more than 2²³ bytes."""
    import torch

    if table is None:
        table = _popcount_table(a.device)
    n1, nb = a.shape
    step = max(1, _PLAIN_BLOCK_ELEMS // max(n1 * nb, 1))
    out = torch.empty((n1, b.shape[0]), dtype=torch.int32, device=a.device)
    for lo in range(0, b.shape[0], step):
        x = torch.bitwise_xor(a[:, None, :], b[None, lo:lo + step, :])
        out[:, lo:lo + step] = table[x.long()].sum(-1, dtype=torch.int32)
    return out


def and_popc_distances(a, b, *, table=None):
    """The tensor-core route's distance product in torch ops:
    ``popc(a & ~b) + popc(~a & b)`` per (row of ``a``, row of ``b``), the
    two 1-bit ``and.popc`` steps of the kernel, equal to ``hamming_counts``
    bit for bit.  Both operands are zero-padded to whole 32-byte k-steps
    first, as the kernel stages them: a pad byte is 0 on the plain side and
    0xFF on the complemented side, and the zero cancels it."""
    import torch
    import torch.nn.functional as F

    if table is None:
        table = _popcount_table(a.device)
    pad = -a.shape[1] % _MMA_STEP_BYTES
    a, b = F.pad(a, (0, pad)), F.pad(b, (0, pad))
    n1, nb = a.shape
    step = max(1, _PLAIN_BLOCK_ELEMS // max(n1 * nb, 1))
    out = torch.empty((n1, b.shape[0]), dtype=torch.int32, device=a.device)
    na = torch.bitwise_not(a)
    for lo in range(0, b.shape[0], step):
        blk = b[None, lo:lo + step, :]
        x = torch.bitwise_and(a[:, None, :], torch.bitwise_not(blk))
        y = torch.bitwise_and(na[:, None, :], blk)
        out[:, lo:lo + step] = (table[x.long()].sum(-1, dtype=torch.int32)
                                + table[y.long()].sum(-1, dtype=torch.int32))
    return out


def topk_plain(q, codes, n_real: int, m: int, *, dead=None):
    """The plain torch version of the kernel, the same function and tie
    rule: per block of rows, the distances, the mask, the key
    ``dist·2^s + id`` (``2^s`` > every id), ``torch.topk`` of the block
    and a merge with the running carry."""
    import torch

    _validate(q, codes, n_real, m, dead)
    nq, nb = q.shape
    rows = codes.shape[0]
    sentinel = nb * 8 + 1
    s = max(rows.bit_length(), 1)
    low = (1 << s) - 1
    dev = q.device
    carry = torch.full((nq, m), (sentinel << s) | low, dtype=torch.int64,
                       device=dev)
    table = _popcount_table(dev)
    blk = max(1, _PLAIN_BLOCK_ELEMS // max(nq * nb, 1))
    for lo in range(0, rows, blk):
        hi = min(lo + blk, rows)
        d = hamming_counts(q, codes[lo:hi], table=table).long()
        ids = torch.arange(lo, hi, dtype=torch.int64, device=dev)
        keep = ids < n_real
        if dead is not None:
            keep &= dead[lo:hi] == 0
        key = (torch.where(keep, d, sentinel) << s) | ids
        top = torch.topk(key, min(m, hi - lo), dim=1, largest=False,
                         sorted=True).values
        carry = torch.topk(torch.cat([carry, top], dim=1), m, dim=1,
                           largest=False, sorted=True).values
    dist = carry >> s
    empty = dist >= sentinel
    return (torch.where(empty, sentinel, dist).to(torch.int32),
            torch.where(empty, EMPTY_ID, carry & low).to(torch.int32))


def mma_scan_plain(q, codes, n_real: int, m: int, plan: TopkPlan, *,
                   dead=None):
    """The tensor-core scan's selection (``topk_mma_kernel``), step for step
    on the host: the split lists it leaves and the survivors' counts it
    adds up.  ``plan`` is a ``'wgmma'`` plan (its ``splits``,
    ``tiles_per_split`` and ``buf``).

    A consumer warp owns 16 query rows; lane ``4g + t`` holds rows ``g``
    and ``g + 8`` and register ``4j + 2h + e`` the distance of row ``g +
    8h`` to the tile's code row ``8j + e + 2t``.  A tile with no live row
    is passed over; in the others each row's least distance in each group
    of 32 registers is held to its threshold (strictly), then a flagged
    group's registers any lane holds below its row's threshold are taken
    in order, their survivors (at or under the threshold as it stands, the
    code row live) appended to their rows' buffers, a row its register
    would overflow merged first; a row's threshold is its list's, read
    again at each merge.  Every buffer is merged at the split's end.  Returns
    ``(part, keys, merges)``: ``(nq, splits, m)`` int64 keys as the kernel
    writes them, the keys taken into buffers and the merges."""
    import numpy as np

    _validate(q, codes, n_real, m, dead)
    nq, nb = q.shape
    sentinel = nb * 8 + 1
    empty = (sentinel << 32) | EMPTY_ID
    n_tiles = -(-int(n_real) // _MMA_TILE_ROWS)
    span = n_tiles * _MMA_TILE_ROWS
    live = np.zeros(span, bool)
    live[:n_real] = True
    if dead is not None:
        live[:n_real] &= dead.cpu().numpy()[:n_real] == 0
    dist = np.empty((nq, span), np.int64)
    rows = min(span, codes.shape[0])
    dist[:, :rows] = hamming_counts(q.cpu(), codes[:rows].cpu()).numpy()
    # rows past the matrix are staged as zeros: popc(q & ~0) + popc(~q & 0)
    dist[:, rows:] = hamming_counts(q.cpu(), codes[:0].cpu().new_zeros(
        (1, nb))).numpy()
    idx = np.arange(128)
    lane = np.arange(32)[:, None]
    half = (idx >> 1) & 1
    reg_row = (lane >> 2) + 8 * half  # (32, 128): the warp's row
    reg_col = 8 * (idx >> 2) + (idx & 1) + 2 * (lane & 3)  # the tile's row
    part = np.full((nq, plan.splits, m), empty, np.int64)
    keys = merges = 0
    for w0 in range(0, nq, 16):
        wr = np.arange(w0, w0 + 16)
        for split in range(plan.splits):
            lists = np.full((16, m), empty, np.int64)
            bufs = [[] for _ in range(16)]
            thr = np.where(wr < nq, sentinel, -1)

            def merge(r):
                nonlocal merges
                both = np.sort(np.concatenate([lists[r], bufs[r]]))
                lists[r] = both[:m]
                bufs[r].clear()
                thr[r] = lists[r, m - 1] >> 32
                merges += 1

            t0 = split * plan.tiles_per_split
            for tile in range(t0, min(t0 + plan.tiles_per_split, n_tiles)):
                r0 = tile * _MMA_TILE_ROWS
                tl = live[r0:r0 + _MMA_TILE_ROWS]
                if not tl.any():
                    continue
                d_t = np.full((16, _MMA_TILE_ROWS), sentinel, np.int64)
                d_t[wr < nq] = dist[wr[wr < nq], r0:r0 + _MMA_TILE_ROWS]
                acc = d_t[reg_row, reg_col]  # (32, 128)
                # the groups flagged at the tile's start
                flagged = (acc < thr[reg_row]).reshape(32, 4, 32).any(axis=(0, 2))
                for k in np.flatnonzero(flagged):
                    grp = slice(32 * k, 32 * k + 32)
                    todo = np.flatnonzero((acc[:, grp] < thr[reg_row[:, grp]])
                                          .any(axis=0)) + 32 * k
                    for i in todo:
                        r, c, d = reg_row[:, i], reg_col[:, i], acc[:, i]
                        hit = tl[c] & (d <= thr[r])
                        over = [g + 8 * half[i] for g in range(8)
                                if len(bufs[g + 8 * half[i]])
                                + hit[4 * g:4 * g + 4].sum() > plan.buf]
                        for row in over:
                            merge(row)
                        if over:
                            hit = tl[c] & (d <= thr[r])
                        for ln in np.flatnonzero(hit):
                            bufs[r[ln]].append((int(d[ln]) << 32) | (r0 + int(c[ln])))
                        keys += int(hit.sum())
            for r in range(16):
                if bufs[r]:
                    merge(r)
            ok = wr < nq
            part[wr[ok], split] = lists[ok]
    return part, keys, merges


def empty_dist(n_bits: int) -> int:
    """The distance of an empty slot over codes of ``n_bits`` bits: one
    past every real distance, so an empty slot sorts after them."""
    return n_bits + 1


def merge_topm(d_parts, i_parts, m: int, *, dedup: bool = False,
               n_bits: Optional[int] = None):
    """The top ``m`` of each row's union of candidate lists, in (distance,
    lower id) order: the host merge of every list this kernel writes.

    ``d_parts`` and ``i_parts`` are host planes, one pair a list, each row
    already in that order; widths may differ, ids are int32 or int64 and
    not negative.  Returns ``(dist int32, ids)``, ``m`` wide, the ids in
    the inputs' widest dtype.  A pair comes back as it was given, so an
    empty slot stays the exact empty pair.  One plane at least ``m`` wide
    passes through as its first ``m`` columns.  ``dedup`` keeps one copy
    of a repeated pair (an id has one distance) and turns the others into
    the empty pair of ``n_bits``, which also fills a union narrower than
    ``m``; ``n_bits`` is needed only then.

    A row's keys ``(dist << s) | id`` sort in that order: ``s`` is 32
    where every id is below 2³² (int32 ids always are), else the ids' bit
    length, so no id bleeds into the distance bits."""
    if len(d_parts) == 1 and not dedup and d_parts[0].shape[1] >= m:
        return d_parts[0][:, :m], i_parts[0][:, :m]
    ids = np.concatenate(i_parts, axis=1)
    s = 32
    if ids.dtype.itemsize > 4 and ids.size:
        s = max(s, int(ids.max()).bit_length())
    if s + _MAX_BITS_EXACT.bit_length() > 63:
        raise ValueError(f"ids of {s} bits leave no room for the distance "
                         "in a 63-bit key")
    key = (np.concatenate(d_parts, axis=1).astype(np.int64) << s) | ids
    rows, width = key.shape
    if dedup or width < m:
        if n_bits is None:
            raise ValueError("merge_topm needs n_bits for the empty pair "
                             "that fills a deduplicated or narrow union")
        empty = (empty_dist(n_bits) << s) | EMPTY_ID
    if dedup:
        key.sort(axis=1)
        dup = np.zeros(key.shape, bool)
        dup[:, 1:] = key[:, 1:] == key[:, :-1]
        key[dup] = empty
    if width < m:
        key = np.concatenate(
            [key, np.full((rows, m - width), empty, np.int64)], axis=1)
    elif m < width:
        key = np.partition(key, m - 1, axis=1)[:, :m]
    key.sort(axis=1)
    return ((key >> s).astype(np.int32),
            (key & ((1 << s) - 1)).astype(ids.dtype))


# -- the CUDA kernel -------------------------------------------------------------

_DECLARED: set = set()


def _lib():
    lib, _ = _build.load(_SRC)
    if _SRC not in _DECLARED:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.rp_topk_scan.argtypes = [p, p, p, i64, i64, i64, i64, i32, i32,
                                     i32, i32, i32, i32, i32, p, p, p]
        lib.rp_topk_scan.restype = i32
        lib.rp_topk_merge.argtypes = [p, i64, i32, i32, i64, p, p, p]
        lib.rp_topk_merge.restype = i32
        lib.rp_topk_smem_bytes.argtypes = [i32, i32, i32, i32, i32, i64]
        lib.rp_topk_smem_bytes.restype = i64
        lib.rp_topk_error_string.argtypes = [i32]
        lib.rp_topk_error_string.restype = ctypes.c_char_p
        _DECLARED.add(_SRC)
    return lib


def build_info() -> _build.Build:
    """Build (or reuse) the kernel's library and return its build record."""
    _lib()
    return _build.load(_SRC)[1]


def _check_launch(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{what} launch failed: CUDA error {rc} "
            f"({lib.rp_topk_error_string(rc).decode()})"
        )


def rp_fused_topk(q, codes, n_real: int, m: int, *, dead=None, plan=None,
                  counts=None):
    """Launch the kernel's two passes on the tensors' card.  ``q``, ``codes``
    and ``dead`` are contiguous CUDA uint8 tensors on one device.  Returns
    ``(dist, idx)``, each ``(nq, m)`` int32.  ``plan`` overrides
    ``plan_fused``'s choice (the tests hold each route to the plain version
    with it).  ``counts``, a (2,) int64 tensor on the card, receives what a
    tensor-core scan adds up: the keys its query rows took into their
    buffers and the buffers' merges (a CUDA graph's caller reads them from
    its outputs); without it, a tensor-core scan is counted in
    ``observability.count_survivors`` while a profiler records, and not at
    all otherwise.  Raises ``ValueError`` for a shape ``plan_fused``
    cannot serve."""
    import torch

    _validate(q, codes, n_real, m, dead)
    tensors = (q, codes) if dead is None else (q, codes, dead)
    if not all(t.is_cuda and t.device == q.device and t.is_contiguous()
               for t in tensors):
        raise ValueError("rp_fused_topk takes contiguous CUDA tensors on one device")
    nq, nb = q.shape
    rows = codes.shape[0]
    dev = q.device
    dist = torch.empty((nq, m), dtype=torch.int32, device=dev)
    idx = torch.empty((nq, m), dtype=torch.int32, device=dev)
    if nq == 0:
        return dist, idx
    if plan is None:
        plan = plan_fused(nq, rows, nb, m, sm_count=_sm_count(dev))
    if plan is None:
        raise ValueError(
            f"no fused top-k plan for nq={nq}, rows={rows}, n_bytes={nb}, "
            f"m={m} (MAX_M={MAX_M}, and n_bytes·8 ≤ 2^24)"
        )
    part = torch.empty((nq, plan.splits, m), dtype=torch.int64, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        mma = plan.route == "wgmma"
        traced = mma and observability.recording()
        own = traced and counts is None
        if own:
            counts = torch.zeros(2, dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rp_topk_scan(
            q.data_ptr(), codes.data_ptr(),
            None if dead is None else dead.data_ptr(), nq, rows, int(n_real),
            nb, m, _ROUTE_CODES[plan.route], plan.tq, plan.stages, plan.buf,
            plan.splits, plan.tiles_per_split, part.data_ptr(),
            counts.data_ptr() if mma and counts is not None else None, stream,
        )
        _check_launch(lib, rc, f"rp_fused_topk ({plan.route} scan)")
        LAUNCHES[f"rp_fused_topk_{plan.route}"] += 1
        if traced:
            observability.count_waves("topk_mma_kernel",
                                      *wave_slots(plan, nq, _sm_count(dev)))
        if own:
            observability.count_survivors(nq * plan.splits, counts)
        rc = lib.rp_topk_merge(part.data_ptr(), nq, plan.splits, m, nb,
                               dist.data_ptr(), idx.data_ptr(), stream)
        _check_launch(lib, rc, "rp_fused_topk (merge)")
        LAUNCHES["rp_topk_merge"] += 1
    return dist, idx


# -- public wrapper ----------------------------------------------------------------


def fused_topk(q, codes, n_real: int, m: int, *, dead=None, counts=None):
    """Exact top-``m`` of one code chunk for a tile of queries.

    ``q`` (nq, n_bytes) uint8 packed queries, ``codes`` (rows, n_bytes)
    uint8 chunk (rows past ``n_real`` are ignored), ``dead`` an optional
    (rows,) uint8 tombstone mask (1 = deleted).  Returns ``(dist, idx)``,
    each (nq, m) int32: ascending distance, ties to the lower chunk-local
    id, empty slots ``(n_bits + 1, 2³¹−1)``.  A CPU tensor is computed by
    ``topk_plain``; a CUDA tensor by the kernel, which adds its survivors'
    counts to ``counts`` where given (``rp_fused_topk``; the plain version
    counts nothing)."""
    if q.device.type == "cpu":
        return topk_plain(q, codes, n_real, m, dead=dead)
    if q.device.type == "cuda":
        return rp_fused_topk(q, codes, n_real, m, dead=dead, counts=counts)
    raise ValueError(f"no top-k kernel for device {q.device}")


# -- tier-boundary staging ------------------------------------------------------------


def stage_rows(rows, *, device, pad_to: Optional[int] = None):
    """Start the upload of host code rows to ``device`` and return ``(tensor,
    event)`` without waiting for it: the tiered serving paths stage their
    cold rows before they launch the hot side's kernel, so the copy runs
    under it.

    ``rows`` is a host array (a memmap is read here, only the pages it
    covers) or a CPU tensor.  On a card the rows go through a pinned bounce
    buffer (a pinned tensor without padding goes up as it is), zero-padded
    there to ``pad_to`` rows, and the copy is queued ``non_blocking`` on
    the device's copy stream with an event behind it; the consumer calls
    ``wait_staged`` before the kernel that reads the tensor.  The tensor
    is allocated on the copy stream, and ``wait_staged`` records its use
    on the consuming stream, so the allocator reuses its memory only after
    that stream's kernels.  On the CPU the rows are copied and the event
    is None."""
    import torch

    device = torch.device(device)
    host_t = rows if isinstance(rows, torch.Tensor) else None
    n, nb = rows.shape
    total = n if pad_to is None else int(pad_to)
    if total < n:
        raise ValueError(f"stage_rows pad_to={pad_to} below row count {n}")
    if device.type == "cpu":
        out = torch.zeros((total, nb), dtype=torch.uint8)
        out.numpy()[:n] = host_t.numpy() if host_t is not None else rows
        return out, None
    if device.type != "cuda":
        raise ValueError(f"no staging path for device {device}")
    if host_t is not None and host_t.is_pinned() and total == n:
        bounce = host_t
    else:
        # the pinned block returns to torch's host cache only after the
        # copy queued on it has run (the cache records the stream's use)
        bounce = torch.empty((total, nb), dtype=torch.uint8, pin_memory=True)
        view = bounce.numpy()
        view[:n] = host_t.numpy() if host_t is not None else rows
        view[n:] = 0
    from randomprojection_tpu_torch.ops.staging import stage_upload

    staged = stage_upload(bounce, device)
    # rplint: allow[RP07] — the tensor leaves with its event, unwaited by design: the caller's wait_staged() orders its stream behind the copy before the kernel that reads the rows
    return staged.tensor, staged.event


def wait_staged(tensor, event) -> None:
    """Make the current stream wait for ``stage_rows``' copy of ``tensor``
    and record the tensor's use there (no-op for a CPU stage)."""
    if event is None:
        return
    from randomprojection_tpu_torch.ops.staging import StagedBatch

    StagedBatch(tensor, event).wait()
