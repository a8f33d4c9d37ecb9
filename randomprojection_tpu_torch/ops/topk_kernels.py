"""Exact Hamming top-m of packed SimHash codes: the serving kernel.

The port of ``randomprojection_tpu/ops/topk_kernels.py``.  ``fused_topk``
returns, for each query row, the ``m`` nearest code rows of one chunk by
Hamming distance, ascending, with exact ties broken by the LOWER
chunk-local id.  Rows with id ``>= n_real`` and rows with ``dead[id] == 1``
never displace a live row; a slot no live row fills is exactly
``(n_bytes·8 + 1, 2³¹−1)``, which the index's cross-chunk host merge
relies on.  Bit for bit the contract of the reference's ``fused_topk``.

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
  in torch ops), selection from the accumulator registers.  A block holds
  ``tq`` = 128 or 64 queries and scans tiles of 256 rows through a ring of
  2–8 stages.  It takes every width and alignment; its limit is shared
  memory, the ``tq·m`` int64 keys of its lists beside the ring (m ≤ 378
  for rows of at most 32 bytes, 370 for wider ones).
* ``'popc'``: the scan on the CUDA cores (``tq`` = 16, 32 or 64 queries,
  tiles of 128 rows), for larger ``m`` up to ``MAX_M``.

Past ``MAX_M``, or past 2²⁴ bits a row (the reference's bound), there is
no plan and the launcher raises.  The plan also sizes the row splits (at
most 32): for ``'wgmma'`` the count that leaves the fewest tile steps on
the longest-running SM with one block an SM, for ``'popc'`` about four
blocks an SM.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

from randomprojection_tpu_torch.ops import _build

__all__ = [
    "LAUNCHES",
    "MAX_M",
    "TopkPlan",
    "and_popc_distances",
    "fused_topk",
    "hamming_counts",
    "plan_fused",
    "reset_launches",
    "rp_fused_topk",
    "smem_bytes",
    "topk_plain",
]

#: kernel launches since the last ``reset_launches()``: an
#: ``rp_fused_topk`` call adds one to its scan route's count and one to the
#: merge's; only the CUDA launcher adds to them
LAUNCHES = {"rp_fused_topk_wgmma": 0, "rp_fused_topk_popc": 0,
            "rp_topk_merge": 0}

MAX_M = 1024  # largest m a plan serves (popc route, tq = 16: 16·1024 keys)
_MAX_BITS_EXACT = 1 << 24  # the reference's bound on a plannable row width
_INT32_MAX = (1 << 31) - 1
_SMEM_LIMIT = 232_448  # dynamic shared memory a block may use on Hopper
_MAX_SPLITS = 32  # kMaxSplits: one merge lane per split
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
# kSmemSlack: alignment, barriers, 8 stages' row-liveness bits
_MMA_SLACK = 1024 + 128 + 8 * 64
_ROUTE_CODES = {"popc": 0, "wgmma": 1}


class TopkPlan(NamedTuple):
    """One launch configuration: the scan ``route`` (``'wgmma'`` or
    ``'popc'``), ``tq`` queries per block, ``splits`` row splits (grid
    ``ceil(nq/tq) × splits``), ``tiles_per_split`` tiles of ``tile_rows``
    rows each split scans, the ring's ``stages`` (0 on the popc route) and
    the block's dynamic shared memory."""

    route: str
    tq: int
    splits: int
    tiles_per_split: int
    tile_rows: int
    stages: int
    smem_bytes: int


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def smem_bytes(route: str, tq: int, m: int, stages: int = 0,
               n_bytes: int = 32) -> int:
    """Dynamic shared memory of one scan block, the formulas of
    ``csrc/topk.cu``.  ``'popc'`` (``scan_smem_bytes``): the lists, the
    query and code word tiles (rows padded to an odd stride) and the tile's
    distances.  ``'wgmma'`` (``mma_smem_bytes``): alignment, barriers and
    the stages' row-liveness bits; ``stages`` × a 256-row code tile's k-step
    and its complement; the queries' k-step and its complement (one slot
    where a row is one step, ``n_bytes`` ≤ 32, else a slot a stage); and
    the lists."""
    if route == "wgmma":
        q_slots = stages if n_bytes > _MMA_STEP_BYTES else 1
        return (_MMA_SLACK + stages * 2 * _MMA_TILE_ROWS * _MMA_STEP_BYTES
                + q_slots * 2 * tq * _MMA_STEP_BYTES + tq * m * 8)
    return (tq * m * 8 + (tq + _ROWS_PER_TILE) * (_CHUNK_WORDS + 1) * 4
            + tq * _ROWS_PER_TILE * 4)


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    """The streaming multiprocessors of a CUDA device (cached per device)."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def _plan_wgmma(nq: int, rows: int, n_bytes: int, m: int, sm_count: int):
    """The tensor-core route's plan, or None when its lists do not fit
    beside a ring of two stages.  128 queries a block (two consumer
    warpgroups sharing each code tile) where there are more than 64 queries
    and a ring of at least four stages fits beside their lists, else 64;
    the deepest ring that fits, up to 8; then the row splits that leave the
    fewest tile steps on the longest-running SM with one block an SM, ties
    to fewer splits (each split warms its lists up anew)."""
    def deepest(tq):
        return next((s for s in range(_MMA_MAX_STAGES, 1, -1)
                     if smem_bytes("wgmma", tq, m, s, n_bytes) <= _SMEM_LIMIT), 0)

    tq, stages = 64, deepest(64)
    if nq > 64 and deepest(128) >= _MMA_MIN_STAGES:
        tq, stages = 128, deepest(128)
    if stages == 0:
        return None
    q_tiles = -(-nq // tq)
    n_tiles = -(-rows // _MMA_TILE_ROWS)
    most = min(_MAX_SPLITS, n_tiles, max(1, _SCRATCH_BYTES // (nq * m * 8)))
    splits = min(range(1, most + 1),
                 key=lambda s: (-(-q_tiles * s // sm_count) * -(-n_tiles // s), s))
    tiles_per_split = -(-n_tiles // splits)
    splits = -(-n_tiles // tiles_per_split)
    return TopkPlan("wgmma", tq, splits, tiles_per_split, _MMA_TILE_ROWS,
                    stages, smem_bytes("wgmma", tq, m, stages, n_bytes))


def _plan_popc(nq: int, rows: int, m: int, sm_count: int) -> TopkPlan:
    """The popc route's plan: the largest query tile whose blocks can
    still reach about four per SM with at most 32 splits (fewer query tiles
    re-read the codes fewer times), then the splits that reach that count,
    bounded by the row tiles and by 256 MiB of split lists."""
    target = _BLOCKS_PER_SM * sm_count
    n_tiles = -(-rows // _ROWS_PER_TILE)
    for tq in (64, 32, 16):
        if smem_bytes("popc", tq, m) > _SMEM_LIMIT:
            continue
        q_tiles = -(-nq // tq)
        if q_tiles * _MAX_SPLITS >= target or tq == 16:
            break
    splits = min(_MAX_SPLITS, n_tiles, -(-target // q_tiles),
                 max(1, _SCRATCH_BYTES // (nq * m * 8)))
    tiles_per_split = -(-n_tiles // splits)
    splits = -(-n_tiles // tiles_per_split)
    return TopkPlan("popc", tq, splits, tiles_per_split, _ROWS_PER_TILE, 0,
                    smem_bytes("popc", tq, m))


def plan_fused(nq: int, rows: int, n_bytes: int, m: int, *,
               sm_count: int) -> Optional[TopkPlan]:
    """The kernel's configuration for ``nq`` queries against ``rows`` codes
    of ``n_bytes`` on a card of ``sm_count`` SMs, or None when it cannot
    serve the shape (``m > MAX_M``, or rows wider than 2²⁴ bits): the
    tensor-core route where its lists fit in shared memory, else the popc
    route."""
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
            torch.where(empty, _INT32_MAX, carry & low).to(torch.int32))


# -- the CUDA kernel -------------------------------------------------------------

_DECLARED: set = set()


def _lib():
    lib, _ = _build.load(_SRC)
    if _SRC not in _DECLARED:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.rp_topk_scan.argtypes = [p, p, p, i64, i64, i64, i64, i32, i32,
                                     i32, i32, i32, i32, p, p]
        lib.rp_topk_scan.restype = i32
        lib.rp_topk_merge.argtypes = [p, i64, i32, i32, i64, p, p, p]
        lib.rp_topk_merge.restype = i32
        lib.rp_topk_smem_bytes.argtypes = [i32, i32, i32, i32, i64]
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


def rp_fused_topk(q, codes, n_real: int, m: int, *, dead=None, plan=None):
    """Launch the kernel's two passes on the tensors' card.  ``q``, ``codes``
    and ``dead`` are contiguous CUDA uint8 tensors on one device.  Returns
    ``(dist, idx)``, each ``(nq, m)`` int32.  ``plan`` overrides
    ``plan_fused``'s choice (the tests hold each route to the plain version
    with it).  Raises ``ValueError`` for a shape ``plan_fused`` cannot
    serve."""
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
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rp_topk_scan(
            q.data_ptr(), codes.data_ptr(),
            None if dead is None else dead.data_ptr(), nq, rows, int(n_real),
            nb, m, _ROUTE_CODES[plan.route], plan.tq, plan.stages,
            plan.splits, plan.tiles_per_split, part.data_ptr(), stream,
        )
        _check_launch(lib, rc, f"rp_fused_topk ({plan.route} scan)")
        LAUNCHES[f"rp_fused_topk_{plan.route}"] += 1
        rc = lib.rp_topk_merge(part.data_ptr(), nq, plan.splits, m, nb,
                               dist.data_ptr(), idx.data_ptr(), stream)
        _check_launch(lib, rc, "rp_fused_topk (merge)")
        LAUNCHES["rp_topk_merge"] += 1
    return dist, idx


# -- public wrapper ----------------------------------------------------------------


def fused_topk(q, codes, n_real: int, m: int, *, dead=None):
    """Exact top-``m`` of one code chunk for a tile of queries.

    ``q`` (nq, n_bytes) uint8 packed queries, ``codes`` (rows, n_bytes)
    uint8 chunk (rows past ``n_real`` are ignored), ``dead`` an optional
    (rows,) uint8 tombstone mask (1 = deleted).  Returns ``(dist, idx)``,
    each (nq, m) int32: ascending distance, ties to the lower chunk-local
    id, empty slots ``(n_bits + 1, 2³¹−1)``.  A CPU tensor is computed by
    ``topk_plain``; a CUDA tensor by the kernel."""
    if q.device.type == "cpu":
        return topk_plain(q, codes, n_real, m, dead=dead)
    if q.device.type == "cuda":
        return rp_fused_topk(q, codes, n_real, m, dead=dead)
    raise ValueError(f"no top-k kernel for device {q.device}")
