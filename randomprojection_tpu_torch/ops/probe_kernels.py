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
   chunks, and the top-k kernel K4 (``topk_kernels.fused_topk``) re-ranks
   the tile against the ``cap`` candidate rows with the dead mask; local
   positions map back to global ids on the device.  Ascending slot order
   is ascending global id, so K4's lower-local-id tie rule is the
   documented lower-global-id rule.

Kernel and plain version
------------------------
``rp_probe_gather`` launches the three passes of ``csrc/probe.cu`` (count,
scan, copy; each counted in ``LAUNCHES``).  ``probe_plain`` computes the
same function with torch ops: the run lengths, ``cumsum`` for the offsets
and ``repeat_interleave`` to expand the runs.  The public wrapper
``probe_gather`` dispatches on the device: a CPU tensor goes to the plain
version, a CUDA tensor to the kernel, anything else raises.

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

import ctypes
from typing import NamedTuple, Optional

from randomprojection_tpu_torch.ops import _build, topk_kernels

__all__ = [
    "LAUNCHES",
    "MAX_CAP",
    "ProbePlan",
    "device_band_keys",
    "device_probe_topk",
    "plan_probe",
    "probe_gather",
    "probe_plain",
    "reset_launches",
    "rp_probe_gather",
    "runs_cap",
]

#: kernel launches since the last ``reset_launches()`` (three per
#: ``rp_probe_gather`` call: count, scan, copy); only the CUDA launcher
#: adds to it
LAUNCHES = {"rp_probe": 0}

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

_INT32_MAX = (1 << 31) - 1
_SENTINEL_ID = _INT32_MAX  # empty slot: sorts past every real id
_RUNS_PER_BLOCK = 1024  # kRunsPerBlock in csrc/probe.cu
_SRC = "probe"


class ProbePlan(NamedTuple):
    """One device-probe tiling: ``tq`` query rows per dispatch (the tier
    clamps its serving tile to it) and ``cap`` the pow2 candidate-slot
    budget of a tile (overflow falls back to the exact path)."""

    tq: int
    cap: int


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


def device_band_keys(codes, bands: int, band_bits: int):
    """Band keys of a packed uint8 code tile on its device: ``(bands, n)``
    int32, key ``j`` of a row being its code bits ``[j·b, (j+1)·b)``,
    little-endian within each byte (equal to the host
    ``ann.lsh.band_keys``)."""
    import torch

    n = codes.shape[0]
    shifts = torch.arange(8, dtype=torch.int32, device=codes.device)
    bits = (codes.to(torch.int32)[:, :, None] >> shifts) & 1
    bits = bits.reshape(n, -1)[:, : bands * band_bits]
    w = torch.ones((), dtype=torch.int32, device=codes.device) << torch.arange(
        band_bits, dtype=torch.int32, device=codes.device)
    keys = (bits.reshape(n, bands, band_bits) * w).sum(dim=2, dtype=torch.int32)
    return keys.T.contiguous()


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
    slots = torch.full((int(cap),), _SENTINEL_ID, dtype=torch.int32, device=dev)
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
        args = [p, p, p, p, p, i32, i32, i32, i32, i64, i64]
        lib.rp_probe_count.argtypes = args + [p, p, p]
        lib.rp_probe_count.restype = i32
        lib.rp_probe_scan.argtypes = [p, i64, i64, p, p, p]
        lib.rp_probe_scan.restype = i32
        lib.rp_probe_copy.argtypes = args + [p, p, p, p]
        lib.rp_probe_copy.restype = i32
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
    """Launch K5's three passes on the tensors' card: the run lengths
    (into ``counts`` and per-block sums), the scan of the block sums (the
    total decides overflow and ``stats``), and the run copy with the
    sentinel fill.  Every plane is a contiguous CUDA int32 tensor on one
    device.  Returns ``(slots (cap,), counts (tq,), stats (8,))``."""
    import torch

    _validate(qkeys, masks, active, indptr, ids, cap)
    planes = (qkeys, masks, active, indptr, ids)
    if not all(t.is_cuda and t.device == qkeys.device and t.is_contiguous()
               for t in planes):
        raise ValueError("rp_probe_gather takes contiguous CUDA tensors on one device")
    dev = qkeys.device
    bands, tq = qkeys.shape
    n_probes = masks.shape[1]
    n_runs = tq * bands * n_probes
    slots = torch.empty(int(cap), dtype=torch.int32, device=dev)
    counts = torch.zeros(tq, dtype=torch.int32, device=dev)
    stats = torch.zeros(8, dtype=torch.int32, device=dev)
    if n_runs == 0:
        slots.fill_(_SENTINEL_ID)
        return slots, counts, stats
    n_blocks = -(-n_runs // _RUNS_PER_BLOCK)
    bsum = torch.empty(n_blocks, dtype=torch.int64, device=dev)
    total = torch.empty(1, dtype=torch.int64, device=dev)
    nb = indptr.shape[1] - 1
    common = (qkeys.data_ptr(), masks.data_ptr(), active.data_ptr(),
              indptr.data_ptr(), ids.data_ptr(), tq, bands, n_probes, nb,
              ids.shape[1], int(cap))
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rp_probe_count(*common, counts.data_ptr(), bsum.data_ptr(),
                                stream)
        _check_launch(lib, rc, "rp_probe_gather (count)")
        LAUNCHES["rp_probe"] += 1
        rc = lib.rp_probe_scan(bsum.data_ptr(), n_blocks, int(cap),
                               total.data_ptr(), stats.data_ptr(), stream)
        _check_launch(lib, rc, "rp_probe_gather (scan)")
        LAUNCHES["rp_probe"] += 1
        rc = lib.rp_probe_copy(*common, bsum.data_ptr(), total.data_ptr(),
                               slots.data_ptr(), stream)
        _check_launch(lib, rc, "rp_probe_gather (copy)")
        LAUNCHES["rp_probe"] += 1
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


def device_probe_topk(q, masks, active, indptr, ids, dead_full, chunks, m: int,
                      *, cap: int, band_bits: int):
    """The probe → dedup → gather → re-rank composite for one query tile,
    on the tile's device with no host sync.

    ``q`` (tq, n_bytes) uint8 queries, ``masks``/``active``/``indptr``/
    ``ids`` as ``probe_gather``, ``dead_full`` (n_total,) uint8 tombstones
    over global ids, ``chunks`` ``[(codes, row0, rows), ...]`` the resident
    code chunks.  Returns device tensors ``(dist (tq, m), gid (tq, m),
    stats (8,), counts (tq,))``, ``stats = [gathered, overflow,
    live_candidates, 0, ...]``; the caller applies the fallback ladder
    (overflow, starved, dense) before trusting the tile."""
    import torch

    n_total = int(dead_full.shape[0])
    qkeys = device_band_keys(q, int(indptr.shape[0]), band_bits)
    slots, cnt, stat = probe_gather(qkeys, masks, active, indptr, ids, cap=cap)
    # ascending slot order is ascending global id (the tie rule); every
    # duplicate, sentinel or tombstoned slot goes dead
    s = torch.sort(slots).values
    dup = torch.zeros_like(s, dtype=torch.bool)
    dup[1:] = s[1:] == s[:-1]
    sc = s.clamp(0, max(n_total - 1, 0)).long()
    dead_c = (s >= n_total) | dup | (dead_full[sc] != 0)
    n_live = (~dead_c).sum(dtype=torch.int32)
    # each live id lies in exactly one chunk's rows; dead slots keep any row
    g = None
    for codes, row0, rows in chunks:
        rows_c = codes[(sc - row0).clamp(0, rows - 1)]
        if g is None:
            g = rows_c
        else:
            inc = (sc >= row0) & (sc < row0 + rows)
            g = torch.where(inc[:, None], rows_c, g)
    d, idx = topk_kernels.fused_topk(q, g, cap, m, dead=dead_c.to(torch.uint8))
    gid = torch.where(idx >= cap, _INT32_MAX, s[idx.long().clamp(0, cap - 1)])
    stat = torch.cat([stat[:2], n_live.reshape(1), stat[3:]])
    return d, gid, stat, cnt
