"""Plain reference of config 4: the exact Hamming top-m of packed codes.

Distances come from a product of bit vectors: for 0/1 vectors ``q`` and
``c``, ``popcount(q ^ c) = |q| + |c| - 2 q.c``.  The codes are unpacked
a block of rows at a time into 0/1 float16 vectors and ``q.c`` is one
matrix product, exact (products of 0 and 1, sums of at most the bit
width: integers that float16 and its float32 accumulator hold exactly).
Each block keeps its ``m`` best by the key ``dist * 2**B + local id``,
and the blocks' candidates merge by ``dist * 2**31 + id``, so ties go to
the lower id.  ``ties='higher'`` is the control: the same answer with
ties broken towards the higher id, a broken guarantee.
"""

from __future__ import annotations

ID_BITS = 31  # global ids below 2**31; distances below 2**16


def unpack_bits(codes):
    """``(n, n_bytes)`` uint8 → ``(n, 8 * n_bytes)`` float16 of 0 and 1,
    least significant bit of each byte first."""
    import torch

    shifts = torch.arange(8, dtype=torch.uint8, device=codes.device)
    bits = (codes[:, :, None] >> shifts) & 1
    return bits.reshape(codes.shape[0], -1).to(torch.float16)


def topk(queries, codes, m: int, *, ties: str = "lower",
         block_rows: int = 1 << 19, query_rows: int = 1024):
    """``(dist, idx)`` int64 ``(nq, m)`` of each query's ``m`` nearest
    codes, computed on ``codes``' device, sorted by (distance, id)."""
    import torch

    if ties not in ("lower", "higher"):
        raise ValueError(f"ties must be 'lower' or 'higher', got {ties!r}")
    dev = codes.device
    n = codes.shape[0]
    if n >= 1 << ID_BITS:
        raise ValueError(f"{n} codes do not fit {ID_BITS}-bit ids")
    n_bits = codes.shape[1] * 8
    local_bits = max(int(block_rows - 1).bit_length(), 1)
    if (n_bits + 1) << local_bits >= 1 << 31:
        raise ValueError("block_rows too large for int32 block keys")
    queries = queries.to(dev)
    m = min(m, n)
    qblocks = []
    for q0 in range(0, queries.shape[0], query_rows):
        qb = unpack_bits(queries[q0:q0 + query_rows])
        qblocks.append([qb, qb.float().sum(1).int()[:, None], None])
    for lo in range(0, n, block_rows):
        cb = unpack_bits(codes[lo:lo + block_rows])
        c_pop = cb.float().sum(1).int()[None, :]
        local = torch.arange(cb.shape[0], dtype=torch.int32, device=dev)
        if ties == "higher":
            local = cb.shape[0] - 1 - local
        for entry in qblocks:
            qb, q_pop, best = entry
            dist = q_pop + c_pop - 2 * (qb @ cb.T).int()
            kb = torch.topk((dist << local_bits) | local[None, :],
                            min(m, cb.shape[0]), dim=1, largest=False).values
            d = (kb >> local_bits).long()
            i = (kb & ((1 << local_bits) - 1)).long()
            i = lo + (cb.shape[0] - 1 - i if ties == "higher" else i)
            gid = ((1 << ID_BITS) - 1 - i) if ties == "higher" else i
            key = (d << ID_BITS) | gid
            entry[2] = key if best is None else torch.topk(
                torch.cat([best, key], 1), m, dim=1, largest=False).values
    out_d, out_i = [], []
    for _qb, _pop, best in qblocks:
        best = torch.sort(best, dim=1).values
        gid = best & ((1 << ID_BITS) - 1)
        out_d.append(best >> ID_BITS)
        out_i.append(((1 << ID_BITS) - 1 - gid) if ties == "higher" else gid)
    return torch.cat(out_d), torch.cat(out_i)


def mismatches(dist, idx, ref_dist, ref_idx) -> int:
    """Entries of the (dist, id) planes that differ from the reference."""
    import torch

    d = torch.as_tensor(dist).long().to(ref_dist.device)
    i = torch.as_tensor(idx).long().to(ref_idx.device)
    return int(((d != ref_dist) | (i != ref_idx)).sum())
