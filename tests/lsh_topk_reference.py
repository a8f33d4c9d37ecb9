"""Plain reference of the multi-probe LSH tier: the exact top-m of each
query over its tile's candidate union.

- A code's band key ``j`` is its code bits ``[j·b, (j+1)·b)``, bit ``t``
  of the key being code bit ``j·b + t``; code bit ``i`` is bit ``i % 8``
  of byte ``i // 8`` (little-endian within each byte).  Read bit by bit.
- The probe masks are the first ``probes`` of the perturbation sequence
  of multi-probe LSH (Lv et al., VLDB 2007) for sign bits, every bit
  equally confident: the exact bucket (mask 0), then the masks of one
  set bit, then of two, ..., each popcount in ascending value.
- A tile's candidate union is every live code whose key in some band
  equals some query's key in that band XOR some mask: a membership mask
  over all codes, a band and a block of rows at a time.
- Each query's answer is the exact top-``m`` over the union, by
  ``exact(queries, codes, m) -> (dist, idx)`` (ties to the lower id of
  the rows it is given, which ascend with the global ids); a union of
  fewer than ``min(m, n_live)`` codes, or of more than ``fallback_density
  · n_live``, is served exact over every live code instead.

Imports nothing but torch, so it stands apart from the program it checks.
"""

from __future__ import annotations

import itertools


def probe_masks(band_bits: int, probes: int) -> list:
    """The first ``probes`` masks of the perturbation sequence."""
    out = []
    for ones in range(band_bits + 1):
        level = sorted(sum(1 << p for p in c)
                       for c in itertools.combinations(range(band_bits), ones))
        out += level[:probes - len(out)]
        if len(out) == probes:
            break
    return out


def band_key(codes, band: int, band_bits: int):
    """``(n,)`` int64: band ``band``'s key of every row of ``codes``
    (``(n, n_bytes)`` uint8), bit by bit."""
    import torch

    key = torch.zeros(codes.shape[0], dtype=torch.int64, device=codes.device)
    for t in range(band_bits):
        i = band * band_bits + t
        key |= ((codes[:, i // 8] >> (i % 8)) & 1).to(torch.int64) << t
    return key


def unions(tiles, codes, *, bands: int, band_bits: int, probes: int,
           block_rows: int = 1 << 24):
    """``(len(tiles), n)`` bool: each tile's candidate union over
    ``codes`` (tombstones not yet removed)."""
    import torch

    dev = codes.device
    masks = torch.tensor(probe_masks(band_bits, probes), dtype=torch.int64,
                         device=dev)
    # per (tile, band) a table over the 2^b buckets: the buckets it probes
    probed = torch.zeros((len(tiles), bands, 1 << band_bits), dtype=torch.bool,
                         device=dev)
    for t, q in enumerate(tiles):
        for j in range(bands):
            qk = band_key(q.to(dev), j, band_bits)
            probed[t, j, (qk[:, None] ^ masks[None, :]).reshape(-1)] = True
    out = torch.zeros((len(tiles), codes.shape[0]), dtype=torch.bool,
                      device=dev)
    for lo in range(0, codes.shape[0], block_rows):
        block = codes[lo:lo + block_rows]
        for j in range(bands):
            key = band_key(block, j, band_bits)
            for t in range(len(tiles)):
                out[t, lo:lo + block.shape[0]] |= probed[t, j, key]
    return out


def topk(tiles, codes, m: int, *, bands: int, band_bits: int, probes: int,
         fallback_density: float, exact, dead=None):
    """Each tile's ``(dist, idx)`` (int64, ``(tq, min(m, n_live))``), and
    how many tiles were served exact over every live code.  ``tiles`` are
    ``(tq, n_bytes)`` uint8 query tensors, ``dead`` an optional ``(n,)``
    bool tombstone plane."""
    import torch

    dev = codes.device
    live = (torch.ones(codes.shape[0], dtype=torch.bool, device=dev)
            if dead is None else ~dead.to(dev))
    n_live = int(live.sum())
    m_eff = min(m, n_live)
    out, fell_back = [], 0
    for q, member in zip(tiles, unions(tiles, codes, bands=bands,
                                       band_bits=band_bits, probes=probes)):
        member &= live
        count = int(member.sum())
        if count < m_eff or count > fallback_density * n_live:
            member, fell_back = live, fell_back + 1
        ids = torch.nonzero(member).reshape(-1)
        d, i = exact(q.to(dev), codes[ids], m_eff)
        out.append((d, ids[i.to(dev)]))
    return out, fell_back
