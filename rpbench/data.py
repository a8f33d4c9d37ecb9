"""Inputs made from a run's seed, on the device, in a few large calls.

- ``normal_rows``: float32 rows of N(0, 1), the projection's input.
- ``planted_codes``: packed SimHash codes with planted neighbours, the
  generator of the port's LSH bench (``LSH_BENCH_SHAPES``) rewritten in
  torch: clusters of ``cluster`` rows around uniform random centres, each
  row with ``noise_bits`` random bit positions flipped (a position drawn
  twice flips back).  Uniform codes have no neighbours: every distance
  concentrates at ``n_bits / 2``.
- ``flip_bits``: the same perturbation of given rows (queries are corpus
  rows with their own bits flipped, so every answer is a neighbourhood).

Each takes a ``torch.Generator`` on the target device; the same seed
gives the same tensors on the same device.  ``reservoir_slot`` and
``keep`` draw, from the run's seed, the uniform sample of a window's
outputs that a check reads.
"""

from __future__ import annotations


def reservoir_slot(rng, seen: int, k: int):
    """Algorithm R: the slot of a uniform sample of ``k`` that the item
    numbered ``seen`` (from 0) takes, or None; ``rng`` is a
    ``random.Random`` seeded from the run's seed."""
    slot = seen if seen < k else rng.randrange(seen + 1)
    return slot if slot < k else None


def keep(kept: list, slot, item) -> None:
    """Put ``item`` into a reservoir list at ``slot`` (None: drop it)."""
    if slot is None:
        return
    if slot == len(kept):
        kept.append(item)
    else:
        kept[slot] = item


def derive(seed: int, stream: int) -> int:
    """A 63-bit number drawn from ``(seed, stream)``."""
    import numpy as np

    ss = np.random.SeedSequence([int(seed), int(stream)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, device, stream: int = 0):
    """A generator on ``device`` seeded from ``(seed, stream)``."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, stream))
    return g


def normal_rows(n: int, d: int, g, *, device):
    import torch

    x = torch.empty((n, d), dtype=torch.float32, device=device)
    x.normal_(generator=g)
    return x


def flip_bits(codes, flips: int, g) -> None:
    """XOR ``flips`` random bit positions into every row of ``codes`` in
    place, one position a row a step (duplicates cancel, as the bench's
    unbuffered ``bitwise_xor.at`` does)."""
    import torch

    n, n_bytes = codes.shape
    rows = torch.arange(n, device=codes.device)
    for _ in range(flips):
        pos = torch.randint(0, n_bytes * 8, (n,), generator=g,
                            device=codes.device)
        bit = torch.bitwise_left_shift(
            torch.ones((), dtype=torch.uint8, device=codes.device),
            (pos & 7).to(torch.uint8))
        codes[rows, pos >> 3] ^= bit


def planted_codes(n: int, n_bytes: int, cluster: int, noise_bits: int, g, *,
                  device, block_rows: int = 1 << 24):
    """``(n, n_bytes)`` uint8 codes: row ``i`` is centre ``i // cluster``
    with ``noise_bits`` bits flipped.  Made block by block, so the
    transient index tensors stay a fraction of the codes."""
    import torch

    n_centres = -(-n // cluster)
    centres = torch.randint(0, 256, (n_centres, n_bytes), generator=g,
                            dtype=torch.uint8, device=device)
    codes = torch.empty((n, n_bytes), dtype=torch.uint8, device=device)
    for lo in range(0, n, block_rows):
        hi = min(lo + block_rows, n)
        ids = torch.arange(lo, hi, device=device) // cluster
        block = centres[ids]
        flip_bits(block, noise_bits, g)
        codes[lo:hi] = block
    return codes


def planted_queries(codes, nq: int, noise_bits: int, g):
    """``nq`` queries: random corpus rows with ``noise_bits`` flipped."""
    import torch

    rows = torch.randint(0, codes.shape[0], (nq,), generator=g,
                         device=codes.device)
    q = codes[rows].clone()
    flip_bits(q, noise_bits, g)
    return q
