"""The least time of K5, the LSH tier's CSR probe gather
(``rp_probe_gather``), from one launch's shapes: the bytes the function
must move at the card's memory rate (``roofline.HBM_BYTES_PER_S``).  Its
operations, a few integer ops a run and a slot, bound nothing."""

from __future__ import annotations

from rpbench.roofline import HBM_BYTES_PER_S


def k5_bytes(rows: int, bands: int, probes: int, gathered: int,
             cap: int) -> int:
    """Bytes one launch must move: it reads the tile's band keys
    (``bands · rows`` int32), the probe masks and the active flags, two
    ``indptr`` words a run (``rows · bands · probes`` runs) and each
    gathered id once, and writes the ``cap`` slots, a count a query and
    the 8 stats words."""
    runs = rows * bands * probes
    read = 4 * (bands * rows + probes + rows + 2 * runs + gathered)
    written = 4 * (cap + rows + 8)
    return read + written


def k5_bound_s(rows: int, bands: int, probes: int, gathered: int,
               cap: int) -> float:
    return k5_bytes(rows, bands, probes, gathered, cap) / HBM_BYTES_PER_S
