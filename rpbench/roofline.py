"""Peaks of one H100 and the least time each kernel's work can take.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, without sparsity)
at its 700 W power limit; a card set below that limit runs under them, and
every result names its card.  A bound is the larger of the bytes the
function must move over the memory's rate and the operations it must do
over the unit's peak, counted from the shapes: each input byte read once,
each output byte written once, whatever a kernel reads again.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
INT8_OPS_PER_S = 1979e12


def k1_bound_s(n: int, d: int, k: int, density: float) -> float:
    """The lazy projection ``Y = X @ R.T`` of ``n`` float32 rows of ``d`` to
    ``k`` float32 columns, ``R`` regenerated from its seed (no bytes): it
    reads ``4nd`` and writes ``4nk`` bytes, and to float32 grade on the
    bf16 tensor cores takes two bf16 products over the ``density * k * d``
    nonzeros of ``R``."""
    nbytes = 4 * n * d + 4 * n * k
    ops = 2 * (2 * n * density * k * d)
    return max(nbytes / HBM_BYTES_PER_S, ops / BF16_FLOP_PER_S)


def k4_bound_s(nq: int, n_codes: int, n_bytes: int, m: int) -> float:
    """Exact Hamming top-``m`` of ``nq`` packed queries against ``n_codes``
    codes of ``n_bytes``: codes and queries read once, ``m`` (int32 dist,
    int32 id) pairs written a query; the binary product counted as one
    8-bit multiply-add a byte of each pair, ``2 * nq * n_codes * n_bytes``
    operations at the int8 rate."""
    nbytes = n_codes * n_bytes + nq * n_bytes + nq * m * 8
    ops = 2 * nq * n_codes * n_bytes
    return max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S)
