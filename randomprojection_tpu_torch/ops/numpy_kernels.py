"""Host-side NumPy projection-matrix kernels (numpy backend / parity oracle).

A copy of ``randomprojection_tpu/ops/numpy_kernels.py``: the port imports
nothing of the JAX package, and the same generator draws give the same
matrices in both packages.  Same distributions as sklearn
(``sklearn/random_projection.py:169-305``), generated with NumPy's
Generator on host.

The sparse kernel is fully vectorized: i.i.d. per-entry ``{+v, 0, -v}``
sampling is distributionally identical to per-row Binomial(d, density) nnz
counts + uniform index sampling + fair signs.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.sparse as sp

from randomprojection_tpu_torch.utils.validation import (
    check_density,
    check_input_size,
)

__all__ = [
    "gaussian_random_matrix",
    "sparse_random_matrix",
    "rademacher_random_matrix",
]


def gaussian_random_matrix(n_components, n_features, rng: np.random.Generator):
    """Dense ``(k, d)`` matrix with i.i.d. N(0, 1/k) entries (RP.py:169-206)."""
    check_input_size(n_components, n_features)
    return rng.normal(
        loc=0.0, scale=1.0 / math.sqrt(n_components), size=(n_components, n_features)
    )


def sparse_random_matrix(
    n_components, n_features, density="auto", rng: np.random.Generator | None = None
):
    """Sparse Achlioptas/Li ``(k, d)`` matrix (RP.py:209-305).

    Returns a CSR array for ``density < 1`` (values ``±sqrt(1/(density·k))``)
    and a dense ``±1/sqrt(k)`` ndarray for ``density == 1`` (the RP.py:269-272
    fast path).
    """
    check_input_size(n_components, n_features)
    density = check_density(density, n_features)
    if rng is None:
        rng = np.random.default_rng()

    if density == 1.0:
        signs = rng.integers(0, 2, size=(n_components, n_features)) * 2 - 1
        return signs / math.sqrt(n_components)

    v = 1.0 / math.sqrt(density * n_components)
    if n_components * n_features <= (1 << 24):
        # small matrices: one vectorized pass over a dense uniform draw
        u = rng.random((n_components, n_features))
        data = np.where(u < density / 2, v, np.where(u < density, -v, 0.0))
        return sp.csr_array(data)

    # large matrices: O(nnz) memory — per-row Binomial(d, density) nnz count
    # + uniform index sample + fair signs (the RP.py:284-297 construction,
    # distributionally identical to the i.i.d. per-entry model above)
    nnz_per_row = rng.binomial(n_features, density, size=n_components)
    indptr = np.zeros(n_components + 1, dtype=np.int64)
    np.cumsum(nnz_per_row, out=indptr[1:])
    indices = np.empty(indptr[-1], dtype=np.int64)
    for i in range(n_components):
        indices[indptr[i] : indptr[i + 1]] = rng.choice(
            n_features, size=nnz_per_row[i], replace=False
        )
    data = (rng.integers(0, 2, size=indptr[-1]) * 2 - 1) * v
    return sp.csr_array(
        (data, indices, indptr), shape=(n_components, n_features)
    )


def rademacher_random_matrix(n_components, n_features, rng: np.random.Generator):
    """Dense ``(k, d)`` sign-RP matrix: entries ±1/sqrt(k) each w.p. 1/2."""
    check_input_size(n_components, n_features)
    signs = rng.integers(0, 2, size=(n_components, n_features)) * 2 - 1
    return signs / math.sqrt(n_components)
