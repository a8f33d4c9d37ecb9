"""Johnson–Lindenstrauss dimensioning math (layer L0).

Behavioral contract: sklearn ``random_projection.johnson_lindenstrauss_min_dim``
(``sklearn/random_projection.py:63-146``) — the canonical open-source
implementation of the capability surface of the (unreadable) reference repo
``afcarl/RandomProjection``; see ``SURVEY.md`` §0/§1 for provenance.

The JL lemma: for ``n`` points and distortion ``eps``, a random projection to

    k >= 4 * ln(n) / (eps**2 / 2 - eps**3 / 3)

dimensions preserves all pairwise squared distances within a ``(1 ± eps)``
factor with high probability (Dasgupta & Gupta, 1999 tightening of
Johnson & Lindenstrauss, 1984).  The reference's shorthand ``k ≈ 4·log n/ε²``
(``BASELINE.json:5``) is this same bound; we implement the full denominator.

Pure NumPy on purpose: this is host-side planning math, never a device op.
A copy of ``randomprojection_tpu/jl.py``: the port imports nothing of the
JAX package.
"""

from __future__ import annotations

import numpy as np

__all__ = ["johnson_lindenstrauss_min_dim"]


def johnson_lindenstrauss_min_dim(n_samples, *, eps=0.1):
    """Minimum number of components to guarantee the JL bound.

    Parameters
    ----------
    n_samples : int or array-like of int
        Number of samples whose pairwise distances must be preserved.
    eps : float or array-like of float in (0, 1), default=0.1
        Maximum allowed distortion of pairwise squared distances.

    Returns
    -------
    int or ndarray of int
        Minimal safe number of components.  Scalar inputs give a Python
        ``int``; array inputs broadcast and give an ``ndarray`` of ints.

    Raises
    ------
    ValueError
        If any ``eps`` is outside the open interval (0, 1), or any
        ``n_samples`` is not strictly positive.

    Examples
    --------
    >>> johnson_lindenstrauss_min_dim(1_000_000, eps=0.5)
    663
    """
    eps_arr = np.asarray(eps, dtype=np.float64)
    n_arr = np.asarray(n_samples)

    if np.any(eps_arr <= 0.0) or np.any(eps_arr >= 1.0):
        raise ValueError(f"The JL bound is defined for eps in (0, 1); got {eps!r}")
    if np.any(n_arr <= 0):
        raise ValueError(
            f"The JL bound is defined for n_samples > 0; got {n_samples!r}"
        )

    denominator = (eps_arr**2 / 2) - (eps_arr**3 / 3)
    min_dim = (4 * np.log(n_arr) / denominator).astype(np.int64)
    if min_dim.ndim == 0:
        return int(min_dim)
    return min_dim
