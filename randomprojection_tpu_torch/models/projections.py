"""Gaussian and sparse (Achlioptas/Li) projection estimators (layer L5).

The counterparts of ``randomprojection_tpu/models/projections.py``.
Behavioral contracts: sklearn ``GaussianRandomProjection``
(``random_projection.py:471-613``) and ``SparseRandomProjection``
(``random_projection.py:616-827``).
"""

from __future__ import annotations

from typing import Optional

from randomprojection_tpu_torch.models.base import BaseRandomProjection
from randomprojection_tpu_torch.utils.validation import check_density

__all__ = ["GaussianRandomProjection", "SparseRandomProjection"]


class GaussianRandomProjection(BaseRandomProjection):
    """Dense Gaussian random projection: ``R[i,j] ~ N(0, 1/k)`` i.i.d.

    Examples
    --------
    >>> import numpy as np
    >>> rp = GaussianRandomProjection(n_components=64, random_state=0,
    ...                               backend="numpy")
    >>> Y = rp.fit_transform(np.random.default_rng(0).normal(size=(100, 512)))
    >>> Y.shape
    (100, 64)
    """

    _kind = "gaussian"


class SparseRandomProjection(BaseRandomProjection):
    """Sparse random projection (Achlioptas 2003 / Li-Hastie-Church 2006).

    ``R[i,j] ∈ {-v, 0, +v}`` with probabilities ``{density/2, 1-density,
    density/2}`` and ``v = sqrt(1/(density·k))``.  ``density='auto'``
    resolves to ``1/sqrt(d)``; ``density=1/3`` is Achlioptas' ``s=3``;
    ``density=1`` degenerates to dense ±1/√k.

    ``backend_options={'materialization': 'lazy'}`` never stores the
    matrix: the fused CUDA kernel regenerates it per batch.
    ``dense_output`` follows scipy semantics on the numpy backend; the
    torch backend always produces dense outputs.
    """

    _kind = "sparse"

    def __init__(
        self,
        n_components="auto",
        *,
        density="auto",
        eps: float = 0.1,
        dense_output: bool = False,
        compute_inverse_components: bool = False,
        random_state=None,
        backend="auto",
        backend_options: Optional[dict] = None,
    ):
        super().__init__(
            n_components,
            eps=eps,
            compute_inverse_components=compute_inverse_components,
            random_state=random_state,
            backend=backend,
            backend_options=backend_options,
        )
        self.density = density
        self.dense_output = dense_output

    def _resolve_density(self, n_features: int) -> float:
        return check_density(self.density, n_features)

    def _dense_output(self) -> bool:
        return self.dense_output
