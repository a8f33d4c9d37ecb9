"""Estimators of the port (layer L5): the JL projections."""

from randomprojection_tpu_torch.models.base import BaseRandomProjection
from randomprojection_tpu_torch.models.projections import (
    GaussianRandomProjection,
    SparseRandomProjection,
)

__all__ = [
    "BaseRandomProjection",
    "GaussianRandomProjection",
    "SparseRandomProjection",
]
