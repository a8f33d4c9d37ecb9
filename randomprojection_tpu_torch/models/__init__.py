"""Estimators of the port (layer L5): the JL projections, SimHash serving
and CountSketch."""

from randomprojection_tpu_torch.models.base import BaseRandomProjection
from randomprojection_tpu_torch.models.projections import (
    GaussianRandomProjection,
    SparseRandomProjection,
)
from randomprojection_tpu_torch.models.sketch import (
    CountSketch,
    SignRandomProjection,
    SimHashIndex,
    TopKServer,
    cosine_from_hamming,
    pairwise_hamming,
    pairwise_hamming_device,
    pairwise_hamming_sharded,
    topk_bruteforce,
)

__all__ = [
    "BaseRandomProjection",
    "GaussianRandomProjection",
    "SparseRandomProjection",
    "SignRandomProjection",
    "CountSketch",
    "SimHashIndex",
    "TopKServer",
    "cosine_from_hamming",
    "pairwise_hamming",
    "pairwise_hamming_device",
    "pairwise_hamming_sharded",
    "topk_bruteforce",
]
