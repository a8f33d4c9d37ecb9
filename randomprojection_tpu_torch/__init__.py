"""randomprojection_tpu_torch — the PyTorch/CUDA port of randomprojection_tpu.

The JL estimators (Gaussian and sparse Achlioptas/Li random projection,
JL auto-dimensioning, streamed row-batch transform with cursor resume)
behind the same ``ProjectionBackend`` boundary, and config-4 SimHash
serving (``SignRandomProjection`` codes, ``SimHashIndex.query_topk``,
``TopKServer``) with its multi-probe LSH tier (``ann.LSHSimHashIndex``),
executed on an NVIDIA card: plain products through
torch; the fused lazy-mask projection and mask writer
(``csrc/fused_project.cu``) and the fused Hamming top-k
(``csrc/topk.cu``) and the LSH tier's CSR probe gather (``csrc/probe.cu``)
as hand-written CUDA kernels for Hopper.  ``backend='auto'`` is the card; the CPU runs
only when asked (``backend_options={'device': 'cpu'}``).

The package imports neither JAX nor ``randomprojection_tpu``; the tests
hold it to that package.
"""

from randomprojection_tpu_torch.jl import johnson_lindenstrauss_min_dim
from randomprojection_tpu_torch.utils.validation import (
    DataDimensionalityWarning,
    NotFittedError,
)

__version__ = "0.1.0"

_LAZY_ESTIMATORS = (
    "BaseRandomProjection",
    "GaussianRandomProjection",
    "SparseRandomProjection",
    "SignRandomProjection",
    "SimHashIndex",
    "TopKServer",
    "pairwise_hamming",
    "pairwise_hamming_device",
    "cosine_from_hamming",
    "topk_bruteforce",
)

_LAZY_ANN = ("ann", "LSHSimHashIndex")

__all__ = [
    "johnson_lindenstrauss_min_dim",
    "DataDimensionalityWarning",
    "NotFittedError",
    "from_reference",
    *_LAZY_ESTIMATORS,
    *_LAZY_ANN,
]


def __getattr__(name):
    # lazy, as the reference package: importing the package stays cheap
    if name in _LAZY_ESTIMATORS:
        from randomprojection_tpu_torch import models

        return getattr(models, name)
    if name in _LAZY_ANN:
        from randomprojection_tpu_torch import ann

        return ann if name == "ann" else getattr(ann, name)
    if name == "from_reference":
        from randomprojection_tpu_torch.interop import from_reference

        return from_reference
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
