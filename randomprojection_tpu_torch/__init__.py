"""randomprojection_tpu_torch — the PyTorch/CUDA port of randomprojection_tpu.

The JL estimators (Gaussian and sparse Achlioptas/Li random projection,
JL auto-dimensioning, streamed row-batch transform with cursor resume)
behind the same ``ProjectionBackend`` boundary, and config-4 SimHash
serving (``SignRandomProjection`` codes, ``SimHashIndex.query_topk``,
``TopKServer``) with its multi-probe LSH tier (``ann.LSHSimHashIndex``)
and tiered hot/cold residency (``SimHashIndex(hbm_budget_bytes=...)``),
config-5 Count-Sketch feature hashing (``CountSketch``,
``ops.hashing.FeatureHasher``, ``streaming.TokenSource``),
model persistence (``serialize.save_model``/``load_model``), durable index
snapshots with exactly-once ingest (``save_index``/``load_index``,
``DurableIngest``) and the sharded serving tier (``ShardedSimHashIndex``,
``ShardedTopKServer``, ``LSHShardedSimHashIndex``, their layout-agnostic
snapshots ``save_sharded_index``/``load_sharded_index``), executed on an
NVIDIA card: plain products through
torch; the fused lazy-mask projection and mask writer
(``csrc/fused_project.cu``) and the fused Hamming top-k
(``csrc/topk.cu``) and the LSH tier's CSR probe gather (``csrc/probe.cu``)
as hand-written CUDA kernels for Hopper.  ``backend='auto'`` is the card; the CPU runs
only when asked (``backend_options={'device': 'cpu'}``).

The package imports neither JAX nor ``randomprojection_tpu``; the tests
hold it to that package.  ``__all__`` is the reference's; the port adds
``from_reference`` (``interop.py``) and the ``ann`` subpackage as
attributes.
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
    "CountSketch",
    "SimHashIndex",
    "TopKServer",
    "pairwise_hamming",
    "pairwise_hamming_device",
    "pairwise_hamming_sharded",
    "cosine_from_hamming",
    "topk_bruteforce",
)

_LAZY_DURABLE = (
    "DurableIngest",
    "save_index",
    "load_index",
    "save_sharded_index",
    "load_sharded_index",
)

_LAZY_SERVING = ("ShardedSimHashIndex", "ShardedTopKServer", "shard_devices")

_LAZY_ANN = (
    "LSHSimHashIndex",
    "LSHShardedSimHashIndex",
    "load_lsh_index",
    "load_lsh_sharded_index",
)

__all__ = [
    "johnson_lindenstrauss_min_dim",
    "DataDimensionalityWarning",
    "NotFittedError",
    *_LAZY_ESTIMATORS,
    *_LAZY_DURABLE,
    *_LAZY_SERVING,
    *_LAZY_ANN,
]


def __getattr__(name):
    # lazy, as the reference package: importing the package stays cheap
    if name in _LAZY_ESTIMATORS:
        from randomprojection_tpu_torch import models

        return getattr(models, name)
    if name in _LAZY_DURABLE:
        from randomprojection_tpu_torch import durable

        return getattr(durable, name)
    if name in _LAZY_SERVING:
        from randomprojection_tpu_torch import serving

        return getattr(serving, name)
    if name in _LAZY_ANN or name == "ann":
        # import_module, not ``from ... import ann``: that form asks this
        # hook for ``ann`` again before the subpackage is imported
        from importlib import import_module

        ann = import_module("randomprojection_tpu_torch.ann")
        return ann if name == "ann" else getattr(ann, name)
    if name == "from_reference":
        from randomprojection_tpu_torch.interop import from_reference

        return from_reference
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
