"""Host NumPy/SciPy backend — the CPU reference executor and parity oracle.

A copy of ``randomprojection_tpu/backends/numpy_backend.py`` with the same
salted stream (``_STREAM_SALT``), so one seed gives the same matrix here as
in the JAX package's numpy backend.  Dense BLAS GEMM for Gaussian, scipy
CSR SpMM for the sparse kernel (call-site contract
``random_projection.py:613`` and ``:825-827``).  The torch backend's dense
and split2 matrices are drawn from this same stream.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from randomprojection_tpu_torch.backends.base import (
    ProjectionBackend,
    ProjectionSpec,
)
from randomprojection_tpu_torch.ops.numpy_kernels import (
    gaussian_random_matrix,
    rademacher_random_matrix,
    sparse_random_matrix,
)

__all__ = ["NumpyBackend", "host_matrix"]


#: Salt mixed into the seed before deriving the matrix stream.  Without it,
#: a user who generated their data with ``default_rng(s)`` and fit with
#: ``random_state=s`` would get R equal to the first k rows of their own X
#: (same generator, same stream) — silently breaking the JL guarantee with
#: pathological self-projection distortions.
_STREAM_SALT = 0x52503141  # "RP1A"


def _bf16():
    from randomprojection_tpu_torch.utils.validation import bfloat16_dtype

    return bfloat16_dtype()


def host_matrix(spec: ProjectionSpec):
    """The spec's matrix from the salted numpy stream, in float64 (ndarray,
    or CSR for the sparse kind below density 1)."""
    rng = np.random.default_rng(np.random.SeedSequence([_STREAM_SALT, spec.seed]))
    if spec.kind == "gaussian":
        return gaussian_random_matrix(spec.n_components, spec.n_features, rng)
    if spec.kind == "sparse":
        return sparse_random_matrix(
            spec.n_components, spec.n_features, density=spec.density, rng=rng
        )
    if spec.kind == "rademacher":
        return rademacher_random_matrix(spec.n_components, spec.n_features, rng)
    raise ValueError(spec.kind)  # pragma: no cover - spec validates kind


class NumpyBackend(ProjectionBackend):
    """Single-host CPU executor: ndarray / CSR state, BLAS matmuls."""

    name = "numpy"

    def materialize(self, spec: ProjectionSpec):
        R = host_matrix(spec)
        # bf16 specs keep R in f32: quantizing R to 8 mantissa bits would
        # cost ~0.4% per entry (vs the ≤1e-3 distance budget); only the
        # OUTPUT is bf16, matching the torch backend's f32-compute policy
        store_dtype = (
            np.float32 if spec.np_dtype == _bf16() else spec.np_dtype
        )
        if sp.issparse(R):
            return R.astype(store_dtype)
        return np.ascontiguousarray(R, dtype=store_dtype)

    def transform(self, X, state, spec: ProjectionSpec, *, dense_output: bool = True):
        # scipy semantics (random_projection.py:825-827 via safe_sparse_dot):
        # output is sparse only if X is sparse AND dense_output=False.
        is_bf16_spec = spec.np_dtype == _bf16()
        if sp.issparse(X):
            Y = X @ state.T
            if dense_output and sp.issparse(Y):
                Y = Y.toarray()
            if is_bf16_spec and not sp.issparse(Y):
                # spec owns the output dtype regardless of input sparsity;
                # CSR outputs stay f32 (scipy cannot hold ml_dtypes)
                Y = Y.astype(spec.np_dtype, copy=False)
            return Y
        X = np.asarray(X)
        if X.dtype == _bf16():
            # ALWAYS upcast bf16 input (exact): scipy CSR cannot matmul
            # ml_dtypes arrays at all, and the dense product would be mixed
            # bf16×f32.  The spec-gated cast below restores bf16 output
            # when the spec says so; an f32 spec correctly yields f32.
            X = X.astype(np.float32)
        if sp.issparse(state):
            # dense X · sparse Rᵀ: compute (R · Xᵀ)ᵀ so the CSR matmul drives
            Y = np.ascontiguousarray((state @ X.T).T)
        else:
            Y = X @ state.T
        # only the bf16 policy casts at the edge: f32-fit/f64-transform must
        # keep returning f64 (sklearn parity)
        return Y.astype(spec.np_dtype, copy=False) if is_bf16_spec else Y

    def inverse_components(self, state, spec: ProjectionSpec) -> np.ndarray:
        # pinv of the densified (k, d) matrix (random_projection.py:360-365)
        R = state.toarray() if sp.issparse(state) else np.asarray(state)
        return np.linalg.pinv(R)  # shape (d, k)

    def inverse_transform(self, Y, inverse_components, spec: ProjectionSpec):
        if sp.issparse(Y):
            Y = Y.toarray()
        Y = np.asarray(Y)
        if spec.np_dtype == _bf16():
            # same bf16 edge policy as transform (cross-backend consistency)
            return (
                Y.astype(np.float32) @ inverse_components.T
            ).astype(spec.np_dtype, copy=False)
        return Y @ inverse_components.T

    def components_to_numpy(self, state, spec: ProjectionSpec):
        return state
