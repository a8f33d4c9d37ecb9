"""``BaseRandomProjection`` — shared fit/transform machinery (layer L5).

The counterpart of ``randomprojection_tpu/models/base.py``.  Behavioral
contract: sklearn ``BaseRandomProjection`` (``random_projection.py:308-468``):

- ``fit`` uses only ``X.shape`` and dtype, never the values — so
  ``fit_schema(n, d)`` fits with no data at all, and a tensor already on
  the card is never copied to fit.
- ``n_components='auto'`` resolves via the JL bound; raises when the bound
  exceeds ``n_features``; a user-fixed ``k > d`` warns
  ``DataDimensionalityWarning``.
- Dtype policy: f32→f32, f64→f64, ints promote to f64.
- Determinism: same seed ⇒ identical matrix and outputs within a backend.

``backend='auto'`` is the torch backend on the card; a fitted model is its
``ProjectionSpec`` (seed + shape + kind).
"""

from __future__ import annotations

import numbers
import sys
import warnings
from typing import Optional

import numpy as np

from randomprojection_tpu_torch.backends.base import (
    ProjectionSpec,
    resolve_backend,
)
from randomprojection_tpu_torch.jl import johnson_lindenstrauss_min_dim
from randomprojection_tpu_torch.utils.validation import (
    DataDimensionalityWarning,
    NotFittedError,
    bfloat16_dtype,
    check_array,
    resolve_transform_dtype,
)

__all__ = ["BaseRandomProjection", "ParamsMixin"]


class ParamsMixin:
    """sklearn-compatible ``get_params``/``set_params`` support.

    Parameter names are introspected from ``__init__`` the way sklearn does,
    so subclasses adding constructor params need no override.
    """

    @classmethod
    def _get_param_names(cls):
        import inspect

        sig = inspect.signature(cls.__init__)
        return sorted(
            p.name
            for p in sig.parameters.values()
            if p.name != "self" and p.kind is not p.VAR_KEYWORD
        )

    def get_params(self, deep: bool = True) -> dict:
        """The exact constructor arguments, so ``sklearn.clone(est)``
        reconstructs an identical unfitted estimator."""
        return {name: getattr(self, name) for name in self._get_param_names()}

    def set_params(self, **params):
        """In-place parameter update.  Unknown names raise."""
        valid = self._get_param_names()
        for name, value in params.items():
            if name not in valid:
                raise ValueError(
                    f"Invalid parameter {name!r} for estimator "
                    f"{type(self).__name__}. Valid parameters are: {valid}."
                )
            setattr(self, name, value)
        return self

    def __repr__(self):
        params = ", ".join(f"{k}={v!r}" for k, v in self.get_params().items())
        return f"{type(self).__name__}({params})"


def _resolve_seed(random_state) -> int:
    """Collapse ``random_state`` to one int seed — the only RNG state kept.

    ``None`` draws fresh OS entropy (so refits differ) but the *drawn* seed
    is stored, keeping every fitted model exactly reproducible.
    """
    if random_state is None:
        return int(np.random.SeedSequence().generate_state(1)[0])
    if isinstance(random_state, numbers.Integral):
        return int(random_state)
    if isinstance(random_state, np.random.Generator):
        return int(random_state.integers(0, 2**31 - 1))
    if isinstance(random_state, np.random.RandomState):
        return int(random_state.randint(0, 2**31 - 1))
    raise ValueError(
        f"random_state must be None, an int, or a numpy Generator/RandomState; "
        f"got {random_state!r}"
    )


def _tensor_np_dtype(torch, dtype) -> np.dtype:
    """The numpy dtype a torch dtype stands for in the dtype policy
    (bfloat16 is ml_dtypes' when installed, else float32)."""
    if dtype == torch.bfloat16:
        return bfloat16_dtype() or np.dtype(np.float32)
    return torch.empty(0, dtype=dtype).numpy().dtype


class BaseRandomProjection(ParamsMixin):
    """Shared estimator machinery; subclasses define the matrix kind.

    Parameters
    ----------
    n_components : int or 'auto'
    eps : float in (0, 1) — JL distortion bound used by ``'auto'``
    compute_inverse_components : bool — precompute ``pinv(R)`` at fit
    random_state : None | int | np.random.Generator | np.random.RandomState
    backend : 'auto' | 'torch' | 'numpy' | ProjectionBackend instance
    backend_options : dict — forwarded to the backend factory (the torch
        backend's ``device``, ``precision``, ``materialization``, ...)
    """

    #: subclasses set: 'gaussian' | 'sparse' | 'rademacher'
    _kind: str = ""
    #: warn when a user-fixed k exceeds d
    _warn_on_expand: bool = True

    def __init__(
        self,
        n_components="auto",
        *,
        eps: float = 0.1,
        compute_inverse_components: bool = False,
        random_state=None,
        backend="auto",
        backend_options: Optional[dict] = None,
    ):
        self.n_components = n_components
        self.eps = eps
        self.compute_inverse_components = compute_inverse_components
        self.random_state = random_state
        self.backend = backend
        self.backend_options = backend_options

    # -- subclass hooks ------------------------------------------------------

    def _resolve_density(self, n_features: int) -> Optional[float]:
        """Numeric density for sparse kinds; None otherwise."""
        return None

    # -- fitting -------------------------------------------------------------

    def _resolve_n_components(self, n_samples: int, n_features: int) -> int:
        if self.n_components == "auto":
            k = johnson_lindenstrauss_min_dim(n_samples, eps=self.eps)
            if k <= 0:
                raise ValueError(
                    f"eps={self.eps} and n_samples={n_samples} lead to a target "
                    f"dimension of {k} which is invalid"
                )
            if k > n_features:
                raise ValueError(
                    f"eps={self.eps} and n_samples={n_samples} lead to a target "
                    f"dimension of {k} which is larger than the original space "
                    f"with n_features={n_features}"
                )
            return int(k)
        if not isinstance(self.n_components, numbers.Integral) or isinstance(
            self.n_components, bool
        ):
            raise ValueError(
                f"n_components must be an int or 'auto', got {self.n_components!r}"
            )
        if self.n_components <= 0:
            raise ValueError(
                f"n_components must be strictly positive, got {self.n_components}"
            )
        if self.n_components > n_features and self._warn_on_expand:
            warnings.warn(
                f"The number of components is higher than the number of features: "
                f"n_features < n_components ({n_features} < {self.n_components}). "
                "The dimensionality of the problem will not be reduced.",
                DataDimensionalityWarning,
            )
        return int(self.n_components)

    def _build_spec(self, n_samples: int, n_features: int, dtype) -> ProjectionSpec:
        if n_samples <= 0:
            raise ValueError(f"n_samples must be strictly positive, got {n_samples}")
        if n_features <= 0:
            raise ValueError(f"n_features must be strictly positive, got {n_features}")
        k = self._resolve_n_components(n_samples, n_features)
        return ProjectionSpec(
            kind=self._kind,
            n_components=k,
            n_features=n_features,
            seed=_resolve_seed(self.random_state),
            density=self._resolve_density(n_features),
            dtype=resolve_transform_dtype(dtype).name,
        )

    def _set_fitted(self, spec: ProjectionSpec, backend, state) -> None:
        """Install a fitted spec, backend and state (``fit_schema`` and
        ``interop.from_reference`` both end here)."""
        self._backend = backend
        self.spec_ = spec
        self.n_components_ = spec.n_components
        self.n_features_in_ = spec.n_features
        if spec.density is not None:
            self.density_ = spec.density
        self._state = state
        if self.compute_inverse_components:
            self.inverse_components_ = backend.inverse_components(state, spec)

    def fit_schema(self, n_samples: int, n_features: int, dtype=np.float64):
        """Fit from shape/dtype alone — no data touched.

        The reference's fit reads only ``X.shape``, so this is the
        primitive; ``fit(X)`` delegates here.  This is how streaming
        sources fit: pass the source's schema, never materialize rows.
        """
        backend = resolve_backend(self.backend, **(self.backend_options or {}))
        spec = self._build_spec(n_samples, n_features, dtype)
        self._set_fitted(spec, backend, backend.materialize(spec))
        return self

    def fit(self, X, y=None):
        """Materialize the projection matrix sized to ``X``'s shape (an
        array, a sparse matrix or a tensor; only shape and dtype are read)."""
        torch = sys.modules.get("torch")
        if torch is not None and isinstance(X, torch.Tensor):
            if X.dim() != 2:
                raise ValueError(f"Expected 2D input, got shape {tuple(X.shape)}")
            return self.fit_schema(
                X.shape[0], X.shape[1], dtype=_tensor_np_dtype(torch, X.dtype)
            )
        X = check_array(X, accept_sparse=True)
        n_samples, n_features = X.shape
        return self.fit_schema(n_samples, n_features, dtype=X.dtype)

    # -- inference -----------------------------------------------------------

    def _check_is_fitted(self):
        if not hasattr(self, "spec_"):
            raise NotFittedError(
                f"This {type(self).__name__} instance is not fitted yet. "
                "Call 'fit' with appropriate arguments before using this estimator."
            )

    def _validate_for_transform(self, X, n_expected: int, what: str):
        shape = getattr(X, "shape", None)
        if shape is None or len(shape) != 2:
            X = check_array(X, accept_sparse=True)
            shape = X.shape
        if shape[1] != n_expected:
            raise ValueError(
                f"X has {shape[1]} features, but {type(self).__name__} was fitted "
                f"expecting {n_expected} {what}"
            )
        return X

    def transform(self, X):
        """Project one batch: ``X @ R.T`` via the selected backend.  A tensor
        on the card gives a tensor on the card; a host array a host array."""
        self._check_is_fitted()
        X = self._validate_for_transform(X, self.n_features_in_, "features")
        return self._backend.transform(
            X, self._state, self.spec_, dense_output=self._dense_output()
        )

    def fit_transform(self, X, y=None):
        return self.fit(X).transform(X)

    def inverse_transform(self, Y):
        """Reconstruct ``X̂ = Y @ pinv(R).T`` (``random_projection.py:435-462``)."""
        self._check_is_fitted()
        Y = self._validate_for_transform(Y, self.n_components_, "components")
        inv = getattr(self, "inverse_components_", None)
        if inv is None:
            inv = self._backend.inverse_components(self._state, self.spec_)
        return self._backend.inverse_transform(Y, inv, self.spec_)

    def _dense_output(self) -> bool:
        return True

    def get_feature_names_out(self, input_features=None):
        """Output feature names: ``<classname_lowercase><index>`` (sklearn's
        ``ClassNamePrefixFeaturesOutMixin`` naming)."""
        self._check_is_fitted()
        if input_features is not None and len(input_features) != self.n_features_in_:
            raise ValueError(
                "input_features should have length equal to number of features "
                f"seen during fit ({self.n_features_in_}), got {len(input_features)}"
            )
        prefix = type(self).__name__.lower()
        return np.asarray(
            [f"{prefix}{i}" for i in range(self._stream_out_width())], dtype=object
        )

    # -- streaming (layer L2) --------------------------------------------------

    def _transform_async(self, X):
        """Transform for the streaming pipeline: may return a device tensor
        still being computed."""
        self._check_is_fitted()
        X = self._validate_for_transform(X, self.n_features_in_, "features")
        return self._backend.transform_async(
            X, self._state, self.spec_, dense_output=self._dense_output()
        )

    def prepare_batch(self, X):
        """Validate a batch and start its host→device copy, returning an
        object ``_transform_async`` accepts with no further host work.
        Backends without an upload step (numpy) return the batch unchanged."""
        self._check_is_fitted()
        X = self._validate_for_transform(X, self.n_features_in_, "features")
        prepare = getattr(self._backend, "prepare_batch", None)
        if prepare is None:
            return X
        return prepare(X, self.spec_)

    def _stream_out_dtype(self):
        """Dtype committed stream batches are cast to (None = leave as-is)."""
        return self.spec_.np_dtype

    def _stream_out_width(self) -> int:
        """Column count of streamed output batches."""
        return self.n_components_

    def fit_source(self, source):
        """Fit from a ``RowBatchSource`` schema — zero rows materialized."""
        n_rows, n_features, dtype = source.schema()
        return self.fit_schema(n_rows, n_features, dtype=dtype)

    def transform_stream(self, source, **kwargs):
        """Stream-project a ``RowBatchSource``; see ``streaming.stream_transform``.

        Yields ``(start_row, Y_batch)`` in row order; supports cursor
        checkpoint/resume and keeps ``pipeline_depth`` batches in flight.
        """
        from randomprojection_tpu_torch.streaming import stream_transform

        return stream_transform(self, source, **kwargs)

    # -- introspection ---------------------------------------------------------

    @property
    def components_(self):
        """The projection matrix in backend-native form, shape ``(k, d)``
        (a tensor, a CSR/ndarray, or the lazy state)."""
        self._check_is_fitted()
        return self._state

    def components_as_numpy(self):
        """Host copy of R (ndarray, or CSR for the numpy sparse kind); a lazy
        model's matrix is written by the mask kernel."""
        self._check_is_fitted()
        return self._backend.components_to_numpy(self._state, self.spec_)
