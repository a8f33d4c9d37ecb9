"""Parameter and input validation helpers (layer L0).

A copy of the part of ``randomprojection_tpu/utils/validation.py`` the JL
estimators use: the port imports nothing of the JAX package.  Contract:
sklearn ``random_projection.py:149-166`` (``_check_density``,
``_check_input_size``) and the input-validation behavior of
``BaseRandomProjection.fit`` (``random_projection.py:367-433``).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = [
    "restore_void_dtype",
    "DataDimensionalityWarning",
    "bfloat16_dtype",
    "check_density",
    "check_input_size",
    "check_array",
    "resolve_transform_dtype",
    "NotFittedError",
]


def bfloat16_dtype():
    """np.dtype of bfloat16 (via ml_dtypes), or None when unavailable."""
    try:
        import ml_dtypes

        return np.dtype(ml_dtypes.bfloat16)
    except ImportError:
        return None


class DataDimensionalityWarning(UserWarning):
    """The number of components exceeds the data dimensionality.

    Raised-as-warning when a user-fixed ``n_components > n_features``: the
    projection then *increases* dimensionality, which is allowed but almost
    certainly a mistake (contract: ``random_projection.py:410-418``).
    """


class NotFittedError(ValueError, AttributeError):
    """Estimator used before ``fit`` (contract: sklearn ``NotFittedError``)."""


def restore_void_dtype(arr, want=None):
    """Undo ``.npy``'s label degradation for ml_dtypes arrays.

    ``np.save`` of a bfloat16 array writes a raw-void header (``|V2``) —
    the format cannot express the name — so ``np.load`` returns unusable
    void data.  When the array is unstructured 2-byte void and bfloat16 is
    either the expected dtype (``want``) or the only plausible producer,
    restore the typed view; anything else passes through for the caller's
    validation to reject loudly.
    """
    dtype = getattr(arr, "dtype", None)
    if dtype is None or dtype.kind != "V" or dtype.names is not None:
        return arr
    bf16 = bfloat16_dtype()
    if bf16 is None or dtype.itemsize != 2:
        return arr
    if want is not None and np.dtype(want) != bf16:
        return arr
    return arr.view(bf16)


def check_density(density, n_features: int) -> float:
    """Resolve and validate the sparse-kernel density parameter.

    ``'auto'`` resolves to ``1/sqrt(n_features)`` (Li, Hastie & Church 2006);
    otherwise density must lie in ``(0, 1]`` (``random_projection.py:149-156``).
    """
    if density == "auto":
        if n_features <= 0:
            raise ValueError(
                f"n_features must be strictly positive to resolve density='auto', "
                f"got {n_features}"
            )
        return 1.0 / np.sqrt(n_features)
    density = float(density)
    if density <= 0.0 or density > 1.0:
        raise ValueError(f"Expected density in range (0, 1], got: {density!r}")
    return density


def check_input_size(n_components: int, n_features: int) -> None:
    """Reject non-positive matrix dimensions (``random_projection.py:159-166``)."""
    if n_components <= 0:
        raise ValueError(f"n_components must be strictly positive, got {n_components}")
    if n_features <= 0:
        raise ValueError(f"n_features must be strictly positive, got {n_features}")


def check_array(X, *, accept_sparse: bool = True, allow_1d: bool = False):
    """Validate an input batch: 2-D, numeric, dense ndarray or CSR/CSC.

    Returns the array unchanged when already acceptable (no copy): dense
    inputs as ``np.ndarray`` (or any ``__array__``-convertible, converted),
    sparse inputs converted to CSR.  Dense 1-D inputs raise unless
    ``allow_1d``; sparse inputs must always be 2-D.
    """
    if sp.issparse(X):
        if not accept_sparse:
            raise TypeError(
                "Sparse input is not supported here; densify with .toarray() first"
            )
        X = X.tocsr()
        if X.ndim != 2:
            raise ValueError(f"Expected 2D sparse input, got ndim={X.ndim}")
        return X
    X = np.asarray(X)
    if X.ndim == 1 and not allow_1d:
        raise ValueError(
            f"Expected 2D array, got 1D array of shape {X.shape}. "
            "Reshape with X.reshape(1, -1) for a single sample."
        )
    if X.ndim not in (1, 2):
        raise ValueError(f"Expected 2D array, got ndim={X.ndim}")
    if (
        not np.issubdtype(X.dtype, np.number)
        and X.dtype != bool
        and X.dtype != bfloat16_dtype()
    ):
        raise ValueError(f"Expected numeric input, got dtype {X.dtype}")
    return X


def resolve_transform_dtype(dtype) -> np.dtype:
    """Dtype policy: f32 in → f32 out; f64 in → f64 out; bf16 in → bf16 out
    (halves the host↔device bytes); everything else (ints, bool, f16)
    promotes to f64 (``random_projection.py:386-387``,
    ``test_random_projection.py:547-567``; IEEE f16 keeps the sklearn
    promotion contract — only bfloat16 gets the pass-through)."""
    dtype = np.dtype(dtype)
    if dtype in (np.dtype(np.float32), np.dtype(np.float64)):
        return dtype
    bf16 = bfloat16_dtype()
    if bf16 is not None and dtype == bf16:
        return bf16
    return np.dtype(np.float64)
