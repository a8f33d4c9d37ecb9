"""Carry a model fitted with the JAX package into the port.

The port draws its dense and split2 matrices from the JAX backend's
threefry stream (``ops/kernels.py``), so a reference spec alone —
``est.spec_.to_dict()`` — re-materialises the same matrix: the sparse and
Rademacher ones bit for bit, the Gaussian within 4 ulps.  Given the
reference's ``est.components_as_numpy()`` as well, ``from_reference``
holds exactly those components instead (a matrix bundle, or a matrix that
no seed of this family defines).

A ``SignRandomProjection`` of the reference carries a Gaussian spec
(its hyperplanes), which alone does not say which estimator it belongs
to: pass ``estimator='sign'`` and the port's ``SignRandomProjection``
comes back, with the reference's hyperplanes.

A lazy spec needs no components: the port's lazy matrix is the hash
stream that the JAX package's kernels contract under ``interpret=True``,
a pure function of ``(seed, density)``.  (A lazy model fitted on a TPU
uses the TPU's hardware PRNG instead, which no other device reproduces.)
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp

from randomprojection_tpu_torch.backends.base import ProjectionSpec, resolve_backend
from randomprojection_tpu_torch.models.projections import (
    GaussianRandomProjection,
    SparseRandomProjection,
)
from randomprojection_tpu_torch.models.sketch import SignRandomProjection

__all__ = ["from_reference"]

#: estimator name → (class, the spec kind it holds)
_ESTIMATORS = {
    "gaussian": (GaussianRandomProjection, "gaussian"),
    "sparse": (SparseRandomProjection, "sparse"),
    "sign": (SignRandomProjection, "gaussian"),
}


def from_reference(spec_dict: dict, components=None,
                   backend_options: Optional[dict] = None, *,
                   estimator: Optional[str] = None):
    """A fitted port estimator for a reference model.

    ``spec_dict`` is the reference's ``spec_.to_dict()``; ``components`` its
    ``components_as_numpy()`` (``(k, d)`` ndarray or CSR), or None to
    re-materialise the matrix from the spec's seed (a lazy model takes
    none: its matrix is ``(seed, density)``).  With
    ``precision='split2'`` the components must be the scaled ±1/0 mask
    of a sparse spec; the port then holds the mask in bf16 and the scale.
    ``estimator`` names the reference's estimator (``'gaussian'``,
    ``'sparse'`` or ``'sign'``); by default the one of the spec's kind.
    """
    spec = ProjectionSpec.from_dict(dict(spec_dict))
    name = spec.kind if estimator is None else estimator
    if name not in _ESTIMATORS:
        raise NotImplementedError(
            f"no port estimator for estimator={estimator!r}, kind="
            f"{spec.kind!r}; the port has {sorted(_ESTIMATORS)} (a "
            "SignRandomProjection spec is kind 'gaussian': pass "
            "estimator='sign')"
        )
    cls, kind = _ESTIMATORS[name]
    if spec.kind != kind:
        raise ValueError(
            f"estimator={name!r} holds a {kind!r} spec, got kind={spec.kind!r}"
        )
    options = dict(backend_options or {})
    kwargs = dict(
        random_state=spec.seed, backend="torch", backend_options=options
    )
    if spec.kind == "sparse":
        kwargs["density"] = spec.density
    est = cls(spec.n_components, **kwargs)
    backend = resolve_backend("torch", **options)

    if options.get("materialization") == "lazy" and components is not None:
        raise ValueError(
            "a lazy model is defined by (seed, density); pass no components"
        )
    if components is None:
        state = backend.materialize(spec)
    else:
        if sp.issparse(components):
            components = components.toarray()
        R = np.asarray(components, dtype=np.float64)
        if R.shape != (spec.n_components, spec.n_features):
            raise ValueError(
                f"components have shape {R.shape}, the spec says "
                f"{(spec.n_components, spec.n_features)}"
            )
        if backend.precision == "split2":
            if spec.kind != "sparse":
                raise ValueError("precision='split2' takes a sparse spec only")
            scale = 1.0 / np.sqrt(spec.density * spec.n_components)
            mask = np.sign(R)
            if not np.array_equal(
                mask.astype(np.float32) * np.float32(scale), R.astype(np.float32)
            ):
                raise ValueError(
                    "components are not the scaled ±1/0 mask of this spec"
                )
            state = backend.split_state(mask, scale)
        else:
            state = backend.dense_state(R)
    est._set_fitted(spec, backend, state)
    return est
