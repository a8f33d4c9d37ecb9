"""Fitted-model persistence: the reference's format version 1, field for
field (``randomprojection_tpu/serialize.py``).

A fitted projection is fully determined by its ``ProjectionSpec`` (seed +
shape + kind + density + dtype) — a few hundred bytes of JSON.  Loading
re-materialises the matrix from the seed.  The port's torch backend draws
the JAX backend's threefry matrices (``ops/kernels.py``), so a dense or
split2 model saved by either package loads in the other to the same
matrix.  Optionally the materialised matrix (and pinv) are bundled as a
sibling ``.npz``.

Two PRNG families of lazy matrices exist, and a file says which it holds:

- the reference writes a lazy model as ``backend_options:
  {materialization: lazy}``.  That matrix is the TPU's hardware PRNG
  stream, which no GPU reproduces: the port refuses such a file;
- the port's lazy matrix is the integer hash stream of
  ``ops/fused_kernels.py``.  It is written with the family tag
  ``backend_options["prng_family"] = "interpret-hash"``, which the port
  strips before it builds the backend, so the model round-trips here.

A ``CountSketch`` is seed-defined: its payload (``countsketch``: width,
features, seed and ``use_mxu``) re-draws the same ``h_``/``s_`` in either
package.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from randomprojection_tpu_torch.backends.base import ProjectionSpec

__all__ = ["save_model", "load_model", "FORMAT_VERSION", "LAZY_FAMILY"]

FORMAT_VERSION = 1

#: ``backend_options`` key naming the PRNG family of a lazy matrix
FAMILY_KEY = "prng_family"
#: the port's lazy family: the hash stream of ``ops/fused_kernels.py``
LAZY_FAMILY = "interpret-hash"

_BACKENDS = ("torch", "numpy")


def _registry() -> dict:
    from randomprojection_tpu_torch.models.projections import (
        GaussianRandomProjection,
        SparseRandomProjection,
    )
    from randomprojection_tpu_torch.models.sketch import (
        CountSketch,
        SignRandomProjection,
    )

    return {
        cls.__name__: cls
        for cls in (GaussianRandomProjection, SparseRandomProjection,
                    SignRandomProjection, CountSketch)
    }


def save_model(est, path: str, *, include_matrix: bool = False) -> None:
    """Save a fitted estimator to ``path`` (JSON; ``path + '.npz'`` if
    ``include_matrix``)."""
    est._check_is_fitted()
    payload = {
        "format_version": FORMAT_VERSION,
        "class": type(est).__name__,
    }
    if not hasattr(est, "spec_"):  # CountSketch: seed-defined, no spec
        payload["countsketch"] = {
            "n_components": est.n_components_,
            "n_features": est.n_features_in_,
            "seed": est.seed_,
            # the route is part of the numeric contract: the one-hot
            # product and the scatter round differently
            "use_mxu": est.use_mxu,
        }
        _write_payload(path, payload)
        return
    payload["spec"] = est.spec_.to_dict()
    payload["params"] = {
        "dense_output": getattr(est, "dense_output", None),
        "compute_inverse_components": est.compute_inverse_components,
    }
    if type(getattr(est, "_state", None)).__name__ == "_LazyMask":
        # the port's lazy matrix is the hash family, not the reference's
        # TPU stream: tag it, or a reload would draw another matrix
        payload["backend_options"] = {
            "materialization": "lazy", FAMILY_KEY: LAZY_FAMILY,
        }
    if include_matrix:
        import scipy.sparse as sp

        R = est.components_as_numpy()
        if sp.issparse(R):
            R = R.toarray()
        arrays = {"components": np.asarray(R)}
        inv = getattr(est, "inverse_components_", None)
        if inv is not None:
            arrays["inverse_components"] = np.asarray(inv)
        np.savez(path + ".npz", **arrays)
        payload["matrix_file"] = os.path.basename(path) + ".npz"
    _write_payload(path, payload)


def _write_payload(path: str, payload: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1)
    os.replace(tmp, path)


def _load_options(payload: dict, path: str, backend: Optional[str]) -> dict:
    """The saved ``backend_options`` this package can build, with the
    family tag stripped; refuses a lazy matrix of another family."""
    saved = dict(payload.get("backend_options") or {})
    if not saved:
        return {}
    family = saved.pop(FAMILY_KEY, None)
    if saved.get("materialization") == "lazy" and family is None:
        raise ValueError(
            f"{path} holds a lazy model saved by the JAX package: its "
            "matrix is the TPU's hardware PRNG stream (pltpu.prng_*), "
            "which no GPU reproduces.  Re-save it with the default dense "
            "materialization (or include_matrix=True and carry the "
            "components across with interop.from_reference)"
        )
    if family is not None and family != LAZY_FAMILY:
        raise ValueError(
            f"{path} names PRNG family {family!r}; this package draws "
            f"lazy matrices from {LAZY_FAMILY!r} only"
        )
    if backend == "numpy":
        raise ValueError(
            f"This model was fitted with backend options {saved} (the "
            f"torch backend's {LAZY_FAMILY!r} family); it cannot be "
            "loaded on backend='numpy' without changing the matrix"
        )
    return saved


def load_model(path: str, *, backend: Optional[str] = None,
               backend_options: Optional[dict] = None):
    """Load a fitted estimator saved by ``save_model`` (of either package).

    ``backend`` is ``'torch'`` (the default: the card) or ``'numpy'``; the
    projection re-materialises from the stored seed.  ``backend_options``
    adds execution options for the torch backend (``{'device': 'cpu'}``
    runs on the CPU); the file's own options (a lazy model's) win where
    they name the same key.  A payload saved with ``include_matrix=True``
    names its sibling ``.npz``, which must exist (a missing one means the
    artifact was copied partially); the bundle is never loaded
    implicitly: the seed is the source of truth.
    """
    with open(path) as f:
        payload = json.load(f)
    version = payload.get("format_version")
    if version != FORMAT_VERSION:
        raise ValueError(
            f"Unsupported model format version {version!r} in {path} "
            f"(expected {FORMAT_VERSION})"
        )
    if backend is not None and backend not in _BACKENDS:
        raise ValueError(
            f"backend must be one of {_BACKENDS} or None, got {backend!r}"
        )
    cls = _registry().get(payload.get("class"))
    if cls is None:
        raise ValueError(f"Unknown model class {payload.get('class')!r} in {path}")
    matrix_file = payload.get("matrix_file")
    if matrix_file is not None:
        bundle = os.path.join(
            os.path.dirname(os.path.abspath(path)), matrix_file
        )
        if not os.path.exists(bundle):
            raise ValueError(
                f"{path} was saved with include_matrix=True but its "
                f"matrix bundle is missing: expected {bundle} alongside "
                "it.  Restore the sibling .npz, or re-save the model "
                "without include_matrix."
            )

    if "countsketch" in payload:
        d = payload["countsketch"]
        if backend_options and backend == "numpy":
            raise ValueError("backend_options apply to backend='torch' only")
        est = cls(d["n_components"], random_state=d["seed"],
                  backend=backend or "torch", backend_options=backend_options,
                  use_mxu=d.get("use_mxu"))
        return est.fit_schema(1, d["n_features"])

    spec = ProjectionSpec.from_dict(payload["spec"])
    options = _load_options(payload, path, backend)
    kwargs = {}
    params = payload.get("params", {})
    if params.get("dense_output") is not None:
        kwargs["dense_output"] = params["dense_output"]
    if spec.kind == "sparse":
        kwargs["density"] = spec.density
    backend = backend or "torch"
    if backend == "torch":
        kwargs["backend_options"] = {**(backend_options or {}), **options}
    elif backend_options:
        raise ValueError("backend_options apply to backend='torch' only")
    est = cls(
        spec.n_components,
        random_state=spec.seed,
        backend=backend,
        compute_inverse_components=bool(params.get("compute_inverse_components")),
        **kwargs,
    )
    # n_samples only gates auto-dim, which a fixed-k respec never triggers
    est.fit_schema(1, spec.n_features, dtype=spec.np_dtype)
    if est.spec_ != spec:
        raise ValueError(
            f"{path}: the re-materialised spec {est.spec_} differs from "
            f"the saved one {spec}"
        )
    return est
