"""``ProjectionBackend`` protocol, ``ProjectionSpec``, and the backend registry.

The counterpart of ``randomprojection_tpu/backends/base.py``: the same
spec and protocol, with a registry of ``'numpy'`` and ``'torch'``, where
``'auto'`` resolves to ``'torch'`` (the card).

A fitted projection is fully described by an immutable ``ProjectionSpec``
(kind, shape, seed, density, dtype).  A backend turns a spec into *state*
(its native representation of the projection matrix — ndarray, CSR, a
tensor on the card, or just a seed) and executes the operations against
that state:

- ``materialize(spec)``      → state                 (fit-time)
- ``transform(X, state, spec, dense_output)`` → Y    (the X·Rᵀ hot loop)
- ``inverse_components(state, spec)`` → pinv(R)      (optional, fit-time)
- ``inverse_transform(Y, inv)``       → X̂            (Y·pinv(R)ᵀ)
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np

__all__ = [
    "ProjectionSpec",
    "ProjectionBackend",
    "register_backend",
    "get_backend",
    "resolve_backend",
    "available_backends",
]

_VALID_KINDS = ("gaussian", "sparse", "rademacher")


@dataclasses.dataclass(frozen=True)
class ProjectionSpec:
    """Immutable description of one projection matrix.

    ``density`` is the *resolved* numeric density (``'auto'`` → ``1/sqrt(d)``
    happens at the estimator layer) and is ``None`` for non-sparse kinds.
    ``dtype`` is the transform output dtype (f32→f32, f64→f64, ints
    promote — ``random_projection.py:386-387``).
    """

    kind: str
    n_components: int
    n_features: int
    seed: int
    density: Optional[float] = None
    dtype: str = "float64"

    def __post_init__(self):
        if self.kind not in _VALID_KINDS:
            raise ValueError(
                f"Unknown projection kind {self.kind!r}; expected one of {_VALID_KINDS}"
            )
        if self.kind == "sparse":
            if self.density is None:
                raise ValueError("kind='sparse' requires a resolved numeric density")
        self.np_dtype  # must be a valid dtype string

    @property
    def np_dtype(self) -> np.dtype:
        if self.dtype == "bfloat16":
            # numpy only understands 'bfloat16' once ml_dtypes is imported
            from randomprojection_tpu_torch.utils.validation import bfloat16_dtype

            dt = bfloat16_dtype()
            if dt is not None:
                return dt
        return np.dtype(self.dtype)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ProjectionSpec":
        return cls(**d)


class ProjectionBackend(abc.ABC):
    """Executor for a projection spec.  Subclass + register to plug in."""

    #: registry key; set by subclasses
    name: str = ""

    @abc.abstractmethod
    def materialize(self, spec: ProjectionSpec) -> Any:
        """Generate the projection matrix in backend-native form (fit-time)."""

    @abc.abstractmethod
    def transform(
        self, X, state: Any, spec: ProjectionSpec, *, dense_output: bool = True
    ):
        """Compute ``X @ R.T`` for one batch ``X`` of shape ``(n, d)``.

        ``dense_output=False`` asks sparse-aware backends to keep sparse
        outputs sparse when ``X`` is sparse (scipy semantics,
        ``random_projection.py:825-827``); dense-only backends may ignore it.
        """

    def transform_async(
        self, X, state: Any, spec: ProjectionSpec, *, dense_output: bool = True
    ):
        """Like ``transform`` but may return a tensor still being computed
        on the card; the streaming pipeline fetches it later, overlapping
        the next batch's work.  Synchronous backends return ``transform``'s
        result."""
        return self.transform(X, state, spec, dense_output=dense_output)

    @abc.abstractmethod
    def inverse_components(self, state: Any, spec: ProjectionSpec) -> np.ndarray:
        """Moore–Penrose pseudo-inverse of R, shape ``(d, k)``."""

    @abc.abstractmethod
    def inverse_transform(self, Y, inverse_components, spec: ProjectionSpec):
        """Compute ``Y @ pinv(R).T``, shape ``(n, d)``."""

    def components_to_numpy(self, state: Any, spec: ProjectionSpec):
        """Host copy of R for introspection/serialization (ndarray or CSR)."""
        return np.asarray(state)

    def close(self) -> None:
        """Release backend resources (no-op by default)."""


_REGISTRY: Dict[str, Callable[..., ProjectionBackend]] = {}
_INSTANCES: Dict[str, ProjectionBackend] = {}


def register_backend(name: str, factory: Callable[..., ProjectionBackend]) -> None:
    """Register a backend factory under a string key (the plugin seam)."""
    if not name or not isinstance(name, str):
        raise ValueError(f"Backend name must be a non-empty string, got {name!r}")
    _REGISTRY[name] = factory


def available_backends() -> Iterable[str]:
    _ensure_builtin_backends()
    return tuple(sorted(_REGISTRY))


def get_backend(name: str, **options) -> ProjectionBackend:
    """Instantiate backend ``name``.  Option-free numpy instances are cached;
    a torch backend is built per call, because its device is resolved when
    it is built."""
    _ensure_builtin_backends()
    if name not in _REGISTRY:
        raise ValueError(
            f"Unknown backend {name!r}; available: {', '.join(sorted(_REGISTRY))}"
        )
    if not options and name == "numpy":
        if name not in _INSTANCES:
            _INSTANCES[name] = _REGISTRY[name]()
        return _INSTANCES[name]
    return _REGISTRY[name](**options)


def resolve_backend(backend, **options) -> ProjectionBackend:
    """Resolve the estimator-level ``backend=`` argument.

    Accepts a ``ProjectionBackend`` instance (passed through), a registry
    key, or ``'auto'`` — which is ``'torch'``: the port runs on the card,
    and the torch backend raises when there is none and the caller named
    no device.
    """
    if isinstance(backend, ProjectionBackend):
        return backend
    if backend == "auto":
        backend = "torch"
    return get_backend(backend, **options)


def _ensure_builtin_backends() -> None:
    # Deferred so `import randomprojection_tpu_torch` stays torch-free until
    # a torch backend is actually requested.
    if "numpy" not in _REGISTRY:
        from randomprojection_tpu_torch.backends.numpy_backend import NumpyBackend

        register_backend("numpy", NumpyBackend)
    if "torch" not in _REGISTRY:

        def _torch_factory(**options):
            from randomprojection_tpu_torch.backends.torch_backend import (
                TorchBackend,
            )

            return TorchBackend(**options)

        register_backend("torch", _torch_factory)
