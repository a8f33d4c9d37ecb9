"""Execution backends behind the ``ProjectionBackend`` boundary."""

from randomprojection_tpu_torch.backends.base import (
    ProjectionBackend,
    ProjectionSpec,
    available_backends,
    get_backend,
    register_backend,
    resolve_backend,
)

__all__ = [
    "ProjectionBackend",
    "ProjectionSpec",
    "available_backends",
    "get_backend",
    "register_backend",
    "resolve_backend",
]
