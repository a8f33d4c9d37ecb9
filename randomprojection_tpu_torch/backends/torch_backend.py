"""PyTorch backend — the card's execution path (layer L4 → L1).

The counterpart of ``randomprojection_tpu/backends/jax_backend.py``.  It
keeps that backend's three states:

- **dense**: ``R`` on the card in the compute dtype; ``transform`` is one
  ``x @ Rᵀ`` under the precision policy (``ops/precision.py``).
- **split2** (``precision='split2'``, ``_SplitMask``): the unscaled ±1/0
  mask in bf16 plus the scale; two bf16 products with float32
  accumulation (``ops/split_matmul.py``).
- **lazy** (``materialization='lazy'``, ``_LazyMask``): no array, just
  ``(seed, density)``; every transform regenerates the mask inside the
  fused CUDA kernel (``ops/fused_kernels.py``), so ``R`` never exists in
  device memory.

Matrix families.  The dense and split2 matrices are drawn on the host
once at fit from the port's numpy-backend stream (``host_matrix``, the
salted ``SeedSequence`` of the JAX package's numpy backend) and uploaded:
for seed ``s`` they equal the numpy backend's matrix, on the CPU and on
the card.  They are NOT the JAX backend's threefry matrices; carry a JAX
model across with ``interop.from_reference``.  The lazy matrix is the
integer hash stream that the JAX package's kernels use under
``interpret=True`` — portable, so unlike the JAX backend this one runs
lazy models off the TPU.

Devices.  ``device=None`` (the default) means the card: with no card the
backend raises rather than run on the CPU.  The CPU runs only when asked
(``backend_options={'device': 'cpu'}``), and the fused wrappers then take
their plain versions.  Host batches go through a pinned staging buffer
with a ``non_blocking`` copy; tensors already on the card stay there, and
so does their output.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import scipy.sparse as sp

from randomprojection_tpu_torch.backends.base import (
    ProjectionBackend,
    ProjectionSpec,
)
from randomprojection_tpu_torch.utils.validation import bfloat16_dtype

__all__ = ["TorchBackend", "resolve_device"]

_COMPUTE_DTYPES = ("float32", "bfloat16")


class _LazyMask:
    """State of ``materialization='lazy'``: no array — just the seed.

    The matrix is regenerated inside the fused kernel per transform
    (``ops/fused_kernels.py``), so it is never resident in device memory.
    """

    __slots__ = ("seed", "density")

    def __init__(self, seed: int, density: float):
        self.seed = seed
        self.density = float(density)


class _SplitMask:
    """State of ``precision='split2'``: unscaled ±1/0 mask in bf16 + scale.

    The mask entries are exact in bf16, so the two-pass split projection
    (``ops/split_matmul.py``) delivers f32-grade output from two bf16
    products.
    """

    __slots__ = ("mask", "scale")

    def __init__(self, mask, scale: float):
        self.mask = mask
        self.scale = float(scale)


def resolve_device(device, *, how="backend_options={'device': 'cpu'}"):
    """The torch device an entry point runs on: the card for ``None``
    (raising when there is none, with ``how`` naming the way to ask for
    the CPU), else the CUDA device or the CPU asked for."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the port runs on a CUDA card and none is available "
                f"(torch.cuda.is_available() is False); pass {how} to run "
                "on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} was asked for but no CUDA card is available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be a CUDA device or 'cpu', got {device!r}")
    return dev


def pack_signs(y):
    """``(n, k)`` coordinates → ``(n, ceil(k/8))`` uint8 sign codes: bit
    ``j % 8`` of byte ``j // 8`` is ``y[:, j] > 0`` (torch has no
    ``packbits``: the bits are shifted by ``arange(8)`` and summed)."""
    import torch

    n, k = y.shape
    bits = (y > 0).to(torch.uint8)
    if k % 8:
        bits = torch.nn.functional.pad(bits, (0, 8 - k % 8))
    shifts = torch.arange(8, dtype=torch.uint8, device=y.device)
    return (bits.view(n, -(-k // 8), 8) << shifts).sum(-1, dtype=torch.uint8)


def _to_numpy(y, np_dtype):
    """Host ndarray of a tensor, in ``np_dtype`` (bf16 tensors widen
    exactly to f32 first: numpy has no native bfloat16)."""
    import torch

    y = y.detach().cpu()
    if y.dtype == torch.bfloat16:
        y = y.float()
    return y.numpy().astype(np_dtype, copy=False)


class TorchBackend(ProjectionBackend):
    """Card executor: device-resident R (or just a seed), torch products and
    the port's CUDA kernels."""

    name = "torch"

    def __init__(
        self,
        *,
        device=None,
        compute_dtype: str = "float32",
        precision: Optional[str] = None,
        materialization: str = "dense",
        mesh: Optional[object] = None,
        feature_axis: Optional[str] = None,
        dispatch_steps: int = 1,
        transform_dma: Optional[bool] = None,
    ):
        import torch

        from randomprojection_tpu_torch.ops.precision import (
            default_matmul_precision,
        )

        # options of the JAX backend that later slices port; refuse them
        # rather than silently run something else
        for name, value, default, item in (
            ("mesh", mesh, None, "A10 (scale-out)"),
            ("feature_axis", feature_axis, None, "A10 (scale-out)"),
            ("dispatch_steps", dispatch_steps, 1, "B4 (multistep dispatch)"),
            ("transform_dma", transform_dma, None,
             "B1 (x pipelining of the fused kernel)"),
        ):
            if value != default:
                raise ValueError(
                    f"{name}={value!r} is not ported yet (ROADMAP {item}); "
                    f"the torch backend takes {name}={default!r} only"
                )
        self.device = resolve_device(device)
        if compute_dtype not in _COMPUTE_DTYPES:
            raise ValueError(
                f"compute_dtype must be one of {_COMPUTE_DTYPES}, got {compute_dtype!r}"
            )
        self.compute_dtype = compute_dtype
        self._dtype = getattr(torch, compute_dtype)
        if precision is None:
            precision = default_matmul_precision(compute_dtype)
        if precision not in ("default", "high", "highest", "split2"):
            raise ValueError(
                "precision must be 'default', 'high', 'highest' or 'split2', "
                f"got {precision!r}"
            )
        self.precision = precision
        if materialization not in ("dense", "lazy"):
            raise ValueError(
                f"materialization must be 'dense' or 'lazy', got {materialization!r}"
            )
        self.materialization = materialization

    def _einsum_precision(self) -> str:
        """Precision for plain products ('split2' applies only to the mask
        product; pinv reconstruct and gaussian use 'high')."""
        return self.precision if self.precision != "split2" else "high"

    def _lazy_mxu_mode(self) -> str:
        """Contraction arithmetic of the fused kernel: ``'split2'`` (f32-grade)
        for every precision but an explicit ``'default'``, which takes the
        single f32 product (the JAX backend's ``_lazy_mxu_mode``)."""
        return "f32" if self.precision == "default" else "split2"

    # -- ProjectionBackend API ----------------------------------------------

    def materialize(self, spec: ProjectionSpec):
        import torch

        from randomprojection_tpu_torch.backends.numpy_backend import host_matrix

        if self.materialization == "lazy":
            if spec.kind not in ("sparse", "rademacher"):
                raise ValueError(
                    "materialization='lazy' regenerates the mask in-kernel and "
                    f"supports kind='sparse'/'rademacher' only, got {spec.kind!r}"
                )
            if spec.n_components % 8:
                # fail at fit, like the dense path's materialization would
                raise ValueError(
                    "materialization='lazy' needs n_components to be a "
                    f"multiple of 8, got {spec.n_components}"
                )
            return _LazyMask(
                spec.seed, spec.density if spec.kind == "sparse" else 1.0
            )

        R = host_matrix(spec)
        if sp.issparse(R):
            R = R.toarray()
        if self.precision == "split2":
            if spec.kind not in ("sparse", "rademacher"):
                raise ValueError(
                    "precision='split2' relies on the ±1/0 mask being exact "
                    "in bf16 and supports kind='sparse'/'rademacher' only; "
                    f"got {spec.kind!r} (use precision='high' for gaussian)"
                )
            density = float(spec.density) if spec.kind == "sparse" else 1.0
            return self.split_state(
                np.sign(R), 1.0 / math.sqrt(density * spec.n_components)
            )
        return torch.from_numpy(np.ascontiguousarray(R, dtype=np.float32)).to(
            self.device, self._dtype
        )

    def split_state(self, mask, scale: float) -> _SplitMask:
        """A split2 state from a host ±1/0 mask and its scale."""
        import torch

        return _SplitMask(
            torch.from_numpy(np.ascontiguousarray(mask, dtype=np.float32)).to(
                self.device, torch.bfloat16
            ),
            scale,
        )

    def dense_state(self, components):
        """A dense state from a host ``(k, d)`` matrix."""
        import torch

        return torch.from_numpy(
            np.ascontiguousarray(components, dtype=np.float32)
        ).to(self.device, self._dtype)

    def _host_tensor(self, X, *, allow_bf16: bool):
        """Densify + apply the dtype policy on the host (bf16 passes through
        only when the spec allows it; everything else becomes float32, so
        the copy moves at most 4 bytes an entry) → a CPU tensor."""
        import torch

        if sp.issparse(X):
            X = X.toarray()
        X = np.asarray(X)
        bf16 = bfloat16_dtype()
        if bf16 is not None and X.dtype == bf16:
            if allow_bf16:
                bits = np.ascontiguousarray(X).view(np.uint16)
                return torch.from_numpy(bits).view(torch.bfloat16)
            X = X.astype(np.float32)
        return torch.from_numpy(np.ascontiguousarray(X, dtype=np.float32))

    def _upload(self, t):
        """Host tensor → device: through a pinned staging buffer and a
        ``non_blocking`` copy on the card (the staging block is held by
        torch's pinned allocator until the copy has run); as is on the CPU."""
        import torch

        from randomprojection_tpu_torch.parallel.sharded import row_bucket

        if self.device.type == "cpu":
            return t
        n = t.shape[0]
        staging = torch.empty(
            (row_bucket(n) if n else 0,) + tuple(t.shape[1:]), dtype=t.dtype,
            pin_memory=True,
        )[:n]
        staging.copy_(t)
        return staging.to(self.device, non_blocking=True)

    def _prepare_rows(self, X, *, allow_bf16: bool = False):
        """Batch preamble: densify, apply the dtype policy, place on the
        device.  Returns ``(x_on_device, device_resident)``."""
        import torch

        device_resident = isinstance(X, torch.Tensor)
        if device_resident:
            keep_bf16 = allow_bf16 and X.dtype == torch.bfloat16
            x = X.to(self.device)
        else:
            x = self._upload(self._host_tensor(X, allow_bf16=allow_bf16))
            keep_bf16 = x.dtype == torch.bfloat16
        if x.dim() != 2:
            raise ValueError(f"Expected a 2D batch, got shape {tuple(x.shape)}")
        if not keep_bf16:
            x = x.to(self._dtype)
        return x, device_resident

    def prepare_batch(self, X, spec: ProjectionSpec):
        """Start a batch's host→device copy ahead of its transform: returns
        the device tensor, which ``transform`` then treats as
        device-resident (no further host work)."""
        x, _ = self._prepare_rows(X, allow_bf16=spec.dtype == "bfloat16")
        return x

    def _project(self, x, state, spec: ProjectionSpec):
        import torch

        from randomprojection_tpu_torch.ops.fused_kernels import (
            fused_sparse_project,
        )
        from randomprojection_tpu_torch.ops.precision import matmul_nt
        from randomprojection_tpu_torch.ops.split_matmul import split2_project

        if isinstance(state, _SplitMask):
            y = split2_project(x, state.mask, state.scale)
        elif isinstance(state, _LazyMask):
            # bf16 input (only when the spec's dtype policy allowed it)
            # stays bf16 through the kernel: one product against the exact
            # mask IS the data's own precision, at half the x bytes
            mode = "bf16" if x.dtype == torch.bfloat16 else self._lazy_mxu_mode()
            y = fused_sparse_project(
                x, state.seed, spec.n_components, state.density, mxu_mode=mode
            )
        else:
            y = matmul_nt(x, state, self._einsum_precision())
        return y.to(x.dtype)

    def _transform_impl(self, X, state, spec: ProjectionSpec):
        x, device_resident = self._prepare_rows(
            X, allow_bf16=spec.dtype == "bfloat16"
        )
        return self._project(x, state, spec), device_resident

    def transform(self, X, state, spec: ProjectionSpec, *, dense_output: bool = True):
        """A tensor in gives a tensor out, on the input's device; a host
        array gives a host array in the spec's dtype."""
        y, device_resident = self._transform_impl(X, state, spec)
        if device_resident:
            return y.to(X.device)
        return _to_numpy(y, spec.np_dtype)

    def transform_async(
        self, X, state, spec: ProjectionSpec, *, dense_output: bool = True
    ):
        # a device tensor either way: the stream pipeline starts its copy to
        # the host and fetches it later, overlapping the next batch's work
        y, _ = self._transform_impl(X, state, spec)
        return y

    def transform_packed_signs(self, X, state, spec: ProjectionSpec, *,
                               materialize: bool = True):
        """SimHash codes on the device: the projection, then ``y > 0``
        packed 8 bits a byte, little-endian, as ``np.packbits(...,
        bitorder='little')`` (pad bits of a ragged last byte are zero).

        The dense route takes one float32 product under the precision
        policy; the lazy and split2 routes compute their coordinates as
        ``transform`` does.  Output ``(n, ceil(k/8))`` uint8: a tensor for a
        tensor input or ``materialize=False`` (the streaming pipeline),
        else a host array."""
        from randomprojection_tpu_torch.ops.precision import matmul_nt

        if isinstance(state, (_LazyMask, _SplitMask)):
            y, device_resident = self._transform_impl(X, state, spec)
        else:
            x, device_resident = self._prepare_rows(
                X, allow_bf16=spec.dtype == "bfloat16"
            )
            y = matmul_nt(x, state, self._einsum_precision())
        codes = pack_signs(y)
        if device_resident:
            return codes.to(X.device)
        if not materialize:
            return codes
        return codes.cpu().numpy()

    def _matrix(self, state, spec: ProjectionSpec):
        """``R`` as a float32 device tensor (the mask kernel for lazy)."""
        from randomprojection_tpu_torch.ops.fused_kernels import lazy_matrix

        if isinstance(state, _LazyMask):
            return lazy_matrix(
                state.seed, spec.n_components, spec.n_features, state.density,
                device=self.device,
            )
        if isinstance(state, _SplitMask):
            return state.mask.float() * state.scale
        return state.float()

    def inverse_components(self, state, spec: ProjectionSpec) -> np.ndarray:
        import torch

        from randomprojection_tpu_torch.ops.precision import fp32_matmul

        with fp32_matmul():
            inv = torch.linalg.pinv(self._matrix(state, spec))
        return inv.cpu().numpy()

    def inverse_transform(self, Y, inverse_components, spec: ProjectionSpec):
        import torch

        from randomprojection_tpu_torch.ops.precision import matmul_nt

        device_resident = isinstance(Y, torch.Tensor)
        if device_resident:
            y = Y.to(self.device, self._dtype)
        else:
            y = self._upload(self._host_tensor(Y, allow_bf16=False)).to(self._dtype)
        inv = torch.as_tensor(
            np.asarray(inverse_components), device=self.device
        ).to(self._dtype)
        x = matmul_nt(y, inv, self._einsum_precision()).to(y.dtype)
        if device_resident:
            return x.to(Y.device)
        return _to_numpy(x, spec.np_dtype)

    def components_to_numpy(self, state, spec: ProjectionSpec):
        return _to_numpy(self._matrix(state, spec), spec.np_dtype)
