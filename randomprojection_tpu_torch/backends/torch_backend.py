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
  device memory.  With ``dispatch_steps=K`` a transform's rows run as the
  multistep chain (``fused_project_multistep``), bit-identical to K calls
  on K contiguous row blocks.

Matrix families.  The dense and split2 matrices are the JAX backend's:
drawn at fit on the backend's device from the threefry stream of the key
``fold_in(key(seed), 0x5250)`` (``ops/kernels.py``), the sparse and
Rademacher ones bit for bit and the Gaussian within 4 ulps.  The lazy
matrix is the integer hash stream that the JAX package's kernels use under
``interpret=True`` — portable, so unlike the JAX backend this one runs
lazy models off the TPU.

Meshes (``mesh=``, ``data_axis=``, ``feature_axis=``; the JAX backend's
options).  Each mesh position computes its block of a batch on its device
(``parallel.sharded.run_sharded``): DP splits rows over ``data_axis``,
DP×TP also splits columns over ``feature_axis`` and adds each row block's
partials in feature order (across processes, one ``all_reduce``).  Dense
and split2 matrices are drawn into the mesh's layout
(``materialize_sharded``); the lazy route runs one fused kernel a
position with its feature shard's ``block_offset``, on a column view of
the batch, and one mask cache a (device, feature shard) serves its data
shards.  A batch lands on the mesh's first device; the result is one
tensor there (in a job of several processes, the rows this process holds).

Devices.  ``device=None`` (the default) means the card: with no card the
backend raises rather than run on the CPU.  The CPU runs only when asked
(``backend_options={'device': 'cpu'}``), and the fused wrappers then take
their plain versions.  Host batches go up through ``ops.staging``: a
pinned staging block and a ``non_blocking`` copy on the card's copy
stream, never behind the kernels on the current stream; tensors already
on the card stay there, and so does their output.

Uploads from a producer thread.  ``prepare_batch`` (the ingest sources'
``prepare`` step, called from a worker thread) starts that copy and
returns the ``StagedBatch`` (the device tensor and the event recorded
after its copy) without waiting.  The transform makes the consumer's
stream wait for that event before its kernel and records the tensor's use
on that stream, so the caching allocator does not hand the block to the
next upload while the kernel still reads it.  A direct ``transform``
waits at once (``_upload``).
"""

from __future__ import annotations

import logging
import math
from typing import Optional

import numpy as np
import scipy.sparse as sp

from randomprojection_tpu_torch.backends.base import (
    ProjectionBackend,
    ProjectionSpec,
)
from randomprojection_tpu_torch.ops.staging import StagedBatch, stage_upload
from randomprojection_tpu_torch.utils import telemetry
from randomprojection_tpu_torch.utils.validation import bfloat16_dtype

__all__ = ["TorchBackend", "resolve_device"]

_COMPUTE_DTYPES = ("float32", "bfloat16")

#: the port's logger (the JAX package logs to "randomprojection_tpu")
logger = logging.getLogger("randomprojection_tpu_torch")


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


def _matrix_key(seed: int, device):
    """Seed → the matrix stream's key on ``device``, salted as the JAX
    backend salts it (``fold_in(key(seed), 0x5250)``), so data drawn from
    ``key(seed)`` cannot collide with the matrix stream."""
    from randomprojection_tpu_torch.ops import threefry

    return threefry.fold_in(threefry.seed_key(seed, device), 0x5250)


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
        data_axis: str = "data",
        feature_axis: Optional[str] = None,
        dispatch_steps: int = 1,
        transform_dma: Optional[bool] = None,
    ):
        import torch

        from randomprojection_tpu_torch.ops.precision import (
            default_matmul_precision,
        )
        from randomprojection_tpu_torch.parallel.mesh import Mesh

        if mesh is not None and not isinstance(mesh, Mesh):
            raise ValueError(
                f"mesh must be a parallel.Mesh (make_mesh, global_mesh), got "
                f"{mesh!r}")
        if feature_axis is not None and mesh is None:
            raise ValueError(
                f"feature_axis={feature_axis!r} needs a mesh with that axis")
        for name, axis in (("data_axis", data_axis),
                           ("feature_axis", feature_axis)):
            if mesh is not None and axis is not None \
                    and axis not in mesh.axis_names:
                raise ValueError(
                    f"{name}={axis!r} is not an axis of the mesh "
                    f"{list(mesh.axis_names)}")
        if mesh is not None and device is not None:
            raise ValueError("pass device= or mesh=, not both: a mesh names "
                             "its devices")
        self.mesh = mesh
        self.data_axis = data_axis
        self.feature_axis = feature_axis
        # execution knobs, not spec fields (the spec defines the matrix):
        # they change how a lazy transform runs, never what it computes
        if int(dispatch_steps) < 1:
            raise ValueError(
                f"dispatch_steps must be >= 1, got {dispatch_steps}"
            )
        #: chain each lazy transform's rows as this many row blocks through
        #: one dispatch (``fused_project_multistep``); 1 = one plain call
        self.dispatch_steps = int(dispatch_steps)
        if transform_dma not in (None, True, False):
            raise ValueError(
                "transform_dma must be None (kernel default), True or "
                f"False, got {transform_dma!r}"
            )
        #: accepted for the JAX backend's signature and ignored: the fused
        #: kernel's x route (TMA or cp.async) is chosen by ``plan_project``
        #: from the shape alone, so the TPU kernel's DMA switch has no
        #: counterpart here
        self.transform_dma = transform_dma
        if mesh is None:
            self.device = resolve_device(device)
        else:
            self.device = mesh.home()  # where a batch lands
            if feature_axis is not None:
                # new_group is collective: every process of the job makes
                # the mesh's groups here, in the same order
                from randomprojection_tpu_torch.parallel import distributed

                distributed.process_groups(mesh, feature_axis)
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
        # warn (don't raise: callers may set the knobs unconditionally) when
        # this configuration routes around them, as the JAX backend does
        if materialization != "lazy" and (
            self.dispatch_steps > 1 or transform_dma is not None
        ):
            logger.warning(
                "dispatch_steps/transform_dma affect only the fused lazy "
                "transform kernel; materialization=%r ignores them",
                materialization,
            )
        elif transform_dma is not None:
            logger.warning(
                "transform_dma=%r has no counterpart on the card: the fused "
                "kernel's x route is chosen by plan_project from the shape "
                "alone, so the option is ignored", transform_dma,
            )
        if mesh is not None and self.dispatch_steps > 1:
            logger.warning(
                "dispatch_steps is ignored on the mesh path (each mesh "
                "position launches its own kernel; only the single-device "
                "lazy route chains row blocks through one dispatch)"
            )

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

        from randomprojection_tpu_torch.ops import kernels

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
            if self.feature_axis is not None:
                from randomprojection_tpu_torch.ops.fused_kernels import (
                    BLOCK_D,
                )

                fshards = self.mesh.shape[self.feature_axis]
                if spec.n_features % (fshards * BLOCK_D):
                    # each TP shard regenerates its own BLOCK_D-aligned
                    # column blocks; a ragged shard would pad mid-matrix
                    # and redefine the block streams against one device
                    raise ValueError(
                        "materialization='lazy' under feature-axis TP needs "
                        "n_features divisible by feature_shards*BLOCK_D = "
                        f"{fshards}*{BLOCK_D}, got {spec.n_features}"
                    )
            return _LazyMask(
                spec.seed, spec.density if spec.kind == "sparse" else 1.0
            )

        key = _matrix_key(spec.seed, self.device)
        k, d = spec.n_components, spec.n_features
        if self.precision == "split2" and spec.kind not in ("sparse",
                                                             "rademacher"):
            raise ValueError(
                "precision='split2' relies on the ±1/0 mask being exact "
                "in bf16 and supports kind='sparse'/'rademacher' only; "
                f"got {spec.kind!r} (use precision='high' for gaussian)"
            )
        if self.mesh is not None:
            return self._materialize_sharded(spec, key)
        if self.precision == "split2":
            density = float(spec.density) if spec.kind == "sparse" else 1.0
            scale = 1.0 / math.sqrt(density * k)
            # R entries are exactly ±scale (or 0) in float32, so dividing
            # by the same float32 scale gives exact ±1/0
            R = kernels.sparse_matrix(key, k, d, density, torch.float32)
            mask = (R / torch.tensor(scale, dtype=torch.float32,
                                     device=self.device)).to(torch.bfloat16)
            return _SplitMask(mask, scale)
        if spec.kind == "gaussian":
            return kernels.gaussian_matrix(key, k, d, self._dtype)
        if spec.kind == "sparse":
            return kernels.sparse_matrix(key, k, d, float(spec.density),
                                         self._dtype)
        return kernels.rademacher_matrix(key, k, d, self._dtype)

    def _materialize_sharded(self, spec: ProjectionSpec, key):
        """The dense or split2 state drawn into the mesh's layout: under a
        feature axis each device draws only its column shard
        (``materialize_sharded``), equal to the one-device matrix's columns
        bit for bit."""
        import functools

        import torch

        from randomprojection_tpu_torch.ops import kernels
        from randomprojection_tpu_torch.parallel.sharded import (
            materialize_sharded,
        )

        density = float(spec.density) if spec.kind == "sparse" else 1.0
        if self.precision == "split2":
            # R entries are exactly ±scale (or 0) in float32, so dividing
            # by the same float32 scale gives exact ±1/0
            scale = 1.0 / math.sqrt(density * spec.n_components)
            R = materialize_sharded(
                functools.partial(kernels.sparse_block, density=density), key,
                spec.n_components, spec.n_features, self.mesh,
                feature_axis=self.feature_axis, dtype=torch.float32)
            return _SplitMask(R.map(lambda b: (b / torch.tensor(
                scale, dtype=torch.float32, device=b.device)).to(
                    torch.bfloat16)), scale)
        block_fn = {
            "gaussian": kernels.gaussian_block,
            "sparse": functools.partial(kernels.sparse_block,
                                        density=density),
            "rademacher": kernels.rademacher_block,
        }[spec.kind]
        return materialize_sharded(block_fn, key, spec.n_components,
                                   spec.n_features, self.mesh,
                                   feature_axis=self.feature_axis,
                                   dtype=self._dtype)

    def _lay_out(self, t):
        """A whole matrix on the mesh's layout (as it is without a mesh)."""
        if self.mesh is None:
            return t
        from randomprojection_tpu_torch.parallel.sharded import shard_columns

        return shard_columns(t, self.mesh, self.feature_axis)

    def split_state(self, mask, scale: float) -> _SplitMask:
        """A split2 state from a host ±1/0 mask and its scale."""
        import torch

        return _SplitMask(self._lay_out(
            torch.from_numpy(np.ascontiguousarray(mask, dtype=np.float32)).to(
                self.device, torch.bfloat16
            )), scale)

    def dense_state(self, components):
        """A dense state from a host ``(k, d)`` matrix."""
        import torch

        return self._lay_out(torch.from_numpy(
            np.ascontiguousarray(components, dtype=np.float32)
        ).to(self.device, self._dtype))

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
        """Host tensor → device, ready on the current stream: staged on the
        card's copy stream (``ops.staging``), which the current stream then
        waits for; as is on the CPU."""
        if self.device.type == "cpu":
            return t
        return stage_upload(t, self.device).wait()

    def _prepare_rows(self, X, *, allow_bf16: bool = False):
        """Batch preamble: densify, apply the dtype policy, place on the
        device.  Returns ``(x_on_device, device_resident)``; a
        ``StagedBatch`` counts as device-resident once the current stream
        has waited for its copy."""
        import torch

        from randomprojection_tpu_torch.utils.observability import annotate

        with annotate("rp:backend/prepare"):
            if isinstance(X, StagedBatch):
                X = X.wait()
            device_resident = isinstance(X, torch.Tensor)
            if device_resident:
                keep_bf16 = allow_bf16 and X.dtype == torch.bfloat16
                x = X.to(self.device)
            else:
                x = self._upload(self._host_tensor(X, allow_bf16=allow_bf16))
                keep_bf16 = x.dtype == torch.bfloat16
            if x.dim() != 2:
                raise ValueError(
                    f"Expected a 2D batch, got shape {tuple(x.shape)}")
            if not keep_bf16:
                x = x.to(self._dtype)
        return x, device_resident

    def prepare_batch(self, X, spec: ProjectionSpec):
        """Start a batch's host→device copy ahead of its transform, from
        any thread.  On a card: host rows (an array, a CSR, a CPU tensor)
        go up on the card's copy stream and come back as a
        ``StagedBatch``, which ``transform_async`` takes; a tensor already
        on the card is returned as it is.  On the CPU the rows are placed
        as ``transform`` would place them."""
        import torch

        from randomprojection_tpu_torch.utils.observability import annotate

        allow_bf16 = spec.dtype == "bfloat16"
        if self.mesh is not None:
            # the dispatch lays the batch out over the mesh
            return X
        if self.device.type == "cpu":
            return self._prepare_rows(X, allow_bf16=allow_bf16)[0]
        with annotate("rp:stream/h2d_prefetch"):
            if isinstance(X, torch.Tensor):
                if X.is_cuda:
                    return X  # on a card already: the transform places it
                t = X
            else:
                t = self._host_tensor(X, allow_bf16=allow_bf16)
            return stage_upload(t, self.device)

    def _project_mesh(self, x, state, spec: ProjectionSpec):
        """The mesh routes (``parallel.sharded``): dense and split2 through
        the sharded projectors, lazy through one fused kernel a position."""
        import torch

        from randomprojection_tpu_torch.parallel import sharded

        axes = dict(data_axis=self.data_axis, feature_axis=self.feature_axis)
        if isinstance(state, _SplitMask):
            return sharded.make_sharded_split2_projector(self.mesh, **axes)(
                x, state.mask, state.scale)
        if not isinstance(state, _LazyMask):
            return sharded.make_sharded_projector(
                self.mesh, precision=self._einsum_precision(), **axes)(x, state)
        from randomprojection_tpu_torch.ops import fused_kernels as fk

        mode = "bf16" if x.dtype == torch.bfloat16 else self._lazy_mxu_mode()
        k = spec.n_components
        masks = {}

        def partial(pos, xb, out):
            j, q = self.mesh.axis_index(pos, self.feature_axis)
            offset = j * (spec.n_features // q) // fk.BLOCK_D
            mask = None
            if xb.is_cuda:
                # one mask cache a (device, feature shard), shared by the
                # shard's row blocks
                mask = masks.get((str(xb.device), j))
                if mask is None:
                    mask = masks[str(xb.device), j] = fk.rp_mask_cache(
                        state.seed, k, xb.shape[1], state.density,
                        block_offset=offset, device=xb.device)
            return fk.fused_sparse_project(
                xb, state.seed, k, state.density, block_offset=offset,
                mxu_mode=mode, mask=mask, out=out)

        return sharded.run_sharded(self.mesh, x, k, partial, **axes)

    def _project(self, x, state, spec: ProjectionSpec):
        import torch

        from randomprojection_tpu_torch.ops import fused_kernels as fk
        from randomprojection_tpu_torch.ops.precision import matmul_nt
        from randomprojection_tpu_torch.ops.split_matmul import split2_project

        if self.mesh is not None:
            y = self._project_mesh(x, state, spec)
        elif isinstance(state, _SplitMask):
            y = split2_project(x, state.mask, state.scale)
        elif isinstance(state, _LazyMask):
            # bf16 input (only when the spec's dtype policy allowed it)
            # stays bf16 through the kernel: one product against the exact
            # mask IS the data's own precision, at half the x bytes
            mode = "bf16" if x.dtype == torch.bfloat16 else self._lazy_mxu_mode()
            if self.dispatch_steps > 1 and x.shape[0] > 1:
                y = fk.fused_project_multistep(
                    x, state.seed, spec.n_components, state.density,
                    steps=self.dispatch_steps, mxu_mode=mode,
                )
                if telemetry.enabled():
                    telemetry.emit(
                        telemetry.EVENTS.BACKEND_DISPATCH_FUSED,
                        rows=int(x.shape[0]),
                        # blocks actually chained, not the knob
                        steps=fk.multistep_chain_length(
                            x.shape[0], self.dispatch_steps
                        ),
                        n_components=spec.n_components,
                        # the JAX backend's field: the card donates no buffer
                        donated=False,
                        **telemetry.trace_fields(),
                    )
            else:
                y = fk.fused_sparse_project(
                    x, state.seed, spec.n_components, state.density,
                    mxu_mode=mode,
                )
        else:
            y = matmul_nt(x, state, self._einsum_precision())
        return y.to(x.dtype)

    def _transform_impl(self, X, state, spec: ProjectionSpec):
        """One batch's dispatch, the span ``rp:backend/dispatch`` when
        traced (``rp:backend/prepare`` and ``rp:backend/project`` inside
        it)."""
        from randomprojection_tpu_torch.utils.observability import annotate

        with annotate("rp:backend/dispatch"):
            x, device_resident = self._prepare_rows(
                X, allow_bf16=spec.dtype == "bfloat16"
            )
            telemetry.registry().counter_inc("backend.dispatches")
            if telemetry.enabled():
                # inside a streamed transform the dispatch stage span is
                # active on this thread, so the record joins its batch trace
                telemetry.emit(
                    telemetry.EVENTS.BACKEND_DISPATCH, kind=spec.kind,
                    rows=int(x.shape[0]), n_features=spec.n_features,
                    n_components=spec.n_components,
                    device_resident=bool(device_resident),
                    **telemetry.trace_fields(),
                )
            with annotate("rp:backend/project"):
                return self._project(x, state, spec), device_resident

    def transform(self, X, state, spec: ProjectionSpec, *, dense_output: bool = True):
        """A tensor in gives a tensor out, on the input's device (a
        ``StagedBatch`` one on the card); a host array gives a host array
        in the spec's dtype."""
        y, device_resident = self._transform_impl(X, state, spec)
        if isinstance(X, StagedBatch):
            return y
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
        policy; the lazy and split2 routes, and every route under a mesh,
        compute their coordinates as ``transform`` does.  Output ``(n, ceil(k/8))`` uint8: a tensor for a
        tensor input or ``materialize=False`` (the streaming pipeline),
        else a host array."""
        from randomprojection_tpu_torch.ops.precision import matmul_nt

        if isinstance(state, (_LazyMask, _SplitMask)) or self.mesh is not None:
            y, device_resident = self._transform_impl(X, state, spec)
        else:
            x, device_resident = self._prepare_rows(
                X, allow_bf16=spec.dtype == "bfloat16"
            )
            y = matmul_nt(x, state, self._einsum_precision())
        codes = pack_signs(y)
        if isinstance(X, StagedBatch):
            return codes
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
        from randomprojection_tpu_torch.parallel.sharded import Sharded

        if isinstance(state, _SplitMask):
            mask = state.mask
            if isinstance(mask, Sharded):
                mask = mask.whole(self.device)
            return mask.float() * state.scale
        if isinstance(state, Sharded):
            state = state.whole(self.device)
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
