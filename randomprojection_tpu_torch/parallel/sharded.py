"""Sharded projection execution: DP over rows, optional TP over features
(the port of ``randomprojection_tpu/parallel/sharded.py``).

The compute is one contraction, ``Y[n,k] = Σ_d X[n,d]·R[k,d]``.  Layouts:

- **DP**: X's rows split over the data axis, R whole on every device; each
  position computes its rows, no reduction.
- **DP×TP**: X split ``(data, feature)``, R's columns over the feature
  axis; each position computes the partial ``X_block @ R_shardᵀ`` and the
  partials of one row block are added over the feature axis.

The reference runs each position under ``shard_map`` and completes the
contraction with one ``psum``.  Here each position runs eagerly on its
device (``run_sharded``), and the reduction adds the partials in a fixed
order, shard 0 + shard 1 + …, on the device of the row block's first
position: a plain sum where the positions share a device, a copy to that
device first where they are other cards of this process.  Where a row
block's positions lie in several processes of a ``torch.distributed``
job, each process sums its own positions first and one ``all_reduce``
over that block's group adds the processes' sums (``distributed``).  The
sums run in another order than one device's, so TP agrees with one
device within ``1e-5·max|Y|``, not bit for bit; DP, with K1's
row-independent kernel, is bit for bit on a card.

Matrices under sharding: a column shard is drawn block by block from the
threefry stream (``ops.kernels``), so it equals the full matrix's columns
bit for bit however the shard boundaries fall (``materialize_sharded``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from randomprojection_tpu_torch.parallel.mesh import DATA_AXIS, FEATURE_AXIS

__all__ = [
    "Layout",
    "Sharded",
    "replicated",
    "row_sharded",
    "feature_sharded",
    "materialize_sharded",
    "make_sharded_projector",
    "make_sharded_split2_projector",
    "row_bucket",
    "run_sharded",
    "shard_columns",
    "slice_rows_sharded",
    "token_balanced_bounds",
]


def row_bucket(n: int, mesh=None, data_axis: str = DATA_AXIS) -> int:
    """Pad target for a batch of ``n`` rows.

    Buckets at the quarter-points of each power-of-two octave
    (``{1, 1.25, 1.5, 1.75, 2}·2^k``): the number of distinct targets over
    a stream of ragged shapes stays O(log n) while pad waste is capped at
    25%.  The result is a multiple of 8; on a mesh it is also a multiple of
    8×(data-axis size), so every shard's row count keeps that tiling.

    Eager PyTorch needs no static shapes, so the port pads no rows for
    compute: the bucket sizes the pinned host staging blocks, and on a
    mesh ``bucket / p`` is a data shard's row block (the reference's split
    of its padded batch, ``Layout.bounds``).
    """
    pow2 = max(8, 1 << (n - 1).bit_length())
    if pow2 < 64:
        pad_to = pow2  # tiny batches: waste is noise, keep one size
    else:
        step = pow2 // 8  # multiple of 8 whenever pow2 >= 64
        for frac in (4, 5, 6, 7, 8):
            pad_to = step * frac
            if pad_to >= n:
                break
    if mesh is not None:
        pad_to += -pad_to % (8 * mesh.shape[data_axis])
    return pad_to


def token_balanced_bounds(indptr, p: int) -> np.ndarray:
    """Row cut points ``(p + 1,)`` int64 splitting one CSR batch into ``p``
    contiguous row ranges whose TOKEN counts balance: cut ``s`` is the
    first row whose token prefix reaches ``s·nnz/p`` (``searchsorted`` on
    the indptr), so every shard's token count is within one row's tokens
    of ``nnz/p``.  Cuts are row-aligned and monotone; empty ranges are
    legal for degenerate batches."""
    if p < 1:
        raise ValueError(f"p must be >= 1, got {p}")
    indptr = np.asarray(indptr, dtype=np.int64)
    n = indptr.shape[0] - 1
    total = int(indptr[-1])
    targets = (np.arange(1, p, dtype=np.int64) * total) // p
    cuts = np.searchsorted(indptr, targets, side="left")
    bounds = np.concatenate(
        [[0], np.minimum(cuts, n), [n]]
    ).astype(np.int64)
    return np.maximum.accumulate(bounds)


def slice_rows_sharded(y, n: int):
    """Drop pad rows from a batch result: a plain slice.  The reference
    slices a row-sharded array under jit; the port's sharded result is one
    tensor in a process, so the slice is all that is left."""
    return y if y.shape[0] == n else y[:n]


class Layout:
    """Where a 2-D tensor's blocks live on a mesh: ``spec`` is the
    reference's ``PartitionSpec`` as a pair (the axis splitting rows, the
    axis splitting columns; None = not split).  Rows split as the
    reference splits its padded batch (``row_bucket(n, mesh) / p`` rows a
    block, the tail short or empty); columns in ``ceil(d / p)`` blocks, as
    an uneven JAX sharding does."""

    def __init__(self, mesh, spec=(None, None)):
        spec = tuple(spec) + (None,) * (2 - len(tuple(spec)))
        for axis in spec:
            if axis is not None and axis not in mesh.axis_names:
                raise ValueError(
                    f"mesh has axes {list(mesh.axis_names)}, no {axis!r}")
        self.mesh = mesh
        self.spec = spec

    def bounds(self, pos: tuple, shape) -> tuple:
        """``((r0, r1), (c0, c1))``: position ``pos``'s block of a tensor of
        ``shape``."""
        n, d = shape
        i, p = self.mesh.axis_index(pos, self.spec[0])
        per = row_bucket(n, self.mesh, self.spec[0]) // p if p > 1 else n
        r0 = min(i * per, n)
        j, q = self.mesh.axis_index(pos, self.spec[1])
        w = -(-d // q)
        c0 = min(j * w, d)
        return (r0, min(r0 + per, n)), (c0, min(c0 + w, d))

    def positions(self):
        """This process's mesh positions, in the mesh's order."""
        return [pos for pos in np.ndindex(*self.mesh.devices.shape)
                if self.mesh.is_local(pos)]

    def device(self, pos: tuple):
        return self.mesh.devices[pos]

    def place(self, t, pos: tuple):
        """Position ``pos``'s block of the whole tensor ``t`` on its device
        (a view where ``t`` is there already)."""
        (r0, r1), (c0, c1) = self.bounds(pos, tuple(t.shape))
        return t[r0:r1, c0:c1].to(self.device(pos))


def replicated(mesh) -> Layout:
    return Layout(mesh, (None, None))


def row_sharded(mesh, data_axis: str = DATA_AXIS) -> Layout:
    return Layout(mesh, (data_axis, None))


def feature_sharded(mesh, feature_axis: str = FEATURE_AXIS) -> Layout:
    """R column-sharded: each position holds R[:, d_shard]."""
    return Layout(mesh, (None, feature_axis))


class Sharded:
    """A ``(k, d)`` matrix laid out over a mesh (``materialize_sharded``):
    the layout, the whole shape, and this process's blocks, one tensor a
    distinct (device, column range), shared by the positions that name
    them."""

    def __init__(self, layout: Layout, shape: tuple, blocks: dict):
        self.layout = layout
        self.shape = tuple(shape)
        self.blocks = blocks

    def block(self, pos: tuple):
        """The block of mesh position ``pos``."""
        _, cols = self.layout.bounds(pos, self.shape)
        return self.blocks[(str(self.layout.device(pos)), cols)]

    def map(self, fn) -> "Sharded":
        """The same layout with ``fn`` applied to every block."""
        return Sharded(self.layout, self.shape,
                       {key: fn(b) for key, b in self.blocks.items()})

    @property
    def dtype(self):
        return next(iter(self.blocks.values())).dtype

    def whole(self, device):
        """The whole matrix on ``device``, its column blocks concatenated
        (every block must be this process's)."""
        import torch

        cols = {}
        for pos in np.ndindex(*self.layout.mesh.devices.shape):
            _, c = self.layout.bounds(pos, self.shape)
            key = (str(self.layout.device(pos)), c)
            if key in self.blocks:
                cols.setdefault(c, self.blocks[key])
        spans = sorted(c for c in cols if c[1] > c[0])
        if [c0 for c0, _ in spans] != [0] + [c1 for _, c1 in spans[:-1]] \
                or spans[-1][1] != self.shape[1]:
            raise ValueError(
                "the matrix's column blocks are not all this process's; "
                "the whole matrix lives across processes")
        return torch.cat([cols[c].to(device) for c in spans], dim=1)


def _column_blocks(mesh, feature_axis: Optional[str], shape: tuple,
                   make) -> Sharded:
    """A ``Sharded`` of ``shape`` whose blocks are ``make(device, c0, c1)``,
    once a (device, column range) of this process's positions."""
    layout = (feature_sharded(mesh, feature_axis) if feature_axis
              else replicated(mesh))
    blocks = {}
    for pos in layout.positions():
        _, cols = layout.bounds(pos, shape)
        name = (str(layout.device(pos)), cols)
        if name not in blocks:
            blocks[name] = make(layout.device(pos), *cols)
    return Sharded(layout, shape, blocks)


def shard_columns(t, mesh, feature_axis: Optional[str] = None) -> Sharded:
    """A whole ``(k, d)`` matrix ``t`` laid out over ``mesh``: its column
    shards over ``feature_axis`` (or the whole matrix) on each of this
    process's devices."""
    return _column_blocks(mesh, feature_axis, tuple(t.shape),
                          lambda dev, c0, c1: t[:, c0:c1].to(dev).contiguous())


def materialize_sharded(block_fn, key, n_components: int, n_features: int,
                        mesh, *, feature_axis: Optional[str] = None,
                        dtype=None) -> Sharded:
    """R drawn directly into its mesh layout: each of this process's
    devices draws only its own column shard (``feature_axis``) or, with
    none, the whole matrix once a device.  ``block_fn`` is a block
    generator of ``ops.kernels`` (``functools.partial`` it for the
    density).  A shard is drawn over the 512-column blocks that cover it,
    then cut, so its values equal the full matrix's columns bit for bit
    wherever its boundaries fall."""
    import torch

    from randomprojection_tpu_torch.ops.kernels import (
        COLUMN_BLOCK,
        materialize_columns,
    )

    def draw(dev, c0, c1):
        if c1 == c0:  # an empty shard of a narrow matrix
            return torch.empty((n_components, 0), dtype=dtype, device=dev)
        b0 = c0 // COLUMN_BLOCK * COLUMN_BLOCK
        b1 = min(-(-c1 // COLUMN_BLOCK) * COLUMN_BLOCK, n_features)
        cover = materialize_columns(block_fn, key, n_components, n_features,
                                    b0, b1, dtype, device=dev)
        return cover[:, c0 - b0:c1 - b0].contiguous()

    return _column_blocks(mesh, feature_axis, (n_components, n_features),
                          draw)


def run_sharded(mesh, x, n_components: int, partial, *,
                data_axis: str = DATA_AXIS,
                feature_axis: Optional[str] = None):
    """Run ``partial(pos, x_block, out)`` at this process's positions of
    ``mesh`` over the ``(n, d)`` batch ``x`` and assemble ``Y (n, k)``.

    ``x_block`` is the position's block of ``x`` on its device (a view
    where ``x`` is there); ``out`` is the rows of ``Y`` the block fills
    when the partial may be written there directly (a row block's first
    partial, on ``Y``'s device), else None.  ``partial`` returns its
    ``(rows, k)`` float32 partial (``out`` itself when it wrote there).
    One position a (row block, feature index) runs: positions that repeat
    a block along another axis are replicas.  The partials of a row block
    are added in feature order on its first position's device; where the
    block's positions lie in several processes, one ``all_reduce`` over its
    group follows.  Returns ``Y`` on
    this process's first position's device: every row in one process, and
    in a job spanning processes the rows this process holds (the row
    blocks it has a position in), in row order."""
    import torch

    from randomprojection_tpu_torch.parallel import distributed

    layout = Layout(mesh, (data_axis, feature_axis))
    spans = mesh.ranks is not None and feature_axis is not None
    if spans and set(mesh.axis_names) - {data_axis, feature_axis}:
        raise ValueError(
            f"a mesh spanning processes reduces over {feature_axis!r} with no "
            f"axis but {data_axis!r} beside it, got {list(mesh.axis_names)}")
    groups = distributed.process_groups(mesh, feature_axis) if spans else {}
    blocks = {}  # row block -> feature index -> its positions
    for pos in np.ndindex(*mesh.devices.shape):
        rows, _ = layout.bounds(pos, x.shape)
        j = mesh.axis_index(pos, feature_axis)[0]
        blocks.setdefault(rows, {}).setdefault(j, []).append(pos)
    home = mesh.home()
    y = torch.empty((x.shape[0], n_components), dtype=torch.float32,
                    device=home)
    held = []
    for (r0, r1), by_feature in sorted(blocks.items()):
        mine = {j: next((p for p in ps if mesh.is_local(p)), None)
                for j, ps in by_feature.items()}
        mine = {j: p for j, p in mine.items() if p is not None}
        if not mine:
            continue
        held.append((r0, r1))
        if r1 == r0:
            continue
        acc, direct = None, False
        for j in sorted(mine):
            pos = mine[j]
            out = (y[r0:r1] if acc is None and layout.device(pos) == home
                   else None)
            part = partial(pos, layout.place(x, pos), out)
            if acc is None:
                acc = part
                direct = out is not None and part.data_ptr() == out.data_ptr()
            else:
                acc += part.to(acc.device)
        if spans:
            ranks = tuple(sorted({int(mesh.ranks[p])
                                  for ps in by_feature.values() for p in ps}))
            if len(ranks) > 1:
                import torch.distributed as dist

                dist.all_reduce(acc, group=groups[ranks])
        if not direct:
            y[r0:r1].copy_(acc)
    if len(held) == len(blocks):
        return y
    return torch.cat([y[r0:r1] for r0, r1 in held])


def make_sharded_projector(mesh, *, data_axis: str = DATA_AXIS,
                           feature_axis: Optional[str] = None,
                           precision: Optional[str] = None):
    """The sharded transform ``(X, R) -> X @ R.T``: X split over
    ``(data, feature)`` (or rows alone without TP), R a ``Sharded``
    from ``materialize_sharded`` (or a whole tensor, cut per position).
    Each position takes one float32-accumulated product under the
    precision policy; the partials are reduced over ``feature_axis``
    (``run_sharded``).  The output is in X's dtype."""
    from randomprojection_tpu_torch.ops.precision import (
        default_matmul_precision,
        matmul_nt,
    )

    def project(x, r):
        prec = precision or default_matmul_precision(
            str(x.dtype).replace("torch.", ""))
        cols = Layout(mesh, (None, feature_axis))

        def partial(pos, xb, out):
            rb = (r.block(pos) if isinstance(r, Sharded)
                  else cols.place(r, pos)).to(xb.device)
            return matmul_nt(xb, rb, prec)

        y = run_sharded(mesh, x, r.shape[0], partial, data_axis=data_axis,
                        feature_axis=feature_axis)
        return y.to(x.dtype)

    return project


def make_sharded_split2_projector(mesh, *, data_axis: str = DATA_AXIS,
                                  feature_axis: Optional[str] = FEATURE_AXIS):
    """The split2 transform under DP×TP: each position splits its own
    ``X[:, d_shard]`` into hi/lo bf16 halves and takes two float32
    products against its unscaled ±1/0 bf16 mask shard; the two partials
    are added BEFORE the feature reduction (one reduction for both), and
    the common scale is applied after it.  ``mask``: a ``Sharded`` (or a
    whole tensor); returns Y in X's dtype, f32-grade (``ops/split_matmul``)."""
    from randomprojection_tpu_torch.ops.precision import mm_f32acc
    from randomprojection_tpu_torch.ops.split_matmul import (
        split_f32_to_bf16_pair,
    )

    def project(x, mask, scale: float):
        cols = Layout(mesh, (None, feature_axis))

        def partial(pos, xb, out):
            mb = (mask.block(pos) if isinstance(mask, Sharded)
                  else cols.place(mask, pos)).to(xb.device)
            hi, lo = split_f32_to_bf16_pair(xb.float())
            mt = mb.t()
            return mm_f32acc(hi, mt) + mm_f32acc(lo, mt)

        y = run_sharded(mesh, x, mask.shape[0], partial, data_axis=data_axis,
                        feature_axis=feature_axis)
        return (y * scale).to(x.dtype)

    return project
