"""Projection matrices drawn on the device from JAX's threefry stream.

The counterpart of ``randomprojection_tpu/ops/kernels.py``, with the same
definition, so a seed gives the JAX backend's matrix here too:

- ``R`` is a sequence of column blocks ``COLUMN_BLOCK`` wide (the last
  one may be ragged); block ``b`` is a pure function of
  ``fold_in(key, b)`` and of its own width, so any layout (the whole
  matrix, a column shard, one block) gives the same entries.
- Gaussian: ``N(0, 1/k)`` as ``normal · float32(1/sqrt(k))``, the two
  float32 constants folded into one as XLA folds them.
- Sparse (Achlioptas/Li, ``s = 1/density``): one uniform an entry,
  ``u < density/2 → +v``, ``u < density → -v``, else 0, with
  ``v = float32(1/sqrt(density·k))``; the compares run in float32
  against ``float32(density/2)`` and ``float32(density)``, as jax's weak
  types make them.
- Rademacher: ``±float32(1/sqrt(k))`` from ``bernoulli(key, 0.5)``.

Everything is drawn with torch ops on the key's device (``ops/threefry.py``);
nothing is made on the host.  The matrix functions draw every full-width
block of a matrix in one pass, the block keys a batch, and the ragged
last block apart.  The sparse and Rademacher matrices are bit-equal to the
reference's; the Gaussian is within 4 ulps (``ops/threefry.py``; at most 3
measured in ``tests/test_torch_threefry.py``).
"""

from __future__ import annotations

import math

from randomprojection_tpu_torch.ops import threefry
from randomprojection_tpu_torch.utils.validation import (
    check_density,
    check_input_size,
)

__all__ = [
    "COLUMN_BLOCK",
    "num_column_blocks",
    "block_key",
    "gaussian_block",
    "sparse_block",
    "rademacher_block",
    "gaussian_matrix",
    "sparse_matrix",
    "rademacher_matrix",
    "materialize_columns",
]

# Canonical column-block width.  Part of the matrix *definition*: changing it
# changes every generated matrix, so it is a constant, not a knob.
COLUMN_BLOCK = 512

# full-width blocks drawn in one pass: bounds the int64 words a pass holds
# (about 8 of them an entry) however wide the matrix is
_GROUP_ENTRIES = 1 << 22


def num_column_blocks(n_features: int) -> int:
    return -(-n_features // COLUMN_BLOCK)


def block_key(key, block_index):
    """The key owning column block ``block_index`` (an int, or an int64
    tensor of indices for a batch of keys)."""
    return threefry.fold_in(key, block_index)


def _block_width(n_features: int, block_index: int) -> int:
    """Width of block ``block_index`` (the last block may be ragged)."""
    return min(COLUMN_BLOCK, n_features - block_index * COLUMN_BLOCK)


def _on(key, device):
    return key if device is None else key.to(device)


# -- entry values from block keys: (B, 2) keys → (B, k, w) float32 -----------


def _gaussian_values(keys, k: int, w: int):
    return threefry.normal(keys, (k, w), scale=1.0 / math.sqrt(k))


def _sparse_values(keys, k: int, w: int, density: float):
    import torch

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=keys.device)

    u = threefry.uniform(keys, (k, w))
    half, dens = f32(density / 2), f32(density)
    v = f32(1.0 / math.sqrt(density * k))
    plus = (u < half).to(torch.float32)
    minus = ((u >= half) & (u < dens)).to(torch.float32)
    return (plus - minus) * v


def _rademacher_values(keys, k: int, w: int):
    import torch

    v = torch.tensor(1.0 / math.sqrt(k), dtype=torch.float32,
                     device=keys.device)
    return torch.where(threefry.bernoulli(keys, 0.5, (k, w)), v, -v)


# -- per-block generators (the reference's signatures) ------------------------


def _dtype(dtype):
    import torch

    return torch.float32 if dtype is None else dtype


def gaussian_block(key, block_index, n_components, width, dtype=None, *,
                   device=None):
    """Column block of the Gaussian kernel: entries i.i.d. N(0, 1/k)."""
    keys = block_key(_on(key, device), block_index).reshape(1, 2)
    return _gaussian_values(keys, n_components, width)[0].to(_dtype(dtype))


def sparse_block(key, block_index, n_components, width, density, dtype=None,
                 *, device=None):
    """Column block of the Achlioptas/Li sparse kernel: ``{+v, -v, 0}``
    with probabilities ``{density/2, density/2, 1-density}``,
    ``v = 1/sqrt(density·k)``."""
    keys = block_key(_on(key, device), block_index).reshape(1, 2)
    return _sparse_values(keys, n_components, width, float(density))[0].to(
        _dtype(dtype)
    )


def rademacher_block(key, block_index, n_components, width, dtype=None, *,
                     device=None):
    """Column block of the sign/Rademacher kernel: ±1/sqrt(k) each w.p. 1/2."""
    keys = block_key(_on(key, device), block_index).reshape(1, 2)
    return _rademacher_values(keys, n_components, width)[0].to(_dtype(dtype))


# -- full-matrix materialization ----------------------------------------------


def _draw_columns(values, key, k: int, n_features: int, b0: int, b1: int,
                  dtype):
    """Blocks ``[b0, b1)`` side by side, ``(k, width)``: the full-width
    blocks in passes of one batch of keys each, the ragged last block
    apart (its counters run over its own width)."""
    import torch

    full_end = min(b1, n_features // COLUMN_BLOCK)
    group = max(1, _GROUP_ENTRIES // (k * COLUMN_BLOCK))
    parts = []
    for g0 in range(b0, full_end, group):
        g1 = min(g0 + group, full_end)
        idx = torch.arange(g0, g1, dtype=torch.int64, device=key.device)
        vals = values(block_key(key, idx), k, COLUMN_BLOCK)  # (B, k, 512)
        parts.append(vals.permute(1, 0, 2).reshape(k, -1).to(dtype))
    if b1 > full_end:
        w = _block_width(n_features, full_end)
        keys = block_key(key, full_end).reshape(1, 2)
        parts.append(values(keys, k, w)[0].to(dtype))
    return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]


def _materialize(values, key, n_components, n_features, dtype, device):
    check_input_size(n_components, n_features)
    return _draw_columns(
        values, _on(key, device), n_components, n_features, 0,
        num_column_blocks(n_features), _dtype(dtype),
    )


def gaussian_matrix(key, n_components, n_features, dtype=None, *,
                    device=None):
    """The full ``(k, d)`` Gaussian projection matrix on the key's device
    (or ``device``)."""
    return _materialize(_gaussian_values, key, n_components, n_features,
                        dtype, device)


def sparse_matrix(key, n_components, n_features, density, dtype=None, *,
                  device=None):
    """The full ``(k, d)`` sparse (Achlioptas/Li) matrix, dense layout.
    ``density`` must be numeric in (0, 1] (resolve ``'auto'`` with
    ``check_density`` first — done at the estimator layer)."""
    density = check_density(density, n_features)

    def values(keys, k, w):
        return _sparse_values(keys, k, w, density)

    return _materialize(values, key, n_components, n_features, dtype, device)


def rademacher_matrix(key, n_components, n_features, dtype=None, *,
                      device=None):
    """The full ``(k, d)`` sign-RP matrix."""
    return _materialize(_rademacher_values, key, n_components, n_features,
                        dtype, device)


def materialize_columns(block_fn, key, n_components, n_features, col_start,
                        col_end, dtype=None, *, device=None):
    """Columns ``[col_start, col_end)`` of the ``(k, n_features)`` matrix,
    bit-identical to slicing the full matrix: ``col_start`` must be
    ``COLUMN_BLOCK``-aligned and ``col_end`` aligned or at the matrix edge
    (each block is drawn at its canonical width).  ``block_fn`` is a block
    generator of this module (``functools.partial`` it for the density)."""
    import torch

    if col_start % COLUMN_BLOCK != 0:
        raise ValueError(
            f"col_start must be aligned to COLUMN_BLOCK={COLUMN_BLOCK}, got {col_start}"
        )
    if col_end % COLUMN_BLOCK != 0 and col_end != n_features:
        raise ValueError(
            f"col_end must be COLUMN_BLOCK-aligned or equal to n_features="
            f"{n_features}, got {col_end}"
        )
    if not 0 <= col_start < col_end <= n_features:
        raise ValueError(
            f"Expected 0 <= col_start < col_end <= n_features={n_features}, "
            f"got [{col_start}, {col_end})"
        )
    key = _on(key, device)
    blocks = [
        block_fn(key, b, n_components, _block_width(n_features, b),
                 dtype=_dtype(dtype))
        for b in range(col_start // COLUMN_BLOCK, -(-col_end // COLUMN_BLOCK))
    ]
    return torch.cat(blocks, dim=1) if len(blocks) > 1 else blocks[0]
