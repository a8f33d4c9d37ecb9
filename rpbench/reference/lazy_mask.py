"""The lazy sparse matrix of config 2, worked out from its seed alone.

A frozen copy of the integer hash that defines the lazy (in-kernel
regenerated) Achlioptas matrix: block ``b`` of 512 columns, row ``r``,
column ``c`` within the block and seed ``s``, all uint32::

    h = r*0x9E3779B1 ^ c*0x85EBCA77 ^ s*0xC2B2AE3D ^ b*0x27D4EB2F
    h = (h ^ (h >> 15)) * 0x2C1B3C6D
    h ^= h >> 13
    m = h >> 8                       # 24 bits, u = m / 2**24

The entry is +1 where ``u < f32(density/2)``, -1 where ``u < f32(density)``
and 0 elsewhere, and the matrix is scaled by ``1/sqrt(density*k)``: the
semantics of scikit-learn's ``SparseRandomProjection`` with a hashed draw.
Plain torch on 64-bit integers; nothing of the program is imported.
"""

from __future__ import annotations

import math

BLOCK = 512
_MASK32 = 0xFFFFFFFF
_ROW, _COL, _SEED, _BLK, _MIX = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D,
                                 0x27D4EB2F, 0x2C1B3C6D)


def _mul(a, c: int):
    """``a*c mod 2**32`` for int64 ``a`` in [0, 2**32): the constant split
    into 16-bit halves so no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _MASK32


def _limit(t: float) -> int:
    """The 24-bit threshold equivalent to ``u < float32(t)``."""
    import numpy as np

    return math.ceil(float(np.float32(t)) * (1 << 24))


def signs(seed: int, k: int, d: int, density: float, *, device="cpu"):
    """The unscaled ``(k, d)`` matrix of +1, -1 and 0 as int8."""
    import torch

    r = torch.arange(k, dtype=torch.int64, device=device)[:, None]
    col = torch.arange(d, dtype=torch.int64, device=device)[None, :]
    c, b = col % BLOCK, col // BLOCK
    h = (_mul(r, _ROW) ^ _mul(c, _COL) ^ ((int(seed) & _MASK32) * _SEED
                                         & _MASK32) ^ _mul(b, _BLK))
    h = _mul(h ^ (h >> 15), _MIX)
    m = (h ^ (h >> 13)) >> 8
    plus, nonzero = _limit(density / 2), _limit(density)
    out = torch.zeros((k, d), dtype=torch.int8, device=device)
    out[m < nonzero] = -1
    out[m < plus] = 1
    return out


def matrix(seed: int, k: int, d: int, density: float, *, dtype=None,
           device="cpu"):
    """``R`` as ``(k, d)``: the signs times ``1/sqrt(density*k)`` (float64
    unless ``dtype`` says otherwise)."""
    import torch

    dtype = torch.float64 if dtype is None else dtype
    return signs(seed, k, d, density, device=device).to(dtype) * (
        1.0 / math.sqrt(density * k))
