"""Two-pass split-precision projection for exact-in-bf16 mask matrices.

The counterpart of ``randomprojection_tpu/ops/split_matmul.py``.  For the
sparse (Achlioptas/Li) and sign kernels the *unscaled* matrix entries are
``{+1, -1, 0}`` — exactly representable in bf16.  Splitting only ``X``
into high/low bf16 halves then gives f32-grade output from two bf16
products:

    X = X_hi + X_lo   (X_hi = top 16 bits of the f32 sign/exponent/mantissa)
    Y = (X_hi · Mᵀ + X_lo · Mᵀ) · v

The high part is produced by **bit-masking** the f32 word
(``& 0xFFFF0000`` on the int32 view), not by an f32→bf16→f32 convert
pair; truncation (vs round-to-nearest) is fine, the low half absorbs the
difference exactly up to its own bf16 rounding.  Both products are
accumulated and returned in float32 (``precision.mm_f32acc``).  This is a
plain product that the JAX package leaves to XLA, so ``torch.mm`` serves
it.
"""

from __future__ import annotations

from randomprojection_tpu_torch.ops.precision import mm_f32acc

__all__ = ["split_f32_to_bf16_pair", "split_f32_to_bf16_triple",
           "split2_project"]

_HI_MASK = -65536  # 0xFFFF0000 as a signed int32


def split_f32_to_bf16_pair(x):
    """``x (f32) -> (x_hi, x_lo)`` bf16 with ``x_hi + x_lo == x`` to ~2^-16."""
    import torch

    x = x.to(torch.float32)
    x_hi_f32 = (x.view(torch.int32) & _HI_MASK).view(torch.float32)
    x_hi = x_hi_f32.to(torch.bfloat16)  # exact: low mantissa bits are zero
    x_lo = (x - x_hi_f32).to(torch.bfloat16)
    return x_hi, x_lo


def split_f32_to_bf16_triple(x):
    """``x (f32) -> (hi, mid, lo)`` bf16 by two successive ``& 0xFFFF0000``
    truncations: ``hi`` is x's top 16 bits, ``mid`` the top 16 bits of
    ``r = x − hi`` (exact), ``lo = bf16(r − mid)``.  Each part holds 8
    significant bits of x's 24, so ``hi + mid + lo == x`` exactly whenever
    ``|x| ≥ 2⁻¹¹⁰`` (the bits of ``lo`` stay on bf16's grid) and within
    2⁻¹³³ below that, where bf16 cannot hold float32's lowest bits.  The
    fused kernel's ``'f32'`` mode contracts the three parts on the bf16
    tensor cores: each product with a ±1/0 mask is exact."""
    import torch

    x = x.to(torch.float32)
    hi = (x.view(torch.int32) & _HI_MASK).view(torch.float32)
    r = x - hi
    mid = (r.view(torch.int32) & _HI_MASK).view(torch.float32)
    return hi.to(torch.bfloat16), mid.to(torch.bfloat16), (r - mid).to(
        torch.bfloat16)


def split2_project(x, mask_bf16, scale: float):
    """``(x @ mask.T) * scale`` in two bf16 products, f32-grade accuracy.

    ``x`` ``(n, d)`` (cast to f32); ``mask_bf16`` ``(k, d)`` with entries
    exactly representable in bf16 (``{±1, 0}``); ``scale`` python float.
    Returns float32 ``(n, k)``.
    """
    x_hi, x_lo = split_f32_to_bf16_pair(x)
    m_t = mask_bf16.t()
    return (mm_f32acc(x_hi, m_t) + mm_f32acc(x_lo, m_t)) * scale
