"""The one dtype→matmul-precision policy, and its mapping onto torch.

``default_matmul_precision`` is a copy of the JAX package's policy: f32
compute gets ``'high'`` (f32-grade products), bf16 compute ``'default'``
(its inputs are already quantized; extra passes buy nothing).

On the card the names map to:

- ``'high'`` / ``'highest'``: float32 inputs, float32 products and sums,
  with TF32 off.  TF32 keeps ~10 mantissa bits, whose pairwise-distance
  distortion would exceed the 1e-3 budget of config 2.
- ``'default'``: both operands rounded to bfloat16, float32 accumulation.

``matmul_nt`` sets ``torch.backends.cuda.matmul.allow_tf32`` for the call
and restores it after, so the global is never left changed and its
default is never relied on.
"""

from __future__ import annotations

import contextlib

import numpy as np

__all__ = ["default_matmul_precision", "fp32_matmul", "matmul_nt", "mm_f32acc"]


def default_matmul_precision(dtype) -> str:
    if dtype == "bfloat16":  # numpy knows the name only with ml_dtypes
        return "default"
    return "high" if np.dtype(dtype) == np.float32 else "default"


@contextlib.contextmanager
def fp32_matmul():
    """Float32 products with TF32 off for the duration of the block."""
    import torch

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def mm_f32acc(a, b):
    """``a @ b`` for two bfloat16 operands, accumulated and returned in
    float32.  ``torch.matmul`` of two bf16 tensors returns bf16, which
    rounds the sum; on the card the product asks for a float32 output, on
    the CPU the operands are widened first (exact: every bf16 value is a
    float32, and each product of two bf16 values is exact in float32)."""
    import torch

    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    with fp32_matmul():
        return a.float() @ b.float()


def matmul_nt(x, r, precision: str):
    """``x @ r.T`` in float32 under a precision name (see module doc)."""
    import torch

    if precision == "default":
        return mm_f32acc(x.to(torch.bfloat16), r.to(torch.bfloat16).t())
    if precision not in ("high", "highest"):
        raise ValueError(
            f"precision must be 'default', 'high' or 'highest', got {precision!r}"
        )
    with fp32_matmul():
        return x.float() @ r.float().t()
