"""Plain reference of config 2: ``Y = X @ R.T`` in float64, and its control.

``reference`` computes the projection of float32 rows in float64 against
the matrix ``lazy_mask.matrix`` works out from the seed.  ``control`` is
the same product in the nearest precision below float32 with TF32 off:
float32 inputs on TF32 tensor cores, a product a later change might be
tempted to ship.  ``gap`` is the number compared: the largest absolute
difference over a batch divided by the largest magnitude of the float64
answer, so rounding of float32 arithmetic reads ~1e-7 and TF32 ~1e-3.
"""

from __future__ import annotations

from rpbench.reference import lazy_mask


def reference(x, seed: int, k: int, density: float, *, block_rows=16384):
    """float64 ``x @ R.T`` on ``x``'s device, in blocks of rows."""
    import torch

    r = lazy_mask.matrix(seed, k, x.shape[1], density, device=x.device)
    out = torch.empty((x.shape[0], k), dtype=torch.float64, device=x.device)
    for lo in range(0, x.shape[0], block_rows):
        out[lo:lo + block_rows] = x[lo:lo + block_rows].double() @ r.T
    return out


def to_tf32(t):
    """float32 rounded to TF32's 10-bit mantissa (nearest, ties away):
    what the tensor cores read of a float32 operand."""
    import torch

    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def control(x, seed: int, k: int, density: float):
    """The product on TF32 tensor cores (float32 in, float32 out); off the
    card, where torch has no TF32, its operands rounded to TF32."""
    import torch

    r = lazy_mask.matrix(seed, k, x.shape[1], density, dtype=torch.float32,
                         device=x.device)
    if x.device.type != "cuda":
        return to_tf32(x) @ to_tf32(r).T
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return x.float() @ r.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def gap(y, ref) -> float:
    """max |y - ref| / max |ref| over one batch."""
    scale = float(ref.abs().max())
    return float((y.double() - ref).abs().max()) / scale if scale else 0.0
