#!/usr/bin/env python3
"""A numpy model of why the fused kernel restarts its tensor-core sum at
every 512-column block.

Hopper's tensor cores may round their float32 sums toward zero.  This
models split2's arithmetic on config 2's contraction (d = 4096, density
1/3, x standard normal): each k16 step adds the exact sum of 16 hi
products, then of 16 lo products, to a float32 accumulator rounded toward
zero; the accumulator either runs over all of d or restarts every
``block`` columns into a float32 sum rounded to nearest.  It prints
max|Δ| / max|Y| against the exact sum of the same parts, to set beside the
1e-5 tolerance.  CPU only, a few seconds a row::

    python3 torch_experiments/rz_model.py
"""

from __future__ import annotations

import numpy as np

D, K16, ROWS = 4096, 16, 32_768


def rz32(a):
    """float64 → float32, rounded toward zero."""
    f = a.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(a)
    return np.where(over, np.nextafter(f, np.float32(0)), f).astype(np.float64)


def split2(x):
    """hi = x & 0xFFFF0000, lo = bf16_rn(x − hi), as float64."""
    hi = (x.view(np.int32) & np.int32(-65536)).view(np.float32)
    bits = (x - hi).view(np.uint32).astype(np.uint64)
    lo = ((bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000).astype(
        np.uint32).view(np.float32)
    return hi.astype(np.float64), lo.astype(np.float64)


def main() -> None:
    rng = np.random.default_rng(0)
    x = rng.normal(size=(ROWS, D)).astype(np.float32)
    m = rng.choice([1.0, -1.0, 0.0], p=[1 / 6, 1 / 6, 2 / 3], size=(ROWS, D))
    hi, lo = split2(x)
    exact = ((hi + lo) * m).sum(1)
    for block in (D, 512):
        total = np.zeros(ROWS, np.float32)
        for b0 in range(0, D, block):
            acc = np.zeros(ROWS)
            for j in range(b0, b0 + block, K16):
                acc = rz32(acc + (hi[:, j:j + K16] * m[:, j:j + K16]).sum(1))
                acc = rz32(acc + (lo[:, j:j + K16] * m[:, j:j + K16]).sum(1))
            total = total + acc.astype(np.float32)
        err = np.abs(total.astype(np.float64) - exact).max()
        print(f"restart every {block} columns: max|d|/max|Y| = "
              f"{err / np.abs(exact).max():.3e} over {ROWS} rows")


if __name__ == "__main__":
    main()
