"""Row bucketing (the single-device part of
``randomprojection_tpu/parallel/sharded.py``; meshes come in a later slice).

Eager PyTorch needs no static shapes, so the port pads no rows for
compute.  The bucket sizes the pinned host staging buffers instead: a
stream of ragged batch shapes then reuses a few pinned block sizes rather
than pinning one per shape.
"""

from __future__ import annotations

__all__ = ["row_bucket"]


def row_bucket(n: int) -> int:
    """Pad target for a batch of ``n`` rows.

    Buckets at the quarter-points of each power-of-two octave
    (``{1, 1.25, 1.5, 1.75, 2}·2^k``): the number of distinct targets over
    a stream of ragged shapes stays O(log n) while pad waste is capped at
    25%.  The result is a multiple of 8.
    """
    pow2 = max(8, 1 << (n - 1).bit_length())
    if pow2 < 64:
        return pow2  # tiny batches: waste is noise, keep one size
    step = pow2 // 8  # multiple of 8 whenever pow2 >= 64
    for frac in (4, 5, 6, 7, 8):
        pad_to = step * frac
        if pad_to >= n:
            break
    return pad_to
