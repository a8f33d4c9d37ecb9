"""How often K4's row splits share a query's bound over the traced window:
of the (query row, tile) pairs its tensor-core scan (``topk_mma_kernel``)
tested, the share, in percent, at which the bound the query's splits
share (the least m-th distance a split's full list has held) was below
the row's own threshold, from the program's counter
(``observability.bound_counts``: row-tiles, bound tighter, counted while
the profiler records; an LSH tile's re-rank counted from its stats).  A
program without the counter, or a window with no such scan, gives None
(the name's part after the dot names the end-to-end metric it moves:
``k4_bound_share.queries``)."""

from __future__ import annotations


def read(ctx):
    try:
        from randomprojection_tpu_torch.utils import observability
    except ImportError:
        return None
    counts = getattr(observability, "bound_counts", None)
    if counts is None:
        return None
    row_tiles, tighter = counts()
    if row_tiles <= 0:
        return None
    return 100.0 * tighter / row_tiles
