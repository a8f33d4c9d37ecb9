"""What K4's survivors' path takes on over the traced window: the mean keys
a (query, split) list of its tensor-core scan (``topk_mma_kernel``) took
into its query row's buffer, from the program's counter
(``observability.survivor_counts``: lists, keys, merges, counted while the
profiler records; an LSH tile's re-rank counted from its stats).  A
program without the counter, or a window with no such scan, gives None
(the name's part after the dot names the end-to-end metric it moves:
``k4_survivors.queries``)."""

from __future__ import annotations


def read(ctx):
    try:
        from randomprojection_tpu_torch.utils import observability
    except ImportError:
        return None
    counts = getattr(observability, "survivor_counts", None)
    if counts is None:
        return None
    lists, keys, _merges = counts()
    if lists <= 0:
        return None
    return keys / lists
