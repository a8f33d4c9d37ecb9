"""The host's own time in ``SimHashIndex.query_topk`` a call over the
traced window: the mean self time of the program's
``rp:index/query_topk`` span (the tiles' dispatch, the copies' set-up and
the merge of the chunks' candidates, less the waits for the card,
``rp:index/wait_tile``), in ms."""

from __future__ import annotations

from rpbench import spans


def read(ctx):
    own = spans.self_times_s("rp:index/query_topk")
    if not own:
        return None
    return 1e3 * sum(own) / len(own)
