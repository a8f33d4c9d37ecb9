"""The dispatcher's host work a coalesced batch over the traced window:
the mean self time of the program's ``rp:serve/batch`` span (the
concatenation, the padding, ``query_topk`` and the scatter to the
requests' futures, less the index's waits for the card,
``rp:index/wait_tile``), in ms."""

from __future__ import annotations

from rpbench import spans


def read(ctx):
    own = spans.self_times_s("rp:serve/batch")
    if not own:
        return None
    return 1e3 * sum(own) / len(own)
