"""The host's own time in ``LSHSimHashIndex.query_topk`` a call over the
traced window: the mean self time of the program's ``rp:lsh/query_topk``
span (a tile's sizing on the host CSR, its staging and graph replay, the
copies started, the ladder and the copy-out), less the waits for the card
(``rp:lsh/wait_tile``) on its thread, in ms.  A program without the
spans gives None."""

from __future__ import annotations

from rpbench import spans, trace

WAIT = "rp:lsh/wait_tile"


def read(ctx):
    calls = spans.named("rp:lsh/query_topk")
    if not calls:
        return None
    waits: dict = {}
    for _n, tid, s, e in spans.named(WAIT) or []:
        waits.setdefault(tid, []).append((s, e))
    own = []
    for _n, tid, s, e in calls:
        inside = [(max(a, s), min(b, e)) for a, b in waits.get(tid, [])
                  if a < e and b > s]
        covered = sum(b - a for a, b in trace.merge(inside))
        own.append((e - s - covered) / 1e9)
    return 1e3 * sum(own) / len(own)
