"""The 99th percentile of a request's wait in ``TopKServer``'s queue over
the traced window: from ``submit`` to its coalesced batch's dispatch,
the program's ``rp:serve/queue_wait`` span a request, in ms."""

from __future__ import annotations

import numpy as np

from rpbench import spans


def read(ctx):
    waits = spans.durations_s("rp:serve/queue_wait")
    if not waits:
        return None
    return float(np.percentile(waits, 99)) * 1e3
