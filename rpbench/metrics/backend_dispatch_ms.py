"""The torch backend's dispatch of a batch over the traced window: the
mean duration of the program's ``rp:backend/dispatch`` span (the rows'
preparation, the kernels' launches and their allocations, inside the
estimator's ``transform``), in ms."""

from __future__ import annotations

from rpbench import spans


def read(ctx):
    spent = spans.durations_s("rp:backend/dispatch")
    if not spent:
        return None
    return 1e3 * sum(spent) / len(spent)
