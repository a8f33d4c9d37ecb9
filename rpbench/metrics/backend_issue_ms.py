"""The host's time in ``est.transform`` a batch, before any wait for the
card (the backend's dispatch, its allocations, the launches), as the mean
over every call of the traced window, in ms."""

from __future__ import annotations


def read(ctx):
    issue = ctx.layer.get("issue_s")
    if not issue:
        return None
    return 1e3 * sum(issue) / len(issue)
