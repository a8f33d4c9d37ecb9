"""Query rows a coalesced dispatch of ``TopKServer`` carried over the
traced window (its ``stats()`` queries over its batches, the window's
difference), in rows."""

from __future__ import annotations


def read(ctx):
    return ctx.layer.get("serve_rows_per_batch")
