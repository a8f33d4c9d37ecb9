"""The card's idle share of the traced window: 1 - (union of the card's
activities / the window), in %.  One reader for each cell's own metric
(``device_idle_pct.rows``, ``.queries``, ``.serve``, ``.streamed``: the
part after the dot names the end-to-end metric it moves)."""

from __future__ import annotations

from rpbench import trace


def read(ctx):
    return trace.idle_pct(ctx.layer.get("trace"))
