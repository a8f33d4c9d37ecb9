"""The streamed rows' bytes over the summed wall of the pipeline's
``h2d`` stage (``StreamStats``: the uploader's ``prepare``, the copy into
pinned staging memory and the queuing of the upload on the copy stream),
in GB/s."""

from __future__ import annotations


def read(ctx):
    stats, nbytes = ctx.layer.get("stream_stats"), ctx.layer.get("stream_bytes")
    if stats is None or not nbytes:
        return None
    wall = stats.stage_wall.get("h2d", 0.0)
    return nbytes / wall / 1e9 if wall > 0 else None
