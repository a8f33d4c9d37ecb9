"""The pipeline's overlap ratio over the traced window, as
``StreamStats.overlap_ratio()`` defines it: 1 - the window's wall over the
summed stage walls of every job in it (one ``StreamStats`` spans the
jobs; its own clock restarts with each job, so the wall is the
harness's).  0 when the stages ran one after another."""

from __future__ import annotations


def read(ctx):
    stats, wall = ctx.layer.get("stream_stats"), ctx.layer.get("stream_wall_s")
    if stats is None or not wall:
        return None
    total = sum(stats.stage_wall.values())
    return max(0.0, 1.0 - wall / total) if total > 0 else None
