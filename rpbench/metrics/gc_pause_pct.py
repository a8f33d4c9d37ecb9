"""The interpreter's collections over the traced window: their summed
wall, every generation, as the program's collection hook counts them
while the profiler records, over the window, in %.  A collection stops
every thread of the process (the name's part after the dot names the
end-to-end metric it moves: ``gc_pause_pct.serve``)."""

from __future__ import annotations

from rpbench import spans


def read(ctx):
    red, wall = ctx.layer.get("trace"), spans.gc_wall_s()
    if not red or wall is None or red["window_s"] <= 0:
        return None
    return 100.0 * wall / red["window_s"]
