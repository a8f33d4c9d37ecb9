"""The program's own spans, as the per-layer readers take them.

While a profiler records, the port keeps every span it opens
(``randomprojection_tpu_torch.utils.observability.annotate``) in an
in-memory store as ``(name, native thread id, start_ns, end_ns)`` on the
profiler's clock, with the interpreter's collections beside it.  The
harness profiles only the traced window, so the store holds that window
alone.  A program without the store (no ``recorded_spans``) gives None,
and its metrics are left out of the line.
"""

from __future__ import annotations

import bisect

from rpbench import trace

#: the host waiting for the card inside an index call
WAIT = "rp:index/wait_tile"


def _observability():
    try:
        from randomprojection_tpu_torch.utils import observability
    except ImportError:
        return None
    return observability if hasattr(observability, "recorded_spans") else None


def named(name: str):
    """The stored spans called ``name``; None without a span store."""
    obs = _observability()
    if obs is None:
        return None
    return [s for s in obs.recorded_spans() if s[0] == name]


def gc_wall_s():
    """The interpreter's collections' summed wall (all generations) while
    the profiler recorded, in s; None without the counters."""
    obs = _observability()
    if obs is None or not hasattr(obs, "gc_collections"):
        return None
    return sum(ns for _n, ns in obs.gc_collections().values()) / 1e9


def durations_s(name: str):
    """Each ``name`` span's duration in s; None when there is none."""
    spans = named(name)
    if not spans:
        return None
    return [(e - s) / 1e9 for _n, _t, s, e in spans]


def self_times_s(name: str):
    """Each ``name`` span's duration less the part of it that the
    ``rp:index/wait_tile`` spans on its own thread cover, in s; None when
    there is none."""
    spans, waits = named(name), named(WAIT) or []
    if not spans:
        return None
    by_tid: dict = {}
    for _n, tid, s, e in waits:
        by_tid.setdefault(tid, []).append((s, e))
    starts = {}
    for tid, ivs in by_tid.items():
        ivs.sort()
        starts[tid] = [s for s, _e in ivs]
    out = []
    for _n, tid, s, e in spans:
        # a thread's spans nest: its waits inside a span start inside it
        ivs, st = by_tid.get(tid, []), starts.get(tid, [])
        lo, hi = bisect.bisect_left(st, s), bisect.bisect_left(st, e)
        inside = [(a, min(b, e)) for a, b in ivs[lo:hi]]
        covered = sum(b - a for a, b in trace.merge(inside) if b > a)
        out.append((e - s - covered) / 1e9)
    return out
