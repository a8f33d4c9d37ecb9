"""The traced run: the harness's own spans and the reduction of a
``torch.profiler`` trace to device time.

The harness names its calls into the program with spans
(``record_function("rpbench:<name>")``), active only while the profiler
records.  ``reduce`` reads the profiler's events once the window closes:

- the window is the ``rpbench:window`` span on the host;
- device time is every activity on the card (kernels, copies, fills) but
  the profiler's echo of host annotations, clipped to the window and
  merged where activities overlap: its sum is ``busy_s``;
- ``kernels`` sums each activity's time by name;
- ``gaps`` are the ten longest idle stretches between merged activities,
  each named by the innermost harness span open on the host when it
  began.
"""

from __future__ import annotations

import contextlib
import types

PREFIX = "rpbench:"
WINDOW = PREFIX + "window"
_ECHO_PREFIXES = ("rp:", PREFIX, "ProfilerStep")


def span(name: str):
    """A named region of the harness, seen by the profiler when it records
    (a null context otherwise)."""
    import sys

    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd.profiler._is_profiler_enabled:
        return contextlib.nullcontext()
    return torch.profiler.record_function(PREFIX + name)


@contextlib.contextmanager
def profiled():
    """Record the region with the profiler on the host and the card; yields
    a holder whose ``prof`` is the finished profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    holder = types.SimpleNamespace(prof=None)
    with profile(activities=acts) as prof:
        yield holder
    holder.prof = prof


def _is_device(e) -> bool:
    from torch.autograd import DeviceType

    if e.device_type() == DeviceType.CPU:
        return False
    if getattr(e, "is_user_annotation", lambda: False)():
        return False
    return not e.name().startswith(_ECHO_PREFIXES)


def merge(intervals):
    """Union of ``(start, end)`` intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce(prof) -> dict:
    """``{"window_s", "busy_s", "kernels": {name: [count, s]}, "gaps":
    [[span, s], ...] longest first}``; None without a window span."""
    from torch.autograd import DeviceType

    evs = list(prof.profiler.kineto_results.events())
    host = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            for e in evs if e.device_type() == DeviceType.CPU
            and e.name().startswith(PREFIX)]
    win = [h for h in host if h[2] == WINDOW]
    if not win:
        return None
    w0, w1 = win[0][0], win[0][1]
    kernels: dict = {}
    ivs = []
    for e in evs:
        if not _is_device(e):
            continue
        s, t = e.start_ns(), e.start_ns() + e.duration_ns()
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        ivs.append((s, t))
        row = kernels.setdefault(e.name(), [0, 0.0])
        row[0] += 1
        row[1] += (t - s) / 1e9
    busy = merge(ivs)
    busy_s = sum(t - s for s, t in busy) / 1e9
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = sorted(((t - s, s) for s, t in zip(edges[0::2], edges[1::2])
                   if t > s), reverse=True)[:10]
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy_s,
            "kernels": kernels,
            "gaps": [[_span_at(host, s), dt / 1e9] for dt, s in gaps]}


def _span_at(host, t) -> str:
    """The innermost (latest-starting) harness span open at ``t``."""
    best = None
    for s, e, name in host:
        if s <= t < e and (best is None or s > best[0]):
            best = (s, name)
    return best[1][len(PREFIX):] if best else "outside any span"


def kernel_seconds(red: dict, *needles: str):
    """``(launches, seconds)`` of the activities whose name holds any of
    ``needles``; None when there is none."""
    n, s = 0, 0.0
    for name, (count, secs) in red["kernels"].items():
        if any(x in name for x in needles):
            n += count
            s += secs
    return (n, s) if n else None


def breakdown(red: dict) -> dict:
    """The ten device activities that took most time and the ten longest
    idle gaps, as the result line carries them."""
    ops = sorted(([name, secs] for name, (_n, secs) in red["kernels"].items()),
                 key=lambda r: -r[1])[:10]
    return {"device_ops": ops, "idle_gaps": red["gaps"][:10]}


def idle_pct(red):
    """Share of the window in which nothing ran on the card, in %; None
    without a trace or with no device activity in it."""
    if not red or red["window_s"] <= 0 or red["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - red["busy_s"] / red["window_s"])
