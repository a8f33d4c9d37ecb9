#!/usr/bin/env python3
"""Where the card idles in the open-loop cell, by the program's spans.

Sets up the benchmark's ``config4_open_loop`` cell (125M codes in one
``SimHashIndex``, ``TopKServer``, Poisson one-query requests at the
cell's rate), runs one window under ``observability.profile_trace``,
and reads the exported Chrome trace: the card's activities (kernels,
copies, fills) merged into busy stretches, and the ten longest idle gaps
inside the window.  Each gap is listed with the spans open on each thread
when it began (the harness's from the trace, the program's from its span
store, outermost first), the program's spans that overlap it a thread,
and every ``rp:gc/gen2`` collection that overlaps it.  Run from the
repository root on a machine with a card::

    python3 torch_experiments/open_loop_gaps.py --seconds 5

Writes the full listing to ``--out`` (``open_loop_gaps.json``) and prints
one compact JSON line (the card's name and power limit first).
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    except FileNotFoundError:
        return None


def _events(path: str):
    """``(name, cat, tid, start_ns, end_ns)`` of every complete event, on
    the Unix clock (the trace's ``ts`` is µs after ``baseTimeNanoseconds``)."""
    with open(path) as f:
        d = json.load(f)
    base = int(d.get("baseTimeNanoseconds", 0))
    out = []
    for e in d["traceEvents"]:
        if e.get("ph") != "X":
            continue
        s = base + round(float(e["ts"]) * 1e3)
        out.append((e.get("name", ""), e.get("cat", ""), e.get("tid"), s,
                    s + round(float(e.get("dur", 0)) * 1e3)))
    return out


def _merge(ivs):
    out = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--seed", type=int, default=2**31 + 577)
    p.add_argument("--device", default="cuda",
                   help="'cpu' rehearses the script (with --overrides)")
    p.add_argument("--overrides", default="{}")
    p.add_argument("--out", default="open_loop_gaps.json")
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(".").resolve()))
    import torch

    from rpbench import harness
    from rpbench import trace as tr
    from randomprojection_tpu_torch.utils import observability as obs

    device = torch.device(args.device, 0 if args.device == "cuda" else None)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    ctx = harness.Context("config4_open_loop", args.seed, device, True,
                          json.loads(args.overrides))
    ctx.seconds = args.seconds
    drv = importlib.import_module(
        f"rpbench.drivers.{ctx.workload['driver']}").Driver(ctx)
    tmp = tempfile.mkdtemp(prefix="rp-gaps-")
    try:
        drv.setup()
        gc.collect()
        harness._sync(device)
        obs.clear_spans()
        with obs.profile_trace(tmp):
            with tr.span("window"):
                e2e = drv.window(args.seconds)
                harness._sync(device)
        names = {t.native_id: t.name for t in threading.enumerate()}
        spans = obs.recorded_spans()
        collections = obs.gc_collections()
        drv.release()
    finally:
        drv.close()
    events = _events(os.path.join(tmp, "trace.json"))
    win = [e for e in events if e[0] == "rpbench:window"]
    w0, w1 = win[0][3], win[0][4]
    busy = _merge((max(s, w0), min(t, w1)) for n, c, _t, s, t in events
                  if c in DEVICE_CATS and min(t, w1) > max(s, w0))
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = sorted(((t - s, s, t) for s, t in zip(edges[0::2], edges[1::2])
                   if t > s), reverse=True)[:10]
    harness_spans = [(n, tid, s, t) for n, c, tid, s, t in events
                     if c == "user_annotation" and n.startswith("rpbench:")]
    # the store's clock against the trace's: each program span's echo
    echo = {}
    for n, c, tid, s, t in events:
        if c == "user_annotation" and n.startswith("rp:"):
            echo.setdefault(n, []).append(s)
    diffs = []
    for n, _tid, s, _t in spans:
        if echo.get(n):
            diffs.append(min(abs(s - x) for x in echo[n][:2000]))
        if len(diffs) >= 200:
            break
    diffs.sort()

    def thread(tid):
        return names.get(tid, str(tid))

    # a request's queue wait is no thread's activity: counted apart
    waits = [(a, b) for n, _tid, a, b in spans if n == "rp:serve/queue_wait"]
    listing = []
    for dt, s, t in gaps:
        open_at = {}
        for n, tid, a, b in sorted(harness_spans + spans, key=lambda x: x[2]):
            if a <= s < b and n != "rp:serve/queue_wait":
                open_at.setdefault(thread(tid), []).append(n)
        for tid, name in names.items():
            if name == "rp-topk-server" and name not in open_at:
                open_at[name] = ["(between batches: collecting)"]
        overlap: dict = {}
        for n, tid, a, b in spans:
            if a < t and b > s and n != "rp:gc/gen2":
                row = overlap.setdefault(thread(tid), {})
                row[n] = row.get(n, 0) + 1
        gen2 = [{"thread": thread(tid), "ms": (b - a) / 1e6,
                 "overlap_ms": (min(b, t) - max(a, s)) / 1e6}
                for n, tid, a, b in spans
                if n == "rp:gc/gen2" and a < t and b > s]
        listing.append({"gap_ms": dt / 1e6, "at_s": (s - w0) / 1e9,
                        "open": open_at, "overlapping": overlap,
                        "requests_waiting": sum(a <= s < b for a, b in waits),
                        "gc_gen2": gen2})
    # the host's time a span name, and the batch's own part apart from
    # the index's call
    by_name: dict = {}
    for n, _tid, a, b in spans:
        by_name.setdefault(n, []).append((b - a) / 1e6)
    mean_ms = {n: [len(v), sum(v) / len(v)] for n, v in by_name.items()}
    gen2_all = [{"at_s": (a - w0) / 1e9, "ms": (b - a) / 1e6,
                 "thread": thread(tid)}
                for n, tid, a, b in spans if n == "rp:gc/gen2"]
    out = {"card": _card(), "seconds": args.seconds, "seed": args.seed,
           **e2e, "window_s": (w1 - w0) / 1e9,
           "busy_s": sum(b - a for a, b in busy) / 1e9,
           "spans": len(spans), "dropped": obs.dropped_spans(),
           "gc": {g: [c, ns / 1e9] for g, (c, ns) in collections.items()},
           "gc_gen2": gen2_all,
           "clock_diff_us": {"n": len(diffs),
                             "median": diffs[len(diffs) // 2] / 1e3
                             if diffs else None,
                             "max": diffs[-1] / 1e3 if diffs else None},
           "mean_ms": mean_ms, "gaps": listing}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    compact = {k: out[k] for k in ("card", "p99_latency_ms", "window_s",
                                   "busy_s", "spans", "gc", "gc_gen2",
                                   "clock_diff_us", "mean_ms")}
    compact["gaps"] = [
        [round(g["gap_ms"], 3), round(g["at_s"], 3),
         {k: v[-1] for k, v in g["open"].items()}, g["requests_waiting"],
         [round(x["ms"], 1) for x in g["gc_gen2"]]] for g in listing]
    print(json.dumps(compact), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
