#!/usr/bin/env python3
"""Where the LSH cell's slow calls lose their time.

Sets the cell ``config4_lsh_probes16`` up as the benchmark does
(``rpbench/drivers/lsh_bulk.py``: the planted 125M-code shard made on the
card, one ``LSHSimHashIndex``, every graph the pool needs captured), then
sends the cell's calls back to back in windows of ``--seconds``, each
window with ``--ahead`` tiles queued behind the running one
(``ann.lsh._TILES_AHEAD``), in turns.  For every call it keeps: the wall;
the host's time in the tiles' sizing and dispatch (``_lsh_tile_entry``)
and in its waits for the card (``_HostFetch.result``), their sums and the
longest single one; the calling thread's CPU time; the process's
voluntary and involuntary context switches and page faults
(``getrusage``); and the interpreter's collections.  A call whose excess
over the median lies in the waits was the card's; one whose excess lies
in the host's own work, with its CPU time short of its wall, was the
host's thread off the CPU.  ``nvidia-smi`` samples the card's clocks and
power every 100 ms beside it.

Run from the repository root on a machine with a card::

    python3 torch_experiments/lsh_slow_calls.py [--seconds 51]
        [--ahead 3,8] [--turns 2] [--seed n]

Writes every call's record to ``chiprun_out/lsh_slow_calls.json`` and
prints a summary line a window, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import gc
import json
import resource
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True)
    return out.stdout.strip()


class _Call:
    """The host's parts of one call."""

    def __init__(self):
        self.dispatch = []
        self.wait = []
        self.gc = [0, 0, 0]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--ahead", default="3,8")
    p.add_argument("--turns", type=int, default=2)
    p.add_argument("--seed", type=int, default=2147700001)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from randomprojection_tpu_torch.ann import lsh
    from rpbench import harness
    from rpbench.drivers import lsh_bulk

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,clocks.mem,"
         "power.draw,temperature.gpu,clocks_throttle_reasons.active",
         "--format=csv,noheader", "-lms", "100"],
        stdout=open(out_dir / "lsh_slow_calls_smi.csv", "w"),
        stderr=subprocess.DEVNULL)
    cur = [None]

    entry = lsh.LSHSimHashIndex._lsh_tile_entry

    def timed_entry(self, *a, **kw):
        t = time.perf_counter()
        try:
            return entry(self, *a, **kw)
        finally:
            if cur[0] is not None:
                cur[0].dispatch.append(time.perf_counter() - t)

    class TimedFetch(lsh._HostFetch):
        __slots__ = ()

        def result(self, out_dtype):
            t = time.perf_counter()
            try:
                return super().result(out_dtype)
            finally:
                if cur[0] is not None:
                    cur[0].wait.append(time.perf_counter() - t)

    def on_gc(phase, info):
        if phase == "start" and cur[0] is not None:
            cur[0].gc[info["generation"]] += 1

    lsh.LSHSimHashIndex._lsh_tile_entry = timed_entry
    lsh._HostFetch = TimedFetch
    gc.callbacks.append(on_gc)

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    ctx = harness.Context("config4_lsh_probes16", args.seed, device, False)
    drv = lsh_bulk.Driver(ctx)
    drv.setup()
    gc.collect()
    torch.cuda.synchronize()
    c, t = ctx.config, ctx.traffic
    setup_s = time.perf_counter() - t_start
    windows = []
    calls = 0
    aheads = [int(a) for a in args.ahead.split(",")]
    for turn in range(args.turns):
        for ahead in aheads:
            lsh._TILES_AHEAD = ahead
            recs = []
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < args.seconds:
                rec = cur[0] = _Call()
                ru0 = resource.getrusage(resource.RUSAGE_SELF)
                c0, w0 = time.thread_time(), time.perf_counter()
                drv.index.query_topk(drv._call(calls), c["m"],
                                     tile=c["rerank_tile"],
                                     probes=c["probes"])
                w1, c1 = time.perf_counter(), time.thread_time()
                ru1 = resource.getrusage(resource.RUSAGE_SELF)
                cur[0] = None
                recs.append({
                    "wall_ms": (w1 - w0) * 1e3,
                    "cpu_ms": (c1 - c0) * 1e3,
                    "dispatch_ms": sum(rec.dispatch) * 1e3,
                    "dispatch_max_ms": max(rec.dispatch) * 1e3,
                    "wait_ms": sum(rec.wait) * 1e3,
                    "wait_max_ms": max(rec.wait) * 1e3,
                    "nvcsw": ru1.ru_nvcsw - ru0.ru_nvcsw,
                    "nivcsw": ru1.ru_nivcsw - ru0.ru_nivcsw,
                    "minflt": ru1.ru_minflt - ru0.ru_minflt,
                    "majflt": ru1.ru_majflt - ru0.ru_majflt,
                    "gc": rec.gc, "end_s": w1 - t_start})
                calls += 1
            elapsed = time.perf_counter() - t0
            walls = np.array([r["wall_ms"] for r in recs])
            med = float(np.median(walls))
            slow = [r for r in recs if r["wall_ms"] > 1.05 * med]
            fields = ("wall_ms", "cpu_ms", "dispatch_ms", "wait_ms",
                      "dispatch_max_ms", "wait_max_ms", "nivcsw", "nvcsw",
                      "minflt")

            def mean(rows, f):
                return round(statistics.fmean(r[f] for r in rows), 3) \
                    if rows else None

            normal = [r for r in recs if r["wall_ms"] <= 1.05 * med]
            summary = {
                "turn": turn, "ahead": ahead, "calls": len(recs),
                "queries_per_s": len(recs) * t["call_queries"] / elapsed,
                "wall_ms_median": med, "wall_ms_max": float(walls.max()),
                "slow_calls": len(slow),
                "normal_mean": {f: mean(normal, f) for f in fields},
                "slow_mean": {f: mean(slow, f) for f in fields},
                "slow_gc": [sum(r["gc"][g] for r in slow) for g in range(3)],
                "slow": sorted(slow, key=lambda r: -r["wall_ms"])[:8]}
            windows.append({"summary": summary, "calls": recs})
            print(json.dumps({k: v for k, v in summary.items()
                              if k != "slow"}), flush=True)
    smi.terminate()
    drv.release()
    drv.close()
    line = {"card": _card(), "seed": args.seed, "setup_s": setup_s,
            "windows": [w["summary"] for w in windows]}
    (out_dir / "lsh_slow_calls.json").write_text(json.dumps(
        {**line, "calls": [w["calls"] for w in windows]}))
    print(json.dumps(line))


if __name__ == "__main__":
    main()
