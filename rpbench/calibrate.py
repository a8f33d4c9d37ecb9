"""Readings that set the benchmark's limits and rates, on the card.

    python rpbench/calibrate.py readings --cell <cell> --seeds 1,2,3 \\
        --seconds 2 [--control 3]
    python rpbench/calibrate.py sweep --cell <open-loop cell> --seed 1 \\
        --seconds 5 --rates 50,100,200
    python rpbench/calibrate.py stages --cell config2_streamed --seed 1 \
        --seconds 15 --windows 2

``readings`` runs the cell's set-up, a short window at its own load and
its check for each seed in one process, and prints one JSON line a seed
with each number compared; on the first ``--control`` seeds it also
prints the control's numbers (the reference in a lower precision, or with
a broken guarantee, in the program's place).  ``sweep`` sets up an
open-loop cell once and runs its window at each rate, printing the tail,
the failures and the submitter's lag a rate.  ``stages`` sets up a
streamed cell once and runs ``--windows`` windows with the pipeline's
``StreamStats`` on (as in a traced run, without the profiler), printing
the rate and each stage's summed wall a window.  None is part of a
benchmark run.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _driver(cell: str, seed: int, seconds: float, stats: bool = False):
    import torch

    from rpbench import harness

    dev = torch.device("cuda", 0)
    ctx = harness.Context(cell, seed, dev, stats)
    ctx.seconds = seconds
    mod = importlib.import_module(f"rpbench.drivers.{ctx.workload['driver']}")
    return ctx, mod.Driver(ctx)


def readings(args) -> None:
    import torch

    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        ctx, drv = _driver(args.cell, seed, args.seconds)
        t0 = time.perf_counter()
        try:
            drv.setup()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            e2e = drv.window(args.seconds)
            drv.release()
            t2 = time.perf_counter()
            program = drv.check()
            t3 = time.perf_counter()
            control = drv.check(control=True) if n < args.control else None
        finally:
            drv.close()
            torch.cuda.empty_cache()
        print(json.dumps({
            "cell": args.cell, "seed": seed, "e2e": e2e,
            "attempted": drv.attempted, "failed": drv.failed,
            "program": {k: v for k, v, _l in program},
            "control": control and {k: v for k, v, _l in control},
            "setup_s": t1 - t0, "check_s": t3 - t2}), flush=True)


def sweep(args) -> None:
    import torch

    ctx, drv = _driver(args.cell, args.seed, args.seconds)
    try:
        drv.setup()
        torch.cuda.synchronize()
        for rate in (float(r) for r in args.rates.split(",")):
            drv.plan(rate, args.seconds)
            out = drv.window(args.seconds)
            print(json.dumps({
                "rate_rps": rate, "requests": drv.attempted,
                "failed": drv.failed, **out,
                "p50_ms": ctx.layer["p50_latency_ms"],
                "lag_s": ctx.layer["submit_lag_s"],
                "rows_per_batch": ctx.layer["serve_rows_per_batch"]}),
                flush=True)
    finally:
        drv.close()


def stages(args) -> None:
    import torch

    ctx, drv = _driver(args.cell, args.seed, args.seconds, stats=True)
    try:
        t0 = time.perf_counter()
        drv.setup()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        for w in range(args.windows):
            out = drv.window(args.seconds)
            st = ctx.layer["stream_stats"]
            print(json.dumps({
                "seed": args.seed, "window": w, "setup_s": setup_s, **out,
                "wall_s": ctx.layer["stream_wall_s"],
                "bytes": ctx.layer["stream_bytes"],
                "stage_wall_s": st.stage_wall}), flush=True)
    finally:
        drv.close()


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("readings")
    r.add_argument("--cell", required=True)
    r.add_argument("--seeds", required=True)
    r.add_argument("--seconds", type=float, default=2.0)
    r.add_argument("--control", type=int, default=0)
    s = sub.add_parser("sweep")
    s.add_argument("--cell", required=True)
    s.add_argument("--seed", type=int, required=True)
    s.add_argument("--seconds", type=float, default=5.0)
    s.add_argument("--rates", required=True)
    g = sub.add_parser("stages")
    g.add_argument("--cell", required=True)
    g.add_argument("--seed", type=int, required=True)
    g.add_argument("--seconds", type=float, default=15.0)
    g.add_argument("--windows", type=int, default=2)
    args = p.parse_args()
    {"readings": readings, "sweep": sweep, "stages": stages}[args.cmd](args)


if __name__ == "__main__":
    main()
