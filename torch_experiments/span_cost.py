#!/usr/bin/env python3
"""What tracing costs a benchmark cell: its end-to-end metric in windows
with no profiler and in windows under ``torch.profiler`` (the harness's
traced window), in turns in one process after one set-up, with the
program's spans recorded a second.

Imports ``rpbench`` and the port from ``--root`` (a checkout), so two
versions of the program compare on one card in one call::

    python3 torch_experiments/span_cost.py --cell config4_open_loop \\
        --seconds 8 --turns 3 --root .

Run from the repository root on a machine with a card.  Prints one JSON
line: the card's name and power limit, then each window's metric, the
traced windows' spans a second and each span's count and mean ms (null
where the program keeps no span store), the interpreter's collections
and the card's idle share.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
from pathlib import Path


def _card() -> dict:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
    except FileNotFoundError:
        return {"card": None}
    return {"card": out.stdout.strip()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cell", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--turns", type=int, default=2)
    p.add_argument("--seed", type=int, default=2**31 + 401)
    p.add_argument("--root", default=".")
    p.add_argument("--device", default="cuda",
                   help="'cpu' rehearses the script (with --overrides)")
    p.add_argument("--overrides", default="{}",
                   help="JSON of the cell's config/traffic overrides")
    args = p.parse_args(argv)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    import importlib

    import torch

    from rpbench import harness
    from rpbench import trace as tr
    from randomprojection_tpu_torch.utils import observability as obs

    device = torch.device(args.device, 0 if args.device == "cuda" else None)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    ctx = harness.Context(args.cell, args.seed, device, False,
                          json.loads(args.overrides))
    ctx.seconds = args.seconds
    mod = importlib.import_module(
        f"rpbench.drivers.{ctx.workload['driver']}")
    drv = mod.Driver(ctx)
    store = hasattr(obs, "recorded_spans")
    rows = []
    try:
        drv.setup()
        gc.collect()
        harness._sync(device)
        for turn in range(2 * args.turns):
            traced = turn % 2 == 1
            if not traced:
                e2e = drv.window(args.seconds)
                harness._sync(device)
                rows.append({"traced": False, **e2e})
                continue
            if store:
                obs.clear_spans()
            with tr.profiled() as held:
                with tr.span("window"):
                    e2e = drv.window(args.seconds)
                    harness._sync(device)
            red = tr.reduce(held.prof)
            row = {"traced": True, **e2e, "window_s": red["window_s"],
                   "idle_pct": tr.idle_pct(red), "spans_per_s": None}
            if store:
                spans = obs.recorded_spans()
                row["spans_per_s"] = len(spans) / red["window_s"]
                by_name: dict = {}
                for name, _tid, t0, t1 in spans:
                    by_name.setdefault(name, []).append((t1 - t0) / 1e6)
                row["mean_ms"] = {name: [len(v), sum(v) / len(v)]
                                  for name, v in by_name.items()}
                row["dropped"] = obs.dropped_spans()
                row["gc"] = {g: [c, ns / 1e9] for g, (c, ns)
                             in obs.gc_collections().items()}
            rows.append(row)
            del held
            gc.collect()
        drv.release()
    finally:
        drv.close()
    print(json.dumps({"cell": args.cell, "root": root, "store": store,
                      **_card(), "seconds": args.seconds,
                      "windows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
