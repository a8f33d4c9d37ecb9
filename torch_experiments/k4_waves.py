#!/usr/bin/env python3
"""K4's time against its row splits, and the warm-up one split costs.

Times ``rp_fused_topk`` (scan and merge) on the card with the plan's row
splits forced, at the shapes its callers run: 1, 48 and 256 queries over
one card's 125M-code shard (the open loop's batches; planted codes as
rpbench makes them), 2,048 queries over 2²⁰ codes (a chunk of the tiered
index), over 2²⁴ codes and over 1B planted codes (the bulk cell), and an
LSH tile of 64 queries × 2¹⁹ or 2²⁰ (the LSH cell's slots) candidate rows
with every third row dead (m = 10).  Each shape's times are fitted to the planner's model,

    T(s) = a · waves(s) · (ceil(n_tiles / s) + W) + c,
    waves(s) = ceil(q_tiles · s / SMs),

by least squares over (a, a·W, c): ``a`` the time of a tile step, ``W``
one split's warm-up of its lists in tile steps, ``c`` what a call costs
whatever its grid (the merge's launch included).  Counts past one wave
separate ``W`` from ``c``.  Every forced count must give the lists the
planned count gives, bit for bit.  At the planned count the scan's own
counters are read too: the keys a (query, split) list took, its merges,
and the share of (query row, tile) pairs at which the bound the query's
splits share was below the row's own threshold.  Then the merge alone at
a few (queries, splits).

Run from the repository root on a machine with a card and ``nvcc``::

    python3 torch_experiments/k4_waves.py [--shapes a,b] [--turns n]
        [--root TREE]

``--turns n`` times each count n times, in turns (forward, then
backward), and keeps each count's median.  ``--root`` imports the port of
another tree (a parent's checkout) and times only its own plan at each
shape (its merge may not take the counts forced here).  Prints one JSON
line: the card's name and power limit, each shape's plan and times (ms a
call, CUDA events over repeated calls) and its fit, and the merge's times.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

SEED = 2**31 + 2003
# (name, queries, rows, m, corpus, forced split counts)
SHAPES = [
    ("open_1x125M", 1, 125_000_000, 16, "planted", [32, 66, 132, 264, 396, 528]),
    ("open_48x125M", 48, 125_000_000, 16, "planted", [32, 66, 132, 264, 396]),
    ("open_256x125M", 256, 125_000_000, 16, "planted", [16, 33, 66, 132, 198]),
    ("lsh_64x2^19", 64, 1 << 19, 10, "lsh", [8, 16, 32, 64, 132, 264, 396]),
    ("lsh_64x2^20", 64, 1 << 20, 10, "lsh", [16, 32, 64, 128, 264, 396]),
    ("tier_2048x2^20", 2048, 1 << 20, 16, "random", [2, 4, 8, 16, 33, 66]),
    ("serve_2048x2^24", 2048, 1 << 24, 16, "random", [4, 8, 16, 33, 66]),
    ("bulk_2048x1B", 2048, 10**9, 16, "planted", [8, 16, 33]),
]
MERGES = [(48, 32), (48, 132), (64, 132), (128, 257), (2048, 8), (2048, 33),
          (64, 4096)]


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def inputs(torch, nq, rows, corpus):
    from rpbench import data

    dev = torch.device("cuda")
    if corpus == "planted":
        codes = data.planted_codes(rows, 32, 16, 6,
                                   data.generator(SEED, dev, 1), device=dev)
        q = data.planted_queries(codes, nq, 6, data.generator(SEED, dev, 2))
        return q.contiguous(), codes, None
    g = data.generator(SEED, dev, 3)
    codes = torch.randint(0, 256, (rows, 32), generator=g, dtype=torch.uint8,
                          device=dev)
    q = torch.randint(0, 256, (nq, 32), generator=g, dtype=torch.uint8,
                      device=dev)
    dead = None
    if corpus == "lsh":
        dead = (torch.arange(rows, device=dev) % 3 == 0).to(torch.uint8)
    return q, codes, dead


def timed_ms(torch, fn, budget_ms=600.0) -> float:
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize()
    reps = int(max(2, min(50, budget_ms // max(e0.elapsed_time(e1), 1e-3))))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def fit(points, q_tiles, n_tiles, sms):
    """Least squares of T = a·(waves·tiles) + b·waves + c; W = b / a."""
    X = np.array([[w * t, w, 1.0] for w, t in
                  ((-(-q_tiles * s // sms), -(-n_tiles // s))
                   for s, _ in points)])
    y = np.array([ms for _s, ms in points])
    (a, b, c), *_ = np.linalg.lstsq(X, y, rcond=None)
    resid = y - X @ np.array([a, b, c])
    return {"a_ms_per_step": float(a), "W_steps": float(b / a),
            "c_ms": float(c), "max_resid_ms": float(np.abs(resid).max())}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", default="", help="names to run (default all)")
    ap.add_argument("--turns", type=int, default=1)
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="the tree whose port is timed")
    args = ap.parse_args()
    here = Path(__file__).resolve().parents[1]
    sys.path[:0] = [args.root, str(here)]  # the port from --root, rpbench here
    import torch

    from randomprojection_tpu_torch.ops import topk_kernels as tk

    own = Path(tk.__file__).resolve().parents[2] == here
    names = set(filter(None, args.shapes.split(",")))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {"card": card(), "torch": torch.__version__, "sms": sms,
           "root": args.root, "warmup_constant":
           getattr(tk, "SPLIT_WARMUP_TILES", None), "shapes": {}}
    for name, nq, rows, m, corpus, splits in SHAPES:
        if names and name not in names:
            continue
        q, codes, dead = inputs(torch, nq, rows, corpus)
        plan = tk.plan_fused(nq, rows, 32, m, sm_count=sms)
        q_tiles, n_tiles = -(-nq // plan.tq), -(-rows // 256)
        row = {"plan": list(plan), "q_tiles": q_tiles, "n_tiles": n_tiles,
               "planned_ms": timed_ms(torch, lambda: tk.rp_fused_topk(
                   q, codes, rows, m, dead=dead, plan=plan))}
        print(f"{name} planned splits={plan.splits} {row['planned_ms']:.4f} ms",
              file=sys.stderr, flush=True)
        if own:
            counts = torch.zeros(4, dtype=torch.int64, device="cuda")
            want = tk.rp_fused_topk(q, codes, rows, m, dead=dead, plan=plan,
                                    counts=counts)
            keys, merges, row_tiles, tight = counts.tolist()
            lists = nq * plan.splits
            row.update(keys_per_list=keys / lists,
                       merges_per_list=merges / lists,
                       bound_share_pct=100.0 * tight / max(row_tiles, 1))
            same, runs = True, {s: [] for s in splits}
            for turn in range(args.turns):
                for s in (splits if turn % 2 == 0 else splits[::-1]):
                    forced = plan._replace(splits=s,
                                           tiles_per_split=-(-n_tiles // s))
                    got = tk.rp_fused_topk(q, codes, rows, m, dead=dead,
                                           plan=forced)
                    same &= bool(torch.equal(got[0], want[0])
                                 and torch.equal(got[1], want[1]))
                    runs[s].append(timed_ms(torch, lambda: tk.rp_fused_topk(
                        q, codes, rows, m, dead=dead, plan=forced)))
                    print(f"{name} splits={s} {runs[s][-1]:.4f} ms",
                          file=sys.stderr, flush=True)
            points = [(s, float(np.median(runs[s]))) for s in splits]
            row.update(same_lists=same, ms=dict(points), runs=runs,
                       fit=fit(points, q_tiles, n_tiles, sms))
        out["shapes"][name] = row
        del q, codes, dead
        torch.cuda.empty_cache()
    if own and not names:
        lib, merges = tk._lib(), {}
        for nq, s in MERGES:
            part = torch.randint(0, 1 << 40, (nq, s, 16), dtype=torch.int64,
                                 device="cuda").sort(dim=2).values
            d = torch.empty((nq, 16), dtype=torch.int32, device="cuda")
            i = torch.empty_like(d)
            stream = torch.cuda.current_stream().cuda_stream
            merges[f"{nq}x{s}"] = timed_ms(torch, lambda: lib.rp_topk_merge(
                part.data_ptr(), nq, s, 16, 32, d.data_ptr(), i.data_ptr(),
                stream), budget_ms=50.0)
        out["merge_ms"] = merges
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
