#!/usr/bin/env python3
"""The multi-probe LSH tier against the exact index over one card's
125M-code shard: build, recall and q/s a probe count, and where a tile's
time goes.

Makes the LSH cell's planted codes on the card (``rpbench/data.py``, the
cell's seed streams), builds one ``LSHSimHashIndex`` over them (8 bands ×
20 bits; the bucket index built on the card, timed), then for each probe
count sends calls of 16,384 planted queries in tiles of 64 (m = 10):
recall@10 of 512 of them against the exact top-10 over the whole shard
(``rpbench/reference/hamming_topk.py``), the tiles served exact, the
candidate fraction and q/s over ``--calls`` calls after a warm call.  The
exact index over the same codes (``probes=0``) is timed at the LSH tile
(64) and at the bulk cell's tile (2,048).  Last, one call at 16 probes
under ``torch.profiler``: device time by kernel, which shows whether the
profiler lists the kernels of a graph replay.  And a tile's parts at 16
probes, each over a call's 256 tiles: the host's sizing of a tile on the
host indptr, its dispatch (staging, the replay, the copies started)
queued with no wait, its finish once the card is done, and the card's
time a tile alone (CUDA events around back-to-back replays of the
tile's graph with its input copies).

Run from the repository root on a machine with a card and ``nvcc``::

    python3 torch_experiments/lsh_shard.py [--codes N] [--probes 1,4,16]
        [--calls n]

Prints one JSON line, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
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


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--codes", type=int, default=125_000_000)
    p.add_argument("--probes", default="1,4,8,16,32")
    p.add_argument("--calls", type=int, default=4)
    p.add_argument("--seed", type=int, default=2147600000)
    args = p.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from randomprojection_tpu_torch.ann import LSHSimHashIndex
    from randomprojection_tpu_torch.utils import telemetry
    from rpbench import data
    from rpbench.reference import hamming_topk

    dev = torch.device("cuda")
    out = {"card": _card(), "codes": args.codes}
    g = data.generator(args.seed, dev, 1)
    codes = data.planted_codes(args.codes, 32, 16, 6, g, device=dev)
    q = data.planted_queries(codes, (args.calls + 1) * 16384, 6,
                             data.generator(args.seed, dev, 2)).cpu().numpy()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    idx = LSHSimHashIndex(codes, bands=8, band_bits=20, probes=16)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    out["build_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    check = torch.from_numpy(q[:512]).to(dev)
    _td, true_i = hamming_topk.topk(check, codes, 10)
    true_i = true_i.cpu().numpy()
    del codes
    reg = telemetry.registry()
    calls = [q[(c + 1) * 16384:(c + 2) * 16384] for c in range(args.calls)]

    def rate(**kw):
        idx.query_topk(q[:16384], 10, **kw)  # warm: captures, plans
        torch.cuda.synchronize()
        t = time.perf_counter()
        for c in calls:
            idx.query_topk(c, 10, **kw)
        return args.calls * 16384 / (time.perf_counter() - t)

    curve = []
    for probes in [int(x) for x in args.probes.split(",")]:
        got = idx.query_topk(q[:512], 10, tile=64, probes=probes)[1]
        hits = sum(np.intersect1d(a, b).size for a, b in zip(got, true_i))
        f0, c0, d0 = (reg.counter("index.lsh.fallbacks"),
                      reg.counter("index.lsh.candidates"),
                      reg.counter("index.lsh.dispatches"))
        qps = rate(tile=64, probes=probes)
        tiles = reg.counter("index.lsh.dispatches") - d0
        curve.append({
            "probes": probes, "recall_at_10": hits / true_i.size,
            "queries_per_s": qps,
            "fallback_tiles": reg.counter("index.lsh.fallbacks") - f0,
            "candidate_fraction": ((reg.counter("index.lsh.candidates") - c0)
                                   / max(tiles, 1) / idx.n_live)})
        print(json.dumps(curve[-1]), file=sys.stderr, flush=True)
    out["lsh"] = curve
    out["exact_qps"] = {str(t): rate(tile=t, probes=0) for t in (64, 2048)}

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        idx.query_topk(calls[0], 10, tile=64, probes=16)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    # a kernel's own device time, in ms over the call (kernels and copies
    # are device events; host ops carry only their children's)
    rows = sorted(([e.key, e.count, e.self_device_time_total / 1e3]
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0), key=lambda r: -r[2])
    out["profiled_call"] = {"wall_ms": wall * 1e3, "tiles": 256,
                            "device_ms_by_kernel": rows[:60]}
    out["tile_parts_ms"] = _tile_parts(idx, calls[0])
    print(json.dumps(out))


def _tile_parts(idx, call, m=10, probes=16, tile=64):
    import torch

    masks = idx._probe_masks(probes)
    tiles = [call[lo:lo + tile] for lo in range(0, call.shape[0], tile)]
    n = len(tiles)
    idx.query_topk(call, m, tile=tile, probes=probes)  # every graph captured
    torch.cuda.synchronize()
    t = time.perf_counter()
    for a in tiles:
        idx._lsh_device_cap(a, masks, m)
    size = time.perf_counter() - t
    t = time.perf_counter()
    sent = [idx._lsh_device_dispatch_tile(a, m, masks, probes, tile)
            for a in tiles]
    dispatch = time.perf_counter() - t
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _kind, payload in sent:
        idx._lsh_finish_device_tile(payload, m)
    finish = time.perf_counter() - t
    entry = list(idx._lsh_graphs._graphs.values())[-1]  # the last used
    q = idx._staged(tiles[0])
    mdev, act = idx._lsh_device_masks(masks), idx._lsh_device_ones(tile)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(n):
        entry.replay(q, mdev, act)
    ev[1].record()
    torch.cuda.synchronize()
    out = {"size": 1e3 * size / n, "dispatch_with_size": 1e3 * dispatch / n,
           "finish": 1e3 * finish / n,
           "card_replay": ev[0].elapsed_time(ev[1]) / n}
    # the host's share of a dispatch, piece by piece (ms a tile, the card
    # drained every 32 tiles so that no launch waits for a full queue)
    from randomprojection_tpu_torch.ops.staging import HostFetch

    def host_ms(fn):
        total = 0.0
        for k in range(n):
            if k % 32 == 0:
                torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            total += time.perf_counter() - t
        torch.cuda.synchronize()
        return 1e3 * total / n

    outs = entry.outputs
    out["host_parts"] = {
        "stage": host_ms(lambda: idx._staged(tiles[0])),
        "graph_key": host_ms(lambda: idx._lsh_graph_key(tile, probes, 1 << 20,
                                                        m)),
        "input_copies": host_ms(lambda: [
            b.copy_(x, non_blocking=True)
            for b, x in zip(entry.inputs, (q, mdev, act))]),
        "graph_launch": host_ms(entry.graph.replay),
        "replay": host_ms(lambda: entry.replay(q, mdev, act)),
        "fetch3": host_ms(lambda: [HostFetch(o) for o in outs[:3]]),
        "fetch1": host_ms(lambda: HostFetch(outs[0])),
        "dispatch_no_size": host_ms(lambda: idx._lsh_device_composite(
            tiles[0], mdev, act, m, 1 << 20,
            fetch=lambda d, g, st, _c: (HostFetch(d), HostFetch(g),
                                        HostFetch(st)))),
    }
    return out


if __name__ == "__main__":
    main()
