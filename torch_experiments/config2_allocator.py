#!/usr/bin/env python3
"""What the caching allocator is worth to the config-2 main path: the
16-batch loop (1M × 4096 → 256, lazy split2, rows on the card, 65,536-row
batches) timed three times in one process, with the allocator's segments
taken from the driver counted around each loop; then, with the cache
emptied, the same rows as one ``transform`` of a ``dispatch_steps=16``
model (the multistep chain, one output) twice.

Run it twice from the repository root on a machine with a card, the
second time with torch's caching allocator off (every tensor then a
``cudaMalloc`` and every free a ``cudaFree``, which waits for the card)::

    python3 torch_experiments/config2_allocator.py
    PYTORCH_NO_CUDA_MEMORY_CACHING=1 python3 torch_experiments/config2_allocator.py

Prints one JSON line with the card's name and power limit beside the
milliseconds (CUDA events, first issue to the last kernel's end) and the
host's issue milliseconds of each loop.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N_ROWS, N_FEATURES, N_COMPONENTS, BATCH = 1_000_000, 4096, 256, 65_536


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("config2_allocator: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import randomprojection_tpu_torch as rpt

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    g = torch.Generator(device="cuda").manual_seed(0)
    X = torch.empty((N_ROWS, N_FEATURES), device="cuda").normal_(generator=g)
    est = rpt.SparseRandomProjection(
        N_COMPONENTS, density=1 / 3, random_state=0,
        backend_options={"materialization": "lazy"}).fit(X)
    bounds = [(lo, min(lo + BATCH, N_ROWS)) for lo in range(0, N_ROWS, BATCH)]
    est.transform(X[:BATCH])  # builds and loads stay out of the loops
    chain = rpt.SparseRandomProjection(
        N_COMPONENTS, density=1 / 3, random_state=0,
        backend_options={"materialization": "lazy", "dispatch_steps": 16},
    ).fit(X)

    def timed(run):
        torch.cuda.synchronize()
        segs = torch.cuda.memory_stats().get("segment.all.allocated", 0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = run()
        end.record()
        issue = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        del out
        return {"ms": start.elapsed_time(end), "host_issue_ms": issue,
                "new_segments": torch.cuda.memory_stats().get(
                    "segment.all.allocated", 0) - segs}

    loops = [timed(lambda: [est.transform(X[lo:hi]) for lo, hi in bounds])
             for _ in range(3)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    chained = [timed(lambda: chain.transform(X)) for _ in range(2)]
    print(json.dumps({
        "config2_allocator": loops,
        "chain_16_steps": chained,
        "caching_allocator": os.environ.get("PYTORCH_NO_CUDA_MEMORY_CACHING",
                                            "0") != "1",
        "shape": f"{N_ROWS}x{N_FEATURES}->{N_COMPONENTS} in {len(bounds)} "
                 f"batches of {BATCH}",
        "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
