#!/usr/bin/env python3
"""How many of a profiled prefetch turn's copies and projection launches
``torch.profiler`` reports.

The config-2 model (4096 → 256, density 1/3, lazy split2) streams 8
pinned 65,536-row batches through ``PrefetchSource(depth=2,
prepare=est.prepare_batch)`` under the profiler, as ``chip_smoke.py``'s
profiled turn does, several times in one process and in two ways: ``settle``
(a reduction and half a second of sleep inside the profiler before the
turn) and ``settle+sync`` (the same, and ``torch.cuda.synchronize()``
before the profiler stops).  For each turn it prints every host-to-device
copy the profiler saw (duration, stream), the projection launches it saw,
the host's ``cudaMemcpyAsync`` calls it recorded, and the same counts read
from the exported Chrome trace, so a missing event can be told apart from
one filtered out.

Run from the repository root on a machine with a card::

    python3 torch_experiments/stream_profile_events.py

Prints one JSON line per turn and the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
N_FEATURES, N_COMPONENTS, BATCH, BATCHES, POOL = 4096, 256, 65_536, 8, 3
TURNS = 3


def _turn(torch, est, streaming, pool, way: str) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def read(lo, hi):
        return pool[(lo // BATCH) % POOL][: hi - lo]

    src = streaming.CallableSource(read, BATCHES * BATCH, N_FEATURES,
                                   np.float32, batch_rows=BATCH)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.ones(1 << 20, device="cuda").sum().item()
        time.sleep(0.5)
        for _ in est.transform_stream(streaming.PrefetchSource(
                src, depth=2, prepare=est.prepare_batch)):
            pass
        if way == "settle+sync":
            torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    dev = [e for e in events if e.device_type() == DeviceType.CUDA]
    copies = [{"name": e.name(), "ms": e.duration_ns() / 1e6,
               "stream": e.device_resource_id()}
              for e in dev if "HtoD" in e.name()]
    k1 = [e for e in dev if "fused_project_kernel" in e.name()]
    api = [e for e in events if e.device_type() != DeviceType.CUDA
           and e.name() == "cudaMemcpyAsync"]
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())["traceEvents"]
    chrome_htod = [e for e in trace if "HtoD" in str(e.get("name", ""))]
    chrome_k1 = [e for e in trace
                 if "fused_project_kernel" in str(e.get("name", ""))
                 and e.get("cat") == "kernel"]
    return {"way": way, "copies_seen": len(copies),
            "big_copies_seen": sum(c["ms"] > 1.0 for c in copies),
            "copies": copies, "k1_seen": len(k1),
            "memcpy_api_calls": len(api),
            "memcpy_api_threads": sorted({e.start_thread_id() for e in api}),
            "chrome_htod": len(chrome_htod), "chrome_k1": len(chrome_k1)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("stream_profile_events: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import randomprojection_tpu_torch as rpt
    from randomprojection_tpu_torch import streaming

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    template = np.random.default_rng(0).standard_normal(
        (BATCH, N_FEATURES), dtype=np.float32)
    est = rpt.SparseRandomProjection(
        N_COMPONENTS, density=1 / 3, random_state=0,
        backend_options={"materialization": "lazy"},
    ).fit(template)
    est.transform(template)  # the kernels' build and load
    pool = [torch.from_numpy(np.roll(template, -i, axis=0)).pin_memory()
            for i in range(POOL)]
    for _ in range(TURNS):
        for way in ("settle", "settle+sync"):
            print(json.dumps(_turn(torch, est, streaming, pool, way)),
                  flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
