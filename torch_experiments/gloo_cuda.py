#!/usr/bin/env python3
"""Does the installed gloo take CUDA tensors?  Two ranks on one card join a
gloo job over localhost and ``all_reduce`` a CUDA tensor of each dtype the
scale-out reduces (float32), at a small and at the two-process job's size
(16,384 x 512).  Prints one JSON line: the answer, the sum's bits against
the plain sum, and the all_reduce's wall.  The port's sharded
reduction hands CUDA partials to gloo as they are on the strength of its
answer (PERF.md, PR 14).

    python torch_experiments/gloo_cuda.py
"""

import json
import os
import socket
import subprocess
import sys
import time


def rank(r: int, port: int) -> None:
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=r)
    out = {"rank": r}
    for rows in (8, 16_384):
        g = torch.Generator(device="cuda").manual_seed(rows + r)
        t = torch.randn((rows, 512), device="cuda", generator=g)
        other = torch.randn((rows, 512), device="cuda",
                            generator=torch.Generator(device="cuda")
                            .manual_seed(rows + 1 - r))
        want = t + other
        try:
            dist.all_reduce(t)  # warm
            t = torch.randn((rows, 512), device="cuda",
                            generator=torch.Generator(device="cuda")
                            .manual_seed(rows + r))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist.all_reduce(t)
            torch.cuda.synchronize()
            out[str(rows)] = {"takes_cuda": True,
                              "device": str(t.device),
                              "wall_ms": (time.perf_counter() - t0) * 1e3,
                              "equal_plain_sum": bool(torch.equal(t, want))}
        except Exception as e:  # the answer this experiment looks for
            out[str(rows)] = {"takes_cuda": False, "error": repr(e)[:300]}
    print(json.dumps(out), flush=True)
    dist.destroy_process_group()


def main() -> int:
    if len(sys.argv) == 3:
        rank(int(sys.argv[1]), int(sys.argv[2]))
        return 0
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env={**os.environ})
             for r in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    ranks = []
    for p, (so, se) in zip(procs, outs):
        if p.returncode:
            print(se[-3000:], file=sys.stderr)
            return 1
        ranks.append(json.loads(so.strip().splitlines()[-1]))
    import torch

    print(json.dumps({"gloo_cuda": ranks, "card": card,
                      "torch": torch.__version__, "cuda": torch.version.cuda}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
