#!/usr/bin/env python3
"""What holds the Hamming top-k kernel's tensor-core scan (K4) back: its
loads, its products, its compares or its survivors' path.

Builds ``randomprojection_tpu_torch/csrc/topk.cu`` as shipped and copies
with parts taken out (wrong results, the other parts' same instructions),
and times the scan (``rp_topk_scan`` alone, no merge) on the card, in turns
(shipped, copies, copies in reverse, shipped):

* ``no_loads``: the producer copies only the ring's first fill;
* ``no_select``: the consumers never enter the survivors' path (the
  register compares stay);
* ``no_epilogue``: the consumers skip the compares too (staging and
  products alone);
* ``no_epilogue_no_loads``, ``no_epilogue_no_products`` (no ``wgmma``:
  staging and barriers alone) and ``no_epilogue_no_complement`` (the
  producer writes no complements): ``no_epilogue`` with one more part out;

at the plan of each shape (``--shapes``, default all):

* ``serve_2048x2^24``: config 4's serving shape, 2,048 random queries ×
  2²⁴ random codes × 32 B, m = 16;
* ``tile_64x2^24``: one query tile over the same codes;
* ``lsh_64x2^20``: an LSH tile's re-rank, 64 queries × 2²⁰ candidate rows,
  every third row dead, m = 10;
* ``bulk_2048x1B``: a tile of the bulk cell, 2,048 planted queries × 1B
  planted codes (as rpbench makes them), m = 16.

``--root TREE`` builds and plans the kernel of another tree (a parent's
checkout), so one call times both sides on one card.  Run from the
repository root on a machine with a card and ``nvcc``::

    python3 torch_experiments/k4_parts.py [--root TREE] [--shapes a,b]

Prints one JSON line a shape as it goes, then one with the card's name and
power limit beside all the milliseconds.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SEED = 2**31 + 2203
REPS = 5
# (name, queries, rows, m, corpus)
SHAPES = [
    ("serve_2048x2^24", 2048, 1 << 24, 16, "random"),
    ("tile_64x2^24", 64, 1 << 24, 16, "random"),
    ("lsh_64x2^20", 64, 1 << 20, 10, "lsh"),
    ("bulk_2048x1B", 2048, 10**9, 16, "planted"),
]

# (a line of the kernel, the line that takes a part out); ``a.m < 0`` never
# holds, so the code stays and never runs
_WAIT = "        mbar_wait(empty(st), at.ph ^ 1);"
_COPY = "            cp_async_16(dst + 512 * i, src + i * 16 * a.n_bytes, 16u);"
_COMPLEMENT = ("          complement16(sc + kTileN * kStepBytes + 512 * i, "
               "sc + 512 * i);")
_PRODUCTS = "        if (any_live) {\n          const uint32_t sq"
_EPILOGUE = "      if (any_live) {  // selection"
_SELECT = ("        if (__any_sync(0xFFFFFFFFu, "
           "hit[0] | hit[1] | hit[2] | hit[3])) {")
NO_LOADS = [(_WAIT, "        const bool fill = it < a.stages;\n" + _WAIT),
            (_COPY, _COPY.replace("cp_async_16", "if (fill) cp_async_16"))]
NO_COMPLEMENT = [(_COMPLEMENT,
                  _COMPLEMENT.replace("complement16", "if (a.m < 0) complement16"))]
NO_PRODUCTS = [(_PRODUCTS, _PRODUCTS.replace("any_live", "any_live && a.m < 0"))]
NO_EPILOGUE = [(_EPILOGUE, "      if (any_live && a.m < 0) {")]
NO_SELECT = [(_SELECT, _SELECT.replace("if (", "if (a.m < 0 && ", 1))]


def _patched(text: str, pairs) -> str:
    for old, new in pairs:
        if text.count(old) != 1:
            raise SystemExit("k4_parts: the kernel changed; update the patch "
                             f"for {old!r}")
        text = text.replace(old, new)
    return text


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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE),
                    help="the tree whose kernel and planner are timed")
    ap.add_argument("--shapes", default="", help="names to run (default all)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k4_parts: no CUDA card", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root), str(HERE)]  # the port from --root, rpbench here
    from randomprojection_tpu_torch.ops import _build as build
    from randomprojection_tpu_torch.ops import topk_kernels as tk

    text = (build.CSRC / "topk.cu").read_text()
    # since the survivors' buffers the scan takes the buffer's size and a
    # pointer to its counters; since the shared bound, a pointer to the
    # queries' bound words
    buffered = "int buf, int splits" in text
    bounded = "void* counts, void* bound" in text
    sources = {
        "shipped": text,
        "no_loads": _patched(text, NO_LOADS),
        "no_select": _patched(text, NO_SELECT),
        "no_epilogue": _patched(text, NO_EPILOGUE),
        "no_epilogue_no_loads": _patched(text, NO_EPILOGUE + NO_LOADS),
        "no_epilogue_no_products": _patched(text, NO_EPILOGUE + NO_PRODUCTS),
        "no_epilogue_no_complement": _patched(text, NO_EPILOGUE + NO_COMPLEMENT),
    }
    tag = "change" if root == HERE else "other"
    out = HERE / "build" / "torch_experiments" / f"k4_parts_{tag}"
    out.mkdir(parents=True, exist_ok=True)

    def compile_(name):
        src = out / f"topk_{name}.cu"
        src.write_text(sources[name])
        lib = out / f"libk4_{name}.so"
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                        str(src)], check=True, capture_output=True, text=True)
        return name, ctypes.CDLL(str(lib))

    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(pool.map(compile_, sources))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for lib in libs.values():
        lib.rp_topk_scan.argtypes = (
            [p, p, p, i64, i64, i64, i64, i32, i32, i32, i32, i32, i32, i32,
             p, p] + [p] * bounded + [p] if buffered else
            [p, p, p, i64, i64, i64, i64, i32, i32, i32, i32, i32, i32, p, p])
        lib.rp_topk_scan.restype = i32

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream

    def timed(fn) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / REPS

    names = set(filter(None, args.shapes.split(",")))
    rows_out = []
    for name, nq, rows, m, corpus in SHAPES:
        if names and name not in names:
            continue
        q, codes, dead = inputs(torch, nq, rows, corpus)
        plan = tk.plan_fused(nq, rows, 32, m, sm_count=sms)
        part = torch.empty((nq, plan.splits, m), dtype=torch.int64, device="cuda")
        dead_p = None if dead is None else dead.data_ptr()
        # each launch starts from a fresh bound, as rp_fused_topk's does
        bound = torch.empty(nq, dtype=torch.int32, device="cuda")
        shared = (bound.data_ptr(),) if bounded and plan.splits > 1 else (None,)

        def launch(lib):
            head = (q.data_ptr(), codes.data_ptr(), dead_p, nq, rows, rows, 32,
                    m, 1, plan.tq, plan.stages)
            tail = (plan.splits, plan.tiles_per_split, part.data_ptr())
            if bounded:
                bound.fill_(32 * 8 + 1)
            rc = (lib.rp_topk_scan(*head, plan.buf, *tail, None,
                                   *shared[:bounded], stream)
                  if buffered else lib.rp_topk_scan(*head, *tail, stream))
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")

        ms = {n: [] for n in libs}
        for n in list(libs) + list(libs)[::-1]:
            ms[n].append(timed(lambda: launch(libs[n])))
        rows_out.append({"shape": name, "queries": nq, "rows": rows, "m": m,
                         "plan": list(plan), "ms": ms})
        print(json.dumps(rows_out[-1]), flush=True)
        del q, codes, dead, part
        torch.cuda.empty_cache()
    print(json.dumps({"k4_parts": rows_out, "root": str(root),
                      "buffered": buffered, "bounded": bounded, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
