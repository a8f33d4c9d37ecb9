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

at config 4's serving shape (2048 queries × 2²⁴ codes × 32 B, m = 16) and at
one query tile (64 queries, 32 row splits).  Run from the repository root on
a machine with a card and ``nvcc``::

    python3 torch_experiments/k4_parts.py

Prints one JSON line with the card's name and power limit beside the
milliseconds.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROWS, N_BYTES, M = 1 << 24, 32, 16
REPS = 5

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k4_parts: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from randomprojection_tpu_torch.ops import _build as build
    from randomprojection_tpu_torch.ops import topk_kernels as tk

    text = (build.CSRC / "topk.cu").read_text()
    sources = {
        "shipped": text,
        "no_loads": _patched(text, NO_LOADS),
        "no_select": _patched(text, NO_SELECT),
        "no_epilogue": _patched(text, NO_EPILOGUE),
        "no_epilogue_no_loads": _patched(text, NO_EPILOGUE + NO_LOADS),
        "no_epilogue_no_products": _patched(text, NO_EPILOGUE + NO_PRODUCTS),
        "no_epilogue_no_complement": _patched(text, NO_EPILOGUE + NO_COMPLEMENT),
    }
    out = ROOT / "build" / "torch_experiments"
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
        lib.rp_topk_scan.argtypes = [p, p, p, i64, i64, i64, i64, i32, i32,
                                     i32, i32, i32, i32, p, p]
        lib.rp_topk_scan.restype = i32

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(0)
    codes = torch.randint(0, 256, (ROWS, N_BYTES), generator=g, device="cuda",
                          dtype=torch.uint8)
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

    rows = []
    for nq in (2048, 64):
        q = torch.randint(0, 256, (nq, N_BYTES), generator=g, device="cuda",
                          dtype=torch.uint8)
        plan = tk.plan_fused(nq, ROWS, N_BYTES, M, sm_count=sms)
        part = torch.empty((nq, plan.splits, M), dtype=torch.int64, device="cuda")

        def launch(name):
            rc = libs[name].rp_topk_scan(
                q.data_ptr(), codes.data_ptr(), None, nq, ROWS, ROWS, N_BYTES,
                M, 1, plan.tq, plan.stages, plan.splits, plan.tiles_per_split,
                part.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")

        ms = {name: [] for name in libs}
        order = list(libs) + list(libs)[::-1]
        for name in order:
            ms[name].append(timed(lambda: launch(name)))
        rows.append({"queries": nq, "plan": list(plan), "ms": ms})
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"k4_parts": rows, "shape": f"{ROWS}x{N_BYTES}B m={M}",
                      "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
