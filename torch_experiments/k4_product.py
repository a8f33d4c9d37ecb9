#!/usr/bin/env python3
"""The two exact tensor-core forms of the Hamming top-k kernel's distance
product (K4), timed alone on the card.

Builds ``torch_experiments/k4_product.cu`` and, for a 64 × 256 tile with 32
bytes a row (config 4's code width, one k-step of either form):

* holds one ``wgmma`` of each form against a numpy product of the same
  bytes, in both shared-memory layouts the source knows (the 32-byte
  swizzle and no swizzle), bit for bit;
* times chains of products on every SM with 1, 2 and 3 warpgroups a block
  and reports the rate in operations a second: 1-bit ``.and.popc`` counts
  2·64·256·256 bit operations a product, int8 counts 2·64·256·32.

At config 4's width a (query, code) pair costs one 1-bit step (256 bits)
or eight int8 steps (the bits unpacked to ±1), so the two forms'
``steps_per_s`` compare as 1 : 8.  Run from the
repository root on a machine with a card and ``nvcc``::

    python3 torch_experiments/k4_product.py

Prints one JSON line with the card's name and power limit beside the rates.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
ITERS = 4000  # 8 products each
FORMS = {"b1_and_popc": (0, 256), "int8": (1, 32)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k4_product: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from randomprojection_tpu_torch.ops import _build as build

    src = Path(__file__).with_suffix(".cu")
    out = ROOT / "build" / "torch_experiments" / "libk4_product.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                           str(src)], capture_output=True, text=True)
    if proc.returncode:
        print(proc.stdout, proc.stderr, file=sys.stderr)
        return 1
    for r in build.kernel_resources(proc.stderr):
        print(f"ptxas {r}", flush=True)
    lib = ctypes.CDLL(str(out))
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.k4_product.argtypes = [i32, p, p, p, i32, i32, i32, i32, p]
    lib.k4_product.restype = i32

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(0)
    A = rng.integers(0, 256, size=(64, 32), dtype=np.uint8)
    B = rng.integers(0, 256, size=(256, 32), dtype=np.uint8)
    a, b = torch.from_numpy(A).cuda(), torch.from_numpy(B).cuda()
    res = torch.zeros((64, 256), dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch(form, iters, layout, wgs, blocks):
        rc = lib.k4_product(form, a.data_ptr(), b.data_ptr(), res.data_ptr(),
                            iters, layout, wgs, blocks, stream)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")

    bits = lambda x: np.unpackbits(x, axis=1, bitorder="little").astype(np.int64)
    want = {"b1_and_popc": bits(A) @ bits(B).T,
            "int8": A.view(np.int8).astype(np.int64)
            @ B.view(np.int8).astype(np.int64).T}
    exact = {}
    for name, (form, _) in FORMS.items():
        for layout, label in ((0, "swizzle32"), (1, "no_swizzle")):
            res.zero_()
            launch(form, 0, layout, 1, 1)
            torch.cuda.synchronize()
            exact[f"{name}/{label}"] = bool(
                np.array_equal(res.cpu().numpy(), want[name]))
    print(json.dumps({"bit_exact": exact}), flush=True)

    rows = []
    for wgs in (1, 2, 3):
        for name in ("b1_and_popc", "int8", "int8", "b1_and_popc"):
            form, depth = FORMS[name]
            launch(form, ITERS, 0, wgs, sms)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            launch(form, ITERS, 0, wgs, sms)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
            steps = sms * wgs * 8 * ITERS
            rows.append({"form": name, "warpgroups": wgs, "ms": ms,
                         "steps_per_s": steps / (ms / 1e3),
                         "ops_per_s": steps * 2 * 64 * 256 * depth / (ms / 1e3)})
            print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"k4_product": rows, "bit_exact": exact,
                      "tile": "64x256, 32 bytes a row", "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
