#!/usr/bin/env python3
"""What holds the mask writer (K3, ``rp_lazy_matrix``, and its bf16 twin
``rp_mask_cache``) back at 256 × 4096: the hash or the launch and stores.

Builds ``randomprojection_tpu_torch/csrc/fused_project.cu`` as shipped and
a copy whose hash finisher is one operation (``h & 1`` picks ±1: wrong
values, the same grid, loads of nothing and the same 16-byte stores), and
times each writer's device time (CUDA events around a CUDA graph of 20
calls) beside a torch fill of the same output, the floor of any kernel
that writes it, interleaved (shipped, no hash, fill, fill, no hash,
shipped).  If the no-hash copy takes the fill's time and the shipped one
more, the hash's integer operations are what the shipped writer pays
above the floor.  Run from the repository root on a machine with a card
and ``nvcc``::

    python3 torch_experiments/k3_parts.py

Prints one JSON line with the card's name and power limit beside the
milliseconds.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
K, D, SEED, DENSITY = 256, 4096, 0, 1 / 3

_FINISH = '''  h = (h ^ (h >> 15)) * 0x2C1B3C6Du;
  h ^= h >> 13;
  const uint32_t m = h >> 8;
  return m < p.lim_plus ? 1.0f : (m < p.lim_nonzero ? -1.0f : 0.0f);'''
_ONE_OP = '''  return (h & 1u) ? 1.0f : -1.0f;'''


def _library(build, src: Path, name: str) -> ctypes.CDLL:
    out = ROOT / "build" / "torch_experiments" / f"lib{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    p, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    geometry = [i32, i32, i32, i32]
    lib.rp_mask_cache.argtypes = [p, i32, i32, i32, u32, u32, u32, u32,
                                  *geometry, p]
    lib.rp_lazy_matrix.argtypes = [p, i32, i32, u32, u32, u32, u32,
                                   ctypes.c_float, i32, *geometry, p]
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k3_parts: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import graph_ms
    from randomprojection_tpu_torch.ops import _build as build
    from randomprojection_tpu_torch.ops import fused_kernels as fk

    src = build.CSRC / "fused_project.cu"
    text = src.read_text()
    if text.count(_FINISH) != 1:
        raise SystemExit("k3_parts: the hash finisher changed; update the patch")
    copy = ROOT / "build" / "torch_experiments" / "fused_project_nohash.cu"
    copy.parent.mkdir(parents=True, exist_ok=True)
    copy.write_text(text.replace(_FINISH, _ONE_OP))
    libs = {"shipped": _library(build, src, "k3_shipped"),
            "no_hash": _library(build, copy, "k3_nohash")}

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    lim_plus, lim_nonzero = fk.mask_limits(DENSITY)
    scale = 1.0 / (DENSITY * K) ** 0.5

    def writer(lib_name, item):
        plan = fk.plan_mask_writer(K, D, item)
        lib = libs[lib_name]
        geometry = (plan.block_x, plan.block_y, plan.grid_x, plan.grid_y)

        def call():
            # the current stream at each call: a capture runs on its own
            stream = torch.cuda.current_stream().cuda_stream
            if item == 4:
                out = torch.empty((K, D), device="cuda")
                rc = lib.rp_lazy_matrix(out.data_ptr(), K, D, SEED, 0, lim_plus,
                                        lim_nonzero, scale, plan.store,
                                        *geometry, stream)
            else:
                out = torch.empty((K, plan.cols), dtype=torch.bfloat16,
                                  device="cuda")
                rc = lib.rp_mask_cache(out.data_ptr(), K, D, plan.cols, SEED, 0,
                                       lim_plus, lim_nonzero, *geometry,
                                       stream)
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")
            return out
        return call

    rows = []
    for item, dtype in ((4, torch.float32), (2, torch.bfloat16)):
        cols = fk.plan_mask_writer(K, D, item).cols
        fns = {
            "shipped": writer("shipped", item),
            "no_hash": writer("no_hash", item),
            "fill": lambda: torch.empty((K, cols), dtype=dtype,
                                        device="cuda").fill_(1.0),
        }
        ms = {name: [] for name in fns}
        for name in ("shipped", "no_hash", "fill", "fill", "no_hash", "shipped"):
            ms[name].append(graph_ms(torch, fns[name]))
        rows.append({"writer": "rp_lazy_matrix" if item == 4 else "rp_mask_cache",
                     "bytes": K * cols * item,
                     **{f"{name}_ms": v for name, v in ms.items()}})
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"k3_parts": rows, "shape": f"{K}x{D}", "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
