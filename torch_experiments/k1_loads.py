#!/usr/bin/env python3
"""What holds the fused projection kernel (K1) back: its loads or its
tensor-core work.

Builds ``randomprojection_tpu_torch/csrc/fused_project.cu`` as shipped and
a copy whose producer stops loading after the ring's first fill (the
consumers then contract stale tiles: wrong values, the same instructions),
and times both on the card at config 2's batch (65,536 × 4096 → 256) in the
three modes and at ring depths 2, 3 and the plan's, interleaved (shipped,
no loads, no loads, shipped).  If the no-loads copy takes the shipped
time, the loads are hidden and the consumers' tensor-core work is the
bound.  Run from the repository root on a machine with a card and
``nvcc``::

    python3 torch_experiments/k1_loads.py

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
N, D, K = 65_536, 4096, 256
REPS = 30

# the producer's loads, and the same loads made only while the ring fills
_LOADS = '''        if (pt == 0) {
          mbar_expect_tx(full(st), use_tma ? kStageBytes : kMBytes);
          if (use_tma) {'''
_FIRST_FILL = '''        const bool fill = fills++ < stages;
        if (pt == 0) {
          mbar_expect_tx(full(st), fill ? kStageBytes : 0);
          if (use_tma && fill) {'''
_MASK = "          tma_load_2d(xs + kXBytes, &m_map, full(st), kb * kStepD, col0);"
_MASK_FILL = "          if (fill) tma_load_2d(xs + kXBytes, &m_map, full(st), kb * kStepD, col0);"
_RING = '''    int st = 0;
    uint32_t ph = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int row0 = (tile / slices) * kTileM;'''
_RING_FILLS = _RING.replace("int st = 0;", "int st = 0, fills = 0;")


def _library(torch, build, src: Path, name: str) -> ctypes.CDLL:
    out = ROOT / "build" / "torch_experiments" / f"lib{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.rp_fused_project.argtypes = [p, p, p, i64, i64, i64, i32,
                                     ctypes.c_float, i32, i32, i32, i32, i32, p]
    lib.rp_fused_project.restype = i32
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k1_loads: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from randomprojection_tpu_torch.ops import _build as build
    from randomprojection_tpu_torch.ops import fused_kernels as fk

    src = build.CSRC / "fused_project.cu"
    text = src.read_text()
    for old in (_LOADS, _MASK, _RING):
        if text.count(old) != 1:
            raise SystemExit("k1_loads: the kernel's producer changed; "
                             "update the patch")
    patched = (text.replace(_LOADS, _FIRST_FILL).replace(_MASK, _MASK_FILL)
               .replace(_RING, _RING_FILLS))
    copy = ROOT / "build" / "torch_experiments" / "fused_project_noloads.cu"
    copy.parent.mkdir(parents=True, exist_ok=True)
    copy.write_text(patched)
    libs = {"shipped": _library(torch, build, src, "k1_shipped"),
            "no_loads": _library(torch, build, copy, "k1_noloads")}

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((N, D), generator=g, device="cuda")
    xb = x.to(torch.bfloat16)
    mask = fk.rp_mask_cache(0, K, D, 1 / 3)
    y = torch.empty((N, K), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count

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
    for mode in ("split2", "f32", "bf16"):
        xin = xb if mode == "bf16" else x
        plan = fk.plan_project(N, D, K, mode, sms)
        for stages in sorted({2, 3, plan.stages}):
            def launch(name):
                rc = libs[name].rp_fused_project(
                    xin.data_ptr(), mask.data_ptr(), y.data_ptr(), N, D,
                    plan.mask_columns, K, 1.0, fk._MODE_CODES[mode],
                    plan.cta_n, stages, 1, plan.grid, stream)
                if rc:
                    raise RuntimeError(f"launch failed: CUDA error {rc}")

            ms = {name: [] for name in libs}
            for name in ("shipped", "no_loads", "no_loads", "shipped"):
                ms[name].append(timed(lambda: launch(name)))
            rows.append({"mode": mode, "stages": stages,
                         "shipped_ms": ms["shipped"],
                         "no_loads_ms": ms["no_loads"]})
            print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"k1_loads": rows, "shape": f"{N}x{D}->{K}",
                      "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
