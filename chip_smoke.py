#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and hold its kernels to their
plain versions.

Run from the repository root, on a machine with a card and ``nvcc``::

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. the card: ``nvidia-smi`` name and power limit, ``torch.cuda`` name;
2. build the CUDA kernels from ``randomprojection_tpu_torch/csrc`` and print
   ``ptxas``'s registers, shared memory and spill stores per kernel (the
   tensor-core projection and top-k kernels must spill nothing);
3. the main path's launch plan, then each kernel against its plain PyTorch
   version on the card:
   ``rp_lazy_matrix`` and ``rp_mask_cache`` bit for bit,
   ``rp_fused_project`` within ``max|Δ| ≤ 1e-5·max|Y|`` in the split2, f32
   and bf16 modes at its trouble shapes (1 and 3 rows, k = 8, 64, 512,
   d = 4097 and bf16 rows of 1100, a block offset, a persistent grid of
   more tiles than SMs), and a row's bits independent of its place in a
   tile;
4. the main path at config-2 width: ``SparseRandomProjection(256,
   density=1/3, materialization='lazy')`` fitted to 1,000,000 × 4096 and
   transforming 1M device-resident rows in 65,536-row batches (rows/s by
   CUDA events), with the launch counts read around the run (one
   ``rp_mask_cache`` and one ``rp_fused_project`` a batch); a full batch
   and the short last one against the plain version; the model's matrix
   (``components_as_numpy``, the mask writer's path, its launches read
   around it) bit for bit; and the pairwise-distance distortion of a
   2,000-row sample against a float64 product with that matrix (≤ 1e-3);
5. the same fit on the dense route and with ``precision='split2'``
   (distortion only), and a Gaussian model;
6. ``transform_stream`` over a host source for 8 batches with a
   checkpoint, cut after 3 batches and resumed: bit-identical to an
   uninterrupted run;
7. each kernel's time at the main path's shape beside its bound, its plain
   version's time and one PyTorch call's time; ``rp_fused_project`` in all
   three modes (f32 and split2 against ``torch.matmul`` in float32, bf16
   against ``torch.matmul`` of bf16 x and the bf16 mask) and, beside
   split2, the port's dense split2 route (``split2_project`` against a
   materialized bf16 mask);
8. the config-4 serving path at full width: ``SignRandomProjection(256)``
   fitted to 768 features encodes 2^24 rows drawn on the card into 32-byte
   codes (sign mismatch against a float64 product ≤ 1e-4); a
   ``SimHashIndex`` of them answers ``query_topk`` of 2,048 queries at
   m = 16 through ``rp_fused_topk`` (its tensor-core scan and its merge, one
   launch each a (tile, chunk), read around each run; 64 queries held bit
   for bit against ``topk_plain``), then again after a
   seeded 1% ``delete`` (masked), an ``add`` of 2^20 codes and a
   ``compact`` (equal through the mapping); a ``TopKServer`` serves 16
   client threads × 4 requests × 128 rows, each bit-identical to a direct
   ``query_topk``; the kernel's two scan routes (the tensor-core one the
   planner picks wherever its lists fit, and the CUDA-core one forced by an
   explicit plan) against the plain version at the trouble shapes (3-, 4-
   and 36-byte codes, 2^16-byte rows, bases off 16 bytes, m = 1 and above
   the live rows, ties, all rows equal, a corpus in descending distance,
   99% of the rows deleted, ``n_real = 0``, 1, 65 and 2049 queries, an LSH
   tile of 64 × 2^19 with a dead mask, the plan's largest m); and its time
   at 2048 × 2^24 × 32 B, at a 4,096-row server batch and at the LSH tile;
9. the multi-probe LSH tier at the reference's own bench shape
   (``benchmark.py`` ``LSH_BENCH_SHAPES["full"]``): 2^20 planted-neighbour
   codes of 32 bytes (clusters of 16, 6 noise bits) in an
   ``LSHSimHashIndex(bands=8, band_bits=16, fallback_density=1.0)`` on the
   card; for 1, 2, 4, 8 and 16 probes ``query_topk`` of 256 queries (m = 10,
   tile 64) on the device rung (each tile one CUDA-graph replay of the
   composite: ``rp_probe``'s two launches, then ``rp_fused_topk``'s scan and
   merge; launches, replays and captures read around each call, exact)
   equals the host rung bit for bit with zero
   fallbacks, with recall@10 against the exact answer (``probes=0`` through
   the same index), the candidate fraction, q/s over 3 other query sets and
   the host-prep/dispatch split; some probe count reaches recall ≥ 0.95 at a
   candidate fraction ≤ 0.10 (the reference's tripwire); the probe kernel
   against its plain version at the bench shape and its trouble shapes, and
   the same bits over repeated launches at 2^21 runs;
   full probe coverage and adaptive probing at their ceiling on a two-chunk
   index with tombstones across the seam equal a brute force; a
   ``TopKServer`` with a two-label ``probe_policy`` answers each request as a
   direct ``query_topk`` with that label's probes does; and
   ``torch.profiler`` splits one graphed device-rung call at 16 probes into
   device time by kernel beside its host wall (the card's busy share).  The
   probe kernel's and the mask writer's rows give device time (CUDA events
   around a CUDA graph of 20 calls) beside the wrapper's time.

The kernels' timings are printed as one JSON line.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the card as ``nvidia-smi`` names it.  Every number is printed beside the
card's name and power limit.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_ROWS, N_FEATURES, N_COMPONENTS, DENSITY = 1_000_000, 4096, 256, 1 / 3
BATCH = 65_536
SAMPLE = 2_000
STREAM_BATCHES = 8
TOL = 1e-5  # kernel vs plain version: max|Δ| ≤ TOL·max|Y|
# rp_fused_project's trouble shapes (n, d, k, block_offset): one and three
# rows, k = 8, 64 and 512 (two slices), odd d (the cp.async route; bf16
# padded to even), bf16 rows of 1100 (2200 bytes, not 16-byte aligned), a
# block offset, and more tiles than SMs (the persistent grid's second pass)
FUSED_SHAPES = ((8192, 4096, 256, 0), (2048, 16384, 512, 0),
                (1, 4097, 512, 0), (3, 4097, 64, 2), (1000, 1100, 64, 0),
                (130, 1100, 8, 2), (8517, 1024, 256, 0),
                (20_000, 520, 512, 1))
DISTORTION_BUDGET = 1e-3
# published H100 SXM peaks (NVIDIA H100 datasheet), at 700 W
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12
# 32-bit integer ops of one mask entry (3 multiplies by the constants, 3
# xors to combine, the 6-op finalizer, the shift to 24 bits, 2 compares, 2
# selects, the scale), counted on the CUDA cores at their float32 rate
HASH_OPS_PER_ENTRY = 17
INT8_OPS_PER_S = 1979e12
# config-4 serving (benchmark.py TOPK_BENCH_SHAPES["full"]): 2^24 codes of
# 256 bits from 768-wide rows, m = 16, query tile 2048, 16 clients x 4
# requests x 128 rows, max_batch 8192.  The cut from config 4's 1B codes
# is depth only.
SIGN_FEATURES, SIGN_BITS = 768, 256
N_CODES, ENCODE_BATCH, N_ADD = 1 << 24, 131_072, 1 << 20
N_QUERIES, TOPK_M, QUERY_TILE = 2048, 16, 2048
CLIENTS, REQUESTS, REQUEST_ROWS, MAX_BATCH = 16, 4, 128, 8192
HOLD_QUERIES = 64  # queries held against the plain version on the card
SIGN_MISMATCH_BUDGET = 1e-4
# the LSH tier (benchmark.py LSH_BENCH_SHAPES["full"], the reference's own
# bench shape, nothing cut): planted neighbours, probes 1..16, 3 timed query
# sets; the tripwire of benchmark.py:64-65
LSH_N, LSH_BYTES, LSH_CLUSTER, LSH_NOISE = 1 << 20, 32, 16, 6
LSH_NQ, LSH_M, LSH_BANDS, LSH_BAND_BITS = 256, 10, 8, 16
LSH_PROBES, LSH_CALLS, LSH_TILE = (1, 2, 4, 8, 16), 3, 64
LSH_RECALL_GATE, LSH_FRACTION_GATE = 0.95, 0.10
# full coverage: 4 bands x 8 bits over 2^16 codes in two chunks
FULL_N, FULL_BANDS, FULL_BAND_BITS, FULL_NQ = 1 << 16, 4, 8, 64
REPEATS = 50  # the probe kernel's repeats at its largest trouble shape

CARD = ""


def log(msg: str) -> None:
    """Print a progress line, with the card's name and power limit beside
    its numbers once they are known."""
    print(f"{msg} [{CARD}]" if CARD else msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of ``fn`` on the card, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, per_graph: int = 20, replays: int = 10) -> float:
    """Device milliseconds per call of ``fn``: ``per_graph`` calls captured
    in one CUDA graph, replayed ``replays`` times between CUDA events, so
    the host makes one launch a replay and the card's time is measured
    (gaps between the graph's kernels included)."""
    fn()  # builds, plans and lazy loads stay out of the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * per_graph)


def pdist2(a):
    """Squared pairwise distances, upper triangle (the repo's distortion
    metric: randomprojection_tpu/benchmark.py)."""
    a = np.asarray(a, dtype=np.float64)
    sq = (a * a).sum(1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (a @ a.T)
    iu = np.triu_indices(a.shape[0], k=1)
    return np.maximum(d2[iu], 1e-30)


def distortion(est, x_sample) -> float:
    """Max relative error of pairwise squared distances of the model's
    output against a float64 product with its own matrix."""
    y = est.transform(x_sample)
    c = np.asarray(est.components_as_numpy(), dtype=np.float64)
    xs = x_sample.double().cpu().numpy()
    ys = y.double().cpu().numpy()
    if not np.isfinite(ys).all() or ys.shape != (xs.shape[0], c.shape[0]):
        raise AssertionError(f"output not finite or wrong shape {ys.shape}")
    return float(np.max(np.abs(pdist2(ys) / pdist2(xs @ c.T) - 1.0)))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# -- phases ----------------------------------------------------------------------


def phase_build(build_mod):
    """Compile every csrc/*.cu at once, one nvcc each, then load them."""
    from concurrent.futures import ThreadPoolExecutor

    names = sorted(p.stem for p in build_mod.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        builds = list(pool.map(build_mod.build, names))
    log(f"build: {len(names)} sources in {time.perf_counter() - t0:.2f} s "
        f"(nvcc -O3 sm_90a, in parallel)")
    for b in builds:
        log(f"  {b.path.name}: {b.seconds:.2f} s")
        for r in build_mod.kernel_resources(b.ptxas_log):
            log(f"  ptxas {r['kernel']}: {r.get('registers')} registers, "
                f"{r.get('smem_bytes', 0)} bytes smem, "
                f"{r.get('spill_store_bytes', 0)} bytes spill stores")
            if ("fused_project_kernel" in r["kernel"]
                    or "topk_mma_kernel" in r["kernel"]):
                check(r.get("spill_store_bytes", 0) == 0,
                      f"{r['kernel']} spills registers")


def phase_kernels(torch, fk, errs):
    plan = fk.plan_project(BATCH, N_FEATURES, N_COMPONENTS, "split2",
                           torch.cuda.get_device_properties(0)
                           .multi_processor_count)
    log(f"rp_fused_project plan at {BATCH}x{N_FEATURES}->{N_COMPONENTS} "
        f"split2: {plan} ({plan.smem_bytes} bytes dynamic smem a CTA)")
    g = torch.Generator(device="cuda").manual_seed(1)
    for seed, k, d, off in ((0, 256, 4096, 0), (0, 256, 4100, 0),
                            (12345678901, 256, 4096, 3), (0, 512, 16384, 0)):
        got = fk.rp_lazy_matrix(seed, k, d, DENSITY, block_offset=off)
        torch.cuda.synchronize()
        want = fk.lazy_matrix_plain(seed, k, d, DENSITY, block_offset=off,
                                    device="cuda")
        exact = torch.equal(got, want)
        err = (got - want).abs().max().item()
        errs["rp_lazy_matrix"] = max(errs["rp_lazy_matrix"], err)
        log(f"rp_lazy_matrix k={k} d={d} offset={off}: bit-exact={exact}")
        check(exact, "rp_lazy_matrix differs from its plain version")
        got = fk.rp_mask_cache(seed, k, d, DENSITY, block_offset=off)
        torch.cuda.synchronize()
        want = fk.mask_cache_plain(seed, k, d, DENSITY, block_offset=off,
                                   device="cuda")
        exact = torch.equal(got, want)
        errs["rp_mask_cache"] = max(errs["rp_mask_cache"],
                                    (got.float() - want.float()).abs().max().item())
        log(f"rp_mask_cache k={k} d={d} offset={off}: bit-exact={exact}")
        check(exact, "rp_mask_cache differs from its plain version")
    for n, d, k, off in FUSED_SHAPES:
        x = torch.randn((n, d), generator=g, device="cuda")
        for mode in ("split2", "f32", "bf16"):
            xin = x.to(torch.bfloat16) if mode == "bf16" else x
            y = fk.rp_fused_project(xin, 0, k, DENSITY, block_offset=off,
                                    mxu_mode=mode)
            torch.cuda.synchronize()
            ref = fk.fused_project(xin, 0, k, DENSITY, block_offset=off,
                                   mxu_mode=mode)
            err = (y - ref).abs().max().item()
            scale = ref.abs().max().item()
            errs["rp_fused_project"] = max(errs["rp_fused_project"], err)
            log(f"rp_fused_project {n}x{d}->{k} offset={off} {mode}: "
                f"max|d|={err:.3e} max|Y|={scale:.3e} ratio={err / scale:.3e} "
                f"(tol {TOL})")
            check(bool(torch.isfinite(y).all()), "non-finite kernel output")
            check(err <= TOL * scale, f"rp_fused_project {mode} off tolerance")
            # the same rows moved within their tiles give the same bits
            part = fk.rp_fused_project(xin[5:].contiguous(), 0, k, DENSITY,
                                       block_offset=off, mxu_mode=mode)
            check(torch.equal(part, y[5:]),
                  f"rp_fused_project {mode}: a row depends on its tile place")


def phase_main_path(torch, rpt, fk, errs):
    """Fit and transform at full width, then read the model's matrix, each
    with the launch counts set to 0 just before and read just after.
    Returns the model, its input and the launch count of each kernel in
    its own run."""
    g = torch.Generator(device="cuda").manual_seed(0)
    X = torch.empty((N_ROWS, N_FEATURES), dtype=torch.float32, device="cuda")
    X.normal_(generator=g)
    bounds = [(lo, min(lo + BATCH, N_ROWS)) for lo in range(0, N_ROWS, BATCH)]
    torch.cuda.synchronize()

    fk.reset_launches()
    est = rpt.SparseRandomProjection(
        N_COMPONENTS, density=DENSITY, random_state=0,
        backend_options={"materialization": "lazy"},
    ).fit(X)
    check(est._backend.device.type == "cuda", "model is not on the card")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    ys = [est.transform(X[lo:hi]) for lo, hi in bounds]
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    launched = dict(fk.LAUNCHES)
    log(f"main path launches (fit + transform): {json.dumps(launched)}")
    check(launched["rp_fused_project"] == len(bounds),
          f"fused kernel launched {launched['rp_fused_project']} times for "
          f"{len(bounds)} batches")
    check(launched["rp_mask_cache"] == len(bounds),
          f"mask cache written {launched['rp_mask_cache']} times for "
          f"{len(bounds)} batches")
    Y = torch.cat(ys)
    check(Y.shape == (N_ROWS, N_COMPONENTS) and Y.dtype == torch.float32,
          f"output {tuple(Y.shape)} {Y.dtype}")
    check(bool(torch.isfinite(Y).all()), "non-finite output")
    log(f"main path: lazy split2 {N_ROWS}x{N_FEATURES}->{N_COMPONENTS} in "
        f"{len(bounds)} batches of {BATCH}: {ms:.3f} ms, "
        f"{N_ROWS / (ms / 1e3):.1f} rows/s")

    # the kernel at the main path's own shapes: a full batch and the short
    # last one, against the plain version with the model's seed
    for i in (0, len(bounds) - 1):
        lo, hi = bounds[i]
        ref = fk.fused_project(X[lo:hi], est.spec_.seed, N_COMPONENTS,
                               est.spec_.density, mxu_mode="split2")
        err = (ys[i] - ref).abs().max().item()
        scale = ref.abs().max().item()
        errs["rp_fused_project"] = max(errs["rp_fused_project"], err)
        log(f"main path batch {i} ({hi - lo} rows) vs plain version: "
            f"max|d|={err:.3e} max|Y|={scale:.3e} ratio={err / scale:.3e} "
            f"(tol {TOL})")
        check(err <= TOL * scale, f"main path batch {i} off tolerance")

    # the mask writer's path: a lazy model's matrix
    fk.reset_launches()
    components = est.components_as_numpy()
    torch.cuda.synchronize()
    launched["rp_lazy_matrix"] = fk.LAUNCHES["rp_lazy_matrix"]
    log(f"components_as_numpy launches: {json.dumps(fk.LAUNCHES)}")
    want = fk.lazy_matrix_plain(est.spec_.seed, N_COMPONENTS, N_FEATURES,
                                est.spec_.density, device="cuda")
    check(np.array_equal(components, want.cpu().numpy()),
          "the model's matrix differs from the plain mask")
    check(launched["rp_lazy_matrix"] == 1,
          f"mask writer launched {launched['rp_lazy_matrix']} times for one "
          f"matrix")
    check(fk.LAUNCHES["rp_mask_cache"] == 0 == fk.LAUNCHES["rp_fused_project"],
          "components_as_numpy launched the projection")

    sample = X[:SAMPLE]
    eps = distortion(est, sample)
    # row tiles are independent: the sample's rows equal batch 0's rows
    check(torch.equal(est.transform(sample), ys[0][:SAMPLE]),
          "output depends on the batch split")
    log(f"main path: distortion {eps:.3e} on {SAMPLE} rows vs float64 "
        f"(budget {DISTORTION_BUDGET})")
    check(eps <= DISTORTION_BUDGET, "main path distortion over budget")
    return est, X, launched


def phase_other_routes(torch, rpt, X):
    sample = X[:SAMPLE]
    for label, est in (
        ("dense", rpt.SparseRandomProjection(N_COMPONENTS, density=DENSITY,
                                             random_state=0)),
        ("split2", rpt.SparseRandomProjection(
            N_COMPONENTS, density=DENSITY, random_state=0,
            backend_options={"precision": "split2"})),
        ("gaussian", rpt.GaussianRandomProjection(N_COMPONENTS, random_state=0)),
    ):
        est.fit(X)
        eps = distortion(est, sample)
        log(f"route {label}: distortion {eps:.3e} (budget {DISTORTION_BUDGET})")
        check(eps <= DISTORTION_BUDGET, f"{label} distortion over budget")


def phase_stream(est, streaming, scratch: Path):
    n = STREAM_BATCHES * BATCH

    def read(lo, hi):
        # uniform draws: the cheapest deterministic host rows
        rng = np.random.default_rng([7, lo])
        return rng.random((hi - lo, N_FEATURES), dtype=np.float32)

    src = streaming.CallableSource(read, n, N_FEATURES, np.float32,
                                   batch_rows=BATCH)
    t0 = time.perf_counter()
    full = streaming.stream_to_array(est, src)
    full_s = time.perf_counter() - t0
    ckpt = scratch / "cursor.json"
    ckpt.unlink(missing_ok=True)
    out = np.full_like(full, np.nan)
    for i, (lo, y) in enumerate(est.transform_stream(src, checkpoint_path=str(ckpt))):
        out[lo:lo + y.shape[0]] = y
        if i == 2:
            break
    done = streaming.StreamCursor.load(str(ckpt)).rows_done
    check(done == 2 * BATCH, f"cursor after the cut: {done}")
    streaming.stream_to_array(est, src, out=out, checkpoint_path=str(ckpt))
    check(streaming.StreamCursor.load(str(ckpt)).rows_done == n, "cursor at end")
    check(np.array_equal(out, full), "resumed stream differs")
    check(bool(np.isfinite(full).all()), "non-finite stream output")
    log(f"stream: {STREAM_BATCHES} host batches of {BATCH}x{N_FEATURES}, cut "
        f"after 3, resumed bit-identical; uninterrupted run {full_s:.3f} s "
        f"({n / full_s:.1f} rows/s host source included)")


def phase_timing(torch, fk, est, X, counts, errs):
    """K1 in its three modes, the mask cache and K3 at the main path's
    shapes: the kernel's time beside its bound, its plain version's time
    and one PyTorch call's time on the same inputs."""
    from randomprojection_tpu_torch.ops.precision import fp32_matmul
    from randomprojection_tpu_torch.ops.split_matmul import split2_project

    x = X[:BATCH]
    xb = x.to(torch.bfloat16)
    n, d, k = x.shape[0], N_FEATURES, N_COMPONENTS
    seed, density = est.spec_.seed, est.spec_.density
    m_scaled = fk.rp_lazy_matrix(seed, k, d, density)
    m_bf16 = torch.sign(m_scaled).to(torch.bfloat16)  # the exact ±1/0 mask
    scale = float(m_scaled.abs().max())

    def matmul_f32():
        with fp32_matmul():
            return torch.matmul(x, m_scaled.t())

    # (mode, input, bytes moved, tensor-core products, library call)
    modes = (
        ("split2", x, 4 * n * d + 4 * n * k, 2, matmul_f32),
        ("f32", x, 4 * n * d + 4 * n * k, 3, matmul_f32),
        ("bf16", xb, 2 * n * d + 4 * n * k, 1,
         lambda: torch.matmul(xb, m_bf16.t())),
    )
    timed = {}
    for mode, xin, bytes_, products, library in modes:
        row = {
            "ms": cuda_ms(lambda: fk.rp_fused_project(
                xin, seed, k, density, mxu_mode=mode), reps=20, warmup=2),
            "plain_ms": cuda_ms(lambda: fk.fused_project(
                xin, seed, k, density, mxu_mode=mode), reps=3),
            "library_ms": cuda_ms(library, reps=20, warmup=2),
        }
        # every product of a bf16 part with the ±1/0 mask is 2ndk operations
        row.update(_bound(bytes_ / HBM_BYTES_PER_S,
                          products * 2 * n * d * k / BF16_FLOP_PER_S))
        timed[mode] = row
        log(f"rp_fused_project {n}x{d}->{k} {mode}: {row['ms']:.3f} ms "
            f"(mask cache included), bound {row['bound_ms']:.3f} ms by "
            f"{row['bound_by']} ({row['bound_ms'] / row['ms']:.1%} of it), "
            f"plain {row['plain_ms']:.3f} ms, library {row['library_ms']:.3f} "
            f"ms ({'torch.matmul bf16' if mode == 'bf16' else 'torch.matmul fp32, TF32 off'})")
    dense_ms = cuda_ms(lambda: split2_project(x, m_bf16, scale), reps=20,
                       warmup=2)
    log(f"dense split2 route (split2_project against a materialized bf16 "
        f"mask, two torch bf16 products): {dense_ms:.3f} ms")

    fused = {
        "name": "rp_fused_project",
        "route": "cuda",
        "source": "randomprojection_tpu_torch/csrc/fused_project.cu",
        "replaces": "randomprojection_tpu/ops/pallas_kernels.py:752",
        "launches": counts["rp_fused_project"],
        "max_abs_err": errs["rp_fused_project"],
        **timed["split2"],
        "shape": f"{n}x{d}->{k} split2",
        "modes": timed,
        "dense_split2_ms": dense_ms,
    }

    dp = -(-d // fk.STEP_D) * fk.STEP_D
    cache = {
        "name": "rp_mask_cache",
        "route": "cuda",
        "source": "randomprojection_tpu_torch/csrc/fused_project.cu",
        # the mask cache of the TPU kernel (_fetch_mask_block, 256), part of
        # K1's pallas_call
        "replaces": "randomprojection_tpu/ops/pallas_kernels.py:752",
        "launches": counts["rp_mask_cache"],
        "max_abs_err": errs["rp_mask_cache"],
        "ms": cuda_ms(lambda: fk.rp_mask_cache(seed, k, d, density), reps=100),
        "plain_ms": cuda_ms(lambda: fk.mask_cache_plain(
            seed, k, d, density, device="cuda"), reps=10),
        "library_ms": None,
    }
    cache.update(_bound(2 * k * dp / HBM_BYTES_PER_S,
                        HASH_OPS_PER_ENTRY * k * d / FP32_FLOP_PER_S))
    cache["shape"] = f"{k}x{dp} bf16"

    lazy = {
        "name": "rp_lazy_matrix",
        "route": "cuda",
        "source": "randomprojection_tpu_torch/csrc/fused_project.cu",
        "replaces": "randomprojection_tpu/ops/pallas_kernels.py:963",
        "launches": counts["rp_lazy_matrix"],
        "max_abs_err": errs["rp_lazy_matrix"],
        # device time, apart from the wrapper's host time
        "ms": graph_ms(torch, lambda: fk.rp_lazy_matrix(seed, k, d, density)),
        "wrapper_ms": cuda_ms(lambda: fk.rp_lazy_matrix(seed, k, d, density),
                              reps=100),
        "plain_ms": cuda_ms(lambda: fk.lazy_matrix_plain(
            seed, k, d, density, device="cuda"), reps=10),
        "library_ms": None,
    }
    lazy.update(_bound(4 * k * d / HBM_BYTES_PER_S,
                       HASH_OPS_PER_ENTRY * k * d / FP32_FLOP_PER_S))
    lazy["shape"] = f"{k}x{d}"
    log(f"rp_lazy_matrix {k}x{d}: device {lazy['ms']:.5f} ms (CUDA graph of "
        f"20 calls), wrapper {lazy['wrapper_ms']:.5f} ms back to back, bound "
        f"{lazy['bound_ms']:.5f} ms by {lazy['bound_by']} "
        f"({lazy['bound_ms'] / lazy['ms']:.1%} of it)")
    for row in (fused, cache, lazy):
        row["card"] = CARD
    return [fused, cache, lazy]


def _hold(torch, tk, errs, got, want, what: str) -> None:
    """Kernel (dist, idx) against the plain version's, bit for bit."""
    for g, w in zip(got, want):
        g = torch.as_tensor(g).to(w.device)
        errs["rp_fused_topk"] = max(errs["rp_fused_topk"],
                                    (g.long() - w.long()).abs().max().item())
        check(torch.equal(g, w), f"rp_fused_topk differs from topk_plain: {what}")
    log(f"{what}: bit-exact against topk_plain")


def _topk_launches(tk):
    """``rp_fused_topk``'s launches since the last reset: (tensor-core scans,
    CUDA-core scans, merges)."""
    return (tk.LAUNCHES["rp_fused_topk_wgmma"], tk.LAUNCHES["rp_fused_topk_popc"],
            tk.LAUNCHES["rp_topk_merge"])


def _encode(torch, est, g, n_rows):
    """``n_rows`` standard-normal rows drawn on the card in batches, encoded
    to packed codes on the card; returns the codes and the encode's
    device milliseconds (CUDA events around each transform)."""
    codes = torch.empty((n_rows, SIGN_BITS // 8), dtype=torch.uint8,
                        device="cuda")
    spans = []
    for lo in range(0, n_rows, ENCODE_BATCH):
        hi = min(lo + ENCODE_BATCH, n_rows)
        x = torch.randn((hi - lo, SIGN_FEATURES), generator=g, device="cuda")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        codes[lo:hi] = est.transform(x)
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return codes, sum(s.elapsed_time(e) for s, e in spans)


def phase_serving(torch, rpt, tk, errs):
    """Config-4 serving at full width; returns what the timing needs and
    the kernel's launches on the serving path."""
    g = torch.Generator(device="cuda").manual_seed(11)
    est = rpt.SignRandomProjection(SIGN_BITS, random_state=7).fit_schema(
        N_CODES, SIGN_FEATURES, dtype=np.float32)
    check(est._backend.device.type == "cuda", "sign model is not on the card")
    codes, enc_ms = _encode(torch, est, g, N_CODES)
    log(f"serving: encoded {N_CODES} x {SIGN_FEATURES} -> {SIGN_BITS} bits in "
        f"{enc_ms:.3f} ms of transform, {N_CODES / (enc_ms / 1e3):.1f} rows/s")
    # sign agreement with a float64 product with the model's own matrix
    gs = torch.Generator(device="cuda").manual_seed(12)
    xs = torch.randn((N_QUERIES, SIGN_FEATURES), generator=gs, device="cuda")
    r64 = torch.as_tensor(est.components_as_numpy(), device="cuda").double()
    y64 = xs.double() @ r64.t()
    bits = np.unpackbits(est.transform(xs).cpu().numpy(), axis=1,
                         bitorder="little")
    want = (y64 > 0).cpu().numpy().astype(np.uint8)
    mismatch = float((bits != want).mean())
    log(f"serving: sign mismatch {mismatch:.3e} on {N_QUERIES} rows vs float64 "
        f"(budget {SIGN_MISMATCH_BUDGET})")
    check(mismatch <= SIGN_MISMATCH_BUDGET, "sign mismatch over budget")

    queries = est.transform(torch.randn((N_QUERIES, SIGN_FEATURES),
                                        generator=g, device="cuda"))
    idx = rpt.SimHashIndex(codes)
    check(idx.device.type == "cuda", "index is not on the card")
    hold = queries[:HOLD_QUERIES]
    launches = 0

    def run(label, chunks):
        nonlocal launches
        tk.reset_launches()
        t0 = time.perf_counter()
        out = idx.query_topk(queries, TOPK_M, tile=QUERY_TILE)
        wall = time.perf_counter() - t0
        n = _topk_launches(tk)
        launches += sum(n)
        tiles = -(-N_QUERIES // QUERY_TILE)
        log(f"serving: query_topk {label}: {N_QUERIES} queries x {idx.n_codes} "
            f"codes m={TOPK_M} in {wall * 1e3:.3f} ms, "
            f"{N_QUERIES / wall:.1f} queries/s; rp_fused_topk launches "
            f"(wgmma scan, popc scan, merge) {n} ({tiles} tile x {chunks} chunk)")
        check(n == (tiles * chunks, 0, tiles * chunks),
              f"{n} launches for {label}")
        return out

    idx.query_topk(queries[:QUERY_TILE], TOPK_M)  # first-call set-up
    d, i = run("resident", 1)
    _hold(torch, tk, errs, (d[:HOLD_QUERIES], i[:HOLD_QUERIES]),
          tk.topk_plain(hold, codes, N_CODES, TOPK_M),
          f"main path, {HOLD_QUERIES} queries")

    rng = np.random.default_rng(13)
    dead_ids = rng.choice(N_CODES, N_CODES // 100, replace=False)
    check(idx.delete(dead_ids) == len(dead_ids), "delete count")
    d, i = run("1% deleted", 1)
    check(not np.isin(i, dead_ids).any(), "a deleted id was returned")
    dead = torch.zeros(N_CODES, dtype=torch.uint8, device="cuda")
    dead[torch.as_tensor(dead_ids, device="cuda")] = 1
    _hold(torch, tk, errs, (d[:HOLD_QUERIES], i[:HOLD_QUERIES]),
          tk.topk_plain(hold, codes, N_CODES, TOPK_M, dead=dead),
          f"masked main path, {HOLD_QUERIES} queries")

    extra, _ = _encode(torch, est, g, N_ADD)
    idx.add(extra)
    d, i = run(f"after add of {N_ADD}", 2)
    mapping = idx.compact()
    d2, i2 = run("after compact", 1)
    check(np.array_equal(d2, d) and np.array_equal(mapping[i2], i),
          "compact changed a result")
    log(f"serving: compact kept {idx.n_codes} codes; results equal through "
        f"the mapping")

    # the server: concurrent clients, each result against a direct call
    n_rows = CLIENTS * REQUESTS * REQUEST_ROWS
    qs = est.transform(torch.randn((n_rows, SIGN_FEATURES), generator=g,
                                   device="cuda")).cpu().numpy()
    want_d, want_i = idx.query_topk(qs, TOPK_M, tile=QUERY_TILE)
    results = {}
    tk.reset_launches()
    with rpt.TopKServer(idx, TOPK_M, max_batch=MAX_BATCH, max_delay_s=0.01,
                        name="chip-smoke") as srv:
        def client(c):
            futs = []
            for r in range(REQUESTS):
                lo = (c * REQUESTS + r) * REQUEST_ROWS
                futs.append((lo, srv.submit(qs[lo:lo + REQUEST_ROWS],
                                            label=f"client{c}")))
            results[c] = [(lo, f.result(timeout=300)) for lo, f in futs]

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads), "a client hung")
        st = srv.stats()
    n = _topk_launches(tk)
    launches += sum(n)
    for c in range(CLIENTS):
        for lo, (d, i) in results[c]:
            check(np.array_equal(d, want_d[lo:lo + REQUEST_ROWS])
                  and np.array_equal(i, want_i[lo:lo + REQUEST_ROWS]),
                  f"server result of client {c} differs from query_topk")
    check(n == (st["batches"], 0, st["batches"]),
          f"{n} launches for {st['batches']} batches")
    lat = st["latency"]
    log(f"serving: TopKServer {CLIENTS} clients x {REQUESTS} x {REQUEST_ROWS} "
        f"rows: {n_rows / wall:.1f} queries/s, {st['batches']} batches, "
        f"rows_per_batch_mean {st['rows_per_batch_mean']}, latency p50 "
        f"{lat['p50'] * 1e3:.3f} ms p99 {lat['p99'] * 1e3:.3f} ms; "
        f"rp_fused_topk launches (wgmma scan, popc scan, merge) {n}; every "
        f"result equals query_topk")
    return codes, queries, launches


def _off(torch, t, by: int):
    """The same contiguous tensor at a base ``by`` bytes past an allocation's."""
    flat = torch.empty(t.numel() + 16, dtype=torch.uint8, device=t.device)
    out = flat[by: by + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def phase_topk_shapes(torch, tk, errs):
    """Each scan route against the plain version at the trouble shapes: the
    route the planner picks, and the CUDA-core route forced by its plan."""
    g = np.random.default_rng(21)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for nq, rows, nb, m, n_dead, corpus, n_real, what in (
        (300, 5000, 3, 16, 0, "random", 4999, "3-byte codes"),
        (33, 2000, 4, 10, 5, "random", 1990, "4-byte codes"),
        (33, 2000, 36, 256, 5, "random", 1990, "36-byte codes, m = 256"),
        (5, 128, 1 << 16, 16, 0, "random", 127, "128 rows x 2^16 bytes"),
        (20, 100, 32, 150, 10, "random", 99, "m above the live rows"),
        (37, 1000, 32, 40, 100, "dup", 999, "duplicated rows"),
        (1, 3000, 32, 1, 0, "equal", 3000, "all rows equal, 1 query, m = 1"),
        (5, 3000, 32, 10, 0, "equal", 3000, "all rows equal, m = 10"),
        (65, 3000, 32, 10, 0, "descending", 3000,
         "descending distances, 65 queries"),
        (70, 20_000, 32, 16, 19_800, "random", 20_000, "99% deleted"),
        (9, 500, 32, 7, 0, "random", 0, "n_real = 0"),
        (40, 3000, 32, 16, 30, "off4", 2990, "bases 4 bytes off"),
        (40, 3000, 32, 16, 30, "off1", 2990, "bases 1 byte off"),
        (64, 1 << 19, 32, LSH_M, 1 << 18, "random", (1 << 19) - 5,
         "an LSH tile with a dead mask"),
        (2049, 70_000, 32, 16, 700, "random", 69_999, "2049 queries, ragged tile"),
        (3, 4000, 32, tk.MAX_M, 0, "random", 3999, f"m = {tk.MAX_M}"),
    ):
        if corpus == "descending":
            # row r has its first n_bits - r n_bits / rows bits set and the
            # queries are zero: every row is nearer than all before it
            ones = nb * 8 - (np.arange(rows) * nb * 8) // rows
            B = np.packbits((np.arange(nb * 8)[None, :] < ones[:, None])
                            .astype(np.uint8), axis=1, bitorder="little")
            A = np.zeros((nq, nb), np.uint8)
        else:
            B = g.integers(0, 256, size=(rows, nb), dtype=np.uint8)
            A = g.integers(0, 256, size=(nq, nb), dtype=np.uint8)
        if corpus == "dup":
            B[rows // 2: rows // 2 + 40] = B[1]
            A[:3] = B[1]
        if corpus == "equal":
            B[:] = B[0]
        if nb == 3:
            B[:, -1] &= 0x0F
            A[:, -1] &= 0x0F
        q = torch.from_numpy(A).cuda()
        c = torch.from_numpy(B).cuda()
        if corpus.startswith("off"):
            q, c = _off(torch, q, int(corpus[3:])), _off(torch, c, int(corpus[3:]))
        dead = None
        if n_dead:
            dead = torch.zeros(rows, dtype=torch.uint8, device="cuda")
            dead[torch.from_numpy(g.choice(rows, n_dead, replace=False)).cuda()] = 1
        want = tk.topk_plain(q, c, n_real, m, dead=dead)
        planned = tk.plan_fused(nq, rows, nb, m, sm_count=sms)
        fits = tk.smem_bytes("wgmma", 64, m, 2, nb) <= 232_448
        check(planned.route == ("wgmma" if fits else "popc"),
              f"{what}: planned route {planned.route}")
        for plan in {planned, tk._plan_popc(nq, rows, m, sms)}:
            tk.reset_launches()
            got = tk.rp_fused_topk(q, c, n_real, m, dead=dead, plan=plan)
            torch.cuda.synchronize()
            n = _topk_launches(tk)
            check(n == ((1, 0, 1) if plan.route == "wgmma" else (0, 1, 1)),
                  f"{what}: launches {n} on the {plan.route} route")
            _hold(torch, tk, errs, got, want,
                  f"rp_fused_topk[{plan.route}] {what} ({nq}x{rows}x{nb}B m={m})")
    # past the plan's largest m the launcher refuses, and launches nothing
    tk.reset_launches()
    try:
        tk.rp_fused_topk(q[:3], c, rows, tk.MAX_M + 1)
    except ValueError as e:
        check("MAX_M" in str(e), f"unexpected refusal: {e}")
    else:
        raise AssertionError(f"rp_fused_topk took m = {tk.MAX_M + 1}")
    check(_topk_launches(tk) == (0, 0, 0), "a refused call launched")
    log(f"rp_fused_topk refuses m = {tk.MAX_M + 1} (past MAX_M)")


def timing_topk(torch, tk, codes, queries, launches, errs):
    """K4 at the serving shape on the route the main path takes, beside its
    bound and the plain version; the CUDA-core route at the same shape, and
    the tensor-core route at a 4,096-row server batch and at an LSH tile."""
    nq, rows, nb = queries.shape[0], codes.shape[0], codes.shape[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    hold = queries[:HOLD_QUERIES]
    plan = tk.plan_fused(nq, rows, nb, TOPK_M, sm_count=sms)
    check(plan.route == "wgmma", f"the serving shape's route is {plan.route}")
    row = {
        "name": "rp_fused_topk",
        "route": "cuda",
        "scan_route": plan.route,
        "source": "randomprojection_tpu_torch/csrc/topk.cu",
        "replaces": "randomprojection_tpu/ops/topk_kernels.py:449",
        "launches": launches,
        "max_abs_err": errs["rp_fused_topk"],
        "ms": cuda_ms(lambda: tk.rp_fused_topk(queries, codes, rows, TOPK_M),
                      reps=10),
        "plain_ms": cuda_ms(lambda: tk.topk_plain(hold, codes, rows, TOPK_M),
                            reps=1, warmup=0),
        "library_ms": None,
    }
    # each code and query read once, dist and idx written once.  The
    # product: a 1-bit tensor-core step covers 256 bits of a pair in the
    # time an int8 step covers 32 values (torch_experiments/k4_product.py),
    # so a pair needs at least n_bits / 8 multiply-adds at the int8 rate;
    # the int8 form itself (a +-1 product per bit) needs eight times that
    bytes_ = rows * nb + nq * nb + 2 * nq * TOPK_M * 4
    row.update(_bound(bytes_ / HBM_BYTES_PER_S,
                      2 * nq * rows * nb / INT8_OPS_PER_S))
    row["bound_int8_form_ms"] = 2 * nq * rows * nb * 8 / INT8_OPS_PER_S * 1e3
    row["shape"] = (f"{nq}x{rows}x{nb}B m={TOPK_M}; plain_ms on "
                    f"{HOLD_QUERIES} queries")
    popc = tk._plan_popc(nq, rows, TOPK_M, sms)
    batch = torch.cat([queries, queries.flip(0)])  # a coalesced server batch
    tile = queries[:LSH_TILE].contiguous()
    cand = codes[: 1 << 19]
    dead = (torch.arange(1 << 19, device="cuda") % 3 == 0).to(torch.uint8)
    row["other_ms"] = {
        f"popc route, {nq}x{rows}x{nb}B m={TOPK_M}": cuda_ms(
            lambda: tk.rp_fused_topk(queries, codes, rows, TOPK_M, plan=popc),
            reps=1, warmup=0),
        f"wgmma route, {batch.shape[0]}x{rows}x{nb}B m={TOPK_M}": cuda_ms(
            lambda: tk.rp_fused_topk(batch, codes, rows, TOPK_M), reps=5),
        f"wgmma route, {LSH_TILE}x{1 << 19}x{nb}B m={LSH_M}, dead mask": cuda_ms(
            lambda: tk.rp_fused_topk(tile, cand, 1 << 19, LSH_M, dead=dead),
            reps=50, warmup=2),
    }
    row["card"] = CARD
    log(f"rp_fused_topk {row['shape']}: {row['ms']:.3f} ms on the "
        f"{plan.route} route (plan {plan}), bound {row['bound_ms']:.3f} ms by "
        f"{row['bound_by']} ({row['bound_ms'] / row['ms']:.1%} of it; the int8 "
        f"form's bound {row['bound_int8_form_ms']:.3f} ms), plain "
        f"{row['plain_ms']:.3f} ms; {json.dumps(row['other_ms'])}")
    return row


# -- the LSH tier --------------------------------------------------------------------


def _lsh_flip_bits(rng, codes, flips: int, n_bits: int):
    """XOR ``flips`` random bit positions into every row (duplicate
    positions cancel); the reference bench's generator
    (randomprojection_tpu/benchmark.py ``_lsh_flip_bits``)."""
    out = codes.copy()
    rows = np.repeat(np.arange(out.shape[0], dtype=np.int64), flips)
    pos = rng.integers(0, n_bits, size=rows.size)
    np.bitwise_xor.at(out, (rows, pos >> 3),
                      np.left_shift(np.uint8(1), (pos & 7).astype(np.uint8)))
    return out


def _lsh_data():
    """The reference bench's planted-neighbour corpus and 4 query sets,
    seed 15, drawn in the reference's order (benchmark.py
    ``measure_topk_lsh``)."""
    n_bits = LSH_BYTES * 8
    rng = np.random.default_rng(15)
    n_clusters = LSH_N // LSH_CLUSTER
    centers = rng.integers(0, 256, size=(n_clusters, LSH_BYTES), dtype=np.uint8)
    codes = _lsh_flip_bits(rng, np.repeat(centers, LSH_CLUSTER, axis=0),
                           LSH_NOISE, n_bits)
    qc = rng.integers(0, n_clusters, size=(LSH_CALLS + 1) * LSH_NQ)
    return codes, _lsh_flip_bits(rng, centers[qc], LSH_NOISE, n_bits)


def _lsh_counters(reg):
    return (reg.counter("index.lsh.dispatches"),
            reg.counter("index.lsh.candidates"),
            reg.counter("index.lsh.fallbacks"),
            reg.hist_sum("index.lsh.probe.host_s"),
            reg.hist_sum("index.lsh.probe.dispatch_s"))


def _hold_probe(torch, pk, errs, planes, cap, what):
    """The probe kernel against its plain version on the same planes: slots,
    counts and stats bit for bit (the same algorithm, overflow included)."""
    got = pk.rp_probe_gather(*planes, cap=cap)
    torch.cuda.synchronize()
    want = pk.probe_plain(*planes, cap=cap)
    for g, w in zip(got, want):
        errs["rp_probe"] = max(errs["rp_probe"],
                               (g.long() - w.long()).abs().max().item())
        check(torch.equal(g, w), f"rp_probe_gather differs from probe_plain: {what}")
    st = got[2].tolist()
    log(f"{what}: bit-exact against probe_plain (written {st[0]}, overflow "
        f"{st[1]}, attempted {int(got[1].long().sum())}, cap {cap})")
    return st


def _tile_planes(torch, pk, index, q, p, inactive=()):
    """The probe planes the device rung builds for one query tile."""
    qd = torch.as_tensor(q).cuda()
    masks = index._lsh_device_masks(index._probe_masks(p))
    active = torch.ones((1, q.shape[0]), dtype=torch.int32, device="cuda")
    active[0, list(inactive)] = 0
    indptr, ids = index._lsh_device_csr()
    qkeys = pk.device_band_keys(qd, index.band_plan.bands,
                                index.band_plan.band_bits)
    return [qkeys, masks, active, indptr, ids]


def phase_lsh(torch, pk, tk, errs):
    """The LSH tier at the reference's bench shape: the curve, its checks,
    the probe kernel against its plain version at the bench shape, and the
    inputs of its timing.  Returns those inputs and ``rp_probe``'s launches
    on the curve (each device-rung call read with the counts set to 0 just
    before it)."""
    from randomprojection_tpu_torch.ann import LSHSimHashIndex
    from randomprojection_tpu_torch.utils import telemetry

    reg = telemetry.registry()
    t0 = time.perf_counter()
    codes, queries = _lsh_data()
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = LSHSimHashIndex(codes, bands=LSH_BANDS, band_bits=LSH_BAND_BITS,
                            fallback_density=1.0)
    build_s = time.perf_counter() - t0
    check(index.device.type == "cuda", "LSH index is not on the card")
    log(f"lsh: {LSH_N} planted codes x {LSH_BYTES} B made in {data_s:.3f} s; "
        f"index ({LSH_BANDS} bands x {LSH_BAND_BITS} bits) built in "
        f"{build_s:.3f} s on the host")
    q0 = queries[:LSH_NQ]
    sets = [queries[(c + 1) * LSH_NQ: (c + 2) * LSH_NQ] for c in range(LSH_CALLS)]
    true_d, true_i = index.query_topk(q0, LSH_M, probes=0)
    t0 = time.perf_counter()
    for qs in sets:
        index.query_topk(qs, LSH_M, probes=0)
    exact_qps = LSH_CALLS * LSH_NQ / (time.perf_counter() - t0)
    log(f"lsh: exact baseline (probes=0, rp_fused_topk over all {LSH_N} "
        f"codes): {exact_qps:.1f} queries/s")
    tiles = -(-LSH_NQ // LSH_TILE)
    launches = 0
    curve = []
    for p in LSH_PROBES:
        def device_call(qs, first=False):
            nonlocal launches
            pk.reset_launches()
            tk.reset_launches()
            out = index.query_topk(qs, LSH_M, tile=LSH_TILE, probes=p)
            n_probe, n_topk = pk.LAUNCHES["rp_probe"], _topk_launches(tk)
            launches += n_probe
            reps, caps = pk.GRAPH_REPLAYS, pk.GRAPH_CAPTURES
            _check_graphed(p, tiles, reps, caps, n_probe, n_topk,
                           captures=1 if first else 0)
            return out, n_probe, n_topk

        c0 = _lsh_counters(reg)
        # the probe count's first call captures its tile (one key: every
        # tile is 64 queries at the plan's cap)
        (got_d, got_i), n_probe, n_topk = device_call(q0, first=True)
        check(_lsh_counters(reg)[2] == c0[2], f"probes={p}: a fallback")
        host_d, host_i = index.query_topk(q0, LSH_M, tile=LSH_TILE, probes=p,
                                          probe_path="host")
        check(np.array_equal(got_d, host_d) and np.array_equal(got_i, host_i),
              f"probes={p}: device rung differs from the host rung")
        recall = sum(np.intersect1d(g, t).size
                     for g, t in zip(got_i, true_i)) / true_i.size
        d0, k0, f0, h0, w0 = _lsh_counters(reg)
        t0 = time.perf_counter()
        for qs in sets:
            device_call(qs)
        elapsed = time.perf_counter() - t0
        d1, k1, f1, h1, w1 = _lsh_counters(reg)
        frac = (k1 - k0) / (d1 - d0) / index.n_live
        point = {"probes": p, "recall_at_m": recall,
                 "candidate_fraction": frac,
                 "queries_per_s": LSH_CALLS * LSH_NQ / elapsed,
                 "fallbacks": int(f1 - f0), "probe_host_s": h1 - h0,
                 "probe_dispatch_s": w1 - w0}
        curve.append(point)
        log(f"lsh probes={p}: recall@{LSH_M} {recall:.4f}, candidate fraction "
            f"{frac:.6f}, {point['queries_per_s']:.1f} queries/s "
            f"({point['queries_per_s'] / exact_qps:.2f}x exact), host prep "
            f"{point['probe_host_s']:.6f} s vs dispatch "
            f"{point['probe_dispatch_s']:.6f} s over {LSH_CALLS} calls, "
            f"fallbacks {point['fallbacks']}; launches a call: rp_probe "
            f"{n_probe}, rp_fused_topk {n_topk}; device rung == host rung")
        check(point["fallbacks"] == 0, f"probes={p}: fallbacks in the timed calls")
        # the probe kernel at this probe count's first tile
        pplan = pk.plan_probe(LSH_TILE, LSH_N, LSH_BANDS, LSH_BAND_BITS, p, LSH_M)
        _hold_probe(torch, pk, errs, _tile_planes(torch, pk, index, q0[:LSH_TILE], p),
                    pplan.cap, f"rp_probe_gather bench tile, probes={p}")
    gate = [c for c in curve if c["recall_at_m"] >= LSH_RECALL_GATE
            and c["candidate_fraction"] <= LSH_FRACTION_GATE]
    check(bool(gate), f"no probe count reaches recall >= {LSH_RECALL_GATE} at "
          f"candidate fraction <= {LSH_FRACTION_GATE}")
    log(f"lsh: tripwire holds at probes={gate[0]['probes']} (recall "
        f"{gate[0]['recall_at_m']:.4f}, fraction "
        f"{gate[0]['candidate_fraction']:.6f}); curve "
        f"{json.dumps(curve)}")
    return index, codes, queries, launches


def _check_graphed(what, tiles, reps, caps, n_probe, n_topk, captures=None):
    """A device-rung call's exact counts: one graph replay a tile, each
    replay two ``rp_probe`` launches and a wgmma scan and a merge of
    ``rp_fused_topk``; a capture's eager warm-up launches as much once
    more and the capture itself nothing."""
    runs = tiles + caps
    check(reps == tiles and (captures is None or caps == captures)
          and n_probe == 2 * runs and n_topk == (runs, 0, runs),
          f"probes={what}: {reps} graph replays and {caps} captures for "
          f"{tiles} tiles, rp_probe {n_probe}, rp_fused_topk {n_topk} "
          f"launches (want a replay a tile, 2 rp_probe, a wgmma scan and a "
          f"merge a replay or warm-up)")


def phase_lsh_wide(pk, tk, codes, queries):
    """The bench corpus under 8 bands of 2^20 buckets, a shape the
    reference's planner refuses (its TPU budget): the device rung sizes
    each tile by its runs and serves it on the card with no fallback,
    equal to the host rung."""
    from randomprojection_tpu_torch.ann import LSHSimHashIndex
    from randomprojection_tpu_torch.utils import telemetry

    reg = telemetry.registry()
    t0 = time.perf_counter()
    index = LSHSimHashIndex(codes, bands=8, band_bits=20, fallback_density=1.0)
    build_s = time.perf_counter() - t0
    q0 = queries[:LSH_NQ]
    tiles = -(-LSH_NQ // LSH_TILE)
    for p in (1, 16):
        check(pk.plan_probe(LSH_TILE, LSH_N, 8, 20, p, LSH_M) is None,
              f"wide bands, probes={p}: the reference planner has a tile")
        f0 = reg.counter("index.lsh.fallbacks")
        pk.reset_launches()
        tk.reset_launches()
        t0 = time.perf_counter()
        got_d, got_i = index.query_topk(q0, LSH_M, tile=LSH_TILE, probes=p)
        wall = time.perf_counter() - t0
        n_probe, n_topk = pk.LAUNCHES["rp_probe"], _topk_launches(tk)
        # each tile's cap is its runs' pow2 ceiling: tiles may key apart
        _check_graphed(f"{p} (wide bands)", tiles, pk.GRAPH_REPLAYS,
                       pk.GRAPH_CAPTURES, n_probe, n_topk)
        check(reg.counter("index.lsh.fallbacks") == f0,
              f"wide bands, probes={p}: a fallback")
        host_d, host_i = index.query_topk(q0, LSH_M, tile=LSH_TILE, probes=p,
                                          probe_path="host")
        check(np.array_equal(got_d, host_d) and np.array_equal(got_i, host_i),
              f"wide bands, probes={p}: device rung differs from the host rung")
        log(f"lsh wide bands (8 x 20 bits, no reference plan; index built in "
            f"{build_s:.3f} s) probes={p}: {LSH_NQ} queries in {wall * 1e3:.3f} "
            f"ms, launches rp_probe {n_probe}, rp_fused_topk {n_topk}, graph "
            f"replays {pk.GRAPH_REPLAYS}, captures {pk.GRAPH_CAPTURES}, no "
            f"fallback; device rung == host rung")
    del index


def profile_lsh(torch, pk, index, queries):
    """Device time by kernel of one graphed device-rung call at 16 probes
    (``torch.profiler`` through CUPTI), beside the call's host wall: the
    device's busy share of the call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    qs = queries[LSH_NQ: 2 * LSH_NQ]
    p = LSH_PROBES[-1]
    index.query_topk(qs, LSH_M, tile=LSH_TILE, probes=p)
    torch.cuda.synchronize()
    pk.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        index.query_topk(qs, LSH_M, tile=LSH_TILE, probes=p)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(pk.GRAPH_REPLAYS == -(-LSH_NQ // LSH_TILE) and pk.GRAPH_CAPTURES == 0,
          f"profiled call: {pk.GRAPH_REPLAYS} replays, {pk.GRAPH_CAPTURES} "
          f"captures")
    rows = sorted(
        ((e.key, getattr(e, "self_device_time_total", 0.0), e.count)
         for e in prof.key_averages()
         if getattr(e, "device_type", None) == DeviceType.CUDA),
        key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    if busy_us <= 0:
        log(f"lsh profile: the profiler saw no device time (busy share not "
            f"measured); call wall {wall * 1e3:.3f} ms")
        return
    log(f"lsh profile, probes={p}, {LSH_NQ} queries in "
        f"{-(-LSH_NQ // LSH_TILE)} tiles, {pk.GRAPH_REPLAYS} graph replays: "
        f"call wall {wall * 1e3:.3f} ms "
        f"(under the profiler), device busy {busy_us / 1e3:.3f} ms "
        f"({busy_us / 1e3 / (wall * 1e3):.1%} of the wall) in "
        f"{sum(r[2] for r in rows)} device events")
    for name, us, n in rows[:10]:
        log(f"  {us:10.1f} us  x{n:<4} {name[:100]}")


def phase_probe_shapes(torch, pk, index, queries, errs):
    """The probe kernel against its plain version at its trouble shapes."""
    from randomprojection_tpu_torch.ann import lsh

    # an overflowing tile, and a ragged tile with inactive queries, on the
    # bench CSR
    planes = _tile_planes(torch, pk, index, queries[:LSH_TILE], 16)
    st = _hold_probe(torch, pk, errs, planes, 4096, "overflowing bench tile")
    check(st[:2] == [0, 1], f"overflow not flagged: {st}")
    _hold_probe(torch, pk, errs,
                _tile_planes(torch, pk, index, queries[:37], 4, inactive=(0, 5, 36)),
                1 << 18, "37 queries, 3 inactive")
    g = np.random.default_rng(31)
    for rows, nb, bands, b, nq, masks, dup, what in (
        (2000, 32, 4, 12, 64, [0, 1, 2], 0, "empty buckets (2^12 a band, 2000 rows)"),
        (20_000, 32, 2, 8, 16, [0, 1], 5000, "a run of 5000 ids"),
        (3000, 32, 3, 3, 9, [0, 1, 2, 3, 4, 5, 6, 7, 0, 1], 0, "P = 10 > 2^3"),
        (1 << 18, 32, 2, 20, 64, [0, 1, 2, 4, 8], 0, "band_bits = 20"),
        (3000, 32, 16, 8, 1024, list(range(128)), 0, "2^21 runs, 2048 blocks"),
    ):
        codes = g.integers(0, 256, size=(rows, nb), dtype=np.uint8)
        codes[:dup] = codes[0]
        plan = lsh.BandPlan(nb * 8, bands=bands, band_bits=b)
        bk = lsh.BandedBuckets(plan)
        bk.add(codes)
        q = codes[g.integers(0, rows, nq)]
        q[0] = codes[0]  # the repeated rows' bucket is probed
        planes = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in (
            lsh.band_keys(q, plan).astype(np.int32),
            np.asarray(masks, np.int32)[None, :], np.ones((1, nq), np.int32),
            np.stack([ip.astype(np.int32) for ip in bk._indptr]),
            np.stack(bk._ids))]
        cap = 1 << 25
        st = _hold_probe(torch, pk, errs, planes, cap, f"rp_probe_gather {what}")
    # the last shape again: no race between the two launches' blocks
    first = pk.rp_probe_gather(*planes, cap=cap)
    for _ in range(REPEATS):
        got = pk.rp_probe_gather(*planes, cap=cap)
        check(all(torch.equal(g, f) for g, f in zip(got, first)),
              "rp_probe_gather differs between repeats")
    log(f"rp_probe_gather 2^21 runs: {REPEATS} repeats bit-identical "
        f"(written {st[0]})")


def _masked_brute(A, B, m, dead_ids):
    """Exact top-m of ``A`` against ``B`` on the host, tombstones excluded,
    (distance, lower id) order; codes in blocks."""
    pop = np.array([bin(v).count("1") for v in range(256)], np.int64)
    D = np.empty((A.shape[0], B.shape[0]), np.int64)
    for lo in range(0, B.shape[0], 4096):
        D[:, lo:lo + 4096] = pop[A[:, None, :] ^ B[None, lo:lo + 4096, :]].sum(-1)
    D[:, dead_ids] = B.shape[1] * 8 + 1
    key = (D << 20) | np.arange(B.shape[0])
    sel = np.argsort(key, axis=1)[:, :m]
    return np.take_along_axis(D, sel, 1).astype(np.int32), sel.astype(np.int32)


def phase_lsh_full(pk):
    """Full probe coverage and adaptive probing at their ceiling on a
    two-chunk index with tombstones across the seam: a brute force."""
    from randomprojection_tpu_torch.ann import LSHSimHashIndex

    g = np.random.default_rng(33)
    codes = g.integers(0, 256, size=(FULL_N, LSH_BYTES), dtype=np.uint8)
    A = codes[g.integers(0, FULL_N, FULL_NQ)] ^ np.uint8(0x11)
    half = FULL_N // 2
    index = LSHSimHashIndex(codes[:half], bands=FULL_BANDS,
                            band_bits=FULL_BAND_BITS, fallback_density=1.0)
    index.add(codes[half:])
    dead = np.concatenate([np.arange(half - 70, half + 70),
                           g.choice(FULL_N, 600, replace=False)])
    index.delete(dead)
    want = _masked_brute(A, codes, LSH_M, np.unique(dead))
    full = 1 << FULL_BAND_BITS
    for adaptive in (False, True):
        pk.reset_launches()
        t0 = time.perf_counter()
        d, i = index.query_topk(A, LSH_M, tile=LSH_TILE, probes=full,
                                adaptive=adaptive)
        wall = time.perf_counter() - t0
        check(np.array_equal(d, want[0]) and np.array_equal(i, want[1]),
              f"full coverage (adaptive={adaptive}) differs from brute force")
        check(pk.GRAPH_REPLAYS > 0 and pk.LAUNCHES["rp_probe"] == 2 * (
            pk.GRAPH_REPLAYS + pk.GRAPH_CAPTURES),
              f"full coverage: {pk.GRAPH_REPLAYS} replays, "
              f"{pk.GRAPH_CAPTURES} captures, rp_probe launches "
              f"{pk.LAUNCHES['rp_probe']}")
        log(f"lsh full coverage ({FULL_BANDS} bands x {FULL_BAND_BITS} bits, "
            f"{FULL_N} codes in 2 chunks, {dead.size} tombstones across the "
            f"seam, adaptive={adaptive}): {FULL_NQ} queries equal a brute force "
            f"in {wall * 1e3:.3f} ms; rp_probe launches {pk.LAUNCHES['rp_probe']}"
            f", graph replays {pk.GRAPH_REPLAYS}, captures {pk.GRAPH_CAPTURES}")


def phase_lsh_server(index, queries):
    """A TopKServer with a two-label probe_policy: each request's answer is
    a direct query_topk of its label's coalesced group with its probes."""
    from randomprojection_tpu_torch.models import sketch as sk

    policy = {"fast": 2, "deep": 8}
    srv = sk.TopKServer(index, LSH_M, max_batch=8192, max_delay_s=0.05,
                        probe_policy=policy, name="chip-smoke-lsh", start=False)
    labels = ["fast", "deep"] * 4
    futs = [srv.submit(queries[64 * k: 64 * k + 64], label=lab)
            for k, lab in enumerate(labels)]
    t0 = time.perf_counter()
    srv.start()  # every request is queued: one coalesced batch, two classes
    got = [f.result(timeout=300) for f in futs]
    wall = time.perf_counter() - t0
    srv.close()
    st = srv.stats()
    check(st["batches"] == 2, f"{st['batches']} dispatches for two probe classes")
    for label, p in policy.items():
        ks = [k for k, lab in enumerate(labels) if lab == label]
        arr = np.concatenate([queries[64 * k: 64 * k + 64] for k in ks])
        pad = sk.row_bucket(arr.shape[0])
        arr = np.pad(arr, ((0, pad - arr.shape[0]), (0, 0)))
        wd, wi = index.query_topk(arr, LSH_M, tile=pad, probes=p)
        for j, k in enumerate(ks):
            check(np.array_equal(got[k][0], wd[64 * j: 64 * j + 64])
                  and np.array_equal(got[k][1], wi[64 * j: 64 * j + 64]),
                  f"server request {k} ({label}) differs from query_topk")
    log(f"lsh: TopKServer probe_policy {json.dumps(policy)}: {len(labels)} "
        f"requests x 64 rows in {st['batches']} dispatches, {wall * 1e3:.3f} ms; "
        f"every result equals a direct query_topk with its label's probes")


def timing_probe(torch, pk, index, queries, launches, errs):
    """K5 at the bench shape (one tile of 64 queries at 16 probes): device
    time, the wrapper's time back to back, and one captured tile's memory."""
    p = LSH_PROBES[-1]
    planes = _tile_planes(torch, pk, index, queries[:LSH_TILE], p)
    cap = pk.plan_probe(LSH_TILE, LSH_N, LSH_BANDS, LSH_BAND_BITS, p, LSH_M).cap
    _, _, stats = pk.rp_probe_gather(*planes, cap=cap)
    written = int(stats[0])
    # the device memory a captured bench tile holds: its pool, reserved
    # for the graph, beside its buffers and the warm-up's outputs
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    entry = pk.capture_tile(torch.as_tensor(queries[:LSH_TILE]).cuda(),
                            planes[1], planes[2], planes[3], planes[4],
                            index._lsh_device_dead(), index._lsh_chunk_planes(),
                            LSH_M, cap=cap, band_bits=LSH_BAND_BITS)
    torch.cuda.synchronize()
    graph_mb = (torch.cuda.memory_reserved() - before) / 2**20
    del entry
    row = {
        "name": "rp_probe",
        "route": "cuda",
        "source": "randomprojection_tpu_torch/csrc/probe.cu",
        "replaces": "randomprojection_tpu/ops/probe_kernels.py:262",
        "launches": launches,
        "max_abs_err": errs["rp_probe"],
        "ms": graph_ms(torch, lambda: pk.rp_probe_gather(*planes, cap=cap)),
        "wrapper_ms": cuda_ms(lambda: pk.rp_probe_gather(*planes, cap=cap),
                              reps=200, warmup=5),
        "plain_ms": cuda_ms(lambda: pk.probe_plain(*planes, cap=cap), reps=20,
                            warmup=2),
        "library_ms": None,
    }
    runs = LSH_TILE * LSH_BANDS * p
    # inputs read once (keys, masks, active; two indptr words a run; the
    # gathered ids), outputs written once (cap slots, counts, stats); a
    # dozen integer operations a run and two a gathered id
    bytes_ = (4 * (LSH_BANDS * LSH_TILE + p + LSH_TILE) + 8 * runs
              + 4 * written + 4 * cap + 4 * LSH_TILE + 32)
    row.update(_bound(bytes_ / HBM_BYTES_PER_S,
                      (12 * runs + 2 * written) / FP32_FLOP_PER_S))
    row["shape"] = (f"{LSH_TILE} queries x {LSH_BANDS} bands x {p} probes over "
                    f"{LSH_N} ids, {written} gathered, cap {cap}")
    row["graph_tile_mb"] = graph_mb
    row["card"] = CARD
    log(f"rp_probe_gather {row['shape']}: device {row['ms']:.5f} ms (CUDA "
        f"graph of 20 calls), wrapper {row['wrapper_ms']:.5f} ms back to back, "
        f"bound {row['bound_ms']:.6f} ms by {row['bound_by']} "
        f"({row['bound_ms'] / row['ms']:.1%} of it), plain "
        f"{row['plain_ms']:.3f} ms; a captured bench tile holds "
        f"{graph_mb:.1f} MiB")
    return row


def _bound(bytes_s: float, ops_s: float) -> dict:
    return {
        "bound_ms": max(bytes_s, ops_s) * 1e3,
        "bound_by": "bytes" if bytes_s >= ops_s else "operations",
    }


def main() -> int:
    global CARD
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import randomprojection_tpu_torch as rpt
        from randomprojection_tpu_torch import streaming
        from randomprojection_tpu_torch.ops import _build as build_mod
        from randomprojection_tpu_torch.ops import fused_kernels as fk
        from randomprojection_tpu_torch.ops import probe_kernels as pk
        from randomprojection_tpu_torch.ops import topk_kernels as tk
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    if Path(rpt.__file__).resolve().parent.parent != ROOT:
        print(f"chip_smoke: imported the port from {rpt.__file__}, not from "
              f"{ROOT}", file=sys.stderr)
        return 2
    scratch = ROOT / "build" / "chip_smoke"
    try:
        CARD = card_line()
        log(f"card: {CARD}; torch.cuda: {torch.cuda.get_device_name(0)}; "
            f"torch {torch.__version__} CUDA {torch.version.cuda}")
        t0 = time.perf_counter()
        phase_build(build_mod)
        errs = {"rp_fused_project": 0.0, "rp_lazy_matrix": 0.0,
                "rp_mask_cache": 0.0, "rp_fused_topk": 0, "rp_probe": 0}
        phase_kernels(torch, fk, errs)
        est, X, counts = phase_main_path(torch, rpt, fk, errs)
        phase_other_routes(torch, rpt, X)
        scratch.mkdir(parents=True, exist_ok=True)
        phase_stream(est, streaming, scratch)
        kernels = phase_timing(torch, fk, est, X, counts, errs)
        del X, est
        torch.cuda.empty_cache()
        codes, queries, topk_launches = phase_serving(torch, rpt, tk, errs)
        phase_topk_shapes(torch, tk, errs)
        kernels.append(timing_topk(torch, tk, codes, queries, topk_launches,
                                   errs))
        del codes, queries
        torch.cuda.empty_cache()
        index, lsh_codes, lsh_queries, probe_launches = phase_lsh(
            torch, pk, tk, errs)
        profile_lsh(torch, pk, index, lsh_queries)
        phase_lsh_wide(pk, tk, lsh_codes, lsh_queries)
        del lsh_codes
        phase_probe_shapes(torch, pk, index, lsh_queries, errs)
        phase_lsh_full(pk)
        phase_lsh_server(index, lsh_queries)
        kernels.append(timing_probe(torch, pk, index, lsh_queries,
                                    probe_launches, errs))
        log(f"total {time.perf_counter() - t0:.1f} s")
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    print(json.dumps({"kernels": kernels}))
    print(CARD)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
