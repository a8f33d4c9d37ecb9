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
3. the main path's launch plans, then each kernel against its plain
   PyTorch version on the card:
   ``rp_lazy_matrix`` and ``rp_mask_cache`` (the two instantiations of the
   mask writer) bit for bit at the main path's shapes and their trouble
   shapes (d = 1, 3, 4097, 4099, 4100 × k = 8, 512 × three seeds × block
   offsets 0 and 3, and 600,000 rows: more than the writer's grid), and
   the old writer (``torch_experiments/mask_writer_per_entry.cu``, built
   beside the port's sources as the yardstick of phase 7) bit for bit too,
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
   then the host's share: the 16-batch loop in a fresh memory pool (torch's
   caching allocator cold: a ``cudaMalloc`` an output) and again in it
   (warm), and cold under ``torch.profiler`` (the host's CUDA API calls,
   counted and timed); and the chain, one ``transform`` of all 1M rows by
   a model with ``dispatch_steps=16``, equal to the 16-batch loop bit for
   bit with its launches read around it (one ``rp_mask_cache``, one
   ``rp_fused_project``), cold and warm;
5. the JAX backend's threefry matrices drawn on the card
   (``ops/kernels.py``): config 2's sparse matrix (seed 0, 256 × 4096,
   density 1/3) dense and as the split2 mask, a Rademacher matrix at the
   same shape and config 4's Gaussian hyperplanes (seed 7, 256 × 768),
   each held to the same draw on the CPU (bit for bit; the Gaussian within
   its 4 ulps), the float32 sparse matrix to the reference's SHA-256, and
   timed by CUDA events beside its bound; then the same fit on the dense
   route (the threefry matrix, SHA-256 held again) and with
   ``precision='split2'`` (distortion only), and a Gaussian model;
6. the streamed main path: ``transform_stream`` over a host source (one
   65,536 x 4096 template rolled a row a batch, the reader of the CLI's
   ``stream-bench``) for 8 batches with a checkpoint, cut after 3 batches
   and resumed: bit-identical to an uninterrupted run; then phase 4's
   model over 2^19 host rows in 65,536-row batches serial, through
   ``PrefetchSource(depth=2, prepare=est.prepare_batch)`` and through
   ``StagedIngestSource(workers=4, depth=2, prepare=est.prepare_batch)``,
   in turns (s p t t p s), each with its launches read around it (one
   ``rp_mask_cache`` and one ``rp_fused_project`` a batch), its rows/s,
   ``StreamStats`` stage walls, overlap ratio and queue depth, and the
   host's resident set at peak; the outputs equal bit for bit (SHA-256)
   and batch 0 within ``1e-5·max|Y|`` of the plain version on the card;
   one prefetch turn from a pinned source under ``torch.profiler``, in a
   process of its own: every launch and copy seen, the host-to-device
   copies on a stream other than the projection's, overlapping its
   launches; the three streams broken mid-run and failed
   by a ``FaultInjectionSource`` with telemetry on (every worker joined,
   every span closed, the fault after the serial prefix); and
   ``stream_to_memmap`` through the staged pool cut by a fault and
   resumed, equal to the stream bit for bit;
7. each kernel's time at the main path's shape beside its bound, its plain
   version's time and one PyTorch call's time; ``rp_fused_project`` in all
   three modes (f32 and split2 against ``torch.matmul`` in float32, bf16
   against ``torch.matmul`` of bf16 x and the bf16 mask), split2 at config
   3's shape (one 16,384 x 16,384 -> 512 batch at density 1/128, held to
   its plain version) and, beside
   split2, the port's dense split2 route (``split2_project`` against a
   materialized bf16 mask); split2 with the old and the new mask writer in
   turns; the mask writer's device time in both instantiations beside the
   old writer's and a torch fill of the same output; and
   the chain over 1M rows in three designs (one launch; a launch a block
   sharing one mask cache; that as one CUDA-graph replay);
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
   around a CUDA graph of 20 calls) beside the wrapper's time;
10. durable snapshots and exactly-once ingest (``durable.py``) at config
   4's size: phase 8's 2^24 codes (512 MiB) with a seeded 1% deleted,
   ``save_index``, ``verify_snapshot``, ``load_index``, and ``query_topk``
   of the 2,048 queries on the restored chunks (K4) equal to the live
   index bit for bit; phase 9's 2^20-code LSH index saved and loaded, a
   16-probe query equal to the live one; a ``DurableIngest`` of
   ``SignRandomProjection(256)`` over 2^20 rows of 768 drawn on the card in
   65,536-row batches, a commit every 4 batches, compacted at the end;
   and a child process on the card (``python -m
   randomprojection_tpu_torch.durable --child ... --device cuda``) killed
   at its 6th batch and resumed: codes, manifest checksums and answers
   equal the uninterrupted run's.  Save and load seconds and GB/s and the
   ingest's rows/s are printed; the snapshots live under a scratch
   directory the phase removes.

11. tiered residency (``tiering.py``) at config 4's width: the port's
   ``tier_smoke`` on the card; phase 8's 2^24 codes as 16 chunks of 2^20
   with a budget of 4 (128 MiB hot, 384 MiB cold in pinned host memory, 4x
   over budget) answering ``query_topk`` of the 2,048 queries at m = 16 bit
   for bit like the resident index in turns with it (16 scans and 16
   merges a call, zero fallbacks; q/s of both, the cold fetches' host wall
   and overlap window, H2D GB/s of a pinned chunk, and the share of the
   cold upload hidden: 1 - (tiered wall - the wall of the same calls with
   the cold chunks pre-staged on the card) / the upload time of the cold
   bytes alone, a pair of adjacent turns at a time, unclamped); phase 9's
   2^20 codes as 16 chunks of 2^16 with 4 hot: the disk tier's exact
   answers and the tiered LSH index at probes 4 and 16 on the device rung
   (K5 on the card, the cold candidate rows staged) equal to the resident
   index's device rung in turns with it, and its host rung likewise, a
   forced demote, every chunk promoted (the graphed device rung back,
   dropped at the next demotion), and an injected staging failure
   answering exactly on the fallback counter; and a crash child on the
   card killed at ``mid-demotion@1`` and resumed to the clean run's codes
   and answers;
12. config 5: ``CountSketch(256)`` at hash space 2^20 over 2^19 docs of 100
   tokens drawn from a 50,000-word vocabulary (seed 0, the reference's
   ``measure_config5`` recipe; the one cut is depth, 100M -> 2^19 docs):
   ``TokenSource`` -> ``FeatureHasher`` (the port's murmur3 library) ->
   ``transform_stream`` on the card in 65,536-doc batches, the first batch
   within rtol = atol = 2e-5 of the host float64 transform; ingest tokens/s,
   the device sketch's docs/s (per-batch dispatches, tokens resident) and
   end-to-end docs/s of the serial pipeline and of ``StagedIngestSource``
   (one hash worker a core, each hashing with one thread), every staged
   batch within rtol = atol = 2e-5 of the serial one;
13. the CLI as a subprocess: ``python -m randomprojection_tpu_torch
   stream-bench`` at the streamed main path's shape with 4 ingest workers
   (its JSON line parsed), and ``project`` of a 524,288 x 512 ``.npy``
   killed (SIGKILL) once its cursor holds a batch, resumed through its
   fingerprint sidecar, equal to a one-shot run bit for bit;
14. the bench as a subprocess: ``python -m randomprojection_tpu_torch bench
   --preset full`` (``benchmark.py``: config 2's seven modes through the
   anti-cache harness, configs 1, 3 and 4 with serving, the LSH curve and
   the tiered index, and config 5), its last line read with the bench's
   ``find_compact_line`` (at most 2 KB) and its full record held to the
   limits: the headline mode believable and within the 1e-3 distortion
   budget, no executed rate past the H100 peak of its unit, config 3's
   distortion, config 4's sign mismatch (<= 1e-4), the LSH recall gate and
   the tiered index's parity with zero fallbacks, config 5's first batch
   within 2e-5 of float64; each config's rate printed, config 2's headline
   beside phase 4's main-path rate;
15. the ops planes at config 4's serving width (2^24 codes x 32 B, m =
   16; the one cut is depth, 1B -> 2^24 codes), through the CLI in this
   process: ``loadgen`` (Poisson arrivals, requests of 16, 64 or 256 rows,
   labels tenant-a and tenant-b, seed 0, ``--server-batch 8192
   --server-delay-ms 2``) 3 s at each of 250, 500, 1,000, 2,000 and 4,000
   requests/s, R the highest with every label's p99 within 100 ms, no
   reject and no submit lag; then 10 s at R/2 (one schedule) with no
   live-plane flag (a) and with ``--metrics-port 0 --health 25,tenant-a=10
   --flight-dump --telemetry-jsonl --openmetrics`` (b), a side thread
   scraping ``/metrics`` (parsed, the ``sharded`` latency histogram in it)
   and ``/health`` mid-run, the two legs' per-label p50/p90/p99/p99.9 side
   by side; bursty arrivals (x8 for 1/8 of each second) at the same mean
   against a target every request misses (c): ``/health`` 503 mid-run and
   200 within the 5 s settle, ``health.slo_burn`` firing and cleared in
   the JSONL; on every leg K4 launched one scan and one merge a coalesced
   batch (the warm-up's included; its counts read around the leg), and
   leg (b)'s ``serve.topk.batches`` moved by the same number; ``doctor``
   on (b)'s file renders the latency table and ``doctor --json``'s
   per-label p99 lies within a log2 bucket of loadgen's exact one;
   ``topk-bench`` at 2^24 codes, at 2^20 with ``--probes 4,16`` (device
   rung) and at 2^20 with 4 of its 8 chunks hot (parity, no fallback);
   ``utils.health_smoke`` and ``utils.live_smoke`` on the card, and
   ``recover`` of phase 10's 2^24-code snapshot;
16. config 4 sharded (``benchmark.py`` ``TOPK_BENCH_SHAPES["full"]``'s
   layout, depth cut to 2^24 codes, on the one card): phase 15's corpus
   (seed 0) as ``ShardedSimHashIndex(devices=[card], n_shards=8)`` (8 x
   64 MiB) and a second group of 8, the second replica; 2,048 queries at
   m = 16 equal the one-device ``SimHashIndex`` bit for bit (its ids as
   int64), with K4 launched 8 scans + 8 merges around one call, exactly;
   q/s of the sharded and the one-device index in turns, with the host
   merge's wall (``stats()``); ids offset by 2^31 + 13; a
   ``ShardedTopKServer`` over the 2 replicas with 16 clients (every result
   equals a direct call, both replicas serve); 1% deleted across shard
   boundaries; the snapshot loaded onto 4 shards and as one index; the LSH
   cell's 2^20 planted codes as ``LSHShardedSimHashIndex`` over 8 shards
   (8 bands x 16 bits, tile 64, ``fallback_density=1.0``): full probe
   coverage on 16 queries equals the exact answer on the device rung (2
   K5 + 1 + 1 K4 a shard), and probes 16 give recall@10 beside the
   one-device LSH index's, K5 and K4 counted a shard a tile; the serving
   and ann smokes, ``topk-bench --shards 8 --replicas 2`` and ``loadgen
   --shards 8`` at phase 15's R/2 as subprocesses, their JSONL carrying
   ``serve.shard.batch`` and ``shard.merge`` (loadgen: 8 K4 dispatches a
   batch);
17. config 3 DP x TP (BASELINE.json config 3 at the full scale of
   ``examples/config3_verysparse_tp.py``: 16,384 -> 512 at density
   1/sqrt(d), ``random_state=0``, 131,072-row batches, the reference's
   v5e-8 mesh ``{"data": 4, "feature": 2}`` naming the one card 8 times;
   the one cut is depth, 10M -> 2^20 rows, 8 batches drawn on the card):
   (a) the lazy model through ``TorchBackend(mesh=, feature_axis=)``, each
   batch within ``1e-5·max|Y|`` of the one-device lazy model, one batch's
   launches read around it (8 ``rp_fused_project``, one a position at its
   feature shard's block offset on a column view of the batch, and 2
   ``rp_mask_cache``, one a feature shard), and the same 8 launches each
   writing its own mask (8 + 8) equal bit for bit; the distortion of a
   2,000-row sample; K1 at block offsets 0 and 16 against its plain
   version on 1,024 rows, and timed at a feature shard's shape (32,768 x
   8,192 -> 512) beside its bound, its plain version and a float32
   ``torch.matmul`` of the materialized column shard; (b) lazy DP
   ``{"data": 8}`` equal to one device bit for bit (8 + 1 launches); (c)
   dense TP (the example's default): ``materialize_sharded``'s column
   shards equal the full matrix's columns bit for bit and Y within
   tolerance; (d) split2 TP likewise; (e) rows/s of every route and the
   one-device lazy route in turns (CUDA events and the host clock); (f) a
   two-process gloo job on the card (global mesh ``{"feature": 2, "data":
   1}``, 16,384 rows at full width, the TP reduction crossing the process
   boundary): both ranks' outputs equal bit for bit and within tolerance
   of one process, and ``host_row_range`` streaming through
   ``python -m randomprojection_tpu_torch.examples.multihost`` (2 ranks,
   lazy) whose rows, concatenated, equal one process's bit for bit; (g)
   ``CountSketch(256, mesh=make_mesh({"data": 8}, devices=[card] * 8))`` at
   config 5's shape (2^20 buckets, one 65,536-doc batch of 100 tokens from
   a 50,000-word vocabulary) within rtol = atol = 2e-5 of one device, each
   shard's tokens within one doc's tokens of nnz/8;
18. rplint over the checked-out port: ``python -m
   randomprojection_tpu_torch lint --json --jobs 4`` as a subprocess must
   exit 0 with ``ok`` true; its file count, suppressed findings and wall
   (the linter's own ``wall_s`` beside the subprocess's) on one line.

``python3 chip_smoke.py --scale-out`` runs the build and phase 17 alone.

The kernels' timings are printed as one JSON line.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the card as ``nvidia-smi`` names it.  Every number is printed beside the
card's name and power limit.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
try:
    # the H100's published peaks (NVIDIA's data sheet, at 700 W), the
    # distortion metric, its budget, the LSH tripwire, config 5's
    # tolerance and the planted-neighbour generator: the bench's own, so
    # the two cannot drift
    from randomprojection_tpu_torch.benchmark import (
        BF16_FLOP_PER_S,
        C5_TOL,
        DISTORTION_BUDGET,
        FP32_FLOP_PER_S,
        HBM_BYTES_PER_S,
        INT8_OPS_PER_S,
        LSH_CANDIDATE_FRACTION_GATE,
        LSH_RECALL_GATE,
        PRESETS,
        TIER_BENCH_SHAPES,
        _lsh_flip_bits,
        pdist2,
    )
except ImportError as e:  # reported by main(): this script alone is not the port
    _PORT_MISSING = e
else:
    _PORT_MISSING = None
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
# the mask writer's trouble shapes: one column, a ragged run, float32 rows
# of odd width (single stores), even width (pairs) and d % 4 == 0 (16
# bytes); k of one block row and of 512; seeds past 2^32; block offsets
WRITER_DS, WRITER_KS = (1, 3, 4097, 4099, 4100), (8, 512)
WRITER_SEEDS, WRITER_OFFSETS = (0, 2**32 - 5, 12345678901), (0, 3)
WRITER_TALL = (600_000, 3)  # more rows than the writer's grid: its row loop
CHAIN_STEPS = 16  # TorchBackend(dispatch_steps=16): the 16-batch split
# 32-bit integer ops of one mask entry (3 multiplies by the constants, 3
# xors to combine, the 6-op finalizer, the shift to 24 bits, 2 compares, 2
# selects, the scale), counted on the CUDA cores at their float32 rate
HASH_OPS_PER_ENTRY = 17
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
# full coverage: 4 bands x 8 bits over 2^16 codes in two chunks
FULL_N, FULL_BANDS, FULL_BAND_BITS, FULL_NQ = 1 << 16, 4, 8, 64
REPEATS = 50  # the probe kernel's repeats at its largest trouble shape
# config 2's matrix (seed 0, 256 x 4096, density 1/3, float32) as the JAX
# backend draws it: its nonzeros and the SHA-256 of its C-order bytes,
# computed with jax 0.9.0 on the CPU by
#   k = jax.random.fold_in(jax.random.key(0), 0x5250)
#   R = np.asarray(randomprojection_tpu.ops.kernels.sparse_matrix(
#       k, 256, 4096, 1/3, jnp.float32))
#   hashlib.sha256(R.tobytes()).hexdigest()
THREEFRY_NNZ = 349_665
THREEFRY_SHA = "cd0d88ada17b39e4280c42b32fa89d8358b5619e6ca2b8cb0f8a364bf9cef048"
GAUSS_ULPS = 4  # the Gaussian's stated tolerance (ops/threefry.py)
# 32-bit integer ops of one threefry word (20 rounds of add, two shifts,
# or, xor; 17 key-schedule adds; the xor of the two output words) and of
# its uniform (shift, or, subtract, compare): counted at the float32 rate
THREEFRY_OPS_PER_ENTRY = 100 + 17 + 1 + 4
# a Gaussian entry adds erf_inv: log1p and sqrt (~20), the 8-step Horner
# polynomial as multiply-adds (16), the selects and two multiplies
GAUSS_EXTRA_OPS = 40
# durable ingest at config 4's width: SignRandomProjection(256) over 2^20
# rows of 768 in 65,536-row batches, a commit every 4 batches, the chunks
# folded into one at the end (16 chunks); the crash child dies at its 6th
# batch, after the first commit
INGEST_ROWS, INGEST_SEED, INGEST_COMMIT, INGEST_COMPACT = 1 << 20, 5, 4, 16
KILL_AT, KILL_NTH = "mid-batch", 6
# tiered residency (benchmark.py TIER_BENCH_SHAPES["full"]'s 16 chunks with 4
# hot, 4x over budget), at the serving cell's 2^24 codes and the LSH cell's
# 2^20; the crash child ingests 2^16 rows in 8 chunks and dies at its first
# demotion
TIER_CHUNKS, TIER_HOT = 16, 4
TIER_CRASH_ROWS, TIER_CRASH_BATCH = 1 << 16, 1 << 13
# config 5 (benchmark.py measure_config5): CountSketch(256) at hash space
# 2^20, a 50,000-word vocabulary drawn uniformly with seed 0, 100 tokens a
# doc, 65,536-doc batches; the one cut is depth, 100M -> 2^19 docs (2^20
# until phase 15 came: the script stays within half its time limit)
C5_FEATURES, C5_K, C5_VOCAB, C5_TOKENS, C5_DOCS = 1 << 20, 256, 50_000, 100, 1 << 19
# the streamed main path (config 2 fed from the host): 2^19 rows (2^20
# until phase 15 came) in 65,536-row batches of one template rolled a row a
# batch (the reader of the CLI's stream-bench), serial, prefetched and
# staged, in turns
STREAM_ROWS, STREAM_DEPTH, STREAM_WORKERS = 1 << 19, 2, 4
STREAM_WAYS = ("serial", "prefetch", "staged", "staged", "prefetch", "serial")
STREAM_POOL = 3  # pinned batches of the profiled turn's source
PROFILE_BATCHES = 8
PROFILE_TURN_FLAG = "--profile-stream-turn"  # profile_stream's child
FAULT_AT, MEMMAP_FAULT_AT = 3, 6  # the global batch a fault fires before
# config 3 (very-sparse Li, 16384 -> 512 at density 1/128): K1's batch of
# the bench's harness (benchmark.py CONFIG3_SHAPES["full"])
C3_ROWS, C3_FEATURES, C3_COMPONENTS = 16_384, 16_384, 512
# the bench as a subprocess (benchmark.py run, preset full)
BENCH_TIMEOUT = 600
# the CLI's project leg: a .npy of 524,288 x 512 float32 rows (1 GiB) in
# 8,192-row batches, killed once its cursor has committed a batch
CLI_ROWS, CLI_D, CLI_K, CLI_BATCH = 1 << 19, 512, 64, 8192
# the ops planes (phase 15): loadgen's open-loop rate search at config 4's
# serving width, 3 s a step; the highest rate with every label's p99 within
# 100 ms, no reject and no submit lag is R, and the measured legs run 10 s
# at R/2 (the bursty leg's health plane gets 5 s to clear after it)
OPS_RATES, OPS_STEP_S, OPS_P99_MS = (250, 500, 1000, 2000, 4000), 3, 100
OPS_LEG_S, OPS_SETTLE_S = 10, 5
# the sharded tier (phase 16): phase 15's corpus as 8 shards sharing the
# card (benchmark.py TOPK_BENCH_SHAPES["full"]'s layout), a second group
# of 8 the second replica; ids offset past int32; the server's batches
# capped at one query tile so the replicas both serve; full probe coverage
# of the LSH cell on 16 queries (one shard's tile then holds 2^24 slots);
# loadgen's leg at R/2
SHARDS, SHARD_REPLICAS, SHARD_CALLS = 8, 2, 3
SHARD_OFFSET, SHARD_SERVER_BATCH = 2**31 + 13, 2048
SHARD_FULL_NQ, SHARD_LOADGEN_S = 16, 3
# config 3 DP x TP (phase 17): BASELINE.json config 3 at the full scale of
# examples/config3_verysparse_tp.py (16,384 -> 512 at density 1/sqrt(d),
# random_state 0, 131,072-row batches) on the reference's v5e-8 mesh
# {"data": 4, "feature": 2}, here naming the one card 8 times; the one cut
# is depth, 10M -> 2^20 rows (8 batches drawn on the card from a seed).  The
# two-process job runs 16,384 rows at full width; config 5's sketch one
# 65,536-doc batch over 8 positions
TP_ROWS, TP_BATCH, TP_MESH = 1 << 20, 131_072, {"data": 4, "feature": 2}
TP_TWO_ROWS, TP_TURNS = 16_384, 2
TP_RANK_FLAG = "--tp-rank"  # phase 17's two-process job's rank
SCALE_OUT_FLAG = "--scale-out"  # the build and phase 17 alone

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


class OldWriter:
    """The mask writers as they stood before their redesign
    (``torch_experiments/mask_writer_per_entry.cu``), built beside the port's
    sources: the yardstick of the redesigned writer, timed in the same
    run.  Its launches count nowhere."""

    SRC = ROOT / "torch_experiments" / "mask_writer_per_entry.cu"

    def __init__(self, build_mod):
        import ctypes

        out = build_mod.BUILD_DIR / "libmask_writer_per_entry.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        subprocess.run([build_mod._nvcc(), *build_mod.NVCC_FLAGS, "-o",
                        str(out), str(self.SRC)],
                       check=True, capture_output=True, text=True, timeout=600)
        self.seconds = time.perf_counter() - t0
        self.lib = ctypes.CDLL(str(out))
        p, i64, i32, u32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                            ctypes.c_uint32)
        self.lib.rp_mask_cache_per_entry.argtypes = [
            p, i32, i64, i64, u32, u32, u32, u32, p]
        self.lib.rp_lazy_matrix_per_entry.argtypes = [
            p, i32, i64, u32, u32, u32, u32, ctypes.c_float, p]
        self.lib.rp_mask_cache_per_entry.restype = i32
        self.lib.rp_lazy_matrix_per_entry.restype = i32

    def mask_cache(self, torch, fk, seed, k, d, density, *, block_offset=0,
                   device="cuda"):
        dp = -(-d // fk.STEP_D) * fk.STEP_D
        out = torch.empty((k, dp), dtype=torch.bfloat16, device=device)
        lim_plus, lim_nonzero = fk.mask_limits(density)
        rc = self.lib.rp_mask_cache_per_entry(
            out.data_ptr(), k, d, dp, int(seed) & 0xFFFFFFFF, block_offset,
            lim_plus, lim_nonzero, torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"old mask cache launch failed: CUDA error {rc}")
        return out

    def lazy_matrix(self, torch, fk, seed, k, d, density, *, block_offset=0):
        out = torch.empty((k, d), dtype=torch.float32, device="cuda")
        lim_plus, lim_nonzero = fk.mask_limits(density)
        rc = self.lib.rp_lazy_matrix_per_entry(
            out.data_ptr(), k, d, int(seed) & 0xFFFFFFFF, block_offset,
            lim_plus, lim_nonzero, 1.0 / float(np.sqrt(density * k)),
            torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"old mask writer launch failed: CUDA error {rc}")
        return out


def phase_build(build_mod):
    """Compile every csrc/*.cu at once, one nvcc each, with the old mask
    writer beside them, then load them.  Returns the old writer."""
    from concurrent.futures import ThreadPoolExecutor

    names = sorted(p.stem for p in build_mod.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names) + 1) as pool:
        old = pool.submit(OldWriter, build_mod)
        builds = list(pool.map(build_mod.build, names))
        old = old.result()
    log(f"build: {len(names)} sources and the old mask writer in "
        f"{time.perf_counter() - t0:.2f} s (nvcc -O3 sm_90a, in parallel; "
        f"the old writer {old.seconds:.2f} s)")
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
    return old


def _hold_writer(torch, fk, errs, seed, k, d, off, what=""):
    """Both mask-writer instantiations against their plain versions, bit
    for bit."""
    for name, kernel, plain in (
        ("rp_lazy_matrix", fk.rp_lazy_matrix, fk.lazy_matrix_plain),
        ("rp_mask_cache", fk.rp_mask_cache, fk.mask_cache_plain),
    ):
        got = kernel(seed, k, d, DENSITY, block_offset=off)
        torch.cuda.synchronize()
        want = plain(seed, k, d, DENSITY, block_offset=off, device="cuda")
        errs[name] = max(errs[name],
                         (got.float() - want.float()).abs().max().item())
        check(torch.equal(got, want),
              f"{name} differs from its plain version: seed={seed} k={k} "
              f"d={d} offset={off}")
    if what:
        log(f"mask writer {what} (seed={seed} k={k} d={d} offset={off}): "
            f"rp_lazy_matrix and rp_mask_cache bit-exact")


def phase_kernels(torch, fk, errs, old):
    plan = fk.plan_project(BATCH, N_FEATURES, N_COMPONENTS, "split2",
                           torch.cuda.get_device_properties(0)
                           .multi_processor_count)
    log(f"rp_fused_project plan at {BATCH}x{N_FEATURES}->{N_COMPONENTS} "
        f"split2: {plan} ({plan.smem_bytes} bytes dynamic smem a CTA)")
    for item in (4, 2):
        log(f"mask writer plan at {N_COMPONENTS}x{N_FEATURES}, {item}-byte "
            f"entries: {fk.plan_mask_writer(N_COMPONENTS, N_FEATURES, item)}")
    n_shapes = 0
    for d in WRITER_DS:
        for k in WRITER_KS:
            for seed in WRITER_SEEDS:
                for off in WRITER_OFFSETS:
                    _hold_writer(torch, fk, errs, seed, k, d, off)
                    n_shapes += 1
    log(f"mask writer trouble shapes: d in {WRITER_DS} x k in {WRITER_KS} x "
        f"seeds {WRITER_SEEDS} x offsets {WRITER_OFFSETS}: {n_shapes} shapes, "
        f"rp_lazy_matrix and rp_mask_cache bit-exact at each")
    k, d = WRITER_TALL
    _hold_writer(torch, fk, errs, 5, k, d, 0,
                 f"past the grid's rows (grid_y "
                 f"{fk.plan_mask_writer(k, d, 4).grid_y})")
    # the yardstick: the old writer gives the same bits
    for seed, k, d, off in ((0, 256, 4096, 0), (12345678901, 512, 4099, 3)):
        check(torch.equal(
            old.lazy_matrix(torch, fk, seed, k, d, DENSITY, block_offset=off),
            fk.lazy_matrix_plain(seed, k, d, DENSITY, block_offset=off,
                                 device="cuda")), "the old writer's matrix")
        check(torch.equal(
            old.mask_cache(torch, fk, seed, k, d, DENSITY, block_offset=off),
            fk.mask_cache_plain(seed, k, d, DENSITY, block_offset=off,
                                device="cuda")), "the old writer's mask cache")
    log("old mask writer (the yardstick): bit-exact at 256x4096 and "
        "512x4099 offset 3")
    g = torch.Generator(device="cuda").manual_seed(1)
    for seed, k, d, off in ((0, 256, 4096, 0), (0, 256, 4100, 0),
                            (12345678901, 256, 4096, 3), (0, 512, 16384, 0)):
        _hold_writer(torch, fk, errs, seed, k, d, off, "main-path shape")
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
    Returns the model, its input, the launch count of each kernel in its
    own run and the transform's rows/s."""
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
    ys, ms, issue_ms, segs = _batch_loop(torch, est, X, bounds)
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
        f"{N_ROWS / (ms / 1e3):.1f} rows/s (the loop's host issue "
        f"{issue_ms:.3f} ms; {segs} new allocator segments)")

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
    return est, X, launched, N_ROWS / (ms / 1e3)


def _segments(torch) -> int:
    """Device memory segments torch's caching allocator has taken from the
    driver so far (one ``cudaMalloc`` each)."""
    return torch.cuda.memory_stats().get("segment.all.allocated", 0)


def _timed(torch, run):
    """``run()`` on the card: returns its result, its milliseconds by CUDA
    events (first issue to the last kernel's end), the host's milliseconds
    to issue it (the wall before it waits for the card) and the segments
    torch's caching allocator took from the driver meanwhile (a
    ``cudaMalloc`` each)."""
    torch.cuda.synchronize()
    seg0 = _segments(torch)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = run()
    end.record()
    issue_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    return out, start.elapsed_time(end), issue_ms, _segments(torch) - seg0


def _batch_loop(torch, est, X, bounds):
    """The main path's loop, ``transform`` of each batch of the card's
    rows, under ``_timed``."""
    return _timed(torch, lambda: [est.transform(X[lo:hi]) for lo, hi in bounds])


def _host_api(prof):
    """The CUDA runtime and driver calls a ``torch.profiler`` window saw on
    the host: ``{name: (count, host ms)}``."""
    from torch.autograd import DeviceType

    return {e.key: (e.count, e.cpu_time_total / 1e3)
            for e in prof.key_averages()
            if e.key.startswith("cu")
            and getattr(e, "device_type", None) != DeviceType.CUDA}


def phase_host_split(torch, rpt, fk, est, X, bounds):
    """Where the main path's time beyond its kernels goes.  The 16-batch
    loop in a fresh memory pool (``torch.cuda.MemPool``: the allocator
    cold, so each output is a new segment, a ``cudaMalloc``), then again in
    that pool (warm); the cold loop again under ``torch.profiler`` for the
    host's CUDA API calls; then the same rows as one ``transform`` of a
    model with ``dispatch_steps=16``, the chain, cold and warm in a fresh
    pool, against the loop's output bit for bit, its launches read around
    each call."""
    from torch.profiler import ProfilerActivity, profile

    def report(what, ms, issue, segs):
        log(f"host split: {what}: {ms:.3f} ms ({issue:.3f} ms host issue, "
            f"{segs} new allocator segments)")

    def empty():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    pool = torch.cuda.MemPool()
    with torch.cuda.use_mem_pool(pool):
        ys, *cold = _batch_loop(torch, est, X, bounds)
        report("the 16-batch loop in a fresh memory pool (allocator cold)",
               *cold)
        del ys
        ys, *warm = _batch_loop(torch, est, X, bounds)
        report("the loop again in that pool (allocator warm)", *warm)
        Y = torch.cat(ys)
        del ys
    del pool
    empty()
    pool = torch.cuda.MemPool()
    with torch.cuda.use_mem_pool(pool), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ys, *profiled = _batch_loop(torch, est, X, bounds)
    del ys, pool
    empty()
    report("the loop in a fresh pool under the profiler", *profiled)
    api = sorted(_host_api(prof).items(), key=lambda kv: -kv[1][1])
    log("host split: the profiled loop's host CUDA API calls (count, host "
        "ms): " + ", ".join(f"{k} x{c} {t:.3f}" for k, (c, t) in api[:12]))
    chain = rpt.SparseRandomProjection(
        N_COMPONENTS, density=DENSITY, random_state=0,
        backend_options={"materialization": "lazy",
                         "dispatch_steps": CHAIN_STEPS},
    ).fit(X)
    pool = torch.cuda.MemPool()
    with torch.cuda.use_mem_pool(pool):
        for label in ("in a fresh pool (allocator cold)", "again (warm)"):
            fk.reset_launches()
            Yc, *run = _timed(torch, lambda: chain.transform(X))
            launched = dict(fk.LAUNCHES)
            check(launched == {"rp_fused_project": 1, "rp_mask_cache": 1,
                               "rp_lazy_matrix": 0},
                  f"the chain launched {launched}, want one mask cache and one "
                  f"persistent launch")
            check(torch.equal(Yc, Y), "the chain differs from the 16-batch loop")
            del Yc
            report(f"the chain, one transform of {N_ROWS} rows at "
                   f"dispatch_steps={CHAIN_STEPS} ("
                   f"{fk.multistep_chain_length(N_ROWS, CHAIN_STEPS)} row "
                   f"blocks), {label}; launches {json.dumps(launched)}, equal "
                   f"to the 16-batch loop bit for bit", *run)
    del Y, pool
    empty()


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
        if label == "dense":
            R = est.components_as_numpy()
            sha = hashlib.sha256(np.ascontiguousarray(R).tobytes()).hexdigest()
            check(sha == THREEFRY_SHA and np.count_nonzero(R) == THREEFRY_NNZ,
                  "the dense route's matrix is not the JAX backend's")
            log("route dense: the matrix is the JAX backend's threefry "
                "matrix (SHA-256 equal)")
        eps = distortion(est, sample)
        log(f"route {label}: distortion {eps:.3e} (budget {DISTORTION_BUDGET})")
        check(eps <= DISTORTION_BUDGET, f"{label} distortion over budget")


def wall_ms(torch, fn, reps: int = 5) -> float:
    """Median host milliseconds of ``fn`` through to the card's finish."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def phase_threefry(torch):
    """The JAX backend's threefry matrices drawn on the card: config 2's
    sparse matrix dense and as the split2 mask, a Rademacher matrix at the
    same shape and config 4's Gaussian hyperplanes, each held to the same
    draw on the CPU (bit for bit; the Gaussian within its ulps) and timed
    by CUDA events beside its bound.  Beside each, the fit route it
    replaced: the numpy stream's matrix drawn on the host (``host_matrix``)
    and uploaded, on the host's clock as the draw is."""
    from randomprojection_tpu_torch.backends.base import ProjectionSpec
    from randomprojection_tpu_torch.backends.numpy_backend import host_matrix
    from randomprojection_tpu_torch.backends.torch_backend import TorchBackend
    from randomprojection_tpu_torch.ops import kernels, threefry

    def key(seed, device):
        return threefry.fold_in(threefry.seed_key(seed, device), 0x5250)

    def ulps(a, b):
        a = a.float().cpu().numpy().view(np.int32).astype(np.int64)
        b = b.float().cpu().numpy().view(np.int32).astype(np.int64)
        return int(np.abs(a - b).max())

    split_spec = ProjectionSpec("sparse", N_COMPONENTS, N_FEATURES, 0,
                                density=DENSITY, dtype="float32")

    def split2(device):
        return TorchBackend(device=device, precision="split2").materialize(
            split_spec).mask

    def dense_host(R):
        return R.toarray() if hasattr(R, "toarray") else R

    def uploaded(kind, k, d, seed):
        spec = ProjectionSpec(kind, k, d, seed, dtype="float32",
                              **({"density": DENSITY} if kind == "sparse"
                                 else {}))
        return lambda: torch.from_numpy(np.ascontiguousarray(
            dense_host(host_matrix(spec)), dtype=np.float32)).to("cuda")

    def split2_uploaded():
        R = dense_host(host_matrix(split_spec))
        return TorchBackend(device="cuda", precision="split2").split_state(
            np.sign(R), 1.0 / np.sqrt(DENSITY * N_COMPONENTS)).mask

    k, d = N_COMPONENTS, N_FEATURES
    host_routes = {
        "sparse": uploaded("sparse", k, d, 0), "split2": split2_uploaded,
        "rademacher": uploaded("rademacher", k, d, 0),
        "gaussian": uploaded("gaussian", SIGN_BITS, SIGN_FEATURES, 7),
    }
    draws = (
        ("sparse 256x4096 float32 (config 2, seed 0)",
         lambda dev: kernels.sparse_matrix(key(0, dev), k, d, DENSITY),
         4, THREEFRY_OPS_PER_ENTRY, 0),
        ("split2 mask 256x4096 bf16 (config 2, seed 0)", split2,
         2, THREEFRY_OPS_PER_ENTRY + 1, 0),
        ("rademacher 256x4096 float32 (seed 0)",
         lambda dev: kernels.rademacher_matrix(key(0, dev), k, d),
         4, THREEFRY_OPS_PER_ENTRY, 0),
        (f"gaussian {SIGN_BITS}x{SIGN_FEATURES} float32 (config 4, seed 7)",
         lambda dev: kernels.gaussian_matrix(key(7, dev), SIGN_BITS,
                                             SIGN_FEATURES),
         4, THREEFRY_OPS_PER_ENTRY + GAUSS_EXTRA_OPS, GAUSS_ULPS),
    )
    rows = []
    for label, fn, item, ops, tol in draws:
        card = fn("cuda")
        torch.cuda.synchronize()
        check(card.is_cuda, f"{label}: not drawn on the card")
        cpu = fn("cpu")
        if tol:
            err = ulps(card, cpu)
            check(err <= tol, f"{label}: {err} ulps from the CPU")
            held = f"within {err} ulps of the CPU (tolerance {tol})"
        else:
            check(torch.equal(card.cpu(), cpu), f"{label}: differs from the CPU")
            held = "bit for bit the CPU's"
        if label.startswith("sparse"):
            R = card.cpu().numpy()
            sha = hashlib.sha256(np.ascontiguousarray(R).tobytes()).hexdigest()
            check(sha == THREEFRY_SHA and np.count_nonzero(R) == THREEFRY_NNZ,
                  "config 2's matrix is not the reference's (SHA-256)")
            held += ", SHA-256 the reference's"
        ms = cuda_ms(lambda: fn("cuda"), reps=5)
        wall = wall_ms(torch, lambda: fn("cuda"))
        host = wall_ms(torch, host_routes[label.split()[0]])
        n = card.numel()
        row = {"draw": label, "ms": ms, "wall_ms": wall,
               "host_draw_upload_ms": host,
               **_bound(n * item / HBM_BYTES_PER_S, n * ops / FP32_FLOP_PER_S)}
        rows.append(row)
        log(f"threefry {label}: {held}; {ms:.3f} ms of device time, "
            f"{wall:.3f} ms on the host's clock (bound {row['bound_ms']:.5f} "
            f"ms by {row['bound_by']}); the numpy stream drawn on the host "
            f"and uploaded {host:.3f} ms")
    log(f"threefry draws {json.dumps(rows)}")


def stream_template():
    """The streamed phases' template: one 65,536 x 4096 batch of standard
    normals from seed 0 (the CLI's stream-bench template), 1 GiB."""
    t0 = time.perf_counter()
    t = np.random.default_rng(0).standard_normal((BATCH, N_FEATURES),
                                                 dtype=np.float32)
    log(f"stream template {BATCH}x{N_FEATURES} float32 drawn in "
        f"{time.perf_counter() - t0:.3f} s")
    return t


def template_source(streaming, template, n_rows):
    from randomprojection_tpu_torch.cli import template_roll_reader

    return streaming.CallableSource(template_roll_reader(template, BATCH),
                                    n_rows, N_FEATURES, np.float32,
                                    batch_rows=BATCH)


def phase_stream(est, streaming, scratch: Path, template):
    n = STREAM_BATCHES * BATCH
    src = template_source(streaming, template, n)
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


def _rss() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


class RssPeak:
    """This process's resident set while the block runs: VmRSS sampled
    every 5 ms (pinned host memory counts)."""

    def __enter__(self):
        self.base = self.peak = _rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True,
                                        name="chip-smoke-rss")
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(0.005):
            self.peak = max(self.peak, _rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, _rss())


def _ingest_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith(("rp-torch-prefetch", "rp-torch-staged"))]


def _ingest(streaming, way, src, est, stats=None):
    if way == "prefetch":
        return streaming.PrefetchSource(src, depth=STREAM_DEPTH,
                                        prepare=est.prepare_batch, stats=stats)
    if way == "staged":
        return streaming.StagedIngestSource(
            src, workers=STREAM_WORKERS, depth=STREAM_DEPTH,
            prepare=est.prepare_batch, stats=stats)
    return src


def _stream_once(fk, streaming, est, src, way, keep_first=False):
    """One streamed turn through ``stream_transform``: the SHA-256 of the
    output, rows/s, the StreamStats summary, the host's resident set and
    the launches read around the run."""
    from randomprojection_tpu_torch.utils.observability import StreamStats

    stats = StreamStats()
    src.stats = stats  # the reader's wall is the 'read' stage
    h = hashlib.sha256()
    first = None
    fk.reset_launches()
    with RssPeak() as rss:
        t0 = time.perf_counter()
        for lo, y in est.transform_stream(_ingest(streaming, way, src, est,
                                                  stats), stats=stats):
            check(y.shape == (BATCH, N_COMPONENTS) and y.dtype == np.float32
                  and bool(np.isfinite(y).all()),
                  f"{way}: batch at row {lo} is {y.shape} {y.dtype} or not "
                  f"finite")
            h.update(y)
            if keep_first and lo == 0:
                first = y.copy()
        wall = time.perf_counter() - t0
    src.stats = None
    launched = dict(fk.LAUNCHES)
    check(not _ingest_threads(), f"{way}: threads left {_ingest_threads()}")
    n_batches = src.n_rows // BATCH
    check(launched["rp_fused_project"] == n_batches == launched["rp_mask_cache"],
          f"{way}: launches {launched} for {n_batches} batches")
    return {"way": way, "sha": h.hexdigest(), "rows_per_s": src.n_rows / wall,
            "wall_s": wall, "summary": stats.summary(), "launches": launched,
            "rss_base_gib": rss.base / 2**30, "rss_peak_gib": rss.peak / 2**30,
            "first": first}


def phase_stream_main(torch, fk, streaming, est, template):
    """The streamed main path at config 2's width: 2^19 host rows through
    ``stream_transform`` serial, through ``PrefetchSource(depth=2,
    prepare=est.prepare_batch)`` and through ``StagedIngestSource(
    workers=4, depth=2, prepare=est.prepare_batch)`` in turns, each with
    the launches read around it; the outputs equal bit for bit (SHA-256),
    the first batch held to the plain version on the card."""
    src = template_source(streaming, template, STREAM_ROWS)
    runs = []
    for i, way in enumerate(STREAM_WAYS):
        r = _stream_once(fk, streaming, est, src, way, keep_first=i == 0)
        runs.append(r)
        sm = r["summary"]
        log(f"streamed main path, {way}: {STREAM_ROWS} rows of {N_FEATURES} "
            f"-> {N_COMPONENTS} in {STREAM_ROWS // BATCH} batches of {BATCH}: "
            f"{r['rows_per_s']:.1f} rows/s ({r['wall_s']:.3f} s); stage walls "
            f"{json.dumps(sm.get('stage_wall_s'))}, overlap ratio "
            f"{sm.get('pipeline_overlap_ratio')}, queue depth max "
            f"{sm.get('queue_depth_max', '-')}; host RSS {r['rss_base_gib']:.2f} "
            f"-> peak {r['rss_peak_gib']:.2f} GiB; launches "
            f"{json.dumps(r['launches'])}; sha256 {r['sha'][:16]}")
    check(len({r["sha"] for r in runs}) == 1,
          "the streamed outputs differ: " + ", ".join(
              f"{r['way']} {r['sha'][:16]}" for r in runs))
    ref = fk.fused_project(torch.from_numpy(template).cuda(), est.spec_.seed,
                           N_COMPONENTS, est.spec_.density, mxu_mode="split2")
    want = ref.cpu().numpy()
    err = float(np.abs(runs[0]["first"] - want).max())
    scale = float(np.abs(want).max())
    check(err <= TOL * scale, f"streamed batch 0 off the plain version: {err}")
    log(f"streamed main path: serial, prefetch and staged equal bit for bit "
        f"(sha256 {runs[0]['sha']}); batch 0 vs the plain version on the "
        f"card max|d|={err:.3e} max|Y|={scale:.3e} (tol {TOL})")
    launches = {r["way"]: r["launches"] for r in runs[:3]}
    return runs[0]["sha"], runs[0]["first"], launches


def profile_stream(first):
    """One prefetch turn under ``torch.profiler``, in a process of its own
    (``chip_smoke.py --profile-stream-turn``, ``profile_stream_turn``):
    in this process, after the earlier phases and their profiler windows,
    the profiler lost some device records of the turn (7 of 8 launches and
    4 of 8 copies in one run, 6 of 8 copies in another), where a fresh
    process saw every one in 6 turns of 6
    (``torch_experiments/stream_profile_events.py``).  The turn's batch 0
    must equal the stream's."""
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                        PROFILE_TURN_FLAG], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    check(r.returncode == 0, f"the profiled turn failed (rc {r.returncode}):"
          f"\n{r.stdout[-4000:]}\n{r.stderr[-4000:]}")
    lines = r.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(line, flush=True)  # the child's log, the card beside it
    res = json.loads(lines[-1])
    check(res["first_sha"] == hashlib.sha256(first).hexdigest(),
          "the pinned source's batch 0 differs from the stream's")
    return res


def profile_stream_turn() -> int:
    """The child of ``profile_stream``: the phase-4 model over
    ``PROFILE_BATCHES`` batches from a source that hands out pinned batches
    (a pool of rolls of the template, so the worker issues its copies
    ahead of the consumer) through ``PrefetchSource(depth=2,
    prepare=est.prepare_batch)`` under the profiler.  Every launch and
    every copy must be seen, the copies on a stream other than the
    projection's, overlapping its launches.  Prints its log line, then
    one JSON line."""
    global CARD
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import randomprojection_tpu_torch as rpt
    from randomprojection_tpu_torch import streaming
    from randomprojection_tpu_torch.ops import fused_kernels as fk

    CARD = card_line()
    template = stream_template()
    est = rpt.SparseRandomProjection(
        N_COMPONENTS, density=DENSITY, random_state=0,
        backend_options={"materialization": "lazy"},
    ).fit(template)
    est.transform(np.negative(template[:BATCH]))  # load the kernels
    pool = [torch.from_numpy(np.roll(template, -i, axis=0)).pin_memory()
            for i in range(STREAM_POOL)]

    def read(lo, hi):
        return pool[(lo // BATCH) % STREAM_POOL][: hi - lo]

    n_rows = PROFILE_BATCHES * BATCH
    src = streaming.CallableSource(read, n_rows, N_FEATURES, np.float32,
                                   batch_rows=BATCH)
    first_sha = None
    fk.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for lo, y in est.transform_stream(_ingest(streaming, "prefetch", src,
                                                  est)):
            if lo == 0:
                first_sha = hashlib.sha256(y).hexdigest()
        wall = time.perf_counter() - t0
    check(fk.LAUNCHES["rp_fused_project"] == PROFILE_BATCHES,
          f"profiled turn launched {fk.LAUNCHES}")
    check(not _ingest_threads(), "profiled turn left threads")
    del pool
    dev = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    # the batches' copies (65,536 x 4096 float32 each, milliseconds),
    # not a scalar's
    h2d = [(e.start_ns(), e.end_ns(), e.device_resource_id()) for e in dev
           if "HtoD" in e.name() and e.duration_ns() > 1_000_000]
    k1 = [(e.start_ns(), e.end_ns(), e.device_resource_id()) for e in dev
          if "fused_project_kernel" in e.name()]
    check(len(k1) == PROFILE_BATCHES == len(h2d),
          f"the profiler saw {len(k1)} projection kernels and {len(h2d)} "
          f"host-to-device copies of {PROFILE_BATCHES}")
    copy_streams = {c[2] for c in h2d}
    k1_streams = {k[2] for k in k1}
    check(not copy_streams & k1_streams,
          f"copies on streams {copy_streams}, the projection on {k1_streams}")
    overlapped = [k for k in k1 if any(c[0] < k[1] and k[0] < c[1]
                                       for c in h2d)]
    overlap_ns = sum(max(0, min(c[1], k[1]) - max(c[0], k[0]))
                     for k in k1 for c in h2d)
    k1_ns = sum(k[1] - k[0] for k in k1)
    h2d_ns = sum(c[1] - c[0] for c in h2d)
    check(overlapped, "no projection launch overlapped a host-to-device copy")
    log(f"stream profile (a process of its own): a prefetch turn of "
        f"{PROFILE_BATCHES} pinned batches, {wall:.3f} s under the profiler; "
        f"{len(h2d)} host-to-device copies on stream(s) "
        f"{sorted(copy_streams)} ({h2d_ns / 1e6:.3f} ms, "
        f"{BATCH * N_FEATURES * 4 * len(h2d) / h2d_ns:.3f} "
        f"GB/s), {len(k1)} rp_fused_project launches on stream(s) "
        f"{sorted(k1_streams)} ({k1_ns / 1e6:.3f} ms); {len(overlapped)} of "
        f"them overlapped a copy, {overlap_ns / 1e6:.3f} ms of kernel time "
        f"under copies")
    print(json.dumps({"first_sha": first_sha,
                      "copy_streams": sorted(copy_streams),
                      "k1_streams": sorted(k1_streams),
                      "overlapped_launches": len(overlapped)}), flush=True)
    return 0


def phase_stream_faults(fk, streaming, est, template, scratch: Path,
                        want_sha: str):
    """Break and fault the three streams with telemetry on: every worker
    joined, every span closed, a fault reaching the consumer after the
    serial prefix; then ``stream_to_memmap`` through the staged pool cut by
    a fault and resumed, equal to the uninterrupted stream bit for bit."""
    from randomprojection_tpu_torch.utils import telemetry

    src = template_source(streaming, template, STREAM_ROWS)
    log_path = scratch / "stream_events.jsonl"
    telemetry.configure(str(log_path))
    prefix = None
    try:
        for way in ("serial", "prefetch", "staged"):
            for i, _ in enumerate(est.transform_stream(
                    _ingest(streaming, way, src, est))):
                if i == 2:
                    break
            check(not _ingest_threads(), f"{way} break left threads")
            faulty = streaming.FaultInjectionSource(src, FAULT_AT)
            got = []
            try:
                for lo, _ in est.transform_stream(
                        _ingest(streaming, way, faulty, est)):
                    got.append(lo)
            except streaming.FaultInjectionSource.InjectedFault:
                pass
            else:
                check(False, f"{way}: the injected fault did not arrive")
            check(not _ingest_threads(), f"{way} fault left threads")
            prefix = got if prefix is None else prefix
            check(got == prefix and got,
                  f"{way}: batches {got} before the fault, serial {prefix}")
    finally:
        telemetry.shutdown()
    starts, ends, roots, abandoned = set(), set(), 0, 0
    with open(log_path) as f:
        for line in f:
            e = telemetry.parse_event(line)
            if e["event"] == "span_start":
                starts.add(e["span_id"])
                roots += e["parent_id"] is None
            elif e["event"] == "span_end":
                ends.add(e["span_id"])
                abandoned += bool(e.get("abandoned"))
    check(starts == ends, f"{len(starts - ends)} span(s) never ended, "
          f"{len(ends - starts)} ended unopened")
    log(f"stream break and fault: serial, prefetch and staged each broken "
        f"after 3 batches and failed before batch {FAULT_AT} (rows {prefix} "
        f"reached the consumer first, in every way); every worker joined; "
        f"{len(starts)} spans opened and closed, {roots} batch traces, "
        f"{abandoned} closed as abandoned")

    out, ckpt = scratch / "stream.npy", scratch / "stream.cursor"
    ckpt.unlink(missing_ok=True)
    faulty = streaming.FaultInjectionSource(src, MEMMAP_FAULT_AT)
    pool = _ingest(streaming, "staged", faulty, est)
    t0 = time.perf_counter()
    try:
        streaming.stream_to_memmap(est, pool, str(out),
                                   checkpoint_path=str(ckpt))
    except streaming.FaultInjectionSource.InjectedFault:
        pass
    else:
        check(False, "stream_to_memmap: the injected fault did not arrive")
    cut = streaming.StreamCursor.load(str(ckpt)).rows_done
    check(0 < cut < STREAM_ROWS, f"memmap cursor after the cut: {cut}")
    faulty.disarm()
    mm = streaming.stream_to_memmap(est, pool, str(out),
                                    checkpoint_path=str(ckpt))
    wall = time.perf_counter() - t0
    sha = hashlib.sha256(np.ascontiguousarray(mm)).hexdigest()
    del mm
    check(sha == want_sha, "stream_to_memmap resumed differs from the stream")
    out.unlink()
    log(f"stream_to_memmap through the staged pool: cut at row {cut}, "
        f"resumed, {STREAM_ROWS} rows equal to the uninterrupted stream bit "
        f"for bit ({wall:.3f} s with the cut)")


def phase_cli(scratch: Path):
    """The CLI as a subprocess: ``stream-bench`` at the streamed main
    path's shape, and ``project`` of a ``.npy`` killed mid-run (SIGKILL
    once its cursor holds a batch) and resumed through its sidecar, equal
    to a one-shot run bit for bit."""
    import signal

    cmd = [sys.executable, "-m", "randomprojection_tpu_torch"]
    bench = [*cmd, "stream-bench", "--rows", str(STREAM_ROWS), "--batch-rows",
             str(BATCH), "--d", str(N_FEATURES), "--k", str(N_COMPONENTS),
             "--kind", "sparse", "--density", "0.3333333",
             "--materialization", "lazy", "--precision", "split2",
             "--ingest-workers", str(STREAM_WORKERS)]
    r = subprocess.run(bench, cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    check(r.returncode == 0, f"stream-bench exited {r.returncode}: "
          f"{r.stderr[-2000:]}")
    out = json.loads(r.stdout.strip().splitlines()[-1])
    check(out["rows"] == STREAM_ROWS and out["value"] > 0
          and out["ingest_workers"] == STREAM_WORKERS,
          f"stream-bench printed {out}")
    log(f"cli stream-bench (subprocess, {out['device']}): {out['value']} "
        f"rows/s, stage walls {json.dumps(out.get('stage_wall_s'))}, overlap "
        f"{out.get('pipeline_overlap_ratio')}, queue depth max "
        f"{out.get('queue_depth_max')}")

    x = scratch / "cli_x.npy"
    np.save(x, np.random.default_rng(3).normal(
        size=(CLI_ROWS, CLI_D)).astype(np.float32))
    common = ["--input", str(x), "--kind", "sparse", "--n-components",
              str(CLI_K), "--density", "0.3333333", "--materialization",
              "lazy", "--precision", "split2", "--batch-rows", str(CLI_BATCH),
              "--ingest-workers", "2"]
    one = scratch / "cli_one.npy"
    r = subprocess.run([*cmd, "project", "--output", str(one), *common],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    check(r.returncode == 0, f"project exited {r.returncode}: {r.stderr[-2000:]}")
    cut_out, ckpt = scratch / "cli_cut.npy", scratch / "cli_cut.cursor"
    ckpt.unlink(missing_ok=True)
    argv = [*cmd, "project", "--output", str(cut_out), "--checkpoint",
            str(ckpt), *common]
    proc = subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE)
    done = 0
    try:
        deadline = time.perf_counter() + 300
        while proc.poll() is None and time.perf_counter() < deadline:
            try:
                done = json.loads(ckpt.read_text())["rows_done"]
            except (FileNotFoundError, ValueError):
                done = 0
            if done > 0:
                proc.send_signal(signal.SIGSTOP)
                break
            time.sleep(0.002)
    finally:
        proc.kill()
        proc.wait()
    done = json.loads(ckpt.read_text())["rows_done"]
    check(0 < done < CLI_ROWS, f"project was not cut mid-run (cursor {done}, "
          f"rc {proc.returncode})")
    r = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    check(r.returncode == 0, f"resumed project exited {r.returncode}: "
          f"{r.stderr[-2000:]}")
    resumed = json.loads(r.stdout.strip().splitlines()[-1])
    check(resumed["rows"] == CLI_ROWS - done, f"resume streamed {resumed}")
    check(np.array_equal(np.load(cut_out), np.load(one)),
          "project killed and resumed differs from the one-shot run")
    for f in (x, one, cut_out):
        f.unlink()
    log(f"cli project: {CLI_ROWS}x{CLI_D} -> {CLI_K} killed (SIGKILL) with "
        f"{done} rows committed, resumed through the sidecar "
        f"({resumed['rows']} rows), equal to the one-shot run bit for bit")


def phase_bench_shapes(torch, fk, tk, errs) -> None:
    """The kernels at the bench's own shapes, against their plain
    versions: K1 at config 2's 131,072 x 4096 -> 256 harness batch in each
    mode its ``lazy*`` modes run (``lazy_f32_bf16data`` is the f32 mode on
    bf16-rounded values), within ``TOL·max|Y|``; K4 at a tiered chunk (256
    queries x 2^16 codes x 32 B, m = 10), bit for bit."""
    n = PRESETS["full"]["batch"]
    g = torch.Generator(device="cuda").manual_seed(11)
    x = torch.empty((n, N_FEATURES), dtype=torch.float32, device="cuda")
    x.normal_(generator=g)
    for what, mode, xin in (
            ("lazy", "f32", x), ("lazy_split2", "split2", x),
            ("lazy_bf16", "bf16", x.to(torch.bfloat16)),
            ("lazy_f32_bf16data", "f32", x.to(torch.bfloat16).float())):
        y = fk.rp_fused_project(xin, 0, N_COMPONENTS, DENSITY, mxu_mode=mode)
        want = fk.fused_project(xin, 0, N_COMPONENTS, DENSITY, mxu_mode=mode)
        err = (y - want).abs().max().item()
        scale = want.abs().max().item()
        errs["rp_fused_project"] = max(errs["rp_fused_project"], err)
        check(bool(torch.isfinite(y).all()) and err <= TOL * scale,
              f"rp_fused_project at the bench's {what} shape off its plain "
              f"version by {err:.3e} (max|Y| {scale:.3e})")
        log(f"rp_fused_project at the bench's {what} shape {n}x{N_FEATURES}"
            f"->{N_COMPONENTS} {mode}: max|d|={err:.3e} max|Y|={scale:.3e} "
            f"ratio={err / scale:.3e} (tol {TOL})")
        del y, want, xin
    del x
    torch.cuda.empty_cache()
    shape = TIER_BENCH_SHAPES["full"]
    rng = np.random.default_rng(19)
    rows, nb, nq, m = (shape["chunk_rows"], shape["n_bytes"], shape["q_tile"],
                       shape["m"])
    c = torch.from_numpy(rng.integers(0, 256, size=(rows, nb),
                                      dtype=np.uint8)).cuda()
    q = torch.from_numpy(rng.integers(0, 256, size=(nq, nb),
                                      dtype=np.uint8)).cuda()
    _hold(torch, tk, errs, tk.rp_fused_topk(q, c, rows, m),
          tk.topk_plain(q, c, rows, m),
          f"rp_fused_topk at the bench's tiered chunk ({nq}x{rows}x{nb}B "
          f"m={m})")


# the bench's legs that launch kernels, by the record's path to each
# leg's ``launches``
BENCH_LEGS = {
    "lazy_matrix": ("lazy_matrix_launches",),
    "config3": ("config3", "launches"),
    "config4_encode": ("config4", "launches"),
    "serving": ("config4", "topk_serving", "launches"),
    "lsh": ("config4", "topk_serving", "lsh", "launches"),
    "tiered": ("config4", "topk_serving", "tiered", "launches"),
    "tiered_resident": ("config4", "topk_serving", "tiered",
                        "resident_launches"),
    "sharded": ("config4", "topk_serving", "sharded", "launches"),
}


def _bench_launches(rec, bm) -> dict:
    """Each leg's launches from the bench's record (each set to 0 just
    before its leg and read just after, in the bench's process), checked:
    a ``lazy*`` mode launches the mask cache and K1 once a harness step and
    once for its distortion sample, the dense modes and config 4's encode
    none, K3 once for the lazy modes' reference and once in config 3,
    and every serving leg K4 (a merge a scan), the LSH curve K5 too."""
    legs = {}
    steps, calls = rec["dispatch_steps"], PRESETS["full"]["calls"]
    for name, mode in rec["all_modes"].items():
        n = steps * (calls + 1) + 1
        want = ({"rp_fused_project": n, "rp_mask_cache": n}
                if name.startswith("lazy") else {})
        check(mode["launches"] == want,
              f"bench mode {name} launched {mode['launches']}, not {want}")
        legs[name] = mode["launches"]
    for leg, path in BENCH_LEGS.items():
        got = rec
        for key in path:
            got = got[key]
        legs[leg] = got
    c3 = bm.CONFIG3_SHAPES["full"]
    n3 = c3["steps"] * (c3["calls"] + 1) + 1
    for leg, want in (("lazy_matrix", {"rp_lazy_matrix": 1}),
                      ("config3", {"rp_fused_project": n3,
                                   "rp_mask_cache": n3, "rp_lazy_matrix": 1}),
                      ("config4_encode", {})):
        check(legs[leg] == want,
              f"bench {leg} launched {legs[leg]}, not {want}")
    for leg in ("serving", "lsh", "tiered", "tiered_resident", "sharded"):
        got = legs[leg]
        scans = (got.get("rp_fused_topk_wgmma", 0)
                 + got.get("rp_fused_topk_popc", 0))
        check(got.get("rp_fused_topk_wgmma", 0) > 0
              and got.get("rp_topk_merge", 0) == scans,
              f"bench {leg} launched {got}")
    check(legs["lsh"].get("rp_probe", 0) > 0,
          f"bench LSH curve launched no rp_probe: {legs['lsh']}")
    sh = rec["config4"]["topk_serving"]["sharded"]
    check(legs["sharded"]["rp_fused_topk_wgmma"] % sh["shards"] == 0
          and legs["sharded"]["rp_fused_topk_wgmma"] >= sh["shard_dispatches"],
          f"bench sharded leg launched {legs['sharded']} for "
          f"{sh['shard_dispatches']} timed shard dispatches")
    return legs


def phase_bench(kind: str, main_rate: float) -> dict:
    """The bench as a subprocess: ``python -m randomprojection_tpu_torch
    bench --preset full``, its last line read with the bench's own
    ``find_compact_line`` and its full record (the line before) held to
    the limits: the headline mode believable and within the distortion
    budget, no executed rate past its unit's peak, config 3's distortion,
    config 4's sign mismatch, the LSH recall gate and the tiered index's
    parity with zero fallbacks, and config 5's first batch; and each leg's
    kernel launches (``_bench_launches``), which it returns."""
    from randomprojection_tpu_torch import benchmark as bm

    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "randomprojection_tpu_torch", "bench",
         "--preset", "full"],
        cwd=ROOT, capture_output=True, text=True, timeout=BENCH_TIMEOUT)
    wall = time.perf_counter() - t0
    check(r.returncode == 0, f"bench exited {r.returncode}: {r.stderr[-3000:]}")
    lines = r.stdout.strip().splitlines()
    compact = bm.find_compact_line(lines[-1])
    size = len(lines[-1].encode())
    check(compact is not None and size <= bm.COMPACT_MAX_BYTES,
          f"bench's last line is not a compact line of <= "
          f"{bm.COMPACT_MAX_BYTES} bytes ({size} bytes)")
    rec = json.loads(lines[-2])
    head = rec["all_modes"][rec["mode"]]
    check(compact["mode"] == rec["mode"] and compact["timing_suspect"]
          is head["timing_suspect"], "compact line and record disagree")
    check(head["distortion"] <= DISTORTION_BUDGET
          and not head["timing_suspect"],
          f"bench headline {rec['mode']} distortion {head['distortion']} "
          f"suspect {head['timing_suspect']}")

    def within_peak(what, row):
        peak = bm.PEAKS[row["executed_on"]] / 1e12
        check(row["executed_tflops"] <= peak,
              f"{what} executed {row['executed_tflops']} TFLOP/s past the "
              f"{row['executed_on']} peak {peak}")

    for name, mode in rec["all_modes"].items():
        within_peak(f"mode {name}", mode)
    c3, c4, c5 = rec["config3"], rec["config4"], rec["config5"]
    tk = c4["topk_serving"]
    for what, row in (("config3", c3), ("config4", c4), ("serving", tk)):
        within_peak(what, row)
    within_peak("single-stream serving", dict(
        tk, executed_tflops=tk["single_stream_executed_tflops"]))
    within_peak("sharded serving", tk["sharded"])
    check(c3["distortion"] <= DISTORTION_BUDGET,
          f"config 3 distortion {c3['distortion']}")
    check(c4["sign_mismatch_rate_vs_cpu"] <= SIGN_MISMATCH_BUDGET,
          f"config 4 sign mismatch {c4['sign_mismatch_rate_vs_cpu']}")
    lsh, tier = tk["lsh"], tk["tiered"]
    check(lsh["recall_gate_ok"] and all(p["fallbacks"] == 0
                                        for p in lsh["curve"]),
          f"bench LSH curve {json.dumps(lsh['curve'])}")
    check(tier["parity_ok"] and tier["fallbacks"] == 0,
          f"bench tiered parity {tier['parity_ok']} fallbacks "
          f"{tier['fallbacks']}")
    check(c5["first_batch_ok"], f"config 5 first batch off float64 by "
          f"{c5['first_batch_max_abs_err']}")
    check(rec["device"] == kind, f"bench ran on {rec['device']}, not {kind}")
    legs = _bench_launches(rec, bm)
    log(f"bench launches by leg (each set to 0 just before the leg and read "
        f"just after, in the bench's process): {json.dumps(legs)}")
    modes = ", ".join(
        f"{n} {m['rows_per_s']} rows/s (distortion {m['distortion']:.3e}, "
        f"{m['executed_tflops']} TFLOP/s on {m['executed_on']}, "
        f"{m['mxu_utilization']:.1%} of peak, suspect {m['timing_suspect']})"
        for n, m in rec["all_modes"].items())
    log(f"bench --preset full (subprocess, {wall:.1f} s, device "
        f"{rec['device']}); compact line {size} bytes")
    log(f"bench config 2 modes: {modes}")
    log(f"bench config 2 headline {rec['mode']}: {rec['value']} rows/s "
        f"(distortion {rec['distortion_eps_vs_cpu']:.3e}); phase 4's main "
        f"path (1M rows in 65,536-row batches through the estimator): "
        f"{main_rate:.1f} rows/s")
    log(f"bench config 1 (numpy, host): {rec['config1']['rows_per_s']} rows/s")
    log(f"bench config 3: {c3['rows_per_s']} rows/s (distortion "
        f"{c3['distortion']:.3e}, {c3['executed_tflops']} TFLOP/s, "
        f"{c3['mxu_utilization']:.1%} of the bf16 peak)")
    log(f"bench config 4: estimator {c4['rows_per_s']} rows/s, raw "
        f"{c4['raw_kernel_rows_per_s']} rows/s, sign mismatch "
        f"{c4['sign_mismatch_rate_vs_cpu']:.3e}")
    log(f"bench serving: server {tk['queries_per_s']} q/s, single stream "
        f"{tk['single_stream_queries_per_s']} q/s ({tk['topk_impl']}; "
        f"{tk['single_stream_executed_tflops']} TOPS single stream, "
        f"{tk['single_stream_executed_tflops'] / (INT8_OPS_PER_S / 1e12):.1%} "
        f"of the int8 peak, int8 flags server "
        f"{tk['int8_timing_suspect']} single stream "
        f"{tk['single_stream_int8_timing_suspect']}); LSH "
        + ", ".join(f"p{p['probes']} {p['queries_per_s']} q/s recall "
                    f"{p['recall_at_m']} fraction {p['candidate_fraction']}"
                    for p in lsh["curve"])
        + f" (exact {lsh['exact_queries_per_s']} q/s, host reference "
        f"{lsh['exact_ref_s']} s); sharded ({tk['sharded']['shards']} shards x "
        f"{tk['sharded']['replicas']} replicas) {tk['sharded']['queries_per_s']}"
        f" q/s, {tk['sharded']['merges']} merges in "
        f"{tk['sharded']['merge_wall_s']} s; tiered {tier['queries_per_s']} q/s vs "
        f"resident {tier['resident_queries_per_s']} ({tier['hot_chunks']} hot, "
        f"{tier['cold_chunks']} cold)")
    log(f"bench config 5: ingest {c5['ingest_tokens_per_s']} tokens/s, device "
        f"sketch {c5['device_sketch_docs_per_s']} docs/s (gather floor "
        f"{c5['sketch_bakeoff_docs_per_s']['packed_gather_floor']}), serial "
        f"{c5['end_to_end_serial_docs_per_s']}, prefetch "
        f"{c5['end_to_end_prefetch_docs_per_s']}, staged "
        f"{c5['end_to_end_docs_per_s']} docs/s, bubble "
        f"{c5['pipeline_bubble_pct']}%, stages "
        f"{json.dumps(c5['pipeline_stage_pct'])}")
    return legs


def _chain_designs(torch, fk, X, seed, density):
    """The chain at config-2 width (all of ``X`` at ``CHAIN_STEPS``), three
    ways: (a) one mask cache and one persistent launch over every row (the
    shipped ``fused_project_multistep``), (b) one mask cache shared by a
    launch a row block, each writing its rows of one output, (c) (b)
    captured once as a CUDA graph and replayed (x and the output baked in).
    Each equals the others bit for bit; returns their milliseconds."""
    n, k = X.shape[0], N_COMPONENTS
    per = -(-n // CHAIN_STEPS)
    blocks = [(lo, min(lo + per, n)) for lo in range(0, n, per)]

    def design_a():
        return fk.fused_project_multistep(X, seed, k, density,
                                          steps=CHAIN_STEPS, mxu_mode="split2")

    def design_b():
        mask = fk.rp_mask_cache(seed, k, X.shape[1], density)
        y = torch.empty((n, k), dtype=torch.float32, device="cuda")
        for lo, hi in blocks:
            fk.rp_fused_project(X[lo:hi], seed, k, density, mxu_mode="split2",
                                mask=mask, out=y[lo:hi])
        return y

    ya, yb = design_a(), design_b()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        yc = design_b()
    graph.replay()
    torch.cuda.synchronize()
    check(torch.equal(ya, yb) and torch.equal(ya, yc),
          "the chain's three designs differ")
    del ya, yb
    # in turns, a b c c b a: the card's clocks drift over a run
    designs = (("a_one_launch_ms", design_a), ("b_launch_a_block_ms", design_b),
               ("c_graph_of_b_ms", graph.replay))
    times = {name: [] for name, _ in designs}
    for name, fn in designs + designs[::-1]:
        times[name].append(cuda_ms(fn, reps=5))
    del graph, yc
    torch.cuda.empty_cache()
    return times


def phase_timing(torch, fk, est, X, counts, errs, old):
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
    # K1 split2 with the old mask-cache writer, in turns with the shipped one
    shipped = fk.rp_mask_cache

    def old_cache(seed_, k_, d_, density_, *, block_offset=0, device="cuda"):
        return old.mask_cache(torch, fk, seed_, k_, d_, density_,
                              block_offset=block_offset, device=device)

    def split2_call():
        return fk.rp_fused_project(x, seed, k, density, mxu_mode="split2")

    turns = []
    for writer in ("old", "new", "new", "old"):
        fk.rp_mask_cache = old_cache if writer == "old" else shipped
        try:
            turns.append((writer, cuda_ms(split2_call, reps=20, warmup=2)))
        finally:
            fk.rp_mask_cache = shipped
    log(f"rp_fused_project {n}x{d}->{k} split2 (mask cache included), old and "
        f"new mask writer in turns: "
        + ", ".join(f"{w} {t:.4f} ms" for w, t in turns))
    chain = _chain_designs(torch, fk, X, seed, density)
    log(f"the chain over {X.shape[0]} rows at {CHAIN_STEPS} steps, split2, "
        f"in turns a b c c b a: "
        + ", ".join(f"{key} {v[0]:.3f} {v[1]:.3f}" for key, v in chain.items())
        + f" (16 single batches of the kernel: {16 * timed['split2']['ms']:.3f})")

    config3 = _k1_config3(torch, fk)
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
        "split2_ms_by_mask_writer": turns,
        "chain_1M_rows_16_steps": chain,
        "config3": config3,
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
        # device time, apart from the wrapper's host time
        "ms": graph_ms(torch, lambda: fk.rp_mask_cache(seed, k, d, density)),
        "old_ms": graph_ms(torch, lambda: old.mask_cache(torch, fk, seed, k, d,
                                                         density)),
        "fill_ms": graph_ms(torch, lambda: torch.empty(
            (k, dp), dtype=torch.bfloat16, device="cuda").fill_(1.0)),
        "wrapper_ms": cuda_ms(lambda: fk.rp_mask_cache(seed, k, d, density),
                              reps=100),
        "plain_ms": cuda_ms(lambda: fk.mask_cache_plain(
            seed, k, d, density, device="cuda"), reps=10),
        "library_ms": None,
    }
    cache.update(_bound(2 * k * dp / HBM_BYTES_PER_S,
                        HASH_OPS_PER_ENTRY * k * d / FP32_FLOP_PER_S))
    cache["shape"] = f"{k}x{dp} bf16"
    log(f"rp_mask_cache {k}x{dp}: device {cache['ms']:.5f} ms (old writer "
        f"{cache['old_ms']:.5f}, a torch fill of the output "
        f"{cache['fill_ms']:.5f}; CUDA graph of 20 calls), wrapper "
        f"{cache['wrapper_ms']:.5f} ms back to back, bound "
        f"{cache['bound_ms']:.6f} ms by {cache['bound_by']} "
        f"({cache['bound_ms'] / cache['ms']:.1%} of it)")

    lazy = {
        "name": "rp_lazy_matrix",
        "route": "cuda",
        "source": "randomprojection_tpu_torch/csrc/fused_project.cu",
        "replaces": "randomprojection_tpu/ops/pallas_kernels.py:963",
        "launches": counts["rp_lazy_matrix"],
        "max_abs_err": errs["rp_lazy_matrix"],
        # device time, apart from the wrapper's host time, beside the old
        # writer's and a torch fill of the same 4 MiB (launch and stores
        # only: the floor of any writer of this output)
        "ms": graph_ms(torch, lambda: fk.rp_lazy_matrix(seed, k, d, density)),
        "old_ms": graph_ms(torch, lambda: old.lazy_matrix(torch, fk, seed, k,
                                                          d, density)),
        "fill_ms": graph_ms(torch, lambda: torch.empty(
            (k, d), device="cuda").fill_(1.0)),
        "wrapper_ms": cuda_ms(lambda: fk.rp_lazy_matrix(seed, k, d, density),
                              reps=100),
        "plain_ms": cuda_ms(lambda: fk.lazy_matrix_plain(
            seed, k, d, density, device="cuda"), reps=10),
        "library_ms": None,
    }
    lazy.update(_bound(4 * k * d / HBM_BYTES_PER_S,
                       HASH_OPS_PER_ENTRY * k * d / FP32_FLOP_PER_S))
    lazy["shape"] = f"{k}x{d}"
    log(f"rp_lazy_matrix {k}x{d}: device {lazy['ms']:.5f} ms (old writer "
        f"{lazy['old_ms']:.5f}, a torch fill of the output "
        f"{lazy['fill_ms']:.5f}; CUDA graph of 20 calls), wrapper "
        f"{lazy['wrapper_ms']:.5f} ms back to back, bound "
        f"{lazy['bound_ms']:.5f} ms by {lazy['bound_by']} "
        f"({lazy['bound_ms'] / lazy['ms']:.1%} of it; old "
        f"{lazy['bound_ms'] / lazy['old_ms']:.1%})")
    for row in (fused, cache, lazy):
        row["card"] = CARD
    return [fused, cache, lazy]


def _k1_config3(torch, fk) -> dict:
    """K1 at config 3's shape: one 16,384 x 16,384 -> 512 split2 batch at
    density 1/128, against its plain version (within ``TOL·max|Y|``), by
    CUDA events beside its bound, the plain version's time and a float32
    ``torch.matmul`` (TF32 off) against the materialized matrix.  The
    bound is the function's: x read once and y written once, and 2 flops a
    row for each nonzero of this run's mask at the float32 rate (the
    product needs no more); the kernel's own dense work, 2 bf16 passes of
    2ndk, stands beside it as ``bound_dense_split2_ms``."""
    from randomprojection_tpu_torch.ops.precision import fp32_matmul

    n, d, k = C3_ROWS, C3_FEATURES, C3_COMPONENTS
    density = 1.0 / np.sqrt(d)
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.empty((n, d), dtype=torch.float32, device="cuda")
    x.normal_(generator=g)
    y = fk.rp_fused_project(x, 0, k, density, mxu_mode="split2")
    want = fk.fused_project(x, 0, k, density, mxu_mode="split2")
    err = (y - want).abs().max().item()
    scale = want.abs().max().item()
    check(err <= TOL * scale, f"K1 at config 3's shape off its plain version "
          f"by {err:.3e} (max|Y| {scale:.3e})")
    m = fk.rp_lazy_matrix(0, k, d, density)
    nnz = int(torch.count_nonzero(m).item())

    def library():
        with fp32_matmul():
            return torch.matmul(x, m.t())

    row = {
        "shape": f"{n}x{d}->{k} split2, density 1/{int(np.sqrt(d))}",
        "ms": cuda_ms(lambda: fk.rp_fused_project(
            x, 0, k, density, mxu_mode="split2"), reps=20, warmup=2),
        "plain_ms": cuda_ms(lambda: fk.fused_project(
            x, 0, k, density, mxu_mode="split2"), reps=3),
        "library_ms": cuda_ms(library, reps=20, warmup=2),
        "max_abs_err": err,
    }
    row.update(_bound((4 * n * d + 4 * n * k) / HBM_BYTES_PER_S,
                      2 * n * nnz / FP32_FLOP_PER_S))
    row["mask_nonzeros"] = nnz
    row["bound_dense_split2_ms"] = 2 * 2 * n * d * k / BF16_FLOP_PER_S * 1e3
    log(f"rp_fused_project at config 3's shape {row['shape']}: "
        f"{row['ms']:.3f} ms (mask cache included), bound "
        f"{row['bound_ms']:.3f} ms by {row['bound_by']} "
        f"({row['bound_ms'] / row['ms']:.1%} of it; {nnz} nonzeros; the "
        f"dense 2-pass split2 work alone "
        f"{row['bound_dense_split2_ms']:.3f} ms), plain "
        f"{row['plain_ms']:.3f} ms, library {row['library_ms']:.3f} ms "
        f"(torch.matmul fp32, TF32 off); vs plain max|d|={err:.3e} "
        f"max|Y|={scale:.3e}")
    del x, y, want, m
    torch.cuda.empty_cache()
    return row


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
            and c["candidate_fraction"] <= LSH_CANDIDATE_FRACTION_GATE]
    check(bool(gate), f"no probe count reaches recall >= {LSH_RECALL_GATE} at "
          f"candidate fraction <= {LSH_CANDIDATE_FRACTION_GATE}")
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


def phase_durable(torch, tk, codes, queries, lsh_index, lsh_queries,
                  scratch: Path) -> str:
    """Durable snapshots and exactly-once ingest at config 4's size: the
    serving phase's 2^24 codes with 1% deleted and the LSH tier's 2^20
    codes each saved, verified and loaded, the restored index answering
    bit for bit; a ``DurableIngest`` of 2^20 rows drawn on the card; and a
    crash child on the card killed mid-batch and resumed to the same codes
    and checksums as the uninterrupted run.  Returns the 2^24-code
    snapshot's directory, kept for phase 15's ``recover``."""
    from randomprojection_tpu_torch import durable
    from randomprojection_tpu_torch.ann import load_lsh_index
    from randomprojection_tpu_torch.models.sketch import SimHashIndex

    root = scratch / "durable"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        idx = SimHashIndex(codes)
        dead = np.random.default_rng(21).choice(N_CODES, N_CODES // 100,
                                                replace=False)
        check(idx.delete(dead) == len(dead), "delete count")
        want_d, want_i = idx.query_topk(queries, TOPK_M, tile=QUERY_TILE)
        snap = str(root / "snapshot")
        t0 = time.perf_counter()
        man = durable.save_index(idx, snap)
        save_s = time.perf_counter() - t0
        status = durable.verify_snapshot(snap)
        check(status["ok"] and status["coverage_ok"]
              and not status["orphan_chunks"], f"snapshot status {status}")
        t0 = time.perf_counter()
        back = durable.load_index(snap)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        check(back.device.type == "cuda" and back.n_codes == N_CODES
              and back.n_deleted == len(dead), "restored index")
        tk.reset_launches()
        got_d, got_i = back.query_topk(queries, TOPK_M, tile=QUERY_TILE)
        n = _topk_launches(tk)
        check(n == (1, 0, 1), f"{n} rp_fused_topk launches on the restored index")
        check(np.array_equal(got_d, want_d) and np.array_equal(got_i, want_i),
              "restored index answers differently")
        nbytes = sum(
            os.path.getsize(os.path.join(snap, e["file"]))
            for e in man["chunks"] + [man["tombstones"]]
        )
        log(f"durable: snapshot of {N_CODES} codes x {SIGN_BITS // 8} B, "
            f"{len(dead)} deleted: save {save_s:.3f} s "
            f"({nbytes / save_s / 1e9:.3f} GB/s), verify ok, load "
            f"{load_s:.3f} s ({nbytes / load_s / 1e9:.3f} GB/s); query_topk of "
            f"{N_QUERIES} queries on the restored chunks == the live index "
            f"bit for bit (rp_fused_topk launches {n})")
        del idx, back
        torch.cuda.empty_cache()

        lsnap = str(root / "lsh")
        t0 = time.perf_counter()
        lsh_index.save(lsnap)
        lsave_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        lback = load_lsh_index(lsnap)
        lload_s = time.perf_counter() - t0
        check(np.array_equal(lback._buckets.keys, lsh_index._buckets.keys),
              "restored band keys differ")
        q = lsh_queries[:LSH_NQ]
        live = lsh_index.query_topk(q, LSH_M, tile=LSH_TILE, probes=16)
        got = lback.query_topk(q, LSH_M, tile=LSH_TILE, probes=16)
        check(np.array_equal(got[0], live[0]) and np.array_equal(got[1], live[1]),
              "restored LSH index answers differently")
        log(f"durable: LSH snapshot of {LSH_N} codes: save {lsave_s:.3f} s, "
            f"load {lload_s:.3f} s (band keys verified); 16-probe query_topk "
            f"== the live index bit for bit")
        del lback

        shapes = dict(rows=INGEST_ROWS, batch_rows=BATCH, d=SIGN_FEATURES,
                      bits=SIGN_BITS, seed=INGEST_SEED,
                      commit_every=INGEST_COMMIT, compact_after=INGEST_COMPACT,
                      device="cuda")
        ingest_dir = str(root / "ingest")
        t0 = time.perf_counter()
        summary = durable.demo_ingest(ingest_dir, **shapes)
        ingest_s = time.perf_counter() - t0
        check(summary["rows_done"] == INGEST_ROWS and summary["chunks"] == 1,
              f"ingest summary {summary}")
        log(f"durable: DurableIngest of {INGEST_ROWS} rows x {SIGN_FEATURES} "
            f"-> {SIGN_BITS} bits drawn on the card, {BATCH}-row batches, a "
            f"commit every {INGEST_COMMIT}, compacted at {INGEST_COMPACT} "
            f"chunks: {ingest_s:.3f} s, {INGEST_ROWS / ingest_s:.1f} rows/s")

        t0 = time.perf_counter()
        verdict = durable.crash_smoke(str(root / "crash"), query_m=TOPK_M,
                                      points=(KILL_AT,), nth=KILL_NTH,
                                      timeout=600, **shapes)
        crash_s = time.perf_counter() - t0
        check(verdict["ok"], f"crash and resume: {json.dumps(verdict)[:4000]}")
        clean = str(root / "crash" / "clean")
        check(np.array_equal(durable._codes_of(clean),
                             durable._codes_of(ingest_dir)),
              "the child's codes differ from the in-process ingest's")
        sums = [e["sha256"] for e in durable.read_manifest(ingest_dir)["chunks"]]
        resumed = str(root / "crash" / KILL_AT.replace("-", "_"))
        check([e["sha256"] for e in durable.read_manifest(resumed)["chunks"]]
              == sums, "resumed manifest checksums differ")
        case = verdict["cases"][0]
        log(f"durable: a child on the card killed at {case['kill_at']} (rc "
            f"{case['crash_returncode']}) and resumed (rc "
            f"{case['resume_returncode']}): codes, manifest checksums and "
            f"query_topk equal the uninterrupted run's; three children in "
            f"{crash_s:.3f} s")
        kept = scratch / "snapshot"
        shutil.rmtree(kept, ignore_errors=True)
        shutil.move(snap, kept)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return str(kept)


def _tier_sums(reg):
    return (reg.counter("index.tier.fallbacks"), reg.counter("index.tier.fetches"),
            reg.hist_sum("index.tier.fetch_s"), reg.hist_sum("index.tier.overlap_s"))


def _h2d_gbps(torch, host) -> float:
    """GB/s of one pinned tensor's copy to the card (CUDA events)."""
    ms = cuda_ms(lambda: host.to("cuda", non_blocking=True), reps=5)
    return host.numel() * host.element_size() / (ms / 1e3) / 1e9


def phase_tier(torch, tk, pk, codes, queries, lsh_codes, lsh_queries, lsh_index,
               scratch: Path) -> int:
    """Tiered residency at config 4's width (see the module docstring);
    returns K4's launches on the timed tiered calls."""
    from randomprojection_tpu_torch import durable, tier_smoke
    from randomprojection_tpu_torch.ann import LSHSimHashIndex
    from randomprojection_tpu_torch.models.sketch import SimHashIndex
    from randomprojection_tpu_torch.utils import telemetry

    reg = telemetry.registry()
    root = scratch / "tier"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    opened = []
    try:
        t0 = time.perf_counter()
        summary = tier_smoke.main("cuda")
        log(f"tier: tier_smoke on the card in {time.perf_counter() - t0:.3f} s "
            f"({summary['cold_chunks']} of {summary['chunks']} chunks cold, "
            f"{summary['fallbacks']} fallbacks on its injected-failure leg)")

        # -- exact leg: 2^24 codes as 16 chunks, 4 hot ----------------------
        host = codes.cpu().numpy()
        chunk = N_CODES // TIER_CHUNKS
        budget = TIER_HOT * chunk * host.shape[1]
        t0 = time.perf_counter()
        tiered = SimHashIndex(host[:chunk], hbm_budget_bytes=budget)
        opened.append(tiered)
        for lo in range(chunk, N_CODES, chunk):
            tiered.add(host[lo:lo + chunk])
        build_s = time.perf_counter() - t0
        r = tiered._tier.residency()
        cold = [c for c in r["chunks"] if c["tier"] != "hot"]
        check(r["hot_bytes"] == budget and len(cold) == TIER_CHUNKS - TIER_HOT,
              f"residency {r['hot_bytes']} B hot, {len(cold)} cold")
        check(all(c.b.is_pinned() for c in tiered._chunks
                  if not c.b.is_cuda), "a cold chunk is not in pinned memory")
        resident = SimHashIndex(codes)
        # the same 16 chunks all resident: what the chunking alone costs
        resident16 = SimHashIndex(codes[:chunk])
        for lo in range(chunk, N_CODES, chunk):
            resident16.add(codes[lo:lo + chunk])
        want = resident.query_topk(queries, TOPK_M, tile=QUERY_TILE)
        # residency moves here only where this phase forces it
        tiered._tier._maybe_rebalance = lambda: None
        # the same tiered calls with every cold chunk already on the card:
        # the upload turned off, all else (stager, waits, merge) as it runs
        prestaged = {c.b.data_ptr(): c.b.to("cuda") for c in tiered._chunks
                     if not c.b.is_cuda}
        orig = tk.stage_rows

        def _prestaged(rows, *, device, pad_to=None):
            return prestaged[rows.data_ptr()], None

        for idx in (tiered, resident16):  # first-call set-up
            idx.query_topk(queries, TOPK_M, tile=QUERY_TILE)
        f0 = _tier_sums(reg)
        indexes = {"resident": resident, "resident16": resident16,
                   "tiered": tiered, "prestaged": tiered}
        walls = {k: [] for k in indexes}
        tier_launches = 0
        for turn in ("resident", "resident16", "tiered", "prestaged",
                     "prestaged", "tiered", "resident16", "resident", "tiered",
                     "prestaged", "prestaged", "tiered", "resident16",
                     "resident"):
            idx = indexes[turn]
            tk.reset_launches()
            tk.stage_rows = _prestaged if turn == "prestaged" else orig
            torch.cuda.synchronize()
            try:
                t0 = time.perf_counter()
                got = idx.query_topk(queries, TOPK_M, tile=QUERY_TILE)
                walls[turn].append(time.perf_counter() - t0)
            finally:
                tk.stage_rows = orig
            n = _topk_launches(tk)
            chunks = 1 if turn == "resident" else TIER_CHUNKS
            check(n == (chunks, 0, chunks), f"{n} K4 launches on the {turn} call")
            check(np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1]),
                  f"{turn} answers differ from the resident index")
            if turn == "tiered":
                tier_launches += sum(n)
        f1 = _tier_sums(reg)
        del prestaged
        fallbacks, fetches = f1[0] - f0[0], f1[1] - f0[1]
        check(fallbacks == 0, f"{fallbacks} tier fallbacks on the timed calls")
        gbps = _h2d_gbps(torch, tiered._chunks[-1].b)
        cold_bytes = len(cold) * chunk * host.shape[1]
        upload_s = cold_bytes / (gbps * 1e9)
        rw, tw = min(walls["resident"]), min(walls["tiered"])
        r16 = min(walls["resident16"])
        # the share of the upload hidden, a pair of adjacent turns at a
        # time: 1 - (tiered - pre-staged) / the upload alone, unclamped
        hidden = [1.0 - (t - p_) / upload_s
                  for t, p_ in zip(walls["tiered"], walls["prestaged"])]
        # the host merge of the 16 chunks' candidates, apart
        dummy = [(np.zeros((N_QUERIES, TOPK_M), np.int32),
                  np.zeros((N_QUERIES, TOPK_M), np.int32))] * TIER_CHUNKS

        class _Done:
            def __init__(self, a):
                self.a = a

            def result(self, _):
                return self.a

        handles = [(_Done(d), _Done(i)) for d, i in dummy]
        t0 = time.perf_counter()
        resident16._topk_finish_tile(handles, TOPK_M)
        merge_s = time.perf_counter() - t0
        k4_16 = cuda_ms(lambda: [tk.rp_fused_topk(queries, c.b, c.n, TOPK_M)
                                 for c in resident16._chunks], reps=3)

        def ms(ws):
            return [round(w * 1e3, 3) for w in ws]

        log(f"tier exact: {N_CODES} codes x {host.shape[1]} B as {TIER_CHUNKS} "
            f"chunks, {TIER_HOT} hot ({budget} B) and {len(cold)} cold in pinned "
            f"host memory (built in {build_s:.3f} s); query_topk of {N_QUERIES} "
            f"queries m={TOPK_M} == the resident index bit for bit in every "
            f"turn; walls (ms) resident {ms(walls['resident'])}, the 16 chunks "
            f"all resident {ms(walls['resident16'])}, tiered "
            f"{ms(walls['tiered'])}, tiered with the cold chunks pre-staged "
            f"on the card {ms(walls['prestaged'])}: {N_QUERIES / rw:.1f} q/s "
            f"resident, {N_QUERIES / r16:.1f} q/s 16 chunks resident, "
            f"{N_QUERIES / tw:.1f} q/s tiered (at best); K4 over the 16 chunks "
            f"alone {k4_16:.3f} ms, the host merge of their candidates "
            f"{merge_s * 1e3:.3f} ms; {fetches} cold fetches, host stage wall "
            f"{f1[2] - f0[2]:.6f} s, overlap window {f1[3] - f0[3]:.6f} s; H2D "
            f"{gbps:.3f} GB/s (a pinned {chunk * host.shape[1] >> 20} MiB "
            f"chunk), the cold {cold_bytes >> 20} MiB alone "
            f"{upload_s * 1e3:.3f} ms; tiered minus pre-staged per pair of "
            f"turns (ms) "
            f"{[round((t - p_) * 1e3, 3) for t, p_ in zip(walls['tiered'], walls['prestaged'])]}"
            f", the upload's hidden share 1 - that / the upload alone "
            f"{[round(h, 4) for h in hidden]} (raw, unclamped); "
            f"index.tier.fallbacks {fallbacks}; {tier_launches} K4 launches "
            f"on the {len(walls['tiered'])} timed tiered calls")
        tiered.close()
        del tiered, resident, resident16, host
        opened.clear()
        torch.cuda.empty_cache()

        # -- disk and LSH leg: 2^20 codes as 16 chunks of 2^16, 4 hot -------
        lchunk = LSH_N // TIER_CHUNKS
        lbudget = TIER_HOT * lchunk * LSH_BYTES
        q = lsh_queries[:LSH_NQ]

        def build(cls, **kw):
            idx = cls(lsh_codes[:lchunk], **kw)
            opened.append(idx)
            for lo in range(lchunk, LSH_N, lchunk):
                idx.add(lsh_codes[lo:lo + lchunk])
            return idx

        exact_want = lsh_index.query_topk(q, LSH_M, tile=LSH_TILE, probes=0)
        disk = build(SimHashIndex, hbm_budget_bytes=lbudget, cold_tier="disk",
                     cold_dir=str(root / "cold"))
        spills = sorted(os.listdir(root / "cold"))
        check(len(spills) == TIER_CHUNKS - TIER_HOT, f"{len(spills)} spills")
        f0 = _tier_sums(reg)
        t0 = time.perf_counter()
        got = disk.query_topk(q, LSH_M, tile=LSH_TILE)
        disk_s = time.perf_counter() - t0
        check(np.array_equal(got[0], exact_want[0])
              and np.array_equal(got[1], exact_want[1]), "disk tier answers")
        lkw = dict(bands=LSH_BANDS, band_bits=LSH_BAND_BITS, fallback_density=1.0)
        t0 = time.perf_counter()
        ltier = build(LSHSimHashIndex, hbm_budget_bytes=lbudget, **lkw)
        lbuild_s = time.perf_counter() - t0
        # residency moves here only where this leg forces it (the card
        # tests run the background rebalance under live queries)
        ltier._tier._maybe_rebalance = lambda: None
        lsh_launches = [0, 0]  # K4 (scans + merges), K5 on the timed calls
        lwalls = {}
        for p in (4, 16):
            want_p = lsh_index.query_topk(q, LSH_M, tile=LSH_TILE, probes=p)
            t0 = time.perf_counter()
            got = ltier.query_topk(q, LSH_M, tile=LSH_TILE, probes=p,
                                   probe_path="host")
            host_s = time.perf_counter() - t0
            check(np.array_equal(got[0], want_p[0])
                  and np.array_equal(got[1], want_p[1]),
                  f"tiered LSH host rung at probes={p} answers differently")
            ltier.query_topk(q, LSH_M, tile=LSH_TILE, probes=p)  # set-up
            w = {"resident": [], "tiered": [], "host": [host_s]}
            for turn in ("resident", "tiered", "tiered", "resident",
                         "resident", "tiered"):
                idx = lsh_index if turn == "resident" else ltier
                tk.reset_launches()
                pk.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = idx.query_topk(q, LSH_M, tile=LSH_TILE, probes=p)
                w[turn].append(time.perf_counter() - t0)
                check(np.array_equal(got[0], want_p[0])
                      and np.array_equal(got[1], want_p[1]),
                      f"{turn} LSH device rung at probes={p} answers "
                      f"differently from the resident index")
                if turn == "tiered":
                    n4, n5 = _topk_launches(tk), pk.LAUNCHES["rp_probe"]
                    check(n5 > 0 and n4[0] + n4[1] == n4[2] > 0
                          and pk.GRAPH_REPLAYS == 0,
                          f"the tiered device rung launched K5 {n5}, K4 {n4}, "
                          f"{pk.GRAPH_REPLAYS} graph replays")
                    lsh_launches[0] += sum(n4)
                    lsh_launches[1] += n5
            lwalls[p] = w
        f1 = _tier_sums(reg)
        check(f1[0] == f0[0], f"{f1[0] - f0[0]} fallbacks on the disk/LSH calls")
        want16 = lsh_index.query_topk(q, LSH_M, tile=LSH_TILE, probes=16)

        def same16(what):
            got = ltier.query_topk(q, LSH_M, tile=LSH_TILE, probes=16)
            check(np.array_equal(got[0], want16[0])
                  and np.array_equal(got[1], want16[1]), what)

        hot0 = next(c for c in ltier._chunks if c.b.is_cuda)
        check(ltier._tier.demote(hot0.row0), "the forced demote")
        pk.reset_launches()
        same16("after a forced demote")
        check(pk.GRAPH_CAPTURES == 0 and pk.LAUNCHES["rp_probe"] > 0,
              "the device rung with cold chunks is not the eager tiered one")
        # promote every cold chunk: the device rung serves on graphs
        # captured anew over the promoted chunks
        ltier._tier.budget_bytes = LSH_N * LSH_BYTES
        for e in list(ltier._tier._entries):
            ltier._tier._promote(e)
        check(not ltier._tier.any_cold(), "promotion left cold chunks")
        pk.reset_launches()
        same16("on the device rung after the promotion")
        captures = pk.GRAPH_CAPTURES
        check(captures >= 1 and len(ltier._lsh_graphs) >= 1,
              "no graph captured after the promotion")
        ltier._tier.demote(ltier._chunks[0].row0)
        check(len(ltier._lsh_graphs) == 0, "a demotion kept the graphs")
        same16("after a demotion of the promoted index")
        # the injected staging failure: the degraded rung, exact answers
        orig = tk.stage_rows

        def _boom(*a, **k):
            raise RuntimeError("injected staging failure")

        tk.stage_rows = _boom
        try:
            fb0 = reg.counter("index.tier.fallbacks")
            same16("tiered LSH on the upload-failure rung")
            got = disk.query_topk(q, LSH_M, tile=LSH_TILE)
            check(np.array_equal(got[1], exact_want[1]), "disk tier on the "
                  "upload-failure rung")
            fb = reg.counter("index.tier.fallbacks") - fb0
        finally:
            tk.stage_rows = orig
        check(fb > 0, "the upload-failure rung never reached the counter")
        log(f"tier disk+LSH: {LSH_N} codes as {TIER_CHUNKS} chunks, {TIER_HOT} "
            f"hot: the disk tier's {len(spills)} spills answer {LSH_NQ} exact "
            f"queries bit for bit in {disk_s:.3f} s; the tiered LSH index "
            f"(built in {lbuild_s:.3f} s) == the resident one at probes 4 and 16 "
            f"in every turn; "
            + "; ".join(
                f"probes {p}: walls (ms) resident device rung "
                f"{ms(lwalls[p]['resident'])}, tiered device rung "
                f"{ms(lwalls[p]['tiered'])}, tiered host rung "
                f"{ms(lwalls[p]['host'])} = {LSH_NQ / min(lwalls[p]['resident']):.1f}, "
                f"{LSH_NQ / min(lwalls[p]['tiered']):.1f} and "
                f"{LSH_NQ / lwalls[p]['host'][0]:.1f} q/s"
                for p in (4, 16))
            + f"; {lsh_launches[0]} K4 and {lsh_launches[1]} K5 launches on the "
            f"timed tiered calls, no graph; a forced demote, then every chunk "
            f"promoted: the device rung answers bit for bit on {captures} new "
            f"graph(s), dropped at the next demotion; the injected staging "
            f"failure: {fb} fallbacks, exact answers")
        for idx in opened:
            idx.close()
        opened.clear()

        # -- crash leg: a child on the card killed at mid-demotion@1 --------
        t0 = time.perf_counter()
        verdict = durable.crash_smoke(
            str(root / "crash"), rows=TIER_CRASH_ROWS, batch_rows=TIER_CRASH_BATCH,
            d=SIGN_FEATURES, bits=SIGN_BITS, seed=INGEST_SEED, device="cuda",
            query_m=TOPK_M, points=("mid-demotion",), nth=1, timeout=600)
        check(verdict["ok"], f"mid-demotion crash: {json.dumps(verdict)[:4000]}")
        case = verdict["cases"][0]
        log(f"tier crash: a child on the card killed at {case['kill_at']} (rc "
            f"{case['crash_returncode']}) and resumed (rc "
            f"{case['resume_returncode']}): codes, checksums and query_topk equal "
            f"the clean run's; three children in {time.perf_counter() - t0:.3f} s")
        return tier_launches, lsh_launches
    finally:
        for idx in opened:
            idx.close()
        shutil.rmtree(root, ignore_errors=True)


def phase_config5(torch):
    """Config 5 on the card (see the module docstring)."""
    import scipy.sparse as sp

    from randomprojection_tpu_torch.models.sketch import CountSketch
    from randomprojection_tpu_torch.ops.hashing import FeatureHasher
    from randomprojection_tpu_torch.streaming import TokenSource

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    words = np.asarray([f"tok{i}" for i in range(C5_VOCAB)])
    toks = words[rng.integers(0, C5_VOCAB, size=C5_DOCS * C5_TOKENS)]
    gen_s = time.perf_counter() - t0
    fh = FeatureHasher(n_features=C5_FEATURES, input_type="string",
                       dtype=np.float32)
    fh.transform_tokens(toks[:1000])  # builds the murmur3 library
    indptr = np.arange(0, BATCH * C5_TOKENS + 1, C5_TOKENS, dtype=np.int64)

    def read_tokens(lo, hi):
        return toks[lo * C5_TOKENS: hi * C5_TOKENS], indptr[: hi - lo + 1]

    src = TokenSource(read_tokens, C5_DOCS, fh, batch_rows=BATCH)
    cs = CountSketch(C5_K, random_state=0).fit_source(src)
    check(cs._device.type == "cuda", "CountSketch is not on the card")
    first = next(src.iter_batches(0))[1]
    y = cs.transform(first)
    want = cs._transform_csr(sp.csr_array(
        (first.data.astype(np.float64), first.indices, first.indptr),
        shape=first.shape))
    err = float(np.abs(y - want).max())
    check(y.shape == (BATCH, C5_K) and np.isfinite(y).all(), "sketch shape")
    check(np.allclose(y, want, rtol=C5_TOL, atol=C5_TOL),
          f"first batch off the host float64 transform by {err}")

    def hash_one():
        t = time.perf_counter()
        fh.transform_tokens(toks[: BATCH * C5_TOKENS], indptr)
        return time.perf_counter() - t

    hash_s = min(hash_one() for _ in range(3))
    from randomprojection_tpu_torch.ops.hashing import hash_tokens

    def murmur_one():
        t = time.perf_counter()
        hash_tokens(toks[: BATCH * C5_TOKENS], C5_FEATURES)
        return time.perf_counter() - t

    murmur_s = min(murmur_one() for _ in range(3))
    # the device sketch alone: every batch laid out and uploaded first,
    # then one dispatch a batch, CUDA events around them
    prepared = [cs.prepare_batch(b) for _, b in src.iter_batches(0)]
    torch.cuda.synchronize()
    sketch_ms = cuda_ms(lambda: [cs._transform_async(b) for b in prepared],
                        reps=3)
    del prepared
    t0 = time.perf_counter()
    serial = []
    for _, yb in cs.transform_stream(src):
        check(np.isfinite(yb).all(), "a streamed batch is not finite")
        serial.append(yb)
    e2e_s = time.perf_counter() - t0
    rows = sum(y.shape[0] for y in serial)
    check(rows == C5_DOCS, f"the stream gave {rows} rows")
    # the staged ingest: a pool of one hash worker a core (each hashing
    # with one thread), the uploads from the uploader thread
    from randomprojection_tpu_torch.streaming import StagedIngestSource
    from randomprojection_tpu_torch.utils.observability import StreamStats

    workers = os.cpu_count() or 1
    stats = StreamStats()
    staged_src = StagedIngestSource(
        TokenSource(read_tokens, C5_DOCS, fh, batch_rows=BATCH,
                    hash_threads=1, stats=stats),
        workers=workers, prepare=cs.prepare_batch, stats=stats)
    t0 = time.perf_counter()
    staged_err = 0.0
    for lo, yb in cs.transform_stream(staged_src, stats=stats):
        want_b = serial[lo // BATCH]
        check(np.allclose(yb, want_b, rtol=C5_TOL, atol=C5_TOL),
              f"staged batch at doc {lo} off the serial one")
        staged_err = max(staged_err, float(np.abs(yb - want_b).max()))
    staged_s = time.perf_counter() - t0
    check(stats.rows == C5_DOCS, f"the staged stream gave {stats.rows} rows")
    check(not _ingest_threads(), "the staged config-5 stream left threads")
    del serial
    sm = stats.summary()
    log(f"config5: {C5_DOCS} docs x {C5_TOKENS} tokens from {C5_VOCAB} words "
        f"(drawn in {gen_s:.3f} s) -> FeatureHasher(2^20) -> CountSketch({C5_K}) "
        f"on the card, {BATCH}-doc batches on the flat route; first batch "
        f"max|dev - host f64| {err:.3e} (rtol=atol={C5_TOL}); ingest "
        f"{BATCH * C5_TOKENS / hash_s:.1f} tokens/s (host murmur3 + CSR; the "
        f"murmur3 call alone {BATCH * C5_TOKENS / murmur_s:.1f} tokens/s on "
        f"{os.cpu_count()} cores); device "
        f"sketch {C5_DOCS / (sketch_ms / 1e3):.1f} docs/s ({C5_DOCS // BATCH} "
        f"per-batch dispatches, tokens resident, {sketch_ms:.3f} ms); end to end "
        f"{C5_DOCS / e2e_s:.1f} docs/s (serial TokenSource -> transform_stream, "
        f"{e2e_s:.3f} s); staged {C5_DOCS / staged_s:.1f} docs/s "
        f"(StagedIngestSource, {workers} hash workers of one thread, "
        f"{staged_s:.3f} s; every batch within rtol=atol={C5_TOL} of the "
        f"serial one, max|d| {staged_err:.3e}; stage walls "
        f"{json.dumps(sm.get('stage_wall_s'))}, overlap ratio "
        f"{sm.get('pipeline_overlap_ratio')}, queue depth max "
        f"{sm.get('queue_depth_max')})")


def _cli_json(argv, on_side=None):
    """``cli.main(argv)`` in this process (on the main thread: the flight
    recorder's signal handlers can only go in there), its stdout captured;
    ``on_side(port)``, when given, runs on a side thread with the live
    endpoint's port once it is up, and what it returns comes back.  Every
    kernel's count is set to 0 just before and read just after.  Returns the last
    stdout line parsed, the launches and ``on_side``'s result."""
    import contextlib
    import io

    from randomprojection_tpu_torch import cli
    from randomprojection_tpu_torch.benchmark import (
        _read_launches,
        _zero_launches,
    )

    side = {}

    def watch():
        deadline = time.monotonic() + 600
        while cli._METRICS_SERVER is None and time.monotonic() < deadline:
            time.sleep(0.005)
        server = cli._METRICS_SERVER
        if server is not None:
            side["out"] = on_side(server.port)

    t = None
    if on_side is not None:
        t = threading.Thread(target=watch, name="rp-torch-smoke-scraper",
                             daemon=True)
        t.start()
    out = io.StringIO()
    _zero_launches()
    with contextlib.redirect_stdout(out):
        cli.main(list(argv))
    launches = _read_launches()
    if t is not None:
        t.join(timeout=60)
        check(not t.is_alive(), "the scraper thread did not finish")
    return json.loads(out.getvalue().strip().splitlines()[-1]), launches, \
        side.get("out")


def _http(url):
    """``(status, body)`` of one GET, error statuses included."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _labels_line(rec) -> str:
    return "; ".join(
        f"{label} p50 {row['p50_ms']} p90 {row['p90_ms']} p99 "
        f"{row['p99_ms']} p99.9 {row['p99.9_ms']} ms (n {row['count']}, "
        f"rejects {row['rejects']})"
        for label, row in sorted(rec["labels"].items()))


def _hold_k4(rec, launches, what):
    """One scan and one merge a coalesced batch: the schedule's batches
    and the warm-up request's, which the server coalesces like any
    other."""
    batches = rec["server"]["batches"]
    scans = launches.get("rp_fused_topk_wgmma", 0) + launches.get(
        "rp_fused_topk_popc", 0)
    check(scans == batches == launches.get("rp_topk_merge", 0),
          f"{what}: K4 launches {launches} for {batches} server batches")
    return batches


def phase_ops_planes(torch, snapshot: str, scratch: Path):
    """The ops planes at config 4's serving width (see the module
    docstring, phase 15).  Returns K4's launches on each loadgen leg and
    R."""
    from randomprojection_tpu_torch import cli
    from randomprojection_tpu_torch.utils import telemetry
    from randomprojection_tpu_torch.utils.metrics_server import (
        fetch_metrics,
        parse_openmetrics,
    )

    t_phase = time.perf_counter()
    root = scratch / "ops"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    base = ["loadgen", "--index-codes", str(N_CODES), "--code-bytes",
            str(SIGN_BITS // 8), "--m", str(TOPK_M), "--request-rows",
            "16,64,256", "--labels", "tenant-a,tenant-b", "--seed", "0",
            "--server-batch", str(MAX_BATCH), "--server-delay-ms", "2"]
    leg_launches = {}

    # 1. the highest open-loop rate within the limits
    rate = None
    for step in OPS_RATES:
        rec, launches, _ = _cli_json([*base, "--rate", str(step),
                                      "--duration", str(OPS_STEP_S)])
        batches = _hold_k4(rec, launches, f"loadgen at {step}/s")
        p99 = max(row["p99_ms"] for row in rec["labels"].values())
        ok = (p99 <= OPS_P99_MS and rec["rejects"] == 0
              and not rec["open_loop_suspect"] and rec["errors"] == 0)
        log(f"ops loadgen {step} req/s x {OPS_STEP_S} s: {_labels_line(rec)}; "
            f"rejects {rec['rejects']}, max_lag_s {rec['max_lag_s']}, "
            f"served {rec['served_qps']} req/s, {batches} batches "
            f"({rec['server']['rows_per_batch_mean']} rows mean) -> "
            f"{'within' if ok else 'past'} p99 <= {OPS_P99_MS} ms")
        leg_launches[f"step_{step}"] = launches
        if ok:
            rate = step
    check(rate is not None, f"no rate of {OPS_RATES} met p99 <= "
          f"{OPS_P99_MS} ms with 0 rejects")
    half = rate / 2
    log(f"ops loadgen: R = {rate} req/s; legs at R/2 = {half} req/s")

    # 2a. no live-plane flags
    leg = [*base, "--rate", str(half), "--duration", str(OPS_LEG_S)]
    rec_a, launches, _ = _cli_json(leg)
    _hold_k4(rec_a, launches, "leg (a)")
    leg_launches["leg_a"] = launches

    # 2b. the live plane on, scraped mid-run
    jsonl, dump, om = root / "b.jsonl", root / "b.flight.json", root / "b.om"

    def scrape(port):
        seen = {"health": set()}
        deadline = time.monotonic() + OPS_LEG_S + 60
        while time.monotonic() < deadline and cli._METRICS_SERVER is not None:
            try:
                text = fetch_metrics("127.0.0.1", port)
                seen["health"].add(
                    _http(f"http://127.0.0.1:{port}/health")[0])
            except OSError:
                break
            plain, labeled = parse_openmetrics(text)
            if "rp_serve_latency_sharded_seconds_bucket" in labeled:
                seen["scrape"] = (plain, labeled)
                return seen
            time.sleep(0.2)
        return seen

    before = telemetry.registry().counter("serve.topk.batches")
    rec_b, launches, seen = _cli_json(
        [*leg, "--metrics-port", "0", "--health", "25,tenant-a=10",
         "--flight-dump", str(dump), "--telemetry-jsonl", str(jsonl),
         "--openmetrics", str(om)], on_side=scrape)
    batches = _hold_k4(rec_b, launches, "leg (b)")
    leg_launches["leg_b"] = launches
    check(seen is not None and "scrape" in seen,
          f"no mid-run scrape carried the sharded latency histogram: {seen}")
    plain, labeled = seen["scrape"]
    check(seen["health"] <= {200, 503} and seen["health"],
          f"/health answered {seen['health']}")
    final, _ = parse_openmetrics(om.read_text())
    check(final["rp_serve_topk_batches_total"] - before == batches,
          f"serve.topk.batches moved {final['rp_serve_topk_batches_total']} - "
          f"{before}, the server served {batches} batches")
    log(f"ops leg (b): mid-run scrape parsed ({len(plain)} samples, "
        f"{len(labeled['rp_serve_latency_sharded_seconds_bucket'])} "
        f"rp_serve_latency_sharded buckets), /health {sorted(seen['health'])}, "
        f"serve.topk.batches +{batches} == the server's batches == K4's scans")
    log("ops legs at R/2, (a) no live plane | (b) metrics endpoint, health, "
        "flight recorder, JSONL:")
    for label in sorted(rec_a["labels"]):
        a, b = rec_a["labels"][label], rec_b["labels"][label]
        log(f"  {label}: " + "  ".join(
            f"{k} {a[k]} | {b[k]}" for k in
            ("p50_ms", "p90_ms", "p99_ms", "p99.9_ms", "count", "rejects")))
    log(f"  served {rec_a['served_qps']} | {rec_b['served_qps']} req/s, "
        f"max_lag_s {rec_a['max_lag_s']} | {rec_b['max_lag_s']}, batches "
        f"{rec_a['server']['batches']} | {rec_b['server']['batches']}")

    # 4. the doctor on (b)'s telemetry file
    import contextlib
    import io

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        cli.main(["doctor", str(jsonl)])
    check("serve latency" in text.getvalue()
          and "sharded[tenant-a]" in text.getvalue(),
          "doctor rendered no serving latency table")
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        cli.main(["doctor", "--json", str(jsonl)])
    report = json.loads(text.getvalue())
    for label, row in rec_b["labels"].items():
        got = report["latency"][f"sharded[{label}]"]["p99"]
        exact = row["p99_ms"] / 1e3
        # the doctor's quantile is within one log2 bucket of the exact one
        check(exact / 2 <= got <= exact * 2,
              f"doctor p99 {got} s for {label}, loadgen's exact {exact} s")
        log(f"ops doctor: {label} p99 {got * 1e3:.3f} ms (log2 buckets) "
            f"against loadgen's exact {row['p99_ms']} ms")

    # 2c. bursty arrivals against a target every request misses
    jsonl_c = root / "c.jsonl"

    def watch_health(port):
        codes = []
        deadline = time.monotonic() + OPS_LEG_S + OPS_SETTLE_S + 60
        while time.monotonic() < deadline and cli._METRICS_SERVER is not None:
            try:
                code = _http(f"http://127.0.0.1:{port}/health")[0]
            except OSError:
                break
            if not codes or codes[-1] != code:
                codes.append(code)
            if codes[-2:] == [503, 200]:
                break
            time.sleep(0.1)
        return codes

    rec_c, launches, codes = _cli_json(
        [*base, "--rate", str(half), "--duration", str(OPS_LEG_S),
         "--arrival", "bursty", "--burst-factor", "8", "--burst-fraction",
         "0.125", "--burst-period", "1", "--settle", str(OPS_SETTLE_S),
         "--metrics-port", "0", "--health",
         "0.001,fast=1,slow=2.5,tick=0.1,stall=30",
         "--telemetry-jsonl", str(jsonl_c)], on_side=watch_health)
    _hold_k4(rec_c, launches, "leg (c)")
    leg_launches["leg_c"] = launches
    check(rec_c["schedule_sha256"] != rec_a["schedule_sha256"]
          and rec_b["schedule_sha256"] == rec_a["schedule_sha256"],
          "legs (a) and (b) must share a schedule, (c) another")
    check(codes is not None and 503 in codes
          and codes[codes.index(503):][-1] == 200,
          f"/health during the bursty leg and its settle: {codes}")
    statuses = {e.get("status") for e in telemetry.read_events(str(jsonl_c))
                if e["event"] == telemetry.EVENTS.HEALTH_SLO_BURN}
    check({"firing", "cleared"} <= statuses,
          f"health.slo_burn statuses {statuses}")
    log(f"ops leg (c) bursty (x8 for 1/8 of each second) at R/2: "
        f"{_labels_line(rec_c)}; rejects {rec_c['rejects']}, max_lag_s "
        f"{rec_c['max_lag_s']}; /health {codes}; health.slo_burn "
        f"{sorted(statuses)}")

    # 5. topk-bench on the card
    tb = ["topk-bench", "--code-bytes", str(SIGN_BITS // 8)]
    rec, launches, _ = _cli_json([*tb, "--index-codes", str(N_CODES)])
    check(rec["topk_impl"] == "wgmma" and rec["direct_queries_per_s"] > 0,
          f"topk-bench at 2^24: {rec}")
    leg_launches["topk_bench_2p24"] = launches
    log(f"ops topk-bench at {N_CODES} codes: direct "
        f"{rec['direct_queries_per_s']} q/s, server "
        f"{rec['server_queries_per_s']} q/s ({rec['server_batches']} "
        f"batches, p99 {rec['server_latency']['p99'] * 1e3:.3f} ms), "
        f"launches {launches}")
    rec, launches, _ = _cli_json([*tb, "--index-codes", str(LSH_N),
                                  "--probes", "4,16"])
    curve = rec["lsh"]["curve"]
    check(rec["lsh"]["probe_path_resolved"] == "device"
          and all(0 <= p["recall_at_m"] <= 1 for p in curve),
          f"topk-bench LSH leg: {rec['lsh']}")
    leg_launches["topk_bench_lsh"] = launches
    log(f"ops topk-bench at {LSH_N} codes, probes 4,16: " + "; ".join(
        f"p{p['probes']} recall@{TOPK_M} {p['recall_at_m']} at "
        f"{p['queries_per_s']} q/s" for p in curve)
        + f" (exact {rec['direct_queries_per_s']} q/s); device rung "
        f"dispatches {rec['lsh']['lsh_device_dispatches']}, fallbacks "
        f"{rec['lsh']['lsh_fallbacks']}, launches {launches}")
    chunk = LSH_N // 8 * (SIGN_BITS // 8)
    rec, launches, _ = _cli_json([*tb, "--index-codes", str(LSH_N),
                                  "--hbm-budget", str(4 * chunk)])
    tier = rec["tiered"]
    check(tier["parity_ok"] and tier["fallbacks"] == 0
          and tier["hot_chunks"] == 4 and tier["cold_chunks"] == 4,
          f"topk-bench tiered leg: {tier}")
    log(f"ops topk-bench tiered at {LSH_N} codes, 4 of 8 chunks hot: "
        f"{tier['queries_per_s']} q/s (x{tier['slowdown_vs_direct']} of "
        f"direct), hot-hit {tier['hot_hit_fraction']}, cold fetch p99 "
        f"{tier['cold_fetch_p99_s']} s, parity ok, 0 fallbacks")

    # 6. the smokes and recover as subprocesses on the card
    for mod, word in (("health_smoke", "health-smoke OK"),
                      ("live_smoke", "live-smoke OK")):
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", f"randomprojection_tpu_torch.utils.{mod}"],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        check(r.returncode == 0 and word in r.stdout,
              f"{mod} exited {r.returncode}: {r.stderr[-3000:]}")
        log(f"ops {mod} on the card: OK in {time.perf_counter() - t0:.1f} s")
    r = subprocess.run(
        [sys.executable, "-m", "randomprojection_tpu_torch", "recover",
         snapshot], cwd=ROOT, capture_output=True, text=True, timeout=300)
    status = json.loads(r.stdout.strip().splitlines()[-1])
    check(r.returncode == 0 and status["ok"], f"recover: {status}")
    log(f"ops recover {Path(snapshot).name}: ok, {status.get('chunks')} "
        f"chunk(s), coverage_ok {status.get('coverage_ok')}")
    shutil.rmtree(root, ignore_errors=True)
    log(f"ops planes: {time.perf_counter() - t_phase:.1f} s")
    return leg_launches, rate



def _same_topk(got, want, what: str, ids=np.int64) -> None:
    """A sharded answer (int64 ids; ``ids`` for another index) against a
    one-device one, bit for bit."""
    check(got[1].dtype == ids, f"{what}: ids are {got[1].dtype}")
    check(np.array_equal(got[0], want[0])
          and np.array_equal(got[1], np.asarray(want[1], dtype=np.int64)),
          f"{what}: the sharded answer differs from the one-device index's")


def _cli_sub(argv, jsonl: Path):
    """One CLI command as a subprocess on the card with a telemetry JSONL:
    its last stdout line parsed and the JSONL's event names counted."""
    from randomprojection_tpu_torch.utils import telemetry

    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "randomprojection_tpu_torch", *argv,
         "--telemetry-jsonl", str(jsonl)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    check(r.returncode == 0, f"{argv[0]} exited {r.returncode}: "
          f"{r.stderr[-3000:]}")
    counts: dict = {}
    for e in telemetry.read_events(str(jsonl)):
        counts[e["event"]] = counts.get(e["event"], 0) + 1
    return (json.loads(r.stdout.strip().splitlines()[-1]), counts,
            time.perf_counter() - t0)


def phase_sharded(torch, tk, pk, rate: float, scratch: Path) -> dict:
    """The sharded tier at config 4's serving width on the one card (see
    the module docstring, phase 16).  Returns K4's and K5's launches on
    its paths, each read around its own call."""
    from randomprojection_tpu_torch.ann import (
        LSHShardedSimHashIndex,
        LSHSimHashIndex,
    )
    from randomprojection_tpu_torch.models.sketch import SimHashIndex
    from randomprojection_tpu_torch.serving import (
        ShardedSimHashIndex,
        ShardedTopKServer,
    )
    from randomprojection_tpu_torch.utils import telemetry

    t_phase = time.perf_counter()
    root = scratch / "sharded"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    card = torch.device("cuda", 0)
    launches = {}
    # phase 15's corpus: loadgen's first draw from seed 0
    codes = np.random.default_rng(0).integers(
        0, 256, size=(N_CODES, SIGN_BITS // 8), dtype=np.uint8)
    qsets = np.random.default_rng(16).integers(
        0, 256, size=(SHARD_CALLS + 1, N_QUERIES, SIGN_BITS // 8),
        dtype=np.uint8)
    one = SimHashIndex(codes, device=card)
    groups = [ShardedSimHashIndex(codes, devices=[card], n_shards=SHARDS)
              for _ in range(SHARD_REPLICAS)]
    sh = groups[0]
    check(sh.stats()["shard_rows"] == [N_CODES // SHARDS] * SHARDS,
          f"shard rows {sh.stats()['shard_rows']}")
    q = qsets[0]
    want = one.query_topk(q, TOPK_M, tile=QUERY_TILE)
    sh.query_topk(q, TOPK_M, tile=QUERY_TILE)  # warm
    tk.reset_launches()
    got = sh.query_topk(q, TOPK_M, tile=QUERY_TILE)
    torch.cuda.synchronize()
    launches["exact_tile"] = dict(tk.LAUNCHES)
    _same_topk(got, want, f"{SHARDS} shards, {N_QUERIES} queries")
    check(tk.LAUNCHES["rp_fused_topk_wgmma"] == SHARDS
          and tk.LAUNCHES["rp_topk_merge"] == SHARDS
          and tk.LAUNCHES["rp_fused_topk_popc"] == 0,
          f"one {N_QUERIES}-row tile over {SHARDS} shards launched "
          f"{tk.LAUNCHES}, not {SHARDS} scans + {SHARDS} merges")
    log(f"sharded: {SHARDS} shards of {N_CODES // SHARDS} codes on one card, "
        f"{N_QUERIES} queries at m = {TOPK_M}: dist and ids equal the "
        f"one-device index bit for bit (ids int64); K4 launches around one "
        f"call {launches['exact_tile']}")

    # q/s beside the one-device index, turns one, sharded, sharded, one
    walls = {"one-device": [], "sharded": []}
    merge_walls = []
    for way in ("one-device", "sharded", "sharded", "one-device"):
        index = one if way == "one-device" else sh
        before = sh.stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in range(1, SHARD_CALLS + 1):
            index.query_topk(qsets[c], TOPK_M, tile=QUERY_TILE)
        walls[way].append(time.perf_counter() - t0)
        if index is sh:
            after = sh.stats()
            merge_walls.append((after["merges"] - before["merges"],
                                after["merge_wall_s"] - before["merge_wall_s"]))
    qps = {way: [round(SHARD_CALLS * N_QUERIES / w, 1) for w in ws]
           for way, ws in walls.items()}
    log(f"sharded q/s ({SHARD_CALLS} calls of {N_QUERIES} queries a turn, "
        f"turns one-device, sharded, sharded, one-device): one-device "
        f"{qps['one-device']}, {SHARDS} shards {qps['sharded']}; the "
        f"sharded calls' host merges (merges, summed wall s) {merge_walls}, "
        f"{[round(w / n * 1e3, 3) for n, w in merge_walls]} ms a merge")

    # ids past int32
    wide = ShardedSimHashIndex(codes, devices=[card], n_shards=SHARDS,
                               id_offset=SHARD_OFFSET)
    dw, iw = wide.query_topk(q, TOPK_M, tile=QUERY_TILE)
    _same_topk((dw, iw - SHARD_OFFSET), want, "id_offset")
    check(int(iw.min()) > 2**31, "ids past int32 did not surface")
    wide.close()
    del wide
    log(f"sharded: id_offset 2^31 + 13: the same distances, every id "
        f"shifted by it (smallest {int(iw.min())})")

    # the replicas behind ShardedTopKServer, 16 clients
    pool = qsets.reshape(-1, SIGN_BITS // 8)
    reqs = [pool[r * REQUEST_ROWS:(r + 1) * REQUEST_ROWS]
            for r in range(CLIENTS * REQUESTS)]
    # a name of its own: the latency histograms are keyed by it, and
    # phase 15's servers used the default
    server = ShardedTopKServer(groups, TOPK_M, max_batch=SHARD_SERVER_BATCH,
                               max_delay_s=0.002, name="chip-smoke-sharded")
    try:
        server.query(reqs[0])  # warm
        results = [None] * len(reqs)

        def client(ci):
            futs = [(r, server.submit(reqs[r]))
                    for r in range(ci, len(reqs), CLIENTS)]
            for r, f in futs:
                results[r] = f.result(timeout=300)

        threads = [threading.Thread(target=client, args=(ci,), daemon=True)
                   for ci in range(CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        srv_wall = time.perf_counter() - t0
    finally:
        server.close()
    st = server.stats()
    for r, req in enumerate(reqs):
        _same_topk(results[r], sh.query_topk(req, TOPK_M),
                   f"server request {r}")
    check(len(st["replica_batches"]) == SHARD_REPLICAS
          and min(st["replica_batches"]) > 0,
          f"replica batches {st['replica_batches']}")
    log(f"sharded server: {SHARD_REPLICAS} replicas x {SHARDS} shards, "
        f"{CLIENTS} clients x {REQUESTS} requests x {REQUEST_ROWS} rows "
        f"(max_batch {SHARD_SERVER_BATCH}): "
        f"{round(len(reqs) * REQUEST_ROWS / srv_wall, 1)} q/s, "
        f"{st['batches']} batches, replica_batches {st['replica_batches']}, "
        f"p99 {st['latency']['p99'] * 1e3:.3f} ms; every result equals a "
        f"direct call")
    for g in groups[1:]:
        g.close()
    del groups, server

    # 1% deleted, across shard boundaries
    span = N_CODES // SHARDS
    dead = np.unique(np.concatenate([
        np.random.default_rng(17).choice(N_CODES, N_CODES // 100,
                                         replace=False),
        np.arange(span - 5000, span + 5000),
        np.arange(3 * span - 100, 3 * span + 100)]))
    check(one.delete(dead) == dead.size and sh.delete(dead) == dead.size,
          "deletes")
    want_d = one.query_topk(q, TOPK_M, tile=QUERY_TILE)
    _same_topk(sh.query_topk(q, TOPK_M, tile=QUERY_TILE), want_d,
               f"{dead.size} deleted across shard boundaries")
    log(f"sharded: {dead.size} codes deleted (1% seeded and two ranges "
        f"across shard boundaries): equal the one-device index bit for bit")

    # the snapshot, loaded onto 4 shards and as one index
    snap = root / "snap"
    t0 = time.perf_counter()
    man = sh.save(str(snap))
    t_save = time.perf_counter() - t0
    check(man["sharded"] == {"shards": SHARDS} and "id_offset" not in man,
          f"sharded manifest {man.get('sharded')}")
    t0 = time.perf_counter()
    four = ShardedSimHashIndex.load(str(snap), devices=[card], n_shards=4)
    t_four = time.perf_counter() - t0
    _same_topk(four.query_topk(q, TOPK_M, tile=QUERY_TILE), want_d,
               "snapshot loaded onto 4 shards")
    four.close()
    del four
    t0 = time.perf_counter()
    plain = SimHashIndex.load(str(snap), device=card)
    t_plain = time.perf_counter() - t0
    _same_topk(plain.query_topk(q, TOPK_M, tile=QUERY_TILE), want_d,
               "snapshot loaded as one index", ids=np.int32)
    del plain, one, sh, codes
    shutil.rmtree(snap, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"sharded snapshot ({SHARDS} shards, {dead.size} deleted): save "
        f"{t_save:.3f} s, load onto 4 shards {t_four:.3f} s, as one index "
        f"{t_plain:.3f} s; both answer bit for bit")

    # the LSH tier's cell over 8 shards
    lsh_codes, lsh_q = _lsh_data()
    Q = lsh_q[:LSH_NQ]
    kw = dict(bands=LSH_BANDS, band_bits=LSH_BAND_BITS, fallback_density=1.0)
    one_lsh = LSHSimHashIndex(lsh_codes, device=card, **kw)
    sh_lsh = LSHShardedSimHashIndex(lsh_codes, devices=[card],
                                    n_shards=SHARDS, **kw)
    exact = one_lsh.query_topk(Q, LSH_M, tile=LSH_TILE, probes=0)
    reg = telemetry.registry()
    full = 1 << LSH_BAND_BITS
    Qf = Q[:SHARD_FULL_NQ]
    fb0 = reg.counter("index.lsh.fallbacks")
    pk.reset_launches()
    tk.reset_launches()
    t0 = time.perf_counter()
    got = sh_lsh.query_topk(Qf, LSH_M, tile=LSH_TILE, probes=full)
    t_full = time.perf_counter() - t0
    launches["lsh_full"] = {**tk.LAUNCHES, **pk.LAUNCHES,
                            "graph_replays": pk.GRAPH_REPLAYS,
                            "graph_captures": pk.GRAPH_CAPTURES}
    _same_topk(got, (exact[0][:SHARD_FULL_NQ], exact[1][:SHARD_FULL_NQ]),
               f"full coverage ({full} probes a band) over {SHARDS} shards")
    # the probe plan clamps a shard's tile; each tile is one replay of its
    # graph, and each capture runs the tile once eagerly first
    tq = sh_lsh._shards[0]._lsh_device_tile(LSH_TILE, full, LSH_M)
    tiles = SHARDS * -(-SHARD_FULL_NQ // tq)
    runs = pk.GRAPH_REPLAYS + pk.GRAPH_CAPTURES
    check(reg.counter("index.lsh.fallbacks") == fb0
          and pk.GRAPH_REPLAYS == tiles
          and tk.LAUNCHES["rp_fused_topk_wgmma"] == runs
          and tk.LAUNCHES["rp_topk_merge"] == runs
          and pk.LAUNCHES["rp_probe"] == 2 * runs,
          f"full coverage launched {launches['lsh_full']} for {tiles} "
          f"shard tiles, fallbacks {reg.counter('index.lsh.fallbacks') - fb0}")
    log(f"sharded LSH full coverage ({SHARD_FULL_NQ} queries, {LSH_BANDS} "
        f"bands x {full} probes, {SHARDS} shards of {LSH_N // SHARDS} codes, "
        f"the plan's tile {tq}) on the device rung: equal to the exact "
        f"answer bit for bit in {t_full:.3f} s; launches "
        f"{launches['lsh_full']}: K5 twice and K4 once a shard tile (a "
        f"capture's eager warm-up included)")
    # probes 16: recall@10 and q/s beside the one-device LSH index
    p = LSH_PROBES[-1]
    rows = {}
    for name, index in (("one-device", one_lsh), ("sharded", sh_lsh)):
        index.query_topk(Q, LSH_M, tile=LSH_TILE, probes=p)  # warm: capture
        fb0 = reg.counter("index.lsh.fallbacks")
        pk.reset_launches()
        tk.reset_launches()
        d, i = index.query_topk(Q, LSH_M, tile=LSH_TILE, probes=p)
        torch.cuda.synchronize()
        lau = {**tk.LAUNCHES, **pk.LAUNCHES,
               "graph_replays": pk.GRAPH_REPLAYS,
               "fallbacks": reg.counter("index.lsh.fallbacks") - fb0}
        hits = sum(np.intersect1d(a, b).size for a, b in zip(i, exact[1]))
        t0 = time.perf_counter()
        for c in range(1, LSH_CALLS + 1):
            index.query_topk(lsh_q[c * LSH_NQ:(c + 1) * LSH_NQ], LSH_M,
                             tile=LSH_TILE, probes=p)
        wall = time.perf_counter() - t0
        rows[name] = {"recall": round(hits / exact[1].size, 4),
                      "qps": round(LSH_CALLS * LSH_NQ / wall, 1),
                      "launches": lau}
    tiles = -(-LSH_NQ // LSH_TILE)
    sl = rows["sharded"]["launches"]
    launches["lsh_probes16"] = sl
    check(sl["rp_fused_topk_wgmma"] == sl["rp_topk_merge"] == SHARDS * tiles
          and sl["rp_probe"] == 2 * sl["graph_replays"]
          and sl["graph_replays"] == SHARDS * tiles - sl["fallbacks"],
          f"probes {p} over {SHARDS} shards launched {sl}")
    log(f"sharded LSH at probes {p} ({LSH_NQ} queries, tile {LSH_TILE}): "
        f"recall@{LSH_M} {rows['sharded']['recall']} at "
        f"{rows['sharded']['qps']} q/s over {SHARDS} shards, one-device "
        f"{rows['one-device']['recall']} at {rows['one-device']['qps']} q/s; "
        f"launches a call, {SHARDS} shards {sl}, one device "
        f"{rows['one-device']['launches']}")
    del one_lsh, sh_lsh, lsh_codes, lsh_q
    torch.cuda.empty_cache()

    # the CLI as subprocesses on the card
    for mod, word in (("serving.smoke", "shard-smoke OK"),
                      ("ann.smoke", "ann-smoke OK")):
        r = subprocess.run(
            [sys.executable, "-m", f"randomprojection_tpu_torch.{mod}"],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        check(r.returncode == 0 and word in r.stdout,
              f"{mod} exited {r.returncode}: {r.stderr[-3000:]}")
    rec, ev, wall = _cli_sub(
        ["topk-bench", "--index-codes", str(N_CODES), "--code-bytes",
         str(SIGN_BITS // 8), "--m", str(TOPK_M), "--shards", str(SHARDS),
         "--replicas", str(SHARD_REPLICAS)], root / "tb.jsonl")
    shd = rec["sharded"]
    check(shd["shards"] == SHARDS and shd["replicas"] == SHARD_REPLICAS
          and min(shd["replica_batches"]) > 0
          and ev.get("serve.shard.batch", 0) > 0 and ev.get("shard.merge", 0) > 0,
          f"topk-bench --shards {SHARDS}: {shd}, events {ev}")
    log(f"sharded topk-bench --shards {SHARDS} --replicas {SHARD_REPLICAS} "
        f"(subprocess, {wall:.1f} s): sharded {shd['queries_per_s']} q/s "
        f"beside the one-device server {rec['server_queries_per_s']} q/s and "
        f"direct {rec['direct_queries_per_s']} q/s; {shd['merges']} merges "
        f"({shd['merge_wall_s']} s), replica_batches "
        f"{shd['replica_batches']}; serve.shard.batch "
        f"{ev['serve.shard.batch']}, shard.merge {ev['shard.merge']} events")
    rec, ev, wall = _cli_sub(
        ["loadgen", "--index-codes", str(N_CODES), "--code-bytes",
         str(SIGN_BITS // 8), "--m", str(TOPK_M), "--request-rows",
         "16,64,256", "--labels", "tenant-a,tenant-b", "--seed", "0",
         "--server-batch", str(MAX_BATCH), "--server-delay-ms", "2",
         "--shards", str(SHARDS), "--rate", str(rate / 2), "--duration",
         str(SHARD_LOADGEN_S)], root / "lg.jsonl")
    batches = rec["server"]["batches"]
    check(rec["shards"] == SHARDS and rec["errors"] == 0
          and ev.get("serve.shard.batch", 0) == batches
          and ev.get("shard.merge", 0) == batches
          and ev.get("topk.kernel.dispatch", 0) == SHARDS * batches,
          f"loadgen --shards {SHARDS}: {batches} batches, events {ev}")
    log(f"sharded loadgen --shards {SHARDS} at R/2 = {rate / 2} req/s x "
        f"{SHARD_LOADGEN_S} s (subprocess, {wall:.1f} s): {_labels_line(rec)}; "
        f"rejects {rec['rejects']}, max_lag_s {rec['max_lag_s']}, {batches} "
        f"batches, each {SHARDS} K4 dispatches and one merge "
        f"(serve.shard.batch {ev['serve.shard.batch']}, shard.merge "
        f"{ev['shard.merge']}, topk.kernel.dispatch "
        f"{ev['topk.kernel.dispatch']})")
    shutil.rmtree(root, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    log(f"sharded phase: {wall:.1f} s")
    return launches


# -- config 3 DP x TP (phase 17) --------------------------------------------------


def _c3_model(torch, shape=None, **opts):
    """Config 3's model (16,384 -> 512, density 1/sqrt(d), seed 0) on the
    card, or on a mesh of ``shape`` naming the card at every position
    (DP x TP where the shape has a feature axis)."""
    from randomprojection_tpu_torch import SparseRandomProjection
    from randomprojection_tpu_torch.parallel import make_mesh

    if shape is not None:
        card = torch.device("cuda", 0)
        opts["mesh"] = make_mesh(shape, devices=[card] * int(np.prod(
            list(shape.values()))))
        if "feature" in shape:
            opts["feature_axis"] = "feature"
    return SparseRandomProjection(
        C3_COMPONENTS, density="auto", random_state=0,
        backend_options=opts).fit_schema(TP_ROWS, C3_FEATURES, np.float32)


def _rel_err(torch, got, want) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


def _k1_shard(torch, fk, x) -> dict:
    """K1 at a feature shard's shape (32,768 x 8,192 -> 512 split2, the
    column view of a 131,072-row batch's last row block and second feature
    shard, block offset 16): held to its plain version at offsets 0 and 16
    on 1,024 rows, then timed beside its bound, the plain version and a
    float32 ``torch.matmul`` against the materialized column shard."""
    from randomprojection_tpu_torch.ops.precision import fp32_matmul

    k, w = C3_COMPONENTS, C3_FEATURES // TP_MESH["feature"]
    rows = TP_BATCH // TP_MESH["data"]
    density = 1.0 / np.sqrt(C3_FEATURES)
    err = 0.0
    for j in range(TP_MESH["feature"]):
        view = x[:1024, j * w:(j + 1) * w]
        off = j * w // fk.BLOCK_D
        got = fk.rp_fused_project(view, 0, k, density, block_offset=off,
                                  mxu_mode="split2")
        want = fk.fused_project(view, 0, k, density, block_offset=off,
                                mxu_mode="split2")
        e = (got - want).abs().max().item()
        check(e <= TOL * want.abs().max().item(),
              f"K1 at block offset {off} off its plain version by {e:.3e}")
        err = max(err, e)
    view = x[TP_BATCH - rows:, w:]
    m = fk.rp_lazy_matrix(0, k, w, density, block_offset=w // fk.BLOCK_D)
    nnz = int(torch.count_nonzero(m).item())

    def library():
        with fp32_matmul():
            return torch.matmul(view, m.t())

    row = {
        "shape": f"{rows}x{w}->{k} split2 at block offset "
                 f"{w // fk.BLOCK_D}, a column view of a "
                 f"{C3_FEATURES}-wide batch",
        "ms": cuda_ms(lambda: fk.rp_fused_project(
            view, 0, k, density, block_offset=w // fk.BLOCK_D,
            mxu_mode="split2"), reps=20, warmup=2),
        "plain_ms": cuda_ms(lambda: fk.fused_project(
            view, 0, k, density, block_offset=w // fk.BLOCK_D,
            mxu_mode="split2"), reps=3),
        "library_ms": cuda_ms(library, reps=20, warmup=2),
        "max_abs_err": err,
        "mask_nonzeros": nnz,
    }
    row.update(_bound((4 * rows * w + 4 * rows * k) / HBM_BYTES_PER_S,
                      2 * rows * nnz / FP32_FLOP_PER_S))
    log(f"rp_fused_project at a feature shard's shape {row['shape']}: "
        f"{row['ms']:.3f} ms (mask cache included), bound "
        f"{row['bound_ms']:.3f} ms by {row['bound_by']} "
        f"({row['bound_ms'] / row['ms']:.1%} of it), plain "
        f"{row['plain_ms']:.3f} ms, library {row['library_ms']:.3f} ms "
        f"(torch.matmul fp32 of the materialized column shard, TF32 off); "
        f"offsets 0 and 16 on 1,024 rows vs plain max|d|={err:.3e}")
    del m
    return row


def tp_rank(rank: int, port: int, out: str) -> int:
    """One rank of phase 17's two-process job (gloo, both ranks on the
    card): the global mesh {"feature": 2, "data": 1}, each rank owning one
    feature shard, so the TP reduction crosses the process boundary."""
    import torch

    from randomprojection_tpu_torch.ops import fused_kernels as fk
    from randomprojection_tpu_torch.parallel import distributed, global_mesh

    distributed.initialize(f"127.0.0.1:{port}", 2, rank)
    mesh = global_mesh({"feature": 2, "data": 1}, ["cuda:0"])
    est = _c3_model(torch, mesh=mesh, feature_axis="feature",
                    materialization="lazy")
    g = torch.Generator(device="cuda").manual_seed(2000)
    x = torch.empty((TP_TWO_ROWS, C3_FEATURES), device="cuda")
    x.normal_(generator=g)
    est.transform(x)  # warm: the group's first collective
    torch.cuda.synchronize()
    fk.reset_launches()
    t0 = time.perf_counter()
    y = est.transform(x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    np.save(out, y.cpu().numpy())
    print(json.dumps({"rank": rank, "ranks": mesh.ranks.tolist(),
                      "launches": dict(fk.LAUNCHES), "wall_s": wall}))
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_all(argvs, timeout: float = 300) -> list:
    """Run the commands at once from the repository root; every one must
    exit 0.  Returns their stdouts."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    procs = [subprocess.Popen(a, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for a in argvs]
    outs = [p.communicate(timeout=timeout) for p in procs]
    for a, p, (so, se) in zip(argvs, procs, outs):
        check(p.returncode == 0, f"{a[1:4]} exited {p.returncode}: "
              f"{se[-2000:]}")
    return [so for so, _ in outs]


def phase_scale_out(torch, fk, scratch: Path) -> dict:
    """Config 3 DP x TP on the one card (see the module docstring, phase
    17).  Returns K1's and the mask cache's launches by leg, each read
    around its own call, and K1's row at a feature shard's shape."""
    import scipy.sparse as sp

    t_phase = time.perf_counter()
    card = torch.device("cuda", 0)
    n, k = TP_BATCH, C3_COMPONENTS
    density = 1.0 / np.sqrt(C3_FEATURES)
    lazy = {"materialization": "lazy"}
    one = _c3_model(torch, **lazy)
    tp = _c3_model(torch, TP_MESH, **lazy)
    dp = _c3_model(torch, {"data": 8}, **lazy)
    check(tp.density_ == density, f"density {tp.density_}")
    x = torch.empty((n, C3_FEATURES), device=card)
    g = torch.Generator(device=card)
    launches = {}

    def counted(leg, fn):
        fn()  # warm
        torch.cuda.synchronize()
        fk.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        launches[leg] = {key: v for key, v in fk.LAUNCHES.items() if v}
        return out

    # (a) lazy DP x TP over 2^20 rows, each batch against one device
    worst = 0.0
    for b in range(TP_ROWS // n):
        g.manual_seed(1000 + b)
        x.normal_(generator=g)
        want = one.transform(x)
        got = (counted("lazy_dp_tp_batch", lambda: tp.transform(x)) if b == 0
               else tp.transform(x))
        check(got.shape == (n, k) and bool(torch.isfinite(got).all()),
              "DP x TP output not finite or of the wrong shape")
        worst = max(worst, _rel_err(torch, got, want))
    check(worst <= TOL, f"lazy DP x TP off one device by {worst:.3e}·max|Y|")
    check(launches["lazy_dp_tp_batch"] == {"rp_fused_project": 8,
                                           "rp_mask_cache": 2},
          f"one DP x TP batch launched {launches['lazy_dp_tp_batch']}, not "
          "8 K1 + 2 mask caches")
    eps = distortion(tp, x[:SAMPLE])
    check(eps <= DISTORTION_BUDGET, f"DP x TP distortion {eps:.3e}")
    log(f"scale-out (a) lazy DP x TP {TP_MESH} on one card: {TP_ROWS // n} "
        f"batches of {n} x {C3_FEATURES} -> {k}, max|d| {worst:.3e}·max|Y| "
        f"against one device (tolerance {TOL}); launches around one batch "
        f"{launches['lazy_dp_tp_batch']}; distortion of {SAMPLE} rows "
        f"{eps:.3e} (budget {DISTORTION_BUDGET})")
    k1 = _k1_shard(torch, fk, x)

    # the same 8 K1 launches without the shared mask: the reference's design
    rows, w = n // TP_MESH["data"], C3_FEATURES // TP_MESH["feature"]

    def unshared():
        y = torch.empty((n, k), device=card)
        for i in range(TP_MESH["data"]):
            r = slice(i * rows, (i + 1) * rows)
            fk.rp_fused_project(x[r, :w], 0, k, density, mxu_mode="split2",
                                out=y[r])
            y[r] += fk.rp_fused_project(x[r, w:], 0, k, density,
                                        block_offset=w // fk.BLOCK_D,
                                        mxu_mode="split2")
        return y

    y_unshared = counted("lazy_dp_tp_unshared_mask", unshared)
    check(torch.equal(y_unshared, got), "the unshared-mask launches differ")
    check(launches["lazy_dp_tp_unshared_mask"] == {"rp_fused_project": 8,
                                                   "rp_mask_cache": 8},
          f"unshared {launches['lazy_dp_tp_unshared_mask']}")
    del y_unshared

    # (b) lazy DP: bit for bit one device
    got = counted("lazy_dp_batch", lambda: dp.transform(x))
    check(torch.equal(got, want), "lazy DP {data: 8} differs from one device")
    check(launches["lazy_dp_batch"] == {"rp_fused_project": 8,
                                        "rp_mask_cache": 1},
          f"one DP batch launched {launches['lazy_dp_batch']}")
    log(f"scale-out (b) lazy DP {{'data': 8}}: equal to one device bit for "
        f"bit; launches {launches['lazy_dp_batch']}")

    # (c) dense TP (the example's default) and (d) split2 TP
    routes = {"one-device lazy": one, "lazy DP x TP": tp, "lazy DP": dp}
    for label, opts in (("dense TP", {}), ("split2 TP", {"precision":
                                                         "split2"})):
        est, ref1 = _c3_model(torch, TP_MESH, **opts), _c3_model(torch, **opts)
        full = ref1.components_ if not opts else ref1.components_.mask
        shards = est.components_ if not opts else est.components_.mask
        check(len(shards.blocks) == TP_MESH["feature"],
              f"{label}: {len(shards.blocks)} column shards")
        for (_, (c0, c1)), blk in shards.blocks.items():
            check(torch.equal(blk, full[:, c0:c1]),
                  f"{label}: shard [{c0}, {c1}) differs from the columns")
        e = _rel_err(torch, counted(label.replace(" ", "_"),
                                    lambda: est.transform(x)),
                     ref1.transform(x))
        check(e <= TOL, f"{label} off one device by {e:.3e}·max|Y|")
        log(f"scale-out ({'c' if not opts else 'd'}) {label}: "
            f"materialize_sharded's {len(shards.blocks)} shards equal the "
            f"full matrix's columns bit for bit; max|d| {e:.3e}·max|Y| "
            f"against one device")
        routes[label] = est
        del ref1

    # (e) rows/s of every route in turns, CUDA events and the host clock
    rates = {label: [] for label in routes}
    order = list(routes) + list(routes)[::-1]
    for label in order * (TP_TURNS // 2):
        est = routes[label]
        ms = cuda_ms(lambda: est.transform(x), reps=5, warmup=1)
        t0 = time.perf_counter()
        for _ in range(5):
            est.transform(x)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / 5 * 1e3
        rates[label].append({"rows_per_s": n / ms * 1e3,
                             "host_rows_per_s": n / host_ms * 1e3,
                             "ms": ms})
    unshared_ms = cuda_ms(unshared, reps=5, warmup=1)
    log(f"scale-out (e) rows/s of a {n}-row batch, turns "
        + " ".join(order) + ": "
        + "; ".join(f"{lab} " + ", ".join(
            f"{r['rows_per_s']:.1f} ({r['host_rows_per_s']:.1f} host)"
            for r in rs) for lab, rs in rates.items())
        + f"; the 8 K1 launches without the shared mask {unshared_ms:.3f} ms "
        f"a batch against {rates['lazy DP x TP'][0]['ms']:.3f}")
    del routes, est

    # (f) a two-process job on the card: gloo, the feature shards in two
    # ranks; and host_row_range streaming through the multihost example
    root = scratch / "scale_out"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    port = _free_port()
    mh_port = _free_port()
    mh = [sys.executable, "-m", "randomprojection_tpu_torch.examples.multihost",
          "--rows", "65536", "--d", "4096", "--k", "256", "--batch-rows",
          "8192", "--materialization", "lazy"]
    mh_ranks = [[*mh, "--coordinator", f"127.0.0.1:{mh_port}",
                 "--num-processes", "2", "--process-id", str(r), "--out",
                 str(root / f"mh{r}.npy")] for r in range(2)]
    outs = _run_all(
        [[sys.executable, str(ROOT / "chip_smoke.py"), TP_RANK_FLAG, str(r),
          str(port), str(root / f"y{r}.npy")] for r in range(2)]
        + mh_ranks + [[*mh, "--out", str(root / "mh.npy")]])
    metas = [json.loads(o.strip().splitlines()[-1]) for o in outs[:2]]
    y0, y1 = (np.load(root / f"y{r}.npy") for r in range(2))
    check(np.array_equal(y0, y1), "the two ranks' outputs differ")
    mesh2 = _c3_model(torch, {"feature": 2, "data": 1}, **lazy)
    g2 = torch.Generator(device="cuda").manual_seed(2000)
    x2 = torch.empty((TP_TWO_ROWS, C3_FEATURES), device=card)
    x2.normal_(generator=g2)
    want2 = mesh2.transform(x2).cpu().numpy()
    e2 = float(np.abs(y0 - want2).max() / np.abs(want2).max())
    check(e2 <= TOL, f"two-process TP off one process by {e2:.3e}·max|Y|")
    for m in metas:
        check(m["launches"] == {"rp_fused_project": 1, "rp_mask_cache": 1,
                                "rp_lazy_matrix": 0},
              f"rank {m['rank']} launched {m['launches']}")
    mh_meta = [json.loads(o.strip().splitlines()[-1]) for o in outs[2:]]
    got_mh = np.concatenate([np.load(root / f"mh{r}.npy") for r in range(2)])
    check(np.array_equal(got_mh, np.load(root / "mh.npy")),
          "the multihost example's rows differ from one process's")
    log(f"scale-out (f) two processes on the card (gloo, mesh "
        f"{{'feature': 2, 'data': 1}}, ranks {metas[0]['ranks']}): "
        f"{TP_TWO_ROWS} x {C3_FEATURES} -> {k} equal in both ranks bit for "
        f"bit, {e2:.3e}·max|Y| from one process; a call's wall "
        f"{metas[0]['wall_s'] * 1e3:.3f} and {metas[1]['wall_s'] * 1e3:.3f} "
        f"ms; launches a rank {metas[0]['launches']}; the multihost example "
        f"(2 ranks of host_row_range, lazy) {[m['row_range'] for m in mh_meta[:2]]}"
        f" equal one process's rows bit for bit ({mh_meta[0]['rows_per_s']}, "
        f"{mh_meta[1]['rows_per_s']} and one process {mh_meta[2]['rows_per_s']}"
        f" rows/s)")
    shutil.rmtree(root, ignore_errors=True)
    del x2, mesh2, one, tp, dp

    # (g) CountSketch over 8 positions at config 5's shape
    from randomprojection_tpu_torch import CountSketch
    from randomprojection_tpu_torch.ops.hashing import FeatureHasher
    from randomprojection_tpu_torch.parallel import make_mesh
    from randomprojection_tpu_torch.parallel.sharded import (
        token_balanced_bounds,
    )

    rng = np.random.default_rng(0)
    words = np.asarray([f"tok{i}" for i in range(C5_VOCAB)])
    toks = words[rng.integers(0, C5_VOCAB, size=BATCH * C5_TOKENS)]
    indptr = np.arange(0, BATCH * C5_TOKENS + 1, C5_TOKENS, dtype=np.int64)
    Xs = FeatureHasher(n_features=C5_FEATURES, input_type="string",
                       dtype=np.float32).transform_tokens(toks, indptr)
    Xs = sp.csr_array(Xs)
    mesh8 = make_mesh({"data": 8}, devices=[card] * 8)
    cs_m = CountSketch(C5_K, random_state=0, mesh=mesh8).fit(Xs)
    cs_1 = CountSketch(C5_K, random_state=0).fit(Xs)
    ym, y1 = cs_m.transform(Xs), cs_1.transform(Xs)
    check(ym.shape == (BATCH, C5_K) and np.isfinite(ym).all(), "sketch shape")
    check(np.allclose(ym, y1, rtol=C5_TOL, atol=C5_TOL),
          f"the mesh sketch off one device by {np.abs(ym - y1).max()}")
    counts = np.diff(Xs.indptr[token_balanced_bounds(Xs.indptr, 8)])
    row_max = int(np.diff(Xs.indptr).max())
    check(np.abs(counts - Xs.nnz / 8).max() <= row_max,
          f"shard tokens {counts.tolist()} off nnz/8 by more than a doc")
    sk_ms = {lab: cuda_ms(lambda: c._transform_csr_device(Xs), reps=3)
             for lab, c in (("mesh", cs_m), ("one", cs_1), ("mesh2", cs_m),
                            ("one2", cs_1))}
    log(f"scale-out (g) CountSketch({C5_K}) over {{'data': 8}} on one card, "
        f"{BATCH} docs x {C5_TOKENS} tokens at 2^20: within {C5_TOL} of one "
        f"device (max|d| {np.abs(ym - y1).max():.3e}); shard tokens "
        f"{counts.tolist()} (nnz/8 {Xs.nnz / 8:.1f}, a doc at most {row_max}); "
        f"the device sketch (layout and upload included) mesh "
        f"{sk_ms['mesh']:.3f}, {sk_ms['mesh2']:.3f} ms against one device "
        f"{sk_ms['one']:.3f}, {sk_ms['one2']:.3f} ms")
    del x
    torch.cuda.empty_cache()
    log(f"scale-out: phase {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "k1_shard": k1, "rates": rates,
            "unshared_mask_ms": unshared_ms}


def phase_lint() -> dict:
    """Phase 18: the port's linter over the tree it was checked out with,
    as a user runs it (host code: no card, no kernel)."""
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "randomprojection_tpu_torch", "lint",
         "--json", "--jobs", "4"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    process_s = time.perf_counter() - t0
    check(r.returncode == 0, f"lint exited {r.returncode}: "
          f"{r.stdout[-2000:]} {r.stderr[-2000:]}")
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    check(rec["ok"] is True and not rec["counts"],
          f"lint findings: {rec['counts']}")
    got = {"files": rec["files"], "suppressed": rec["suppressed"],
           "wall_s": rec["wall_s"], "process_s": round(process_s, 3)}
    log(f"lint: {json.dumps(got)}")
    return got


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
    try:
        if _PORT_MISSING is not None:
            raise _PORT_MISSING
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
    if sys.argv[1:] == [PROFILE_TURN_FLAG]:
        return profile_stream_turn()
    if sys.argv[1:2] == [TP_RANK_FLAG]:
        return tp_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    scratch = ROOT / "build" / "chip_smoke"
    if sys.argv[1:] == [SCALE_OUT_FLAG]:
        # the build and phase 17 alone: a quick check of the scale-out
        CARD = card_line()
        phase_build(build_mod)
        got = phase_scale_out(torch, fk, scratch)
        print(json.dumps(got, default=str))
        return 0
    try:
        CARD = card_line()
        log(f"card: {CARD}; torch.cuda: {torch.cuda.get_device_name(0)}; "
            f"torch {torch.__version__} CUDA {torch.version.cuda}")
        t0 = time.perf_counter()
        old = phase_build(build_mod)
        errs = {"rp_fused_project": 0.0, "rp_lazy_matrix": 0.0,
                "rp_mask_cache": 0.0, "rp_fused_topk": 0, "rp_probe": 0}
        phase_kernels(torch, fk, errs, old)
        est, X, counts, main_rate = phase_main_path(torch, rpt, fk, errs)
        phase_host_split(torch, rpt, fk, est, X,
                         [(lo, min(lo + BATCH, N_ROWS))
                          for lo in range(0, N_ROWS, BATCH)])
        phase_threefry(torch)
        phase_other_routes(torch, rpt, X)
        scratch.mkdir(parents=True, exist_ok=True)
        template = stream_template()
        phase_stream(est, streaming, scratch, template)
        stream_sha, first, stream_launches = phase_stream_main(
            torch, fk, streaming, est, template)
        profile_stream(first)
        phase_stream_faults(fk, streaming, est, template, scratch, stream_sha)
        del template, first
        kernels = phase_timing(torch, fk, est, X, counts, errs, old)
        # the streamed main path's launches, apart from the resident one's
        for row in kernels[:2]:
            row["stream_launches"] = {
                way: c[row["name"]] for way, c in stream_launches.items()}
        del X, est
        torch.cuda.empty_cache()
        codes, queries, topk_launches = phase_serving(torch, rpt, tk, errs)
        phase_topk_shapes(torch, tk, errs)
        kernels.append(timing_topk(torch, tk, codes, queries, topk_launches,
                                   errs))
        torch.cuda.empty_cache()
        index, lsh_codes, lsh_queries, probe_launches = phase_lsh(
            torch, pk, tk, errs)
        profile_lsh(torch, pk, index, lsh_queries)
        phase_lsh_wide(pk, tk, lsh_codes, lsh_queries)
        phase_probe_shapes(torch, pk, index, lsh_queries, errs)
        phase_lsh_full(pk)
        phase_lsh_server(index, lsh_queries)
        kernels.append(timing_probe(torch, pk, index, lsh_queries,
                                    probe_launches, errs))
        snapshot = phase_durable(torch, tk, codes, queries, index,
                                 lsh_queries, scratch)
        # each tiered path's launches apart from the serving path's
        tier_launches, lsh_launches = phase_tier(
            torch, tk, pk, codes, queries, lsh_codes, lsh_queries, index,
            scratch)
        rows = {r["name"]: r for r in kernels}
        rows["rp_fused_topk"]["tier_launches"] = tier_launches
        rows["rp_fused_topk"]["tier_lsh_launches"] = lsh_launches[0]
        rows["rp_probe"]["tier_lsh_launches"] = lsh_launches[1]
        del lsh_codes, codes, index
        torch.cuda.empty_cache()
        phase_config5(torch)
        phase_cli(scratch)
        phase_bench_shapes(torch, fk, tk, errs)
        for name in ("rp_fused_project", "rp_fused_topk"):
            rows[name]["max_abs_err"] = errs[name]
        legs = phase_bench(torch.cuda.get_device_name(0), main_rate)
        # the bench's path, apart from the main path's launches
        for name, keys in (
                ("rp_fused_project", ("rp_fused_project",)),
                ("rp_mask_cache", ("rp_mask_cache",)),
                ("rp_lazy_matrix", ("rp_lazy_matrix",)),
                ("rp_fused_topk", ("rp_fused_topk_wgmma", "rp_fused_topk_popc",
                                   "rp_topk_merge")),
                ("rp_probe", ("rp_probe",))):
            rows[name]["bench_launches"] = {
                leg: {key: got[key] for key in keys if got.get(key)}
                for leg, got in legs.items()
                if any(got.get(key) for key in keys)}
        # the ops planes' legs, each counted from 0
        ops, rate = phase_ops_planes(torch, snapshot, scratch)
        for name, keys in (
                ("rp_fused_topk", ("rp_fused_topk_wgmma", "rp_fused_topk_popc",
                                   "rp_topk_merge")),
                ("rp_probe", ("rp_probe",))):
            rows[name]["ops_launches"] = {
                leg: {key: got[key] for key in keys if got.get(key)}
                for leg, got in ops.items()
                if any(got.get(key) for key in keys)}
        # the sharded tier's paths, each counted from 0
        sharded = phase_sharded(torch, tk, pk, rate, scratch)
        for name, keys in (
                ("rp_fused_topk", ("rp_fused_topk_wgmma", "rp_topk_merge")),
                ("rp_probe", ("rp_probe",))):
            rows[name]["sharded_launches"] = {
                leg: {key: got[key] for key in keys if got.get(key)}
                for leg, got in sharded.items()
                if any(got.get(key) for key in keys)}
        # config 3 DP x TP: K1 and the mask cache a mesh position, each leg
        # counted from 0; K1 at a feature shard's shape
        scale_out = phase_scale_out(torch, fk, scratch)
        for name in ("rp_fused_project", "rp_mask_cache"):
            rows[name]["tp_launches"] = {
                leg: got[name] for leg, got in scale_out["launches"].items()
                if got.get(name)}
        rows["rp_fused_project"]["tp_shard"] = scale_out["k1_shard"]
        rows["rp_fused_project"]["tp_rates"] = scale_out["rates"]
        phase_lint()
        # the entry points whose runs launched each kernel
        for name in ("rp_fused_project", "rp_mask_cache"):
            rows[name]["paths"] = [
                "SparseRandomProjection(materialization='lazy')",
                "transform_stream", "benchmark", "TorchBackend(mesh=)"]
        rows["rp_fused_topk"]["paths"] = [
            "SimHashIndex", "TopKServer", "LSHSimHashIndex",
            "tiered SimHashIndex", "ShardedSimHashIndex",
            "ShardedTopKServer", "LSHShardedSimHashIndex"]
        rows["rp_probe"]["paths"] = [
            "LSHSimHashIndex", "tiered LSHSimHashIndex",
            "LSHShardedSimHashIndex"]
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
