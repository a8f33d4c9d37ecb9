"""Command-line interface: ``python -m randomprojection_tpu_torch <cmd>``.

The counterpart of ``randomprojection_tpu/cli.py``:

- ``jl-dim``        JL minimum dimension for (n, eps)
- ``info``          torch, CUDA, the card, and whether the CUDA kernels
                    and the murmur3 library build
- ``project``       project a .npy/.npz matrix, streamed, with checkpoint
                    and a fingerprint sidecar for resume
- ``stream-bench``  host-streamed throughput (rows/s with the copies to
                    and from the card)
- ``bench``         the data-resident bench (``benchmark.run``): every
                    config's rate on the card, the full record then a
                    compact last line of at most 2 KB
- ``topk-bench``    SimHash top-k serving queries/s, direct and through
                    the ``TopKServer`` micro-batcher (plus the LSH curve
                    and the tiered index on request)
- ``loadgen``       open-loop arrivals against the serving tier: the
                    ``topk_slo`` record of per-label tail latency
- ``recover``       a snapshot's status and checksums, or the crash
                    smoke (``--smoke``)
- ``doctor``        the critical-path report of a telemetry JSONL file
                    (alias ``report``), a flight-recorder postmortem
                    (``--postmortem``) or a live endpoint (``--live``)
- ``lint``          rplint (``analysis/``) over the package: exit 0
                    clean, 1 findings, 2 internal error

``--backend auto`` (the default) is the torch backend on ``--device``
(default ``cuda``): with no card the command exits naming it and never
carries on on the CPU; ``--device cpu`` asks for the CPU (for ``bench``
that runs the kernels' plain versions, every timing flagged suspect).
The live plane's flags (``--openmetrics``, ``--metrics-port``,
``--health``, ``--flight-dump``) run as the reference's do.  ``lint`` is
host code and takes no ``--device``.  ``topk-bench --shards``
and ``loadgen`` serve the sharded tier (``ShardedSimHashIndex`` groups
behind ``ShardedTopKServer``), every shard on ``--device``.
``--debug-nans`` and ``--disable-jit`` set JAX
options and ``--transform-dma`` picks the TPU kernel's DMA route: they
have no counterpart here and refuse too (``bench`` takes
``--transform-dma auto``, its default: the kernel's one route on the
card).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

import numpy as np

#: the reference's jax.config switches: no counterpart in torch
_JAX_FLAGS = ("debug_nans", "disable_jit")
#: the reference's TPU kernel switches: no counterpart on the card
_TPU_FLAGS = ("transform_dma",)

# the live MetricsServer while a --metrics-port command runs (set and
# cleared by main(); commands with per-run registries register them as
# scrape sources through _register_metrics_source, and the smokes read
# the bound port from here)
_METRICS_SERVER = None


def _register_metrics_source(fn) -> None:
    """Attach a snapshot source (e.g. ``stats.registry.snapshot``) to the
    live metrics endpoint when one is running; no-op otherwise."""
    server = _METRICS_SERVER
    if server is not None:
        server.add_source(fn)


def _add_common(p):
    p.add_argument("--backend", default="auto",
                   choices=["auto", "numpy", "torch"],
                   help="'auto' = the torch backend on --device")
    p.add_argument("--device", default="cuda",
                   help="torch device: 'cuda' (default; exits when there is "
                        "no card), 'cuda:N' or 'cpu'")
    p.add_argument("--prefetch-batches", type=int, default=0,
                   help="prefetch depth: run source production (reads, "
                        "hashing) and the early upload to the card on a "
                        "background worker thread, keeping up to this "
                        "many batches queued ahead of the consumer "
                        "(0 = synchronous)")
    p.add_argument("--ingest-workers", type=int, default=0,
                   help="staged multi-worker ingest: a pool of this many "
                        "workers producing disjoint batches (reassembled "
                        "in row order, bit-identical to serial) feeding "
                        "one uploader thread; 0/1 = single-worker (see "
                        "--prefetch-batches).  The queue depth between "
                        "the uploader and the consumer is "
                        "--prefetch-batches (default 2 when staged)")
    p.add_argument("--hash-threads", type=int, default=None,
                   help="worker threads for the C++ murmur3 batch hasher "
                        "(sets RP_HASH_THREADS; output is bit-identical "
                        "at any count; default: hardware concurrency)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--precision", default=None,
                   choices=["default", "high", "highest", "split2"],
                   help="torch backend precision mode")
    p.add_argument("--materialization", default=None,
                   choices=["dense", "lazy"],
                   help="torch backend: 'lazy' = the mask regenerated in "
                        "the fused CUDA kernel")
    p.add_argument("--transform-dma", default=None,
                   choices=["auto", "on", "off"],
                   help="the reference's TPU DMA route switch; refused "
                        "here (the fused kernel's x route is chosen from "
                        "the shape)")
    p.add_argument("--dispatch-steps", type=_positive_int, default=None,
                   metavar="K",
                   help="torch backend, lazy kernel: chain K row blocks of "
                        "each transform through one persistent launch "
                        "(bit-identical to K separate calls)")
    _add_observability(p)
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace (trace.json, Chrome/"
                        "Perfetto format) here")
    p.add_argument("--debug-nans", action="store_true",
                   help="the reference's jax_debug_nans switch; refused "
                        "here (no counterpart in torch)")
    p.add_argument("--disable-jit", action="store_true",
                   help="the reference's jax_disable_jit switch; refused "
                        "here (no counterpart in torch)")


def _add_observability(p):
    p.add_argument("--log-level", default="warning",
                   choices=["debug", "info", "warning", "error"])
    p.add_argument("--telemetry-jsonl", default=None, metavar="PATH",
                   help="append structured telemetry events (versioned "
                        "JSONL schema — see utils/telemetry.py) for every "
                        "pipeline stage, dispatch, commit and per-batch "
                        "tracing span to this file")
    p.add_argument("--openmetrics", default=None, metavar="PATH",
                   help="after the run, write an OpenMetrics/Prometheus "
                        "text exposition of the process metrics registry "
                        "(counters, gauges, stage-wall histograms) to "
                        "this file")
    p.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                   help="serve a live OpenMetrics endpoint at "
                        "http://127.0.0.1:PORT/metrics for the duration "
                        "of the command (0 = ephemeral port, printed to "
                        "stderr): registry counters/gauges, latency "
                        "histograms with p50/p90/p99/p99.9 summaries, and "
                        "a rolling LiveAggregator window of span walls and "
                        "time-weighted queue depth; poll it with "
                        "'doctor --live HOST:PORT'")
    p.add_argument("--health", nargs="?", const="", default=None,
                   metavar="SPEC",
                   help="run the health plane (utils/health.py) for the "
                        "duration of the command: SLO burn-rate, stall-"
                        "watchdog, queue-pinning and degraded-spike "
                        "detectors over the live event stream, emitting "
                        "firing/cleared health.* events and (with "
                        "--metrics-port) answering GET /health (200 ok / "
                        "503 while a critical detector fires).  SPEC, "
                        "comma-separated: a bare number = default p99 "
                        "target in ms, 'label=ms' = per-label target, and "
                        "the reserved keys budget/fast/slow/fire/clear/"
                        "stall/tick tune windows and thresholds (e.g. "
                        "'25,tenant-a=10,fast=2,slow=10')")
    p.add_argument("--flight-dump", default=None, metavar="PATH",
                   help="keep an in-memory flight recorder (ring of the "
                        "last 2048 events/spans) and dump it atomically to "
                        "PATH as a postmortem JSON on SIGTERM/SIGABRT, an "
                        "unhandled exception or a stall-watchdog trip "
                        "(read it with 'doctor --postmortem PATH')")


def _positive_int(v: str) -> int:
    i = int(v)
    if i < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {v}")
    return i


def _density_arg(v: str) -> float:
    f = float(v)
    if not 0.0 < f <= 1.0:
        raise argparse.ArgumentTypeError(f"density must be in (0, 1], got {v}")
    return f


def _backend_options(args) -> dict:
    opts = {}
    if getattr(args, "precision", None):
        opts["precision"] = args.precision
    if getattr(args, "materialization", None):
        opts["materialization"] = args.materialization
    if getattr(args, "dispatch_steps", None):
        opts["dispatch_steps"] = args.dispatch_steps
    return opts


def build_parser():
    p = argparse.ArgumentParser(
        prog="randomprojection_tpu_torch",
        description="random projection on an NVIDIA card (PyTorch/CUDA)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    q = sub.add_parser("jl-dim", help="JL minimum dimension")
    q.add_argument("--n-samples", type=int, required=True)
    q.add_argument("--eps", type=float, default=0.1)

    q = sub.add_parser("info", help="environment / card / kernel status")
    q.add_argument("--device", default="cuda",
                   help="'cuda' (default; exits non-zero with no card) or "
                        "'cpu'")

    q = sub.add_parser("project", help="project a matrix from disk")
    q.add_argument("--input", required=True, help=".npy (dense) or .npz CSR")
    q.add_argument("--output", required=True, help="output .npy path")
    q.add_argument("--kind", default="gaussian",
                   choices=["gaussian", "sparse", "sign", "countsketch"])
    q.add_argument("--n-components", default="auto",
                   help="int or 'auto' (JL bound)")
    q.add_argument("--eps", type=float, default=0.1)
    q.add_argument("--density", default="auto")
    q.add_argument("--batch-rows", type=int, default=65536)
    q.add_argument("--pipeline-depth", type=_positive_int, default=2,
                   help="batches kept in flight on the torch backend; "
                        "results are depth-invariant")
    q.add_argument("--checkpoint", default=None,
                   help="cursor path for resume")
    _add_common(q)

    q = sub.add_parser("stream-bench", help="host-streamed throughput")
    q.add_argument("--rows", type=int, default=262144)
    q.add_argument("--d", type=int, default=4096)
    q.add_argument("--k", type=int, default=256)
    q.add_argument("--batch-rows", type=int, default=16384,
                   help="rows per streamed batch; host RSS is a few "
                        "batches regardless of --rows (the source "
                        "synthesizes batches on demand)")
    q.add_argument("--kind", default="gaussian",
                   choices=["gaussian", "sparse", "sign", "countsketch"])
    q.add_argument("--density", default="auto")
    q.add_argument("--eps", type=float, default=0.1)
    q.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="input dtype: bfloat16 halves the h2d bytes "
                        "(bf16 in -> bf16 out policy)")
    _add_common(q)

    q = sub.add_parser("bench", help="data-resident bench on the card")
    q.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    q.add_argument("--d", type=int, default=4096,
                   help="input dimension for the headline modes")
    q.add_argument("--k", type=int, default=256,
                   help="output dimension for the headline modes")
    q.add_argument("--density", type=_density_arg, default=1.0 / 3.0,
                   help="mask density for the headline modes")
    q.add_argument("--transform-dma", default="auto",
                   choices=["auto", "on", "off"],
                   help="the reference's TPU DMA route switch: only 'auto' "
                        "runs here (the fused kernel's one route)")
    q.add_argument("--dispatch-steps", type=_positive_int, default=None,
                   metavar="K",
                   help="anti-cache harness steps per call (overrides the "
                        "preset)")
    q.add_argument("--device", default="cuda",
                   help="'cuda' (default; exits with no card) or 'cpu' "
                        "(the kernels' plain versions, every timing "
                        "flagged suspect)")
    _add_observability(q)

    q = sub.add_parser(
        "doctor", aliases=["report"],
        help="per-batch critical-path report from a telemetry JSONL file",
        description="Reconstruct per-batch timelines from the tracing "
                    "spans in a --telemetry-jsonl file and print the "
                    "critical-path waterfall (per-stage share + pipeline "
                    "bubble), the queue depth, serving latency, health "
                    "verdicts and the degraded-event audit.  Tolerates "
                    "crashed runs: torn tails and orphaned spans are "
                    "counted, not fatal.  With --live HOST:PORT it polls a "
                    "--metrics-port endpoint instead; with --postmortem it "
                    "renders a flight-recorder dump.",
    )
    q.add_argument("telemetry", nargs="?", metavar="TELEMETRY_JSONL",
                   help="event file written by --telemetry-jsonl "
                        "(omit with --live or --postmortem)")
    q.add_argument("--json", action="store_true",
                   help="print the report as one JSON object (with "
                        "--live: one JSON line per poll)")
    q.add_argument("--live", default=None, metavar="HOST:PORT",
                   help="poll the live endpoint a --metrics-port run "
                        "serves and render a refreshing view: queue "
                        "depths, rolling stage walls, serve-latency "
                        "quantiles, health verdicts, degraded-counter "
                        "rates")
    q.add_argument("--postmortem", default=None, metavar="DUMP",
                   help="render a flight-recorder dump (--flight-dump "
                        "PATH of a crashed or killed run): last-known "
                        "per-stage activity, spans in flight, detectors "
                        "firing at death, counters")
    q.add_argument("--interval", type=float, default=1.0,
                   help="--live poll interval in seconds")
    q.add_argument("--iterations", type=int, default=0, metavar="N",
                   help="--live: stop after N polls (0 = until "
                        "interrupted)")

    q = sub.add_parser(
        "recover",
        help="durable index lifecycle: snapshot status, checksum "
             "verification, and the process-kill recovery smoke",
        description="Inspect a snapshot / durable-ingest directory "
                    "(durable.py): validate the manifest, verify every "
                    "chunk's SHA-256, check that chunk row ranges tile "
                    "exactly once, and list orphan spill files; JSON "
                    "status on stdout, non-zero exit on corruption.  "
                    "--smoke instead runs the SIGKILL fault matrix of "
                    "the harness child on --device and holds every "
                    "recovered run to a clean one bit for bit.",
    )
    q.add_argument("dir", nargs="?", metavar="DIR",
                   help="snapshot / durable-ingest directory to inspect")
    q.add_argument("--smoke", action="store_true",
                   help="run the crash-recovery fault matrix in a "
                        "temporary directory (or DIR when given) and exit "
                        "non-zero unless every kill point recovers "
                        "bit-identically")
    # harness child entry: one deterministic ingest into DIR, honoring
    # RP_DURABLE_KILL kill points
    q.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    q.add_argument("--rows", type=_positive_int, default=192,
                   help="harness rows (child/smoke)")
    q.add_argument("--batch-rows", type=_positive_int, default=32,
                   help="harness rows per batch (child/smoke)")
    q.add_argument("--d", type=_positive_int, default=16,
                   help="harness input dimension (child/smoke)")
    q.add_argument("--bits", type=_positive_int, default=64,
                   help="harness SimHash code bits (child/smoke)")
    q.add_argument("--seed", type=int, default=0)
    q.add_argument("--device", default="cuda",
                   help="the harness's device for --smoke/--child: "
                        "'cuda' (default; exits with no card) or 'cpu'")
    _add_observability(q)

    q = sub.add_parser(
        "topk-bench",
        help="SimHash top-k serving throughput (direct vs micro-batched)",
        description="Build a random SimHashIndex on --device and measure "
                    "query_topk queries/s two ways: direct per-request "
                    "calls, and through the TopKServer micro-batcher that "
                    "coalesces concurrent requests into one launch.",
    )
    q.add_argument("--index-codes", type=_positive_int, default=1 << 18,
                   help="rows in the resident code index")
    q.add_argument("--code-bytes", type=_positive_int, default=32,
                   help="packed code width (bytes/row; 32 = 256 bits)")
    q.add_argument("--m", type=_positive_int, default=16,
                   help="neighbors per query")
    q.add_argument("--queries", type=_positive_int, default=4096,
                   help="total queries per measurement")
    q.add_argument("--request-rows", type=_positive_int, default=64,
                   help="query rows per client request")
    q.add_argument("--clients", type=_positive_int, default=8,
                   help="concurrent client threads for the server mode")
    q.add_argument("--server-batch", type=_positive_int, default=8192,
                   help="TopKServer max coalesced rows per dispatch")
    q.add_argument("--server-delay-ms", type=float, default=2.0,
                   help="TopKServer max wait for stragglers once a "
                        "request is in hand")
    q.add_argument("--topk-impl", default="auto",
                   choices=["auto", "fused", "scan"],
                   help="'auto'/'fused' = the top-k kernel (its plain "
                        "version on the CPU); the reference's 'scan' "
                        "route does not exist here and refuses")
    q.add_argument("--shards", type=int, default=0,
                   help="also measure the sharded tier: ShardedSimHashIndex "
                        "groups of this many shards, all on --device, "
                        "behind ShardedTopKServer (0 = skip)")
    q.add_argument("--replicas", type=_positive_int, default=1,
                   help="replica groups for the sharded tier (each a full "
                        "copy of the corpus, batches routed round-robin)")
    q.add_argument("--probes", default="", metavar="P1,P2,...",
                   help="also measure the multi-probe LSH candidate tier "
                        "(ann.LSHSimHashIndex) at each probe count: "
                        "recall@m against brute force, candidate fraction "
                        "and q/s per point (empty = skip)")
    q.add_argument("--lsh-bands", type=int, default=0,
                   help="LSH band count (0 = auto: min(8, bits/band))")
    q.add_argument("--lsh-band-bits", type=int, default=0,
                   help="LSH bits per band key (0 = auto: min(16, bits))")
    q.add_argument("--probe-path", default="auto",
                   choices=["auto", "host", "device"],
                   help="LSH candidate generation: 'device' = the probe "
                        "kernel and the top-k kernel on the card (their "
                        "plain versions on the CPU), 'host' = the host "
                        "CSR walk, 'auto' = device on a card")
    q.add_argument("--adaptive", action="store_true",
                   help="adaptive per-query probing: each --probes value "
                        "is the per-query ceiling")
    q.add_argument("--candidate-budget", type=int, default=0,
                   help="adaptive per-query candidate budget "
                        "(0 = uncapped)")
    q.add_argument("--hbm-budget", type=int, default=0, metavar="BYTES",
                   help="also measure the tiered hot/cold index: the same "
                        "corpus in 8 chunks under a device budget of this "
                        "many bytes, cold chunks staged per query "
                        "(0 = skip)")
    q.add_argument("--cold-tier", default="host",
                   choices=["host", "disk"],
                   help="where --hbm-budget's cold chunks live: pinned "
                        "host memory, or checksummed memmapped spills")
    q.add_argument("--seed", type=int, default=0)
    q.add_argument("--device", default="cuda",
                   help="'cuda' (default; exits with no card) or 'cpu' "
                        "(the kernels' plain versions)")
    _add_observability(q)

    q = sub.add_parser(
        "loadgen",
        help="open-loop load generator -> per-label tail-latency SLO "
             "record (topk_slo)",
        description="Drive the serving tier with an open-loop arrival "
                    "schedule (Poisson or bursty, mixed request sizes, "
                    "fixed client labels, fully determined by --seed) and "
                    "print a 'topk_slo' record of per-label "
                    "p50/p90/p99/p99.9 latency, rejects and the "
                    "schedule's digest as the last line.  The sharded tier "
                    "serves: --replicas groups of ShardedSimHashIndex "
                    "(LSHShardedSimHashIndex with --probes) of --shards "
                    "shards on --device, behind ShardedTopKServer.",
    )
    q.add_argument("--index-codes", type=_positive_int, default=1 << 14,
                   help="rows in the resident code index")
    q.add_argument("--code-bytes", type=_positive_int, default=32,
                   help="packed code width (bytes/row)")
    q.add_argument("--m", type=_positive_int, default=16,
                   help="neighbors per query")
    q.add_argument("--shards", type=_positive_int, default=1,
                   help="row shards a replica group, all on --device")
    q.add_argument("--replicas", type=_positive_int, default=1,
                   help="replica groups (each a full copy of the corpus)")
    q.add_argument("--topk-impl", default="auto",
                   choices=["auto", "fused", "scan"],
                   help="'auto'/'fused' = the top-k kernel; 'scan' "
                        "refuses (no such route here)")
    q.add_argument("--probes", default="0", metavar="P|label=P,...",
                   help="serve through the multi-probe LSH tier "
                        "(ann.LSHSimHashIndex): a bare int P probes P "
                        "buckets per band for every label (0 = exact "
                        "tier); 'label=P,...' sets a per-label probe "
                        "policy (unlisted labels keep the tier default, "
                        "P=0 pins a label onto the exact path)")
    q.add_argument("--rate", type=float, default=50.0, metavar="QPS",
                   help="mean offered request rate (requests/s)")
    q.add_argument("--duration", type=float, default=5.0, metavar="SEC",
                   help="schedule length in seconds")
    q.add_argument("--arrival", default="poisson",
                   choices=["poisson", "bursty"],
                   help="arrival process: Poisson, or a mean-preserving "
                        "on/off burst cycle (--burst-factor/"
                        "--burst-fraction/--burst-period)")
    q.add_argument("--request-rows", default="16,64,256",
                   metavar="R1,R2,...",
                   help="request-size mix: query rows drawn uniformly from "
                        "this comma list")
    q.add_argument("--labels", default="tenant-a,tenant-b",
                   metavar="L1,L2,...",
                   help="client labels assigned (seeded) per request; the "
                        "record carries one SLO table per label")
    q.add_argument("--burst-factor", type=float, default=8.0,
                   help="bursty: ON-phase rate multiplier")
    q.add_argument("--burst-fraction", type=float, default=0.125,
                   help="bursty: fraction of each period that is ON")
    q.add_argument("--burst-period", type=float, default=1.0,
                   metavar="SEC", help="bursty: cycle period")
    q.add_argument("--server-batch", type=_positive_int, default=8192,
                   help="TopKServer max coalesced rows per dispatch")
    q.add_argument("--server-delay-ms", type=float, default=2.0,
                   help="TopKServer straggler wait")
    q.add_argument("--max-pending", type=_positive_int, default=8192,
                   help="submit-queue bound (requests); beyond it "
                        "submissions are shed and counted as rejects")
    q.add_argument("--seed", type=int, default=0)
    q.add_argument("--settle", type=float, default=0.0, metavar="SEC",
                   help="keep the process (and its --health/--metrics-port "
                        "planes) alive this long after the drain: the "
                        "window in which a fired SLO burn-rate detector "
                        "clears and GET /health returns to 200")
    q.add_argument("--out", default=None, metavar="PATH",
                   help="also write the topk_slo record (one JSON object) "
                        "to this file")
    q.add_argument("--device", default="cuda",
                   help="'cuda' (default; exits with no card) or 'cpu' "
                        "(the kernels' plain versions)")
    _add_observability(q)

    q = sub.add_parser(
        "lint",
        help="rplint: AST + flow-sensitive invariant checks "
             "(rules RP01-RP14)",
        description="Run the port's static-analysis pass "
                    "(randomprojection_tpu_torch/analysis/rplint.py) over "
                    "the installed package: span balance, telemetry.EVENTS "
                    "registry drift, host syncs in hot-path loops "
                    "(syntactic AND one call deep, torch's .item()/"
                    ".tolist()/.cpu()/.numpy()/.synchronize() included), "
                    "thread/queue hygiene and flow-sensitive shutdown "
                    "protocol, ops/ determinism (torch's global RNG "
                    "included), silently-swallowed exceptions, the "
                    "asynchronous-copy discipline (non_blocking copies "
                    "ordered by CUDA events, StagedBatch waits, d2h "
                    "buffers synchronized before they are read), "
                    "cross-thread shared-state races, lock-order "
                    "deadlock analysis, resource-lifecycle pairing, "
                    "durable-commit discipline, and degraded-path "
                    "contracts.  Exit codes: 0 = no unsuppressed "
                    "finding (none outside the baseline when one is "
                    "given), 1 = findings, 2 = internal error "
                    "(unreadable target, malformed baseline, analysis "
                    "crash) — a partial run never reports success.  "
                    "Findings are suppressed per line by an inline "
                    "`# rplint: allow[RPxx] — reason` pragma.  Pure "
                    "stdlib AST analysis: never imports or executes the "
                    "code it checks, and needs no card.",
    )
    q.add_argument("paths", nargs="*", metavar="PATH",
                   help="specific files to lint (default: the whole "
                        "package plus the registry drift check)")
    q.add_argument("--json", action="store_true",
                   help="emit the stable findings record as one JSON "
                        "object: rplint version, per-finding rule id / "
                        "path / line / message / severity / pragma "
                        "state, counts, unresolvable-emit tally")
    q.add_argument("--baseline", default=None, metavar="JSON",
                   help="a prior `lint --json` record: fail only on "
                        "findings NOT in it (matched on rule+path+"
                        "message, so line drift never re-flags a "
                        "baselined finding)")
    q.add_argument("--update-baseline", action="store_true",
                   help="rewrite the --baseline file in place from the "
                        "fresh lint record (prunes stale entries, "
                        "accepts current findings; exit 0)")
    q.add_argument("--sarif", default=None, metavar="PATH",
                   help="also write the findings as a SARIF 2.1.0 log "
                        "to PATH so CI and editors can annotate them "
                        "inline")
    q.add_argument("--jobs", type=int, default=None, metavar="N",
                   help="lint files across N worker processes (default: "
                        "min(8, cpu count); 1 = serial). Findings stay "
                        "in deterministic path order either way")
    return p


def _check_device(args) -> None:
    """Refuse to run where the command would have to fall back: the torch
    backend on a CUDA device needs a card."""
    import torch

    dev = str(getattr(args, "device", "cuda"))
    if dev.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit(
            f"no CUDA card: --device {dev} was asked for but "
            "torch.cuda.is_available() is False; pass --device cpu to run "
            "on the CPU"
        )


def cmd_jl_dim(args):
    from randomprojection_tpu_torch import johnson_lindenstrauss_min_dim

    print(johnson_lindenstrauss_min_dim(args.n_samples, eps=args.eps))


def cmd_info(args):
    import torch

    from randomprojection_tpu_torch.backends import available_backends

    info = {
        "backends": list(available_backends()),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cuda_available": torch.cuda.is_available(),
        "device": args.device,
    }
    if torch.cuda.is_available():
        info["card"] = torch.cuda.get_device_name(0)
        info["card_count"] = torch.cuda.device_count()
    try:
        from randomprojection_tpu_torch.native.build import load_murmur3

        load_murmur3()
        info["native_murmur3"] = True
    except Exception as e:  # reported, not fatal: info is the diagnosis
        info["native_murmur3"] = False
        info["native_murmur3_error"] = str(e)
    if args.device.startswith("cuda") and torch.cuda.is_available():
        from randomprojection_tpu_torch.ops import _build

        kernels = {}
        for name in sorted(p.stem for p in _build.CSRC.glob("*.cu")):
            try:
                _build.build(name)
                kernels[name] = True
            except Exception as e:  # reported per kernel, as above
                kernels[name] = f"build failed: {e}"
        info["cuda_kernels"] = kernels
    print(json.dumps(info, indent=1))
    _check_device(args)


def _make_estimator(args):
    import randomprojection_tpu_torch as rpt

    k = args.n_components
    if k != "auto":
        k = int(k)
    common = dict(random_state=args.seed, backend=args.backend)
    opts = _backend_options(args)
    device_opts = {} if args.backend == "numpy" else {"device": args.device}
    if opts or device_opts:
        common["backend_options"] = {**opts, **device_opts}
    if args.kind != "sparse" and getattr(args, "density", "auto") != "auto":
        # refuse rather than silently drop: only the sparse kind has a
        # density parameter
        raise SystemExit(f"--density is not supported for --kind {args.kind}")
    if args.kind == "gaussian":
        return rpt.GaussianRandomProjection(k, eps=args.eps, **common)
    if args.kind == "sparse":
        density = args.density
        if density != "auto":
            try:
                density = _density_arg(density)
            except (argparse.ArgumentTypeError, ValueError) as e:
                raise SystemExit(f"--density: {e}")
        return rpt.SparseRandomProjection(k, eps=args.eps, density=density,
                                          **common)
    if args.kind == "sign":
        if k == "auto":
            raise SystemExit("--kind sign requires an explicit --n-components")
        return rpt.SignRandomProjection(k, **common)
    if k == "auto":
        raise SystemExit("--kind countsketch requires an explicit --n-components")
    if opts:
        # refuse rather than silently drop: CountSketch has no precision/
        # materialization knobs
        raise SystemExit(
            "--precision/--materialization are not supported for "
            "--kind countsketch"
        )
    return rpt.CountSketch(k, random_state=args.seed, backend=args.backend,
                           backend_options=device_opts or None)


def _wrap_prefetch(source, est, args, stats):
    """Wrap ``source`` in the requested ingest pipeline: a staged
    multi-worker pool (``--ingest-workers >= 2``) or a single prefetch
    worker (``--prefetch-batches``); production (and the estimator's
    early upload, ``prepare_batch``) moves off the consumer thread either
    way."""
    depth = getattr(args, "prefetch_batches", 0)
    workers = getattr(args, "ingest_workers", 0)
    if workers >= 2:
        from randomprojection_tpu_torch.streaming import StagedIngestSource

        return StagedIngestSource(
            source, workers=workers, depth=depth or 2,
            prepare=est.prepare_batch, stats=stats,
        )
    if not depth:
        return source
    from randomprojection_tpu_torch.streaming import PrefetchSource

    return PrefetchSource(
        source, depth=depth, prepare=est.prepare_batch, stats=stats
    )


def cmd_project(args):
    import os

    import scipy.sparse as sp

    from randomprojection_tpu_torch.streaming import (
        ArraySource,
        StreamCursor,
        stream_to_array,
        stream_to_memmap,
    )
    from randomprojection_tpu_torch.utils.observability import (
        StreamStats,
        profile_trace,
    )

    if args.input.endswith(".npz"):
        X = sp.load_npz(args.input).tocsr()
    else:
        from randomprojection_tpu_torch.utils.validation import (
            restore_void_dtype,
        )

        # restore bf16 arrays whose .npy header degraded to raw void
        X = restore_void_dtype(np.load(args.input, mmap_mode="r"))
    source = ArraySource(X, args.batch_rows)
    stats = StreamStats(log_every=10)
    _register_metrics_source(stats.registry.snapshot)
    # np.save appends .npy itself; normalize once so the JSON summary and
    # the memmap path always name the file that actually exists
    out_path = args.output if args.output.endswith(".npy") else args.output + ".npy"

    if args.checkpoint is None:
        est = _make_estimator(args).fit_source(source)
        with profile_trace(args.profile_dir):
            Y = stream_to_array(
                est, _wrap_prefetch(source, est, args, stats), stats=stats,
                pipeline_depth=args.pipeline_depth,
            )
        if sp.issparse(Y):
            Y = Y.toarray()
        np.save(out_path, Y)
        print(json.dumps({"output": out_path, "shape": list(Y.shape),
                          "dtype": str(Y.dtype), **stats.summary()}))
        _write_openmetrics(args, stats.registry.snapshot())
        return

    # Checkpointed runs write through an on-disk .npy memmap so every
    # committed batch is durable: a mid-run crash resumes from the cursor
    # into the same file, and a completed run is never silently overwritten.
    # A fingerprint sidecar pins the run configuration — input data,
    # estimator parameters, output path: resuming with anything different
    # would silently mix two projections in one file.  Built from the raw
    # CLI args (not the fitted estimator) so every refusal below fires
    # before any device work or matrix materialization.
    fingerprint = {
        "input": os.path.abspath(args.input),
        "kind": args.kind, "n_components": str(args.n_components),
        "eps": args.eps,
        "seed": args.seed, "density": str(getattr(args, "density", "auto")),
        "backend": args.backend, "device": args.device,
        "batch_rows": args.batch_rows,
        "precision": getattr(args, "precision", None),
        "materialization": getattr(args, "materialization", None),
        "n_rows": source.n_rows, "n_features": source.n_features,
        "output": os.path.abspath(out_path),
    }
    meta_path = args.checkpoint + ".meta.json"
    rows_done = (
        StreamCursor.load(args.checkpoint).rows_done
        if os.path.exists(args.checkpoint)
        else 0
    )
    if rows_done > 0 and not os.path.exists(meta_path):
        raise SystemExit(
            f"checkpoint {args.checkpoint} has partial progress but no "
            f"{meta_path} fingerprint; cannot prove the resume parameters "
            f"match the original run — delete the checkpoint to restart"
        )
    if rows_done > 0:
        with open(meta_path) as f:
            recorded = json.load(f)
        if recorded != fingerprint:
            diff = {
                kk: (recorded.get(kk), fingerprint.get(kk))
                for kk in sorted(set(recorded) | set(fingerprint))
                if recorded.get(kk) != fingerprint.get(kk)
            }
            raise SystemExit(
                f"checkpoint {args.checkpoint} was written by a run with "
                f"different parameters {diff} (recorded, requested); "
                f"resuming would mix two projections in one output — "
                f"delete the checkpoint to restart"
            )
    if rows_done >= source.n_rows and rows_done > 0:
        raise SystemExit(
            f"checkpoint {args.checkpoint} records a completed run "
            f"(rows_done={rows_done}); refusing to overwrite {out_path} — "
            f"delete the checkpoint file to re-project from scratch"
        )
    est = _make_estimator(args).fit_source(source)
    if rows_done == 0:
        with open(meta_path, "w") as f:
            json.dump(fingerprint, f)
    try:
        with profile_trace(args.profile_dir):
            out = stream_to_memmap(
                est, _wrap_prefetch(source, est, args, stats), out_path,
                checkpoint_path=args.checkpoint, stats=stats,
                pipeline_depth=args.pipeline_depth,
            )
    except ValueError as e:
        raise SystemExit(str(e))
    print(json.dumps({"output": out_path, "shape": list(out.shape),
                      "dtype": str(out.dtype), **stats.summary()}))
    _write_openmetrics(args, stats.registry.snapshot())


def template_roll_reader(template, batch_rows: int):
    """``read(lo, hi)`` over one resident template: batch ``i`` is the
    template's rows rolled by ``i`` (mod its length), cut to ``hi - lo``.

    Distinct values per batch at memcpy cost — not a fresh RNG draw per
    batch, which would bill seconds a GiB of host generation to the
    streaming number.  A row ROLL (not a scalar add, which quantizes to
    nothing in bf16 once the offset exceeds the ulp) keeps batches
    exactly distinct in any dtype until the shift wraps after
    ``len(template)`` batches.  Deterministic in ``(lo, hi)``, so runs
    are reproducible and resume-exact."""
    template_rows = template.shape[0]

    def read(lo, hi):
        shift = (lo // max(batch_rows, 1)) % template_rows
        return np.roll(template, -shift, axis=0)[: hi - lo]

    return read


def cmd_stream_bench(args):
    """Host-streamed rows/s: the copies to and from the card included.
    The estimator is built by the same ``_make_estimator`` as ``project``,
    so ``--kind``/``--precision``/``--materialization`` select the same
    execution modes.

    The source is a seeded ``CallableSource`` synthesizing each batch on
    demand from one resident template (``template_roll_reader``): host
    memory stays a few batches however large ``--rows`` is."""
    import time

    from randomprojection_tpu_torch.streaming import CallableSource
    from randomprojection_tpu_torch.utils.observability import (
        StreamStats,
        profile_trace,
    )

    out_dtype = np.float32
    if getattr(args, "dtype", "float32") == "bfloat16":
        from randomprojection_tpu_torch.utils.validation import bfloat16_dtype

        out_dtype = bfloat16_dtype()
        if out_dtype is None:
            raise SystemExit("--dtype bfloat16 requires ml_dtypes")

    template_rows = min(args.batch_rows, args.rows) or 1
    template = np.random.default_rng(0).standard_normal(
        (template_rows, args.d), dtype=np.float32
    ).astype(out_dtype, copy=False)
    stats = StreamStats()
    _register_metrics_source(stats.registry.snapshot)
    source = CallableSource(
        template_roll_reader(template, args.batch_rows), args.rows, args.d,
        dtype=out_dtype, batch_rows=args.batch_rows, stats=stats,
    )
    args.n_components = args.k
    est = _make_estimator(args).fit_source(source)
    # warmup on one batch — NEGATED so its contents never equal any
    # streamed batch
    est.transform(np.negative(template[: min(args.batch_rows, args.rows) or 1]))
    timed_source = _wrap_prefetch(source, est, args, stats)
    t0 = time.perf_counter()
    with profile_trace(args.profile_dir):
        for _ in est.transform_stream(timed_source, stats=stats):
            pass
    elapsed = time.perf_counter() - t0
    import torch

    device = ("host" if args.backend == "numpy" else
              torch.cuda.get_device_name(torch.device(args.device))
              if args.device.startswith("cuda") else "cpu")
    out = {
        "metric": f"host-streamed rows/s {args.d}->{args.k} ({args.kind})",
        "value": round(args.rows / elapsed, 1),
        "unit": "rows/s",
        "kind": args.kind,
        "rows": args.rows,
        "batch_rows": args.batch_rows,
        "dtype": str(np.dtype(out_dtype)),
        "backend": args.backend,
        "backend_options": _backend_options(args),
        "bytes_in": stats.bytes_in,
        "elapsed_s": round(elapsed, 4),
        "prefetch_batches": args.prefetch_batches,
        "ingest_workers": args.ingest_workers,
        "device": device,
    }
    if stats.stage_wall:
        out["stage_wall_s"] = {
            k_: round(v, 4) for k_, v in sorted(stats.stage_wall.items())
        }
        out["pipeline_overlap_ratio"] = round(stats.overlap_ratio(), 3)
        out["queue_depth_max"] = stats.queue_depth_max
    print(json.dumps(out))
    _write_openmetrics(args, stats.registry.snapshot())


def _write_openmetrics(args, *extra_snapshots) -> None:
    """Write the OpenMetrics exposition when ``--openmetrics PATH`` was
    given: the process-wide registry merged with any per-run registries
    (the stream's ``StreamStats``).  Consumes the flag, so ``main``'s
    fallback write (for commands without their own stats, such as
    ``bench``) fires at most once.  A file, never stdout: the bench's and
    loadgen's last-line contracts stay intact."""
    path = getattr(args, "openmetrics", None)
    if not path:
        return
    from randomprojection_tpu_torch.utils import telemetry

    with open(path, "w") as f:
        f.write(
            telemetry.to_openmetrics(
                telemetry.registry().snapshot(), *extra_snapshots
            )
        )
    args.openmetrics = None


def cmd_bench(args):
    from randomprojection_tpu_torch.benchmark import emit_bench_output, run

    # the full record first, then the compact digest as the FINAL line
    emit_bench_output(run(
        args.preset, k=args.k, d=args.d, density=args.density,
        dispatch_steps=args.dispatch_steps, device=args.device,
    ))


def _cmd_doctor_live(args) -> int:
    """``doctor --live HOST:PORT``: poll the live metrics endpoint and
    render a refreshing terminal view (see utils/metrics_server.py)."""
    import time

    from randomprojection_tpu_torch.utils import metrics_server

    host, _, port_s = args.live.rpartition(":")
    try:
        port = int(port_s)
    except ValueError:
        port = -1
    if not host or not 0 < port < 65536:
        raise SystemExit(
            f"--live wants HOST:PORT (e.g. 127.0.0.1:9100), got "
            f"{args.live!r}"
        )
    if args.interval <= 0:
        raise SystemExit(f"--interval must be > 0, got {args.interval}")
    prev = None
    poll = 0
    consecutive_failures = 0
    while True:
        poll += 1
        try:
            text = metrics_server.fetch_metrics(
                host, port, timeout=max(args.interval, 1.0)
            )
        except OSError as e:
            # a first-poll failure means the endpoint was never there;
            # later ones are tolerated briefly (one timed-out scrape must
            # not kill a dashboard that has been live for hours)
            consecutive_failures += 1
            if poll == 1 or consecutive_failures >= 5:
                raise SystemExit(
                    f"live endpoint {args.live} unreachable"
                    + (
                        f" ({consecutive_failures} consecutive "
                        "failed polls)" if poll > 1 else ""
                    )
                    + f": {e} — is the serving process running with "
                    "--metrics-port?"
                )
            print(
                f"live doctor: poll #{poll} failed ({e}); retrying",
                file=sys.stderr,
            )
            if args.iterations and poll >= args.iterations:
                return 0
            time.sleep(args.interval)
            continue
        consecutive_failures = 0
        plain, labeled = metrics_server.parse_openmetrics(text)
        if args.json:
            print(metrics_server.live_snapshot_json(plain, labeled))
        else:
            if sys.stdout.isatty() and poll > 1:
                print("\x1b[2J\x1b[H", end="")
            print(
                metrics_server.render_live(
                    plain, labeled, prev, interval_s=args.interval,
                    endpoint=args.live, poll=poll,
                ),
                end="", flush=True,
            )
        prev = plain
        if args.iterations and poll >= args.iterations:
            return 0
        time.sleep(args.interval)


def cmd_doctor(args):
    """The doctor: a telemetry file's report, a flight-recorder
    postmortem (``--postmortem``), or a live endpoint (``--live``).  The
    tripwire line says why there is none: the committed bench records
    are the TPU's (``benchmark.REGRESSIONS_SKIPPED``)."""
    import os

    from randomprojection_tpu_torch.utils.trace_report import (
        build_postmortem,
        build_report,
        render_postmortem,
        render_report,
    )

    if args.live:
        return _cmd_doctor_live(args)
    if args.postmortem:
        if not os.path.exists(args.postmortem):
            raise SystemExit(
                f"no such flight-recorder dump: {args.postmortem}"
            )
        try:
            with open(args.postmortem) as f:
                dump = json.load(f)
            pm = build_postmortem(dump)
        except (ValueError, KeyError, TypeError) as e:
            raise SystemExit(
                f"unreadable flight-recorder dump {args.postmortem}: {e}"
            )
        if args.json:
            print(json.dumps(pm))
        else:
            print(render_postmortem(pm), end="")
        return
    if not args.telemetry:
        raise SystemExit(
            "doctor wants a TELEMETRY_JSONL file, --postmortem DUMP, "
            "or --live HOST:PORT"
        )
    if not os.path.exists(args.telemetry):
        raise SystemExit(f"no such telemetry file: {args.telemetry}")
    try:
        report = build_report(args.telemetry)
    except (ValueError, KeyError, TypeError) as e:
        # a torn final line is tolerated by the reader; reaching here
        # means a torn middle line or payloads of the wrong shape
        raise SystemExit(f"corrupt telemetry file {args.telemetry}: {e}")
    from randomprojection_tpu_torch.benchmark import REGRESSIONS_SKIPPED

    report["tripwire"] = {"error": REGRESSIONS_SKIPPED}
    if args.json:
        print(json.dumps(report))
    else:
        print(render_report(report), end="")


def cmd_recover(args):
    """Durable-lifecycle operations (``durable.py``): a snapshot's status
    and checksums (default, host only), the SIGKILL recovery smoke on
    ``--device`` (``--smoke``), and the harness child ingest
    (``--child``)."""
    import tempfile

    from randomprojection_tpu_torch import durable

    if args.child or args.smoke:
        _check_device(args)
    if args.child:
        if not args.dir:
            raise SystemExit("recover --child requires DIR")
        summary = durable.demo_ingest(
            args.dir, rows=args.rows, batch_rows=args.batch_rows,
            d=args.d, bits=args.bits, seed=args.seed, device=args.device,
        )
        print(json.dumps(summary))
        return 0
    if args.smoke:
        made_tmp = args.dir is None
        workdir = args.dir or tempfile.mkdtemp(prefix="rp_recover_smoke_")
        verdict = durable.crash_smoke(
            workdir, rows=args.rows, batch_rows=args.batch_rows,
            d=args.d, bits=args.bits, seed=args.seed, device=args.device,
        )
        if made_tmp and verdict["ok"]:
            # a clean pass leaves nothing behind; a failing run keeps the
            # directory for its per-case paths
            import shutil

            shutil.rmtree(workdir, ignore_errors=True)
        print(json.dumps(verdict))
        return 0 if verdict["ok"] else 1
    if not args.dir:
        raise SystemExit("recover requires DIR (or --smoke)")
    status = durable.verify_snapshot(args.dir)
    print(json.dumps(status))
    return 0 if status["ok"] else 1


def _check_serving_args(args) -> None:
    """``topk-bench``/``loadgen``: the reference's ``scan`` route refuses."""
    if args.topk_impl == "scan":
        raise SystemExit(
            "--topk-impl scan: the port has one top-k route, the kernel on "
            "the card (its plain version on the CPU); no scan route (a "
            "standing divergence, ROADMAP queue C)"
        )


def cmd_topk_bench(args):
    """Top-k serving throughput, direct and micro-batched: the direct mode
    issues one ``query_topk`` per ``--request-rows`` request back to back;
    the server mode has ``--clients`` threads submit the same requests
    concurrently through a ``TopKServer``, which coalesces them into
    ``--server-batch``-row launches.  Query values are distinct per
    request (slices of one pregenerated pool)."""
    import threading
    import time

    from randomprojection_tpu_torch.benchmark import (
        _device,
        _device_name,
        _topk_impl,
    )
    from randomprojection_tpu_torch.models.sketch import (
        SimHashIndex,
        TopKServer,
    )

    _check_serving_args(args)
    dev = _device(args.device)
    rng = np.random.default_rng(args.seed)
    codes = rng.integers(
        0, 256, size=(args.index_codes, args.code_bytes), dtype=np.uint8
    )
    n_requests = -(-args.queries // args.request_rows)
    pool = rng.integers(
        0, 256, size=(n_requests * args.request_rows, args.code_bytes),
        dtype=np.uint8,
    )
    requests = [
        pool[i * args.request_rows : (i + 1) * args.request_rows]
        for i in range(n_requests)
    ]
    index = SimHashIndex(codes, device=dev)
    index.query_topk(requests[0], args.m)  # warm: builds and plans

    t0 = time.perf_counter()
    for req in requests:
        index.query_topk(req, args.m)
    direct_elapsed = time.perf_counter() - t0
    direct_qps = len(requests) * args.request_rows / direct_elapsed

    def measure_server(server, warmed=lambda: None):
        threads = []
        try:
            server.query(requests[0])  # warm the coalesced bucket
            warmed()

            def client(reqs):
                futs = [server.submit(r) for r in reqs]
                for f in futs:
                    f.result()

            threads = [
                threading.Thread(target=client,
                                 args=(requests[i :: args.clients],),
                                 daemon=True)
                for i in range(args.clients)
            ]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            elapsed = time.perf_counter() - t0
        finally:
            server.close()
            # a start() or join() that raised leaves started clients
            # behind: the closed server answers them, and they are joined
            for t in threads:
                if t.ident is not None:
                    t.join()
        return len(requests) * args.request_rows / elapsed, server.stats()

    server_qps, server_stats = measure_server(TopKServer(
        index, args.m, max_batch=args.server_batch,
        max_delay_s=args.server_delay_ms / 1e3, name="topk"))

    sharded = None
    if args.shards:
        from randomprojection_tpu_torch.serving import (
            ShardedSimHashIndex,
            ShardedTopKServer,
        )

        groups = [
            ShardedSimHashIndex(codes, devices=[dev], n_shards=args.shards)
            for _ in range(args.replicas)
        ]
        pre = []
        sh_qps, sh_stats = measure_server(
            ShardedTopKServer(groups, args.m, max_batch=args.server_batch,
                              max_delay_s=args.server_delay_ms / 1e3),
            # the merges are counted from after the warm request
            warmed=lambda: pre.extend(g.stats() for g in groups))
        post = [g.stats() for g in groups]
        for g in groups:
            g.close()
        sharded = {
            "shards": args.shards,
            "replicas": args.replicas,
            "queries_per_s": round(sh_qps, 1),
            "merges": sum(b["merges"] - a["merges"]
                          for a, b in zip(pre, post)),
            "merge_wall_s": round(sum(
                b["merge_wall_s"] - a["merge_wall_s"]
                for a, b in zip(pre, post)), 6),
            "replica_batches": sh_stats["replica_batches"],
        }

    lsh = None
    if args.probes.strip():
        from randomprojection_tpu_torch.ann import LSHSimHashIndex
        from randomprojection_tpu_torch.utils import telemetry as _telemetry

        try:
            probe_counts = [
                int(v) for v in args.probes.split(",") if v.strip()
            ]
        except ValueError:
            probe_counts = []
        if not probe_counts or any(p < 1 for p in probe_counts):
            raise SystemExit(
                f"--probes wants a comma list of positive ints, got "
                f"{args.probes!r}"
            )
        lsh_index = LSHSimHashIndex(
            codes,
            device=dev,
            bands=args.lsh_bands or None,
            band_bits=args.lsh_band_bits or None,
            probe_path=args.probe_path,
            adaptive=bool(args.adaptive),
            candidate_budget=args.candidate_budget or None,
        )
        # exact truth for recall@m: the exact index above, whose answers
        # are a brute force's bit for bit (a host brute force over 2^20
        # codes takes about a minute)
        ref_rows = min(len(requests), 4) * args.request_rows
        true_d, true_i = index.query_topk(pool[:ref_rows], args.m)
        lsh_index.query_topk(pool[:ref_rows], args.m,
                             probes=probe_counts[0])  # warm
        reg = _telemetry.registry()
        lsh_curve = []
        for p in probe_counts:
            gd, gi = lsh_index.query_topk(pool[:ref_rows], args.m,
                                          probes=p)
            hits = 0
            for row_got, row_true in zip(gi, true_i):
                hits += np.intersect1d(row_got, row_true).size
            # per-tile wall split: host probe work against dispatch wall,
            # histogram-sum deltas over the timed loop
            h0 = reg.hist_sum("index.lsh.probe.host_s")
            s0 = reg.hist_sum("index.lsh.probe.dispatch_s")
            u0 = reg.hist_quantiles("index.lsh.adaptive.probes_used")
            t0 = time.perf_counter()
            for req in requests:
                lsh_index.query_topk(req, args.m, probes=p)
            elapsed = time.perf_counter() - t0
            point = {
                "probes": p,
                "recall_at_m": round(hits / true_i.size, 4),
                "queries_per_s": round(
                    len(requests) * args.request_rows / elapsed, 1
                ),
                "probe_host_s": round(
                    reg.hist_sum("index.lsh.probe.host_s") - h0, 6
                ),
                "probe_dispatch_s": round(
                    reg.hist_sum("index.lsh.probe.dispatch_s") - s0, 6
                ),
            }
            if args.adaptive:
                u1 = reg.hist_quantiles("index.lsh.adaptive.probes_used")
                if u1 is not None:
                    n0 = u0["count"] if u0 else 0
                    s_0 = u0["sum"] if u0 else 0.0
                    point["probes_used"] = {
                        "count": u1["count"] - n0,
                        "mean": round(
                            (u1["sum"] - s_0)
                            / max(u1["count"] - n0, 1), 3
                        ),
                        # cumulative-histogram estimates (log2 buckets)
                        "p50": u1.get("p50"),
                        "p99": u1.get("p99"),
                    }
            lsh_curve.append(point)
        lsh = {
            "bands": lsh_index.band_plan.bands,
            "band_bits": lsh_index.band_plan.band_bits,
            "fallback_density": lsh_index.fallback_density,
            "probe_path": args.probe_path,
            "probe_path_resolved": (
                "device" if lsh_index._lsh_probe_device(args.probe_path)
                else "host"
            ),
            "adaptive": bool(args.adaptive),
            "candidate_budget": args.candidate_budget or None,
            # a CPU run's wall split times the plain versions
            "wall_split_suspect": dev.type != "cuda",
            "curve": lsh_curve,
            **{f"lsh_{k}": v for k, v in lsh_index.lsh_stats().items()},
        }

    tiered = None
    if args.hbm_budget:
        import shutil
        import tempfile

        from randomprojection_tpu_torch.utils import telemetry as _tel

        # the same corpus in 8 chunks so the budget splits it into a hot
        # and a cold set; answers must equal the resident index's
        chunk_rows = -(-args.index_codes // 8)
        cold_dir = tempfile.mkdtemp(prefix="rp_tier_bench_") \
            if args.cold_tier == "disk" else None
        t_index = SimHashIndex(
            codes[:0], device=dev, hbm_budget_bytes=args.hbm_budget,
            cold_tier=args.cold_tier, cold_dir=cold_dir,
        )
        try:
            for lo in range(0, args.index_codes, chunk_rows):
                t_index.add(codes[lo : lo + chunk_rows])
            rd, ri = index.query_topk(requests[0], args.m)
            td, ti = t_index.query_topk(requests[0], args.m)  # + warm
            parity_ok = bool((td == rd).all() and (ti == ri).all())
            reg = _tel.registry()
            h0 = reg.counter("index.tier.hot_rows")
            c0 = reg.counter("index.tier.cold_rows")
            f0 = reg.counter("index.tier.fetches")
            fb0 = reg.counter("index.tier.fallbacks")
            w0 = reg.hist_sum("index.tier.fetch_s")
            o0 = reg.hist_sum("index.tier.overlap_s")
            t0 = time.perf_counter()
            for req in requests:
                t_index.query_topk(req, args.m)
            t_elapsed = time.perf_counter() - t0
            hot = reg.counter("index.tier.hot_rows") - h0
            cold = reg.counter("index.tier.cold_rows") - c0
            fq = reg.hist_quantiles("index.tier.fetch_s")
            chunk_tiers = [
                c["tier"] for c in t_index._tier.residency()["chunks"]
            ]
            tiered = {
                "hbm_budget_bytes": args.hbm_budget,
                "cold_tier": args.cold_tier,
                "over_budget_factor": round(
                    args.index_codes * args.code_bytes / args.hbm_budget,
                    2,
                ),
                "hot_chunks": sum(
                    1 for t in chunk_tiers if t == "hot"
                ),
                "cold_chunks": sum(
                    1 for t in chunk_tiers if t != "hot"
                ),
                "queries_per_s": round(
                    len(requests) * args.request_rows / t_elapsed, 1
                ),
                "slowdown_vs_direct": round(
                    direct_qps
                    / (len(requests) * args.request_rows / t_elapsed),
                    3,
                ),
                "hot_hit_fraction": (
                    round(hot / (hot + cold), 4) if (hot + cold) else None
                ),
                "cold_fetches": reg.counter("index.tier.fetches") - f0,
                "cold_fetch_wall_s": round(
                    reg.hist_sum("index.tier.fetch_s") - w0, 6
                ),
                "cold_fetch_overlapped_s": round(
                    reg.hist_sum("index.tier.overlap_s") - o0, 6
                ),
                "cold_fetch_p99_s": (
                    round(fq["p99"], 6)
                    if fq and fq.get("p99") is not None else None
                ),
                "fallbacks": reg.counter("index.tier.fallbacks") - fb0,
                "parity_ok": parity_ok,
                "timing_suspect": dev.type != "cuda",
            }
        finally:
            t_index.close()
            if cold_dir is not None:
                shutil.rmtree(cold_dir, ignore_errors=True)

    print(json.dumps({
        "metric": f"simhash top-k serving queries/s (m={args.m}, "
                  f"{args.index_codes} codes)",
        "index_codes": args.index_codes,
        "code_bytes": args.code_bytes,
        "m": args.m,
        "request_rows": args.request_rows,
        "requests": len(requests),
        "clients": args.clients,
        "topk_impl": _topk_impl(dev, args.request_rows, args.index_codes,
                                args.code_bytes,
                                min(args.m, args.index_codes)),
        "direct_queries_per_s": round(direct_qps, 1),
        "server_queries_per_s": round(server_qps, 1),
        "server_speedup": round(server_qps / direct_qps, 2),
        "server_batch": args.server_batch,
        "server_delay_ms": args.server_delay_ms,
        **{f"server_{k}": v for k, v in server_stats.items()},
        **({"sharded": sharded} if sharded else {}),
        **({"lsh": lsh} if lsh else {}),
        **({"tiered": tiered} if tiered else {}),
        "device": _device_name(dev),
    }))
    _write_openmetrics(args)


def _probe_args(text: str):
    """``--probes`` of ``loadgen``: ``(default, policy)``, a bare int for
    every label or ``label=P,...`` pairs as a per-label policy."""
    probes_txt = str(text).strip()
    if "=" not in probes_txt:
        try:
            probes_default = int(probes_txt or "0")
        except ValueError:
            raise SystemExit(
                f"--probes wants an int or label=P pairs, got "
                f"{probes_txt!r}"
            )
        if probes_default < 0:
            raise SystemExit(f"--probes must be >= 0, got {probes_default}")
        return probes_default, None
    probe_policy = {}
    for part in probes_txt.split(","):
        part = part.strip()
        if not part:
            continue
        k, eq, v = part.partition("=")
        try:
            if not eq:
                raise ValueError(part)
            probe_policy[k.strip()] = int(v)
        except ValueError:
            raise SystemExit(
                f"--probes wants an int or label=P pairs, got {part!r}"
            )
    if not probe_policy or any(p < 0 for p in probe_policy.values()):
        raise SystemExit(
            f"--probes label=P pairs want non-negative probe counts, got "
            f"{probes_txt!r}"
        )
    return 0, probe_policy


def cmd_loadgen(args):
    """Open-loop SLO measurement (``loadgen.py``): a seeded arrival
    schedule against ``--replicas`` groups of ``--shards`` shards on
    ``--device`` behind a ``ShardedTopKServer``, as the reference serves
    it.  The ``topk_slo`` record is the last stdout line and optionally
    ``--out``."""
    from randomprojection_tpu_torch import loadgen
    from randomprojection_tpu_torch.benchmark import _device
    from randomprojection_tpu_torch.serving import (
        ShardedSimHashIndex,
        ShardedTopKServer,
    )

    def _csv(text, cast, flag):
        try:
            vals = [cast(v.strip()) for v in text.split(",") if v.strip()]
        except ValueError:
            vals = []
        if not vals:
            raise SystemExit(f"{flag} wants a comma list, got {text!r}")
        return vals

    _check_serving_args(args)
    request_rows = _csv(args.request_rows, int, "--request-rows")
    labels = _csv(args.labels, str, "--labels")
    try:
        schedule = loadgen.build_schedule(
            seed=args.seed, duration_s=args.duration, rate_qps=args.rate,
            arrival=args.arrival, request_rows=request_rows,
            labels=labels, burst_factor=args.burst_factor,
            burst_fraction=args.burst_fraction,
            burst_period_s=args.burst_period,
        )
    except ValueError as e:
        raise SystemExit(str(e))
    if not schedule:
        raise SystemExit(
            f"empty schedule: --rate {args.rate} over --duration "
            f"{args.duration}s produced no arrivals — raise one of them"
        )
    probes_default, probe_policy = _probe_args(args.probes)
    dev = _device(args.device)
    rng = np.random.default_rng(args.seed)
    codes = rng.integers(
        0, 256, size=(args.index_codes, args.code_bytes), dtype=np.uint8
    )
    layout = {"devices": [dev], "n_shards": args.shards}
    if probes_default > 0 or probe_policy is not None:
        # the LSH candidate tier serves: probes is the recall/latency knob
        # the per-label SLO tables then express
        from randomprojection_tpu_torch.ann import LSHShardedSimHashIndex

        lsh_kw = {"probes": probes_default} if probes_default > 0 else {}
        groups = [LSHShardedSimHashIndex(codes, **layout, **lsh_kw)
                  for _ in range(args.replicas)]
    else:
        groups = [ShardedSimHashIndex(codes, **layout)
                  for _ in range(args.replicas)]
    server = ShardedTopKServer(
        groups, args.m, max_batch=args.server_batch,
        max_delay_s=args.server_delay_ms / 1e3,
        max_pending=args.max_pending, probe_policy=probe_policy,
    )
    try:
        record = loadgen.run(
            server, schedule, code_bytes=args.code_bytes,
            seed=args.seed, warmup_rows=max(request_rows),
            probe_policy=probe_policy,
        )
    finally:
        server.close()
        for g in groups:
            g.close()
    record.update({
        "seed": args.seed,
        "arrival": args.arrival,
        "rate_qps": args.rate,
        "duration_s": args.duration,
        "request_rows": request_rows,
        "index_codes": args.index_codes,
        "code_bytes": args.code_bytes,
        "m": args.m,
        "shards": args.shards,
        "replicas": args.replicas,
        "probes": probes_default,
        "probe_policy": probe_policy,
    })
    if args.health is not None:
        # the spec the live burn-rate detector grades against rides in the
        # record, so post-hoc analysis and the live verdicts share one
        # contract
        from randomprojection_tpu_torch.utils import health

        spec = health.parse_slo_spec(args.health)
        record["slo_targets"] = {
            "default_ms": spec["default_ms"],
            "labels": spec["labels"],
            "spec": args.health,
        }
    if args.settle and args.settle > 0:
        # hold the health/metrics planes open through the recovery window
        # before the last-line record is printed
        import time

        time.sleep(args.settle)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f)
    _write_openmetrics(args)
    print(json.dumps(record))


def cmd_lint(args):
    """rplint over the package (or explicit paths); returns the exit
    code — 0 clean, 1 on unsuppressed (non-baselined) findings, 2 on an
    internal error — so a crashed partial run is never mistaken for a
    clean tree."""
    from randomprojection_tpu_torch.analysis import rplint

    argv = list(args.paths)
    if args.json:
        argv.append("--json")
    if args.baseline is not None:
        argv += ["--baseline", args.baseline]
    if args.update_baseline:
        argv.append("--update-baseline")
    if args.sarif is not None:
        argv += ["--sarif", args.sarif]
    if args.jobs is not None:
        argv += ["--jobs", str(args.jobs)]
    return rplint.main(argv)


def _refuse_flags(args) -> None:
    """Flags of JAX alone, or of the TPU kernel's route, exit naming
    why."""
    for name in _JAX_FLAGS:
        if getattr(args, name, False):
            flag = "--" + name.replace("_", "-")
            raise SystemExit(
                f"{flag} sets a jax.config option of the reference and has "
                "no counterpart in the torch port (a standing divergence, "
                "ROADMAP queue C)"
            )
    for name in _TPU_FLAGS:
        if getattr(args, name, None) is not None:
            flag = "--" + name.replace("_", "-")
            raise SystemExit(
                f"{flag} picks the reference's TPU kernel route and has no "
                "counterpart on the card: the fused kernel's route is chosen "
                "from the shape (a standing divergence, ROADMAP queue C)"
            )


def main(argv=None):
    parser = build_parser()
    args, extra = parser.parse_known_args(argv)
    if extra:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    if args.cmd == "bench" and args.transform_dma == "auto":
        args.transform_dma = None  # the kernel's one route on the card
    _refuse_flags(args)
    if hasattr(args, "log_level"):
        logging.basicConfig(level=getattr(logging, args.log_level.upper()))
    if getattr(args, "prefetch_batches", 0) < 0:
        raise SystemExit(
            f"--prefetch-batches must be >= 0, got {args.prefetch_batches}"
        )
    if getattr(args, "ingest_workers", 0) < 0:
        raise SystemExit(
            f"--ingest-workers must be >= 0, got {args.ingest_workers}"
        )
    if getattr(args, "hash_threads", None) is not None:
        if args.hash_threads < 1:
            raise SystemExit(
                f"--hash-threads must be >= 1, got {args.hash_threads}"
            )
        # process default for every batch-hash call (the C++ kernel reads
        # RP_HASH_THREADS per call); TokenSource(hash_threads=...) can
        # still override per stream
        import os

        os.environ["RP_HASH_THREADS"] = str(args.hash_threads)
    if args.cmd in ("bench", "topk-bench", "loadgen") or (
        args.cmd in ("project", "stream-bench") and args.backend != "numpy"
    ):
        _check_device(args)
    if getattr(args, "metrics_port", None) is not None and not (
        0 <= args.metrics_port <= 65535
    ):
        raise SystemExit(
            f"--metrics-port must be 0..65535, got {args.metrics_port}"
        )
    telemetry = None
    if getattr(args, "telemetry_jsonl", None):
        # process-wide sink, AFTER flag validation: an invalid invocation
        # must abort without touching (creating or tail-repairing) the file
        from randomprojection_tpu_torch.utils import telemetry

        telemetry.configure(args.telemetry_jsonl)
    try:
        return _run_with_planes(args)
    finally:
        if telemetry is not None:
            telemetry.shutdown()


def _run_with_planes(args):
    """Run the command inside the live planes its flags ask for: the
    health engine is built before any bind (a malformed spec aborts with
    nothing to undo), the metrics endpoint binds before anything
    subscribes, and the flight recorder installs its handlers last; all
    come down in reverse, with a dump first when an exception unwinds."""
    global _METRICS_SERVER
    from randomprojection_tpu_torch.utils import telemetry

    engine = None
    if getattr(args, "health", None) is not None:
        from randomprojection_tpu_torch.utils import health

        try:
            engine = health.HealthEngine(slo=health.parse_slo_spec(args.health))
        except ValueError as e:
            raise SystemExit(f"--health: {e}")
    recorder = None
    if getattr(args, "flight_dump", None):
        recorder = telemetry.FlightRecorder()
        if engine is not None:
            engine.recorder = recorder  # a watchdog trip dumps
    live = None
    if getattr(args, "metrics_port", None) is not None:
        # a LiveAggregator subscribed to the event stream and an HTTP
        # /metrics endpoint for the duration of the command.  The endpoint
        # line goes to stderr: stdout keeps the last-line contracts.
        from randomprojection_tpu_torch.utils import metrics_server

        agg = telemetry.LiveAggregator()
        # bind first: a subscribe before a failed bind (address in use)
        # would leave a registered subscription nothing cleans up
        server = metrics_server.MetricsServer(
            port=args.metrics_port, aggregator=agg, health=engine
        )
        try:
            sub = telemetry.subscribe(agg, maxsize=4096,
                                      name="live-aggregator")
        except BaseException:
            server.close()
            raise
        live = (server, sub)
        _METRICS_SERVER = server
        print(f"metrics: serving {server.url}", file=sys.stderr)
    rec_sub = None
    if recorder is not None or engine is not None:
        # subscriptions after the bind; the recorder's signal and
        # excepthook handlers go in last, so a failed subscribe never
        # leaves a handler pointing at a recorder with no feed
        try:
            if recorder is not None:
                rec_sub = telemetry.subscribe(
                    recorder, maxsize=4096, name="flight-recorder"
                )
                recorder.install(args.flight_dump)
            if engine is not None:
                engine.start()
                if recorder is not None:
                    recorder.attach_health(engine.active)
        except BaseException:
            if rec_sub is not None:
                recorder.uninstall()
                telemetry.unsubscribe(rec_sub)
            if live is not None:
                _METRICS_SERVER = None
                live[0].close()
                telemetry.unsubscribe(live[1])
            raise
    try:
        rv = {
            "jl-dim": cmd_jl_dim,
            "info": cmd_info,
            "project": cmd_project,
            "stream-bench": cmd_stream_bench,
            "bench": cmd_bench,
            "topk-bench": cmd_topk_bench,
            "loadgen": cmd_loadgen,
            "recover": cmd_recover,
            "doctor": cmd_doctor,
            "report": cmd_doctor,  # alias
            "lint": cmd_lint,
        }[args.cmd](args)
        # for commands that wrote no exposition of their own (bench)
        _write_openmetrics(args)
    finally:
        if engine is not None:
            engine.close()
        if recorder is not None:
            # an exception unwinding through here dies after this finally
            # restores sys.excepthook: dump now, while the ring is still
            # subscribed, or the crash leaves nothing
            exc = sys.exc_info()[0]
            if exc is not None and not issubclass(
                exc, (SystemExit, KeyboardInterrupt)
            ):
                recorder.dump(reason=f"unhandled_exception:{exc.__name__}")
            recorder.uninstall()
            if rec_sub is not None:
                telemetry.unsubscribe(rec_sub)
        if live is not None:
            server, sub = live
            _METRICS_SERVER = None
            server.close()
            telemetry.unsubscribe(sub)
    return rv


if __name__ == "__main__":
    sys.exit(main())
