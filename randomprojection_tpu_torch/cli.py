"""Command-line interface: ``python -m randomprojection_tpu_torch <cmd>``.

The counterpart of ``randomprojection_tpu/cli.py``'s main path:

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

``--backend auto`` (the default) is the torch backend on ``--device``
(default ``cuda``): with no card the command exits naming it and never
carries on on the CPU; ``--device cpu`` asks for the CPU (for ``bench``
that runs the kernels' plain versions, every timing flagged suspect).  The
reference's other subcommands (``topk-bench``, ``loadgen``,
``recover``, ``doctor``/``report``, ``lint``) and its live-plane flags
(``--openmetrics``, ``--metrics-port``, ``--health``, ``--flight-dump``)
are registered and refuse, naming their ROADMAP item; ``--debug-nans``
and ``--disable-jit`` set JAX options and ``--transform-dma`` picks the TPU
kernel's DMA route: they have no counterpart here and refuse too
(``bench`` takes ``--transform-dma auto``, its default: the kernel's one
route on the card).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

import numpy as np

#: later-slice subcommands: registered, they refuse naming their item
_LATER_COMMANDS = {
    "topk-bench": "ROADMAP A13 (ops planes)",
    "loadgen": "ROADMAP A13 (ops planes)",
    "recover": "ROADMAP A13 (ops planes)",
    "doctor": "ROADMAP A13 (ops planes)",
    "report": "ROADMAP A13 (ops planes)",
    "lint": "ROADMAP A13 (ops planes)",
}
#: the live plane's flags (ROADMAP A13): registered, they refuse
_A13_FLAGS = ("openmetrics", "metrics_port", "health", "flight_dump")
#: the reference's jax.config switches: no counterpart in torch
_JAX_FLAGS = ("debug_nans", "disable_jit")
#: the reference's TPU kernel switches: no counterpart on the card
_TPU_FLAGS = ("transform_dma",)


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
    later = "not ported yet (ROADMAP A13, the live plane); refused"
    p.add_argument("--openmetrics", default=None, metavar="PATH", help=later)
    p.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                   help=later)
    p.add_argument("--health", nargs="?", const="", default=None,
                   metavar="SPEC", help=later)
    p.add_argument("--flight-dump", default=None, metavar="PATH",
                   help=later)


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

    for name, item in _LATER_COMMANDS.items():
        # their arguments are not parsed: the command refuses whatever
        # follows it (main)
        sub.add_parser(name, help=f"not ported yet ({item})")
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


def cmd_bench(args):
    from randomprojection_tpu_torch.benchmark import emit_bench_output, run

    # the full record first, then the compact digest as the FINAL line
    emit_bench_output(run(
        args.preset, k=args.k, d=args.d, density=args.density,
        dispatch_steps=args.dispatch_steps, device=args.device,
    ))


def _cmd_later(args):
    raise SystemExit(
        f"'{args.cmd}' is not ported yet ({_LATER_COMMANDS[args.cmd]}); the "
        "port's CLI runs jl-dim, info, project, stream-bench and bench"
    )


def _refuse_flags(args) -> None:
    """Flags of a later slice, or of JAX alone, exit naming why."""
    for name in _A13_FLAGS:
        if getattr(args, name, None) is not None:
            flag = "--" + name.replace("_", "-")
            raise SystemExit(
                f"{flag} is not ported yet (ROADMAP A13, the live plane: "
                "OpenMetrics, the metrics endpoint, the health plane and "
                "the flight recorder)"
            )
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
    if args.cmd in _LATER_COMMANDS:
        return _cmd_later(args)
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
    if args.cmd == "bench" or (
        args.cmd in ("project", "stream-bench") and args.backend != "numpy"
    ):
        _check_device(args)
    telemetry = None
    if getattr(args, "telemetry_jsonl", None):
        # process-wide sink, AFTER flag validation: an invalid invocation
        # must abort without touching (creating or tail-repairing) the file
        from randomprojection_tpu_torch.utils import telemetry

        telemetry.configure(args.telemetry_jsonl)
    try:
        return {
            "jl-dim": cmd_jl_dim,
            "info": cmd_info,
            "project": cmd_project,
            "stream-bench": cmd_stream_bench,
            "bench": cmd_bench,
        }[args.cmd](args)
    finally:
        if telemetry is not None:
            telemetry.shutdown()


if __name__ == "__main__":
    sys.exit(main())
