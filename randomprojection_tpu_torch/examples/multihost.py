"""Multi-process streamed projection (the port of ``examples/multihost.py``).

One process per host (or per card), every process running THIS module
unchanged.  ``distributed.initialize()`` joins the processes into one
``torch.distributed`` job, ``host_row_range`` gives each process its own
contiguous slice of the global stream (rows are independent in X·Rᵀ, so
no process waits for another), and every process draws the identical
matrix from the seed.

Single process (the card; ``--device cpu`` for the CPU)::

    python -m randomprojection_tpu_torch.examples.multihost

Two processes on one machine (gloo over localhost)::

    python -m randomprojection_tpu_torch.examples.multihost --device cpu \\
        --coordinator localhost:8476 --num-processes 2 --process-id 0 &
    python -m randomprojection_tpu_torch.examples.multihost --device cpu \\
        --coordinator localhost:8476 --num-processes 2 --process-id 1

A row's values depend on its global index alone: the reader draws fixed
1,024-row chunks, each from the seed of its chunk index (the reference
seeds each batch by its first row, so its rows depend on where batches
fall).  With ``--out PATH`` each process saves its rows as ``.npy``; the
processes' files, concatenated in rank order, equal one process's rows
(bit for bit with ``--materialization lazy`` on a card, whose kernel's
rows do not depend on their batch).
"""

import argparse
import json
import time

import numpy as np

CHUNK = 1024  # rows of one seeded chunk of the synthetic stream


def read_rows(g0: int, g1: int, d: int) -> np.ndarray:
    """Global rows ``[g0, g1)`` of the synthetic stream, ``(g1 - g0, d)``
    float32: chunk ``c`` is ``default_rng(c)``'s normals."""
    out = np.empty((g1 - g0, d), np.float32)
    for c in range(g0 // CHUNK, -(-g1 // CHUNK)):
        block = np.random.default_rng(c).standard_normal((CHUNK, d),
                                                         dtype=np.float32)
        lo, hi = max(g0, c * CHUNK), min(g1, (c + 1) * CHUNK)
        out[lo - g0:hi - g0] = block[lo - c * CHUNK:hi - c * CHUNK]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default=None,
                    help="coordinator address host:port (process 0 hosts it)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--rows", type=int, default=100_000)
    ap.add_argument("--d", type=int, default=1024)
    ap.add_argument("--k", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="'cpu' or a CUDA device (default: the card)")
    ap.add_argument("--materialization", choices=("dense", "lazy"),
                    default="dense")
    ap.add_argument("--batch-rows", type=int, default=16384)
    ap.add_argument("--out", default=None,
                    help="save this process's rows here (.npy)")
    args = ap.parse_args(argv)

    from randomprojection_tpu_torch import SparseRandomProjection
    from randomprojection_tpu_torch.parallel import distributed
    from randomprojection_tpu_torch.streaming import CallableSource

    distributed.initialize(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )
    # this process's slice of the global row range: no communication
    lo, hi = distributed.host_row_range(args.rows)
    src = CallableSource(lambda a, b: read_rows(lo + a, lo + b, args.d),
                         n_rows=hi - lo, n_features=args.d,
                         batch_rows=args.batch_rows)
    options = {"materialization": args.materialization}
    if args.device is not None:
        options["device"] = args.device
    # fit from the schema: the same (seed, k, d) everywhere => one matrix
    rp = SparseRandomProjection(
        args.k, density=1 / 3, random_state=0, backend="torch",
        backend_options=options,
    ).fit_schema(args.rows, args.d, np.float32)

    t0 = time.perf_counter()
    done, parts = 0, []
    for _, y in rp.transform_stream(src):
        done += y.shape[0]
        if args.out:
            parts.append(np.asarray(y))
    dt = time.perf_counter() - t0
    if args.out:
        np.save(args.out, np.concatenate(parts) if parts
                else np.empty((0, args.k), np.float32))
    print(json.dumps({
        "process": distributed.process_rank(),
        "process_count": distributed.world_size(),
        "row_range": [lo, hi],
        "rows_done": done,
        "rows_per_s": round(done / dt, 1) if dt > 0 else None,
        "device": str(rp._backend.device),
    }))


if __name__ == "__main__":
    main()
