"""Config 3 (BASELINE.json:9): very-sparse Li RP 10M×16384→512, DP×TP (the
port of ``examples/config3_verysparse_tp.py``).

density = 1/√d (Li/Hastie/Church 2006).  d = 16384 is the regime where the
contraction dimension is worth sharding: the mesh is DP×TP, R is drawn
directly into its column-sharded layout (each device holds only its
shard), and each position's partial product is added over the feature
axis.

``--devices N`` lays the mesh over N positions that all name ``--device``
(the card by default; ``cpu`` for the CPU), as the reference's flag lays
it over a virtual CPU mesh; without it the mesh spans every card.  With 4
or more positions (an even count) the mesh is ``{"data": N/2, "feature":
2}``, the reference's v5e-8 layout at N = 8.  ``--materialization lazy``
regenerates the mask inside the fused kernel, one launch a position.

    python -m randomprojection_tpu_torch.examples.config3_verysparse_tp \\
        --devices 8 --device cpu
"""

import argparse
import json
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", choices=["small", "full"], default="small")
    ap.add_argument("--devices", type=int, default=None,
                    help="a mesh of this many positions on --device")
    ap.add_argument("--device", default=None,
                    help="'cpu' or a CUDA device (default: the card)")
    ap.add_argument("--materialization", choices=("dense", "lazy"),
                    default="dense")
    ap.add_argument("--rows", type=int, default=None,
                    help="cut the stream to this many rows")
    args = ap.parse_args(argv)

    from randomprojection_tpu_torch import SparseRandomProjection
    from randomprojection_tpu_torch.backends.torch_backend import (
        resolve_device,
    )
    from randomprojection_tpu_torch.parallel import make_mesh, mesh_shape_for
    from randomprojection_tpu_torch.streaming import CallableSource

    if args.devices:
        devices = [resolve_device(args.device, how="--device cpu")] * args.devices
        n_dev = args.devices
    else:
        devices = None if args.device is None else [resolve_device(args.device)]
        import torch

        n_dev = torch.cuda.device_count() if devices is None else 1
    feature_shards = 2 if n_dev >= 4 and n_dev % 2 == 0 else 1
    mesh = make_mesh(mesh_shape_for(n_dev, feature_shards), devices)

    if args.scale == "full":
        n, d, k, batch = 10_000_000, 16_384, 512, 131_072
    else:
        n, d, k, batch = 50_000, 2048, 64, 8192
    if args.rows is not None:
        n = args.rows

    def read(lo, hi):
        return np.random.default_rng(lo).normal(
            size=(hi - lo, d)).astype(np.float32)

    src = CallableSource(read, n_rows=n, n_features=d, batch_rows=batch)
    rp = SparseRandomProjection(
        k, density="auto", random_state=0, backend="torch",
        backend_options={
            "mesh": mesh,
            "feature_axis": "feature" if feature_shards > 1 else None,
            "materialization": args.materialization,
        },
    ).fit_source(src)

    t0 = time.perf_counter()
    total, checksum = 0, 0.0
    for lo, y in rp.transform_stream(src):
        total += y.shape[0]
        checksum += float(y[0, 0])
    dt = time.perf_counter() - t0
    print(json.dumps({
        "config": 3, "mesh": dict(mesh.shape), "density": rp.density_,
        "rows": total, "rows_per_s": round(total / dt, 1),
        "checksum": checksum,
    }))


if __name__ == "__main__":
    main()
