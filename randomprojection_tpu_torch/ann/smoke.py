"""Multi-probe LSH tier parity at toy shapes (the port of
``randomprojection_tpu/ann/smoke.py``)::

    python -m randomprojection_tpu_torch.ann.smoke [--device cpu]

On one device (the card unless asked): at full probe coverage with the
fallback ladder off (so the re-rank path really runs)
``LSHSimHashIndex.query_topk`` and ``LSHShardedSimHashIndex.query_topk``
over eight shards equal ``topk_bruteforce`` bit for bit, with tombstones
spanning shard boundaries; the density-fallback rung serves the same
answers through the exact path; every partial-probe distance is the true
Hamming distance of its id; and the device rung (the probe kernel K5 and
the top-k kernel K4; their plain versions on the CPU) equals the host
rung and brute force across two chunks with seam-spanning tombstones, at
a ragged ``n_bits`` and over eight shards.  Exit 0 prints
``ann-smoke OK``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

__all__ = ["main"]


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def main(device=None) -> dict:
    """Run every leg on ``device`` (None: the card); raises on the first
    mismatch and returns a summary."""
    from randomprojection_tpu_torch.ann import (
        LSHShardedSimHashIndex,
        LSHSimHashIndex,
    )
    from randomprojection_tpu_torch.backends.torch_backend import resolve_device
    from randomprojection_tpu_torch.models import sketch as sk
    from randomprojection_tpu_torch.serving.smoke import masked_bruteforce

    dev = str(resolve_device(device, how="device='cpu'"))
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 256, size=(1100, 8), dtype=np.uint8)
    queries = rng.integers(0, 256, size=(24, 8), dtype=np.uint8)
    m = 7
    full, full4 = 1 << 8, 1 << 4  # probes >= 2^band_bits: every bucket
    want = masked_bruteforce(queries, codes, m)

    def same(got, ref, what):
        _check(np.array_equal(got[0], ref[0])
               and np.array_equal(got[1], ref[1]), what)

    # full coverage, ladder off: the re-rank reproduces brute force
    lsh = LSHSimHashIndex(codes, device=dev, bands=4, band_bits=8,
                          fallback_density=1.0)
    same(lsh.query_topk(queries, m, probes=full), want,
         "full-probe LSH != brute force")
    # the density-fallback rung: the exact path serves
    low = LSHSimHashIndex(codes, device=dev, bands=4, band_bits=8,
                          fallback_density=0.01)
    same(low.query_topk(queries, m, probes=full), want,
         "density-fallback rung != brute force")
    # partial probes: approximate, but each distance is its id's
    dp, ip = lsh.query_topk(queries, m, probes=2)
    D = sk.pairwise_hamming(queries, codes)
    _check((np.take_along_axis(D, ip, axis=1) == dp).all(),
           "partial-probe distances are not the true Hamming distances")

    # 8 shards, [200, 420) across boundaries: full probes == masked brute
    dead = np.arange(200, 420)
    masked = masked_bruteforce(queries, codes, m, dead)
    sh = LSHShardedSimHashIndex(codes, devices=[dev], n_shards=8, bands=4,
                                band_bits=8, fallback_density=1.0)
    sh.delete(dead)
    same(sh.query_topk(queries, m, probes=full), masked,
         "sharded full-probe LSH != masked brute force")

    # the device rung: two chunks, tombstones across the seam
    dv = LSHSimHashIndex(codes[:700], device=dev, bands=4, band_bits=4,
                         fallback_density=1.0, probe_path="device")
    dv.add(codes[700:])
    dv.delete(np.arange(650, 760))
    same(dv.query_topk(queries, m, probes=full4),
         masked_bruteforce(queries, codes, m, np.arange(650, 760)),
         "device-rung full-probe LSH != brute force (two chunks, tombstones)")
    same(dv.query_topk(queries, m, probes=3),
         dv.query_topk(queries, m, probes=3, probe_path="host"),
         "device-rung partial probes != host rung")
    # ragged n_bits (61 of 64): device rung == host rung at full coverage
    kw = dict(device=dev, bands=4, band_bits=4, n_bits=61,
              fallback_density=1.0)
    same(LSHSimHashIndex(codes, probe_path="device", **kw).query_topk(
             queries, m, probes=full4),
         LSHSimHashIndex(codes, probe_path="host", **kw).query_topk(
             queries, m, probes=full4),
         "device rung != host rung at n_bits=61")
    # 8 shards on the device rung, one shard wholly dead
    sh2 = LSHShardedSimHashIndex(codes, devices=[dev], n_shards=8, bands=4,
                                 band_bits=4, fallback_density=1.0,
                                 probe_path="device")
    sh2.delete(dead)
    same(sh2.query_topk(queries, m, probes=full4), masked,
         "sharded device-rung full-probe LSH != masked brute force")
    return {"device": dev, "shards": 8}


def _main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m randomprojection_tpu_torch.ann.smoke")
    p.add_argument("--device", default=None,
                   help="a torch device ('cpu', 'cuda'); default: the card")
    summary = main(p.parse_args(argv).device)
    print(f"ann-smoke OK on {summary['device']}: full-probe LSH == brute "
          "force (one index and 8 shards, cross-shard tombstones); density "
          "fallback exact; partial-probe distances exact; the device rung "
          "equals the host rung (two chunks, tombstones, ragged n_bits, "
          "8 shards)")
    return 0


if __name__ == "__main__":
    sys.exit(_main())
