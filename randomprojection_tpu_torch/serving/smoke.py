"""Sharded-tier parity at toy shapes (the port of
``randomprojection_tpu/serving/smoke.py``)::

    python -m randomprojection_tpu_torch.serving.smoke [--device cpu]

On one device (the card unless asked), eight shards sharing it answer
``query_topk`` bit for bit like ``topk_bruteforce`` on the concatenated
corpus, and so does a second layout of four shards (the reference's
second leg pins its ``lax.scan`` route, which the port does not have);
both hold with tombstones spanning shard boundaries and with a global id
space offset past int32.  On a card each tile launches the top-k kernel
once a shard (one scan and one merge each).  Exit 0 prints
``shard-smoke OK``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

__all__ = ["main", "masked_bruteforce"]


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def masked_bruteforce(A, B, m: int, dead=()):
    """``topk_bruteforce`` with the ``dead`` columns losing every
    comparison: the contract tombstones carry."""
    from randomprojection_tpu_torch.models.sketch import pairwise_hamming

    D = pairwise_hamming(A, B).astype(np.int64)
    D[:, np.asarray(dead, dtype=np.int64)] = B.shape[1] * 8 + 1
    key = (D << 32) | np.arange(D.shape[1], dtype=np.int64)[None, :]
    sel = np.argsort(key, axis=1, kind="stable")[:, :m]
    return (np.take_along_axis(D, sel, axis=1).astype(np.int32),
            sel.astype(np.int64))


def main(device=None) -> dict:
    """Run every leg on ``device`` (None: the card); raises on the first
    mismatch and returns a summary."""
    from randomprojection_tpu_torch.backends.torch_backend import resolve_device
    from randomprojection_tpu_torch.ops import topk_kernels as tk
    from randomprojection_tpu_torch.serving import ShardedSimHashIndex

    dev = resolve_device(device, how="device='cpu'")
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 256, size=(1100, 8), dtype=np.uint8)
    queries = rng.integers(0, 256, size=(24, 8), dtype=np.uint8)
    m = 7
    want = masked_bruteforce(queries, codes, m)

    def same(got, ref, what):
        _check(got[1].dtype == np.int64, f"{what}: ids are {got[1].dtype}")
        _check(np.array_equal(got[0], ref[0])
               and np.array_equal(got[1], ref[1]), what)

    idx = ShardedSimHashIndex(codes, devices=[dev], n_shards=8)
    tk.reset_launches()
    eight = idx.query_topk(queries, m)
    launches = dict(tk.LAUNCHES)
    same(eight, want, "8 shards != brute force")
    if dev.type == "cuda":
        scans = launches["rp_fused_topk_wgmma"] + launches["rp_fused_topk_popc"]
        _check(scans == 8 and launches["rp_topk_merge"] == 8,
               f"8 shards launched the top-k kernel {launches}, not one "
               "scan and one merge a shard")

    four = ShardedSimHashIndex(codes, devices=[dev], n_shards=4)
    same(four.query_topk(queries, m), eight, "4 shards != 8 shards")

    # 8 shards of ~137 rows: [200, 420) crosses two boundaries
    dead = np.arange(200, 420)
    for index in (idx, four):
        index.delete(dead)
    masked = masked_bruteforce(queries, codes, m, dead)
    same(idx.query_topk(queries, m), masked, "cross-shard tombstones (8)")
    same(four.query_topk(queries, m), masked, "cross-shard tombstones (4)")

    # a global id space past int32: the same distances, ids shifted
    off = 2**31 + 13
    wide = ShardedSimHashIndex(codes, devices=[dev], n_shards=4,
                               id_offset=off)
    dw, iw = wide.query_topk(queries, m)
    same((dw, iw - off), want, "id_offset changed the answer")
    _check(int(iw.min()) > 2**31, "ids past int32 did not surface")
    return {"device": str(dev), "shards": (8, 4), "launches": launches}


def _main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m randomprojection_tpu_torch.serving.smoke")
    p.add_argument("--device", default=None,
                   help="a torch device ('cpu', 'cuda'); default: the card")
    summary = main(p.parse_args(argv).device)
    print(f"shard-smoke OK on {summary['device']}: 8 shards == 4 shards == "
          "brute force; cross-shard tombstones and ids past int32 bit for bit")
    return 0


if __name__ == "__main__":
    sys.exit(_main())
