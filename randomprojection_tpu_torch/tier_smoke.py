"""Tiered hot/cold residency parity at toy shapes (the port's tier smoke).

The counterpart of ``randomprojection_tpu/tier_smoke.py``, single-device:
an index whose corpus is 4× an artificially small device-memory budget
(one chunk of four hot, three cold) answers bit for bit like the fully
resident index on the exact path, on the LSH tier at partial and full
probe coverage, with tombstones spanning the hot/cold seam, and on the
disk rung's memmapped spills; the hot set never exceeds the budget; an
injected staging-upload failure still answers exactly while landing on
the fallback counter; a tiered snapshot round-trips through ``durable``
with its residency block verified; and eight LSH shards sharing the
device, each under a budget below any chunk (every shard all cold),
merge to the fully resident sharded index's answers with tombstones
across shard boundaries.

Run ``python -m randomprojection_tpu_torch.tier_smoke [--device cpu]``
(the card unless asked); ``chip_smoke.py`` and the CPU tests call
``main``.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

__all__ = ["main"]


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def main(device=None) -> dict:
    """Run every leg on ``device`` (None: the card); raises on the first
    mismatch and returns a summary of what ran."""
    from randomprojection_tpu_torch import durable
    from randomprojection_tpu_torch.ann import (
        LSHShardedSimHashIndex,
        LSHSimHashIndex,
    )
    from randomprojection_tpu_torch.backends.torch_backend import resolve_device
    from randomprojection_tpu_torch.models import sketch as sk
    from randomprojection_tpu_torch.ops import topk_kernels
    from randomprojection_tpu_torch.utils import telemetry

    device = str(resolve_device(device, how="device='cpu'"))
    rng = np.random.default_rng(0)
    chunk_rows, n_bytes, n_chunks = 600, 8, 4
    codes = rng.integers(0, 256, size=(chunk_rows * n_chunks, n_bytes),
                         dtype=np.uint8)
    queries = rng.integers(0, 256, size=(24, n_bytes), dtype=np.uint8)
    m = 7
    # the acceptance shape: the corpus is 4x the budget, one chunk fits
    budget = chunk_rows * n_bytes
    full = 1 << 4
    lsh_kw = dict(bands=4, band_bits=4, fallback_density=1.0,
                  probe_path="host")
    opened = []

    def build(cls, **kw):
        idx = cls(codes[:chunk_rows], device=device, **kw)
        opened.append(idx)
        for lo in range(chunk_rows, codes.shape[0], chunk_rows):
            idx.add(codes[lo:lo + chunk_rows])
        return idx

    def same(a, b, what):
        _check(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]),
               f"{what}: tiered != fully resident")

    reg = telemetry.registry()
    try:
        # -- exact path, 4x over budget -----------------------------------
        ref = build(sk.SimHashIndex)
        tiered = build(sk.SimHashIndex, hbm_budget_bytes=budget)
        r = tiered._tier.residency()
        _check(r["hot_bytes"] <= budget, "hot set exceeds the budget")
        cold = sum(c["tier"] != "hot" for c in r["chunks"])
        _check(cold == n_chunks - 1, f"{cold} cold chunks, expected {n_chunks - 1}")
        want = ref.query_topk(queries, m)
        same(tiered.query_topk(queries, m), want, "exact path")

        # -- LSH tier: partial and full probes, seam-spanning tombstones --
        lref = build(LSHSimHashIndex, **lsh_kw)
        ltier = build(LSHSimHashIndex, hbm_budget_bytes=budget, **lsh_kw)
        for p in (2, full):
            same(ltier.query_topk(queries, m, probes=p),
                 lref.query_topk(queries, m, probes=p), f"LSH at probes={p}")
        dead = np.arange(chunk_rows - 60, chunk_rows + 60)
        lref.delete(dead)
        ltier.delete(dead)
        want3 = lref.query_topk(queries, m, probes=full)
        got3 = ltier.query_topk(queries, m, probes=full)
        same(got3, want3, "tombstoned LSH path")
        # full coverage is the masked brute force through the tiered merge
        D = sk.pairwise_hamming(queries, codes).astype(np.int64)
        D[:, dead] = n_bytes * 8 + 1
        key = (D << 32) | np.arange(codes.shape[0], dtype=np.int64)
        sel = np.argsort(key, axis=1, kind="stable")[:, :m]
        _check(np.array_equal(got3[0], np.take_along_axis(D, sel, 1))
               and np.array_equal(got3[1], sel),
               "tiered full-probe LSH != masked brute force")

        # -- degraded rung: an injected upload failure ----------------------
        before = reg.counter("index.tier.fallbacks")
        orig = topk_kernels.stage_rows

        def _boom(*a, **k):
            raise RuntimeError("injected staging failure")

        topk_kernels.stage_rows = _boom
        try:
            got = ltier.query_topk(queries, m, probes=full)
            got_exact = tiered.query_topk(queries, m)
        finally:
            topk_kernels.stage_rows = orig
        same(got, want3, "upload-failure rung (LSH)")
        same(got_exact, want, "upload-failure rung (exact)")
        fallbacks = reg.counter("index.tier.fallbacks") - before
        _check(fallbacks > 0, "the upload-failure rung never hit the "
               "fallback counter")

        # -- disk rung and the snapshot round trip --------------------------
        with tempfile.TemporaryDirectory() as tmp:
            cold_dir = os.path.join(tmp, "cold")
            disk = build(sk.SimHashIndex, hbm_budget_bytes=budget,
                         cold_tier="disk", cold_dir=cold_dir)
            spills = [f for f in os.listdir(cold_dir) if f.startswith("chunk-")]
            _check(len(spills) == n_chunks - 1,
                   f"disk tier spilled {len(spills)} chunks")
            same(disk.query_topk(queries, m), want, "disk-tier exact path")
            snap = os.path.join(tmp, "snap")
            manifest = durable.save_index(disk, snap)
            _check(manifest["tier"]["cold_tier"] == "disk", "tier block")
            status = durable.verify_snapshot(snap)
            _check(status["ok"] and status["tier"]["cold_chunks"] > 0,
                   f"tiered snapshot failed verification: {status}")
            restored = durable.load_index(snap, device=device)
            same(restored.query_topk(queries, m), want,
                 "snapshot restored resident")
            retiered = durable.load_index(
                snap, device=device, index_kwargs={"hbm_budget_bytes": budget})
            opened.append(retiered)
            _check(retiered._tier.any_cold(), "restore did not re-tier")
            same(retiered.query_topk(queries, m), want,
                 "snapshot restored under a budget")
            disk.close()

        # -- 8 shards with budgets a shard (tombstones included) ------------
        sref = LSHShardedSimHashIndex(codes, devices=[device], n_shards=8,
                                      **lsh_kw)
        # a budget below any chunk: every shard serves all cold
        stier = LSHShardedSimHashIndex(codes, devices=[device], n_shards=8,
                                       hbm_budget_bytes=n_bytes, **lsh_kw)
        opened += [sref, stier]
        for index in (sref, stier):
            index.delete(np.arange(200, 420))
        _check(all(s._tier.any_cold() for s in stier._shards),
               "a budgeted shard holds no cold chunk")
        same(stier.query_topk(queries, m, probes=full),
             sref.query_topk(queries, m, probes=full),
             "8-shard all-cold merge")
    finally:
        for idx in opened:
            idx.close()
    return {"device": device, "chunks": n_chunks, "cold_chunks": cold,
            "budget_bytes": budget, "fallbacks": int(fallbacks)}


def _main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m randomprojection_tpu_torch.tier_smoke")
    p.add_argument("--device", default=None,
                   help="a torch device ('cpu', 'cuda'); default: the card")
    a = p.parse_args(argv)
    summary = main(a.device)
    print(f"tier-smoke OK on {summary['device']}: a 4x-over-budget tiered "
          "index answers bit for bit like the fully resident one (exact, LSH "
          "at partial and full probes, seam-spanning tombstones, the upload-"
          "failure rung, disk spills, the snapshot round trip, an 8-shard "
          "all-cold merge)")
    return 0


if __name__ == "__main__":
    sys.exit(_main())
