#!/usr/bin/env python3
"""Which CSR route should CountSketch run on the card: the doc-major
compare-reduce, the flat scatter (``index_add_``) or a sorted segment sum.

The three compute the same ``(n, k)`` sketch of one float32 CSR batch with
the tables ``h``/``s`` resident on the card:

- **doc-major**: tokens laid out as a padded ``(n_pad, t_pad)`` matrix on
  the host, one gather of the packed table ``2h + (s<0)`` a token, then
  ``Y[r, c] = Σ_t sv[r, t]·[h[r, t] = c]`` as a masked reduction over a
  ``(chunk, t_pad, k)`` float32 tensor: no atomics, k times a scatter's
  elementwise work.
- **flat**: ``(row, idx, val)`` a token, ``row·k + h[idx]`` as the flat
  index and one ``index_add_`` of ``val·s[idx]`` into ``n_pad·k`` floats:
  float32 atomics, so the order of a bucket's sum varies from run to run.
- **sorted**: the flat keys sorted (``torch.sort``, stable), the runs of
  equal keys summed by ``torch.segment_reduce``: a fixed order.

At config 5's batch (65,536 docs × 100 tokens from a 50,000-word
vocabulary, seed 0, hashed by the port's ``FeatureHasher`` into 2^20
features, ``k = 256``) and at two other shapes (10 and 1,000 tokens a
doc, normal values), it times each route's device work with the tokens
resident (CUDA events, turns d f s s f d), its host layout (host clock),
checks each against the host float64 transform within rtol = atol = 2e-5,
and whether two runs give the same bits.  Run from the repository root on
a machine with a card::

    python3 torch_experiments/countsketch_routes.py

Prints one JSON line with the card's name and power limit beside the
milliseconds.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
K, FEATURES, VOCAB, TOKENS, DOCS = 256, 1 << 20, 50_000, 100, 65_536
SHAPES = (("config5", DOCS, TOKENS), ("short", DOCS, 10), ("long", 8192, 1000))
TOL = 2e-5
REPS = 5


def _events_ms(torch, fn, reps=REPS) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _row_bucket(n: int) -> int:
    pow2 = max(8, 1 << (n - 1).bit_length())
    if pow2 < 64:
        return pow2
    step = pow2 // 8
    for frac in (4, 5, 6, 7, 8):
        if step * frac >= n:
            return step * frac
    return pow2


def docmajor_layout(X):
    n = X.shape[0]
    n_pad = _row_bucket(n)
    counts = np.diff(X.indptr)
    t_pad = _row_bucket(int(counts.max()))
    rows = np.repeat(np.arange(n, dtype=np.int64), counts)
    pos = np.arange(X.nnz, dtype=np.int64) - np.repeat(
        X.indptr[:-1].astype(np.int64), counts)
    idxm = np.zeros((n_pad, t_pad), np.int32)
    valm = np.zeros((n_pad, t_pad), np.float32)
    idxm[rows, pos] = X.indices
    valm[rows, pos] = X.data
    return idxm, valm


def docmajor(torch, idxm, valm, hs, n: int):
    n_pad, t_pad = idxm.shape
    chunk = n_pad
    while chunk * t_pad * K * 4 > (1 << 28) and chunk % 2 == 0:
        chunk //= 2
    g = hs.index_select(0, idxm.reshape(-1)).reshape(n_pad, t_pad)
    sv = valm * (1 - 2 * (g & 1)).to(torch.float32)
    h2 = g >> 1
    iota = torch.arange(K, dtype=h2.dtype, device=h2.device)
    out = torch.empty((n_pad, K), dtype=torch.float32, device=h2.device)
    for lo in range(0, n_pad, chunk):
        hc, svc = h2[lo:lo + chunk], sv[lo:lo + chunk]
        out[lo:lo + chunk] = torch.where(
            hc[:, :, None] == iota, svc[:, :, None], 0.0).sum(dim=1)
    return out[:n]


def flat_layout(X):
    rows = np.repeat(np.arange(X.shape[0], dtype=np.int32), np.diff(X.indptr))
    return rows, X.indices.astype(np.int32), X.data.astype(np.float32)


def flat(torch, rows, idx, vals, h, s, n: int):
    key = rows.long() * K + h.index_select(0, idx)
    y = torch.zeros(n * K, dtype=torch.float32, device=rows.device)
    y.index_add_(0, key, vals * s.index_select(0, idx))
    return y.reshape(n, K)


def sorted_sum(torch, rows, idx, vals, h, s, n: int):
    key = rows.long() * K + h.index_select(0, idx)
    key, order = torch.sort(key, stable=True)
    v = (vals * s.index_select(0, idx))[order]
    uniq, counts = torch.unique_consecutive(key, return_counts=True)
    sums = torch.segment_reduce(v, "sum", lengths=counts)
    y = torch.zeros(n * K, dtype=torch.float32, device=rows.device)
    y[uniq] = sums
    return y.reshape(n, K)


def _config5_batch():
    import scipy.sparse as sp

    sys.path.insert(0, str(ROOT))
    from randomprojection_tpu_torch.ops.hashing import FeatureHasher

    rng = np.random.default_rng(0)
    words = np.asarray([f"tok{i}" for i in range(VOCAB)])
    toks = words[rng.integers(0, VOCAB, size=DOCS * TOKENS)]
    indptr = np.arange(0, DOCS * TOKENS + 1, TOKENS, dtype=np.int64)
    fh = FeatureHasher(n_features=FEATURES, input_type="string",
                       dtype=np.float32)
    return sp.csr_array(fh.transform_tokens(toks, indptr))


def _batch(name, n, t):
    import scipy.sparse as sp

    if name == "config5":
        return _config5_batch()
    rng = np.random.default_rng(1)
    return sp.csr_array(
        (rng.normal(size=n * t).astype(np.float32),
         rng.integers(0, FEATURES, size=n * t).astype(np.int32),
         np.arange(0, n * t + 1, t, dtype=np.int64)), shape=(n, FEATURES))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("countsketch_routes: no CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(0)
    h_np = rng.integers(0, K, size=FEATURES).astype(np.int32)
    s_np = np.where(rng.random(FEATURES) < 0.5, -1, 1).astype(np.int8)
    dev = torch.device("cuda")
    h = torch.from_numpy(h_np).to(dev)
    s = torch.from_numpy(s_np.astype(np.float32)).to(dev)
    hs = torch.from_numpy((h_np.astype(np.int64) * 2 + (s_np < 0)).astype(
        np.int32)).to(dev)
    out = {"card": card, "torch": torch.__version__, "shapes": {}}
    for name, n, t in SHAPES:
        X = _batch(name, n, t)
        n = X.shape[0]
        rows_h = np.repeat(np.arange(n), np.diff(X.indptr))
        want = np.zeros((n, K))
        np.add.at(want, (rows_h, h_np[X.indices]),
                  X.data.astype(np.float64) * s_np[X.indices])
        t0 = time.perf_counter()
        idxm, valm = docmajor_layout(X)
        host_d = time.perf_counter() - t0
        t0 = time.perf_counter()
        rows, idx, vals = flat_layout(X)
        host_f = time.perf_counter() - t0
        dm = [torch.from_numpy(a).to(dev) for a in (idxm, valm)]
        fl = [torch.from_numpy(a).to(dev) for a in (rows, idx, vals)]
        runs = {
            "docmajor": lambda: docmajor(torch, *dm, hs, n),
            "flat": lambda: flat(torch, *fl, h, s, n),
            "sorted": lambda: sorted_sum(torch, *fl, h, s, n),
        }
        res = {k: {"ms": []} for k in runs}
        for k in ("docmajor", "flat", "sorted", "sorted", "flat", "docmajor"):
            res[k]["ms"].append(round(_events_ms(torch, runs[k]), 4))
        for k, fn in runs.items():
            a, b = fn().cpu().numpy(), fn().cpu().numpy()
            res[k]["max_abs_err"] = float(np.abs(a - want).max())
            res[k]["within_tol"] = bool(np.allclose(a, want, rtol=TOL, atol=TOL))
            res[k]["same_bits_twice"] = bool(np.array_equal(a, b))
        res["docmajor"]["host_layout_ms"] = round(host_d * 1e3, 3)
        res["docmajor"]["t_pad"] = int(idxm.shape[1])
        res["flat"]["host_layout_ms"] = res["sorted"]["host_layout_ms"] = round(
            host_f * 1e3, 3)
        out["shapes"][name] = {"docs": n, "tokens": int(X.nnz), **res}
        del dm, fl
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
