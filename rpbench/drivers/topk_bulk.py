"""Exact top-m queries from one closed-loop caller sending large query sets.

Set-up makes the configuration's planted-neighbour codes on the card from
the seed and hands them to one ``SimHashIndex`` (they stay where they
are), then a pool of planted queries (corpus rows with bits flipped),
copied to the host as a caller would hold them.  The window sends
``query_topk(queries, m, tile=query_tile)`` calls of ``call_queries``
rows back to back, each call a distinct slice of the pool;
``queries_per_s`` is every query answered over the window's time, which
ends when the call running at ``seconds`` returns.

The check: ``check_queries`` query rows drawn from the seed among a
reservoir of ``keep_calls`` calls, their (dist, id) lists against the
exact reference over the same codes, made again from the seed.
"""

from __future__ import annotations

import random
import time

from rpbench import data
from rpbench import trace as tr
from rpbench.reference import hamming_topk

E2E = {"queries_per_s": "queries/s"}

# (dist, id) entries that differ from the exact answer: an exact
# comparison
LIMIT = 0


def make_codes(ctx):
    """The corpus: the configuration's planted codes, from the seed."""
    c = ctx.config
    return data.planted_codes(c["n_codes"], c["code_bytes"], c["cluster"],
                              c["noise_bits"], data.generator(ctx.seed,
                                                              ctx.device, 1),
                              device=ctx.device)


def make_queries(ctx, codes, nq: int):
    """``nq`` planted queries as a host array."""
    g = data.generator(ctx.seed, ctx.device, 2)
    return data.planted_queries(codes, nq, ctx.config["query_noise_bits"],
                                g).cpu().numpy()


def make_index(ctx, codes):
    from randomprojection_tpu_torch.models.sketch import SimHashIndex

    return SimHashIndex(codes, device=ctx.device)


def exact_mismatches(ctx, queries, dist, idx, control: bool = False) -> int:
    """Entries of the program's (dist, id) planes for ``queries`` that differ
    from the exact reference, over codes made again from the seed; with
    ``control`` the reference with ties to the higher id stands in for
    the program's planes."""
    import torch

    codes = make_codes(ctx)
    q = torch.from_numpy(queries)
    rd, ri = hamming_topk.topk(q, codes, ctx.config["m"])
    if control:
        dist, idx = hamming_topk.topk(q, codes, ctx.config["m"],
                                      ties="higher")
    del codes
    return hamming_topk.mismatches(dist, idx, rd, ri)


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.attempted = 0
        self.failed = 0

    def setup(self):
        t = self.ctx.traffic
        t0 = time.perf_counter()
        codes = make_codes(self.ctx)
        self.pool = make_queries(self.ctx, codes,
                                 t["pool_calls"] * t["call_queries"])
        self.index = make_index(self.ctx, codes)
        del codes
        t1 = time.perf_counter()
        self.index.query_topk(self._call(0), self.ctx.config["m"],
                              tile=self.ctx.config["query_tile"])
        self.ctx.log(f"codes, queries and index {t1 - t0:.3f} s, warm call "
                     f"{time.perf_counter() - t1:.3f} s")

    def _call(self, i):
        t = self.ctx.traffic
        j = i % t["pool_calls"]
        return self.pool[j * t["call_queries"]:(j + 1) * t["call_queries"]]

    def window(self, seconds):
        c, t = self.ctx.config, self.ctx.traffic
        rng = random.Random(self.ctx.seed)
        k = t["keep_calls"]
        self.kept = []  # (call index, dist, idx)
        calls = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            with tr.span("query_topk"):
                d, i = self.index.query_topk(self._call(calls), c["m"],
                                             tile=c["query_tile"])
            data.keep(self.kept, data.reservoir_slot(rng, calls, k),
                      (calls, d, i))
            calls += 1
        elapsed = time.perf_counter() - t0
        self.attempted = calls * t["call_queries"]
        tiles = -(-t["call_queries"] // c["query_tile"])
        self.ctx.layer["k4"] = {
            "tiles": [(c["query_tile"], calls * tiles)],
            "n_codes": c["n_codes"], "n_bytes": c["code_bytes"], "m": c["m"]}
        return {"queries_per_s": self.attempted / elapsed}

    def release(self):
        import torch

        self.index.close()
        del self.index
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False):
        import numpy as np

        rows = [(ci, r) for ci, _d, _i in self.kept
                for r in range(self.ctx.traffic["call_queries"])]
        rng = np.random.default_rng([self.ctx.seed, 3])
        pick = rng.choice(len(rows), min(len(rows),
                                         self.ctx.traffic["check_queries"]),
                          replace=False)
        by_call = {ci: (d, i) for ci, d, i in self.kept}
        sel = [rows[p] for p in sorted(pick)]
        queries = np.stack([self._call(ci)[r] for ci, r in sel])
        dist = np.stack([by_call[ci][0][r] for ci, r in sel])
        idx = np.stack([by_call[ci][1][r] for ci, r in sel])
        bad = exact_mismatches(self.ctx, queries, dist, idx, control)
        return [("topk_mismatches", bad, LIMIT)]

    def close(self):
        index = self.__dict__.pop("index", None)
        if index is not None:
            index.close()
        for name in ("pool", "kept"):
            self.__dict__.pop(name, None)
