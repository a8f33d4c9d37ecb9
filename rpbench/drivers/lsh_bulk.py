"""Multi-probe LSH top-m queries from one closed-loop caller sending large
query sets.

Set-up makes the configuration's planted codes on the card from the seed
(``topk_bulk.make_codes``) and hands them to one ``LSHSimHashIndex``,
which builds its banded buckets where the codes are; then a pool of
planted queries, copied to the host as a caller would hold them.  It
warms every tile key the pool needs (one tile of each slot budget, each
a CUDA graph on a card), so that no capture falls in the window.  A
program whose index cannot build its buckets on the card stops at once,
before any code is made: the host build would take minutes at this size.

The window sends ``query_topk(queries, m, tile=rerank_tile,
probes=probes)`` calls of ``call_queries`` rows back to back, each call a
distinct slice of the pool; ``queries_per_s`` is every query answered
over the window's time, which ends when the call running at ``seconds``
returns.  It leaves the shape of K4's re-rank for ``k4_roofline``: the
window's tiles, each over the mean candidate union a tile
(``index.lsh.candidates``).

The check, over codes made again from the seed: ``check_tiles`` whole
tiles drawn from the seed among a reservoir of ``keep_calls`` calls,
their (dist, id) lists against the plain LSH reference
(``lsh_mismatches``, an exact comparison); the tiles the tier served
exact over the window (``lsh_fallback_tiles``: such a tile measures the
exact path, not this one); and ``recall_miss``, 1 − recall@m of those
queries against the exact top-m over the whole shard (the port's
``LSH_RECALL_GATE`` of 0.95: a tripwire on the setting, not on the
program).
"""

from __future__ import annotations

import functools
import random
import time

import numpy as np

from rpbench import data
from rpbench import trace as tr
from rpbench.drivers.topk_bulk import make_codes, make_queries
from rpbench.reference import hamming_topk, lsh_topk

E2E = {"queries_per_s": "queries/s"}

# limits: the tier's semantics are integer and exact; no tile of the
# window may take the exact path; recall@m at least the port's gate 0.95
LIMITS = {"lsh_mismatches": 0, "lsh_fallback_tiles": 0, "recall_miss": 0.05}

#: what stands in for the program's answers in a control: the reference
#: with ties to the higher id, the exact top-m over the whole shard, or
#: the reference with its last band dropped
CONTROLS = ("ties", "exact", "band")


def _counter(name: str) -> int:
    from randomprojection_tpu_torch.utils import telemetry

    return int(telemetry.registry().counter(name))


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.attempted = 0
        self.failed = 0

    def setup(self):
        # the card build of the bucket index, called by name: a program
        # without it fails here, in seconds
        from randomprojection_tpu_torch.ann import LSHSimHashIndex
        from randomprojection_tpu_torch.ops.probe_kernels import (  # noqa: F401
            fold_band_csr,
        )

        c, t = self.ctx.config, self.ctx.traffic
        t0 = time.perf_counter()
        codes = make_codes(self.ctx)
        self.pool = make_queries(self.ctx, codes,
                                 t["pool_calls"] * t["call_queries"])
        t1 = time.perf_counter()
        self.index = LSHSimHashIndex(
            codes, device=self.ctx.device, bands=c["bands"],
            band_bits=c["band_bits"], probes=c["probes"],
            fallback_density=c["fallback_density"],
            probe_path=c["probe_path"])
        del codes
        t2 = time.perf_counter()
        self._warm()
        self.ctx.log(f"codes and queries {t1 - t0:.3f} s, index and buckets "
                     f"{t2 - t1:.3f} s, warm tiles "
                     f"{time.perf_counter() - t2:.3f} s")

    def _warm(self):
        """One tile of each slot budget the pool's tiles need: a tile's
        key is its budget (every tile has ``rerank_tile`` rows), and its
        first tile captures the graph."""
        c = self.ctx.config
        idx = self.index
        masks = idx._probe_masks(c["probes"])
        tile = c["rerank_tile"]
        firsts = {}
        for lo in range(0, self.pool.shape[0], tile):
            a = self.pool[lo:lo + tile]
            firsts.setdefault(idx._lsh_device_cap(a, masks, c["m"]), a)
        self.ctx.log(f"slot budgets of the pool's tiles: {sorted(firsts)}")
        idx.query_topk(np.concatenate(list(firsts.values())), c["m"],
                       tile=tile, probes=c["probes"])

    def _call(self, i):
        t = self.ctx.traffic
        j = i % t["pool_calls"]
        return self.pool[j * t["call_queries"]:(j + 1) * t["call_queries"]]

    def window(self, seconds):
        from randomprojection_tpu_torch.ops import probe_kernels

        c, t = self.ctx.config, self.ctx.traffic
        rng = random.Random(self.ctx.seed)
        self.kept = []  # (call index, dist, idx)
        calls = 0
        f0, g0 = _counter("index.lsh.fallbacks"), probe_kernels.GRAPH_CAPTURES
        c0 = _counter("index.lsh.candidates")
        ends = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            with tr.span("query_topk"):
                d, i = self.index.query_topk(self._call(calls), c["m"],
                                             tile=c["rerank_tile"],
                                             probes=c["probes"])
            ends.append(time.perf_counter())
            data.keep(self.kept, data.reservoir_slot(rng, calls,
                                                     t["keep_calls"]),
                      (calls, d, i))
            calls += 1
        elapsed = time.perf_counter() - t0
        self.fallback_tiles = _counter("index.lsh.fallbacks") - f0
        # K4 re-ranks each tile's candidate union: the function whose least
        # time k4_roofline reads is the exact top-m of a tile's queries
        # over its candidates, on average this many codes
        tiles = calls * -(-t["call_queries"] // c["rerank_tile"])
        self.ctx.layer["k4"] = {
            "tiles": [(c["rerank_tile"], tiles)],
            "n_codes": (_counter("index.lsh.candidates") - c0) / max(tiles, 1),
            "n_bytes": c["code_bytes"], "m": c["m"]}
        walls = np.diff([t0] + ends) * 1e3
        self.ctx.log(f"{calls} calls, {self.fallback_tiles} tiles served "
                     f"exact, {probe_kernels.GRAPH_CAPTURES - g0} graphs "
                     f"captured in the window, "
                     f"{self.ctx.layer['k4']['n_codes']:.1f} candidates a "
                     f"tile; a call's wall ms: min "
                     f"{walls.min():.2f}, median {np.median(walls):.2f}, "
                     f"max {walls.max():.2f}, over 1.05x the median "
                     f"{int((walls > 1.05 * np.median(walls)).sum())}")
        self.attempted = calls * t["call_queries"]
        return {"queries_per_s": self.attempted / elapsed}

    def release(self):
        import torch

        self.index.close()
        del self.index
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def _checked(self):
        """The checked tiles: ``(queries, dist, idx)`` host arrays, each
        ``check_tiles`` whole tiles of ``rerank_tile`` rows drawn from the
        seed among the kept calls."""
        tile, t = self.ctx.config["rerank_tile"], self.ctx.traffic
        per_call = t["call_queries"] // tile
        tiles = [(k, r) for k in range(len(self.kept))
                 for r in range(per_call)]
        rng = np.random.default_rng([self.ctx.seed, 3])
        pick = sorted(rng.choice(len(tiles), min(len(tiles),
                                                 t["check_tiles"]),
                                 replace=False))
        out = []
        for p in pick:
            k, r = tiles[p]
            ci, d, i = self.kept[k]
            rows = slice(r * tile, (r + 1) * tile)
            out.append((self._call(ci)[rows], d[rows], i[rows]))
        return out

    def check(self, control=None):
        """``control`` (one of ``CONTROLS``, or True for ``'ties'``) puts
        that answer in the program's place."""
        import torch

        control = "ties" if control is True else control
        c = self.ctx.config
        checked = self._checked()
        codes = make_codes(self.ctx)
        tiles = [torch.from_numpy(q).to(codes.device) for q, _d, _i in checked]
        lsh = functools.partial(
            lsh_topk.topk, bands=c["bands"], band_bits=c["band_bits"],
            probes=c["probes"], fallback_density=c["fallback_density"])
        ref, _ = lsh(tiles, codes, c["m"], exact=hamming_topk.topk)
        queries = torch.cat(tiles)
        true_d, true_i = hamming_topk.topk(queries, codes, c["m"])
        got = [(d, i) for _q, d, i in checked]
        if control == "ties":
            got, _ = lsh(tiles, codes, c["m"], exact=functools.partial(
                hamming_topk.topk, ties="higher"))
        elif control == "exact":
            got = list(zip(true_d.split(c["rerank_tile"]),
                           true_i.split(c["rerank_tile"])))
        elif control == "band":
            got, _ = lsh(tiles, codes, c["m"], exact=hamming_topk.topk,
                         bands=c["bands"] - 1)
        elif control is not None:
            raise ValueError(f"control must be one of {CONTROLS}")
        del codes
        bad = sum(hamming_topk.mismatches(d, i, rd, ri)
                  for (d, i), (rd, ri) in zip(got, ref))
        got_i = np.concatenate([np.asarray(torch.as_tensor(i).cpu())
                                for _d, i in got])
        true_i = true_i.cpu().numpy()
        hits = sum(np.intersect1d(g, w).size for g, w in zip(got_i, true_i))
        return [("lsh_mismatches", bad, LIMITS["lsh_mismatches"]),
                ("lsh_fallback_tiles", self.fallback_tiles,
                 LIMITS["lsh_fallback_tiles"]),
                ("recall_miss", 1.0 - hits / true_i.size,
                 LIMITS["recall_miss"])]

    def close(self):
        index = self.__dict__.pop("index", None)
        if index is not None:
            index.close()
        for name in ("pool", "kept"):
            self.__dict__.pop(name, None)
