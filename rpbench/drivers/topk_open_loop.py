"""Independent users of an online top-m service: open-loop arrivals of
small requests through ``TopKServer``.

Set-up makes the configuration's codes and index (as ``topk_bulk``), the
server with the traffic's ``max_batch`` and ``max_delay_s``, the
schedule and one planted query row for every row it asks for, then warms
every batch size the coalescing can make (``query_topk`` at each row
bucket up to ``warm_rows_max``) and the server's own path.

The schedule is the copied ``build_schedule`` at the traffic's rate,
arrival process, request sizes and labels, built from the traffic's own
``schedule_seed`` for the window's length, then put in another order by
the run's seed (``schedule.reorder``): every run offers the same work.
One thread submits each request at its due time whether or not earlier
ones have finished.  A request's latency runs from its due time to the
completion of its future, so a late submitter counts against it.
``p99_latency_ms`` is the 99th percentile over every request of the
schedule; a rejected or failed request counts as failed and as the
longest latency of the run.

The harness holds no object a request during the window, so the
collector's pauses are the program's: the schedule is kept as flat
lists and arrays (due times, labels, row offsets), not as its
``ScheduledRequest`` tuples, which would add a tracked object a request
to every full collection.

The check: requests drawn from the seed before the window, ``check_rows``
query rows at least, their (dist, id) lists against the exact
reference (only their futures are kept); and every request answered (``unanswered``: those rejected, failed or not done a
minute past the window's close).
"""

from __future__ import annotations

import threading
import time

import numpy as np

from rpbench import schedule as sched
from rpbench import trace as tr
from rpbench.drivers.topk_bulk import (
    LIMIT,
    exact_mismatches,
    make_codes,
    make_index,
    make_queries,
)

E2E = {"p99_latency_ms": "ms"}

DRAIN_S = 60.0  # how long past the window's close the answers are awaited


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.attempted = 0
        self.failed = 0

    def setup(self):
        from randomprojection_tpu_torch.models.sketch import TopKServer
        from randomprojection_tpu_torch.parallel.sharded import row_bucket

        c, t = self.ctx.config, self.ctx.traffic
        t0 = time.perf_counter()
        self.codes = make_codes(self.ctx)
        self.index = make_index(self.ctx, self.codes)
        self.plan(t["rate_rps"], self.ctx.seconds)
        t1 = time.perf_counter()
        buckets = sorted({row_bucket(n) for n in range(
            1, min(t["warm_rows_max"], t["max_batch"]) + 1)})
        for b in buckets:
            self.index.query_topk(np.resize(self.rows, (b, self.rows.shape[1])),
                                  c["m"], tile=b)
        self.server = TopKServer(self.index, c["m"], max_batch=t["max_batch"],
                                 max_delay_s=t["max_delay_s"],
                                 name="rpbench")
        self.server.query(self.rows[:1])
        self.ctx.log(f"codes, index and schedule {t1 - t0:.3f} s, "
                     f"{len(buckets)} warm batch sizes and the server "
                     f"{time.perf_counter() - t1:.3f} s")

    def plan(self, rate: float, seconds: float) -> None:
        """The schedule at ``rate`` requests/s for ``seconds`` in this run's
        order, and a planted query row for each row it asks for."""
        t = self.ctx.traffic
        base = sched.build_schedule(
            seed=t["schedule_seed"], duration_s=seconds, rate_qps=rate,
            arrival=t["arrival"], request_rows=t["request_rows"],
            labels=t["labels"],
            **{k: t[k] for k in ("burst_factor", "burst_fraction",
                                 "burst_period_s") if k in t})
        order = sched.reorder(base, self.ctx.seed)
        del base
        self.due = np.array([r.t for r in order])
        self.labels = [r.label for r in order]
        self.offsets = np.cumsum([0] + [r.rows for r in order])
        del order
        self.rows = make_queries(self.ctx, self.codes,
                                 max(int(self.offsets[-1]), 1))
        # the requests the check reads, drawn from the seed before the
        # window: only their futures are kept
        rng = np.random.default_rng([self.ctx.seed, 3])
        self.sample, rows = [], 0
        for i in rng.permutation(len(self.due)):
            if rows >= t["check_rows"]:
                break
            self.sample.append(int(i))
            rows += int(self.offsets[i + 1] - self.offsets[i])
        self.sample.sort()

    def window(self, seconds):
        n = len(self.due)
        done_at = np.full(n, np.nan)
        failed = np.zeros(n, dtype=bool)
        keep = set(self.sample)
        self.futures = {}
        lock = threading.Lock()
        left = [n]
        all_done = threading.Event()

        def finished(i):
            def cb(fut):
                done_at[i] = time.perf_counter()
                if fut.exception() is not None:
                    failed[i] = True
                with lock:
                    left[0] -= 1
                    if left[0] == 0:
                        all_done.set()
            return cb

        s0 = self.server.stats()
        lag = 0.0
        t0 = time.perf_counter()
        for i, (due_t, label) in enumerate(zip(self.due.tolist(),
                                               self.labels)):
            delay = t0 + due_t - time.perf_counter()
            if delay > 0:
                with tr.span("await_arrival"):
                    time.sleep(delay)
            else:
                lag = max(lag, -delay)
            codes = self.rows[self.offsets[i]:self.offsets[i + 1]]
            try:
                with tr.span("submit"):
                    fut = self.server.submit(codes, label=label)
            except RuntimeError:
                failed[i] = True
                done_at[i] = time.perf_counter()
                with lock:
                    left[0] -= 1
                continue
            if i in keep:
                self.futures[i] = fut
            fut.add_done_callback(finished(i))
        with lock:
            if left[0] == 0:
                all_done.set()
        close = t0 + seconds
        with tr.span("drain"):
            all_done.wait(timeout=max(close + DRAIN_S - time.perf_counter(),
                                      0.0))
        s1 = self.server.stats()
        due = t0 + self.due
        lat = done_at - due
        failed |= np.isnan(lat)
        worst = np.nanmax(lat) if (~np.isnan(lat)).any() else 0.0
        lat[failed] = max(worst, time.perf_counter() - t0)
        self.failed_mask = failed
        self.attempted = n
        self.failed = int(failed.sum())
        batches = s1["batches"] - s0["batches"]
        self.ctx.layer["serve_rows_per_batch"] = (
            (s1["queries"] - s0["queries"]) / batches if batches else None)
        self.ctx.layer["submit_lag_s"] = lag
        self.ctx.layer["p50_latency_ms"] = (
            float(np.percentile(lat, 50)) * 1e3 if n else None)
        self.ctx.log(f"{n} requests, {self.failed} failed, {batches} "
                     f"batches, submitter lag {lag:.4f} s")
        return {"p99_latency_ms": float(np.percentile(lat, 99)) * 1e3
                if n else 0.0}

    def release(self):
        import torch

        self.server.close()
        self.index.close()
        del self.server, self.index, self.codes
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False):
        sel = [i for i in self.sample if not self.failed_mask[i]]
        unanswered = ("unanswered", int(self.failed_mask.sum()), 0)
        if not sel:
            return [("topk_mismatches", 0, LIMIT), unanswered]
        queries = np.concatenate([self.rows[self.offsets[i]:self.offsets[i + 1]]
                                  for i in sel])
        res = [self.futures[i].result() for i in sel]
        dist = np.concatenate([d for d, _i in res])
        idx = np.concatenate([i for _d, i in res])
        bad = exact_mismatches(self.ctx, queries, dist, idx, control)
        return [("topk_mismatches", bad, LIMIT), unanswered]

    def close(self):
        server = self.__dict__.pop("server", None)
        if server is not None:
            server.close()
        index = self.__dict__.pop("index", None)
        if index is not None:
            index.close()
        for name in ("futures", "rows", "codes"):
            self.__dict__.pop(name, None)
