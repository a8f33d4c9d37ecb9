"""Rows in host memory, through the port's streaming pipeline, projected
rows back in host memory.

Set-up makes a pool of ``traffic["pool_batches"]`` distinct float32
batches of ``batch_rows`` rows on the card from the seed and copies them
into pageable host memory; the reader hands out a view of one of them, so
the pipeline, not a generator, is measured.  A job streams
``traffic["job_rows"]`` rows, batch ``i`` reading pool batch ``i mod
pool_batches``, through ``est.transform_stream(StagedIngestSource(
CallableSource(read), workers, depth, prepare=est.prepare_batch))``.  The
window runs jobs back to back and ends at the last batch whose
projections reached the host once ``seconds`` have passed;
``streamed_rows_per_s`` is every row received over that time.

The check: a reservoir sample, drawn from the seed, of ``keep_batches``
received batches against the float64 reference of their pool batch, so
a batch out of order reads as wrong.
"""

from __future__ import annotations

import random
import time

from rpbench import data
from rpbench import trace as tr
from rpbench.drivers.resident_projection import LIMIT, fit_model, model_seed
from rpbench.reference import project

E2E = {"streamed_rows_per_s": "rows/s"}


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.attempted = 0
        self.failed = 0

    def setup(self):
        import numpy as np

        c, t = self.ctx.config, self.ctx.traffic
        dev = self.ctx.device
        b = t["batch_rows"]
        t0 = time.perf_counter()
        x = data.normal_rows(t["pool_batches"] * b, c["n_features"],
                             data.generator(self.ctx.seed, dev), device=dev)
        host = x.cpu().numpy()
        del x
        self.pool = [host[i * b:(i + 1) * b] for i in range(t["pool_batches"])]
        self.est = fit_model(c, t["job_rows"], self.ctx.seed, dev)
        t1 = time.perf_counter()
        # one whole job: the kernels loaded, the pinned staging and output
        # blocks in torch's host cache, the threads' first start
        for _lo, y in self.est.transform_stream(self._source(None)):
            np.asarray(y)
        self.ctx.log(f"pool and model {t1 - t0:.3f} s, warm job "
                     f"{time.perf_counter() - t1:.3f} s")

    def _read(self, lo, hi):
        b = self.ctx.traffic["batch_rows"]
        return self.pool[(lo // b) % len(self.pool)][: hi - lo]

    def _source(self, stats):
        from randomprojection_tpu_torch import streaming

        c, t = self.ctx.config, self.ctx.traffic
        src = streaming.CallableSource(
            self._read, t["job_rows"], c["n_features"], dtype=c["dtype"],
            batch_rows=t["batch_rows"], stats=stats)
        return streaming.StagedIngestSource(
            src, workers=t["workers"], depth=t["depth"],
            prepare=self.est.prepare_batch, stats=stats)

    def window(self, seconds):
        from randomprojection_tpu_torch.utils.observability import StreamStats

        rng = random.Random(self.ctx.seed)
        k = self.ctx.traffic["keep_batches"]
        self.kept = []  # (lo, y)
        stats = StreamStats() if self.ctx.trace else None
        rows = seen = 0
        t0 = t_last = time.perf_counter()
        while t_last - t0 < seconds:
            with tr.span("job"):
                stream = self.est.transform_stream(self._source(stats),
                                                   stats=stats)
                try:
                    for lo, y in stream:
                        t_last = time.perf_counter()
                        rows += y.shape[0]
                        data.keep(self.kept, data.reservoir_slot(rng, seen, k),
                                  (lo, y))
                        seen += 1
                        if t_last - t0 >= seconds:
                            break
                finally:
                    stream.close()
        self.attempted = seen
        if stats is not None:
            self.ctx.layer["stream_stats"] = stats
            self.ctx.layer["stream_bytes"] = rows * self.ctx.config[
                "n_features"] * 4
            self.ctx.layer["stream_wall_s"] = t_last - t0
        return {"streamed_rows_per_s": rows / (t_last - t0)}

    def release(self):
        import torch

        del self.est
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False):
        """The kept batches against the float64 reference of their pool
        batch; with ``control`` the TF32 product stands in for them."""
        import torch

        c = self.ctx.config
        seed = model_seed(self.ctx.seed)
        worst = 0.0
        for lo, y in self.kept:
            x = torch.from_numpy(self._read(lo, lo + y.shape[0])).to(
                self.ctx.device)
            ref = project.reference(x, seed, c["n_components"], c["density"])
            y = (project.control(x, seed, c["n_components"], c["density"])
                 if control else torch.from_numpy(y).to(self.ctx.device))
            worst = max(worst, project.gap(y, ref))
        return [("max_rel_gap", worst, LIMIT)]

    def close(self):
        for name in ("est", "pool", "kept"):
            self.__dict__.pop(name, None)
