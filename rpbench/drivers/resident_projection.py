"""Rows already on the card, projected by one fitted model.

Set-up makes ``traffic["rows"]`` float32 rows on the device from the seed
and fits ``SparseRandomProjection`` as the configuration states (lazy
matrix, its seed drawn from the run's seed).  The window runs passes over
all rows, ``est.transform`` a batch of ``traffic["batch_rows"]`` at a
time, each pass's outputs dropped before the next; the host stays at most
one pass ahead of the card.  ``rows_per_s`` is every row of every pass
over the window's whole time, ending when the card has finished.

The check: a reservoir sample, drawn from the seed, of ``keep_batches``
batch outputs of the window (each copied aside on the card as it is
produced) against the float64 reference of the same rows.
"""

from __future__ import annotations

import random
import time

from rpbench import data
from rpbench import trace as tr
from rpbench.reference import project

E2E = {"rows_per_s": "rows/s"}

# largest gap between a batch's output and the float64 answer, over its
# largest magnitude (PERF.md: readings of the program and of the TF32
# control that this limit was set between)
LIMIT = 6e-5


def model_seed(seed: int) -> int:
    """The model's ``random_state``, drawn from the run's seed."""
    return data.derive(seed, 7) % (2**31 - 1)


def fit_model(cfg: dict, n_rows: int, seed: int, device):
    import numpy as np

    import randomprojection_tpu_torch as rpt

    opts = {"materialization": cfg["materialization"]}
    if cfg.get("precision"):
        opts["precision"] = cfg["precision"]
    if device.type == "cpu":
        opts["device"] = "cpu"
    return rpt.SparseRandomProjection(
        cfg["n_components"], density=cfg["density"],
        random_state=model_seed(seed), backend_options=opts,
    ).fit_schema(n_rows, cfg["n_features"], dtype=np.dtype(cfg["dtype"]))


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.attempted = 0
        self.failed = 0

    def _rows(self):
        c, t = self.ctx.config, self.ctx.traffic
        return data.normal_rows(t["rows"], c["n_features"],
                                data.generator(self.ctx.seed, self.ctx.device),
                                device=self.ctx.device)

    def setup(self):
        import torch

        c, t = self.ctx.config, self.ctx.traffic
        dev = self.ctx.device
        t0 = time.perf_counter()
        self.x = self._rows()
        self.est = fit_model(c, t["rows"], self.ctx.seed, dev)
        b = t["batch_rows"]
        self.bounds = [(lo, min(lo + b, t["rows"]))
                       for lo in range(0, t["rows"], b)]
        k = t["keep_batches"]
        self.keep = torch.empty((k, b, c["n_components"]),
                                dtype=torch.float32, device=dev)
        self.kept = [None] * k  # batch index a slot holds
        # two warm passes: the kernels built and loaded, the allocator's
        # blocks for a pass's outputs and the next pass's in place
        for _ in range(2):
            ys = [self.est.transform(self.x[lo:hi]) for lo, hi in self.bounds]
        del ys
        self.ctx.log(f"rows, model and warm passes issued in "
                     f"{time.perf_counter() - t0:.3f} s")

    def window(self, seconds):
        import torch

        rng = random.Random(self.ctx.seed)
        k = len(self.kept)
        seen = 0
        issue = []
        trace = self.ctx.trace
        on_card = self.ctx.device.type == "cuda"
        prev = None
        passes = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for bi, (lo, hi) in enumerate(self.bounds):
                with tr.span("transform"):
                    t_a = time.perf_counter()
                    y = self.est.transform(self.x[lo:hi])
                    if trace:
                        issue.append(time.perf_counter() - t_a)
                slot = data.reservoir_slot(rng, seen, k)
                if slot is not None:
                    self.keep[slot, : hi - lo].copy_(y)
                    self.kept[slot] = bi
                seen += 1
                del y
            passes += 1
            if on_card:
                # the host stays at most one pass ahead of the card
                ev = torch.cuda.Event()
                ev.record()
                if prev is not None:
                    with tr.span("wait_card"):
                        prev.synchronize()
                prev = ev
        if prev is not None:
            prev.synchronize()
        elapsed = time.perf_counter() - t0
        rows = passes * self.bounds[-1][1]
        self.attempted = passes * len(self.bounds)
        c = self.ctx.config
        self.ctx.layer.update(issue_s=issue, k1_rows={
            "rows": rows, "d": c["n_features"], "k": c["n_components"],
            "density": c["density"]})
        return {"rows_per_s": rows / elapsed}

    def release(self):
        import torch

        del self.est, self.x
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False):
        """The kept outputs against the float64 reference; with
        ``control`` the TF32 product of the same rows stands in for them."""
        c = self.ctx.config
        seed = model_seed(self.ctx.seed)
        x = self._rows()  # the inputs again, from the seed
        worst = 0.0
        for slot, bi in enumerate(self.kept):
            if bi is None:
                continue
            lo, hi = self.bounds[bi]
            ref = project.reference(x[lo:hi], seed, c["n_components"],
                                    c["density"])
            y = (project.control(x[lo:hi], seed, c["n_components"],
                                 c["density"]) if control
                 else self.keep[slot, : hi - lo])
            worst = max(worst, project.gap(y, ref))
        del x
        return [("max_rel_gap", worst, LIMIT)]

    def close(self):
        self.__dict__.pop("keep", None)
        self.__dict__.pop("est", None)
        self.__dict__.pop("x", None)
