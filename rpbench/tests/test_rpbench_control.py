"""The comparison that decides ``correct`` fails where it must, at toy
sizes on the CPU: each control (the reference in a lower precision, or
with a broken guarantee, in the program's place) reads over its limit,
and a run whose timed path is broken underneath (an answer altered where
it is produced) comes out not correct."""

from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from rpbench import data, harness  # noqa: E402
from rpbench.drivers import resident_projection  # noqa: E402
from rpbench.reference import hamming_topk, lazy_mask, project  # noqa: E402
from rpbench.tests.test_rpbench_harness import TOY  # noqa: E402

CPU = torch.device("cpu")
SEEDS = (3, 2**31 + 11, 987654321)


def _drive(cell, seed, *, control=False):
    ctx = harness.Context(cell, seed, CPU, False, TOY[cell])
    ctx.seconds = 0.2
    mod = __import__(f"rpbench.drivers.{ctx.workload['driver']}",
                     fromlist=["Driver"])
    drv = mod.Driver(ctx)
    try:
        drv.setup()
        drv.window(ctx.seconds)
        drv.release()
        return drv.check(control=control)
    finally:
        drv.close()


@pytest.mark.parametrize("cell", sorted(TOY))
@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_fails_and_the_program_passes(cell, seed):
    for name, value, limit in _drive(cell, seed):
        assert value <= limit, (name, value, limit)
    control = _drive(cell, seed, control=True)
    assert any(value > limit for _n, value, limit in control), control


def test_the_lazy_mask_is_the_programs_matrix():
    from randomprojection_tpu_torch.ops import fused_kernels as fk

    for seed in SEEDS:
        want = fk.lazy_matrix_plain(seed, 64, 1100, 1 / 3).double()
        got = lazy_mask.matrix(seed, 64, 1100, 1 / 3)
        assert torch.allclose(got, want, rtol=1e-7, atol=0)


def test_the_tf32_control_reads_a_thousand_times_the_program():
    x = data.normal_rows(512, 1024, data.generator(1, "cpu"), device="cpu")
    ref = project.reference(x, 5, 64, 1 / 3)
    prog = x @ lazy_mask.matrix(5, 64, 1024, 1 / 3, dtype=torch.float32).T
    assert project.gap(prog, ref) < 1e-5 < project.gap(
        project.control(x, 5, 64, 1 / 3), ref)


def test_the_exact_topk_is_a_brute_force_with_ties_to_the_lower_id():
    g = data.generator(4, "cpu")
    codes = data.planted_codes(3000, 8, 16, 3, g, device="cpu")
    queries = data.planted_queries(codes, 40, 2, g)
    # brute force: popcount of the xor, then a stable sort by distance
    x = (queries[:, None, :] ^ codes[None, :, :]).numpy()
    import numpy as np

    dist = np.unpackbits(x, axis=2).sum(2)
    order = np.argsort(dist, axis=1, kind="stable")[:, :10]
    d, i = hamming_topk.topk(queries, codes, 10, block_rows=1000,
                             query_rows=16)
    assert (i.numpy() == order).all()
    assert (d.numpy() == np.take_along_axis(dist, order, 1)).all()
    hd, hi = hamming_topk.topk(queries, codes, 10, ties="higher",
                               block_rows=512)
    assert (hd == d).all() and (hi != i).any()


def _alter_first(t):
    t = t.clone()
    t.view(-1)[0] += 1
    return t


@pytest.mark.parametrize("cell", ["config2_resident", "config2_streamed"])
def test_an_altered_projection_is_not_correct(cell, monkeypatch):
    from randomprojection_tpu_torch.ops import fused_kernels as fk

    real = fk.fused_sparse_project
    monkeypatch.setattr(fk, "fused_sparse_project",
                        lambda *a, **k: _alter_first(real(*a, **k)))
    out = harness.run_cell(cell, 9, 0.3, False, t_start=time.perf_counter(),
                           device=CPU, overrides=TOY[cell])
    assert out["correct"] is False
    assert out["checks"]["max_rel_gap"]["value"] > \
        resident_projection.LIMIT


@pytest.mark.parametrize("cell", ["config4_bulk", "config4_open_loop"])
def test_an_altered_answer_is_not_correct(cell, monkeypatch):
    from randomprojection_tpu_torch.ops import topk_kernels as tk

    real = tk.fused_topk

    def swapped(*a, **k):
        d, i = real(*a, **k)
        i = i.clone()
        i[:, [0, 1]] = i[:, [1, 0]]
        return d, i

    monkeypatch.setattr(tk, "fused_topk", swapped)
    out = harness.run_cell(cell, 9, 0.3, False, t_start=time.perf_counter(),
                           device=CPU, overrides=TOY[cell])
    assert out["correct"] is False
    assert out["checks"]["topk_mismatches"]["value"] > 0
