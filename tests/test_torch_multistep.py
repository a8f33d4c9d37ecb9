"""The port's multistep dispatch chain, its backend knob and its telemetry,
and the mask writer's launch geometry, on the CPU.

The chain (``fused_project_multistep``) is held bit for bit to the port's
own ``fused_sparse_project`` on the contiguous ``ceil(n/steps)`` row split,
and to the reference's ``fused_project_multistep(..., interpret=True)``
within max|Δ| ≤ 1e-5·max|Y| (the single call's tolerance: sums in another
order).  The mask writer's kernel runs only on a card
(tests/test_torch_cuda.py); here its plan (``plan_mask_writer``) is shown
to cover every entry exactly once, and a numpy emulation of the kernel's
arithmetic on that plan (the row and block terms once a row, the column
term stepped by the constant) gives the plain versions' bits.  The shapes
are ``tests/test_pallas_dma.py``'s.
"""

import logging

import jax.numpy as jnp

import numpy as np
import pytest
import torch

from randomprojection_tpu.ops import pallas_kernels as pk
from randomprojection_tpu_torch.backends import base as port_base
from randomprojection_tpu_torch.backends.torch_backend import TorchBackend
from randomprojection_tpu_torch.ops import fused_kernels as fk

CPU = {"device": "cpu"}
N, D, K, DENSITY, SEED = 70, 700, 16, 0.25, 13


def _x(n, d, seed=1):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _split(x, steps):
    per = -(-x.shape[0] // steps)
    return [x[lo:lo + per] for lo in range(0, x.shape[0], per)]


# -- the chain -----------------------------------------------------------------


@pytest.mark.parametrize("mode", ["f32", "split2", "bf16"])
@pytest.mark.parametrize("steps", [2, 3, 7])
def test_multistep_equals_the_split(steps, mode):
    """Bit for bit the port's single calls on the contiguous split, ragged
    last block included (70 rows: 35+35, 24+24+22, 10 × 7)."""
    x = torch.from_numpy(_x(N, D))
    got = fk.fused_project_multistep(x, SEED, K, DENSITY, steps=steps,
                                     mxu_mode=mode)
    want = torch.cat([fk.fused_sparse_project(b, SEED, K, DENSITY,
                                              mxu_mode=mode)
                      for b in _split(x, steps)])
    assert got.dtype == torch.float32 and got.shape == (N, K)
    assert torch.equal(got, want)


@pytest.mark.parametrize("steps", [2, 3, 7])
def test_multistep_matches_the_reference(steps):
    x = _x(N, D)
    want = np.asarray(pk.fused_project_multistep(
        jnp.asarray(x), SEED, K, DENSITY, steps=steps, interpret=True))
    got = fk.fused_project_multistep(torch.from_numpy(x), SEED, K, DENSITY,
                                     steps=steps).numpy()
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err


def test_multistep_clamps_and_degenerates():
    """steps > n clamps to the row count (one row a block); steps = 1 is
    exactly the plain call; donate changes no value."""
    x = torch.from_numpy(_x(5, 600, seed=2))
    plain = fk.fused_sparse_project(x, 1, 8, 0.5)
    assert torch.equal(fk.fused_project_multistep(x, 1, 8, 0.5, steps=1), plain)
    per_row = torch.cat([fk.fused_sparse_project(x[i:i + 1], 1, 8, 0.5)
                         for i in range(5)])
    assert torch.equal(fk.fused_project_multistep(x, 1, 8, 0.5, steps=99),
                       per_row)
    assert torch.equal(
        fk.fused_project_multistep(x, 1, 8, 0.5, steps=2, donate=True),
        fk.fused_project_multistep(x, 1, 8, 0.5, steps=2))
    empty = fk.fused_project_multistep(x[:0], 1, 8, 0.5, steps=4)
    assert empty.shape == (0, 8)
    with pytest.raises(ValueError, match="multiple of 8"):
        fk.fused_project_multistep(x, 1, 12, 0.5, steps=2)


def test_multistep_counts_no_launch_on_the_cpu():
    fk.reset_launches()
    fk.fused_project_multistep(torch.from_numpy(_x(9, 520)), 0, 8, 0.5,
                               steps=3)
    assert set(fk.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("n,steps,want", [(10, 7, 5), (4, 8, 4), (1, 5, 1),
                                          (70, 3, 3), (70, 7, 7), (0, 3, 1)])
def test_chain_length_pins(n, steps, want):
    assert fk.multistep_chain_length(n, steps) == want


def test_chain_length_equals_the_reference_over_a_grid():
    for n in range(0, 41):
        for steps in range(0, 45):
            assert fk.multistep_chain_length(n, steps) == \
                pk.multistep_chain_length(n, steps), (n, steps)


def test_chain_length_is_the_split_count():
    for n in range(1, 60):
        for steps in range(1, 70):
            blocks = _split(np.zeros(n), max(1, min(steps, n)))
            assert fk.multistep_chain_length(n, steps) == len(blocks)


# -- the backend knob ------------------------------------------------------------


def _lazy(steps, **extra):
    import randomprojection_tpu_torch as rpt

    return rpt.SparseRandomProjection(
        K, density=1 / 3, random_state=4,
        backend_options=CPU | {"materialization": "lazy",
                               "dispatch_steps": steps} | extra)


@pytest.mark.parametrize("steps", [2, 3, 16, 99])
@pytest.mark.parametrize("precision", [None, "default"])
def test_backend_chain_equals_one_step(steps, precision):
    """K row blocks against one call.  On the CPU the plain product's bits
    may depend on a batch's row count (the BLAS picks its blocking by
    shape: 1 of 1120 entries 1 ulp apart at K = 16), so the two agree
    within the single call's tolerance, and the chain equals the port's
    calls on its split bit for bit.  On a card the kernel is
    row-independent and the chain equals K = 1 bit for bit
    (tests/test_torch_cuda.py)."""
    extra = {} if precision is None else {"precision": precision}
    X = _x(N, D, seed=3)
    one = _lazy(1, **extra).fit(X)
    chained = _lazy(steps, **extra).fit(X)
    assert chained._backend.dispatch_steps == steps
    want = one.transform(X)
    got = chained.transform(X)
    assert got.dtype == want.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    xt = torch.from_numpy(X)
    mode = chained._backend._lazy_mxu_mode()
    blocks = _split(xt, min(steps, N))
    assert torch.equal(chained.transform(xt), torch.cat([
        fk.fused_sparse_project(b, chained.spec_.seed, K,
                                chained.spec_.density, mxu_mode=mode)
        for b in blocks]))
    # a one-row batch is a plain call
    np.testing.assert_array_equal(chained.transform(X[:1]), one.transform(X[:1]))


def test_backend_chain_matches_the_reference():
    """The port's chained transform against the reference's chain on the
    same lazy matrix (the interpreter's hash stream)."""
    X = _x(N, D, seed=4)
    est = _lazy(3).fit(X)
    spec = est.spec_
    want = np.asarray(pk.fused_project_multistep(
        jnp.asarray(X), spec.seed, K, spec.density, steps=3,
        mxu_mode="split2", interpret=True))
    got = est.transform(X)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("bad", [0, -1])
def test_dispatch_steps_below_one_raises(bad):
    with pytest.raises(ValueError, match="dispatch_steps must be >= 1"):
        port_base.resolve_backend("torch", **CPU, dispatch_steps=bad)


def test_transform_dma_value_check():
    with pytest.raises(ValueError, match="transform_dma must be None"):
        port_base.resolve_backend("torch", **CPU, transform_dma="yes")


@pytest.mark.parametrize("opt", [{"dispatch_steps": 4},
                                 {"transform_dma": False}])
def test_knobs_warn_off_the_lazy_route(caplog, opt):
    with caplog.at_level(logging.WARNING, logger="randomprojection_tpu_torch"):
        b = TorchBackend(device="cpu", **opt)
    assert "affect only the fused lazy" in caplog.text
    assert b.materialization == "dense"


@pytest.mark.parametrize("dma", [True, False])
def test_transform_dma_is_accepted_and_ignored_on_the_lazy_route(caplog, dma):
    with caplog.at_level(logging.WARNING, logger="randomprojection_tpu_torch"):
        b = TorchBackend(device="cpu", materialization="lazy",
                         transform_dma=dma)
    assert "no counterpart" in caplog.text and b.transform_dma is dma
    X = _x(20, 600, seed=5)
    np.testing.assert_array_equal(
        _lazy(1, transform_dma=dma).fit(X).transform(X),
        _lazy(1).fit(X).transform(X))


def test_lazy_chain_warns_nothing(caplog):
    with caplog.at_level(logging.WARNING, logger="randomprojection_tpu_torch"):
        TorchBackend(device="cpu", materialization="lazy", dispatch_steps=8)
    assert caplog.text == ""


# -- telemetry -------------------------------------------------------------------


def test_dispatch_events_parse_with_the_reference_reader(tmp_path):
    from randomprojection_tpu.utils.telemetry import read_events
    from randomprojection_tpu_torch.utils import telemetry

    p = str(tmp_path / "chain.jsonl")
    before = telemetry.registry().counter("backend.dispatches")
    telemetry.configure(p)
    try:
        x = torch.from_numpy(_x(10, 520, seed=12))
        fk.fused_sparse_project(x, 0, 8, 0.5)
        fk.fused_project_multistep(x, 0, 8, 0.5, steps=7)
        est = _lazy(7).fit(_x(10, D))
        est.transform(_x(10, D, seed=6))
        est.transform(_x(1, D, seed=7))
    finally:
        telemetry.shutdown()
    events = list(read_events(p))
    kernel = [e for e in events if e["event"] == "kernel.dma.dispatch"]
    # the single call, the chain of 5 (n=10, steps=7), the backend's chain
    # and its one-row plain call
    assert [e["steps"] for e in kernel] == [1, 5, 5, 1]
    assert {e["path"] for e in kernel} == {"plain"}
    assert kernel[0]["rows"] == 10 and kernel[0]["d"] == 520
    assert kernel[0]["n_components"] == 8 and kernel[0]["mxu_mode"] == "f32"
    assert kernel[2]["mxu_mode"] == "split2" and kernel[2]["d"] == D
    fused = [e for e in events if e["event"] == "backend.dispatch_fused"]
    assert len(fused) == 1
    assert fused[0]["steps"] == 5 and fused[0]["rows"] == 10
    assert fused[0]["n_components"] == K and fused[0]["donated"] is False
    disp = [e for e in events if e["event"] == "backend.dispatch"]
    assert [e["rows"] for e in disp] == [10, 1]
    assert disp[0]["kind"] == "sparse" and disp[0]["n_features"] == D
    assert disp[0]["device_resident"] is False
    assert telemetry.registry().counter("backend.dispatches") == before + 2


def test_dispatch_counter_counts_without_a_sink():
    from randomprojection_tpu_torch.utils import telemetry

    est = _lazy(1).fit(_x(4, 600))
    before = telemetry.registry().counter("backend.dispatches")
    est.transform(_x(4, 600))
    est.transform(torch.from_numpy(_x(4, 600)))
    assert telemetry.registry().counter("backend.dispatches") == before + 2


# -- the mask writer's geometry ----------------------------------------------------


WRITER_SHAPES = [(8, 1), (8, 3), (512, 4097), (512, 4099), (512, 4100),
                 (256, 4096), (24, 700), (16, 64), (600_000, 3),
                 (70_000, 1), (8, 1030)]


def _visits(plan, k):
    """How often the plan's threads visit each row and each column."""
    stride = plan.grid_y * plan.block_y
    r0 = np.arange(stride)
    r = (r0[:, None] + stride * np.arange(-(-k // stride))[None, :]).ravel()
    rows = np.bincount(r[r < k], minlength=k)
    c0 = np.arange(plan.grid_x * plan.block_x) * plan.vec
    c0 = c0[c0 < plan.cols]
    c = (c0[:, None] + np.arange(plan.vec)[None, :]).ravel()
    cols = np.bincount(c[c < plan.cols], minlength=plan.cols)
    return rows, cols, c0


@pytest.mark.parametrize("item", [4, 2])
@pytest.mark.parametrize("k,d", WRITER_SHAPES)
def test_writer_plan_covers_every_entry_once(k, d, item):
    plan = fk.plan_mask_writer(k, d, item)
    assert plan.cols == (d if item == 4 else -(-d // 64) * 64)
    assert plan.vec * item == 16
    assert plan.block_x * plan.block_y <= fk.WRITER_THREADS
    assert plan.block_x % 32 == 0 and plan.grid_y <= fk.MAX_GRID_Y
    rows, cols, c0 = _visits(plan, k)
    assert rows.shape == (k,) and (rows == 1).all()
    assert cols.shape == (plan.cols,) and (cols == 1).all()
    # a thread's run lies in one 512-column block
    assert (c0 // fk.BLOCK_D == (c0 + plan.vec - 1) // fk.BLOCK_D).all()
    # 16-byte stores only on 16-byte rows
    if plan.store == plan.vec:
        assert plan.cols * item % 16 == 0
    else:
        assert item == 4 and plan.store == (2 if d % 2 == 0 else 1)


def test_writer_plan_loops_rows_past_the_grid():
    plan = fk.plan_mask_writer(600_000, 3, 4)
    assert plan.grid_y == fk.MAX_GRID_Y
    assert plan.grid_y * plan.block_y < 600_000


@pytest.mark.parametrize("bad", [(0, 8, 4), (8, 0, 4), (8, 8, 3)])
def test_writer_plan_refuses(bad):
    with pytest.raises(ValueError):
        fk.plan_mask_writer(*bad)


_U32 = np.uint32


def _writer_emulation(plan, seed, k, d, density, offset, scale):
    """The kernel's arithmetic on the plan's runs, in numpy uint32: the row
    and block terms once a row, the column term of the run's first column
    stepped by adding the constant."""
    lim_plus, lim_nonzero = fk.mask_limits(density)
    seed_mix = _U32((int(seed) & 0xFFFFFFFF) * 0xC2B2AE3D & 0xFFFFFFFF)
    c = np.arange(plan.cols)
    c0, i = (c // plan.vec) * plan.vec, c % plan.vec
    blk = (c0 >> 9).astype(_U32) + _U32(offset)
    col = (c0 & 511).astype(_U32) * _U32(0x85EBCA77) + i.astype(_U32) * _U32(0x85EBCA77)
    r = np.arange(k, dtype=_U32)[:, None]
    rb = (r * _U32(0x9E3779B1)) ^ seed_mix ^ (blk * _U32(0x27D4EB2F))[None, :]
    h = rb ^ col[None, :]
    h = (h ^ (h >> _U32(15))) * _U32(0x2C1B3C6D)
    h = h ^ (h >> _U32(13))
    m = h >> _U32(8)
    e = np.where(m < lim_plus, 1.0, np.where(m < lim_nonzero, -1.0, 0.0))
    e = np.where(c[None, :] < d, e, 0.0).astype(np.float32)
    return e * np.float32(scale)


@pytest.mark.parametrize("seed", [0, 2**32 - 5, 12345678901])
@pytest.mark.parametrize("k,d,offset", [(8, 3, 0), (16, 1030, 3), (8, 4099, 0),
                                        (24, 700, 1)])
def test_writer_arithmetic_gives_the_plain_bits(seed, k, d, offset):
    density = 1 / 3
    scale = np.float32(1.0 / np.sqrt(density * k))
    lazy = _writer_emulation(fk.plan_mask_writer(k, d, 4), seed, k, d,
                             density, offset, scale)
    np.testing.assert_array_equal(
        lazy, fk.lazy_matrix_plain(seed, k, d, density,
                                   block_offset=offset).numpy())
    cache = _writer_emulation(fk.plan_mask_writer(k, d, 2), seed, k, d,
                              density, offset, 1.0)
    np.testing.assert_array_equal(
        cache, fk.mask_cache_plain(seed, k, d, density,
                                   block_offset=offset).float().numpy())
