"""The port's fused lazy-mask kernels (plain versions) against the JAX
package's Pallas kernels run in interpret mode.

The lazy mask is defined as the interpreter's integer hash stream, so
``lazy_matrix`` must equal ``pallas_sparse_matrix(..., interpret=True)``
bit for bit, and ``fused_project`` must match
``fused_sparse_project(..., interpret=True)`` on both TPU routes
(``dma=True`` and ``dma=False``) in every mode.  The projection tolerance
is ``max|Δ| ≤ 1e-5·max|Y|``, for sums taken in another order; the
measured worst case at these shapes is ~3.4e-7 (f32), ~6.4e-8 (split2)
and ~4.9e-8 (bf16).  Shapes stay toy-sized: the Pallas interpreter legs
are the suite's slow ones.  The CUDA kernels themselves are held to these
plain versions on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from randomprojection_tpu.ops import pallas_kernels as pk
from randomprojection_tpu_torch.ops import fused_kernels as fk

SEEDS = [0, 7, 2**31 + 3, 12345678901, 2**32 - 5]


def _x(n, d, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("density", [1 / 3, 0.05, 1.0])
def test_lazy_matrix_equals_interpreter_matrix(seed, density):
    for k, d in ((16, 1024), (8, 700), (24, 520)):  # exact and ragged d
        want = np.asarray(
            pk.pallas_sparse_matrix(seed, k, d, density, interpret=True)
        )
        got = fk.lazy_matrix(seed, k, d, density, device="cpu").numpy()
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("offset,d", [(1, 500), (2, 76)])
def test_lazy_matrix_block_offset_is_a_column_slice(offset, d):
    """Block offset b gives columns [512·b, 512·b + d) of the full matrix."""
    lo = offset * fk.BLOCK_D
    full = np.asarray(
        pk.pallas_sparse_matrix(12345678901, 16, lo + d, 0.25, interpret=True)
    )
    got = fk.lazy_matrix(12345678901, 16, d, 0.25, block_offset=offset,
                         device="cpu")
    np.testing.assert_array_equal(got.numpy(), full[:, lo:])


def test_mask_block_is_the_interpreter_block():
    import jax.numpy as jnp

    gen = pk._interp_mask_block(0.3, jnp.int32(pk._seed_to_i32(2**32 - 5)),
                                jnp.int32(9))
    want = np.asarray(gen((40, fk.BLOCK_D)))
    got = fk.lazy_mask_block(2**32 - 5, 9, 40, 0.3).numpy()
    np.testing.assert_array_equal(got, want)


def test_mul32_is_uint32_multiplication():
    a = np.random.default_rng(0).integers(0, 2**32, size=4096, dtype=np.uint64)
    for c in (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x2C1B3C6D):
        want = (a.astype(np.uint32) * np.uint32(c)).astype(np.int64)
        got = fk._mul32(torch.from_numpy(a.astype(np.int64)), c).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("density", [1 / 3, 0.05, 1.0, 2.0**-25])
def test_mask_limits_match_float32_threshold(density):
    """The integer limit reproduces ``u < float32(t)`` for every 24-bit u."""
    m = np.arange(1 << 24, dtype=np.int64)
    u = m.astype(np.float32) * np.float32(2.0**-24)
    lim_plus, lim_nonzero = fk.mask_limits(density)
    np.testing.assert_array_equal(m < lim_plus, u < np.float32(density * 0.5))
    np.testing.assert_array_equal(m < lim_nonzero, u < np.float32(density))


@pytest.mark.parametrize("mode", ["f32", "split2", "bf16"])
@pytest.mark.parametrize("dma", [True, False])
@pytest.mark.parametrize("n,d", [(70, 700), (130, 1100), (3, 520)])
def test_fused_project_matches_interpreter(mode, dma, n, d):
    import jax.numpy as jnp

    x = _x(n, d, seed=n)
    xj = jnp.asarray(x).astype(jnp.bfloat16 if mode == "bf16" else jnp.float32)
    want = np.asarray(
        pk.fused_sparse_project(xj, 11, 16, 1 / 3, mxu_mode=mode,
                                interpret=True, dma=dma)
    )
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32)))
    got = fk.fused_sparse_project(xt, 11, 16, 1 / 3, mxu_mode=mode)
    assert got.dtype == torch.float32 and got.shape == (n, 16)
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err


def test_fused_project_block_offset_matches_interpreter():
    import jax.numpy as jnp

    x = _x(40, 600, seed=7)
    want = np.asarray(
        pk.fused_sparse_project(jnp.asarray(x), 5, 16, 0.5, block_offset=2,
                                interpret=True, dma=True)
    )
    got = fk.fused_sparse_project(torch.from_numpy(x), 5, 16, 0.5,
                                  block_offset=2, mxu_mode="f32")
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_fused_project_is_x_times_lazy_matrix():
    x = _x(33, 1030, seed=3)
    y = fk.fused_sparse_project(torch.from_numpy(x), 9, 24, 1 / 3,
                                mxu_mode="split2").numpy()
    R = fk.lazy_matrix(9, 24, 1030, 1 / 3, device="cpu").numpy().astype(
        np.float64)
    ref = x.astype(np.float64) @ R.T
    assert np.abs(y - ref).max() <= 1e-5 * np.abs(ref).max()


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    fk.reset_launches()
    x = torch.from_numpy(_x(8, 512))
    got = fk.fused_sparse_project(x, 1, 8, 0.5, mxu_mode="split2")
    torch.testing.assert_close(
        got, fk.fused_project(x, 1, 8, 0.5, mxu_mode="split2"), rtol=0, atol=0
    )
    fk.lazy_matrix(1, 8, 512, 0.5, device="cpu")
    assert fk.LAUNCHES == {"rp_fused_project": 0, "rp_lazy_matrix": 0,
                           "rp_mask_cache": 0}


def test_cuda_launchers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        fk.rp_fused_project(torch.zeros(8, 512), 0, 8, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        fk.rp_lazy_matrix(0, 8, 512, 0.5, device="cpu")


@pytest.mark.parametrize(
    "kwargs,match",
    [
        (dict(n_components=12), "multiple of 8"),
        (dict(mxu_mode="tf32"), "mxu_mode"),
        (dict(density=0.0), "density"),
        (dict(n_components=0), "strictly positive"),
    ],
)
def test_validation_as_fused_raw(kwargs, match):
    args = dict(seed=0, n_components=8, density=0.5, mxu_mode="f32") | kwargs
    x = torch.zeros(4, 64)
    with pytest.raises(ValueError, match=match):
        fk.fused_sparse_project(x, args.pop("seed"), args.pop("n_components"),
                                args.pop("density"), **args)
    with pytest.raises(ValueError):
        pk._fused_raw(np.zeros((4, 64), np.float32), 0,
                      kwargs.get("n_components", 8),
                      kwargs.get("density", 0.5), block_n=None,
                      block_offset=0, mxu_mode=kwargs.get("mxu_mode", "f32"),
                      interpret=True, no_cache=False)


def test_lazy_matrix_needs_the_card_unless_the_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="none is available.*device='cpu'"):
        fk.lazy_matrix(1, 8, 512, 0.5)
    assert fk.lazy_matrix(1, 8, 512, 0.5, device="cpu").shape == (8, 512)


# -- the fused kernel's launch planner ---------------------------------------------


@pytest.mark.parametrize("mode", ["f32", "split2", "bf16"])
@pytest.mark.parametrize("k", [8, 16, 64, 72, 128, 136, 256, 264, 512, 1000])
@pytest.mark.parametrize("n", [1, 3, 64, 65_536, 70_001])
def test_plan_covers_k_and_fits_shared_memory(mode, k, n):
    plan = fk.plan_project(n, 4096, k, mode, sm_count=132)
    # the slices cover k exactly once: every column in one slice, the last
    # slice holding at least one column
    assert plan.cta_n in (64, 128, 256)
    assert (plan.slices - 1) * plan.cta_n < k <= plan.slices * plan.cta_n
    assert plan.slices == 1 or plan.cta_n == fk.SLICE_N
    assert 2 <= plan.stages <= fk.MAX_STAGES
    assert plan.smem_bytes == fk.project_smem_bytes(plan.cta_n, mode,
                                                    plan.stages)
    assert plan.smem_bytes <= 232_448
    # one more stage would not fit, or the ring is at its cap
    assert (plan.stages == fk.MAX_STAGES or fk.project_smem_bytes(
        plan.cta_n, mode, plan.stages + 1) > 232_448)
    assert plan.tiles == -(-n // fk.TILE_M) * plan.slices
    assert plan.grid == max(1, min(plan.tiles, 132))
    assert plan.mask_columns % fk.STEP_D == 0 and plan.mask_columns >= 4096


@pytest.mark.parametrize(
    "d,mode,route,pad",
    [
        (4096, "split2", "tma", 0),
        (4096, "bf16", "tma", 0),
        (1100, "bf16", "cp.async", 0),   # 2200-byte rows: not 16-byte
        (1101, "bf16", "cp.async", 1),   # odd bf16 rows get a zero column
        (4097, "f32", "cp.async", 0),
        (4097, "split2", "cp.async", 0),
        (1100, "f32", "tma", 0),         # 4400-byte rows are 16-byte
        (520, "bf16", "tma", 0),
    ],
)
def test_plan_route_by_row_alignment(d, mode, route, pad):
    plan = fk.plan_project(1000, d, 64, mode, sm_count=132)
    assert (plan.route, plan.pad_columns) == (route, pad)
    misaligned = fk.plan_project(1000, d, 64, mode, sm_count=132,
                                 base_aligned=False)
    assert misaligned.route == "cp.async"


def test_plan_of_the_main_path():
    """Config 2's batch: one 256-wide slice (x read once), the ring as deep
    as the 227 KB allow, one persistent CTA per SM."""
    plan = fk.plan_project(65_536, 4096, 256, "split2", sm_count=132)
    assert (plan.cta_n, plan.slices, plan.stages, plan.route) == (
        256, 1, 4, "tma")
    assert (plan.tiles, plan.grid, plan.mask_columns) == (1024, 132, 4096)
    assert plan.smem_bytes == 1152 + 4 * (16_384 + 32_768)


@pytest.mark.parametrize("kwargs", [dict(k=12), dict(k=0), dict(mode="tf32"),
                                    dict(sm_count=0)])
def test_plan_refuses_what_the_kernel_cannot_run(kwargs):
    args = dict(n=10, d=512, k=16, mode="f32", sm_count=132) | kwargs
    with pytest.raises(ValueError):
        fk.plan_project(args["n"], args["d"], args["k"], args["mode"],
                        sm_count=args["sm_count"])


# -- the three-way split of the f32 mode -------------------------------------------


def _f32_values(kind, rng):
    if kind == "random":
        return rng.normal(size=20_000).astype(np.float32)
    if kind == "huge":
        v = rng.uniform(1e30, 3.4e38, size=5_000) * rng.choice([-1, 1], 5_000)
        return np.concatenate([v, [3.4028235e38, -3.4028235e38]]).astype(
            np.float32)
    if kind == "tiny":
        e = rng.uniform(-110, -60, size=5_000)
        return (rng.choice([-1, 1], 5_000) * 2.0 ** e).astype(np.float32)
    # every float32 bit pattern of exponent 0 (subnormal) and the
    # smallest normals
    bits = rng.integers(1, 1 << 24, size=5_000, dtype=np.int64)
    return (bits | (rng.integers(0, 2, 5_000) << 31)).astype(np.uint32).view(
        np.float32)


@pytest.mark.parametrize("kind", ["random", "huge", "tiny", "subnormal"])
def test_three_way_split_sums_to_x(kind):
    from randomprojection_tpu_torch.ops.split_matmul import (
        split_f32_to_bf16_pair,
        split_f32_to_bf16_triple,
    )

    x = torch.from_numpy(_f32_values(kind, np.random.default_rng(4)))
    hi, mid, lo = split_f32_to_bf16_triple(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    # hi is the pair split's hi, bit for bit
    assert torch.equal(hi, split_f32_to_bf16_pair(x)[0])
    total = (hi.float() + mid.float()) + lo.float()  # float32 sums
    exact = x.abs() >= 2.0 ** -110
    assert torch.equal(total[exact].view(torch.int32),
                       x[exact].view(torch.int32))
    # below 2^-110 bf16's grid (2^-133) cannot hold float32's lowest bits
    assert (total - x).abs().max().item() <= 2.0 ** -133
    if kind != "subnormal":
        assert exact.all()


@pytest.mark.parametrize("n,d,k", [(70, 700, 16), (33, 1030, 24)])
def test_product_through_the_three_way_split_matches_f32(n, d, k):
    """The f32 mode's tensor-core arithmetic in plain torch: the three bf16
    parts' products with the ±1/0 mask (each exact), summed per 512-column
    block in float32, against the f32 plain version, within the stated
    1e-5·max|Y|."""
    from randomprojection_tpu_torch.ops.precision import fp32_matmul
    from randomprojection_tpu_torch.ops.split_matmul import (
        split_f32_to_bf16_triple,
    )

    x = torch.from_numpy(_x(n, d, seed=d))
    want = fk.fused_project(x, 5, k, 1 / 3, mxu_mode="f32")
    mask = fk.lazy_matrix(5, k, d, 1 / 3, device="cpu")
    scale = mask.abs().max()
    y = torch.zeros((n, k))
    with fp32_matmul():
        for lo in range(0, d, fk.BLOCK_D):
            m_t = (mask[:, lo:lo + fk.BLOCK_D] / scale).t()
            for part in split_f32_to_bf16_triple(x[:, lo:lo + fk.BLOCK_D]):
                y += part.float() @ m_t
    got = y * scale
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


@pytest.mark.parametrize("seed,k,d,off", [(0, 16, 1024, 0), (7, 8, 700, 3),
                                          (2**32 - 5, 24, 1100, 1)])
def test_mask_cache_plain_is_the_interpreter_mask(seed, k, d, off):
    """The bf16 mask cache holds the interpreter's ±1/0 mask (unscaled),
    zero past d up to the 64-column pad."""
    full = np.asarray(pk.pallas_sparse_matrix(seed, k, off * fk.BLOCK_D + d,
                                              1 / 3, interpret=True))
    got = fk.mask_cache_plain(seed, k, d, 1 / 3, block_offset=off)
    assert got.dtype == torch.bfloat16
    assert got.shape == (k, -(-d // fk.STEP_D) * fk.STEP_D)
    np.testing.assert_array_equal(got[:, :d].float().numpy(),
                                  np.sign(full[:, off * fk.BLOCK_D:]))
    assert not got[:, d:].any()
