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
    assert fk.LAUNCHES == {"rp_fused_project": 0, "rp_lazy_matrix": 0}


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
