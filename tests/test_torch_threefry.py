"""The port's threefry stream and matrix kernels against the JAX package.

- ``ops/threefry.py``: the hash, keys, ``fold_in`` and the uniform and
  Bernoulli draws are bit-equal to ``jax.random`` (installed jax, 64-bit
  types off, ``jax_threefry_partitionable=True``); ``erf_inv`` is within
  2 ulps of XLA's and so the Gaussian draws within 4.
- ``ops/kernels.py``: ``sparse_matrix`` and ``rademacher_matrix`` are
  bit-equal to the reference's for every seed, shape and density below;
  ``gaussian_matrix`` is within ``GAUSS_ULPS`` ulps; ``materialize_columns``
  equals slices of the full matrix and raises the reference's errors.
- ``TorchBackend.materialize`` (dense, split2) is the JAX backend's matrix,
  and ``from_reference`` of a spec without components transforms like the
  reference within ``1e-5·max|Y|``.
"""

import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import randomprojection_tpu as ref
from randomprojection_tpu.ops import kernels as ref_kernels
from randomprojection_tpu_torch.interop import from_reference
from randomprojection_tpu_torch.ops import kernels, threefry

SEEDS = [0, 1, 2**32 - 5, 12345678901]
#: stated tolerances: XLA's float32 log1p is not correctly rounded, so
#: erf_inv may differ in its last bits, and the scale adds one rounding
ERFINV_ULPS = 2
GAUSS_ULPS = 4
CPU = {"device": "cpu"}

# the matrix key of seed 0 and the reference's sparse_matrix of it at
# 256 x 4096, density 1/3, float32 (nonzeros and SHA-256 of its C-order
# bytes), computed with the installed jax on the CPU:
#   k = jax.random.fold_in(jax.random.key(0), 0x5250)
#   R = np.asarray(randomprojection_tpu.ops.kernels.sparse_matrix(
#       k, 256, 4096, 1/3, jnp.float32))
MATRIX_KEY_0 = [3218173443, 3934497062]
SPARSE_NNZ = 349665
SPARSE_SHA = "cd0d88ada17b39e4280c42b32fa89d8358b5619e6ca2b8cb0f8a364bf9cef048"


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@functools.lru_cache(maxsize=None)
def _keys(seed):
    jk = jax.random.fold_in(jax.random.key(seed), 0x5250)
    tk = threefry.fold_in(threefry.seed_key(seed, "cpu"), 0x5250)
    return jk, tk


# -- known answers ---------------------------------------------------------------


def test_threefry_known_answer():
    z = torch.zeros((), dtype=torch.int64)
    out = [int(v) for v in threefry.threefry_2x32(z, z, z, z)]
    assert out == [0x6B200159, 0x99BA4EFE]


def test_matrix_key_known_answer():
    key = threefry.fold_in(threefry.seed_key(0, "cpu"), 0x5250)
    assert key.tolist() == MATRIX_KEY_0


def test_sparse_matrix_known_answer():
    R = kernels.sparse_matrix(_keys(0)[1], 256, 4096, 1 / 3).numpy()
    assert R.dtype == np.float32 and R.shape == (256, 4096)
    assert np.count_nonzero(R) == SPARSE_NNZ
    assert hashlib.sha256(np.ascontiguousarray(R).tobytes()).hexdigest() == SPARSE_SHA


# -- the stream against jax.random ---------------------------------------------


@pytest.mark.parametrize("seed", SEEDS + [2**63 - 1, -3])
def test_keys_equal_jax(seed):
    want = np.asarray(jax.random.key_data(jax.random.key(seed)))
    assert threefry.seed_key(seed, "cpu").tolist() == want.astype(np.int64).tolist()
    jk, tk = _keys(seed)
    assert tk.tolist() == np.asarray(jax.random.key_data(jk)).tolist()
    folded = threefry.fold_in(tk, torch.arange(5))
    for b in range(5):
        want_b = jax.random.key_data(jax.random.fold_in(jk, b))
        assert folded[b].tolist() == np.asarray(want_b).tolist()


def test_hash_of_random_words_equals_jax():
    from jax._src import prng

    rng = np.random.default_rng(3)
    key = rng.integers(0, 2**32, size=2, dtype=np.uint64).astype(np.uint32)
    count = rng.integers(0, 2**32, size=64, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(prng.threefry_2x32(jnp.asarray(key), jnp.asarray(count)))
    k = torch.from_numpy(key.astype(np.int64))
    c = torch.from_numpy(count.astype(np.int64))
    x0, x1 = threefry.threefry_2x32(k[0], k[1], c[:32], c[32:])
    np.testing.assert_array_equal(torch.cat([x0, x1]).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(24, 512), (7, 13), (1, 1)])
def test_uniform_and_bernoulli_equal_jax(seed, shape):
    jk, tk = _keys(seed)
    np.testing.assert_array_equal(
        threefry.uniform(tk, shape).numpy(),
        np.asarray(jax.random.uniform(jk, shape)),
    )
    np.testing.assert_array_equal(
        threefry.uniform(tk, shape, -2.5, 3.0).numpy(),
        np.asarray(jax.random.uniform(jk, shape, minval=-2.5, maxval=3.0)),
    )
    for p in (0.5, 0.3):
        np.testing.assert_array_equal(
            threefry.bernoulli(tk, p, shape).numpy(),
            np.asarray(jax.random.bernoulli(jk, p, shape)),
        )


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_stated_ulps(seed):
    jk, tk = _keys(seed)
    got = threefry.normal(tk, (64, 512)).numpy()
    assert _ulps(got, np.asarray(jax.random.normal(jk, (64, 512)))).max() \
        <= GAUSS_ULPS


def test_erf_inv_within_stated_ulps():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, 1 << 20).astype(np.float32)
    x[:6] = [1.0, -1.0, 0.0, -0.0, np.nextafter(np.float32(-1), 0), 0.5]
    want = np.asarray(lax.erf_inv(jnp.asarray(x)))
    got = threefry.erf_inv(torch.from_numpy(x.copy())).numpy()
    np.testing.assert_array_equal(got[:4], want[:4])  # ±inf, ±0
    assert _ulps(got[4:], want[4:]).max() <= ERFINV_ULPS
    # the float64 log1p makes the result the same from call to call
    np.testing.assert_array_equal(
        threefry.erf_inv(torch.from_numpy(x.copy())).numpy(), got
    )


def test_seed_key_defaults_to_the_card(monkeypatch):
    """A key with no device is made on the card, as every entry point of
    the port runs there unless the CPU is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        threefry.seed_key(0)
    assert threefry.seed_key(0, "cpu").device.type == "cpu"


def test_random_bits_refuses_counters_past_32_bits():
    with pytest.raises(ValueError, match="2\\*\\*32"):
        threefry.random_bits(threefry.seed_key(0, "cpu"), (1 << 17, 1 << 16))


# -- the matrices against the reference's ----------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("k,d", [(24, 700), (24, 513), (24, 4096),
                                 (256, 700), (256, 513), (256, 4096)])
@pytest.mark.parametrize("density", [1 / 3, 0.25, 1.0])
def test_sparse_matrix_bit_equal(seed, k, d, density):
    jk, tk = _keys(seed)
    want = np.asarray(ref_kernels.sparse_matrix(jk, k, d, density))
    np.testing.assert_array_equal(kernels.sparse_matrix(tk, k, d, density).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("k,d", [(24, 700), (24, 513), (24, 4096),
                                 (256, 700), (256, 513), (256, 4096)])
def test_rademacher_matrix_bit_equal(seed, k, d):
    jk, tk = _keys(seed)
    want = np.asarray(ref_kernels.rademacher_matrix(jk, k, d))
    np.testing.assert_array_equal(kernels.rademacher_matrix(tk, k, d).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("k,d", [(24, 700), (256, 513), (256, 768)])
def test_gaussian_matrix_within_stated_ulps(seed, k, d):
    jk, tk = _keys(seed)
    want = np.asarray(ref_kernels.gaussian_matrix(jk, k, d))
    assert _ulps(kernels.gaussian_matrix(tk, k, d).numpy(), want).max() <= GAUSS_ULPS


@pytest.mark.parametrize("k", [24, 256])
def test_bf16_matrices_round_like_the_reference(k):
    jk, tk = _keys(7)
    for fn, args in (("sparse_matrix", (1 / 3,)), ("rademacher_matrix", ())):
        want = np.asarray(getattr(ref_kernels, fn)(jk, k, 700, *args, jnp.bfloat16))
        got = getattr(kernels, fn)(tk, k, 700, *args, torch.bfloat16)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))


def test_block_functions_equal_the_reference():
    jk, tk = _keys(2)
    for b, w in ((0, 512), (3, 200)):
        np.testing.assert_array_equal(
            kernels.sparse_block(tk, b, 16, w, 0.25).numpy(),
            np.asarray(ref_kernels.sparse_block(jk, b, 16, w, 0.25)),
        )
        np.testing.assert_array_equal(
            kernels.rademacher_block(tk, b, 16, w).numpy(),
            np.asarray(ref_kernels.rademacher_block(jk, b, 16, w)),
        )
        assert _ulps(kernels.gaussian_block(tk, b, 16, w).numpy(),
                     np.asarray(ref_kernels.gaussian_block(jk, b, 16, w))
                     ).max() <= GAUSS_ULPS


@pytest.mark.parametrize("cols", [(0, 512), (512, 1024), (1024, 1300), (0, 1300)])
def test_materialize_columns_equals_slices(cols):
    _, tk = _keys(5)
    fn = functools.partial(kernels.sparse_block, density=1 / 3)
    full = kernels.sparse_matrix(tk, 16, 1300, 1 / 3)
    got = kernels.materialize_columns(fn, tk, 16, 1300, *cols)
    assert torch.equal(got, full[:, cols[0]:cols[1]])


@pytest.mark.parametrize("cols", [(100, 512), (0, 700), (512, 512), (0, 2000)])
def test_materialize_columns_errors_match_the_reference(cols):
    jk, tk = _keys(5)
    with pytest.raises(ValueError) as want:
        ref_kernels.materialize_columns(ref_kernels.rademacher_block, jk, 8,
                                        1300, *cols)
    with pytest.raises(ValueError) as got:
        kernels.materialize_columns(kernels.rademacher_block, tk, 8, 1300, *cols)
    assert str(got.value) == str(want.value)


def test_matrices_need_no_host_array():
    _, tk = _keys(0)
    out = kernels.sparse_matrix(tk, 8, 1030, 0.5, device="cpu")
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    with pytest.raises(ValueError):
        kernels.sparse_matrix(tk, 0, 10, 0.5)


# -- the torch backend and interop -----------------------------------------------


def _ref_state_matrix(cls, seed, k, d, options=None, **kw):
    est = getattr(ref, cls)(k, random_state=seed, backend="jax",
                            backend_options=options, **kw)
    return est.fit(np.zeros((2, d), np.float32))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cls,kw", [
    ("SparseRandomProjection", dict(density=1 / 3)),
    ("SparseRandomProjection", dict(density="auto")),
    ("GaussianRandomProjection", {}),
])
def test_backend_dense_matrix_is_the_jax_backends(seed, cls, kw):
    import randomprojection_tpu_torch as port

    want = _ref_state_matrix(cls, seed, 24, 700, **kw).components_as_numpy()
    got = getattr(port, cls)(24, random_state=seed, backend_options=CPU, **kw)
    got = got.fit(np.zeros((2, 700), np.float32)).components_as_numpy()
    if hasattr(want, "toarray"):
        want = want.toarray()
    if cls == "GaussianRandomProjection":
        assert _ulps(got, want).max() <= GAUSS_ULPS
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_backend_split2_mask_is_the_jax_backends(seed):
    import randomprojection_tpu_torch as port

    want = _ref_state_matrix("SparseRandomProjection", seed, 32, 1100,
                             {"precision": "split2"}, density=0.25)
    got = port.SparseRandomProjection(
        32, density=0.25, random_state=seed,
        backend_options=CPU | {"precision": "split2"},
    ).fit(np.zeros((2, 1100), np.float32))
    np.testing.assert_array_equal(
        got._state.mask.float().numpy(),
        np.asarray(want._state.mask).astype(np.float32),
    )
    assert got._state.scale == want._state.scale


@pytest.mark.parametrize("cls,kw,options", [
    ("SparseRandomProjection", dict(density=1 / 3), {}),
    ("SparseRandomProjection", dict(density=1 / 3), {"precision": "split2"}),
    ("SparseRandomProjection", dict(density="auto"), {"precision": "highest"}),
    ("GaussianRandomProjection", {}, {}),
])
def test_from_reference_without_components_matches_jax(cls, kw, options):
    X = np.random.default_rng(1).normal(size=(120, 900)).astype(np.float32)
    est_ref = getattr(ref, cls)(24, random_state=4, backend="jax",
                                backend_options=options or None, **kw).fit(X)
    want = np.asarray(est_ref.transform(X), dtype=np.float64)
    est = from_reference(est_ref.spec_.to_dict(), backend_options=CPU | options)
    got = est.transform(X)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_sign_codes_from_the_seed_match_the_reference():
    X = np.random.default_rng(2).normal(size=(200, 96)).astype(np.float32)
    est_ref = ref.SignRandomProjection(64, random_state=7, backend="jax").fit(X)
    est = from_reference(est_ref.spec_.to_dict(), backend_options=CPU,
                         estimator="sign")
    want = np.unpackbits(np.asarray(est_ref.transform(X)), axis=1,
                         bitorder="little")
    got = np.unpackbits(est.transform(X), axis=1, bitorder="little")
    y = X.astype(np.float64) @ est_ref.components_as_numpy().astype(np.float64).T
    clear = np.abs(y) > 1e-5 * np.abs(y).max()
    np.testing.assert_array_equal(got[:, :64][clear], want[:, :64][clear])
