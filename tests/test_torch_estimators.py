"""The port's estimators end to end on the CPU, against the JAX package.

- JAX-backend dense and split2 models carried across with
  ``interop.from_reference`` give the JAX transform within
  ``max|Δ| ≤ 1e-5·max|Y|`` (same matrix, sums in another order).
- The lazy route (``materialization='lazy'``, here through the fused
  kernel's plain version): fit, transform against the JAX interpreter's
  ``fused_sparse_project``, ``components_as_numpy`` against the
  interpreter's matrix (exact), the inverse round trip, JL distortion
  against float64, the dtype policy and determinism.
- A streamed run that is cut and resumed from its cursor is bit-identical
  to an uninterrupted one.
"""

import numpy as np
import pytest
import torch

import randomprojection_tpu as ref
import randomprojection_tpu_torch as port
from randomprojection_tpu.ops import pallas_kernels as pk
from randomprojection_tpu_torch import streaming
from randomprojection_tpu_torch.interop import from_reference
from randomprojection_tpu_torch.utils.validation import bfloat16_dtype

CPU = {"device": "cpu"}
LAZY = {"device": "cpu", "materialization": "lazy"}


def _x(n, d, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(dtype)


def _pdist2(a):
    a = np.asarray(a, dtype=np.float64)
    sq = (a * a).sum(1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (a @ a.T)
    iu = np.triu_indices(a.shape[0], k=1)
    return np.maximum(d2[iu], 1e-30)


def _rel(got, want):
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max()


# -- carried across from the JAX backend ----------------------------------------


@pytest.mark.parametrize(
    "cls,kwargs,options",
    [
        ("SparseRandomProjection", dict(density=1 / 3), {}),
        ("SparseRandomProjection", dict(density=1 / 3), {"precision": "split2"}),
        ("SparseRandomProjection", dict(density="auto"), {"precision": "highest"}),
        ("GaussianRandomProjection", {}, {}),
    ],
)
def test_from_reference_matches_jax_transform(cls, kwargs, options):
    X = _x(120, 900, seed=1)
    est_ref = getattr(ref, cls)(24, random_state=4, backend="jax",
                                backend_options=options or None, **kwargs)
    want = np.asarray(est_ref.fit(X).transform(X), dtype=np.float64)
    est = from_reference(est_ref.spec_.to_dict(), est_ref.components_as_numpy(),
                         backend_options=CPU | options)
    got = est.transform(X)
    assert got.shape == want.shape and got.dtype == np.float32
    assert _rel(got, want) <= 1e-5
    assert type(est).__name__ == cls and est.spec_.to_dict() == \
        est_ref.spec_.to_dict()


def test_from_reference_lazy_needs_no_components():
    spec = ref.SparseRandomProjection(16, density=0.25, random_state=9).fit(
        _x(4, 700)).spec_.to_dict()
    est = from_reference(spec, backend_options=LAZY)
    want = np.asarray(pk.pallas_sparse_matrix(9, 16, 700, 0.25, interpret=True))
    np.testing.assert_array_equal(est.components_as_numpy(), want)
    with pytest.raises(ValueError, match="no components"):
        from_reference(spec, want, backend_options=LAZY)
    # a dense spec without components re-materialises the JAX backend's
    # threefry matrix from the seed
    dense = from_reference(spec, backend_options=CPU)
    want = ref.SparseRandomProjection(16, density=0.25, random_state=9,
                                      backend="jax").fit(_x(4, 700))
    np.testing.assert_array_equal(dense.components_as_numpy(),
                                  want.components_as_numpy())


def test_from_reference_split2_rejects_a_non_mask():
    spec = ref.SparseRandomProjection(8, density=0.5, random_state=0).fit(
        _x(2, 64)).spec_.to_dict()
    with pytest.raises(ValueError, match="scaled"):
        from_reference(spec, _x(8, 64), backend_options=CPU | {"precision": "split2"})


# -- the lazy route end to end ----------------------------------------------------


@pytest.fixture(scope="module")
def lazy_fit():
    X = _x(200, 1100, seed=2)
    est = port.SparseRandomProjection(32, density=1 / 3, random_state=17,
                                      backend_options=LAZY).fit(X)
    return est, X


def test_lazy_components_are_the_interpreter_matrix(lazy_fit):
    est, _ = lazy_fit
    want = np.asarray(pk.pallas_sparse_matrix(17, 32, 1100, 1 / 3, interpret=True))
    got = est.components_as_numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("precision,mode", [(None, "split2"), ("default", "f32")])
def test_lazy_transform_matches_interpreter(precision, mode):
    import jax.numpy as jnp

    X = _x(150, 1030, seed=3)
    est = port.SparseRandomProjection(
        16, density=0.2, random_state=5,
        backend_options=LAZY | ({"precision": precision} if precision else {}),
    ).fit(X)
    want = np.asarray(pk.fused_sparse_project(
        jnp.asarray(X), 5, 16, 0.2, mxu_mode=mode, interpret=True))
    assert _rel(est.transform(X), want) <= 1e-5


def test_lazy_transform_jl_distortion(lazy_fit):
    est, X = lazy_fit
    Y = est.transform(X)
    C = est.components_as_numpy().astype(np.float64)
    distortion = np.max(np.abs(_pdist2(Y) / _pdist2(X.astype(np.float64) @ C.T) - 1))
    assert distortion <= 1e-3


def test_lazy_inverse_round_trip(lazy_fit):
    est, X = lazy_fit
    Y = est.transform(X)
    Xr = est.inverse_transform(Y)
    assert Xr.shape == X.shape and Xr.dtype == np.float32
    # projecting the reconstruction gives Y back (R · pinv(R) = I_k)
    assert _rel(est.transform(Xr), Y.astype(np.float64)) <= 1e-4


def test_lazy_inverse_components_at_fit():
    X = _x(20, 600, seed=4)
    est = port.SparseRandomProjection(8, density=0.5, random_state=1,
                                      compute_inverse_components=True,
                                      backend_options=LAZY).fit(X)
    R = est.components_as_numpy().astype(np.float64)
    np.testing.assert_allclose(est.inverse_components_, np.linalg.pinv(R),
                               rtol=1e-4, atol=1e-5)


def test_lazy_is_deterministic_and_seed_sensitive(lazy_fit):
    est, X = lazy_fit
    again = port.SparseRandomProjection(32, density=1 / 3, random_state=17,
                                        backend_options=LAZY).fit(X)
    np.testing.assert_array_equal(est.transform(X), again.transform(X))
    other = port.SparseRandomProjection(32, density=1 / 3, random_state=18,
                                        backend_options=LAZY).fit(X)
    assert not np.array_equal(est.components_as_numpy(),
                              other.components_as_numpy())


@pytest.mark.parametrize(
    "in_dtype,out_dtype",
    [(np.float32, np.float32), (np.float64, np.float64), (np.int32, np.float64)],
)
@pytest.mark.parametrize("options", [LAZY, CPU, CPU | {"precision": "split2"}])
def test_dtype_policy(in_dtype, out_dtype, options):
    X = (_x(10, 600) * 10).astype(in_dtype)
    est = port.SparseRandomProjection(8, density=0.5, random_state=0,
                                      backend_options=options).fit(X)
    assert est.transform(X).dtype == out_dtype


def test_bf16_policy_keeps_bf16():
    bf16 = bfloat16_dtype()
    X = _x(10, 600).astype(bf16)
    est = port.SparseRandomProjection(8, density=0.5, random_state=0,
                                      backend_options=LAZY).fit(X)
    Y = est.transform(X)
    assert Y.dtype == bf16
    want = est.transform(X.astype(np.float32))
    np.testing.assert_allclose(Y.astype(np.float32), want, rtol=1e-2, atol=1e-2)
    # an f32-fitted model returns f32 even for bf16 input
    est32 = port.SparseRandomProjection(8, density=0.5, random_state=0,
                                        backend_options=LAZY).fit(
                                            X.astype(np.float32))
    assert est32.transform(X).dtype == np.float32


@pytest.mark.parametrize("options", [CPU, LAZY])
def test_bf16_compute_dtype(options):
    """compute_dtype='bfloat16' rounds x (and a dense R) to bf16: precision
    'default', the lazy kernel's bf16 mode, bf16-grade output."""
    X = _x(64, 600, seed=9)
    est = port.SparseRandomProjection(
        16, density=1 / 3, random_state=0,
        backend_options=options | {"compute_dtype": "bfloat16"}).fit(X)
    assert est._backend.precision == "default"
    Y = est.transform(X)
    assert Y.dtype == np.float32
    C = est.components_as_numpy().astype(np.float64)
    assert _rel(Y, X.astype(np.float64) @ C.T) <= 2e-2


def test_tensor_in_tensor_out_and_fit_from_tensor(lazy_fit):
    est, X = lazy_fit
    xt = torch.from_numpy(X)
    fitted = port.SparseRandomProjection(32, density=1 / 3, random_state=17,
                                         backend_options=LAZY).fit(xt)
    assert fitted.spec_ == est.spec_
    y = fitted.transform(xt)
    assert isinstance(y, torch.Tensor) and y.dtype == torch.float32
    np.testing.assert_array_equal(y.numpy(), est.transform(X))


def test_lazy_refuses_gaussian_and_ragged_k():
    with pytest.raises(ValueError, match="sparse"):
        port.GaussianRandomProjection(8, backend_options=LAZY).fit(_x(2, 64))
    with pytest.raises(ValueError, match="multiple of 8"):
        port.SparseRandomProjection(12, backend_options=LAZY).fit(_x(2, 64))
    with pytest.raises(port.NotFittedError):
        port.SparseRandomProjection(8, backend_options=LAZY).transform(_x(2, 64))


def test_dense_routes_distortion_and_auto_k():
    X = _x(100, 1100, seed=6)
    auto = port.SparseRandomProjection(n_components="auto", eps=0.9,
                                       backend_options=CPU).fit(X)
    assert auto.n_components_ == ref.johnson_lindenstrauss_min_dim(100, eps=0.9)
    for options in (CPU, CPU | {"precision": "split2"}):
        est = port.SparseRandomProjection(32, density=1 / 3, random_state=0,
                                          backend_options=options).fit(X)
        C = est.components_as_numpy().astype(np.float64)
        Y = est.transform(X)
        ref_d2 = _pdist2(X.astype(np.float64) @ C.T)
        assert np.max(np.abs(_pdist2(Y) / ref_d2 - 1)) <= 1e-3


def test_get_params_round_trip():
    est = port.SparseRandomProjection(8, density=0.5, backend_options=LAZY)
    clone = type(est)(**est.get_params())
    assert clone.get_params() == est.get_params()
    with pytest.raises(ValueError, match="Invalid parameter"):
        est.set_params(bogus=1)


# -- streaming: resume is bit-identical ------------------------------------------


def _source(n=256, d=700, batch=48):
    def read(lo, hi):
        return _x(hi - lo, d, seed=lo)

    return streaming.CallableSource(read, n, d, np.float32, batch_rows=batch)


@pytest.mark.parametrize("options", [LAZY, CPU])
def test_stream_resume_bit_identical(tmp_path, options):
    src = _source()
    est = port.SparseRandomProjection(16, density=1 / 3, random_state=2,
                                      backend_options=options).fit_source(src)
    full = streaming.stream_to_array(est, src)

    ckpt = str(tmp_path / "cursor.json")
    out = np.full_like(full, np.nan)
    for i, (lo, y) in enumerate(est.transform_stream(src, checkpoint_path=ckpt)):
        out[lo:lo + y.shape[0]] = y
        if i == 2:
            break  # batches 0-1 committed; batch 2 was never acknowledged
    assert streaming.StreamCursor.load(ckpt).rows_done == 2 * src.batch_rows
    with pytest.raises(ValueError, match="out="):
        streaming.stream_to_array(est, src, checkpoint_path=ckpt)
    resumed = streaming.stream_to_array(est, src, out=out, checkpoint_path=ckpt)
    np.testing.assert_array_equal(resumed, full)
    assert streaming.StreamCursor.load(ckpt).rows_done == src.n_rows


def test_stream_crash_in_consumer_is_recomputed(tmp_path):
    src = _source(n=250, batch=50)
    est = port.SparseRandomProjection(8, density=0.5, random_state=3,
                                      backend_options=LAZY).fit_source(src)
    full = streaming.stream_to_array(est, src, pipeline_depth=1)
    ckpt = str(tmp_path / "c.json")
    out = np.zeros_like(full)
    with pytest.raises(RuntimeError, match="boom"):
        for lo, y in est.transform_stream(src, checkpoint_path=ckpt,
                                          pipeline_depth=3):
            if lo == 150:
                raise RuntimeError("boom")  # crash before writing batch 3
            out[lo:lo + y.shape[0]] = y
    assert streaming.StreamCursor.load(ckpt).rows_done == 150
    streaming.stream_to_array(est, src, out=out, checkpoint_path=ckpt)
    np.testing.assert_array_equal(out, full)


def test_array_source_and_stream_matches_reference_numpy_stream():
    from randomprojection_tpu import streaming as ref_streaming

    X = _x(256, 128, seed=8)
    a = ref_streaming.stream_to_array(
        ref.SparseRandomProjection(8, density=0.5, random_state=1,
                                   backend="numpy", dense_output=True).fit(X),
        ref_streaming.ArraySource(X, batch_rows=64))
    b = streaming.stream_to_array(
        port.SparseRandomProjection(8, density=0.5, random_state=1,
                                    backend="numpy", dense_output=True).fit(X),
        streaming.ArraySource(X, batch_rows=64))
    np.testing.assert_array_equal(a, b)


def test_stream_rejects_misaligned_resume_and_bad_depth():
    src = _source(n=256, batch=64)
    est = port.SparseRandomProjection(8, density=0.5, random_state=0,
                                      backend_options=LAZY).fit_source(src)
    with pytest.raises(ValueError, match="multiple of batch_rows"):
        list(est.transform_stream(src, cursor=streaming.StreamCursor(10)))
    with pytest.raises(ValueError, match="pipeline_depth"):
        list(est.transform_stream(src, pipeline_depth=0))
    assert list(est.transform_stream(src, cursor=streaming.StreamCursor(256))) == []
