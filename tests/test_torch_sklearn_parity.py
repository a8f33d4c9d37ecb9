"""The port's estimators against sklearn's random_projection (the
behavioral contract the JAX package pins in tests/test_sklearn_parity.py):
exact where the contract is exact, matched statistics where the PRNGs
differ.  The torch backend runs on the CPU here (``device='cpu'``)."""

import numpy as np
import pytest
import torch

sklearn_rp = pytest.importorskip("sklearn.random_projection")

from randomprojection_tpu_torch import (  # noqa: E402
    DataDimensionalityWarning,
    GaussianRandomProjection,
    NotFittedError,
    SparseRandomProjection,
    johnson_lindenstrauss_min_dim,
)

CPU = {"device": "cpu"}
LAZY = {"device": "cpu", "materialization": "lazy"}


def test_jl_min_dim_matches_sklearn_exactly():
    ns = [10, 100, 5000, 10**6]
    for n in ns:
        for e in (0.05, 0.1, 0.5, 0.999):
            assert johnson_lindenstrauss_min_dim(n, eps=e) == int(
                sklearn_rp.johnson_lindenstrauss_min_dim(n, eps=e)
            ), (n, e)
    np.testing.assert_array_equal(
        johnson_lindenstrauss_min_dim(np.array(ns), eps=0.3),
        sklearn_rp.johnson_lindenstrauss_min_dim(np.array(ns), eps=0.3),
    )
    assert johnson_lindenstrauss_min_dim(100, eps=1e-5) == 368416070986


@pytest.mark.parametrize("options", [CPU, LAZY])
def test_auto_dim_and_density_match_sklearn(options):
    X = np.zeros((10, 1000))
    ours = SparseRandomProjection(n_components="auto", eps=0.5, random_state=0,
                                  backend_options=options)
    theirs = sklearn_rp.SparseRandomProjection(
        n_components="auto", eps=0.5, random_state=0)
    if options is LAZY:  # the fused kernel takes k in multiples of 8
        ours.set_params(n_components=112)
        theirs.set_params(n_components=112)
    ours.fit(X)
    theirs.fit(X)
    assert ours.n_components_ == theirs.n_components_
    assert ours.density_ == pytest.approx(theirs.density_)


def test_gaussian_matrix_statistics_match_sklearn():
    X = np.zeros((10, 1000))
    k = 400
    Ro = GaussianRandomProjection(k, random_state=0, backend_options=CPU).fit(
        X).components_as_numpy()
    Rt = sklearn_rp.GaussianRandomProjection(k, random_state=0).fit(
        X).components_
    assert Ro.shape == Rt.shape == (k, 1000)
    assert abs(Ro.mean() - Rt.mean()) < 1e-3
    np.testing.assert_allclose(Ro.var(), Rt.var(), rtol=0.02)


@pytest.mark.parametrize("options", [CPU, LAZY, CPU | {"precision": "split2"}])
def test_sparse_matrix_statistics_match_sklearn(options):
    X = np.zeros((10, 1000))
    k = 400
    Ro = SparseRandomProjection(k, density=0.1, random_state=0,
                                backend_options=options).fit(
        X).components_as_numpy().astype(np.float64)
    Rt = sklearn_rp.SparseRandomProjection(k, density=0.1,
                                           random_state=0).fit(X).components_
    nz = Ro[Ro != 0]
    np.testing.assert_allclose(np.unique(np.abs(nz)),
                               np.unique(np.abs(Rt.data)), rtol=1e-6)
    np.testing.assert_allclose(nz.size, Rt.nnz, rtol=0.03)
    # fair signs
    assert abs((nz > 0).mean() - 0.5) < 0.02


def test_transform_agrees_with_sklearn_given_same_matrix():
    """With sklearn's matrix grafted in, float32 products on the CPU give
    sklearn's float64 transform to float32 precision."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(100, 300))
    theirs = sklearn_rp.GaussianRandomProjection(32, random_state=0).fit(X)
    ours = GaussianRandomProjection(32, random_state=0,
                                    backend_options=CPU).fit(X)
    ours._state = ours._backend.dense_state(theirs.components_)
    want = theirs.transform(X)
    got = ours.transform(X)
    assert got.dtype == np.float64  # f64 in → f64 out (computed in f32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_warning_and_error_conditions_match_sklearn():
    with pytest.raises(ValueError):
        GaussianRandomProjection("auto", eps=0.1, backend_options=CPU).fit(
            np.ones((1000, 100)))
    with pytest.raises(ValueError):
        sklearn_rp.GaussianRandomProjection("auto", eps=0.1).fit(np.ones((1000, 100)))
    with pytest.warns(DataDimensionalityWarning):
        GaussianRandomProjection(200, random_state=0, backend_options=CPU).fit(
            np.ones((10, 100)))
    with pytest.warns(Warning):
        sklearn_rp.GaussianRandomProjection(200, random_state=0).fit(
            np.ones((10, 100)))


def test_inverse_transform_parity():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(80, 200))
    theirs = sklearn_rp.GaussianRandomProjection(
        40, random_state=0, compute_inverse_components=True).fit(X)
    ours = GaussianRandomProjection(40, random_state=0,
                                    backend_options=CPU).fit(X)
    ours._state = ours._backend.dense_state(theirs.components_)
    ours.inverse_components_ = np.ascontiguousarray(theirs.inverse_components_)
    Y = theirs.transform(X)
    want = theirs.inverse_transform(Y)
    np.testing.assert_allclose(ours.inverse_transform(Y), want,
                               rtol=1e-4, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize(
    "ours_cls,theirs_name",
    [(GaussianRandomProjection, "GaussianRandomProjection"),
     (SparseRandomProjection, "SparseRandomProjection")],
)
def test_get_feature_names_out_matches_sklearn(ours_cls, theirs_name):
    X = np.random.default_rng(0).normal(size=(40, 96))
    ours = ours_cls(n_components=7, random_state=0, backend_options=CPU).fit(X)
    theirs = getattr(sklearn_rp, theirs_name)(n_components=7,
                                              random_state=0).fit(X)
    names = ours.get_feature_names_out()
    np.testing.assert_array_equal(names, theirs.get_feature_names_out())
    assert names.dtype == object
    with pytest.raises(ValueError, match="input_features"):
        ours.get_feature_names_out(["a", "b"])
    with pytest.raises(NotFittedError):
        ours_cls(4).get_feature_names_out()


def test_clone_and_set_params_roundtrip():
    from sklearn.base import clone

    X = np.random.default_rng(0).normal(size=(50, 128)).astype(np.float32)
    for est in (
        GaussianRandomProjection(16, eps=0.2, random_state=3, backend_options=CPU),
        SparseRandomProjection(8, density=0.25, dense_output=True,
                               random_state=1, backend_options=LAZY),
        SparseRandomProjection(8, density=0.25, random_state=1,
                               backend_options=CPU | {"precision": "split2"}),
    ):
        dup = clone(est)
        assert type(dup) is type(est) and dup.get_params() == est.get_params()
        np.testing.assert_array_equal(est.fit(X).transform(X),
                                      dup.fit(X).transform(X))
    est = SparseRandomProjection(8, random_state=0, backend_options=CPU)
    assert est.set_params(density=0.5, n_components=4) is est
    assert est.density == 0.5 and est.n_components == 4
    with pytest.raises(ValueError, match="Invalid parameter"):
        GaussianRandomProjection(4).set_params(density=0.5)


def test_tensor_inputs_follow_the_dtype_policy():
    X = torch.from_numpy(np.random.default_rng(0).normal(size=(20, 64)))
    est = SparseRandomProjection(8, density=0.5, random_state=0,
                                 backend_options=CPU).fit(X)
    assert est.spec_.dtype == "float64"
    y = est.transform(X)
    assert isinstance(y, torch.Tensor) and y.device == X.device
    est32 = SparseRandomProjection(8, density=0.5, random_state=0,
                                   backend_options=CPU).fit(X.float())
    assert est32.spec_.dtype == "float32"
