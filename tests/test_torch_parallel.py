"""The port's projection half of the scale-out against the JAX package.

``randomprojection_tpu_torch.parallel`` (``sharded.py``: the row bucket,
token-balanced cuts, layouts, ``materialize_sharded`` and the sharded
projectors; the mesh), ``TorchBackend(mesh=, feature_axis=)`` and
``CountSketch(mesh=)`` mirror ``tests/test_parallel.py`` and the mesh legs
of ``tests/test_pallas.py`` and ``tests/test_sketch.py``.  The port runs
its meshes on ``devices=['cpu'] * 8`` (one device named 8 times); the
reference runs on conftest's virtual 8-device mesh.

Levels, stated before the code (``PERF.md``, PR 14):

- bit for bit: ``row_bucket(n, mesh)``, ``token_balanced_bounds``,
  ``_flat_mesh_layout``, and ``materialize_sharded`` against the
  reference's (the Gaussian within the 4 ulps of ``ops/threefry.py``);
- within ``1e-5·max|Y|``: the sharded projectors, DP and DP×TP, against
  the reference's, and every estimator on a mesh against one device.  On
  the CPU DP is allclose, not bit for bit: the CPU BLAS blocks by row
  count (a standing divergence since PR 7);
- the lazy route: the reference refuses lazy off a TPU, so the port's
  DP×TP is held to the reference's own ``fused_sparse_project(x[:, shard],
  block_offset=..., interpret=True)`` summed over the shards, and to the
  port's one-device lazy route;
- ``CountSketch(mesh=)`` within ``rtol = atol = 2e-5`` of the reference's
  mesh sketch and of one device.
"""

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import randomprojection_tpu as ref
import randomprojection_tpu_torch as rpt
from randomprojection_tpu.models import sketch as ref_sk
from randomprojection_tpu.ops import kernels as ref_kernels
from randomprojection_tpu.ops.pallas_kernels import (
    fused_sparse_project as ref_fused,
)
from randomprojection_tpu.parallel import make_mesh as ref_make_mesh
from randomprojection_tpu.parallel import sharded as ref_sharded
from randomprojection_tpu_torch import parallel
from randomprojection_tpu_torch.interop import from_reference
from randomprojection_tpu_torch.models import sketch as sk
from randomprojection_tpu_torch.ops import kernels, threefry
from randomprojection_tpu_torch.parallel import sharded

CPU = {"device": "cpu"}
CPU8 = ["cpu"] * 8
REL = 1e-5  # max|Δ| ≤ REL·max|Y|
TOL = dict(rtol=2e-5, atol=2e-5)
GAUSS_ULPS = 4


def _mesh(shape):
    return parallel.make_mesh(shape, devices=["cpu"] * int(np.prod(
        list(shape.values()))))


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.fixture(scope="module")
def devices():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs the 8-device virtual mesh (default CPU suite)")
    return devs


# -- the mesh, the row bucket and the cuts -------------------------------------------


def test_make_mesh_shapes():
    mesh = parallel.make_mesh({"data": 4, "feature": 2}, devices=CPU8)
    assert mesh.shape == {"data": 4, "feature": 2}
    assert mesh.ranks is None and mesh.is_local((3, 1))
    assert mesh.axis_index((3, 1), "feature") == (1, 2)
    assert mesh.axis_index((3, 1), None) == (0, 1)
    with pytest.raises(ValueError, match="require"):
        parallel.make_mesh({"data": 3}, devices=CPU8)
    with pytest.raises(ValueError, match="ranks"):
        parallel.Mesh(mesh.devices, mesh.axis_names, ranks=np.zeros(3))


@pytest.mark.parametrize("p", [1, 3, 6, 8])
def test_row_bucket_equals_the_reference(p):
    class FakeMesh:
        shape = {"data": p}

    for n in [1, 5, 8, 9, 33, 64, 65, 100, 1000, 65536, 65537, 100000,
              131072, 131073]:
        assert sharded.row_bucket(n, FakeMesh(), "data") == \
            ref_sharded.row_bucket(n, FakeMesh(), "data")
        assert sharded.row_bucket(n) == ref_sharded.row_bucket(n)


def _skewed_indptr(seed):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, 40, size=97)
    sizes[:30] = 0  # early shards carry almost nothing
    sizes[50] = 900  # one heavy document
    return np.concatenate([[0], np.cumsum(sizes)])


@pytest.mark.parametrize("p", [1, 2, 3, 8, 120])
def test_token_balanced_bounds_equal_the_reference(p):
    for seed in range(3):
        indptr = _skewed_indptr(seed)
        got = sharded.token_balanced_bounds(indptr, p)
        np.testing.assert_array_equal(
            got, ref_sharded.token_balanced_bounds(indptr, p))
        assert got.dtype == np.int64
    np.testing.assert_array_equal(
        sharded.token_balanced_bounds(np.zeros(5, np.int64), 4),
        ref_sharded.token_balanced_bounds(np.zeros(5, np.int64), 4))
    with pytest.raises(ValueError, match="p must be"):
        sharded.token_balanced_bounds(np.zeros(3), 0)


@pytest.mark.parametrize("p", [1, 3, 8])
def test_flat_mesh_layout_equals_the_reference(p):
    rng = np.random.default_rng(9)
    X = rng.normal(size=(101, 500)).astype(np.float32)
    X[np.abs(X) < 1.0] = 0.0
    X[:40] = 0.0
    Xs = sp.csr_array(X)
    for got, want in zip(sk._flat_mesh_layout(Xs, p),
                         ref_sk._flat_mesh_layout(Xs, p)):
        np.testing.assert_array_equal(got, want)
        assert np.asarray(got).dtype == np.asarray(want).dtype


def test_layout_splits_rows_as_the_reference_pads_them():
    mesh = _mesh({"data": 8})
    layout = sharded.row_sharded(mesh)
    n = 101  # bucket 128 on 8 shards: 16 rows a block, the tail short
    rows = [layout.bounds(pos, (n, 4))[0] for pos in layout.positions()]
    per = ref_sharded.row_bucket(n, mesh, "data") // 8
    assert rows == [(min(i * per, n), min((i + 1) * per, n))
                    for i in range(8)]
    cols = sharded.feature_sharded(_mesh({"data": 2, "feature": 4}))
    assert [cols.bounds(pos, (3, 1001))[1] for pos in cols.positions()][:4] \
        == [(0, 251), (251, 502), (502, 753), (753, 1001)]
    assert sharded.slice_rows_sharded(torch.ones(5, 2), 3).shape == (3, 2)


# -- materialize_sharded -----------------------------------------------------------------


def _block_fn(kind):
    if kind == "sparse":
        return (functools.partial(kernels.sparse_block, density=0.1),
                lambda key, k_, d_, dt: ref_kernels.sparse_matrix(
                    key, k_, d_, 0.1, dt))
    return (getattr(kernels, f"{kind}_block"),
            getattr(ref_kernels, f"{kind}_matrix"))


@pytest.mark.parametrize("kind", ["gaussian", "sparse", "rademacher"])
@pytest.mark.parametrize("d", [2048, 1000])
@pytest.mark.mesh_env
def test_sharded_materialization_equals_the_reference(devices, kind, d):
    """Each device drawing only its column shard reproduces the reference's
    sharded matrix: a shard boundary d/4 need not be 512-aligned (250)."""
    port_fn, ref_fn = _block_fn(kind)
    k = 8
    key = jax.random.key(7)
    want = np.asarray(ref_sharded.materialize_sharded(
        ref_fn, key, k, d, ref_make_mesh({"data": 2, "feature": 4}),
        feature_axis="feature"))
    tk = threefry.seed_key(7, "cpu")
    got = sharded.materialize_sharded(
        port_fn, tk, k, d, _mesh({"data": 2, "feature": 4}),
        feature_axis="feature", dtype=torch.float32)
    assert len(got.blocks) == 4  # one a (device, column shard)
    whole = got.whole("cpu").numpy()
    if kind == "gaussian":
        assert _ulps(whole, want).max() <= GAUSS_ULPS
    else:
        np.testing.assert_array_equal(whole, want)
    # each shard is the one-device matrix's columns bit for bit
    full = kernels.materialize_columns(port_fn, tk, k, d, 0, d).numpy()
    np.testing.assert_array_equal(whole, full)


def test_replicated_materialization():
    mesh = _mesh({"data": 8})
    tk = threefry.seed_key(0, "cpu")
    R = sharded.materialize_sharded(kernels.gaussian_block, tk, 8, 512, mesh)
    assert len(R.blocks) == 1  # one copy: the 8 positions share the CPU
    for pos in R.layout.positions():
        assert R.block(pos).shape == (8, 512)


# -- the sharded projectors against the reference's ----------------------------------


@pytest.fixture(scope="module")
def xr():
    rng = np.random.default_rng(1)
    return (rng.normal(size=(96, 2048)).astype(np.float32),
            rng.normal(size=(16, 2048)).astype(np.float32))


@pytest.mark.parametrize("shape,fa", [({"data": 8}, None),
                                      ({"data": 4, "feature": 2}, "feature"),
                                      ({"data": 2, "feature": 4}, "feature")])
@pytest.mark.mesh_env
def test_projector_matches_the_reference(devices, xr, shape, fa):
    x, r = xr
    want = np.asarray(ref_sharded.make_sharded_projector(
        ref_make_mesh(shape), feature_axis=fa)(x, r))
    got = sharded.make_sharded_projector(_mesh(shape), feature_axis=fa)(
        torch.from_numpy(x), torch.from_numpy(r))
    _close(got, want)
    _close(got, x.astype(np.float64) @ r.T.astype(np.float64), 1e-6)


@pytest.mark.parametrize("shape,fa", [({"data": 8}, None),
                                      ({"data": 4, "feature": 2}, "feature")])
@pytest.mark.mesh_env
def test_split2_projector_matches_the_reference(devices, xr, shape, fa):
    x, _ = xr
    mask = np.sign(np.random.default_rng(2).normal(size=(16, 2048))).astype(
        np.float32)
    mask[::3] = 0.0
    scale = 0.25
    if fa is None:
        from randomprojection_tpu.ops.split_matmul import split2_project

        want = np.asarray(split2_project(x, jnp.asarray(mask, jnp.bfloat16),
                                         scale))
    else:
        want = np.asarray(ref_sharded.make_sharded_split2_projector(
            ref_make_mesh(shape), feature_axis=fa)(
                x, jnp.asarray(mask, jnp.bfloat16), scale))
    got = sharded.make_sharded_split2_projector(_mesh(shape),
                                                feature_axis=fa)(
        torch.from_numpy(x), torch.from_numpy(mask).to(torch.bfloat16), scale)
    _close(got, want)


# -- the estimators on a mesh --------------------------------------------------------------


def _pair(Est, mesh, fa=None, **kw):
    opts = kw.pop("backend_options", {})
    meshed = Est(backend_options={"mesh": mesh, "feature_axis": fa, **opts},
                 **kw)
    one = Est(backend_options={**CPU, **opts}, **kw)
    return meshed, one


@pytest.mark.mesh_env
def test_estimator_with_tp_mesh_backend(devices):
    """DP×TP: R column-sharded, X split (data, feature), the partials added
    over the feature axis; equal to one device and to the reference's TP
    estimator within 1e-5·max|Y|, on a ragged batch of 1,000 rows."""
    mesh = _mesh({"data": 4, "feature": 2})
    X = np.random.default_rng(5).normal(size=(1000, 2048)).astype(np.float32)
    for name in ("GaussianRandomProjection", "SparseRandomProjection"):
        tp, one = _pair(getattr(rpt, name), mesh, "feature", n_components=16,
                        random_state=1)
        tp.fit(X)
        state = tp.components_
        assert isinstance(state, sharded.Sharded)
        assert sorted(c for _, c in state.blocks) == [(0, 1024), (1024, 2048)]
        Y = tp.transform(X)
        _close(Y, one.fit(X).transform(X))
        want = np.asarray(getattr(ref, name)(
            n_components=16, random_state=1, backend="jax",
            backend_options={"mesh": ref_make_mesh({"data": 4, "feature": 2}),
                             "feature_axis": "feature"}).fit(X).transform(X))
        _close(Y, want)
        # the mesh changes the layout, never the matrix
        if name == "SparseRandomProjection":
            np.testing.assert_array_equal(
                tp.components_as_numpy(), one.components_as_numpy())


@pytest.mark.mesh_env
def test_split2_composes_with_tp_mesh(devices):
    mesh = _mesh({"data": 4, "feature": 2})
    X = np.random.default_rng(9).normal(size=(512, 2048)).astype(np.float32)
    kw = dict(n_components=32, random_state=2, density=1 / 3,
              backend_options={"precision": "split2"})
    tp, one = _pair(rpt.SparseRandomProjection, mesh, "feature", **kw)
    Y = tp.fit(X).transform(X)
    assert tp.components_.mask.dtype == torch.bfloat16
    _close(Y, one.fit(X).transform(X))
    want = np.asarray(ref.SparseRandomProjection(
        n_components=32, random_state=2, density=1 / 3, backend="jax",
        backend_options={"mesh": ref_make_mesh({"data": 4, "feature": 2}),
                         "feature_axis": "feature", "precision": "split2"},
    ).fit(X).transform(X))
    _close(Y, want)
    R = one.components_as_numpy().astype(np.float64)
    np.testing.assert_allclose(Y, X.astype(np.float64) @ R.T, rtol=1e-3,
                               atol=1e-3)


def test_split2_composes_with_dp_only_mesh():
    X = np.random.default_rng(11).normal(size=(256, 1024)).astype(np.float32)
    dp, one = _pair(rpt.SparseRandomProjection, _mesh({"data": 8}), None,
                    n_components=16, random_state=4, density=0.1,
                    backend_options={"precision": "split2"})
    _close(dp.fit(X).transform(X), one.fit(X).transform(X))


def test_estimator_with_mesh_backend():
    X = np.random.default_rng(3).normal(size=(64, 512))
    dp, one = _pair(rpt.GaussianRandomProjection, _mesh({"data": 8}),
                    n_components=16, random_state=0)
    _close(dp.fit(X).transform(X), one.fit(X).transform(X))


@pytest.mark.parametrize("shape,fa", [({"data": 8}, None),
                                      ({"data": 4, "feature": 2}, "feature")])
def test_jl_mesh_ragged_batch(shape, fa):
    """Ragged batches (101 rows on 8 shards; 5 and 1 rows: empty blocks)
    give exact rows on a mesh."""
    X = np.random.default_rng(0).normal(size=(101, 1024)).astype(np.float32)
    m, one = _pair(rpt.GaussianRandomProjection, _mesh(shape), fa,
                   n_components=16, random_state=0)
    m.fit(X)
    one.fit(X)
    for rows in (X, X[:5], X[:1]):
        Y = m.transform(rows)
        assert Y.shape == (rows.shape[0], 16)
        _close(Y, one.transform(rows))


@pytest.mark.parametrize("mode,precision", [("split2", None), ("f32", "default")])
@pytest.mark.parametrize("shape,fa", [({"data": 8}, None),
                                      ({"data": 4, "feature": 2}, "feature"),
                                      ({"data": 2, "feature": 4}, "feature")])
def test_lazy_mesh_equals_the_reference_kernel_summed_over_shards(
        mode, precision, shape, fa):
    """Lazy DP×TP: one fused kernel a position with its shard's block
    offset; held to the reference's own interpret-mode kernel on each
    column shard, summed over the shards, and to the port's one-device
    lazy route."""
    d, k, seed, density = 2048, 16, 3, 0.25
    X = np.random.default_rng(4).normal(size=(40, d)).astype(np.float32)
    opts = {"materialization": "lazy"}
    if precision:
        opts["precision"] = precision
    m, one = _pair(rpt.SparseRandomProjection, _mesh(shape), fa,
                   n_components=k, random_state=seed, density=density,
                   backend_options=opts)
    Y = m.fit(X).transform(X)
    _close(Y, one.fit(X).transform(X))
    q = shape.get("feature", 1)
    w = d // q
    want = sum(np.asarray(ref_fused(
        X[:, j * w:(j + 1) * w], seed, k, density, block_offset=j * w // 512,
        mxu_mode=mode, interpret=True)) for j in range(q))
    _close(Y, want)


def test_lazy_tp_alignment_validated_at_fit():
    mesh = _mesh({"data": 4, "feature": 2})
    X = np.zeros((16, 700), dtype=np.float32)  # 700 % (2*512) != 0
    with pytest.raises(ValueError, match="feature_shards"):
        rpt.SparseRandomProjection(
            8, random_state=0, density=0.5,
            backend_options={"mesh": mesh, "feature_axis": "feature",
                             "materialization": "lazy"}).fit(X)


def test_mesh_options_validate():
    mesh = _mesh({"data": 4, "feature": 2})
    for opts, match in (({"mesh": object()}, "parallel.Mesh"),
                        ({"feature_axis": "feature", **CPU}, "needs a mesh"),
                        ({"mesh": mesh, "feature_axis": "rows"}, "not an axis"),
                        ({"mesh": mesh, "data_axis": "batch"}, "not an axis"),
                        ({"mesh": mesh, **CPU}, "not both")):
        with pytest.raises(ValueError, match=match):
            rpt.backends.resolve_backend("torch", **opts)


def test_dispatch_steps_warns_and_is_ignored_on_a_mesh(caplog):
    X = np.random.default_rng(6).normal(size=(64, 1024)).astype(np.float32)
    with caplog.at_level(logging.WARNING, logger="randomprojection_tpu_torch"):
        m, one = _pair(rpt.SparseRandomProjection, _mesh({"data": 8}),
                       n_components=8, random_state=0,
                       backend_options={"materialization": "lazy",
                                        "dispatch_steps": 4})
        m.fit(X)
    assert "ignored on the mesh path" in caplog.text
    _close(m.transform(X), one.fit(X).transform(X))


def test_signs_stream_and_inverse_on_a_mesh():
    """transform_packed_signs, transform_stream, prepare_batch and the
    inverse under a DP×TP mesh agree with one device."""
    mesh = _mesh({"data": 4, "feature": 2})
    X = np.random.default_rng(7).normal(size=(300, 1024)).astype(np.float32)
    s_m, s_1 = _pair(rpt.SignRandomProjection, mesh, "feature",
                     n_components=64, random_state=5)
    c_m, c_1 = s_m.fit(X).transform(X), s_1.fit(X).transform(X)
    assert c_m.dtype == np.uint8 and c_m.shape == c_1.shape
    bits = np.unpackbits(c_m ^ c_1)
    assert bits.mean() <= 1e-3
    m, one = _pair(rpt.SparseRandomProjection, mesh, "feature",
                   n_components=16, random_state=0,
                   compute_inverse_components=True)
    m.fit(X)
    one.fit(X)
    assert m.prepare_batch(X[:7]) is X[:7] or np.shares_memory(
        m.prepare_batch(X[:7]), X)
    src = rpt.streaming.ArraySource(X, batch_rows=64)
    streamed = rpt.streaming.stream_to_array(m, src)
    _close(streamed, one.transform(X))
    np.testing.assert_allclose(m.inverse_components_, one.inverse_components_,
                               rtol=1e-5, atol=1e-6)
    _close(m.inverse_transform(m.transform(X)),
           one.inverse_transform(one.transform(X)))
    t = m.transform(torch.from_numpy(X))
    assert isinstance(t, torch.Tensor)
    _close(t, one.transform(X))


@pytest.mark.mesh_env
def test_reference_mesh_model_carries_across(devices):
    """A reference model fitted under its DP×TP mesh, carried with
    ``from_reference`` onto the port's mesh, transforms the same."""
    X = np.random.default_rng(8).normal(size=(128, 2048)).astype(np.float32)
    mesh_opts = {"mesh": ref_make_mesh({"data": 4, "feature": 2}),
                 "feature_axis": "feature"}
    port_opts = {"mesh": _mesh({"data": 4, "feature": 2}),
                 "feature_axis": "feature"}
    for opts in ({}, {"precision": "split2"}):
        r = ref.SparseRandomProjection(
            16, random_state=3, density=1 / 3, backend="jax",
            backend_options={**mesh_opts, **opts}).fit(X)
        want = np.asarray(r.transform(X))
        for comps in (None, r.components_as_numpy()):
            p = from_reference(r.spec_.to_dict(), comps,
                               backend_options={**port_opts, **opts})
            assert isinstance(
                p.components_.mask if opts else p.components_,
                sharded.Sharded)
            _close(p.transform(X), want)


# -- CountSketch on a mesh --------------------------------------------------------------


def _cs_pair(mesh, X, k=32, **kw):
    m = rpt.CountSketch(k, random_state=0, mesh=mesh, **kw).fit(X)
    one = rpt.CountSketch(k, random_state=0, backend_options=CPU, **kw).fit(X)
    return m, one


@pytest.mark.mesh_env
def test_countsketch_mesh_matches_single_device(devices):
    """DP row-sharded one-hot product: equal to one device and within 2e-5
    of the host sketch; rows not divisible by the mesh work."""
    mesh = _mesh({"data": 8})
    X = np.random.default_rng(0).normal(size=(101, 300)).astype(np.float32)
    m, one = _cs_pair(mesh, X)
    Ym = m.transform(X)
    assert Ym.shape == (101, 32) and m._mxu_route()
    np.testing.assert_allclose(Ym, one.transform(X), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        Ym, ref.CountSketch(32, random_state=0, backend="numpy").fit(X)
        .transform(X), **TOL)


@pytest.mark.mesh_env
def test_countsketch_mesh_scatter_path(devices, monkeypatch):
    monkeypatch.setattr(ref.CountSketch, "_MXU_MASK_BYTES_CAP", 1024)
    monkeypatch.setattr(rpt.CountSketch, "_MXU_MASK_BYTES_CAP", 1024)
    X = np.random.default_rng(1).normal(size=(64, 300)).astype(np.float32)
    m, one = _cs_pair(_mesh({"data": 8}), X, k=16)
    assert not m._mxu_route()
    Ym = m.transform(X)
    want = ref.CountSketch(16, random_state=0, backend="jax",
                           mesh=ref_make_mesh({"data": 8})).fit(X).transform(X)
    np.testing.assert_allclose(Ym, want, **TOL)
    np.testing.assert_allclose(Ym, one.transform(X), **TOL)


@pytest.mark.mesh_env
def test_countsketch_mesh_csr_matches_single_device(devices):
    """DP CSR sketch at token-balanced row cuts (ragged n, an empty early
    shard range): equal to one device, the reference's mesh sketch and the
    host scatter within 2e-5."""
    rng = np.random.default_rng(9)
    X = rng.normal(size=(101, 500)).astype(np.float32)
    X[np.abs(X) < 1.0] = 0.0
    X[:40] = 0.0
    Xs = sp.csr_array(X)
    m, one = _cs_pair(_mesh({"data": 8}), Xs)
    Ym = m.transform(Xs)
    assert Ym.shape == (101, 32) and Ym.dtype == np.float32
    np.testing.assert_allclose(Ym, one.transform(Xs), **TOL)
    want = ref.CountSketch(32, random_state=0, backend="jax",
                           mesh=ref_make_mesh({"data": 8})).fit(Xs).transform(Xs)
    np.testing.assert_allclose(Ym, want, **TOL)
    np.testing.assert_allclose(
        Ym, ref.CountSketch(32, random_state=0, backend="numpy").fit(Xs)
        .transform(Xs), **TOL)


def test_countsketch_mesh_stream_and_float64():
    """The stream's async transform under a mesh returns a device tensor
    (no prepared batch: the mesh lays a batch out at dispatch); float64
    stays on the host, exact."""
    rng = np.random.default_rng(2)
    X = rng.normal(size=(96, 128)).astype(np.float32)
    m, one = _cs_pair(_mesh({"data": 8}), X, k=16)
    Xs = sp.csr_array(np.where(np.abs(X) > 1, X, 0).astype(np.float32))
    assert m.prepare_batch(Xs) is Xs
    assert isinstance(m._transform_async(Xs[:32]), torch.Tensor)
    got = rpt.streaming.stream_to_array(
        m, rpt.streaming.ArraySource(X, batch_rows=32))
    np.testing.assert_allclose(got, one.transform(X), **TOL)
    X64 = X.astype(np.float64)
    np.testing.assert_array_equal(m.transform(X64), one.transform(X64))


def test_countsketch_mesh_validation():
    X = np.ones((4, 16), np.float32)
    with pytest.raises(ValueError, match="parallel.Mesh"):
        rpt.CountSketch(8, mesh=object()).fit(X)
    with pytest.raises(ValueError, match="not both"):
        rpt.CountSketch(8, mesh=_mesh({"data": 2}), backend_options=CPU).fit(X)
    cs = rpt.CountSketch(8, mesh=_mesh({"data": 2}), random_state=0).fit(X)
    assert cs.get_params()["data_axis"] == "data"
    cs.set_params(mesh=None, backend_options=CPU)
    assert cs.transform(X).shape == (4, 8)
