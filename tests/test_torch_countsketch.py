"""CountSketch (config 5) of the port against the JAX package.

- ``h_``/``s_`` equal the reference's bit for bit (the same
  ``SeedSequence([0x43534B31, seed])`` draw on the host).
- Every route on the torch backend (run here on the CPU: the one-hot
  product, the scatter with ``use_mxu=False`` and past the mask cap, the
  flat CSR scatter, a prepared ``DeviceBatch``) is within
  ``rtol = atol = 2e-5`` of the reference's ``CountSketch(backend='numpy')``;
  float64 input and the numpy backend equal it exactly.
- ``use_mxu`` semantics, validation, ``TokenSource`` batches equal to the
  reference's, the stream, and the model file in both directions.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import randomprojection_tpu as ref
from randomprojection_tpu import serialize as ref_ser
from randomprojection_tpu import streaming as ref_stream
from randomprojection_tpu.models import sketch as ref_sk
from randomprojection_tpu.ops import hashing as ref_h
from randomprojection_tpu_torch import serialize as ser
from randomprojection_tpu_torch import streaming
from randomprojection_tpu_torch.models import sketch as sk
from randomprojection_tpu_torch.models.sketch import CountSketch
from randomprojection_tpu_torch.ops import hashing as h
from randomprojection_tpu_torch.utils.validation import NotFittedError

CPU = {"device": "cpu"}
TOL = dict(rtol=2e-5, atol=2e-5)


def _ref(k, X, seed=0):
    return ref.CountSketch(k, random_state=seed, backend="numpy").fit(X)


def _sparse(n=37, d=400, seed=5, cut=1.2, dtype=np.float32):
    X = np.random.default_rng(seed).normal(size=(n, d)).astype(dtype)
    X[np.abs(X) < cut] = 0.0
    X[5] = 0.0  # an empty row
    return sp.csr_array(X)


@pytest.mark.parametrize("seed,k,d", [(0, 64, 300), (7, 256, 1 << 12),
                                      (2**31 + 5, 3, 17)])
def test_tables_equal_the_reference(seed, k, d):
    port = CountSketch(k, random_state=seed, backend_options=CPU).fit_schema(2, d)
    want = ref.CountSketch(k, random_state=seed, backend="numpy").fit_schema(2, d)
    assert port.seed_ == want.seed_
    np.testing.assert_array_equal(port.h_, want.h_)
    np.testing.assert_array_equal(port.s_, want.s_)
    assert port.h_.dtype == np.int32 and port.s_.dtype == np.int8


@pytest.mark.parametrize("use_mxu", [None, False])
def test_dense_routes_match_the_reference(use_mxu):
    X = np.random.default_rng(0).normal(size=(40, 300)).astype(np.float32)
    cs = CountSketch(64, random_state=0, backend_options=CPU,
                     use_mxu=use_mxu).fit(X)
    assert cs._mxu_route() is (use_mxu is None)
    y = cs.transform(X)
    assert y.dtype == np.float32
    np.testing.assert_allclose(y, _ref(64, X).transform(X), **TOL)


def test_scatter_above_the_mask_cap(monkeypatch):
    monkeypatch.setattr(CountSketch, "_MXU_MASK_BYTES_CAP", 1024)
    X = np.random.default_rng(0).normal(size=(20, 300)).astype(np.float32)
    cs = CountSketch(16, random_state=0, backend_options=CPU).fit(X)
    assert not cs._mxu_route()
    np.testing.assert_allclose(cs.transform(X), _ref(16, X).transform(X), **TOL)


def test_float64_and_numpy_backend_are_exact():
    X = np.random.default_rng(1).normal(size=(30, 500))
    Xs = _sparse(dtype=np.float64, d=500)
    for backend, opts in (("torch", CPU), ("numpy", None)):
        cs = CountSketch(32, random_state=0, backend=backend,
                         backend_options=opts).fit(X)
        np.testing.assert_array_equal(cs.transform(X), _ref(32, X).transform(X))
        np.testing.assert_array_equal(cs.transform(Xs), _ref(32, Xs).transform(Xs))
    X32 = X.astype(np.float32)
    cs = CountSketch(32, random_state=0, backend="numpy").fit(X32)
    np.testing.assert_array_equal(cs.transform(X32), _ref(32, X32).transform(X32))


# the port's one CSR route on the batch shapes the reference sends down
# each of its two: low skew (doc-major) and one row 10x the others (flat)
@pytest.mark.parametrize("route", ["docmajor", "flat"])
def test_csr_routes_match_the_reference(route):
    Xs = _sparse()
    if route == "flat":
        X = Xs.toarray()
        X[7] = np.random.default_rng(8).normal(size=X.shape[1])
        Xs = sp.csr_array(X)
    cs = CountSketch(32, random_state=0, backend_options=CPU).fit(Xs)
    assert cs._csr_on_device(Xs)
    assert _ref(32, Xs)._csr_route(Xs)[0] == route
    want = _ref(32, Xs).transform(Xs)
    y = cs.transform(Xs)
    assert y.dtype == np.float32
    np.testing.assert_allclose(y, want, **TOL)
    b = cs.prepare_batch(Xs)
    assert isinstance(b, sk.DeviceBatch) and len(b.arrays[0]) == Xs.nnz
    assert b.shape == Xs.shape
    np.testing.assert_allclose(cs._transform_async(b).numpy(), want, **TOL)
    empty = sp.csr_array(np.zeros((4, 400), np.float32))
    np.testing.assert_array_equal(cs.transform(empty), np.zeros((4, 32)))


def test_csr_at_the_hash_space_width():
    d, n, per = 1 << 20, 16, 50
    rng = np.random.default_rng(6)
    Xs = sp.csr_array(
        (rng.normal(size=n * per).astype(np.float32),
         rng.integers(0, d, size=n * per).astype(np.int32),
         np.arange(0, n * per + 1, per)), shape=(n, d))
    cs = CountSketch(256, random_state=0, backend_options=CPU).fit_schema(n, d)
    assert cs._csr_on_device(Xs)
    np.testing.assert_allclose(cs.transform(Xs), _ref(256, Xs).transform(Xs),
                               **TOL)


@pytest.mark.parametrize("p", [1, 3, 8])
def test_flat_layout_equals_the_reference(p):
    """The port's layout is the reference's over ``p`` token-balanced row
    ranges, each range's tokens in order with its row offset added back."""
    Xs = _sparse(n=50, seed=9, cut=0.5)
    got = sk._flat_layout(Xs)
    rows, idx, vals, rows_blk, _, perm = ref_sk._flat_mesh_layout(Xs, p)
    rng_of = perm // rows_blk
    want = ([], [], [])
    for r in range(p):
        members = np.flatnonzero(rng_of == r)
        if members.size == 0:
            continue
        r0, r1 = members[0], members[-1] + 1
        c = int(Xs.indptr[r1] - Xs.indptr[r0])
        want[0].append(rows[r, :c] + r0)
        want[1].append(idx[r, :c])
        want[2].append(vals[r, :c])
        assert not vals[r, c:].any()  # the reference's padding
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.concatenate(w).astype(g.dtype))


def test_use_mxu_semantics():
    X = np.random.default_rng(0).normal(size=(20, 300)).astype(np.float32)
    cs = CountSketch(16, random_state=0, backend_options=CPU, use_mxu=True).fit(X)
    with pytest.raises(ValueError, match="float64"):
        cs.transform(X.astype(np.float64))
    with pytest.raises(ValueError, match="sparse"):
        cs.transform(sp.csr_array(X))
    assert cs.prepare_batch(sp.csr_array(X)) is not None
    with pytest.raises(ValueError, match="requires the torch backend"):
        CountSketch(16, random_state=0, backend="numpy", use_mxu=True).fit(X)
    big = CountSketch(16, random_state=0, backend_options=CPU, use_mxu=True)
    big._MXU_MASK_BYTES_CAP = 1024
    big.fit(X)
    with pytest.raises(ValueError, match="use_mxu=True"):
        big.transform(X)
    auto = CountSketch(16, random_state=0, backend_options=CPU).fit(X)
    auto.transform(X)
    assert "_dev_mask" in auto.__dict__
    auto.set_params(use_mxu=False)
    assert "_dev_mask" not in auto.__dict__ and not auto._mxu_route()
    np.testing.assert_allclose(auto.transform(X), _ref(16, X).transform(X), **TOL)
    assert CountSketch(16, use_mxu=False).get_params()["use_mxu"] is False


def test_validation_and_the_card_default(monkeypatch):
    import torch

    with pytest.raises(ValueError):
        CountSketch(0)
    # mesh= is ported (A10b, PR 14): a mesh that is not a parallel.Mesh is
    # refused at fit, where the sketch resolves its devices
    with pytest.raises(ValueError, match="parallel.Mesh"):
        CountSketch(8, mesh=object()).fit_schema(2, 4)
    with pytest.raises(NotFittedError):
        CountSketch(8, backend_options=CPU).transform(np.ones((2, 4)))
    cs = CountSketch(8, random_state=0, backend_options=CPU).fit_schema(10, 16)
    with pytest.raises(ValueError, match="features"):
        cs.transform(np.ones((2, 5)))
    with pytest.raises(ValueError, match="components"):
        cs.inverse_transform(np.ones((2, 5)))
    with pytest.raises(ValueError, match="backend_options"):
        CountSketch(8, backend_options={"precision": "x"}).fit_schema(2, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device"):
        CountSketch(8).fit_schema(2, 4)


def test_decode_and_names_equal_the_reference():
    X = np.random.default_rng(2).normal(size=(3, 64)).astype(np.float32)
    cs = CountSketch(32, random_state=4, backend_options=CPU).fit(X)
    r = _ref(32, X, seed=4)
    Y = r.transform(X)
    np.testing.assert_array_equal(cs.inverse_transform(Y), r.inverse_transform(Y))
    np.testing.assert_array_equal(cs.get_feature_names_out(),
                                  r.get_feature_names_out())


def _read_tokens(vocab, seed=3):
    def read(lo, hi):
        rng = np.random.default_rng([seed, lo])
        counts = rng.integers(0, 12, size=hi - lo)
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        return vocab[rng.integers(0, vocab.size, size=int(indptr[-1]))], indptr
    return read


def test_token_source_batches_equal_the_reference():
    vocab = np.asarray([f"w{i}" for i in range(500)])
    read = _read_tokens(vocab)
    kw = dict(n_features=1 << 12, input_type="string", dtype=np.float32)
    port = streaming.TokenSource(read, 100, h.FeatureHasher(**kw), batch_rows=32,
                                 hash_threads=2)
    want = ref_stream.TokenSource(read, 100, ref_h.FeatureHasher(**kw),
                                  batch_rows=32)
    assert port.schema() == want.schema()
    for start in (0, 64):
        pairs = list(zip(port.iter_batches(start), want.iter_batches(start)))
        assert len(pairs) == -(-(100 - start) // 32)
        for (lo, g), (wlo, w) in pairs:
            assert lo == wlo
            np.testing.assert_array_equal(g.toarray(), w.toarray())
    with pytest.raises(ValueError, match="hash_threads"):
        streaming.TokenSource(read, 100, h.FeatureHasher(**kw), hash_threads=0)

    def bad(lo, hi):
        return np.asarray(["a"]), np.array([0, 1])

    with pytest.raises(ValueError, match="indptr must be local"):
        next(streaming.TokenSource(bad, 10, h.FeatureHasher(**kw),
                                   batch_rows=5).iter_batches())


def test_stream_over_tokens_matches_the_reference_and_resumes(tmp_path):
    vocab = np.asarray([f"w{i}" for i in range(500)])
    kw = dict(n_features=1 << 12, input_type="string", dtype=np.float32)
    src = streaming.TokenSource(_read_tokens(vocab), 100, h.FeatureHasher(**kw),
                                batch_rows=32)
    cs = CountSketch(64, random_state=1, backend_options=CPU).fit_source(src)
    got = streaming.stream_to_array(cs, src)
    rsrc = ref_stream.TokenSource(_read_tokens(vocab), 100,
                                  ref_h.FeatureHasher(**kw), batch_rows=32)
    r = ref.CountSketch(64, random_state=1, backend="numpy").fit_source(rsrc)
    want = ref_stream.stream_to_array(r, rsrc)
    np.testing.assert_allclose(got, want, **TOL)
    ckpt = str(tmp_path / "c.json")
    it = cs.transform_stream(src, checkpoint_path=ckpt)
    first = [next(it), next(it), next(it)]  # the third acks the first two
    it.close()
    rest = list(cs.transform_stream(src, checkpoint_path=ckpt))
    assert [lo for lo, _ in rest] == [64, 96]
    out = np.concatenate([y for _, y in first[:2] + rest])
    np.testing.assert_array_equal(out, got)


def test_model_file_crosses_both_ways(tmp_path):
    X = np.random.default_rng(3).normal(size=(10, 90)).astype(np.float32)
    path = str(tmp_path / "cs.json")
    port = CountSketch(24, random_state=9, backend_options=CPU,
                       use_mxu=False).fit(X)
    ser.save_model(port, path)
    back = ref_ser.load_model(path, backend="numpy")
    np.testing.assert_array_equal(back.h_, port.h_)
    assert back.use_mxu is False
    np.testing.assert_allclose(port.transform(X), back.transform(X), **TOL)
    r = ref.CountSketch(24, random_state=11, backend="numpy").fit(X)
    ref_ser.save_model(r, path)
    got = ser.load_model(path, backend_options=CPU)
    assert isinstance(got, CountSketch) and got.seed_ == 11
    np.testing.assert_array_equal(got.s_, r.s_)
    np.testing.assert_allclose(got.transform(X), r.transform(X), **TOL)
    host = ser.load_model(path, backend="numpy")
    np.testing.assert_array_equal(host.transform(X), r.transform(X))
