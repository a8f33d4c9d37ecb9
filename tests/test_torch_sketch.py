"""The port's config-4 serving path against the JAX package, on the CPU.

``SimHashIndex.query_topk`` (the kernel's plain version serves on the CPU)
is held bit for bit, distance and id, to the reference's
``SimHashIndex(topk_impl='scan')`` (XLA, bit-identical to the reference's
fused route by that package's own tests) and to ``topk_bruteforce``:
several chunks, tombstones before and after ``compact``, ragged
``n_bits``, tie-heavy corpora, ``m`` above the live codes, multi-tile
queries with a ragged last tile, wide rows and ``m`` past the kernel's
``MAX_M`` (which the plain version serves on the CPU).
``SignRandomProjection`` codes, ``TopKServer`` and the telemetry core are
held to the reference as well.
"""

import threading

import numpy as np
import pytest
import torch

import randomprojection_tpu as ref
import randomprojection_tpu_torch as port
from randomprojection_tpu.models import sketch as ref_sk
from randomprojection_tpu.utils import telemetry as ref_tel
from randomprojection_tpu_torch.models import sketch as sk
from randomprojection_tpu_torch.ops import topk_kernels as tk
from randomprojection_tpu_torch.utils import telemetry as tel

CPU = {"device": "cpu"}


def _codes(rows, nb, seed):
    return np.random.default_rng(seed).integers(0, 256, size=(rows, nb),
                                                dtype=np.uint8)


def _same(got, *wants):
    for want in wants:
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def _masked_brute(A, B, m, dead_ids):
    D = ref_sk.pairwise_hamming(A, B).astype(np.int64)
    D[:, np.asarray(dead_ids, dtype=np.int64)] = B.shape[1] * 8 + 1
    return ref_sk._host_topk_select(D, m)


# -- the index --------------------------------------------------------------------


def _chunked_pair(parts, **kw):
    p = sk.SimHashIndex(parts[0], device="cpu", **kw)
    r = ref_sk.SimHashIndex(parts[0], topk_impl="scan", **kw)
    for part in parts[1:]:
        p.add(part)
        r.add(part)
    return p, r


@pytest.mark.parametrize("m,tile", [(11, 16), (900, 50)])  # 900 > n_live
def test_query_topk_chunks_tombstones_ragged_tile(m, tile):
    parts = [_codes(n, 8, 5 + n) for n in (500, 37, 300)]
    B = np.concatenate(parts)
    A = _codes(45, 8, 99)
    p, r = _chunked_pair(parts)
    dead = [0, 17, 499, 520, 700]  # every chunk touched
    assert p.delete(dead) == r.delete(dead) == 5
    assert p.delete([17, 17]) == 0 and p.n_live == r.n_live == 832
    got = p.query_topk(A, m, tile=tile)
    assert got[0].shape == (45, min(m, 832)) and got[0].dtype == np.int32
    _same(got, r.query_topk(A, m, tile=tile),
          _masked_brute(A, B, min(m, 832), dead))
    assert not np.isin(got[1], dead).any()


def test_query_topk_tie_heavy_corpus():
    rng = np.random.default_rng(9)
    basis = rng.integers(0, 256, size=(3, 16), dtype=np.uint8)
    B = basis[rng.integers(0, 3, 700)]
    A = basis[rng.integers(0, 3, 24)]
    p, r = _chunked_pair([B[:300], B[300:]])
    _same(p.query_topk(A, 25, tile=10), r.query_topk(A, 25, tile=10),
          ref_sk.topk_bruteforce(A, B, 25))


def test_query_topk_ragged_bits():
    B, A = _codes(1025, 4, 3), _codes(17, 4, 4)
    B[:, -1] &= 0x07  # 27 bits in 4 bytes: pad bits zero
    A[:, -1] &= 0x07
    p, r = _chunked_pair([B], n_bits=27)
    assert p.n_bits == 27
    _same(p.query_topk(A, 7), r.query_topk(A, 7),
          ref_sk.topk_bruteforce(A, B, 7))
    np.testing.assert_allclose(p.query_cosine(A), r.query_cosine(A))


def test_compact_keeps_results_through_the_mapping():
    parts = [_codes(n, 8, n) for n in (400, 250)]
    A = _codes(30, 8, 77)
    p, r = _chunked_pair(parts)
    dead = np.arange(3, 650, 7)
    p.delete(dead)
    r.delete(dead)
    before = p.query_topk(A, 9)
    mapping = p.compact()
    np.testing.assert_array_equal(mapping, r.compact())
    assert len(p._chunks) == 1 and p.n_deleted == 0 and p.n_codes == 650 - len(dead)
    after = p.query_topk(A, 9)
    np.testing.assert_array_equal(after[0], before[0])
    np.testing.assert_array_equal(mapping[after[1]], before[1])
    _same(after, r.query_topk(A, 9))


def test_query_and_device_hamming_match_reference():
    parts = [_codes(200, 8, 1), _codes(33, 8, 2)]
    A = _codes(40, 8, 3)
    p, _ = _chunked_pair(parts)
    want = ref_sk.pairwise_hamming(A, np.concatenate(parts))
    np.testing.assert_array_equal(p.query(A, tile=16), want)
    np.testing.assert_array_equal(
        sk.pairwise_hamming_device(A, np.concatenate(parts), device="cpu"), want)
    np.testing.assert_array_equal(sk.pairwise_hamming(A), ref_sk.pairwise_hamming(A))
    np.testing.assert_allclose(sk.cosine_from_hamming(want, 64),
                               ref_sk.cosine_from_hamming(want, 64))


@pytest.mark.parametrize("rows,nb,nq,m", [(40, 4096, 3, 6),       # 2^15-bit rows
                                         (1500, 8, 5, tk.MAX_M + 76)])
def test_cpu_index_wide_rows_and_m_past_the_kernel(rows, nb, nq, m):
    B, A = _codes(rows, nb, 31), _codes(nq, nb, 32)
    p, r = _chunked_pair([B])
    _same(p.query_topk(A, m), r.query_topk(A, m), ref_sk.topk_bruteforce(A, B, m))


def test_card_index_refuses_m_past_the_kernel():
    idx = sk.SimHashIndex(_codes(1500, 8, 1), device="cpu")
    idx.device = torch.device("cuda", 0)  # refused before any dispatch
    with pytest.raises(ValueError, match=f"MAX_M={tk.MAX_M}"):
        idx.query_topk(_codes(2, 8, 2), tk.MAX_M + 1)


def test_index_checks_and_later_slices():
    codes = _codes(16, 8, 0)
    for kw, item in (({"mesh": object()}, "A10"),
                     ({"hbm_budget_bytes": 1 << 20}, "A12"),
                     ({"cold_tier": "disk"}, "A12")):
        with pytest.raises(ValueError, match=f"ROADMAP {item}"):
            sk.SimHashIndex(codes, device="cpu", **kw)
    idx = sk.SimHashIndex(codes, device="cpu", label="shard-3")
    for call in (lambda: idx.save("x"), lambda: sk.SimHashIndex.load("x")):
        with pytest.raises(ValueError, match="ROADMAP A9"):
            call()
    idx.n_codes = 2**31 - 10  # a near-capacity index refuses to grow
    with pytest.raises(ValueError, match="'shard-3'.*2\\*\\*31"):
        idx.add(codes)
    assert idx.n_codes == 2**31 - 10
    idx = sk.SimHashIndex(codes, device="cpu")
    with pytest.raises(ValueError, match="queries must be"):
        idx.query_topk(np.zeros((2, 3), np.uint8), 2)
    with pytest.raises(ValueError, match="codes must be"):
        idx.add(np.zeros((2, 3), np.uint8))
    with pytest.raises(ValueError, match="m must be"):
        idx.query_topk(codes, 0)
    with pytest.raises(ValueError, match="delete ids"):
        idx.delete([16])
    idx.delete(np.arange(16))
    with pytest.raises(ValueError, match="all deleted"):
        idx.query_topk(codes, 2)
    # a uint8 tensor is kept as given, and answers like the array
    t = sk.SimHashIndex(torch.from_numpy(codes), device="cpu")
    _same(t.query_topk(torch.from_numpy(codes[:4]), 3),
          ref_sk.topk_bruteforce(codes[:4], codes, 3))


def test_cpu_index_counts_no_kernel_launch():
    tk.reset_launches()
    sk.SimHashIndex(_codes(64, 8, 1), device="cpu").query_topk(_codes(4, 8, 2), 3)
    assert not any(tk.LAUNCHES.values())


def test_no_card_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="none is available.*device='cpu'"):
        sk.SimHashIndex(_codes(8, 4, 0))
    with pytest.raises(RuntimeError, match="none is available"):
        port.SignRandomProjection(16).fit(np.zeros((4, 32), np.float32))
    with pytest.raises(RuntimeError, match="none is available"):
        sk.pairwise_hamming_device(_codes(4, 4, 1))


# -- SignRandomProjection -----------------------------------------------------------


@pytest.mark.parametrize("k", [20, 256])
def test_numpy_backend_codes_bit_identical_to_reference(k):
    X = np.random.default_rng(1).normal(size=(60, 96)).astype(np.float32)
    a = ref.SignRandomProjection(k, random_state=3, backend="numpy").fit_transform(X)
    b = port.SignRandomProjection(k, random_state=3, backend="numpy").fit_transform(X)
    assert b.dtype == np.uint8 and b.shape == (60, -(-k // 8))
    np.testing.assert_array_equal(a, b)


def _near_zero_only(got, want, y64):
    """Bits may differ only where |y| ≤ 1e-5·max|y| in float64: the two
    packages sum the float32 products in another order."""
    diff = np.unpackbits(got ^ want, axis=1, bitorder="little")[:, : y64.shape[1]]
    tiny = np.abs(y64) <= 1e-5 * np.abs(y64).max()
    assert not (diff.astype(bool) & ~tiny).any()
    return int(diff.sum())


def test_reference_sign_model_carried_across_gives_the_same_codes():
    X = np.random.default_rng(2).normal(size=(2048, 768)).astype(np.float32)
    est = ref.SignRandomProjection(256, random_state=7).fit(X)
    want = np.asarray(est.transform(X))
    R = est.components_as_numpy()
    mine = port.from_reference(est.spec_.to_dict(), R,
                               backend_options=CPU, estimator="sign")
    assert isinstance(mine, port.SignRandomProjection)
    got = mine.transform(X)
    assert got.dtype == np.uint8 and got.shape == (2048, 32)
    y64 = X.astype(np.float64) @ np.asarray(R, np.float64).T
    assert _near_zero_only(got, want, y64) <= 2048 * 256 * 1e-4
    # a tensor in gives a tensor out
    t = mine.transform(torch.from_numpy(X[:8]))
    assert isinstance(t, torch.Tensor) and t.dtype == torch.uint8
    np.testing.assert_array_equal(t.numpy(), got[:8])


def test_from_reference_estimator_checks():
    spec = ref.SparseRandomProjection(8, density=0.5, random_state=0,
                                      backend="numpy").fit(np.zeros((4, 16)))
    d = spec.spec_.to_dict()
    with pytest.raises(ValueError, match="holds a 'gaussian' spec"):
        port.from_reference(d, np.zeros((8, 16)), backend_options=CPU,
                            estimator="sign")
    with pytest.raises(NotImplementedError, match="estimator='sign'"):
        port.from_reference(d, np.zeros((8, 16)), backend_options=CPU,
                            estimator="countsketch")


def test_torch_cpu_codes_are_the_signs_of_the_model_and_stream():
    from randomprojection_tpu_torch import streaming

    X = np.random.default_rng(4).normal(size=(300, 64)).astype(np.float32)
    est = port.SignRandomProjection(20, random_state=5,
                                    backend_options=CPU).fit(X)
    codes = est.transform(X)
    assert codes.shape == (300, 3) and codes.dtype == np.uint8
    y64 = X.astype(np.float64) @ est.components_as_numpy().astype(np.float64).T
    want = np.packbits(y64 > 0, axis=1, bitorder="little")
    _near_zero_only(codes, want, y64)
    # pad bits of the ragged last byte are zero
    assert not (codes[:, -1] & 0xF0).any()
    src = streaming.ArraySource(X, batch_rows=64)
    np.testing.assert_array_equal(streaming.stream_to_array(est, src), codes)
    with pytest.raises(NotImplementedError, match="no inverse"):
        est.inverse_transform(codes)


# -- TopKServer ----------------------------------------------------------------------


def _serving_fixture(n_codes=3000, nq=960, seed=0):
    idx = sk.SimHashIndex(_codes(n_codes, 8, seed), device="cpu")
    idx.add(_codes(300, 8, seed + 1))
    return idx, _codes(nq, 8, seed + 2)


def test_server_threaded_clients_bit_identical():
    idx, q = _serving_fixture()
    want = idx.query_topk(q, 3)
    out = {}
    with sk.TopKServer(idx, 3, max_batch=512, max_delay_s=0.01,
                       name="torch-test-threads") as srv:
        def client(ci):
            futs = [(o, srv.submit(q[o: o + 32], label=f"c{ci}"))
                    for o in range(ci * 240, (ci + 1) * 240, 32)]
            out[ci] = [(o, f.result(timeout=60)) for o, f in futs]

        threads = [threading.Thread(target=client, args=(ci,)) for ci in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        d1, i1 = srv.query(q[0])  # a 1-D code is one row
        st = srv.stats()
    rows = 1
    for ci in range(4):
        for o, (d, i) in out[ci]:
            np.testing.assert_array_equal(d, want[0][o: o + 32])
            np.testing.assert_array_equal(i, want[1][o: o + 32])
            rows += d.shape[0]
    np.testing.assert_array_equal(d1, want[0][:1])
    assert st["requests"] == 4 * 8 + 1 and st["queries"] == rows
    assert st["latency"]["count"] == st["requests"]
    assert tel.registry().hist_quantiles(
        "serve.latency.torch-test-threads.client.c0")["count"] == 8


def test_server_lifecycle_and_validation():
    idx, q = _serving_fixture(n_codes=200, nq=8)
    for kw, match in (({"m": 0}, "m must be"), ({"max_batch": 0}, "max_batch"),
                      ({"max_delay_s": -1}, "max_delay_s"),
                      ({"max_pending": 0}, "max_pending"),
                      ({"probe_policy": {"a": 1}}, "LSH-tier index")):
        with pytest.raises(ValueError, match=match):
            sk.TopKServer(idx, **({"m": 2} | kw))
    srv = sk.TopKServer(idx, 2, max_delay_s=0.0)
    with pytest.raises(ValueError, match="queries must be"):
        srv.submit(np.zeros((2, 3), np.uint8))
    with pytest.raises(ValueError, match="empty request"):
        srv.submit(np.zeros((0, 8), np.uint8))
    fut = srv.submit(q[:4])
    srv.close()  # drains what was submitted
    assert fut.result(timeout=60)[0].shape == (4, 2)
    for call in (lambda: srv.submit(q[:1]), srv.start):
        with pytest.raises(RuntimeError, match="server closed"):
            call()
    srv.close()  # idempotent
    assert not [t for t in threading.enumerate() if t.name.startswith("rp-topk")]


def test_server_bounded_queue_rejects_when_stalled():
    idx, q = _serving_fixture(n_codes=200, nq=8)
    srv = sk.TopKServer(idx, 2, max_pending=2, start=False)
    f1, f2 = srv.submit(q[:1]), srv.submit(q[:1])
    n0 = tel.registry().counter("serve.topk.rejects")
    with pytest.raises(RuntimeError, match="queue is full"):
        srv.submit(q[:1])
    assert tel.registry().counter("serve.topk.rejects") == n0 + 1
    srv.close()  # the sentinel's slot is reserved: returns at once
    assert not f1.done() and not f2.done()


class _Boom:
    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def query_topk(self, *a, **k):
        raise RuntimeError("device exploded")


def test_server_failed_dispatch_emits_error_event(tmp_path):
    idx, q = _serving_fixture(n_codes=200, nq=8)
    srv = sk.TopKServer(idx, 2, start=False)
    srv.index = _Boom(idx)
    path = str(tmp_path / "serve.jsonl")
    n0 = tel.registry().counter("serve.topk.errors")
    tel.configure(path)
    try:
        srv.start()
        with pytest.raises(RuntimeError, match="device exploded"):
            srv.submit(q[:4]).result(timeout=60)
        srv.close()
    finally:
        tel.shutdown()
    evs = [e for e in ref_tel.read_events(path) if e["event"] == "serve.topk.error"]
    assert len(evs) == 1 and "device exploded" in evs[0]["error"]
    assert tel.registry().counter("serve.topk.errors") == n0 + 1


# -- the telemetry core --------------------------------------------------------------


def test_event_names_equal_the_reference():
    assert tel._EVENT_NAMES == ref_tel._EVENT_NAMES
    assert tel.EVENTS.FAMILIES == ref_tel.EVENTS.FAMILIES
    assert tel.SUPPORTED_SCHEMA_VERSIONS == ref_tel.SUPPORTED_SCHEMA_VERSIONS


@pytest.mark.parametrize("n", [0, 1, 2, 500])
def test_hist_quantiles_equal_the_reference(n):
    obs = np.random.default_rng(n).lognormal(-7, 2, size=n)
    mine, theirs = tel.MetricsRegistry(), ref_tel.MetricsRegistry()
    for v in obs:
        mine.observe("h", float(v))
        theirs.observe("h", float(v))
    if n:
        assert mine.hist_quantiles("h") == theirs.hist_quantiles("h")
    else:
        assert mine.hist_quantiles("h") is None
    assert tel.quantiles_from_buckets({}, 0, 0.0) == \
        ref_tel.quantiles_from_buckets({}, 0, 0.0)


def test_event_log_parses_with_the_reference_reader(tmp_path):
    idx, q = _serving_fixture(n_codes=500, nq=64)
    path = str(tmp_path / "events.jsonl")
    tel.configure(path)
    try:
        idx.query_topk(q, 4, tile=32)
        with sk.TopKServer(idx, 4, name="torch-test-log") as srv:
            srv.query(q[:5], label="x y")
        idx.delete([1])
        idx.compact()
    finally:
        tel.shutdown()
    events = list(ref_tel.read_events(path))
    names = {e["event"] for e in events}
    assert {"simhash.topk_tile", "topk.kernel.dispatch", "serve.topk_batch",
            "serve.latency.request", "index.compact"} <= names
    assert all(ref_tel.registered_event(n) for n in names)
    tiles = [e for e in events if e["event"] == "simhash.topk_tile"]
    assert len(tiles) == 3 and tiles[0]["chunks"] == 2  # 2 tiles + 1 batch
    lat = [e for e in events if e["event"] == "serve.latency.request"]
    assert lat[0]["label"] == "x_y" and lat[0]["rows"] == 5
