"""The port's multi-probe LSH tier (``ann/lsh.py``) against the JAX package,
on the CPU.

The host half (band keys, probe masks, ``BandPlan``, ``BandedBuckets`` with
its incremental merge and compact remap, ``_merge_topm_rows``) is held to
the reference bit for bit.  ``LSHSimHashIndex(device='cpu')`` is held to
the reference's host-path index (``probe_path='host'``; its own
device-probe path cannot run here, see tests/test_torch_probe.py) in a few
calls, since each new shape costs the reference seconds through its
interpreted top-k kernel, and to ``_model_topk`` (the reference's buckets,
probe masks and host selection applied tile by tile) everywhere else.
In the port, the device rung (``probe_path='device'``: K5's plain version,
the dedup, the gather and K4's plain version) equals the host rung.
"""

import threading

import numpy as np
import pytest
import torch

from randomprojection_tpu.ann import lsh as ref_lsh
from randomprojection_tpu.models import sketch as ref_sk
from randomprojection_tpu.utils import telemetry as ref_tel
from randomprojection_tpu_torch.ann import lsh
from randomprojection_tpu_torch.models import sketch as sk
from randomprojection_tpu_torch.ops import probe_kernels as pk
from randomprojection_tpu_torch.ops import topk_kernels as tk
from randomprojection_tpu_torch.utils import telemetry as tel

NB, M, TILE = 8, 5, 8
BANDS = dict(bands=4, band_bits=4)
FULL = 1 << 4


def _codes(rows, nb=NB, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(rows, nb),
                                                dtype=np.uint8)


def _planted(rows, nq, seed, *, nb=NB, flips=3):
    """Codes in clusters of 8 around random centres and queries near
    centres: partial probes then find real neighbours."""
    rng = np.random.default_rng(seed)
    centres = rng.integers(0, 256, size=(rows // 8, nb), dtype=np.uint8)

    def noisy(rows_):
        out = rows_.copy()
        for _ in range(flips):
            pos = rng.integers(0, nb * 8, size=out.shape[0])
            out[np.arange(out.shape[0]), pos >> 3] ^= (1 << (pos & 7)).astype(np.uint8)
        return out

    codes = noisy(np.repeat(centres, 8, axis=0))
    return codes, noisy(centres[rng.integers(0, centres.shape[0], nq)])


def _masked_brute(A, B, m, dead_ids=()):
    D = ref_sk.pairwise_hamming(A, B).astype(np.int64)
    D[:, np.asarray(dead_ids, dtype=np.int64)] = B.shape[1] * 8 + 1
    return ref_sk._host_topk_select(D, m)


def _model_topk(codes, A, m, *, tile, probes, bands, band_bits, dead=(),
                density=1.0, n_bits=None):
    """The host rung's answer from the reference's parts: per tile, the
    candidate union of ``BandedBuckets.candidates`` less tombstones,
    re-ranked by a host brute force, or the exact answer when the union is
    starved or denser than ``density``.  Returns ``(dist, idx, tiles that
    fell back)``."""
    n_bits = codes.shape[1] * 8 if n_bits is None else n_bits
    plan = ref_lsh.BandPlan(n_bits, bands=bands, band_bits=band_bits)
    b = ref_lsh.BandedBuckets(plan)
    b.add(codes)
    masks = ref_lsh.probe_masks(band_bits, probes)
    is_dead = np.zeros(codes.shape[0], bool)
    is_dead[list(dead)] = True
    n_live = int((~is_dead).sum())
    m_eff = min(m, n_live)
    out_d = np.empty((A.shape[0], m_eff), np.int32)
    out_i = np.empty((A.shape[0], m_eff), np.int32)
    fallbacks = 0
    for lo in range(0, A.shape[0], tile):
        a = A[lo: lo + tile]
        cand, _ = b.candidates(ref_lsh.band_keys(a, plan), masks)
        cand = cand[~is_dead[cand]]
        if cand.size < m_eff or cand.size > density * n_live:
            fallbacks += 1
            d, i = _masked_brute(a, codes, m_eff, np.flatnonzero(is_dead))
        else:
            d, loc = ref_sk._host_topk_select(
                ref_sk.pairwise_hamming(a, codes[cand]), m_eff)
            i = cand[loc]
        out_d[lo: lo + tile], out_i[lo: lo + tile] = d, i
    return out_d, out_i, fallbacks


def _same(got, *wants):
    for want in wants:
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def _both_rungs(idx, A, m, **kw):
    host = idx.query_topk(A, m, probe_path="host", **kw)
    dev = idx.query_topk(A, m, probe_path="device", **kw)
    _same(dev, host)
    return host


# -- the host half ---------------------------------------------------------------


@pytest.mark.parametrize("n,nb,n_bits,bands,b", [
    (50, 8, 64, 4, 8), (37, 3, 20, 2, 10), (9, 32, 256, 8, 16),
    (70_000, 8, 64, 3, 20), (25, 8, 61, 6, 10), (5, 4, 32, None, None),
])
def test_band_keys_equal_the_reference(n, nb, n_bits, bands, b):
    codes = _codes(n, nb, seed=n)
    plan = lsh.BandPlan(n_bits, bands=bands, band_bits=b)
    rplan = ref_lsh.BandPlan(n_bits, bands=bands, band_bits=b)
    assert (plan.bands, plan.band_bits) == (rplan.bands, rplan.band_bits)
    got = lsh.band_keys(codes, plan)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, ref_lsh.band_keys(codes, rplan))


@pytest.mark.parametrize("b,probes", [(4, 1), (4, 3), (4, 16), (4, 999),
                                      (8, 37), (16, 20), (1, 5), (20, 300)])
def test_probe_masks_equal_the_reference(b, probes):
    got = lsh.probe_masks(b, probes)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, ref_lsh.probe_masks(b, probes))


@pytest.mark.parametrize("args,kw", [
    ((256,), {}), ((64,), {}), ((8,), {}), ((20,), {"bands": 3, "band_bits": 8}),
    ((64,), {"band_bits": 0}), ((64,), {"band_bits": 24}), ((0,), {}),
    ((64,), {"bands": 0, "band_bits": 4}),
])
def test_band_plan_equals_the_reference(args, kw):
    try:
        want = ref_lsh.BandPlan(*args, **kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            lsh.BandPlan(*args, **kw)
        assert str(got.value) == str(e)
        return
    got = lsh.BandPlan(*args, **kw)
    assert (got.n_bits, got.bands, got.band_bits) == (
        want.n_bits, want.bands, want.band_bits)
    assert got == lsh.BandPlan(*args, **kw)


def _assert_buckets_equal(got, want):
    assert got.n == want.n
    np.testing.assert_array_equal(got.keys, want.keys)
    for j in range(want.plan.bands):
        np.testing.assert_array_equal(got._indptr[j], want._indptr[j])
        np.testing.assert_array_equal(got._ids[j], want._ids[j])


@pytest.mark.parametrize("splits,bands,b", [((37, 37, 200, 300), 4, 8),
                                            ((1, 500), 2, 3), ((250, 500), 8, 1)])
def test_buckets_incremental_add_and_from_keys_equal_the_reference(splits, bands,
                                                                   b):
    codes = _codes(splits[-1], seed=b)
    got = lsh.BandedBuckets(lsh.BandPlan(64, bands=bands, band_bits=b))
    want = ref_lsh.BandedBuckets(ref_lsh.BandPlan(64, bands=bands, band_bits=b))
    lo = 0
    for hi in splits:
        assert got.add(codes[lo:hi]) == want.add(codes[lo:hi]) == hi - lo
        lo = hi
    _assert_buckets_equal(got, want)
    fresh = lsh.BandedBuckets.from_keys(got.plan, got.keys)
    _assert_buckets_equal(fresh, want)
    qk = lsh.band_keys(codes[:9] ^ np.uint8(3), got.plan)
    masks = lsh.probe_masks(b, 3)
    c1, g1 = got.candidates(qk, masks)
    c2, g2 = want.candidates(qk, masks)
    np.testing.assert_array_equal(c1, c2)
    assert g1 == g2 and c1.dtype == np.int32
    np.testing.assert_array_equal(got.bucket_ids(0, int(qk[0, 0])),
                                  want.bucket_ids(0, int(qk[0, 0])))
    # compact's remap: surviving rows keep their keys, renumbered
    mapping = np.flatnonzero(np.arange(codes.shape[0]) % 3 != 1)
    _assert_buckets_equal(
        lsh.BandedBuckets.from_keys(got.plan, got.keys[:, mapping]),
        ref_lsh.BandedBuckets.from_keys(want.plan, want.keys[:, mapping]))
    with pytest.raises(ValueError, match="keys must be"):
        lsh.BandedBuckets.from_keys(got.plan, got.keys[:1])


def test_candidates_of_empty_buckets():
    b = lsh.BandedBuckets(lsh.BandPlan(16, bands=2, band_bits=8))
    b.add(np.zeros((5, 2), np.uint8))
    cand, gathered = b.candidates(np.full((2, 3), 200, np.uint32),
                                  lsh.probe_masks(8, 2))
    assert cand.size == 0 and cand.dtype == np.int32 and gathered == 0


@pytest.mark.parametrize("m,seed", [(1, 0), (5, 1), (12, 2)])
def test_merge_topm_rows_equals_the_reference(m, seed):
    rng = np.random.default_rng(seed)
    sent = 65

    def plane():
        d = np.sort(rng.integers(0, 20, size=(30, m)), axis=1).astype(np.int32)
        g = rng.integers(0, 40, size=(30, m)).astype(np.int32)
        empty = rng.random((30, m)) < 0.2
        return np.where(empty, sent, d), np.where(empty, 2**31 - 1, g)

    bd, bg = plane()
    nd, ng = plane()
    nd[:5], ng[:5] = bd[:5], bg[:5]  # duplicates across the two rounds
    got = lsh._merge_topm_rows(bd, bg, nd, ng, sent)
    _same(got, ref_lsh._merge_topm_rows(bd, bg, nd, ng, sent))
    assert lsh._level_size(8, 3) == ref_lsh._level_size(8, 3) == 56


# -- the index against the reference's host-path index -----------------------------


def _ref_index(parts, **kw):
    r = ref_lsh.LSHSimHashIndex(parts[0], probe_path="host", topk_impl="scan",
                                **kw)
    for p in parts[1:]:
        r.add(p)
    return r


def _port_index(parts, **kw):
    p = lsh.LSHSimHashIndex(parts[0], device="cpu", **kw)
    for part in parts[1:]:
        p.add(part)
    return p


def test_partial_probes_chunks_tombstones_compact_equal_the_reference():
    codes, A = _planted(400, 24, 3)
    parts = [codes[:300], codes[300:]]
    kw = dict(BANDS, probes=3, fallback_density=1.0)
    ref, port = _ref_index(parts, **kw), _port_index(parts, **kw)
    dead = np.arange(280, 320)  # across the chunk seam
    assert ref.delete(dead) == port.delete(dead) == 40
    want = ref.query_topk(A, M, tile=TILE)
    _same(_both_rungs(port, A, M, tile=TILE), want,
          _model_topk(codes, A, M, tile=TILE, probes=3, dead=dead, **BANDS))
    # compact folds the remap through the buckets: equal through the mapping
    rmap, pmap = ref.compact(), port.compact()
    np.testing.assert_array_equal(pmap, rmap)
    got = _both_rungs(port, A, M, tile=TILE)
    _same(got, ref.query_topk(A, M, tile=TILE))
    np.testing.assert_array_equal(pmap[got[1]], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    assert len(port._chunks) == 1 and port._buckets.n == 360


def test_ragged_bits_and_full_coverage_equal_the_reference():
    codes = _codes(400, seed=4)
    codes[:, -1] &= 0x1F  # 61 real bits
    A = codes[:16] ^ np.uint8(2)
    kw = dict(n_bits=61, bands=6, band_bits=10, fallback_density=1.0)
    ref, port = _ref_index([codes], probes=2, **kw), _port_index([codes], probes=2, **kw)
    _same(_both_rungs(port, A, M, tile=TILE), ref.query_topk(A, M, tile=TILE),
          _model_topk(codes, A, M, tile=TILE, probes=2, bands=6, band_bits=10,
                      n_bits=61))
    # full coverage: brute force, the device rung included
    full = port.query_topk(A, M, tile=TILE, probes=1 << 10, probe_path="device")
    _same(full, _masked_brute(A, codes, M))


def test_fallback_ladder_equals_the_reference():
    codes = _codes(400, seed=5)
    A = _codes(16, seed=6)
    reg = tel.registry()
    for kw, reason in ((dict(bands=2, band_bits=2, fallback_density=0.05), "dense"),
                       (dict(bands=1, band_bits=16, fallback_density=1.0), "starved")):
        ref, port = _ref_index([codes], **kw), _port_index([codes], **kw)
        for path in ("host", "device"):
            f0 = reg.counter("index.lsh.fallbacks")
            got = port.query_topk(A, M, tile=TILE, probes=1, probe_path=path)
            assert reg.counter("index.lsh.fallbacks") - f0 == 2, reason
            _same(got, _masked_brute(A, codes, M))
        _same(got, ref.query_topk(A, M, tile=TILE, probes=1))


# -- the index against the model and brute force ------------------------------------


@pytest.mark.parametrize("probes,tile,m,density", [
    (1, 8, 5, 1.0), (2, 5, 3, 1.0), (5, 16, 7, 1.0), (3, 8, 5, 0.3),
    (1, 2, 3, 0.3), (9, 64, 5, 1.0), (16, 8, 5, 1.0),
])
def test_partial_probes_equal_the_model(probes, tile, m, density):
    codes, A = _planted(600, 40, probes + tile)
    idx = _port_index([codes[:250], codes[250:]], probes=probes,
                      fallback_density=density, **BANDS)
    dead = [0, 249, 250, 251, 599]
    idx.delete(dead)
    reg = tel.registry()
    f0 = reg.counter("index.lsh.fallbacks")
    got = _both_rungs(idx, A, m, tile=tile)
    want = _model_topk(codes, A, m, tile=tile, probes=probes, dead=dead,
                       density=density, **BANDS)
    _same(got, want)
    # each rung takes the ladder on the same tiles
    assert reg.counter("index.lsh.fallbacks") - f0 == 2 * want[2]


def test_full_coverage_and_add_after_construction_equal_brute_force():
    parts = [_codes(n, seed=n) for n in (200, 150, 50)]
    idx = _port_index(parts[:1], fallback_density=1.0, **BANDS)
    A = _codes(20, seed=7)
    for k in (2, 3):
        idx.add(parts[k - 1])
        codes = np.concatenate(parts[:k])
        _same(_both_rungs(idx, A, M, tile=TILE, probes=FULL),
              ref_sk.topk_bruteforce(A, codes, M))
        # probes past the bucket space clamp to full coverage
        _same(idx.query_topk(A, M, tile=TILE, probes=10**6),
              ref_sk.topk_bruteforce(A, codes, M))
    assert idx._buckets.n == 400 and len(idx._chunks) == 3
    _same(idx.query_topk(A, M, probes=0), ref_sk.topk_bruteforce(A, codes, M))


def test_adaptive_full_ceiling_brute_and_monotone_in_budget():
    codes, A = _planted(400, 16, 12)
    idx = _port_index([codes], fallback_density=1.0, probe_path="device",
                      adaptive=True, **BANDS)
    rd, ri = ref_sk.topk_bruteforce(A, codes, M)
    tiles0 = idx.lsh_stats()["adaptive_tiles"]
    _same(idx.query_topk(A, M, tile=TILE, probes=FULL), (rd, ri))
    assert idx.lsh_stats()["adaptive_tiles"] - tiles0 == 2
    prev = -1.0
    for budget in (1, M, 64, 10**9):
        d, i = idx.query_topk(A, M, tile=TILE, probes=FULL,
                              candidate_budget=budget)
        np.testing.assert_array_equal(d, ref_sk.pairwise_hamming(A, codes)[
            np.arange(A.shape[0])[:, None], i])  # true distances
        recall = sum(np.intersect1d(a, b).size for a, b in zip(i, ri)) / ri.size
        assert recall >= prev
        prev = recall
    assert prev == 1.0
    # on the host rung adaptive is inert: the fixed probes serve
    _same(idx.query_topk(A, M, tile=TILE, probes=3, probe_path="host"),
          _model_topk(codes, A, M, tile=TILE, probes=3, **BANDS))


def test_device_ladder_budget_and_plan_fallbacks_stay_exact():
    reg = tel.registry()
    # one bucket holds every row: a tile's gather passes the plan's cap
    codes = np.repeat(_codes(1, seed=8), 400, axis=0)
    codes[::7, 0] ^= 0xFF
    idx = _port_index([codes], probe_path="device", fallback_density=1.0,
                      bands=4, band_bits=8)
    A = codes[:16]
    f0 = reg.counter("index.lsh.fallbacks")
    _same(idx.query_topk(A, M, tile=TILE, probes=1), _masked_brute(A, codes, M))
    assert reg.counter("index.lsh.fallbacks") - f0 == 2  # device_budget, twice
    # 4 bands of 2^20 buckets: the reference planner has no tile; the runs'
    # total sizes the dispatch and the device rung serves, with no fallback
    wide = _codes(300, 16, seed=9)
    idx = _port_index([wide], probe_path="device", fallback_density=1.0,
                      bands=4, band_bits=20)
    assert pk.plan_probe(TILE, 300, 4, 20, FULL, M) is None
    Aw = wide[:8]
    f0, d0 = reg.counter("index.lsh.fallbacks"), idx.lsh_stats()["device_dispatches"]
    _same(idx.query_topk(Aw, M, tile=TILE, probes=FULL),
          _model_topk(wide, Aw, M, tile=TILE, probes=FULL, bands=4,
                      band_bits=20))
    assert reg.counter("index.lsh.fallbacks") == f0
    assert idx.lsh_stats()["device_dispatches"] - d0 == 1
    assert idx._lsh_probe_device("device") and not idx._lsh_probe_device("auto")


@pytest.mark.parametrize("adaptive", [False, True])
def test_unplanned_wide_bands_stay_on_the_device_rung(adaptive):
    # 8 bands of 2^20 buckets: past the reference planner's 16 MiB budget
    codes, A = _planted(480, 24, 20, nb=24)
    wide = dict(bands=8, band_bits=20)
    idx = _port_index([codes], probe_path="device", fallback_density=1.0,
                      adaptive=adaptive, **wide)
    idx.delete([3, 200])
    reg = tel.registry()
    f0, d0 = reg.counter("index.lsh.fallbacks"), idx.lsh_stats()["device_dispatches"]
    ladder = 0
    for probes in (2, 21):
        assert pk.plan_probe(TILE, 480, 8, 20, probes, M) is None
        got = idx.query_topk(A, M, tile=TILE, probes=probes)
        D = ref_sk.pairwise_hamming(A, codes)
        np.testing.assert_array_equal(got[0], np.take_along_axis(D, got[1], 1))
        assert not np.isin(got[1], [3, 200]).any()
        if adaptive:
            continue
        want = _model_topk(codes, A, M, tile=TILE, probes=probes, dead=(3, 200),
                           **wide)
        _same(got, want, idx.query_topk(A, M, tile=TILE, probes=probes,
                                        probe_path="host"))
        ladder += want[2]
    # only the ladder's own rungs (starved, dense) for the fixed probes, and
    # none for the adaptive rounds on this planted corpus
    assert reg.counter("index.lsh.fallbacks") - f0 == 2 * ladder
    assert idx.lsh_stats()["device_dispatches"] - d0 >= 2 * 3 - ladder


@pytest.mark.parametrize("adaptive", [False, True])
def test_runs_past_one_dispatch_fall_back_to_the_exact_path(adaptive, monkeypatch):
    codes = _codes(300, 16, seed=21)
    idx = _port_index([codes], probe_path="device", fallback_density=1.0,
                      adaptive=adaptive, bands=4, band_bits=20)
    monkeypatch.setattr(pk, "MAX_CAP", 64)  # below every runs_cap
    reg = tel.registry()
    f0 = reg.counter("index.lsh.fallbacks")
    A = codes[:16] ^ np.uint8(1)
    _same(idx.query_topk(A, M, tile=TILE, probes=3), _masked_brute(A, codes, M))
    # device_budget a tile: adaptive's rounds, then the fixed dispatch
    assert reg.counter("index.lsh.fallbacks") - f0 == (4 if adaptive else 2)


def test_append_hook_takes_the_chunk_as_given():
    seen = []

    class Spy(sk.SimHashIndex):
        def _codes_appended(self, codes, row0):
            seen.append((type(codes), row0, codes.shape[0]))

    idx = Spy(_codes(30, seed=22), device="cpu")
    idx.add(torch.from_numpy(_codes(5, seed=23)))
    assert seen == [(np.ndarray, 0, 30), (torch.Tensor, 30, 5)]


def test_events_and_counters(tmp_path):
    path = tmp_path / "t.jsonl"
    tel.configure(str(path))
    try:
        codes = _codes(400, seed=10)
        idx = _port_index([codes], fallback_density=1.0, **BANDS)
        A = codes[:16]
        idx.query_topk(A, M, tile=TILE, probes=2, probe_path="host")
        idx.query_topk(A, M, tile=TILE, probes=2, probe_path="device")
        idx.query_topk(A, M, tile=TILE, probes=FULL, probe_path="device",
                       adaptive=True)
        sk.SimHashIndex(codes, device="cpu")  # the base index folds nothing
    finally:
        tel.shutdown()
    events = ref_tel.read_events(str(path))
    names = [e["event"] for e in events]
    for name in ("index.lsh.build", "index.lsh.dispatch",
                 "index.lsh.device_upload", "index.lsh.device_dispatch",
                 "index.lsh.adaptive"):
        assert name in names, name
    assert names.count("index.lsh.build") == 1
    assert all(ref_tel.registered_event(n) for n in names)


def test_probe_host_and_dispatch_histograms():
    reg = tel.registry()
    h0 = reg.hist_sum("index.lsh.probe.host_s")
    w0 = reg.hist_sum("index.lsh.probe.dispatch_s")
    idx = _port_index([_codes(300, seed=11)], fallback_density=1.0, **BANDS)
    idx.query_topk(_codes(16, seed=12), M, tile=TILE, probes=2)
    assert reg.hist_sum("index.lsh.probe.host_s") > h0
    assert reg.hist_sum("index.lsh.probe.dispatch_s") > w0
    assert reg.hist_sum("never.observed") == 0.0
    ours, theirs = tel.MetricsRegistry(), ref_tel.MetricsRegistry()
    for s in (0.25, 1e-7, 3.5):
        ours.observe("x", s)
        theirs.observe("x", s)
    assert ours.hist_sum("x") == theirs.hist_sum("x")


def test_tensor_codes_and_queries():
    codes = _codes(300, seed=13)
    A = codes[:16] ^ np.uint8(8)
    idx = lsh.LSHSimHashIndex(torch.from_numpy(codes), device="cpu",
                              fallback_density=1.0, **BANDS)
    idx.add(torch.from_numpy(_codes(40, seed=14)))
    assert idx._buckets.n == 340
    want = _both_rungs(idx, A, M, tile=TILE, probes=3)
    _same(idx.query_topk(torch.from_numpy(A), M, tile=TILE, probes=3,
                         probe_path="host"), want)
    _same(idx.query_topk(torch.from_numpy(A), M, tile=TILE, probes=3,
                         probe_path="device"), want)


# -- knobs and validation -----------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {"probes": 0}, {"probes": True}, {"probes": 2.5}, {"fallback_density": 0.0},
    {"fallback_density": 1.5}, {"probe_path": "bogus"},
    {"candidate_budget": True}, {"candidate_budget": 0},
    {"candidate_budget": -3}, {"bands": 3, "band_bits": 30},
])
def test_constructor_knobs_fail_like_the_reference(kw):
    codes = _codes(64, seed=15)
    with pytest.raises(ValueError) as want:
        ref_lsh.LSHSimHashIndex(codes, **kw)
    with pytest.raises(ValueError) as got:
        lsh.LSHSimHashIndex(codes, device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_call_knobs_and_later_slices():
    codes = _codes(64, seed=16)
    idx = lsh.LSHSimHashIndex(codes, device="cpu", adaptive=True,
                              candidate_budget=64, **BANDS)
    assert (idx.probes, idx.probe_path, idx.adaptive, idx.candidate_budget) == (
        8, "auto", True, 64)
    A = codes[:4]
    for bad in (True, False, -1, 2.9, "4"):
        with pytest.raises(ValueError, match="probes must be a non-negative int"):
            idx.query_topk(A, 3, probes=bad)
    with pytest.raises(ValueError, match="candidate_budget"):
        idx.query_topk(A, 3, candidate_budget=True)
    with pytest.raises(ValueError, match="probe_path"):
        idx.query_topk(A, 3, probe_path="bogus")
    with pytest.raises(ValueError, match="m must be"):
        idx.query_topk(A, 0)
    with pytest.raises(ValueError, match="ROADMAP A10"):
        lsh.LSHSimHashIndex(codes, device="cpu", mesh=object())
    for call in (lambda: idx.save("x"), lambda: lsh.LSHSimHashIndex.load("x")):
        with pytest.raises(ValueError, match="ROADMAP A9"):
            call()
    idx.delete(np.arange(64))
    with pytest.raises(ValueError, match="all deleted"):
        idx.query_topk(A, 3)
    card = lsh.LSHSimHashIndex(_codes(1500, seed=1), device="cpu", **BANDS)
    card.device = torch.device("cuda", 0)  # refused before any dispatch
    with pytest.raises(ValueError, match=f"MAX_M={tk.MAX_M}"):
        card.query_topk(_codes(2, seed=1), tk.MAX_M + 1, probes=2)
    assert card._lsh_probe_device("auto")


def test_package_exports():
    import randomprojection_tpu_torch as rpt

    assert rpt.LSHSimHashIndex is lsh.LSHSimHashIndex
    assert rpt.ann.BandedBuckets is lsh.BandedBuckets
    assert set(rpt.ann.__all__) == {"BandPlan", "band_keys", "probe_masks",
                                    "BandedBuckets", "LSHSimHashIndex"}


# -- the server's probe classes ----------------------------------------------------


def test_server_probe_policy_groups_by_label():
    codes, A = _planted(600, 96, 17)
    idx = _port_index([codes], probes=2, fallback_density=1.0, **BANDS)
    policy = {"fast": 1, "deep": 6, "exact": 0}
    srv = sk.TopKServer(idx, M, max_batch=4096, max_delay_s=0.05,
                        probe_policy=policy, name="torch-lsh-policy",
                        start=False)
    labels = ["fast", "deep", "exact", None, "other", "fast"] * 2
    futs = [(lab, srv.submit(A[8 * k: 8 * k + 8], label=lab))
            for k, lab in enumerate(labels)]
    srv.start()  # every request is queued: one coalesced batch, four classes
    got = [(lab, f.result(timeout=60)) for lab, f in futs]
    srv.close()
    st = srv.stats()
    assert st["batches"] == 4 and st["requests"] == len(labels)
    for probes in (1, 6, 0, None):
        rows = [k for k, lab in enumerate(labels)
                if policy.get(lab) == probes]
        arr = np.concatenate([A[8 * k: 8 * k + 8] for k in rows])
        pad = sk.row_bucket(arr.shape[0])
        arr = np.pad(arr, ((0, pad - arr.shape[0]), (0, 0)))
        kw = {} if probes is None else {"probes": probes}
        want = idx.query_topk(arr, M, tile=pad, **kw)
        for j, k in enumerate(rows):
            _same(got[k][1], (want[0][8 * j: 8 * j + 8],
                              want[1][8 * j: 8 * j + 8]))
    assert not [t for t in threading.enumerate()
                if t.name.startswith("rp-topk")]


def test_server_probe_policy_validation():
    idx = _port_index([_codes(64, seed=18)], **BANDS)
    plain = sk.SimHashIndex(_codes(64, seed=18), device="cpu")
    for index, pol, match in ((plain, {"a": 2}, "LSH-tier index"),
                              (idx, {"a": True}, "non-negative int"),
                              (idx, {"a": -1}, "non-negative int"),
                              (idx, [("a", 2)], "dict of label")):
        with pytest.raises(ValueError, match=match):
            sk.TopKServer(index, M, probe_policy=pol, start=False)
    srv = sk.TopKServer(idx, M, probe_policy={"a b": 3}, start=False)
    assert srv.probe_policy == {"a_b": 3}  # keyed by the sanitized label
    srv.close()


def test_plan_clamps_the_device_tile():
    idx = _port_index([_codes(400, seed=19)], **BANDS)
    pplan = pk.plan_probe(1024, 400, 4, 4, 3, M)
    assert idx._lsh_device_tile(5000, 3, M) == pplan.tq
    assert idx._lsh_device_tile(7, 3, M) == 7
