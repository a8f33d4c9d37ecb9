"""The port's CSR probe gather (K5's plain version) and its planner against
the JAX package, on the CPU.

The reference's Pallas probe kernel cannot run here: it reads its refs with
``pl.load``/``pl.store``, which this JAX no longer has.  So K5's plain
version is held to a numpy transcription of that kernel's sequential loop
(``_greedy_probe`` below): slots, counts and stats bit for bit when no run
overflows the slot budget, ``counts`` and the overflow flag when one does
(the prefix-sum design writes no run after an overflow, where the greedy
loop packs the runs that still fit; ``ops/probe_kernels.py`` documents
it).  Its slot union is held to the reference's host
``BandedBuckets.candidates``, the planner to the reference's
``plan_probe``, and the band keys to the reference's host and XLA
extractions.  The CUDA kernel is held to this plain version on the card
(tests/test_torch_cuda.py and chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from randomprojection_tpu.ann import lsh as ref_lsh
from randomprojection_tpu.ops import probe_kernels as ref_pk
from randomprojection_tpu_torch.ann import lsh
from randomprojection_tpu_torch.ops import probe_kernels as pk

SENTINEL = 2**31 - 1


def _greedy_probe(qkeys, masks, active, indptr, ids, cap):
    """``_probe_kernel``'s loop (randomprojection_tpu/ops/probe_kernels.py,
    183-254) in numpy: runs in (query, band, probe) order, each appended
    at the write cursor if it fits ``cap``, else skipped with overflow."""
    bands, tq = qkeys.shape
    n_probes = masks.shape[1]
    slots = np.full(cap, SENTINEL, np.int32)
    counts = np.zeros(tq, np.int32)
    wr = ovf = 0
    for t in range(tq * bands * n_probes):
        q, j, p = t // (bands * n_probes), (t // n_probes) % bands, t % n_probes
        key = qkeys[j, q] ^ masks[0, p]
        start, end = int(indptr[j, key]), int(indptr[j, key + 1])
        ln = end - start if active[0, q] != 0 else 0
        counts[q] += ln
        if ln > 0 and wr + ln <= cap:
            slots[wr: wr + ln] = ids[j, start: start + ln]
            wr += ln
        elif ln > 0:
            ovf = 1
    stats = np.zeros(8, np.int32)
    stats[:2] = wr, ovf
    return slots, counts, stats


def _csr(rows, nb, bands, band_bits, seed, *, dup=0):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 256, size=(rows, nb), dtype=np.uint8)
    codes[:dup] = codes[0]
    plan = lsh.BandPlan(nb * 8, bands=bands, band_bits=band_bits)
    b = lsh.BandedBuckets(plan)
    b.add(codes)
    return codes, plan, b


def _planes(b, plan, q, masks, inactive=()):
    active = np.ones((1, q.shape[0]), np.int32)
    active[0, list(inactive)] = 0
    return (lsh.band_keys(q, plan).astype(np.int32),
            np.asarray(masks, np.int32)[None, :], active,
            np.stack([ip.astype(np.int32) for ip in b._indptr]),
            np.stack(b.ids))


# (rows, bytes, bands, band_bits, queries, masks, cap, repeated rows,
# inactive queries)
SHAPES = [
    (600, 8, 4, 4, 8, [0, 1, 2, 4], 4096, 0, ()),
    (600, 8, 4, 8, 13, [0, 1, 2, 4, 8], 1024, 0, (0, 12)),   # ragged, inactive
    (40, 8, 2, 12, 6, [0, 1, 2], 128, 0, ()),                 # empty buckets
    (500, 8, 2, 6, 4, [0, 1], 2048, 300, ()),                 # a run of 300+
    (200, 8, 3, 2, 5, [0, 1, 2, 3, 0, 1, 2], 4096, 0, ()),    # P > 2^b
    (3000, 8, 3, 20, 9, [0, 1, 2, 4], 256, 0, (4,)),          # b = 20
    (600, 8, 4, 4, 8, [0, 1, 2, 4], 300, 0, ()),              # overflow
    (600, 8, 4, 8, 13, [0, 1, 2, 4, 8], 50, 0, (0,)),         # overflow
]


@pytest.mark.parametrize("rows,nb,bands,b,tq,masks,cap,dup,inactive", SHAPES)
def test_plain_probe_equals_the_reference_loop(rows, nb, bands, b, tq, masks,
                                               cap, dup, inactive):
    codes, plan, bk = _csr(rows, nb, bands, b, rows + tq, dup=dup)
    rng = np.random.default_rng(tq)
    q = rng.integers(0, 256, size=(tq, nb), dtype=np.uint8)
    q[: tq // 2] = codes[rng.integers(0, rows, tq // 2)]
    planes = _planes(bk, plan, q, masks, inactive)
    ws, wc, wst = _greedy_probe(*planes, cap)
    s, c, st = pk.probe_gather(*(torch.from_numpy(p) for p in planes), cap=cap)
    assert s.dtype == c.dtype == st.dtype == torch.int32
    assert s.shape == (cap,) and c.shape == (tq,) and st.shape == (8,)
    np.testing.assert_array_equal(c.numpy(), wc)
    assert int(st[1]) == int(wst[1])
    if wst[1]:
        # the documented divergence: no run is written after an overflow
        assert (s == SENTINEL).all() and st.tolist() == [0, 1, 0, 0, 0, 0, 0, 0]
        assert int(c.sum()) > cap
    else:
        np.testing.assert_array_equal(s.numpy(), ws)
        np.testing.assert_array_equal(st.numpy(), wst)


@pytest.mark.parametrize("bands,b,probes,inactive", [(4, 4, 3, ()), (4, 8, 9, (2,)),
                                                     (2, 3, 8, ()), (8, 1, 2, (0, 1))])
def test_slot_union_equals_reference_candidates(bands, b, probes, inactive):
    codes = np.random.default_rng(b).integers(0, 256, size=(700, 8),
                                              dtype=np.uint8)
    q = codes[:10] ^ np.uint8(1)
    rplan = ref_lsh.BandPlan(64, bands=bands, band_bits=b)
    rb = ref_lsh.BandedBuckets(rplan)
    rb.add(codes)
    keep = np.setdiff1d(np.arange(10), inactive)
    want, gathered = rb.candidates(ref_lsh.band_keys(q[keep], rplan),
                                   ref_lsh.probe_masks(b, probes))
    plan = lsh.BandPlan(64, bands=bands, band_bits=b)
    bk = lsh.BandedBuckets(plan)
    bk.add(codes)
    planes = _planes(bk, plan, q, lsh.probe_masks(b, probes), inactive)
    s, c, st = pk.probe_plain(*(torch.from_numpy(p) for p in planes),
                              cap=1 << 16)
    assert int(st[0]) == gathered == int(c.sum())
    np.testing.assert_array_equal(np.unique(s[: int(st[0])].numpy()), want)


@pytest.mark.parametrize("nq", [1, 7, 64, 256, 2048])
@pytest.mark.parametrize("rows,bands,b", [(400, 4, 4), (1 << 20, 8, 16),
                                          (1 << 16, 4, 8), (5000, 3, 20),
                                          (10, 64, 1)])
@pytest.mark.parametrize("probes,m", [(1, 10), (16, 10), (3, 300), (1 << 20, 5)])
def test_plan_equals_reference(nq, rows, bands, b, probes, m):
    want = ref_pk.plan_probe(nq, rows, bands, b, probes, m)
    got = pk.plan_probe(nq, rows, bands, b, probes, m)
    assert got == (None if want is None else (want.tq, want.cap))


def test_plan_bounds():
    for bad in ((0, 10, 4, 4, 2, 5), (8, 0, 4, 4, 2, 5), (8, 10, 4, 4, 0, 5),
                (8, 10, 4, 4, 2, 0), (8, 10, 0, 4, 2, 5), (8, 10, 4, 0, 2, 5)):
        assert pk.plan_probe(*bad) is None is ref_pk.plan_probe(*bad)


@pytest.mark.parametrize("total,m,want", [
    (0, 5, 128), (1, 1, 128), (129, 5, 256), (256, 5, 256), (100, 200, 1024),
    ((1 << 30) - 3, 5, 1 << 30), ((1 << 30) + 1, 5, 1 << 31),
])
def test_runs_cap_holds_every_run(total, m, want):
    cap = pk.runs_cap(total, m)
    assert cap == want and cap >= total
    assert (cap <= pk.MAX_CAP) == (total <= pk.MAX_CAP)


@pytest.mark.parametrize("n,nb,bands,b", [(50, 8, 4, 8), (17, 3, 2, 10),
                                          (9, 32, 8, 16), (4, 8, 3, 20)])
def test_device_band_keys_equal_the_reference(n, nb, bands, b):
    import jax.numpy as jnp

    codes = np.random.default_rng(n).integers(0, 256, size=(n, nb),
                                              dtype=np.uint8)
    got = pk.device_band_keys(torch.from_numpy(codes), bands, b)
    assert got.dtype == torch.int32 and got.shape == (bands, n)
    host = ref_lsh.band_keys(codes, ref_lsh.BandPlan(nb * 8, bands=bands,
                                                     band_bits=b))
    np.testing.assert_array_equal(got.numpy(), host.astype(np.int32))
    xla = ref_pk.device_band_keys(jnp.asarray(codes), bands, b)
    np.testing.assert_array_equal(got.numpy(), np.asarray(xla))


def test_wrapper_device_rule_and_checks():
    codes, plan, bk = _csr(100, 8, 2, 4, 0)
    planes = [torch.from_numpy(p) for p in _planes(bk, plan, codes[:3], [0, 1])]
    pk.reset_launches()
    got = pk.probe_gather(*planes, cap=512)
    want = pk.probe_plain(*planes, cap=512)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert pk.LAUNCHES == {"rp_probe": 0}  # the CPU counts no launch
    with pytest.raises(ValueError, match="CUDA"):
        pk.rp_probe_gather(*planes, cap=512)
    meta = [torch.empty(p.shape, dtype=p.dtype, device="meta") for p in planes]
    with pytest.raises(ValueError, match="no probe kernel"):
        pk.probe_gather(*meta, cap=512)
    qk, mk, act, ip, ids = planes
    for args, match in (((qk.long(), mk, act, ip, ids), "qkeys"),
                        ((qk, mk, act[:, :2], ip, ids), "active"),
                        ((qk, mk, act, ip[:, :-1], ids), "indptr"),
                        ((qk, mk, act, ip, ids[:1]), "ids")):
        with pytest.raises(ValueError, match=match):
            pk.probe_gather(*args, cap=512)


def test_composite_equals_candidates_brute_force():
    """``device_probe_topk`` on the CPU: the top-m over the tile's
    candidate union (reference buckets, tombstones removed) by a host
    brute force, and stats = [gathered, 0, live candidates]."""
    from randomprojection_tpu.models import sketch as ref_sk

    rng = np.random.default_rng(5)
    codes = rng.integers(0, 256, size=(900, 8), dtype=np.uint8)
    dead = np.zeros(900, bool)
    dead[rng.choice(900, 60, replace=False)] = True
    q = codes[:12] ^ np.uint8(4)
    rplan = ref_lsh.BandPlan(64, bands=4, band_bits=6)
    rb = ref_lsh.BandedBuckets(rplan)
    rb.add(codes)
    masks = ref_lsh.probe_masks(6, 4)
    cand, gathered = rb.candidates(ref_lsh.band_keys(q, rplan), masks)
    cand = cand[~dead[cand]]
    D = ref_sk.pairwise_hamming(q, codes[cand])
    wd, wl = ref_sk._host_topk_select(D, 6)
    plan = lsh.BandPlan(64, bands=4, band_bits=6)
    bk = lsh.BandedBuckets(plan)
    bk.add(codes)
    qk, mk, act, ip, ids = (torch.from_numpy(p)
                            for p in _planes(bk, plan, q, masks))
    chunks = [(torch.from_numpy(codes[:500]), 0, 500),
              (torch.from_numpy(codes[500:]), 500, 400)]
    d, gid, st, cnt = pk.device_probe_topk(
        torch.from_numpy(q), mk, act, ip, ids,
        torch.from_numpy(dead.astype(np.uint8)), chunks, 6, cap=1 << 14,
        band_bits=6)
    np.testing.assert_array_equal(d.numpy(), wd)
    np.testing.assert_array_equal(gid.numpy(), cand[wl])
    assert st.tolist()[:3] == [gathered, 0, cand.size]
    assert int(cnt.sum()) == gathered
