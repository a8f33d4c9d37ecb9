"""The port's multi-probe LSH tier (``LSHSimHashIndex``) against the plain
reference of its semantics, on the CPU.

``lsh_topk_reference.py`` beside this file is a byte-for-byte copy of the
benchmark's reference (``rpbench/reference/lsh_topk.py``): band keys read
bit by bit, probe masks from their definition, each tile's candidate union
as a membership mask over all codes, the exact top-m over it (here a
numpy brute force), and the same fallbacks (a starved or a dense union is
served exact).  The tier is held to it on planted codes on both rungs,
at 1, 16 and every probe, in tiles of 1 and 64, on 12-bit bands (the
reference planner's tiles) and 20-bit bands (sized by the runs), and
through its dense and starved fallbacks.

The banded CSR (``fold_band_csr``, the torch build of every index, run on
CPU tensors here as a card runs it on its own) equals the JAX package's
host build (``randomprojection_tpu.ann.lsh.BandedBuckets``, numpy) bit for
bit, through folds of several chunks; and an index answers as the
reference through ``add``, ``delete``, ``compact`` and a snapshot's save
and load, making its host ids only for the host rung.
"""

import numpy as np
import pytest
import torch

import lsh_topk_reference as ref
from randomprojection_tpu.ann import lsh as jax_lsh
from randomprojection_tpu_torch.ann import lsh
from randomprojection_tpu_torch.ops import probe_kernels as pk
from randomprojection_tpu_torch.utils import telemetry as tel

NB, M = 32, 10


def _planted(rows, nq, seed, *, flips=6):
    """Clusters of 16 codes around uniform centres with ``flips`` random
    bits flipped a row, and queries that are corpus rows with their own
    flips (config 4's generator, in numpy)."""
    rng = np.random.default_rng(seed)
    centres = rng.integers(0, 256, size=(-(-rows // 16), NB), dtype=np.uint8)

    def noisy(a):
        a = a.copy()
        for _ in range(flips):
            pos = rng.integers(0, NB * 8, size=a.shape[0])
            a[np.arange(a.shape[0]), pos >> 3] ^= (1 << (pos & 7)).astype(
                np.uint8)
        return a

    codes = noisy(np.repeat(centres, 16, axis=0)[:rows])
    return codes, noisy(codes[rng.integers(0, rows, nq)])


def _exact(q, codes, m):
    """The exact top-m by a brute force: popcount of the xor, ties to the
    lower row."""
    x = np.bitwise_xor(q.numpy()[:, None, :], codes.numpy()[None, :, :])
    dist = np.unpackbits(x, axis=2).sum(axis=2, dtype=np.int64)
    order = np.argsort(dist, axis=1, kind="stable")[:, :m]
    return (torch.from_numpy(np.take_along_axis(dist, order, 1)),
            torch.from_numpy(order))


def _reference(codes, A, *, tile, dead=None, **kw):
    """The reference's answer for every tile of ``A``, and its fallbacks."""
    tiles = [torch.from_numpy(A[lo:lo + tile])
             for lo in range(0, A.shape[0], tile)]
    dead_t = None
    if dead is not None:
        dead_t = torch.zeros(codes.shape[0], dtype=torch.bool)
        dead_t[torch.as_tensor(dead)] = True
    out, fell_back = ref.topk(tiles, torch.from_numpy(codes), M,
                              exact=_exact, dead=dead_t, **kw)
    return (np.concatenate([d.numpy() for d, _i in out]),
            np.concatenate([i.numpy() for _d, i in out]), fell_back)


def _check(idx, codes, A, *, tile, probes, path, dead=None):
    """The tier's answer on ``path`` equals the reference's, fallbacks
    included; returns how many tiles fell back."""
    reg = tel.registry()
    f0 = reg.counter("index.lsh.fallbacks")
    d, i = idx.query_topk(A, M, tile=tile, probes=probes, probe_path=path)
    wd, wi, fell_back = _reference(
        codes, A, tile=tile, dead=dead, bands=idx.band_plan.bands,
        band_bits=idx.band_plan.band_bits, probes=probes,
        fallback_density=idx.fallback_density)
    np.testing.assert_array_equal(i, wi)
    np.testing.assert_array_equal(d, wd)
    assert reg.counter("index.lsh.fallbacks") - f0 == fell_back
    return fell_back


# tiles of 64 planted queries gather ~1,100 candidates: under 0.1 of the
# corpus, so the tier serves them
CODES, QUERIES = _planted(16000, 128, 7)


# every (rung, band bits, probes, tile) but one: a one-query tile at one
# probe gets the planner's least budget, 128 slots, fewer than a planted
# query's 12-bit buckets hold, so that tile overflows to the exact path on
# the planner's verdict, which the reference does not model
# (test_torch_lsh.py holds the device budget's fallback)
GRID = [(path, bits, probes, tile) for path in ("host", "device")
        for bits in (12, 20) for probes in (1, 16) for tile in (1, 64)
        if (path, bits, probes, tile) != ("device", 12, 1, 1)]


@pytest.mark.parametrize("path,band_bits,probes,tile", GRID)
def test_the_tier_equals_the_plain_reference(path, band_bits, probes, tile):
    # 12-bit buckets hold ~4 codes each here, so a tile's union passes 0.1
    # of the corpus: served by the tier at density 1
    density = 1.0 if band_bits == 12 else 0.1
    idx = lsh.LSHSimHashIndex(CODES, device="cpu", bands=8,
                              band_bits=band_bits, fallback_density=density)
    # 12-bit bands are the reference planner's; 20-bit ones it refuses
    planned = pk.plan_probe(tile, 16000, 8, band_bits, probes, M) is not None
    assert planned == (band_bits == 12)
    A = QUERIES[:16] if tile == 1 else QUERIES
    fell_back = _check(idx, CODES, A, tile=tile, probes=probes, path=path)
    # the tier serves every tile but, at one probe, a starved query
    assert fell_back <= (probes == 1)


@pytest.mark.parametrize("path,tile", [("host", 64), ("device", 1)])
def test_full_coverage_is_the_exact_answer(path, tile):
    idx = lsh.LSHSimHashIndex(CODES, device="cpu", bands=8, band_bits=12,
                              fallback_density=1.0)
    A = QUERIES[:64] if tile == 64 else QUERIES[:6]
    assert _check(idx, CODES, A, tile=tile, probes=1 << 12, path=path) == 0
    d, i = idx.query_topk(A, M, tile=tile, probes=1 << 12, probe_path=path)
    wd, wi = _exact(torch.from_numpy(A), torch.from_numpy(CODES), M)
    np.testing.assert_array_equal(i, wi.numpy())
    np.testing.assert_array_equal(d, wd.numpy())


@pytest.mark.parametrize("path", ["host", "device"])
def test_a_dense_union_is_served_exact(path):
    # every probe of 8-bit bands: the union is the whole corpus, past 0.1
    codes = CODES[:3000]
    idx = lsh.LSHSimHashIndex(codes, device="cpu", bands=8, band_bits=8)
    assert _check(idx, codes, QUERIES[:24], tile=8, probes=256,
                  path=path) == 3


@pytest.mark.parametrize("path", ["host", "device"])
def test_a_starved_union_is_served_exact(path):
    # queries far from every code, one probe of 20-bit buckets: fewer
    # candidates than m
    far = np.random.default_rng(3).integers(0, 256, size=(5, NB),
                                            dtype=np.uint8)
    idx = lsh.LSHSimHashIndex(CODES, device="cpu", bands=8, band_bits=20)
    assert _check(idx, CODES, far, tile=1, probes=1, path=path) == 5


@pytest.mark.parametrize("bands,band_bits,nb", [(8, 20, 32), (8, 12, 32),
                                                 (3, 7, 4), (5, 5, 4)])
def test_the_card_built_csr_equals_the_host_build(bands, band_bits, nb):
    rng = np.random.default_rng(band_bits)
    host = jax_lsh.BandedBuckets(jax_lsh.BandPlan(nb * 8, bands=bands,
                                                  band_bits=band_bits))
    card = lsh.BandedBuckets(lsh.BandPlan(nb * 8, bands=bands,
                                          band_bits=band_bits))
    for rows in (2500, 1, 0, 700):
        part = rng.integers(0, 256, size=(rows, nb), dtype=np.uint8)
        # a planted corner: many rows in one bucket of every band
        part[: rows // 3] = part[:1]
        assert host.add(part) == card.add(torch.from_numpy(part)) == rows
        ip, ids = card.dev
        assert ip.dtype == ids.dtype == torch.int32
        if rows:
            assert card._ids is None and card._keys is None
        for j in range(bands):
            np.testing.assert_array_equal(ip[j].numpy(), host._indptr[j])
            np.testing.assert_array_equal(card._indptr[j], host._indptr[j])
            np.testing.assert_array_equal(ids[j].numpy(), host._ids[j])
        np.testing.assert_array_equal(card.keys, host.keys)
        assert card.n == host.n
    # the host ids come from the built planes, once
    assert all(np.array_equal(a, b) for a, b in zip(card.ids, host._ids))


def test_the_card_keys_equal_the_host_keys():
    for band_bits in (1, 7, 8, 13, 20):
        plan = lsh.BandPlan(256, bands=256 // band_bits // 2,
                            band_bits=band_bits)
        want = lsh.band_keys(CODES, plan)
        got = pk.device_band_keys(torch.from_numpy(CODES), plan.bands,
                                  band_bits)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
        # the build's key, a band over every row
        for j in range(plan.bands):
            np.testing.assert_array_equal(
                pk.band_key(torch.from_numpy(CODES), j, band_bits).numpy(),
                want[j])


@pytest.mark.parametrize("band_bits", [12, 20])
def test_a_card_built_index_answers_through_its_mutations(band_bits,
                                                          tmp_path):
    codes, A = _planted(12000, 128, 11)
    idx = lsh.LSHSimHashIndex(codes[:8000], device="cpu", bands=8,
                              band_bits=band_bits, fallback_density=1.0)
    assert idx._buckets.dev is not None and idx._buckets._ids is None
    idx.add(codes[8000:])
    assert idx._buckets.n == 12000 and idx._buckets._ids is None
    indptr, ids = idx._lsh_device_csr()
    assert indptr is idx._buckets.dev[0] and ids is idx._buckets.dev[1]
    host = jax_lsh.BandedBuckets(jax_lsh.BandPlan(
        256, bands=8, band_bits=band_bits))
    host.add(codes)
    for j in range(8):
        np.testing.assert_array_equal(indptr[j].numpy(), host._indptr[j])
        np.testing.assert_array_equal(ids[j].numpy(), host._ids[j])
    # tiles of 32: every one is served by the tier
    assert _check(idx, codes, A, tile=32, probes=16, path="device") == 0
    assert idx._buckets._ids is None  # the device rung reads no host id
    _check(idx, codes, A, tile=32, probes=16, path="host")
    dead = np.arange(0, 12000, 5)
    idx.delete(dead)
    for path in ("device", "host"):
        assert _check(idx, codes, A, tile=32, probes=16, path=path,
                      dead=dead) == 0
    idx.save(str(tmp_path / "snap"))
    back = lsh.load_lsh_index(str(tmp_path / "snap"), device="cpu")
    assert back._buckets.dev is not None
    np.testing.assert_array_equal(back._buckets.keys, host.keys)
    _check(back, codes, A, tile=32, probes=16, path="device", dead=dead)
    mapping = idx.compact()
    assert idx._buckets.dev is not None and idx._buckets.n == mapping.size
    survivors = jax_lsh.BandedBuckets(host.plan)
    survivors.add(codes[mapping])
    for j in range(8):
        np.testing.assert_array_equal(idx._buckets.dev[1][j].numpy(),
                                      survivors._ids[j])
    for path in ("device", "host"):
        assert _check(idx, codes[mapping], A, tile=32, probes=16,
                      path=path) == 0
