"""The device-rung tile as one CUDA graph, on the CPU: the graph cache's
keys, its LRU and its invalidation on ``add``/``delete``/``compact``, the
launch bookkeeping of a capture and a replay, and the candidate-row gather
as whole words against the byte-wise gather it replaced.

Nothing here captures a graph: ``TileGraphs`` takes its capture function
as an argument, and these tests give it one that records its calls.  The
replay itself is held to the eager composite on the card
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from randomprojection_tpu_torch.ann import LSHSimHashIndex
from randomprojection_tpu_torch.ops import probe_kernels as pk


def _bytewise_gather(chunks, sc):
    """The gather the composite ran before whole-word rows: a byte-wise
    advanced index a chunk and a ``(len(sc), n_bytes)`` ``torch.where``."""
    g = None
    for codes, row0, rows in chunks:
        rows_c = codes[(sc - row0).clamp(0, rows - 1)]
        if g is None:
            g = rows_c
        else:
            inc = (sc >= row0) & (sc < row0 + rows)
            g = torch.where(inc[:, None], rows_c, g)
    return g


@pytest.mark.parametrize("n_bytes", [3, 8, 32, 12])
@pytest.mark.parametrize("offset", [0, 4])
def test_word_gather_equals_the_bytewise_gather(n_bytes, offset):
    rng = np.random.default_rng(n_bytes + offset)
    flat = torch.from_numpy(rng.integers(0, 256, size=offset + 900 * n_bytes,
                                         dtype=np.uint8))
    # two ragged chunks; the second starts `offset` bytes into its buffer,
    # so its rows may only be taken as narrower words
    c0 = flat[offset: offset + 517 * n_bytes].view(517, n_bytes).clone()
    c1 = flat[offset: offset + 383 * n_bytes].view(383, n_bytes)
    chunks = [(c0, 0, 517), (c1, 517, 383)]
    # ascending ids of both chunks, duplicates, and clamped sentinels
    sc = torch.from_numpy(np.sort(np.concatenate([
        rng.integers(0, 900, 3000), [0, 516, 517, 899, 899, 899]]))).long()
    got = pk.gather_rows(chunks, sc)
    assert got.dtype == torch.uint8 and got.shape == (sc.numel(), n_bytes)
    assert torch.equal(got, _bytewise_gather(chunks, sc))


@pytest.mark.parametrize("n_bytes,offset,want", [
    (32, 0, torch.int64), (8, 0, torch.int64), (12, 0, torch.int32),
    (6, 0, torch.int16), (3, 0, torch.uint8), (32, 4, torch.int32),
    (32, 2, torch.int16), (32, 1, torch.uint8),
])
def test_row_words_take_the_widest_word_that_fits(n_bytes, offset, want):
    flat = torch.zeros(offset + 10 * n_bytes, dtype=torch.uint8)
    codes = flat[offset:].view(10, n_bytes)
    words = pk._row_words(codes)
    assert words.dtype == want and words.shape[0] == 10
    assert words.view(torch.uint8).shape == (10, n_bytes)


class _Entry:
    """A stand-in for a captured tile: its replay returns fixed outputs and
    counts its calls."""

    def __init__(self, key):
        self.key = key
        self.replays = []

    def replay(self, q, masks, active):
        self.replays.append((q, masks, active))
        return ("d", self.key), ("gid", self.key), "stat", "cnt"


def _fake_cache(captured):
    def capture(q, masks, active, indptr, ids, dead, chunks, m, *, cap,
                band_bits):
        entry = _Entry((q, cap))
        captured.append(entry)
        return entry

    return pk.TileGraphs(capture=capture)


def _run(cache, key, q="q"):
    return cache.run(key, q, "masks", "active", "indptr", "ids", "dead", [],
                     5, cap=key, band_bits=4, fetch=lambda *outs: outs)


def test_graph_cache_captures_once_per_key_and_keeps_the_recent_ones(
        monkeypatch):
    monkeypatch.setattr(pk, "GRAPH_CACHE_SIZE", 2)
    captured = []
    cache = _fake_cache(captured)
    out = _run(cache, 1)
    assert out == (("d", ("q", 1)), ("gid", ("q", 1)), "stat", "cnt")
    _run(cache, 1, q="q2")
    assert len(captured) == 1 and captured[0].replays[1][0] == "q2"
    _run(cache, 2)
    _run(cache, 1)            # a hit makes key 1 the most recent
    _run(cache, 3)            # so key 2 is the one dropped
    assert cache.keys() == [1, 3] and len(captured) == 3
    _run(cache, 2)            # captured anew
    assert len(captured) == 4 and cache.keys() == [3, 2]
    # every run is one replay, the capture's run included
    assert sum(len(e.replays) for e in captured) == 6
    cache.clear()
    assert len(cache) == 0


def test_capture_counts_nothing_and_a_replay_counts_what_was_captured():
    probe, topk = {"rp_probe": 7}, {"rp_fused_topk_wgmma": 1,
                                     "rp_fused_topk_popc": 0,
                                     "rp_topk_merge": 1}
    counters = (probe, topk)

    def composite():
        probe["rp_probe"] += 2
        topk["rp_fused_topk_wgmma"] += 1
        topk["rp_topk_merge"] += 1
        return "outputs"

    out, added = pk.counted_launches(counters, composite)
    assert out == "outputs"
    assert probe == {"rp_probe": 7} and topk["rp_topk_merge"] == 1
    assert added == [{"rp_probe": 2}, {"rp_fused_topk_wgmma": 1,
                                       "rp_fused_topk_popc": 0,
                                       "rp_topk_merge": 1}]
    for _ in range(3):
        pk.credit_launches(counters, added)
    assert probe == {"rp_probe": 13}
    assert topk == {"rp_fused_topk_wgmma": 4, "rp_fused_topk_popc": 0,
                    "rp_topk_merge": 4}

    def failing():
        probe["rp_probe"] += 1
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        pk.counted_launches(counters, failing)
    assert probe == {"rp_probe": 13}


def test_reset_clears_the_graph_counters():
    pk.GRAPH_REPLAYS, pk.GRAPH_CAPTURES = 5, 2
    pk.reset_launches()
    assert pk.GRAPH_REPLAYS == 0 == pk.GRAPH_CAPTURES
    assert pk.LAUNCHES == {"rp_probe": 0}


def _index(seed=0, n=400):
    codes = np.random.default_rng(seed).integers(0, 256, size=(n, 8),
                                                 dtype=np.uint8)
    return codes, LSHSimHashIndex(codes, device="cpu", bands=4, band_bits=4,
                                  fallback_density=1.0, probe_path="device")


def test_graph_key_follows_shape_and_index_state():
    codes, idx = _index()
    k = idx._lsh_graph_key(64, 16, 1 << 12, 5)
    assert k == idx._lsh_graph_key(64, 16, 1 << 12, 5)
    # a ragged tile, another probe count, cap or m: another graph
    others = {idx._lsh_graph_key(*a) for a in ((37, 16, 1 << 12, 5),
                                                (64, 8, 1 << 12, 5),
                                                (64, 16, 1 << 13, 5),
                                                (64, 16, 1 << 12, 6))}
    assert k not in others and len(others) == 4
    idx.delete([3])
    k_del = idx._lsh_graph_key(64, 16, 1 << 12, 5)
    assert k_del != k
    idx.delete([3])  # already deleted: nothing changes
    assert idx._lsh_graph_key(64, 16, 1 << 12, 5) == k_del
    idx.add(codes[:50])
    k_add = idx._lsh_graph_key(64, 16, 1 << 12, 5)
    assert k_add not in (k, k_del)
    idx.compact()
    assert idx._lsh_graph_key(64, 16, 1 << 12, 5) not in (k, k_del, k_add)


def test_every_mutation_drops_the_captured_tiles():
    codes, idx = _index(1)
    captured = []
    idx._lsh_graphs = _fake_cache(captured)

    def fill():
        for cap in (1, 2, 3):
            _run(idx._lsh_graphs, cap)
        assert len(idx._lsh_graphs) == 3

    fill()
    idx.add(codes[:10])
    assert len(idx._lsh_graphs) == 0
    fill()
    assert idx.delete([0, 1]) == 2
    assert len(idx._lsh_graphs) == 0
    fill()
    assert idx.delete([0]) == 0  # no new tombstone: the graphs stand
    assert len(idx._lsh_graphs) == 3
    idx.compact()
    assert len(idx._lsh_graphs) == 0


def test_the_cpu_device_rung_captures_nothing():
    codes, idx = _index(2)
    captured = []
    idx._lsh_graphs = _fake_cache(captured)
    q = codes[:20] ^ np.uint8(1)
    dev = idx.query_topk(q, 5, tile=8, probes=3)
    host = idx.query_topk(q, 5, tile=8, probes=3, probe_path="host")
    np.testing.assert_array_equal(dev[0], host[0])
    np.testing.assert_array_equal(dev[1], host[1])
    ada = idx.query_topk(q, 5, tile=8, probes=16, adaptive=True)
    full = idx.query_topk(q, 5, tile=8, probes=16)
    np.testing.assert_array_equal(ada[1], full[1])
    assert captured == [] and len(idx._lsh_graphs) == 0
