"""The port's sharded serving tier against the JAX package, on the CPU.

``randomprojection_tpu_torch.serving`` (``ShardedSimHashIndex``,
``ShardedTopKServer``, ``shard_devices``), the port's mesh
(``parallel/mesh.py``), ``SimHashIndex(mesh=)`` and
``pairwise_hamming_sharded`` mirror ``tests/test_serving.py``.  The port
runs its shards with ``devices=['cpu']`` (the kernel's plain version
serves each shard); the reference runs on conftest's virtual 8-device
mesh, its fused route in interpret mode for the 8-shard layout and its
``lax.scan`` route (bit-identical to the fused one by that package's own
tests) elsewhere.  Both are held to ``topk_bruteforce``; every answer is
exact integer data, so every comparison is bit for bit: distances int32,
global ids int64, ties to the lower global id.
"""

import jax
import numpy as np
import pytest
import torch

from randomprojection_tpu import serving as ref_serving
from randomprojection_tpu.models import sketch as ref_sk
from randomprojection_tpu.parallel import mesh as ref_mesh
from randomprojection_tpu.utils import telemetry as ref_tel
from randomprojection_tpu.utils import trace_report as ref_report
from randomprojection_tpu_torch.models import sketch as sk
from randomprojection_tpu_torch.parallel import mesh as pmesh
from randomprojection_tpu_torch.serving import (
    ShardedSimHashIndex,
    ShardedTopKServer,
    shard_devices,
)
from randomprojection_tpu_torch.utils import telemetry as tel

NB = 8  # packed bytes a code
CPU = torch.device("cpu")
LAYOUTS = [1, 2, 3, 8]


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 256, size=(1100, NB), dtype=np.uint8)
    queries = rng.integers(0, 256, size=(24, NB), dtype=np.uint8)
    return codes, queries


def _port(codes, n_shards, **kw):
    return ShardedSimHashIndex(codes, devices=["cpu"], n_shards=n_shards, **kw)


def _ref(codes, n_shards, **kw):
    # the 8-shard layout runs the reference's fused route (interpret mode
    # on the CPU); the others its scan route
    impl = "auto" if n_shards == 8 else "scan"
    return ref_serving.ShardedSimHashIndex(codes, n_shards=n_shards,
                                           topk_impl=impl, **kw)


def _masked_ref(A, B, dead_ids, m):
    D = ref_sk.pairwise_hamming(A, B).astype(np.int64)
    if len(dead_ids):
        D[:, dead_ids] = B.shape[1] * 8 + 1
    return ref_sk._host_topk_select(D, m)


def _same(got, *wants):
    assert got[1].dtype == np.int64
    for want in wants:
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], np.asarray(want[1]).astype(np.int64))


# -- device resolution and the mesh ------------------------------------------------


def test_shard_devices_resolution():
    assert shard_devices(devices=["cpu"]) == [CPU]
    assert shard_devices(devices=["cpu"], n_shards=8) == [CPU] * 8
    assert shard_devices(devices=["cpu", CPU], n_shards=5) == [CPU] * 5
    with pytest.raises(ValueError, match="at least one"):
        shard_devices(devices=[])
    with pytest.raises(ValueError, match="n_shards"):
        shard_devices(devices=["cpu"], n_shards=0)
    with pytest.raises(ValueError, match="CUDA device or 'cpu'"):
        shard_devices(devices=["meta"])
    if not torch.cuda.is_available():
        # the card by default, never the CPU quietly
        for kw in ({}, {"n_shards": 8}, {"devices": ["cuda"]}):
            with pytest.raises(RuntimeError, match="CUDA"):
                shard_devices(**kw)


def test_shard_devices_from_mesh():
    mesh = pmesh.make_mesh({"data": 8}, devices=["cpu"] * 8)
    assert mesh.shape == {"data": 8} and mesh.axis_names == ("data",)
    assert shard_devices(mesh=mesh) == [CPU] * 8
    # a 2-D mesh: one shard a data-axis index, the first device of its
    # slice, as the reference resolves it
    devs = ["cpu"] * 8
    mesh2 = pmesh.make_mesh({"data": 4, "feature": 2}, devices=devs)
    assert len(shard_devices(mesh=mesh2)) == 4
    jmesh2 = ref_mesh.make_mesh({"data": 4, "feature": 2}, jax.devices()[:8])
    assert ref_serving.shard_devices(mesh=jmesh2) == [
        jax.devices()[i] for i in (0, 2, 4, 6)]
    with pytest.raises(ValueError, match="no 'rows' axis"):
        shard_devices(mesh=mesh, data_axis="rows")
    with pytest.raises(ValueError, match="cannot be combined"):
        shard_devices(mesh=mesh, n_shards=4)
    with pytest.raises(ValueError, match="cannot be combined"):
        shard_devices(mesh=mesh, devices=["cpu"])
    with pytest.raises(ValueError, match="cannot be combined"):
        ShardedSimHashIndex(np.zeros((16, 4), np.uint8), mesh=mesh, n_shards=4)


@pytest.mark.parametrize("n,tp", [(8, 1), (8, 2), (4, 4), (6, 3)])
def test_mesh_shapes_equal_the_reference(n, tp):
    assert pmesh.mesh_shape_for(n, tp) == ref_mesh.mesh_shape_for(n, tp)
    mesh = pmesh.default_mesh(feature_shards=tp, devices=["cpu"] * n)
    assert mesh.shape == ref_mesh.mesh_shape_for(n, tp)
    assert mesh.devices.shape == tuple(mesh.shape.values())


def test_mesh_refusals():
    with pytest.raises(ValueError, match="require 8 devices, have 4"):
        pmesh.make_mesh({"data": 8}, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="must divide"):
        pmesh.mesh_shape_for(8, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pmesh.default_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            pmesh.make_mesh({"data": 1})


# -- parity with the reference and brute force -------------------------------------


@pytest.mark.parametrize("n_shards", LAYOUTS)
def test_sharded_parity_across_layouts(corpus, n_shards):
    codes, queries = corpus
    idx = _port(codes, n_shards)
    assert idx.n_shards == n_shards and idx.devices == [CPU] * n_shards
    got = idx.query_topk(queries, 7)
    _same(got, _ref(codes, n_shards).query_topk(queries, 7),
          ref_sk.topk_bruteforce(queries, codes, 7))
    # a ragged last tile, and m past a shard's rows
    _same(idx.query_topk(queries, 200, tile=10),
          ref_sk.topk_bruteforce(queries, codes, 200))


def test_sharded_tie_heavy_corpus():
    """Few distinct codes: massed ties, the lower global id wins across
    shard boundaries."""
    rng = np.random.default_rng(3)
    base = rng.integers(0, 256, size=(4, NB), dtype=np.uint8)
    codes = base[rng.integers(0, 4, size=300)]
    queries = base[rng.integers(0, 4, size=8)]
    for n in (4, 8):
        _same(_port(codes, n).query_topk(queries, 9),
              ref_serving.ShardedSimHashIndex(
                  codes, n_shards=n, topk_impl="scan").query_topk(queries, 9),
              ref_sk.topk_bruteforce(queries, codes, 9))


def test_add_keeps_insertion_order_and_balance(corpus):
    codes, queries = corpus
    idx = _port(codes[:100], 4)
    ref = ref_serving.ShardedSimHashIndex(codes[:100], n_shards=4,
                                          topk_impl="scan")
    for part in (codes[100:350], codes[350:]):
        idx.add(part)
        ref.add(part)
    assert idx.n_codes == 1100
    assert idx.stats()["shard_rows"] == ref.stats()["shard_rows"]
    sizes = idx.stats()["shard_rows"]
    assert max(sizes) - min(sizes) <= 1, sizes
    assert [(s.g0, s.rows, s.shard, s.l0) for s in idx._segments] == [
        (s.g0, s.rows, s.shard, s.l0) for s in ref._segments]
    _same(idx.query_topk(queries, 6), ref.query_topk(queries, 6),
          ref_sk.topk_bruteforce(queries, codes, 6))


def test_empty_shards_are_skipped(corpus):
    _, queries = corpus
    tiny = np.random.default_rng(5).integers(0, 256, size=(5, NB),
                                             dtype=np.uint8)
    idx = _port(tiny, 8)
    assert sorted(idx.stats()["shard_rows"], reverse=True)[:5] == [1] * 5
    _same(idx.query_topk(queries, 3), ref_sk.topk_bruteforce(queries, tiny, 3))


# -- tombstones across shard boundaries ----------------------------------------------


@pytest.mark.parametrize("n_shards", LAYOUTS)
def test_tombstones_span_shard_boundaries(corpus, n_shards):
    codes, queries = corpus
    idx = _port(codes, n_shards)
    ref = ref_serving.ShardedSimHashIndex(codes, n_shards=n_shards,
                                          topk_impl="scan")
    # 8 shards of ~137 rows: [200, 420) crosses two boundaries and holds
    # one shard whole
    dead = np.arange(200, 420)
    assert idx.delete(dead) == ref.delete(dead) == 220
    assert idx.delete(dead) == 0
    assert idx.n_deleted == 220 and idx.n_live == 880
    _same(idx.query_topk(queries, 8), ref.query_topk(queries, 8),
          _masked_ref(queries, codes, dead, 8))


def test_delete_validation(corpus):
    codes, _ = corpus
    idx = _port(codes, 2)
    with pytest.raises(ValueError, match="integers"):
        idx.delete(np.array([1.5]))
    with pytest.raises(ValueError, match=r"\[0, 1100\)"):
        idx.delete([1100])
    assert idx.delete([]) == 0


def test_m_clamps_to_live_and_error_paths(corpus):
    codes, queries = corpus
    small = codes[:40]
    idx = _port(small, 3)
    idx.delete(np.arange(30, 40))
    d, i = idx.query_topk(queries, 64)
    assert d.shape == (24, 30) and i.shape == (24, 30)
    _same((d, i), _masked_ref(queries, small, np.arange(30, 40), 30))
    idx.delete(np.arange(30))
    with pytest.raises(ValueError, match="all deleted"):
        idx.query_topk(queries, 3)
    with pytest.raises(ValueError, match="empty index"):
        _port(np.empty((0, NB), np.uint8), 2).query_topk(queries, 3)
    with pytest.raises(ValueError, match="positive int"):
        idx.query_topk(queries, 0)
    with pytest.raises(ValueError, match="queries must be"):
        idx.query_topk(np.zeros((2, NB + 1), np.uint8), 3)


# -- the global int64 id space ----------------------------------------------------


@pytest.mark.parametrize("n_shards", LAYOUTS)
def test_id_offset_past_int32(corpus, n_shards):
    codes, queries = corpus
    off = 2**31 + 13
    idx = _port(codes, n_shards, id_offset=off)
    ref = ref_serving.ShardedSimHashIndex(codes, n_shards=n_shards,
                                          topk_impl="scan", id_offset=off)
    d, i = idx.query_topk(queries, 7)
    rd, ri = ref_sk.topk_bruteforce(queries, codes, 7)
    _same((d, i), ref.query_topk(queries, 7),
          (rd, ri.astype(np.int64) + off))
    assert int(i.min()) > 2**31
    # delete speaks offset ids, and validates in offset space
    assert idx.delete(np.array([off, off + 1])) == 2
    ref.delete(np.array([off, off + 1]))
    with pytest.raises(ValueError, match=str(off + 1100)):
        idx.delete([off + 1100])
    md, mi = _masked_ref(queries, codes, np.array([0, 1]), 7)
    _same(idx.query_topk(queries, 7), ref.query_topk(queries, 7),
          (md, mi.astype(np.int64) + off))


def test_per_shard_capacity_error_names_shard():
    codes = np.random.default_rng(0).integers(0, 256, size=(16, NB),
                                             dtype=np.uint8)
    idx = _port(codes, 8)
    shard = idx._shards[3]
    assert shard.label == "shard 3/8 on cpu"
    shard.n_codes = 2**31 - 10  # a near-capacity shard
    with pytest.raises(ValueError) as ei:
        shard.add(codes)
    msg = str(ei.value)
    assert "shard 3/8 on cpu" in msg
    assert "ShardedSimHashIndex" in msg and "int64" in msg


def test_card_shard_refuses_m_past_the_kernel_naming_the_shard(corpus):
    """No dense leg a shard: a card shard refuses past the kernel's MAX_M,
    naming itself, before any shard is dispatched."""
    from randomprojection_tpu_torch.ops import topk_kernels as tk

    codes = np.random.default_rng(1).integers(0, 256, size=(8 * 1100, NB),
                                             dtype=np.uint8)
    idx = _port(codes, 8)
    idx._shards[5].device = torch.device("cuda", 0)  # refused first
    with pytest.raises(ValueError, match=f"MAX_M={tk.MAX_M}.*shard 5/8"):
        idx.query_topk(corpus[1], tk.MAX_M + 1)
    idx._shards[5].device = CPU
    assert idx.query_topk(corpus[1], tk.MAX_M + 1)[0].shape == (24, 1025)


# -- the dense analysis surface and compaction ---------------------------------------


def test_dense_query_global_column_order(corpus):
    codes, queries = corpus
    idx = _port(codes, 3)
    ref = ref_serving.ShardedSimHashIndex(codes, n_shards=3, topk_impl="scan")
    idx.add(codes[:50])
    ref.add(codes[:50])
    full = np.concatenate([codes, codes[:50]])
    got = idx.query(queries)
    assert np.array_equal(got, ref.query(queries))
    assert np.array_equal(got, ref_sk.pairwise_hamming(queries, full))
    np.testing.assert_array_equal(idx.query_cosine(queries),
                                  ref.query_cosine(queries))


def test_compact_folds_and_remaps(corpus):
    codes, queries = corpus
    idx = _port(codes, 3, id_offset=7)
    ref = ref_serving.ShardedSimHashIndex(codes, n_shards=3,
                                          topk_impl="scan", id_offset=7)
    dead = np.arange(100, 260) + 7
    idx.delete(dead)
    ref.delete(dead)
    mapping = idx.compact()
    assert np.array_equal(mapping, ref.compact())
    live = np.delete(np.arange(1100), dead - 7)
    assert np.array_equal(mapping, live + 7)
    assert idx.n_deleted == 0 and idx.n_codes == 940
    assert all(len(s._chunks) <= 1 for s in idx._shards)
    rd, ri = ref_sk.topk_bruteforce(queries, codes[live], 6)
    _same(idx.query_topk(queries, 6), ref.query_topk(queries, 6),
          (rd, ri.astype(np.int64) + 7))


# -- the replica-aware server ------------------------------------------------------


def test_sharded_server_round_robin_bit_identical(corpus):
    codes, queries = corpus
    r1, r2 = _port(codes, 2), _port(codes, 3)
    rd, ri = ref_sk.topk_bruteforce(queries, codes, 5)
    with ShardedTopKServer([r1, r2], 5, max_delay_s=0.0) as srv:
        assert srv.n_replicas == 2 and srv.name == "sharded"
        # max_delay_s=0: one dispatch a request, strict round-robin
        for k in range(4):
            _same(srv.query(queries[k * 6:(k + 1) * 6]),
                  (rd[k * 6:(k + 1) * 6], ri[k * 6:(k + 1) * 6]))
        stats = srv.stats()
    assert stats["replicas"] == 2 and stats["replica_batches"] == [2, 2]
    assert stats["requests"] == 4


def test_sharded_server_validates_replicas(corpus):
    codes, _ = corpus
    r1 = _port(codes, 2)
    with pytest.raises(ValueError, match="replica 1 disagrees"):
        ShardedTopKServer([r1, _port(codes[:500], 2)], 5, start=False)
    r3 = _port(codes, 2, n_bits=codes.shape[1] * 8 - 3)
    with pytest.raises(ValueError, match="n_bits"):
        ShardedTopKServer([r1, r3], 5, start=False)
    with pytest.raises(ValueError, match="at least one replica"):
        ShardedTopKServer([], 5, start=False)
    with pytest.raises(ValueError, match="probe_policy requires LSH-tier "
                       "replicas.*replica 0"):
        ShardedTopKServer([r1], 5, probe_policy={"a": 2}, start=False)


def test_plain_topk_server_accepts_sharded_index(corpus):
    codes, queries = corpus
    idx = _port(codes, 2)
    with sk.TopKServer(idx, 4, max_delay_s=0.0) as srv:
        got = srv.query(queries)
    _same(got, ref_sk.topk_bruteforce(queries, codes, 4))


# -- telemetry: the reference's doctor reads the port's shard events -----------------


def test_shard_events_and_the_reference_doctor(tmp_path, corpus):
    codes, queries = corpus
    path = str(tmp_path / "events.jsonl")
    idx = _port(codes, 2)
    reg = tel.registry()
    b0, d0 = reg.counter("serve.shard.batches"), reg.counter("shard.dispatches")
    tel.configure(path)
    try:
        with ShardedTopKServer(idx, 5, max_delay_s=0.0) as srv:
            srv.query(queries)
        idx.query_topk(queries, 5)
    finally:
        tel.shutdown()
    names = [e["event"] for e in ref_tel.read_events(path)]
    assert {"shard.topk_tile", "shard.merge", "serve.shard.batch"} <= set(names)
    report = ref_report.build_report(path)
    sv = report["serving"]
    assert sv["shard_tiles"] == 2 and sv["shard_dispatches"] == 4
    assert sv["shard_merges"] == sv["shard_tiles"]
    assert sv["shard_batches"] == 1 and sv["shard_replicas_used"] == [0]
    assert report["unregistered_events"] == {}
    rendered = ref_report.render_report(report)
    assert "sharded tier:" in rendered and "replica routing:" in rendered
    from randomprojection_tpu_torch.utils import trace_report

    assert trace_report.build_report(path)["serving"] == sv
    assert reg.counter("serve.shard.batches") - b0 == 1
    assert reg.counter("shard.dispatches") - d0 == 4
    assert reg.gauge("serve.shard.merge_wall_s") is not None


def test_sharded_index_stats(corpus):
    codes, queries = corpus
    idx = _port(codes, 2)
    idx.query_topk(queries, 3)
    s = idx.stats()
    ref = ref_serving.ShardedSimHashIndex(codes, n_shards=2, topk_impl="scan")
    ref.query_topk(queries, 3)
    assert set(s) == set(ref.stats())
    assert s["shards"] == 2 and s["merges"] == 1 and s["merge_wall_s"] >= 0.0
    assert s["shard_rows"] == ref.stats()["shard_rows"]


@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_merge_tile_equals_the_reference_merge(corpus, n_shards):
    # tie-heavy shard columns as a shard finishes them (each row in
    # (distance, lower global id) order), merged by the port's packed-key
    # sort (one shard: passed through) and by the reference's lexsort
    codes, _ = corpus
    off = 2**31 + 13
    idx = _port(codes, n_shards, id_offset=off)
    ref = ref_serving.ShardedSimHashIndex(codes[:0], n_shards=n_shards,
                                          topk_impl="scan", id_offset=off)
    rng = np.random.default_rng(n_shards)
    m, rows = 9, 24
    d_parts, g_parts = [], []
    for si in range(n_shards):
        gids = idx._shard_gids(si)
        d = rng.integers(0, 4, size=(rows, gids.size)).astype(np.int32)
        order = np.lexsort((np.broadcast_to(gids, d.shape), d), axis=1)
        m_s = min(m, gids.size)
        d_parts.append(np.take_along_axis(d, order, axis=1)[:, :m_s])
        g_parts.append(gids[order][:, :m_s])
    merges = idx.stats()["merges"]
    got = idx._merge_tile(d_parts, g_parts, m)
    want = ref._merge_tile(d_parts, g_parts, m)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1]) and got[1].dtype == np.int64
    assert idx.stats()["merges"] == merges + 1


def test_construction_validation():
    with pytest.raises(ValueError, match="codes must be"):
        _port(np.zeros((2, 2, 2), np.uint8), 2)
    with pytest.raises(ValueError, match="id_offset"):
        _port(np.zeros((2, NB), np.uint8), 2, id_offset=-1)
    with pytest.raises(ValueError, match="n_bits"):
        _port(np.zeros((2, NB), np.uint8), 2, n_bits=NB * 8 + 1)
    # the kernel is the one top-k route: no topk_impl knob to pick a scan
    with pytest.raises(TypeError, match="topk_impl"):
        _port(np.zeros((2, NB), np.uint8), 2, topk_impl="scan")
    mesh = pmesh.make_mesh({"data": 2}, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="device= pins"):
        sk.SimHashIndex(np.zeros((2, NB), np.uint8), device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="hbm_budget_bytes= tiers"):
        sk.SimHashIndex(np.zeros((2, NB), np.uint8), mesh=mesh,
                        hbm_budget_bytes=1)


# -- SimHashIndex(mesh=) and pairwise_hamming_sharded ------------------------------


@pytest.mark.parametrize("p", [2, 4, 8])
def test_mesh_index_equals_the_reference_mesh_index(corpus, p):
    """The port splits each chunk into one row block a device (each a chunk
    scored by the kernel); the reference row-shards it under one scan
    program.  The routes differ, the answers do not."""
    codes, queries = corpus
    mesh = pmesh.make_mesh({"data": p}, devices=["cpu"] * p)
    idx = sk.SimHashIndex(codes[:700], mesh=mesh)
    ref = ref_sk.SimHashIndex(
        codes[:700], mesh=ref_mesh.make_mesh({"data": p}, jax.devices()[:p]))
    assert len(idx._chunks) == p and idx.mesh is mesh
    idx.add(codes[700:])
    ref.add(codes[700:])
    assert len(idx._chunks) == 2 * p
    for m in (7, 300):
        d, i = idx.query_topk(queries, m)
        rd, ri = ref.query_topk(queries, m)
        assert i.dtype == np.int32
        assert np.array_equal(d, rd) and np.array_equal(i, ri)
    assert np.array_equal(idx.query(queries), ref.query(queries))
    dead = np.arange(600, 760)  # across the chunk seam and the blocks
    idx.delete(dead)
    ref.delete(dead)
    d, i = idx.query_topk(queries, 9)
    rd, ri = _masked_ref(queries, codes, dead, 9)
    assert np.array_equal(d, rd) and np.array_equal(i, ri)
    assert np.array_equal(idx.compact(), ref.compact())
    assert len(idx._chunks) == p
    d, i = idx.query_topk(queries, 9)
    assert np.array_equal(d, rd) and np.array_equal(i, ref.query_topk(queries, 9)[1])


def test_pairwise_hamming_sharded_equals_the_reference(corpus):
    codes, queries = corpus
    mesh = pmesh.make_mesh({"data": 4}, devices=["cpu"] * 4)
    want = ref_sk.pairwise_hamming_sharded(
        queries, codes, mesh=ref_mesh.make_mesh({"data": 4}, jax.devices()[:4]))
    got = sk.pairwise_hamming_sharded(queries, codes, mesh=mesh, tile=10)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert np.array_equal(sk.pairwise_hamming_sharded(codes[:30], mesh=mesh),
                          ref_sk.pairwise_hamming(codes[:30]))


def test_package_exports_equal_the_reference():
    import randomprojection_tpu as ref
    import randomprojection_tpu_torch as port
    from randomprojection_tpu_torch import durable
    from randomprojection_tpu_torch.ann import lsh

    assert port.__all__ == ref.__all__
    for name in port.__all__:
        assert getattr(port, name) is not None
    assert port.ShardedSimHashIndex is ShardedSimHashIndex
    assert port.ShardedTopKServer is ShardedTopKServer
    assert port.shard_devices is shard_devices
    assert port.pairwise_hamming_sharded is sk.pairwise_hamming_sharded
    assert port.save_sharded_index is durable.save_sharded_index
    assert port.load_sharded_index is durable.load_sharded_index
    assert port.LSHShardedSimHashIndex is lsh.LSHShardedSimHashIndex
    assert port.load_lsh_sharded_index is lsh.load_lsh_sharded_index
    assert set(port.serving.__all__) == set(ref_serving.__all__)
