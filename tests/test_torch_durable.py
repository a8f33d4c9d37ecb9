"""Durable snapshots and exactly-once ingest against the JAX package.

- A snapshot saved by the reference loads in the port and one saved by
  the port loads in the reference; ``query_topk`` answers bit for bit
  (distances and ids), with tombstones, several chunks and ragged
  ``n_bits``; both packages write the same chunk checksums.
- The LSH tier's snapshot (band keys spilled beside the chunks) crosses
  both ways; a plain snapshot rebuilds the bands.
- A corrupted chunk raises ``ValueError`` and emits
  ``recover.checksum_mismatch``; ``verify_snapshot`` reports it.
- ``DurableIngest`` resumes an in-process ``FaultInjectionSource`` crash
  bit-identical to an uninterrupted run, and ``crash_smoke`` SIGKILLs real
  child processes at the four kill points (``mid-demotion`` in the child's
  disk-tiered leg) and resumes each to the clean run's codes, checksums
  and answers.
"""

import json
import os

import numpy as np
import pytest

from randomprojection_tpu import durable as ref_durable
from randomprojection_tpu.ann import lsh as ref_lsh
from randomprojection_tpu.models import sketch as ref_sk
from randomprojection_tpu.utils import telemetry as ref_tel
from randomprojection_tpu_torch import durable, streaming
from randomprojection_tpu_torch.ann import lsh
from randomprojection_tpu_torch.models import sketch as sk
from randomprojection_tpu_torch.utils import telemetry as tel

BANDS = dict(bands=4, band_bits=4)


def _codes(rows, nb=3, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(rows, nb),
                                                dtype=np.uint8)


def _ragged(rows, seed, n_bits=20, nb=3):
    """Codes of ``n_bits`` bits: the pad bits of the last byte are zero."""
    c = _codes(rows, nb, seed)
    c[:, -1] &= (1 << (n_bits - 8 * (nb - 1))) - 1
    return c


def _port_index(n_bits=20, device="cpu"):
    """Three chunks (one ragged) with tombstones across two of them."""
    idx = sk.SimHashIndex(_ragged(300, 1), n_bits=n_bits, device=device)
    idx.add(_ragged(77, 2))
    idx.add(_ragged(150, 3))
    idx.delete([0, 5, 299, 300, 376, 400])
    return idx


def _ref_index():
    idx = ref_sk.SimHashIndex(_ragged(300, 1), n_bits=20, topk_impl="scan")
    idx.add(_ragged(77, 2))
    idx.add(_ragged(150, 3))
    idx.delete([0, 5, 299, 300, 376, 400])
    return idx


def _answers(idx, m=7):
    return idx.query_topk(_ragged(40, 9), m, tile=16)


def _equal(a, b):
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
    np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))


def test_reference_snapshot_loads_in_the_port(tmp_path):
    live = _ref_index()
    ref_durable.save_index(live, str(tmp_path))
    got = durable.load_index(str(tmp_path), device="cpu")
    assert (got.n_codes, got.n_bits, got.n_deleted, len(got._chunks)) == (
        527, 20, 6, 3)
    assert [c.row0 for c in got._chunks] == [0, 300, 377]
    _equal(_answers(got), _answers(live))


def test_port_snapshot_loads_in_the_reference(tmp_path):
    live = _port_index()
    man = durable.save_index(live, str(tmp_path))
    got = ref_durable.load_index(str(tmp_path),
                                 index_kwargs={"topk_impl": "scan"})
    assert (got.n_codes, got.n_deleted, len(got._chunks)) == (527, 6, 3)
    _equal(_answers(got), _answers(live))
    # the same index saved by the reference: the same checksums
    ref_man = ref_durable.save_index(_ref_index(), str(tmp_path / "ref"))
    assert [e["sha256"] for e in man["chunks"]] == \
        [e["sha256"] for e in ref_man["chunks"]]
    assert man["tombstones"]["sha256"] == ref_man["tombstones"]["sha256"]
    for key in ("format_version", "kind", "n_bytes", "n_bits", "n_codes"):
        assert man[key] == ref_man[key]


def test_resave_advances_the_generation_and_sweeps(tmp_path):
    idx = _port_index()
    first = idx.save(str(tmp_path))
    idx.add(_ragged(10, 4))
    second = idx.save(str(tmp_path))
    assert second["generation"] == first["generation"] + 1
    files = set(os.listdir(tmp_path))
    assert {e["file"] for e in second["chunks"]} <= files
    assert not {e["file"] for e in first["chunks"]} & files
    back = sk.SimHashIndex.load(str(tmp_path), device="cpu")
    _equal(_answers(back), _answers(idx))
    status = durable.verify_snapshot(str(tmp_path))
    assert status["ok"] and status["orphan_chunks"] == []
    assert status == {**ref_durable.verify_snapshot(str(tmp_path)),
                      "path": str(tmp_path)}


def test_lsh_snapshot_crosses_both_ways(tmp_path):
    codes = _codes(900, seed=7)
    live = lsh.LSHSimHashIndex(codes[:600], device="cpu", probes=3, **BANDS)
    live.add(codes[600:])
    live.delete([3, 650])
    a = str(tmp_path / "port")
    man = live.save(a)
    assert man["lsh"]["bands"] == 4 and man["lsh"]["rows"] == 900
    got = ref_lsh.load_lsh_index(a)
    np.testing.assert_array_equal(got._buckets.keys, live._buckets.keys)
    q = _codes(12, seed=8)
    back = lsh.load_lsh_index(a, device="cpu", probe_path="host")
    assert (back.probes, back.band_plan) == (3, live.band_plan)
    _equal(back.query_topk(q, 5, probes=3), live.query_topk(q, 5, probes=3))
    # the reference's snapshot into the port, answered as the reference
    ref_live = ref_lsh.LSHSimHashIndex(codes, probes=3, topk_impl="scan",
                                       probe_path="host", **BANDS)
    b = str(tmp_path / "ref")
    ref_live.save(b)
    mine = lsh.LSHSimHashIndex.load(b, device="cpu", probe_path="host")
    np.testing.assert_array_equal(mine._buckets.keys, ref_live._buckets.keys)
    _equal(mine.query_topk(q, 5, probes=3), ref_live.query_topk(q, 5, probes=3))


def test_plain_snapshot_rebuilds_the_bands(tmp_path):
    codes = _codes(300, seed=9)
    sk.SimHashIndex(codes, device="cpu").save(str(tmp_path))
    got = lsh.load_lsh_index(str(tmp_path), device="cpu", **BANDS)
    want = lsh.LSHSimHashIndex(codes, device="cpu", **BANDS)
    np.testing.assert_array_equal(got._buckets.keys, want._buckets.keys)


def test_corrupt_lsh_keys_are_refused(tmp_path):
    live = lsh.LSHSimHashIndex(_codes(200, seed=10), device="cpu", **BANDS)
    man = live.save(str(tmp_path))
    keys = np.load(tmp_path / man["lsh"]["file"])
    keys[0, 0] ^= 1
    np.save(tmp_path / man["lsh"]["file"], keys)
    with pytest.raises(ValueError, match="checksum"):
        lsh.load_lsh_index(str(tmp_path), device="cpu")


def test_corrupt_chunk_is_refused_and_reported(tmp_path):
    snap = str(tmp_path / "snap")
    man = _port_index().save(snap)
    arr = np.load(os.path.join(snap, man["chunks"][1]["file"]))
    arr[0, 0] ^= 0xFF
    np.save(os.path.join(snap, man["chunks"][1]["file"]), arr)
    log = str(tmp_path / "events.jsonl")
    tel.configure(log)
    try:
        with pytest.raises(ValueError, match="fails checksum"):
            durable.load_index(snap, device="cpu")
        status = durable.verify_snapshot(snap)
    finally:
        tel.shutdown()
    assert not status["ok"] and status["corrupt"][0]["file"] == man["chunks"][1]["file"]
    events = [e for e in ref_tel.read_events(log)
              if e["event"] == "recover.checksum_mismatch"]
    assert len(events) == 2 and events[0]["file"] == man["chunks"][1]["file"]


def test_manifest_refusals(tmp_path):
    snap = str(tmp_path)
    durable.save_index(_port_index(), snap)
    path = os.path.join(snap, durable.MANIFEST_NAME)
    good = json.loads(open(path).read())
    for change, match in (
        ({"format_version": 2}, "Unsupported index manifest version"),
        ({"kind": "other"}, "not a SimHash index"),
        ({"id_offset": 100}, "ROADMAP A10"),
        ({"tier": {"format": 1, "cold_tier": "tape"}}, "unknown cold_tier"),
        ({"n_codes": 1}, "chunks cover"),
    ):
        with open(path, "w") as f:
            json.dump({**good, **change}, f)
        with pytest.raises(ValueError, match=match):
            durable.load_index(snap, device="cpu")
    with pytest.raises(ValueError, match="ROADMAP A10"):
        durable.load_index(snap, device="cpu", mesh=object())
    # a valid tier block loads, every chunk resident
    tier = {"format": 1, "cold_tier": "host", "hbm_budget_bytes": 1,
            "chunks": [{"row0": e["row0"], "rows": e["rows"], "tier": "host"}
                       for e in good["chunks"]]}
    with open(path, "w") as f:
        json.dump({**good, "tier": tier}, f)
    got = durable.load_index(snap, device="cpu")
    _equal(_answers(got), _answers(_port_index()))
    assert durable.verify_snapshot(snap)["tier"]["cold_chunks"] == 3


def _sign(rows=160, d=24, bits=20):
    from randomprojection_tpu_torch.models.sketch import SignRandomProjection

    source = durable._demo_source(rows, 32, d, 0, "cpu")
    est = SignRandomProjection(bits, random_state=3, backend="torch",
                               backend_options={"device": "cpu"})
    return est.fit_source(source), source


def test_ingest_resumes_an_in_process_fault_bit_identical(tmp_path):
    est, source = _sign()
    clean = durable.DurableIngest(str(tmp_path / "clean"), device="cpu",
                                  commit_every_batches=2).run(est, source)
    faulty = streaming.FaultInjectionSource(source, fail_after_batches=3)
    ingest = durable.DurableIngest(str(tmp_path / "cut"), device="cpu",
                                   commit_every_batches=2)
    with pytest.raises(streaming.FaultInjectionSource.InjectedFault):
        ingest.run(est, faulty)
    assert ingest.rows_done() == 64  # batches 0-1 committed, 2 pending
    with pytest.raises(streaming.FaultInjectionSource.InjectedFault):
        ingest.run(est, faulty)  # still armed: batch 3 faults again
    faulty.disarm()
    resumed = ingest.run(est, faulty)
    assert ingest.rows_done() == 160
    np.testing.assert_array_equal(durable._codes_of(str(tmp_path / "cut")),
                                  durable._codes_of(str(tmp_path / "clean")))
    q = _codes(6, nb=3, seed=11)
    _equal(resumed.query_topk(q, 4), clean.query_topk(q, 4))
    # the reference's loader reads the ingest directory
    got = ref_durable.load_index(str(tmp_path / "cut"),
                                 index_kwargs={"topk_impl": "scan"})
    _equal(got.query_topk(q, 4), clean.query_topk(q, 4))


def test_ingest_compaction_and_refusals(tmp_path):
    est, source = _sign()
    path = str(tmp_path / "c")
    index = durable.DurableIngest(path, commit_every_batches=1, device="cpu",
                                  compact_after_chunks=3).run(est, source)
    # five batches, folded at three chunks and again at the fifth commit
    man = durable.read_manifest(path)
    assert man["ingest"]["rows_done"] == 160 and len(man["chunks"]) == 1
    assert len(index._chunks) == 1 and man["generation"] == 2
    plain = durable.DurableIngest(str(tmp_path / "p"), device="cpu").run(
        est, source)
    assert len(plain._chunks) == 5
    np.testing.assert_array_equal(durable._codes_of(path),
                                  durable._codes_of(str(tmp_path / "p")))
    with pytest.raises(ValueError, match="commit_every_batches"):
        durable.DurableIngest(path, commit_every_batches=0)
    with pytest.raises(ValueError, match="compact_after_chunks"):
        durable.DurableIngest(path, compact_after_chunks=1)
    other, _ = _sign()
    other.spec_ = type(other.spec_)(**{**other.spec_.to_dict(), "seed": 4})
    with pytest.raises(ValueError, match="mix two projections"):
        durable.DurableIngest(path, device="cpu").run(other, source)
    plain = str(tmp_path / "plain")
    _port_index().save(plain)
    with pytest.raises(ValueError, match="plain index snapshot"):
        durable.DurableIngest(plain, device="cpu").run(est, source)
    from randomprojection_tpu_torch.models.projections import (
        GaussianRandomProjection,
    )

    gauss = GaussianRandomProjection(8, backend_options={"device": "cpu"})
    with pytest.raises(ValueError, match="packed uint8 codes"):
        durable.DurableIngest(str(tmp_path / "g"), device="cpu").run(
            gauss.fit_source(source), source)


def test_ingest_encodes_on_one_cpu_thread(tmp_path):
    """On the CPU the run holds torch to one intra-op thread while it
    encodes (a replayed batch must give the same bits under any load) and
    gives the caller's count back after."""
    import torch

    from randomprojection_tpu_torch.streaming import CallableSource

    est, source = _sign()
    seen = []

    def read(lo, hi):
        seen.append(torch.get_num_threads())
        return source._read(lo, hi)

    counted = CallableSource(read, source.n_rows, source.n_features,
                             dtype=np.float32, batch_rows=32)
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        durable.DurableIngest(str(tmp_path / "t"), device="cpu").run(
            est, counted)
        assert seen and set(seen) == {1}
        assert torch.get_num_threads() == 2
    finally:
        torch.set_num_threads(before)


@pytest.mark.parametrize("entry", ["demo_ingest", "run_child", "crash_smoke",
                                   "child_command"])
def test_harness_entry_points_default_to_the_card(entry, tmp_path,
                                                  monkeypatch):
    """With no device the harness runs on the card, as every entry point
    of the port does, and says how to ask for the CPU where there is none."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "x")
    if entry == "child_command":
        with pytest.raises(RuntimeError, match="--device cpu"):
            durable._main(["--child", path])
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            getattr(durable, entry)(path)
    assert not os.path.exists(path)


@pytest.fixture(scope="module")
def kill_matrix(tmp_path_factory):
    return durable.crash_smoke(str(tmp_path_factory.mktemp("crash")),
                               device="cpu", timeout=120)


@pytest.mark.parametrize("point", durable.KILL_POINTS)
def test_crash_smoke_kill_point_resumes_bit_identical(kill_matrix, point):
    case = {c["kill_at"]: c for c in kill_matrix["cases"]}[f"{point}@3"]
    assert case.get("error") is None, case
    assert case["crash_returncode"] == -9 and case["resume_returncode"] == 0
    assert case["rows_done"] == 192
    assert case["bit_identical_codes"] and case["manifest_chunks_identical"]
    assert case["query_results_match"]


def test_crash_smoke_verdict(kill_matrix):
    assert kill_matrix["ok"], kill_matrix
    assert [c["kill_at"] for c in kill_matrix["cases"]] == [
        f"{p}@3" for p in durable.KILL_POINTS]


def test_child_command_runs_one_ingest(tmp_path):
    proc = durable.run_child(str(tmp_path / "x"), rows=64, batch_rows=16,
                             commit_every=2, compact_after=2, device="cpu",
                             timeout=120)
    assert proc.returncode == 0, proc.stderr
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary == {"path": str(tmp_path / "x"), "rows_done": 64,
                       "n_codes": 64, "chunks": 1, "tier_demotions": 1}
