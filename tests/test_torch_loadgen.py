"""The port's open-loop load generator and the CLI's serving and recovery
commands against the JAX package's.

``build_schedule`` and ``schedule_digest`` are the reference's for both
arrival processes over several seeds, and raise its errors; ``slo_table``
is the reference's; ``loadgen.run`` against a port ``TopKServer`` returns
a record with the reference's keys; ``loadgen --device cpu`` (exact and
LSH, the live plane on, served by the sharded tier as the reference's is),
``topk-bench --device cpu`` (with its sharded leg) and ``recover``
(status and ``--smoke --device cpu``) end with the reference's record
keys; one seed gives one schedule through the CLI; the reference's doctor
reads the shard events of a sharded ``loadgen``.
"""

import json

import numpy as np
import pytest

from randomprojection_tpu import cli as ref_cli
from randomprojection_tpu import loadgen as ref_loadgen
from randomprojection_tpu_torch import cli, loadgen
from randomprojection_tpu_torch.utils import telemetry


@pytest.fixture(autouse=True)
def _no_live_plane_left():
    yield
    assert not telemetry._SUBSCRIPTIONS and cli._METRICS_SERVER is None


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
@pytest.mark.parametrize("kw", [
    dict(duration_s=2.0, rate_qps=150.0),
    dict(duration_s=3.0, rate_qps=80.0, arrival="bursty"),
    dict(duration_s=2.0, rate_qps=60.0, arrival="bursty", burst_factor=2.0,
         burst_fraction=0.25, burst_period_s=0.5, request_rows=(4, 8, 32),
         row_weights=(1, 0, 3), labels=("x", "y", "z")),
])
def test_schedule_and_digest_equal_the_reference(seed, kw):
    got = loadgen.build_schedule(seed=seed, **kw)
    want = ref_loadgen.build_schedule(seed=seed, **kw)
    assert [tuple(r) for r in got] == [tuple(r) for r in want]
    assert got and loadgen.schedule_digest(got) == \
        ref_loadgen.schedule_digest(want)


def test_bursty_default_confines_arrivals_to_the_on_window():
    sched = loadgen.build_schedule(seed=3, duration_s=3.0, rate_qps=100.0,
                                   arrival="bursty")
    assert sched and all((r.t % 1.0) < 0.125 for r in sched)


@pytest.mark.parametrize("kw", [
    dict(arrival="uniform"), dict(duration_s=0), dict(rate_qps=-1),
    dict(labels=()), dict(request_rows=(0,)), dict(request_rows=()),
    dict(row_weights=(1,)), dict(row_weights=(0, 0, 0)),
    dict(arrival="bursty", burst_fraction=1.0),
    dict(arrival="bursty", burst_factor=10.0),
    dict(arrival="bursty", burst_period_s=0),
])
def test_schedule_validation_equals_the_reference(kw):
    args = dict(seed=0, duration_s=1.0, rate_qps=10.0)
    args.update(kw)
    with pytest.raises(ValueError) as want:
        ref_loadgen.build_schedule(**args)
    with pytest.raises(ValueError) as got:
        loadgen.build_schedule(**args)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("lats,kw", [
    ([], {}), ([0.004], {"rows": 3}),
    (list(np.random.default_rng(0).exponential(0.01, 501)),
     {"rows": 90, "rejects": 4}),
])
def test_slo_table_equals_the_reference(lats, kw):
    assert loadgen.slo_table(lats, **kw) == ref_loadgen.slo_table(lats, **kw)


def test_run_record_has_the_reference_keys():
    from randomprojection_tpu.models.sketch import SimHashIndex as RefIndex
    from randomprojection_tpu.models.sketch import TopKServer as RefServer
    from randomprojection_tpu_torch.models.sketch import (
        SimHashIndex,
        TopKServer,
    )

    codes = np.random.default_rng(0).integers(0, 256, size=(600, 8),
                                              dtype=np.uint8)
    sched = loadgen.build_schedule(seed=2, duration_s=0.5, rate_qps=60.0,
                                   request_rows=(2, 4))
    with TopKServer(SimHashIndex(codes, device="cpu"), 3,
                    max_delay_s=0.001, name="lg-port") as srv:
        got = loadgen.run(srv, sched, code_bytes=8, seed=2, warmup_rows=4)
    with RefServer(RefIndex(codes, topk_impl="scan"), 3, max_delay_s=0.001,
                   name="lg-ref") as srv:
        want = ref_loadgen.run(srv, sched, code_bytes=8, seed=2,
                               warmup_rows=4)
    assert set(got) == set(want)
    assert got["schedule_sha256"] == want["schedule_sha256"]
    assert got["requests"] == want["requests"] == len(sched)
    assert set(got["labels"]) == set(want["labels"])
    for label, row in got["labels"].items():
        assert set(row) == set(want["labels"][label])
        assert row["count"] == want["labels"][label]["count"]
    # the warm-up is one of the server's coalesced batches
    assert got["server"]["requests"] == len(sched) + 1


class _StallingServer:
    """Answers at once, but its first ``submit`` stalls the submitter."""

    def __init__(self, stall_s):
        self.stall_s = stall_s
        self.calls = 0

    def submit(self, codes, *, label=None):
        import time
        from concurrent.futures import Future

        self.calls += 1
        if self.calls == 1:
            time.sleep(self.stall_s)
        fut = Future()
        fut.set_result((None, None))
        return fut

    def stats(self):
        return {}


def test_run_stamps_latency_from_the_due_time():
    # four requests due within 3 ms; the first submit holds the generator
    # for 0.2 s, so the three behind it are late by ~0.2 s each and their
    # latencies say so (stamped from submit they would read ~0)
    sched = [loadgen.ScheduledRequest(t, "a", 1)
             for t in (0.0, 0.001, 0.002, 0.003)]
    rec = loadgen.run(_StallingServer(0.2), sched, code_bytes=8)
    assert rec["total"]["count"] == 4
    assert rec["max_lag_s"] >= 0.19
    assert rec["total"]["p50_ms"] >= 190.0
    assert rec["total"]["max_ms"] >= 200.0


def _loadgen_argv(*extra):
    return ["loadgen", "--rate", "60", "--duration", "0.5",
            "--index-codes", "512", "--code-bytes", "8", "--m", "4",
            "--request-rows", "4,8", *extra]


@pytest.mark.parametrize("extra", [
    [],
    ["--probes", "2"],
    ["--probes", "tenant-a=2,tenant-b=0", "--arrival", "bursty"],
])
def test_cli_loadgen_ends_with_the_reference_record(capsys, tmp_path, extra):
    ref_cli.main(_loadgen_argv("--topk-impl", "scan", *extra))
    want = _last_json(capsys.readouterr().out)
    out = tmp_path / "slo.json"
    cli.main(_loadgen_argv("--device", "cpu", "--out", str(out), *extra))
    got = _last_json(capsys.readouterr().out)
    assert set(got) == set(want)
    assert got["schedule_sha256"] == want["schedule_sha256"]
    assert got["probe_policy"] == want["probe_policy"]
    assert got["probes"] == want["probes"]
    for label, row in got["labels"].items():
        assert set(row) == set(want["labels"][label])
    assert json.loads(out.read_text()) == got


def test_cli_loadgen_seed_pins_the_schedule(capsys):
    shas = []
    for seed in ("5", "5", "6"):
        cli.main(_loadgen_argv("--device", "cpu", "--seed", seed))
        shas.append(_last_json(capsys.readouterr().out)["schedule_sha256"])
    assert shas[0] == shas[1] != shas[2]


def test_cli_loadgen_with_the_live_plane(capsys, tmp_path):
    from randomprojection_tpu.utils.metrics_server import parse_openmetrics

    om, jsonl = tmp_path / "m.txt", tmp_path / "t.jsonl"
    cli.main(_loadgen_argv(
        "--device", "cpu", "--metrics-port", "0", "--health", "25,tenant-a=10",
        "--flight-dump", str(tmp_path / "f.json"), "--telemetry-jsonl",
        str(jsonl), "--openmetrics", str(om)))
    rec = _last_json(capsys.readouterr().out)
    assert rec["slo_targets"] == {"default_ms": 25.0,
                                  "labels": {"tenant-a": 10.0},
                                  "spec": "25,tenant-a=10"}
    plain, labeled = parse_openmetrics(om.read_text())
    assert "rp_serve_latency_sharded_seconds_bucket" in labeled
    assert plain["rp_serve_topk_batches_total"] >= rec["server"]["batches"]
    events = list(telemetry.read_events(str(jsonl)))
    servers = {e.get("server") for e in events
               if e["event"] == telemetry.EVENTS.SERVE_LATENCY_REQUEST}
    assert servers == {"sharded"}
    # the sharded tier serves (one shard, one replica): each coalesced
    # batch is one routed dispatch, one shard tile and one merge
    names = [e["event"] for e in events]
    batches = names.count("serve.topk_batch")
    assert batches >= rec["server"]["batches"]
    assert names.count("serve.shard.batch") == batches
    assert names.count("shard.topk_tile") == names.count("shard.merge") \
        == batches
    assert plain["rp_serve_shard_batches_total"] >= rec["server"]["batches"]
    assert rec["server"]["replica_batches"] == [rec["server"]["batches"]]


@pytest.mark.parametrize("cmd,argv,message", [
    ("loadgen", ["--rate", "0"], "rate_qps"),
    ("loadgen", ["--labels", ","], "--labels"),
    ("loadgen", ["--probes", "a=-1"], "non-negative"),
    ("loadgen", ["--probes", "x"], "--probes"),
    ("loadgen", ["--health", "bogus"], "--health"),
    ("loadgen", ["--metrics-port", "70000"], "--metrics-port"),
    ("topk-bench", ["--probes", "0"], "--probes"),
    ("topk-bench", ["--topk-impl", "scan"], "no scan route"),
])
def test_cli_serving_commands_refuse_bad_flags(cmd, argv, message):
    with pytest.raises(SystemExit) as info:
        cli.main([cmd, "--device", "cpu", "--index-codes", "64", *argv])
    assert message in str(info.value.code)


def test_cli_topk_bench_ends_with_the_reference_record(capsys):
    small = ["--index-codes", "512", "--code-bytes", "8", "--queries", "32",
             "--request-rows", "8", "--clients", "2", "--m", "4",
             "--probes", "1,2", "--lsh-bands", "4", "--lsh-band-bits", "4",
             "--hbm-budget", "1024"]
    sharded = ["--shards", "2", "--replicas", "2"]
    ref_cli.main(["topk-bench", "--topk-impl", "scan", *sharded, *small])
    want = _last_json(capsys.readouterr().out)
    cli.main(["topk-bench", "--device", "cpu", *sharded, *small])
    got = _last_json(capsys.readouterr().out)
    assert set(got) - {"device"} == set(want)
    assert got["device"] == "cpu" and got["topk_impl"] == "plain"
    assert set(got["lsh"]) == set(want["lsh"])
    assert [p["recall_at_m"] for p in got["lsh"]["curve"]] == \
        [p["recall_at_m"] for p in want["lsh"]["curve"]]
    assert set(got["tiered"]) == set(want["tiered"])
    assert got["tiered"]["parity_ok"] and got["tiered"]["fallbacks"] == 0
    sharded = got["sharded"]
    assert set(sharded) == set(want["sharded"])
    assert sharded["shards"] == sharded["replicas"] == 2
    assert sharded["merges"] >= 1 and len(sharded["replica_batches"]) == 2
    assert min(sharded["replica_batches"]) >= 1


def test_sharded_loadgen_events_read_by_the_reference_doctor(capsys,
                                                             tmp_path):
    from randomprojection_tpu.utils import trace_report as ref_report

    jsonl = str(tmp_path / "t.jsonl")
    cli.main(_loadgen_argv("--device", "cpu", "--shards", "3", "--replicas",
                           "2", "--telemetry-jsonl", jsonl))
    rec = _last_json(capsys.readouterr().out)
    assert rec["shards"] == 3 and rec["replicas"] == 2
    assert sum(rec["server"]["replica_batches"]) == rec["server"]["batches"]
    report = ref_report.build_report(jsonl)
    sv = report["serving"]
    assert sv["shard_batches"] == rec["server"]["batches"]
    assert sv["shard_dispatches"] == 3 * sv["shard_tiles"]
    assert sv["shard_merges"] == sv["shard_tiles"]
    assert sv["shard_replicas_used"] == [0, 1]
    assert report["unregistered_events"] == {}


def test_cli_recover_status_and_smoke(capsys, tmp_path):
    from randomprojection_tpu import durable as ref_durable
    from randomprojection_tpu_torch import durable
    from randomprojection_tpu_torch.models.sketch import SimHashIndex

    codes = np.random.default_rng(1).integers(0, 256, size=(300, 8),
                                              dtype=np.uint8)
    snap = str(tmp_path / "snap")
    durable.save_index(SimHashIndex(codes, device="cpu"), snap)
    assert cli.main(["recover", snap]) == 0
    got = _last_json(capsys.readouterr().out)
    assert got["ok"] and set(got) == set(ref_durable.verify_snapshot(snap))
    assert cli.main(["recover", str(tmp_path / "none")]) == 1
    capsys.readouterr()
    with pytest.raises(SystemExit):
        cli.main(["recover"])
    work = str(tmp_path / "smoke")
    assert cli.main(["recover", "--smoke", "--device", "cpu", work]) == 0
    verdict = _last_json(capsys.readouterr().out)
    assert verdict["ok"] is True
    assert {"ok", "cases"} <= set(verdict)
    assert all(c["crash_returncode"] == -9 for c in verdict["cases"])
