"""The port's CLI (``python -m randomprojection_tpu_torch``) against the
JAX package's.

``jl-dim`` prints the reference's number; ``info --device cpu`` runs;
``project`` on the numpy backend writes the reference CLI's ``.npy`` bit
for bit and on the torch backend (CPU) within ``1e-5·max|Y|`` of the
reference's JAX backend (the same threefry matrix); a checkpointed
``project`` cut mid-run resumes through its fingerprint sidecar to the
one-shot output and refuses a changed fingerprint; ``stream-bench
--device cpu`` prints the reference's JSON keys and runs under each
live-plane flag; the ops planes' subcommands run on the CPU, and
``topk-bench``/``loadgen`` serve shards and replicas through the sharded
tier; the JAX-only flags exit non-zero naming why; ``lint`` (ROADMAP
A14) runs rplint: exit 0 on the tree, 1 on a seeded file; with no card
and no ``--device cpu`` a command exits naming the card; ``bench
--device cpu`` at toy shapes ends with the compact line the reference
reads, and refuses ``--transform-dma`` but ``auto``.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from randomprojection_tpu import cli as ref_cli
from randomprojection_tpu_torch import cli, streaming

REPO = Path(__file__).resolve().parents[1]


def _json_line(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture
def matrix(tmp_path):
    X = np.random.default_rng(11).normal(size=(700, 96)).astype(np.float32)
    path = tmp_path / "x.npy"
    np.save(path, X)
    return X, str(path)


@pytest.mark.parametrize("n,eps", [(1000, 0.1), (10**6, 0.25)])
def test_jl_dim_prints_the_reference(capsys, n, eps):
    argv = ["jl-dim", "--n-samples", str(n), "--eps", str(eps)]
    ref_cli.main(argv)
    want = capsys.readouterr().out
    cli.main(argv)
    assert capsys.readouterr().out == want


def test_info_on_the_cpu(capsys):
    cli.main(["info", "--device", "cpu"])
    info = json.loads(capsys.readouterr().out)
    assert info["device"] == "cpu" and "torch" in info["backends"]
    assert info["native_murmur3"] is True


@pytest.mark.parametrize("kind,extra", [
    ("sparse", ["--density", "0.25"]),
    ("gaussian", []),
    ("sign", []),
])
def test_project_numpy_equals_the_reference_cli(matrix, tmp_path, kind, extra):
    _, x = matrix
    common = ["--input", x, "--kind", kind, "--n-components", "24",
              "--backend", "numpy", "--batch-rows", "128", "--seed", "5",
              *extra]
    ref_cli.main(["project", "--output", str(tmp_path / "ref.npy"), *common])
    cli.main(["project", "--output", str(tmp_path / "port.npy"), *common])
    want, got = np.load(tmp_path / "ref.npy"), np.load(tmp_path / "port.npy")
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("staged", [False, True])
def test_project_torch_cpu_close_to_the_reference_jax(matrix, tmp_path,
                                                      staged):
    _, x = matrix
    common = ["--input", x, "--kind", "sparse", "--n-components", "32",
              "--density", "0.3333333", "--batch-rows", "128", "--seed", "2"]
    ref_cli.main(["project", "--output", str(tmp_path / "ref.npy"),
                  "--backend", "jax", *common])
    flow = ["--ingest-workers", "3"] if staged else ["--prefetch-batches", "2"]
    cli.main(["project", "--output", str(tmp_path / "port.npy"),
              "--device", "cpu", *flow, *common])
    want, got = np.load(tmp_path / "ref.npy"), np.load(tmp_path / "port.npy")
    assert got.shape == want.shape == (700, 32)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_project_resume_through_the_sidecar(matrix, tmp_path, monkeypatch,
                                            capsys):
    X, x = matrix
    out, ckpt = str(tmp_path / "y.npy"), str(tmp_path / "y.cursor")
    argv = ["project", "--input", x, "--output", out, "--kind", "sparse",
            "--n-components", "16", "--device", "cpu", "--batch-rows", "64",
            "--checkpoint", ckpt, "--ingest-workers", "2"]
    cli.main(["project", "--input", x, "--output", str(tmp_path / "one.npy"),
              "--kind", "sparse", "--n-components", "16", "--device", "cpu",
              "--batch-rows", "64"])
    one_shot = np.load(tmp_path / "one.npy")

    real = streaming.ArraySource

    class CutSource(real):
        """The first run's source dies at its 5th batch."""

        def iter_batches(self, start_row=0):
            for lo, b in super().iter_batches(start_row):
                if lo >= 4 * 64:
                    raise RuntimeError("cut")
                yield lo, b

    monkeypatch.setattr(streaming, "ArraySource", CutSource)
    with pytest.raises(RuntimeError, match="cut"):
        cli.main(argv)
    monkeypatch.setattr(streaming, "ArraySource", real)
    cursor = streaming.StreamCursor.load(ckpt).rows_done
    assert 0 < cursor < X.shape[0]
    meta = json.loads(Path(ckpt + ".meta.json").read_text())
    assert meta["device"] == "cpu" and meta["kind"] == "sparse"

    # a changed fingerprint is refused before any work
    with pytest.raises(SystemExit, match="different parameters"):
        cli.main([*argv[:-2], "--seed", "9", *argv[-2:]])
    capsys.readouterr()
    cli.main(argv)
    summary = _json_line(capsys.readouterr().out)
    assert summary["rows"] == X.shape[0] - cursor
    np.testing.assert_array_equal(np.load(out), one_shot)
    with pytest.raises(SystemExit, match="completed run"):
        cli.main(argv)


def test_stream_bench_prints_the_reference_keys(capsys):
    small = ["--rows", "2048", "--batch-rows", "512", "--d", "64", "--k",
             "16", "--kind", "sparse", "--density", "0.3333333"]
    ref_cli.main(["stream-bench", "--backend", "numpy",
                  "--prefetch-batches", "2", *small])
    want = _json_line(capsys.readouterr().out)
    cli.main(["stream-bench", "--device", "cpu", "--materialization", "lazy",
              "--precision", "split2", "--ingest-workers", "4", *small])
    got = _json_line(capsys.readouterr().out)
    assert set(want) <= set(got)
    assert got["rows"] == 2048 and got["unit"] == "rows/s"
    assert got["device"] == "cpu" and got["ingest_workers"] == 4
    assert {"h2d", "dispatch", "d2h"} <= set(got["stage_wall_s"])
    assert got["backend_options"] == {"precision": "split2",
                                      "materialization": "lazy"}


def test_stream_bench_reader_rolls_the_template():
    t = np.arange(12, dtype=np.float32).reshape(6, 2)
    read = cli.template_roll_reader(t, batch_rows=4)
    np.testing.assert_array_equal(read(0, 4), t[:4])
    np.testing.assert_array_equal(read(4, 8), np.roll(t, -1, axis=0)[:4])
    np.testing.assert_array_equal(read(24, 26), t[:2])  # the shift wraps


@pytest.mark.parametrize("argv,message", [
    (["--debug-nans"], "jax.config"),
    (["--disable-jit"], "jax.config"),
    (["--transform-dma", "on"], "TPU kernel route"),
    (["--transform-dma", "auto"], "TPU kernel route"),
])
def test_later_and_jax_only_flags_refuse(argv, message):
    with pytest.raises(SystemExit) as info:
        cli.main(["stream-bench", "--device", "cpu", "--rows", "8",
                  "--batch-rows", "8", "--d", "8", "--k", "8", *argv])
    assert message in str(info.value.code)


@pytest.mark.parametrize("flag", [
    ["--openmetrics", "m.txt"], ["--metrics-port", "0"], ["--health"],
    ["--flight-dump", "f.json"],
])
def test_live_plane_flags_run_on_the_cpu(capsys, tmp_path, monkeypatch, flag):
    from randomprojection_tpu_torch.utils import telemetry

    monkeypatch.chdir(tmp_path)
    cli.main(["stream-bench", "--device", "cpu", "--rows", "64",
              "--batch-rows", "32", "--d", "8", "--k", "4", *flag])
    assert _json_line(capsys.readouterr().out)["rows"] == 64
    if flag[0] == "--openmetrics":
        text = (tmp_path / "m.txt").read_text()
        assert "rp_stream_rows_total 64" in text and text.endswith("# EOF\n")
    assert not telemetry._SUBSCRIPTIONS and cli._METRICS_SERVER is None


@pytest.mark.parametrize("cmd,item", [("lint", "A14")])
def test_later_subcommands_refuse_naming_their_item(cmd, item, tmp_path,
                                                    capsys):
    """No subcommand refuses any more: ``lint``, the last one (ROADMAP
    item A14), runs rplint over the tree (exit 0) and over a seeded file
    (exit 1), host code with no ``--device``."""
    assert cli.main([cmd, "--jobs", "2"]) == 0
    assert "rplint: clean" in capsys.readouterr().out
    seeded = tmp_path / "seeded.py"
    seeded.write_text("import threading\n"
                      "t = threading.Thread(target=print)\n")
    assert cli.main([cmd, str(seeded)]) == 1
    assert "RP04" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli.main([cmd, "--device", "cpu"])


@pytest.mark.parametrize("cmd", [
    "topk-bench --shards 2", "topk-bench --replicas 2",
    "loadgen --shards 2", "loadgen --replicas 2",
    "topk-bench --shards 8 --replicas 2", "loadgen --shards 2 --replicas 2",
])
def test_shards_and_replicas_serve_the_sharded_tier(capsys, cmd):
    """What replaced the refusals of a second shard or replica: the
    sharded tier serves them, ``ShardedSimHashIndex`` groups behind
    ``ShardedTopKServer`` (the reference's layout)."""
    name, *flags = cmd.split()
    asked = dict(zip(flags[::2], map(int, flags[1::2])))
    argv = [name, *flags, "--device", "cpu", "--index-codes", "64",
            "--code-bytes", "8", "--m", "3"]
    if name == "topk-bench":
        # --replicas alone serves no sharded leg in the reference either
        asked.setdefault("--shards", 3)
        argv += ["--shards", str(asked["--shards"]), "--queries", "16",
                 "--request-rows", "8", "--clients", "2"]
    else:
        argv += ["--rate", "40", "--duration", "0.3", "--request-rows", "2,4"]
    cli.main(argv)
    rec = _json_line(capsys.readouterr().out)
    shards, replicas = asked.get("--shards", 1), asked.get("--replicas", 1)
    if name == "topk-bench":
        sh = rec["sharded"]
        assert (sh["shards"], sh["replicas"]) == (shards, replicas)
        assert sh["merges"] >= 1 and len(sh["replica_batches"]) == replicas
    else:
        assert (rec["shards"], rec["replicas"]) == (shards, replicas)
        assert len(rec["server"]["replica_batches"]) == replicas
        assert sum(rec["server"]["replica_batches"]) == rec["server"]["batches"]
        assert rec["errors"] == 0


@pytest.mark.parametrize("cmd", ["topk-bench", "loadgen", "recover",
                                 "doctor", "report"])
def test_ops_subcommands_run_on_the_cpu(capsys, tmp_path, cmd):
    """The ops planes' subcommands at toy shapes on the CPU (their records
    are held to the reference's in tests/test_torch_loadgen.py and
    tests/test_torch_live_plane.py)."""
    from randomprojection_tpu_torch import durable
    from randomprojection_tpu_torch.models.sketch import SimHashIndex

    codes = np.random.default_rng(2).integers(0, 256, size=(256, 8),
                                              dtype=np.uint8)
    jsonl = str(tmp_path / "t.jsonl")
    loadgen = ["--rate", "40", "--duration", "0.3", "--index-codes", "256",
               "--code-bytes", "8", "--m", "3", "--request-rows", "2,4",
               "--device", "cpu", "--telemetry-jsonl", jsonl]
    argv = {
        "topk-bench": ["--index-codes", "256", "--code-bytes", "8",
                       "--queries", "16", "--request-rows", "8",
                       "--clients", "2", "--m", "3", "--device", "cpu"],
        "loadgen": loadgen,
        "recover": [str(tmp_path / "snap")],
        "doctor": [jsonl],
        "report": ["--json", jsonl],
    }[cmd]
    if cmd == "recover":
        durable.save_index(SimHashIndex(codes, device="cpu"),
                           str(tmp_path / "snap"))
    if cmd in ("doctor", "report"):
        cli.main(["loadgen", *loadgen])
        capsys.readouterr()
    rv = cli.main([cmd, *argv])
    out = capsys.readouterr().out
    assert rv in (None, 0)
    if cmd == "doctor":
        assert "serve latency" in out and "sharded[tenant-" in out
    else:
        rec = _json_line(out)
        key = {"topk-bench": "direct_queries_per_s", "loadgen": "metric",
               "recover": "ok", "report": "latency"}[cmd]
        assert rec[key]


@pytest.mark.parametrize("argv", [
    ["stream-bench", "--rows", "8", "--batch-rows", "8", "--d", "8"],
    ["project", "--input", "x.npy", "--output", "y.npy"],
    ["info"],
    ["bench"],
    ["topk-bench"],
    ["loadgen"],
    ["recover", "--smoke"],
])
def test_no_card_exits_naming_it(monkeypatch, capsys, argv):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as info:
        cli.main(argv)
    assert "no CUDA card" in str(info.value.code)
    assert "--device cpu" in str(info.value.code)


def test_module_entry_point_runs():
    r = subprocess.run(
        [sys.executable, "-m", "randomprojection_tpu_torch", "jl-dim",
         "--n-samples", "500"],
        capture_output=True, text=True, cwd=REPO, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    assert int(r.stdout) > 0
    r = subprocess.run(
        [sys.executable, "-m", "randomprojection_tpu_torch", "lint",
         "--jobs", "2"],
        capture_output=True, text=True, cwd=REPO, timeout=120,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("rplint: clean — ")


@pytest.fixture
def toy_bench(monkeypatch):
    from randomprojection_tpu_torch import benchmark

    monkeypatch.setitem(benchmark.TOPK_BENCH_SHAPES, "smoke", dict(
        n_idx=2048, q_tile=128, clients=2, req_rows=16, reqs_per_client=2,
        max_batch=64, shards=2, replicas=2))
    monkeypatch.setitem(benchmark.LSH_BENCH_SHAPES, "smoke", dict(
        n_idx=512, n_bytes=8, cluster=8, nq=8, m=5, bands=4, band_bits=8,
        noise_bits=2, probe_counts=(1,), calls=1, rerank_tile=8))
    monkeypatch.setitem(benchmark.TIER_BENCH_SHAPES, "smoke", dict(
        n_idx=1024, n_bytes=8, nq=8, m=5, calls=1, chunk_rows=256,
        budget_chunks=1, q_tile=8))
    monkeypatch.setitem(benchmark.CONFIG3_SHAPES, "smoke",
                        dict(batch=64, steps=1, calls=1))


def test_bench_on_the_cpu_ends_with_the_compact_line(capsys, toy_bench):
    from randomprojection_tpu import benchmark as ref_bench

    cli.main(["bench", "--device", "cpu", "--d", "512", "--k", "64",
              "--dispatch-steps", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    record = json.loads(lines[-2])
    compact = ref_bench.find_compact_line(lines[-1])
    assert compact is not None and len(lines[-1].encode()) <= 2048
    assert compact["mode"] == record["mode"] and compact["preset"] == "smoke"
    assert compact["dispatch_steps"] == 1 == record["dispatch_steps"]
    assert record["device"] == "cpu" and record["timing_suspect"] is True
    assert compact["transform_dma"] == "auto"


@pytest.mark.parametrize("value", ["on", "off"])
def test_bench_refuses_transform_dma_but_auto(value):
    with pytest.raises(SystemExit) as info:
        cli.main(["bench", "--device", "cpu", "--transform-dma", value])
    assert "TPU kernel route" in str(info.value.code)
