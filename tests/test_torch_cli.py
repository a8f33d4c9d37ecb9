"""The port's CLI (``python -m randomprojection_tpu_torch``) against the
JAX package's.

``jl-dim`` prints the reference's number; ``info --device cpu`` runs;
``project`` on the numpy backend writes the reference CLI's ``.npy`` bit
for bit and on the torch backend (CPU) within ``1e-5·max|Y|`` of the
reference's JAX backend (the same threefry matrix); a checkpointed
``project`` cut mid-run resumes through its fingerprint sidecar to the
one-shot output and refuses a changed fingerprint; ``stream-bench
--device cpu`` prints the reference's JSON keys; the live-plane flags, the
JAX-only flags and the later subcommands exit non-zero naming why; with
no card and no ``--device cpu`` a command exits naming the card.
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
    (["--openmetrics", "m.txt"], "A13"),
    (["--metrics-port", "0"], "A13"),
    (["--health"], "A13"),
    (["--flight-dump", "f.json"], "A13"),
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


@pytest.mark.parametrize("cmd,item", [
    ("bench", "A6"), ("topk-bench", "A13"), ("loadgen", "A13"),
    ("recover", "A13"), ("doctor", "A13"), ("report", "A13"),
    ("lint", "A13"),
])
def test_later_subcommands_refuse_naming_their_item(cmd, item):
    with pytest.raises(SystemExit) as info:
        cli.main([cmd, "--anything", "goes"])
    assert item in str(info.value.code) and "not ported" in str(info.value.code)


@pytest.mark.parametrize("argv", [
    ["stream-bench", "--rows", "8", "--batch-rows", "8", "--d", "8"],
    ["project", "--input", "x.npy", "--output", "y.npy"],
    ["info"],
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
        [sys.executable, "-m", "randomprojection_tpu_torch", "lint"],
        capture_output=True, text=True, cwd=REPO, timeout=120,
    )
    assert r.returncode == 1 and "A13" in r.stderr
