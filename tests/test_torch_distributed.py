"""Multi-process bring-up of the port (``parallel/distributed.py``,
``mesh.global_mesh``) against the JAX package's, mirroring
``tests/test_distributed.py``.

The two-process tests EXECUTE the path on this machine: two subprocesses
join one ``torch.distributed`` job over gloo on localhost (CPU), with no
JAX imported, and their outputs are held to the reference's one-process
results computed in this test process (its virtual 8-device mesh):
within ``1e-5·max|Y|`` (the port's Gaussian is within 4 ulps of the
reference's, and TP sums in another order), and the two ranks' copies of
a cross-process TP result bit for bit (two partials added by all_reduce
give the same bits on both ranks).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from randomprojection_tpu_torch.parallel import distributed

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-5


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in distributed._DISTRIBUTED_ENV_MARKERS}
    env["PYTHONPATH"] = REPO_ROOT
    return env


def _run_pair(argv_of, timeout=240):
    """Start the two ranks (``argv_of(pid)``), wait for both, return their
    stdouts."""
    procs = [subprocess.Popen(argv_of(p), env=_env(), cwd=REPO_ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for p in range(2)]
    results = [pr.communicate(timeout=timeout) for pr in procs]
    for pr, (so, se) in zip(procs, results):
        assert pr.returncode == 0, f"worker failed:\n{so}\n{se}"
    return [so for so, _ in results]


# -- host_row_range: pure-function unit tests --------------------------------------


def test_host_row_range_partitions_exactly():
    from randomprojection_tpu.parallel.distributed import (
        host_row_range as ref_range,
    )

    for n_rows in (0, 1, 7, 100, 101, 1023):
        for n_p in (1, 2, 3, 8):
            ranges = [distributed.host_row_range(n_rows, process_id=p,
                                                 process_count=n_p)
                      for p in range(n_p)]
            assert ranges == [ref_range(n_rows, process_id=p,
                                        process_count=n_p)
                              for p in range(n_p)]
            assert ranges[0][0] == 0 and ranges[-1][1] == n_rows
            for (_, ahi), (blo, _) in zip(ranges, ranges[1:]):
                assert ahi == blo
            sizes = [hi - lo for lo, hi in ranges]
            assert max(sizes) - min(sizes) <= 1


def test_host_row_range_validates():
    with pytest.raises(ValueError, match="n_rows"):
        distributed.host_row_range(-1, process_id=0, process_count=1)
    with pytest.raises(ValueError, match="out of range"):
        distributed.host_row_range(10, process_id=2, process_count=2)


def test_host_row_range_uses_runtime_by_default():
    assert distributed.host_row_range(100) == (0, 100)
    assert not distributed.is_multi_process()
    assert (distributed.process_rank(), distributed.world_size()) == (0, 1)


def test_host_row_range_rejects_partial_pair():
    with pytest.raises(ValueError, match="together"):
        distributed.host_row_range(100, process_count=4)
    with pytest.raises(ValueError, match="together"):
        distributed.host_row_range(100, process_id=0)


# -- initialize(): the failure policy ----------------------------------------------------


@pytest.fixture
def _fresh_initialize(monkeypatch):
    """Reset the idempotence latch and make the underlying torch call fail
    fast (a real unreachable coordinator would wait for minutes)."""
    import torch.distributed as dist

    if hasattr(distributed.initialize, "_done"):
        del distributed.initialize._done

    def boom(*args, **kwargs):
        raise RuntimeError("simulated coordinator failure")

    monkeypatch.setattr(dist, "init_process_group", boom)
    for v in distributed._DISTRIBUTED_ENV_MARKERS:
        monkeypatch.delenv(v, raising=False)
    yield distributed
    if hasattr(distributed.initialize, "_done"):
        del distributed.initialize._done


def test_initialize_raises_on_explicit_args_failure(_fresh_initialize):
    """Explicit distributed arguments that cannot be satisfied raise, never
    silently degrade to one process."""
    with pytest.raises(RuntimeError, match="refusing to silently degrade"):
        distributed.initialize(
            coordinator_address="localhost:1", num_processes=2, process_id=1
        )
    assert not getattr(distributed.initialize, "_done", False)


@pytest.mark.parametrize("marker", ["JAX_COORDINATOR_ADDRESS", "MASTER_ADDR",
                                    "WORLD_SIZE", "RANK",
                                    "TORCHELASTIC_RUN_ID"])
def test_initialize_raises_when_env_marks_distributed(
        _fresh_initialize, monkeypatch, marker):
    """A failure inside a distributed launch (the reference's markers and
    torch's launcher's) is a misconfiguration, not a single-machine run."""
    monkeypatch.setenv(marker, "localhost:1" if "ADDR" in marker else "2")
    with pytest.raises(RuntimeError, match="refusing to silently degrade"):
        distributed.initialize()


def test_initialize_degrades_quietly_on_plain_single_machine(
        _fresh_initialize):
    """No args, no env markers: the ordinary laptop case stays a no-op."""
    distributed.initialize()  # must not raise
    assert distributed.initialize._done
    distributed.initialize()  # idempotent


# -- two-process integration (gloo over localhost) ---------------------------------


_WORKER = r"""
import json, sys
import numpy as np
from randomprojection_tpu_torch.parallel import distributed

assert "jax" not in sys.modules
pid = int(sys.argv[1])
distributed.initialize(coordinator_address=sys.argv[3], num_processes=2,
                       process_id=pid)
assert distributed.is_multi_process() and distributed.world_size() == 2

from randomprojection_tpu_torch import GaussianRandomProjection

X = np.random.default_rng(0).normal(size=(301, 64)).astype(np.float32)
lo, hi = distributed.host_row_range(X.shape[0])
est = GaussianRandomProjection(16, random_state=7,
                               backend_options={"device": "cpu"})
est.fit_schema(*X.shape, dtype=X.dtype)  # from the schema: no data needed
np.save(sys.argv[2], est.transform(X[lo:hi]))
assert "jax" not in sys.modules
print(json.dumps({"pid": pid, "lo": lo, "hi": hi}))
"""


def test_two_process_transform_matches_single(tmp_path):
    coord = f"127.0.0.1:{_free_port()}"
    outs = [str(tmp_path / f"y{p}.npy") for p in range(2)]
    stdouts = _run_pair(lambda p: [sys.executable, "-c", _WORKER, str(p),
                                   outs[p], coord])
    metas = [json.loads(so.splitlines()[-1]) for so in stdouts]
    assert metas[0]["lo"] == 0 and metas[1]["hi"] == 301
    assert metas[0]["hi"] == metas[1]["lo"]

    # the reference's one-process result: same seed, the same matrix
    from randomprojection_tpu import GaussianRandomProjection

    X = np.random.default_rng(0).normal(size=(301, 64)).astype(np.float32)
    est = GaussianRandomProjection(16, random_state=7, backend="jax")
    est.fit_schema(*X.shape, dtype=X.dtype)
    _close(np.concatenate([np.load(o) for o in outs]),
           np.asarray(est.transform(X)))


_POD_WORKER = r"""
import sys
import numpy as np
import torch

from randomprojection_tpu_torch.parallel import distributed

assert "jax" not in sys.modules
pid = int(sys.argv[1])
distributed.initialize(coordinator_address=sys.argv[3], num_processes=2,
                       process_id=pid)
from randomprojection_tpu_torch.parallel import global_mesh, make_mesh
from randomprojection_tpu_torch.parallel.sharded import (
    Layout,
    make_sharded_projector,
)

LOCAL = ["cpu"] * 4
n, d, k = 320, 64, 16
X = np.random.default_rng(0).normal(size=(n, d)).astype(np.float32)
R = np.random.default_rng(1).normal(size=(k, d)).astype(np.float32)
Xt, Rt = torch.from_numpy(X), torch.from_numpy(R)
out = {}

# --- DP over the GLOBAL 8-position mesh (4 positions in each process) ---
mesh = global_mesh({"data": 8}, LOCAL)
assert mesh.ranks.tolist() == [0] * 4 + [1] * 4, mesh.ranks
layout = Layout(mesh, ("data", None))
out["dp_lo"] = min(layout.bounds(p, X.shape)[0][0] for p in layout.positions())
out["dp_rows"] = make_sharded_projector(mesh)(Xt, Rt).numpy()

# --- DP x TP: 'feature' listed FIRST, so its two shards live in DIFFERENT
# processes: the contraction's reduction crosses the process boundary ---
mesh2 = global_mesh({"feature": 2, "data": 4}, LOCAL)
out["tp_full"] = make_sharded_projector(mesh2, feature_axis="feature")(
    Xt, Rt).numpy()
assert out["tp_full"].shape == (n, k)  # every process holds every row

# --- the ESTIMATOR over the global DP x TP mesh: each process draws only
# its column shard of the same global matrix ---
from randomprojection_tpu_torch import SparseRandomProjection

opts = {"mesh": mesh2, "feature_axis": "feature"}
est_tp = SparseRandomProjection(k, random_state=11, density=0.25,
                                backend_options=opts)
est_tp.fit_schema(n, d, dtype=np.float32)
out["est_tp_full"] = est_tp.transform(X)
# the lazy route: one fused kernel a position at its shard's block offset
X2 = np.random.default_rng(2).normal(size=(64, 2048)).astype(np.float32)
lazy = SparseRandomProjection(k, random_state=11, density=0.25,
                              backend_options={**opts,
                                               "materialization": "lazy"})
lazy.fit_schema(64, 2048, dtype=np.float32)
out["lazy_tp_full"] = lazy.transform(X2)

# --- deployment pattern: host_row_range over the stream, a LOCAL mesh of
# this process's 4 positions under the estimator ---
from randomprojection_tpu_torch import GaussianRandomProjection
from randomprojection_tpu_torch.streaming import ArraySource, stream_to_array

local_mesh = make_mesh({"data": 4}, devices=LOCAL)
lo, hi = distributed.host_row_range(n)
est = GaussianRandomProjection(k, random_state=7,
                               backend_options={"mesh": local_mesh})
est.fit_schema(n, d, dtype=X.dtype)
out["stream_lo"] = lo
out["stream_rows"] = stream_to_array(est, ArraySource(X[lo:hi], batch_rows=64))

np.savez(sys.argv[2], **out)
assert "jax" not in sys.modules
print("ok")
"""


@pytest.mark.mesh_env
def test_pod_topology_two_process_mesh(tmp_path):
    """The reference's pod shape on gloo: 2 processes x 4 positions = one
    global 8-position mesh.  DP rows, a TP whose reduction crosses the
    process boundary, the estimator (dense and lazy) over the global DP×TP
    mesh, and the per-process host_row_range + local-mesh streaming equal
    the reference's single-process 8-device results."""
    import jax

    if len(jax.devices()) != 8:
        pytest.skip("needs the suite's virtual 8-device CPU topology")
    coord = f"127.0.0.1:{_free_port()}"
    outs = [str(tmp_path / f"pod{p}.npz") for p in range(2)]
    _run_pair(lambda p: [sys.executable, "-c", _POD_WORKER, str(p), outs[p],
                         coord])
    w0, w1 = [np.load(o) for o in outs]

    from randomprojection_tpu import GaussianRandomProjection
    from randomprojection_tpu import SparseRandomProjection as RefSparse
    from randomprojection_tpu.ops.pallas_kernels import fused_sparse_project
    from randomprojection_tpu.parallel import make_mesh
    from randomprojection_tpu.parallel.sharded import make_sharded_projector

    n, d, k = 320, 64, 16
    X = np.random.default_rng(0).normal(size=(n, d)).astype(np.float32)
    R = np.random.default_rng(1).normal(size=(k, d)).astype(np.float32)
    ref_dp = np.asarray(make_sharded_projector(make_mesh({"data": 8}))(X, R))

    # DP: the two processes' row blocks tile [0, n)
    assert {int(w0["dp_lo"]), int(w1["dp_lo"])} == {0, n // 2}
    got_dp = np.concatenate(
        [w["dp_rows"] for w in sorted((w0, w1), key=lambda w: int(w["dp_lo"]))]
    )
    _close(got_dp, ref_dp)

    # TP (cross-process reduction): both hold the same full Y, bit for bit
    mesh_tp = make_mesh({"feature": 2, "data": 4})
    ref_tp = np.asarray(
        make_sharded_projector(mesh_tp, feature_axis="feature")(X, R))
    np.testing.assert_array_equal(w0["tp_full"], w1["tp_full"])
    _close(w0["tp_full"], ref_tp)

    # the estimator across processes: the reference's fit on the same
    # decomposition of the mesh
    est_ref = RefSparse(16, random_state=11, density=0.25, backend="jax",
                        backend_options={"mesh": mesh_tp,
                                         "feature_axis": "feature"})
    est_ref.fit_schema(n, d, dtype=np.float32)
    np.testing.assert_array_equal(w0["est_tp_full"], w1["est_tp_full"])
    _close(w0["est_tp_full"], np.asarray(est_ref.transform(X)))

    # lazy TP across processes: the reference's interpret-mode kernel on
    # each half of the columns at its block offset, summed
    X2 = np.random.default_rng(2).normal(size=(64, 2048)).astype(np.float32)
    want = sum(np.asarray(fused_sparse_project(
        X2[:, j * 1024:(j + 1) * 1024], 11, k, 0.25, block_offset=2 * j,
        mxu_mode="split2", interpret=True)) for j in range(2))
    np.testing.assert_array_equal(w0["lazy_tp_full"], w1["lazy_tp_full"])
    _close(w0["lazy_tp_full"], want)

    # streamed host_row_range + local mesh: the rows equal one process's
    est = GaussianRandomProjection(k, random_state=7, backend="jax")
    est.fit_schema(n, d, dtype=X.dtype)
    got_stream = np.concatenate(
        [w["stream_rows"]
         for w in sorted((w0, w1), key=lambda w: int(w["stream_lo"]))]
    )
    _close(got_stream, np.asarray(est.transform(X)))


def test_multihost_example_two_processes(tmp_path):
    """``python -m randomprojection_tpu_torch.examples.multihost`` as two
    gloo ranks: each streams its host_row_range, and the ranks' rows,
    concatenated, equal one process's run."""
    coord = f"127.0.0.1:{_free_port()}"
    args = ["--device", "cpu", "--rows", "3000", "--d", "256", "--k", "32",
            "--batch-rows", "512"]
    mod = [sys.executable, "-m", "randomprojection_tpu_torch.examples.multihost"]
    stdouts = _run_pair(lambda p: [
        *mod, *args, "--coordinator", coord, "--num-processes", "2",
        "--process-id", str(p), "--out", str(tmp_path / f"y{p}.npy")])
    metas = sorted((json.loads(so.splitlines()[-1]) for so in stdouts),
                   key=lambda m: m["process"])
    assert [m["row_range"] for m in metas] == [[0, 1500], [1500, 3000]]
    assert all(m["process_count"] == 2 and m["device"] == "cpu"
               for m in metas)
    one = subprocess.run([*mod, *args, "--out", str(tmp_path / "one.npy")],
                         env=_env(), cwd=REPO_ROOT, capture_output=True,
                         text=True, timeout=240)
    assert one.returncode == 0, one.stderr
    got = np.concatenate([np.load(tmp_path / f"y{p}.npy") for p in range(2)])
    _close(got, np.load(tmp_path / "one.npy"))
