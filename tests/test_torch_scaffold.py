"""The PyTorch port's host scaffold against the JAX package.

JL math, validation, the spec and registry, the numpy backend (same salted
stream, so bit-identical matrices), row bucketing, the precision policy
and the split2 product; plus the port's separation rule (no JAX and no
``randomprojection_tpu`` import anywhere in the port or its chip smoke)
and its device rule (no card and no device asked: entry points raise).
"""

import ast
import pathlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import randomprojection_tpu as ref
import randomprojection_tpu_torch as port
from randomprojection_tpu.backends import numpy_backend as ref_numpy_backend
from randomprojection_tpu.backends.base import ProjectionSpec as RefSpec
from randomprojection_tpu.ops import precision as ref_precision
from randomprojection_tpu.ops import split_matmul as ref_split
from randomprojection_tpu.parallel.sharded import row_bucket as ref_row_bucket
from randomprojection_tpu.utils import validation as ref_validation
from randomprojection_tpu_torch.backends import base as port_base
from randomprojection_tpu_torch.backends import numpy_backend as port_numpy_backend
from randomprojection_tpu_torch.ops import precision as port_precision
from randomprojection_tpu_torch.ops import split_matmul as port_split
from randomprojection_tpu_torch.parallel.sharded import row_bucket
from randomprojection_tpu_torch.utils import validation as port_validation

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = {"device": "cpu"}


# -- separation: the port imports neither jax nor the JAX package --------------

_BANNED = ("jax", "randomprojection_tpu")


def _banned_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    found = []
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif isinstance(node, ast.Call):
            fn = node.func
            fname = getattr(fn, "attr", None) or getattr(fn, "id", None)
            if fname in ("import_module", "__import__") and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str):
                names = [node.args[0].value]
        found += [n for n in names if n.split(".")[0] in _BANNED]
    return found


def _port_sources():
    files = sorted((REPO / "randomprojection_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    return files


def test_port_imports_neither_jax_nor_reference():
    files = _port_sources()
    assert len(files) > 15 and all(f.exists() for f in files)
    names = {str(f.relative_to(REPO)) for f in files}
    for module in ("models/sketch.py", "ops/topk_kernels.py",
                   "utils/telemetry.py", "backends/torch_backend.py",
                   "streaming.py", "utils/observability.py", "cli.py",
                   "__main__.py", "ops/staging.py"):
        assert f"randomprojection_tpu_torch/{module}" in names
    bad = {str(f.relative_to(REPO)): _banned_imports(f) for f in files}
    assert {k: v for k, v in bad.items() if v} == {}


@pytest.mark.parametrize(
    "src,banned",
    [
        ("import jax", True),
        ("import jax.numpy as jnp", True),
        ("from jax import lax", True),
        ("from randomprojection_tpu.ops import kernels", True),
        ("import randomprojection_tpu", True),
        ("importlib.import_module('jax.numpy')", True),
        ("import randomprojection_tpu_torch.ops", False),
        ("from randomprojection_tpu_torch import models", False),
        ("import jaxlib_like_name", False),
    ],
)
def test_import_scanner_cases(tmp_path, src, banned):
    f = tmp_path / "m.py"
    f.write_text(src + "\n")
    assert bool(_banned_imports(f)) is banned


# -- JL math and validation copies ---------------------------------------------


@pytest.mark.parametrize("n,eps", [(1_000_000, 0.5), (100, 0.1), (10**9, 0.01)])
def test_jl_min_dim_matches_reference(n, eps):
    assert port.johnson_lindenstrauss_min_dim(n, eps=eps) == \
        ref.johnson_lindenstrauss_min_dim(n, eps=eps)
    arr = port.johnson_lindenstrauss_min_dim([n, 2 * n], eps=[eps, eps / 2])
    np.testing.assert_array_equal(
        arr, ref.johnson_lindenstrauss_min_dim([n, 2 * n], eps=[eps, eps / 2])
    )


def test_jl_min_dim_rejects_like_reference():
    for bad in (dict(n_samples=10, eps=0.0), dict(n_samples=0, eps=0.5)):
        with pytest.raises(ValueError):
            port.johnson_lindenstrauss_min_dim(**bad)
        with pytest.raises(ValueError):
            ref.johnson_lindenstrauss_min_dim(**bad)


@pytest.mark.parametrize("density,d", [("auto", 4096), (1 / 3, 100), (1.0, 5)])
def test_check_density_matches(density, d):
    assert port_validation.check_density(density, d) == \
        ref_validation.check_density(density, d)


@pytest.mark.parametrize(
    "dtype", [np.float32, np.float64, np.int32, np.float16, bool]
)
def test_transform_dtype_policy_matches(dtype):
    assert port_validation.resolve_transform_dtype(dtype) == \
        ref_validation.resolve_transform_dtype(dtype)


def test_validation_errors_match():
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError):
            port_validation.check_density(bad, 10)
    with pytest.raises(ValueError):
        port_validation.check_input_size(0, 10)
    with pytest.raises(ValueError, match="2D"):
        port_validation.check_array(np.zeros(3))
    assert issubclass(port.NotFittedError, (ValueError, AttributeError))


# -- spec, registry, numpy backend ----------------------------------------------


def test_spec_round_trip_and_registry():
    d = RefSpec("sparse", 16, 100, 7, density=0.25, dtype="float32").to_dict()
    spec = port_base.ProjectionSpec.from_dict(d)
    assert spec.to_dict() == d
    assert set(port_base.available_backends()) == {"numpy", "torch"}
    be = port_base.resolve_backend("torch", **CPU)
    assert be.name == "torch" and be.device.type == "cpu"
    with pytest.raises(ValueError, match="Unknown backend"):
        port_base.get_backend("jax")


@pytest.mark.parametrize(
    "kind,density,dtype",
    [
        ("sparse", 1 / 3, "float32"),
        ("sparse", 0.05, "float64"),
        ("sparse", 1.0, "float32"),
        ("gaussian", None, "float64"),
        ("rademacher", None, "float32"),
    ],
)
@pytest.mark.parametrize("seed", [0, 12345678901])
def test_numpy_backend_bit_identical_to_reference(kind, density, dtype, seed):
    fields = dict(kind=kind, n_components=24, n_features=300, seed=seed,
                  density=density, dtype=dtype)
    a = ref_numpy_backend.NumpyBackend().materialize(RefSpec(**fields))
    b = port_numpy_backend.NumpyBackend().materialize(
        port_base.ProjectionSpec(**fields)
    )
    assert type(a) is type(b)
    a = a.toarray() if sp.issparse(a) else a
    b = b.toarray() if sp.issparse(b) else b
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def test_numpy_estimator_matches_reference_numpy_estimator():
    X = np.random.default_rng(1).normal(size=(50, 200)).astype(np.float32)
    a = ref.SparseRandomProjection(16, density=0.2, random_state=3,
                                   backend="numpy").fit_transform(X)
    b = port.SparseRandomProjection(16, density=0.2, random_state=3,
                                    backend="numpy").fit_transform(X)
    np.testing.assert_array_equal(a, b)


def test_torch_dense_matrix_is_the_jax_threefry_matrix():
    """The torch backend's dense matrix for seed s is the JAX backend's
    threefry matrix (no longer the numpy stream, which stays the numpy
    backend's own)."""
    est = port.SparseRandomProjection(
        16, density=1 / 3, random_state=5, backend_options=CPU
    ).fit(np.zeros((4, 700), np.float32))
    want = ref.SparseRandomProjection(
        16, density=1 / 3, random_state=5, backend="jax"
    ).fit(np.zeros((4, 700), np.float32)).components_as_numpy()
    np.testing.assert_array_equal(est.components_as_numpy(), want)
    numpy_stream = ref_numpy_backend.NumpyBackend().materialize(
        RefSpec(**est.spec_.to_dict())
    )
    assert not np.array_equal(est.components_as_numpy(), numpy_stream.toarray())


@pytest.mark.parametrize("n", [1, 7, 8, 9, 63, 64, 65, 100, 1280, 65537, 10**6])
def test_row_bucket_matches_reference(n):
    assert row_bucket(n) == ref_row_bucket(n)


# -- precision policy and split2 ------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_default_precision_matches(dtype):
    assert port_precision.default_matmul_precision(dtype) == \
        ref_precision.default_matmul_precision(dtype)


def test_matmul_precision_restores_tf32_flag():
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = flag
            x = torch.randn(4, 8)
            port_precision.matmul_nt(x, torch.randn(3, 8), "high")
            port_precision.matmul_nt(x, torch.randn(3, 8), "default")
            assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_split_pair_bit_identical_to_reference():
    import jax.numpy as jnp

    x = np.random.default_rng(2).normal(size=(33, 77)).astype(np.float32) * 1e3
    hi_r, lo_r = ref_split.split_f32_to_bf16_pair(jnp.asarray(x))
    hi_p, lo_p = port_split.split_f32_to_bf16_pair(torch.from_numpy(x))
    for r, p in ((hi_r, hi_p), (lo_r, lo_p)):
        np.testing.assert_array_equal(
            np.asarray(r.astype(jnp.float32)), p.float().numpy()
        )


def test_split2_project_matches_reference():
    """max|Δ| ≤ 1e-5·max|Y|: the two packages sum in different orders."""
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    x = rng.normal(size=(40, 300)).astype(np.float32)
    mask = rng.choice([-1.0, 0.0, 1.0], size=(24, 300)).astype(np.float32)
    want = np.asarray(ref_split.split2_project(
        jnp.asarray(x), jnp.asarray(mask, dtype=jnp.bfloat16), 0.125))
    got = port_split.split2_project(
        torch.from_numpy(x), torch.from_numpy(mask).to(torch.bfloat16), 0.125
    )
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


# -- the card is the default: no card, no device asked → raise ------------------


def test_no_card_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.zeros((4, 64), np.float32)
    for est in (port.SparseRandomProjection(8),
                port.GaussianRandomProjection(8),
                port.SparseRandomProjection(
                    8, backend_options={"materialization": "lazy"})):
        with pytest.raises(RuntimeError, match="no CUDA card|none is available"):
            est.fit(X)
    with pytest.raises(RuntimeError):
        port.SparseRandomProjection(8, backend_options={"device": "cuda"}).fit(X)
    with pytest.raises(RuntimeError):
        port_base.resolve_backend("auto")


@pytest.mark.parametrize(
    "opt,item",
    [
        ({"mesh": object()}, "A10"),
        ({"feature_axis": "feature"}, "A10"),
    ],
)
def test_options_of_later_slices_raise(opt, item):
    with pytest.raises(ValueError, match=f"ROADMAP {item}"):
        port_base.resolve_backend("torch", **CPU, **opt)


def test_bad_options_raise():
    for opt in ({"precision": "fast"}, {"materialization": "cached"},
                {"compute_dtype": "float16"}, {"device": "meta"}):
        with pytest.raises(ValueError):
            port_base.resolve_backend("torch", **(CPU | opt))
