"""Model files across the two packages (format version 1).

- A dense model saved by the JAX package loads in the port, and one saved
  by the port loads in the JAX package; the loaded model transforms like
  the saved one within ``1e-5·max|Y|`` (the port draws the JAX backend's
  threefry matrix from the seed).
- The reference's lazy file (the TPU's hardware PRNG) is refused with a
  reason; the port's lazy file (its hash family, tagged) round-trips in
  the port, and the reference cannot load it (a standing divergence).
- The ``include_matrix`` bundle round-trips and a missing one is named.
"""

import json
import os

import numpy as np
import pytest

import randomprojection_tpu as ref
import randomprojection_tpu_torch as port
from randomprojection_tpu import serialize as ref_ser
from randomprojection_tpu_torch import serialize as ser

CPU = {"device": "cpu"}


def _x(n=80, d=700, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


MODELS = [
    ("SparseRandomProjection", dict(density=1 / 3, dense_output=True)),
    ("SparseRandomProjection", dict(density="auto")),
    ("GaussianRandomProjection", {}),
    ("GaussianRandomProjection", dict(compute_inverse_components=True)),
]


@pytest.mark.parametrize("cls,kw", MODELS)
def test_reference_file_loads_in_the_port(tmp_path, cls, kw):
    X = _x()
    est = getattr(ref, cls)(24, random_state=11, backend="jax", **kw).fit(X)
    path = str(tmp_path / "m.json")
    ref_ser.save_model(est, path)
    got = ser.load_model(path, backend_options=CPU)
    assert type(got).__name__ == cls
    assert got.spec_.to_dict() == est.spec_.to_dict()
    _close(got.transform(X), est.transform(X))
    if kw.get("compute_inverse_components"):
        _close(got.inverse_components_, est.inverse_components_)


@pytest.mark.parametrize("cls,kw", MODELS)
def test_port_file_loads_in_the_reference(tmp_path, cls, kw):
    X = _x(seed=1)
    est = getattr(port, cls)(24, random_state=12, backend_options=CPU,
                             **kw).fit(X)
    path = str(tmp_path / "m.json")
    ser.save_model(est, path)
    got = ref_ser.load_model(path, backend="jax")
    assert got.spec_.to_dict() == est.spec_.to_dict()
    _close(est.transform(X), got.transform(X))
    # and back into the port, the same model
    again = ser.load_model(path, backend_options=CPU)
    np.testing.assert_array_equal(again.transform(X), est.transform(X))


def test_sign_model_codes_cross_both_ways(tmp_path):
    X = _x(200, 96, seed=2)
    est = ref.SignRandomProjection(64, random_state=7, backend="jax").fit(X)
    path = str(tmp_path / "sign.json")
    ref_ser.save_model(est, path)
    got = ser.load_model(path, backend_options=CPU)
    assert type(got).__name__ == "SignRandomProjection"
    y = X.astype(np.float64) @ est.components_as_numpy().astype(np.float64).T
    clear = np.abs(y) > 1e-5 * np.abs(y).max()
    bits = lambda c: np.unpackbits(np.asarray(c), axis=1, bitorder="little")  # noqa: E731
    np.testing.assert_array_equal(bits(got.transform(X))[clear],
                                  bits(est.transform(X))[clear])
    ser.save_model(got, path)
    back = ref_ser.load_model(path, backend="jax")
    np.testing.assert_array_equal(np.asarray(back.transform(X)),
                                  np.asarray(est.transform(X)))


def test_numpy_backend_loads_the_numpy_stream(tmp_path):
    X = _x(seed=3)
    est = ref.SparseRandomProjection(16, density=0.25, random_state=3,
                                     backend="numpy").fit(X)
    path = str(tmp_path / "n.json")
    ref_ser.save_model(est, path)
    got = ser.load_model(path, backend="numpy")
    np.testing.assert_array_equal(got.transform(X), est.transform(X))


def test_reference_lazy_file_is_refused(tmp_path):
    payload = {
        "format_version": 1, "class": "SparseRandomProjection",
        "spec": {"kind": "sparse", "n_components": 16, "n_features": 256,
                 "seed": 0, "density": 0.25, "dtype": "float32"},
        "params": {"dense_output": False, "compute_inverse_components": False},
        # what the reference's save_model writes for a TPU lazy model
        "backend_options": {"materialization": "lazy"},
    }
    path = tmp_path / "lazy.json"
    path.write_text(json.dumps(payload))
    with pytest.raises(ValueError, match="hardware PRNG"):
        ser.load_model(str(path), backend_options=CPU)


def test_port_lazy_model_round_trips_and_the_reference_refuses_it(tmp_path):
    X = _x(seed=4)
    est = port.SparseRandomProjection(
        24, density=1 / 3, random_state=5,
        backend_options=CPU | {"materialization": "lazy"},
    ).fit(X)
    path = str(tmp_path / "lazy.json")
    ser.save_model(est, path)
    saved = json.loads(open(path).read())
    assert saved["backend_options"] == {
        "materialization": "lazy", ser.FAMILY_KEY: ser.LAZY_FAMILY,
    }
    got = ser.load_model(path, backend_options=CPU)
    assert got.backend_options == CPU | {"materialization": "lazy"}
    np.testing.assert_array_equal(got.transform(X), est.transform(X))
    with pytest.raises(ValueError, match="backend='numpy'"):
        ser.load_model(path, backend="numpy")
    # the reference builds its jax backend with the tag as an option and
    # fails on it: the standing divergence of the two lazy families
    with pytest.raises(TypeError, match="prng_family"):
        ref_ser.load_model(path)


def test_matrix_bundle_round_trips(tmp_path):
    X = _x(seed=5)
    est = port.GaussianRandomProjection(
        16, random_state=6, compute_inverse_components=True,
        backend_options=CPU,
    ).fit(X)
    path = str(tmp_path / "b.json")
    ser.save_model(est, path, include_matrix=True)
    bundle = np.load(path + ".npz")
    np.testing.assert_array_equal(bundle["components"], est.components_as_numpy())
    np.testing.assert_array_equal(bundle["inverse_components"],
                                  est.inverse_components_)
    ser.load_model(path, backend_options=CPU)
    ref_ser.load_model(path, backend="jax")
    os.remove(path + ".npz")
    with pytest.raises(ValueError, match="matrix bundle is missing") as got:
        ser.load_model(path, backend_options=CPU)
    with pytest.raises(ValueError, match="matrix bundle is missing") as want:
        ref_ser.load_model(path)
    assert str(got.value) == str(want.value)


def test_refusals(tmp_path):
    X = _x(seed=6)
    est = port.GaussianRandomProjection(8, random_state=1,
                                        backend_options=CPU).fit(X)
    path = tmp_path / "m.json"
    ser.save_model(est, str(path))
    with pytest.raises(ValueError, match="backend must be"):
        ser.load_model(str(path), backend="jax")
    with pytest.raises(ValueError, match="backend='torch' only"):
        ser.load_model(str(path), backend="numpy", backend_options=CPU)
    bad = json.loads(path.read_text())
    bad["format_version"] = 2
    path.write_text(json.dumps(bad))
    with pytest.raises(ValueError, match="Unsupported model format version 2"):
        ser.load_model(str(path))
    # a CountSketch file is no longer refused (CountSketch is ported): it
    # loads with the reference's tables
    cs = ref.CountSketch(32, random_state=0, backend="numpy").fit(
        np.zeros((2, 40), np.float32))
    ref_ser.save_model(cs, str(path))
    back = ser.load_model(str(path), backend_options=CPU)
    np.testing.assert_array_equal(back.h_, cs.h_)
    np.testing.assert_array_equal(back.s_, cs.s_)
    path.write_text(json.dumps({"format_version": 1, "class": "Nope"}))
    with pytest.raises(ValueError, match="Unknown model class"):
        ser.load_model(str(path))
    unfitted = port.GaussianRandomProjection(8)
    with pytest.raises(Exception, match="not fitted|fit"):
        ser.save_model(unfitted, str(path))
