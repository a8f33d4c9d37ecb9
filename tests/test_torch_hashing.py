"""Feature hashing of the port against the JAX package.

- ``murmur3_32`` (the port's C++ library) and its plain version
  ``_murmur3_32_py`` equal the reference's library and pure-Python hash.
- ``hash_tokens`` on every path (list, fixed-width bytes, ASCII and
  non-ASCII unicode, embedded NULs) and ``FeatureHasher``'s CSR (data,
  indices, indptr) equal the reference's bit for bit, at any thread count.
- The library is built from the port's own source into a path keyed by a
  digest of the source and the flags, and a failed build raises.
"""

import hashlib

import numpy as np
import pytest

from randomprojection_tpu.ops import hashing as ref_h
from randomprojection_tpu_torch.native import build as nb
from randomprojection_tpu_torch.ops import hashing as h

WORDS = ["", "a", "ab", "abc", "abcd", "hello", "tok49999", "ünïcødé",
         "日本語のテキスト", "x" * 37, "tab\there", "naïve café"]


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 7])
def test_murmur3_equals_the_reference(seed):
    for w in WORDS + [b"\x00\x01\xff", bytes(range(200))]:
        data = w.encode() if isinstance(w, str) else w
        want = ref_h.murmur3_32(w, seed)
        assert h.murmur3_32(w, seed) == want
        assert h._murmur3_32_py(data, seed) == ref_h._murmur3_32_py(data, seed)
        assert h._murmur3_32_py(data, seed) == h.murmur3_32(w, seed, signed=False)


def _same_hash(tokens, n_features=1 << 20):
    got = h.hash_tokens(tokens, n_features)
    want = ref_h.hash_tokens(tokens, n_features)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == np.int32 and got[1].dtype == np.int8


def test_hash_tokens_every_path_equals_the_reference():
    rng = np.random.default_rng(0)
    vocab = np.asarray([f"tok{i}" for i in range(5000)])
    toks = vocab[rng.integers(0, 5000, size=20_000)]
    _same_hash(toks)                       # ASCII unicode: strided
    _same_hash(toks.astype("S"))           # fixed-width bytes: strided
    _same_hash(toks.tolist())              # a list: one concatenated buffer
    _same_hash(np.asarray(WORDS))          # non-ASCII unicode: utf-8 first
    _same_hash(np.asarray([b"a\x00b", b"ab", b"\x00"], dtype="S4"))  # NULs
    _same_hash(np.asarray([], dtype="U3"))
    _same_hash(toks, n_features=7)
    with pytest.raises(TypeError, match="str or bytes"):
        h.hash_tokens([1, 2], 16)


def test_hash_threads_change_no_output():
    rng = np.random.default_rng(1)
    toks = np.asarray([f"w{i}" for i in range(1000)])[
        rng.integers(0, 1000, size=1 << 19)]
    one = h.hash_tokens(toks, 1 << 20, n_threads=1)
    with h.hash_threads_override(4):
        four = h.hash_tokens(toks, 1 << 20)
    np.testing.assert_array_equal(one[0], four[0])
    np.testing.assert_array_equal(one[1], four[1])
    with pytest.raises(ValueError):
        with h.hash_threads_override(0):
            pass


def _same_csr(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.data, want.data)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("alternate_sign", [True, False])
def test_feature_hasher_csr_equals_the_reference(dtype, alternate_sign):
    kw = dict(n_features=1 << 10, alternate_sign=alternate_sign, dtype=dtype)
    docs = [{"a": 1.0, "b": 2.0, "ü": -1.5}, {}, {"a": 0.0, "zz": 3.0}]
    _same_csr(h.FeatureHasher(**kw).transform(docs),
              ref_h.FeatureHasher(**kw).transform(docs))
    pairs = [[("a", 1.0), ("a", 2.0)], [("q", 5.0)]]
    _same_csr(h.FeatureHasher(input_type="pair", **kw).transform(pairs),
              ref_h.FeatureHasher(input_type="pair", **kw).transform(pairs))
    strs = [["a", "b", "a"], [], ["日本", "x"]]
    _same_csr(h.FeatureHasher(input_type="string", **kw).transform(strs),
              ref_h.FeatureHasher(input_type="string", **kw).transform(strs))
    rng = np.random.default_rng(2)
    toks = np.asarray([f"tok{i}" for i in range(300)])[
        rng.integers(0, 300, size=1000)]
    indptr = np.arange(0, 1001, 100)
    vals = rng.normal(size=1000)
    for args in ((toks,), (toks, indptr), (toks, indptr, vals)):
        _same_csr(h.FeatureHasher(input_type="string", **kw).transform_tokens(*args),
                  ref_h.FeatureHasher(input_type="string", **kw).transform_tokens(*args))


def test_feature_hasher_validation():
    with pytest.raises(ValueError):
        h.FeatureHasher(0)
    with pytest.raises(ValueError):
        h.FeatureHasher(8, input_type="bogus")
    with pytest.raises(ValueError):
        h.FeatureHasher(8, dtype=np.int32)
    fh = h.FeatureHasher(8, input_type="string")
    with pytest.raises(ValueError, match="indptr"):
        fh.transform_tokens(["a", "b"], [0, 1])
    with pytest.raises(ValueError, match="non-decreasing"):
        fh.transform_tokens(["a", "b"], [0, 2, 1, 2])
    with pytest.raises(ValueError, match="values"):
        fh.transform_tokens(["a", "b"], [0, 2], [1.0])
    indptr = np.array([0, 1, 2])
    fh.transform_tokens(["a", "b"], indptr)
    np.testing.assert_array_equal(indptr, [0, 1, 2])  # not rewritten


def test_native_build_is_keyed_by_the_source_digest(tmp_path, monkeypatch):
    h.murmur3_32("warm")  # builds (or reuses) the library
    path = nb.library_path()
    digest = hashlib.sha256(nb.SRC.read_bytes()
                            + " ".join(nb.FLAGS).encode()).hexdigest()[:16]
    assert path.name == f"libmurmur3-{digest}.so" and path.exists()
    assert path.parent == nb.BUILD_DIR
    assert nb.BUILD_DIR.parts[-2:] == ("build", "native")
    # an edited source keys another library; a failed compile raises
    src = tmp_path / "murmur3.cpp"
    src.write_text(nb.SRC.read_text() + "\n#error edited\n")
    monkeypatch.setattr(nb, "SRC", src)
    monkeypatch.setattr(nb, "BUILD_DIR", tmp_path / "build")
    assert nb.library_path().name != path.name
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        nb._compile(nb.library_path())
    assert not list((tmp_path / "build").glob("*.so"))
