"""Feature hashing (the hashing trick) over raw tokens → CSR.

The port of ``randomprojection_tpu/ops/hashing.py``: the host-side ingest
of config 5 ("Count-Sketch / feature-hashing structured RP on streaming
TF-IDF").  Semantics are sklearn ``FeatureHasher``'s
(``sklearn/feature_extraction/_hash.py`` + ``_hashing_fast.pyx``): signed
32-bit murmur3 (seed 0) of the token bytes, ``index = |h| mod
n_features``, an optional alternating sign that makes the sketch
unbiased.

The hot loop is the C++ batch hasher (``native/murmur3.cpp``, the port's
own copy, built with g++ at first use and bound with ctypes); a build
failure raises.  ``_murmur3_32_py`` is the plain version the tests hold
the library to.
"""

from __future__ import annotations

import contextlib
import ctypes
import numbers
import os
import struct
import threading
from typing import Iterable, Optional

import numpy as np
import scipy.sparse as sp

from randomprojection_tpu_torch.native.build import load_murmur3
from randomprojection_tpu_torch.utils import telemetry

__all__ = [
    "murmur3_32", "hash_tokens", "FeatureHasher", "hash_threads_override",
]

# The worker count of the C++ batch kernel comes from the explicit
# ``n_threads`` argument of its ``*_t`` entry points, scoped per thread by
# ``hash_threads_override``: no process-global state, so concurrent
# streams neither serialize nor leak their setting into each other.  The
# output is bit-identical at any count (token i's hash depends on token i
# alone), so the override changes wall clock, never values.
_THREAD_OVERRIDE = threading.local()


def _requested_threads(n_threads: Optional[int]) -> int:
    """The worker count of one kernel call: the explicit argument, else
    this thread's ``hash_threads_override`` scope, else 0 (the kernel
    reads ``RP_HASH_THREADS`` or the hardware's concurrency)."""
    if n_threads is not None:
        return int(n_threads)
    return int(getattr(_THREAD_OVERRIDE, "n", None) or 0)


def _emit_hash_batch(path: str, n_tokens: int,
                     n_threads: Optional[int]) -> None:
    """One counter (``hash.batches.<path>``) and, with a sink, one
    ``hash.batch`` event per batch: which kernel path served it
    (``strided`` or ``list``) and its worker count (0 = the kernel's
    default)."""
    telemetry.registry().counter_inc(telemetry.EVENTS.HASH_BATCHES_FAMILY + path)
    if telemetry.enabled():
        threads = _requested_threads(n_threads)
        if not threads:
            try:
                threads = int(os.environ.get("RP_HASH_THREADS", "0") or 0)
            except ValueError:
                threads = 0
        telemetry.emit(telemetry.EVENTS.HASH_BATCH, path=path,
                       tokens=int(n_tokens), threads=threads, native=True,
                       **telemetry.trace_fields())


@contextlib.contextmanager
def hash_threads_override(n_threads: Optional[int]):
    """Scope the C++ batch hasher's worker count (thread-local) around hash
    calls.  ``None`` keeps the ambient default; an int >= 1 pins it."""
    if n_threads is None:
        yield
        return
    n = int(n_threads)
    if n < 1:
        raise ValueError(f"n_threads must be >= 1, got {n_threads!r}")
    prev = getattr(_THREAD_OVERRIDE, "n", None)
    _THREAD_OVERRIDE.n = n
    try:
        yield
    finally:
        _THREAD_OVERRIDE.n = prev


def _murmur3_32_py(data: bytes, seed: int = 0) -> int:
    """Pure-Python MurmurHash3 x86_32: the plain version of the library."""
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = seed & 0xFFFFFFFF
    n_blocks = len(data) // 4
    for i in range(n_blocks):
        (k,) = struct.unpack_from("<I", data, i * 4)
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
        h = ((h << 13) | (h >> 19)) & 0xFFFFFFFF
        h = (h * 5 + 0xE6546B64) & 0xFFFFFFFF
    tail = data[n_blocks * 4:]
    k = 0
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
    h ^= len(data)
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h


def murmur3_32(data, seed: int = 0, *, signed: bool = True) -> int:
    """MurmurHash3 x86_32 of ``data`` (str or bytes), by the library."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    h = load_murmur3().murmur3_32(data, len(data), seed)
    if signed and h >= 2**31:
        h -= 2**32
    return h


def _reject_token(t):
    raise TypeError(
        f"Feature names must be str or bytes, got {type(t).__name__}: {t!r}"
    )


def _nul_scan(mat2d: np.ndarray):
    """One pass over a fixed-width token buffer → ``(has_embedded_nul,
    first_nul_lengths int64)``.  A row has an embedded NUL when a nonzero
    follows its first zero: there the strided kernel's first-NUL length
    would disagree with numpy's item semantics (trailing pad stripped)."""
    nz = mat2d != 0
    lengths = np.where(
        nz.all(axis=1), mat2d.shape[1], nz.argmin(axis=1)
    ).astype(np.int64)
    return bool(np.any(nz.sum(axis=1) != lengths)), lengths


def _hash_token_array(arr: np.ndarray, n_features: int, seed: int,
                      n_threads: Optional[int] = None):
    """Hash a numpy ``U``/``S`` token array in one library call.

    A fixed-width bytes array is the strided buffer the kernel takes: the
    lengths come from one vectorized scan.  ASCII unicode arrays narrow
    UCS-4 → uint8 with one cast; other unicode is utf-8 encoded first.  A
    column holding a token with an embedded NUL goes through the list path
    instead (the fixed-width padding cannot be told from content), so
    every path hashes such tokens alike."""
    if arr.ndim != 1:
        arr = arr.ravel()
    n = arr.shape[0]
    idx = np.empty(n, dtype=np.int32)
    sign = np.empty(n, dtype=np.int8)
    if n == 0:
        return idx, sign
    lib = load_murmur3()
    buf = None
    lengths = None
    if arr.dtype.kind == "U":
        w = arr.dtype.itemsize // 4
        codes = np.ascontiguousarray(arr).view(np.uint32).reshape(n, w)
        embedded, ulens = _nul_scan(codes)
        if embedded:
            telemetry.registry().counter_inc("hash.embedded_nul_fallbacks")
            return hash_tokens(arr.tolist(), n_features, seed,
                               n_threads=n_threads)
        if int(codes.max(initial=0)) < 128:
            buf = codes.astype(np.uint8)  # ASCII: one narrowing cast
            lengths = ulens
        else:
            arr = np.char.encode(arr, "utf-8")
    if buf is None:
        arr = np.ascontiguousarray(arr)
        sbuf = arr.view(np.uint8).reshape(n, arr.dtype.itemsize)
        embedded, lengths = _nul_scan(sbuf)
        if embedded:
            telemetry.registry().counter_inc("hash.embedded_nul_fallbacks")
            return hash_tokens(arr.tolist(), n_features, seed,
                               n_threads=n_threads)
        buf = sbuf
    _emit_hash_batch("strided", n, n_threads)
    lib.hash_tokens_strided_t(
        ctypes.c_void_p(buf.ctypes.data), buf.shape[1],
        lengths.ctypes.data_as(ctypes.c_void_p), n, seed, n_features,
        idx.ctypes.data_as(ctypes.c_void_p),
        sign.ctypes.data_as(ctypes.c_void_p), _requested_threads(n_threads),
    )
    return idx, sign


def hash_tokens(tokens: Iterable, n_features: int, seed: int = 0,
                n_threads: Optional[int] = None):
    """Batch-hash tokens → ``(idx int32, sign int8)`` in one library call
    over one concatenated buffer.

    ``n_threads`` pins the kernel's worker count for this call (``None``:
    this thread's ``hash_threads_override`` scope, else the
    ``RP_HASH_THREADS`` / hardware default); the output is bit-identical
    at any count.  Tokens must be ``str`` or ``bytes`` (sklearn's
    contract: an int would silently hash as that many zero bytes).  A
    numpy ``U*``/``S*`` array takes ``_hash_token_array``, with no
    per-token Python."""
    if isinstance(tokens, np.ndarray) and tokens.dtype.kind in ("U", "S"):
        return _hash_token_array(tokens, n_features, seed, n_threads=n_threads)
    encoded = [
        t.encode("utf-8") if isinstance(t, str)
        else bytes(t) if isinstance(t, (bytes, bytearray))
        else _reject_token(t)
        for t in tokens
    ]
    n = len(encoded)
    idx = np.empty(n, dtype=np.int32)
    sign = np.empty(n, dtype=np.int8)
    if n == 0:
        return idx, sign
    lib = load_murmur3()
    _emit_hash_batch("list", n, n_threads)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    lib.hash_tokens_t(
        b"".join(encoded), offsets.ctypes.data_as(ctypes.c_void_p), n, seed,
        n_features, idx.ctypes.data_as(ctypes.c_void_p),
        sign.ctypes.data_as(ctypes.c_void_p), _requested_threads(n_threads),
    )
    return idx, sign


class FeatureHasher:
    """Hash raw feature tokens into a ``(n_samples, n_features)`` CSR matrix.

    Input per sample (``input_type``): ``'string'``, an iterable of tokens
    each counting 1; ``'pair'``, an iterable of ``(token, value)``;
    ``'dict'``, a mapping ``token -> value``.  ``alternate_sign=True``
    multiplies each value by the hash sign (the role of ``s`` in
    ``CountSketch``).  ``dtype=np.float32`` feeds the card's CountSketch
    routes without a cast.
    """

    def __init__(self, n_features: int = 2**20, *, input_type: str = "dict",
                 alternate_sign: bool = True, dtype=np.float64):
        if not isinstance(n_features, numbers.Integral) or n_features <= 0:
            raise ValueError(f"n_features must be a positive int, got {n_features!r}")
        if input_type not in ("dict", "pair", "string"):
            raise ValueError(
                f"input_type must be 'dict', 'pair' or 'string', got {input_type!r}"
            )
        if np.dtype(dtype).kind != "f":
            raise ValueError(f"dtype must be a float dtype, got {np.dtype(dtype)!r}")
        self.n_features = int(n_features)
        self.input_type = input_type
        self.alternate_sign = alternate_sign
        self.dtype = np.dtype(dtype)

    def transform(self, raw_X) -> sp.csr_array:
        tokens: list = []
        indptr = [0]
        if self.input_type == "string":
            for sample in raw_X:
                tokens.extend(sample)
                indptr.append(len(tokens))
            values = None
        else:
            values = []
            for sample in raw_X:
                items = sample.items() if self.input_type == "dict" else sample
                for tok, val in items:
                    if val == 0:
                        continue
                    tokens.append(tok)
                    values.append(val)
                indptr.append(len(tokens))
        return self._build_csr(tokens, indptr, values)

    def transform_tokens(self, tokens, indptr=None, values=None) -> sp.csr_array:
        """Pre-tokenized ingest (the streaming TF-IDF path).

        ``tokens``: a flat numpy ``U*``/``S*`` array (one library call) or
        any flat sequence of str/bytes.  ``indptr``: CSR row pointers
        ``(n_samples + 1,)``; ``None`` = one sample.  ``values``: per-token
        weights (default 1.0).  Explicit zero values stay as stored zeros.
        """
        if indptr is None:
            indptr = np.asarray([0, len(tokens)], dtype=np.int64)
        else:
            indptr = np.asarray(indptr, dtype=np.int64)
            if (indptr.ndim != 1 or indptr.size == 0 or indptr[0] != 0
                    or indptr[-1] != len(tokens)):
                raise ValueError(
                    f"indptr must be 1-D with indptr[0]=0 and "
                    f"indptr[-1]=len(tokens)={len(tokens)}"
                )
            if np.any(np.diff(indptr) < 0):
                raise ValueError("indptr must be non-decreasing")
        if values is not None and len(values) != len(tokens):
            raise ValueError(
                f"values has length {len(values)} but there are "
                f"{len(tokens)} tokens"
            )
        return self._build_csr(tokens, indptr, values)

    def _build_csr(self, tokens, indptr, values) -> sp.csr_array:
        idx, sign = hash_tokens(tokens, self.n_features)
        if values is None:
            data = np.ones(len(idx), dtype=self.dtype)
        else:
            data = np.asarray(values, dtype=self.dtype)
        if self.alternate_sign:
            data = data * sign
        # a copy of indptr: sum_duplicates rewrites the CSR arrays in place
        mat = sp.csr_array(
            (data, idx, np.array(indptr, dtype=np.int64, copy=True)),
            shape=(len(indptr) - 1, self.n_features),
        )
        mat.sum_duplicates()
        return mat

    fit_transform = transform

    def fit(self, X=None, y=None):
        return self
