"""Build and load the murmur3 library (g++ → ``.so`` → ctypes).

``native/murmur3.cpp`` is compiled at the first call that needs it into
``build/native/libmurmur3-<digest>.so``, where the digest covers the
source and the flags, as ``ops/_build.py`` keys the CUDA sources: an
edited source is rebuilt and a stale library is never loaded.  The
compile goes to a temporary name and is renamed into place, so concurrent
processes never load a half-written library.  A failed compile raises
with the compiler's output: the pure-Python murmur3 in ``ops/hashing.py``
is the plain version the tests hold the library to, not a fallback.
Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

__all__ = ["load_murmur3", "library_path", "SRC", "FLAGS"]

SRC = Path(__file__).resolve().parent / "murmur3.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_TIMEOUT_S = 300

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    digest = hashlib.sha256(
        SRC.read_bytes() + " ".join(FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libmurmur3-{digest}.so"


def _compile(out: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError(
            "g++ not found (set CXX or put g++ on PATH): the feature "
            f"hasher's murmur3 library is compiled from {SRC} at first use"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=_TIMEOUT_S)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed ({proc.returncode}) on {SRC}:\n{proc.stdout}\n"
            f"{proc.stderr}"
        )
    os.replace(tmp, out)


def load_murmur3() -> ctypes.CDLL:
    """The bound library, built on first use; raises when it cannot be."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not out.exists():
            _compile(out)
        lib = ctypes.CDLL(str(out))
        p, i64, u32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32
        lib.murmur3_32.restype = u32
        lib.murmur3_32.argtypes = [ctypes.c_char_p, i64, u32]
        # (buf, offsets int64, n_tokens, seed, n_features, out_idx int32,
        #  out_sign int8, n_threads)
        lib.hash_tokens_t.restype = None
        lib.hash_tokens_t.argtypes = [ctypes.c_char_p, p, i64, u32, u32, p, p,
                                      i64]
        # (buf, stride, lengths int64, n_tokens, seed, n_features, out_idx,
        #  out_sign, n_threads)
        lib.hash_tokens_strided_t.restype = None
        lib.hash_tokens_strided_t.argtypes = [p, i64, p, i64, u32, u32, p, p,
                                              i64]
        _lib = lib
        return lib
