"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/torch_kernels/lib<name>-<digest>.so``
at the first call that needs it, then loaded with ``ctypes``.  The digest
covers the source and the flags, so an edited source is rebuilt and a
stale library is never loaded.  The compile goes to a temporary name and
is renamed into place, so concurrent processes never load a half-written
library.  Nothing here runs at import: the CPU tests import every module
on machines with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Tuple

__all__ = ["Build", "build", "load", "kernel_resources"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_NVCC_TIMEOUT_S = 600


@dataclasses.dataclass(frozen=True)
class Build:
    """One compiled library: its path, the compile's wall seconds in this
    process (0.0 when an existing library was reused) and ``ptxas -v``'s
    report of registers and shared memory per kernel."""

    path: Path
    seconds: float
    ptxas_log: str


_LOADED: Dict[str, Tuple[ctypes.CDLL, Build]] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [str(Path(home) / "bin" / "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are compiled from csrc/ at first use"
    )


def build(name: str) -> Build:
    """Compile ``csrc/<name>.cu`` unless a library of the same digest exists."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    log = out.with_suffix(".ptxas.txt")
    if out.exists():
        return Build(out, 0.0, log.read_text() if log.exists() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(
        cmd, capture_output=True, text=True, timeout=_NVCC_TIMEOUT_S
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {src}:\n{proc.stdout}\n{proc.stderr}"
        )
    log.write_text(proc.stderr)
    os.replace(tmp, out)
    return Build(out, seconds, proc.stderr)


def load(name: str) -> Tuple[ctypes.CDLL, Build]:
    """The loaded library for ``csrc/<name>.cu`` (built on first use)."""
    hit = _LOADED.get(name)
    if hit is None:
        b = build(name)
        hit = (ctypes.CDLL(str(b.path)), b)
        _LOADED[name] = hit
    return hit


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")
_SPILL = re.compile(r"(\d+) bytes spill stores")


def kernel_resources(ptxas_log: str) -> List[dict]:
    """Registers, static shared memory and spill stores per kernel, from
    ``ptxas -v``'s report (one dict per compiled entry function)."""
    rows: List[dict] = []
    for line in ptxas_log.splitlines():
        m = _ENTRY.search(line)
        if m:
            rows.append({"kernel": m.group(1)})
            continue
        if not rows:
            continue
        for key, rx in (("registers", _USED), ("smem_bytes", _SMEM),
                        ("spill_store_bytes", _SPILL)):
            m = rx.search(line)
            if m:
                rows[-1][key] = int(m.group(1))
    return rows
