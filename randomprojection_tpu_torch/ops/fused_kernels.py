"""Fused projection with in-kernel mask regeneration, and its mask writer.

The port of ``randomprojection_tpu/ops/pallas_kernels.py``.  When ``k·d``
is large, keeping ``R`` resident costs device memory and bandwidth: every
batch re-reads ``k·d`` values.  Since the sparse/sign matrix is a pure
function of ``(seed, column block)``, the kernel regenerates each
``(k, BLOCK_D)`` block while contracting, so ``R`` never exists in device
memory and each batch moves ``n·d + n·k`` values instead of
``n·d + k·d + n·k``.

Matrix definition (the lazy family)
-----------------------------------
Block ``j`` of the matrix is the integer hash stream that the JAX package
uses under ``interpret=True`` (``_interp_mask_block``): for row ``ri`` of
the block, column ``ci`` within the full 512-wide block, seed ``s`` and
global block ``b = j + block_offset``, all in uint32::

    h = ri·0x9E3779B1 ^ ci·0x85EBCA77 ^ s·0xC2B2AE3D ^ b·0x27D4EB2F
    h = (h ^ (h >> 15))·0x2C1B3C6D
    h ^= h >> 13
    u = float(h >> 8)·2⁻²⁴

and the entry is +1 if ``u < f32(ρ/2)``, −1 if ``u < f32(ρ)``, else 0.  The
common scale ``1/sqrt(ρ·k)`` is applied once to the output.  The CUDA
kernels, the plain versions below and the JAX interpreter agree on every
mask bit.  It is NOT the TPU's hardware PRNG stream: a lazy model fitted
on a TPU has another matrix.  ``BLOCK_D``, the hash and the thresholds
define the persisted lazy family; changing any of them redefines every
saved lazy model.

Kernels and their plain versions
--------------------------------
``rp_fused_project`` / ``rp_lazy_matrix`` launch the CUDA kernels of
``csrc/fused_project.cu`` on the tensor's device and count their
launches in ``LAUNCHES``; ``rp_fused_project`` first writes the launch's
bf16 mask cache (``rp_mask_cache``, its own count), then runs the
tensor-core product on the plan of ``plan_project``.  ``fused_project`` /
``mask_cache_plain`` / ``lazy_matrix_plain`` / ``lazy_mask_block`` compute
the same functions with torch integer and float32 ops.  The public wrappers ``fused_sparse_project`` and
``lazy_matrix`` dispatch on the device: a CPU tensor goes to the plain
version, a CUDA tensor to the kernel, and anything else raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np

from randomprojection_tpu_torch.ops import _build
from randomprojection_tpu_torch.utils.validation import (
    check_density,
    check_input_size,
)

__all__ = [
    "BLOCK_D",
    "LAUNCHES",
    "MXU_MODES",
    "ProjectPlan",
    "fused_project",
    "fused_sparse_project",
    "lazy_mask_block",
    "lazy_matrix",
    "lazy_matrix_plain",
    "mask_cache_plain",
    "mask_limits",
    "plan_project",
    "project_smem_bytes",
    "reset_launches",
    "rp_fused_project",
    "rp_lazy_matrix",
    "rp_mask_cache",
]

BLOCK_D = 512  # contraction-dim block; part of the matrix definition
MXU_MODES = ("f32", "split2", "bf16")

#: kernel launches since the last ``reset_launches()``, by kernel name;
#: only the CUDA launchers add to it
LAUNCHES = {"rp_fused_project": 0, "rp_lazy_matrix": 0, "rp_mask_cache": 0}

_SRC = "fused_project"
_MASK32 = 0xFFFFFFFF
_C_ROW, _C_COL, _C_SEED, _C_BLOCK = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F
_C_MIX = 0x2C1B3C6D


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _seed_u32(seed) -> int:
    """Seeds are taken mod 2^32 (the JAX package's ``_seed_to_i32`` folds
    into int32, and the hash reads that word as uint32)."""
    return int(seed) & _MASK32


def mask_limits(density: float):
    """``(lim_plus, lim_nonzero)``: the entry is +1 when ``h >> 8 <
    lim_plus``, −1 when ``lim_plus <= h >> 8 < lim_nonzero``, else 0.

    The thresholds ``ρ/2`` and ``ρ`` are computed in double and rounded to
    float32 once (what JAX's weak-typed comparison with an f32 array
    does).  ``u = m·2⁻²⁴`` is exact for the 24-bit integer ``m``, so
    ``u < t`` holds exactly when ``m < ceil(t·2²⁴)``."""
    def lim(t):
        return math.ceil(float(np.float32(t)) * (1 << 24))

    return lim(density * 0.5), lim(density)


def _f32(v: float) -> float:
    """A Python float that is exactly its float32 rounding, so every path
    scales by the same float32 value."""
    return float(np.float32(v))


def _mul32(a, c: int):
    """``a·c mod 2³²`` for an int64 tensor ``a`` in [0, 2³²) and a uint32
    constant: the constant is split into 16-bit halves so no product
    leaves int64's range."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _MASK32


def _mask_entries(ri, ci, blk, seed: int, density: float):
    """The hash stream on broadcastable int64 tensors ``ri``, ``ci``,
    ``blk`` → float32 {+1, −1, 0}."""
    import torch

    h = (
        _mul32(ri, _C_ROW)
        ^ _mul32(ci, _C_COL)
        ^ ((_seed_u32(seed) * _C_SEED) & _MASK32)
        ^ _mul32(blk & _MASK32, _C_BLOCK)
    )
    h = _mul32(h ^ (h >> 15), _C_MIX)
    h = h ^ (h >> 13)
    m = h >> 8
    lim_plus, lim_nonzero = mask_limits(density)
    one = torch.ones((), dtype=torch.float32, device=m.device)
    return torch.where(
        m < lim_plus, one, torch.where(m < lim_nonzero, -one, 0.0 * one)
    )


def lazy_mask_block(seed, block: int, n_components: int, density: float, *,
                    device="cpu"):
    """Unscaled ``(k, BLOCK_D)`` float32 mask of global column block
    ``block`` (plain torch; the definition the kernels reproduce)."""
    import torch

    ri = torch.arange(n_components, dtype=torch.int64, device=device)[:, None]
    ci = torch.arange(BLOCK_D, dtype=torch.int64, device=device)[None, :]
    blk = torch.tensor(int(block), dtype=torch.int64, device=device)
    return _mask_entries(ri, ci, blk, seed, density)


def _validate(n_components: int, n_features: int, density) -> float:
    density = check_density(density, n_features)
    check_input_size(n_components, n_features)
    if n_components % 8:
        raise ValueError(
            f"n_components must be a multiple of 8 for the fused kernel, "
            f"got {n_components}"
        )
    return density


def _validate_project(x, n_components: int, density, mxu_mode: str) -> float:
    """The checks of ``_fused_raw``: mode, a 2-D ``x``, density and k."""
    if mxu_mode not in MXU_MODES:
        raise ValueError(
            f"mxu_mode must be 'f32', 'split2' or 'bf16', got {mxu_mode!r}"
        )
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D, got shape {tuple(x.shape)}")
    return _validate(n_components, x.shape[1], density)


def lazy_matrix_plain(seed, n_components: int, n_features: int,
                      density: float, *, block_offset: int = 0, device="cpu"):
    """``M·scale`` as ``(k, d)`` float32 with plain torch ops: block by
    block, each full 512 wide, the last sliced to ``d``."""
    import torch

    density = _validate(n_components, n_features, density)
    scale = _f32(1.0 / math.sqrt(density * n_components))
    nj = -(-n_features // BLOCK_D)
    m = torch.cat(
        [
            lazy_mask_block(seed, j + block_offset, n_components, density,
                            device=device)
            for j in range(nj)
        ],
        dim=1,
    )
    return m[:, :n_features].contiguous() * scale


def mask_cache_plain(seed, n_components: int, n_features: int,
                     density: float, *, block_offset: int = 0, device="cpu"):
    """Plain torch version of the mask-cache writer: the unscaled mask as
    bf16 ``(k, dp)``, ``dp`` = ``n_features`` rounded up to ``STEP_D``,
    the columns past ``n_features`` zero."""
    import torch

    density = _validate(n_components, n_features, density)
    dp = _mask_columns(n_features)
    out = torch.zeros((n_components, dp), dtype=torch.bfloat16, device=device)
    for j in range(-(-n_features // BLOCK_D)):
        lo, hi = j * BLOCK_D, min(n_features, (j + 1) * BLOCK_D)
        out[:, lo:hi] = lazy_mask_block(seed, j + block_offset, n_components,
                                        density, device=device)[:, : hi - lo]
    return out


def fused_project(x, seed, n_components: int, density: float, *,
                  block_offset: int = 0, mxu_mode: str = "f32"):
    """Plain torch version of the fused kernel, in its arithmetic: for
    each 512-column block ``j`` in order, ``acc = x_j · M_jᵀ`` in float32
    (split2: the hi and lo bf16 halves' products summed in float32;
    bf16: x as bf16, widened exactly), ``y += acc``; then ``y·scale``.
    ``x`` must already be in the mode's dtype (float32, or bfloat16 for
    ``'bf16'``)."""
    import torch

    from randomprojection_tpu_torch.ops.precision import fp32_matmul
    from randomprojection_tpu_torch.ops.split_matmul import split_f32_to_bf16_pair

    density = _validate_project(x, n_components, density, mxu_mode)
    n, d = x.shape
    scale = _f32(1.0 / math.sqrt(density * n_components))
    y = torch.zeros((n, n_components), dtype=torch.float32, device=x.device)
    with fp32_matmul():
        for j in range(-(-d // BLOCK_D)):
            lo, hi = j * BLOCK_D, min(d, (j + 1) * BLOCK_D)
            m_t = lazy_mask_block(
                seed, j + block_offset, n_components, density, device=x.device
            )[:, : hi - lo].t()
            xb = x[:, lo:hi]
            if mxu_mode == "split2":
                x_hi, x_lo = split_f32_to_bf16_pair(xb)
                y += x_hi.float() @ m_t + x_lo.float() @ m_t
            else:
                y += xb.float() @ m_t
    return y * scale


# -- the launch planner ----------------------------------------------------------

# the constants of csrc/fused_project.cu
TILE_M = 64            # rows of Y per tile, shared by both consumer warpgroups
STEP_D = 64            # contraction columns per ring stage
SLICE_N = 256          # widest column slice of a tile (wgmma's widest N x 2)
MAX_STAGES = 6
SMEM_LIMIT = 232_448   # dynamic shared memory a block can use on Hopper
_SMEM_SLACK = 1024 + 128  # the swizzle's 1024-byte alignment + mbarriers


def _itemsize(mxu_mode: str) -> int:
    return 2 if mxu_mode == "bf16" else 4


def _mask_columns(n_features: int) -> int:
    """The mask cache's width: ``n_features`` rounded up to ``STEP_D``."""
    return -(-n_features // STEP_D) * STEP_D


def project_smem_bytes(cta_n: int, mxu_mode: str, stages: int) -> int:
    """Shared memory of one fused launch: ``stages`` ring stages of an x
    tile (64 rows x 64 columns) and a bf16 mask tile (``cta_n`` rows x 64
    columns), plus the alignment slack and the barriers."""
    x_bytes = TILE_M * STEP_D * _itemsize(mxu_mode)
    return _SMEM_SLACK + stages * (x_bytes + cta_n * STEP_D * 2)


@dataclasses.dataclass(frozen=True)
class ProjectPlan:
    """How ``rp_fused_project`` launches: the tile's column width
    ``cta_n`` (two consumer warpgroups of ``cta_n / 2``), the k slices, the
    ring's stages and shared memory, the x route (``'tma'`` when a row is a
    multiple of 16 bytes from a 16-byte-aligned base, else ``'cp.async'``),
    the padding column bf16 rows of odd width get (the cp.async route
    copies 4-byte pairs), the tiles (64 rows of one slice) and the
    persistent grid."""

    cta_n: int
    slices: int
    stages: int
    smem_bytes: int
    route: str
    pad_columns: int
    tiles: int
    grid: int
    mask_columns: int  # the mask cache's width: d rounded up to STEP_D


def plan_project(n: int, d: int, k: int, mxu_mode: str, sm_count: int, *,
                 base_aligned: bool = True) -> ProjectPlan:
    """The launch plan of ``rp_fused_project`` for an ``(n, d)`` batch to
    ``k`` columns on a card of ``sm_count`` SMs (plain Python, the
    wrapper's and the tests' single source of the plan)."""
    if mxu_mode not in MXU_MODES:
        raise ValueError(f"unknown mxu_mode {mxu_mode!r}")
    if k <= 0 or k % 8 or d <= 0 or n < 0 or sm_count <= 0:
        raise ValueError(f"no plan for n={n} d={d} k={k} sm_count={sm_count}")
    cta_n = 64 if k <= 64 else 128 if k <= 128 else SLICE_N
    slices = -(-k // cta_n)
    per_stage = project_smem_bytes(cta_n, mxu_mode, 1) - _SMEM_SLACK
    stages = min(MAX_STAGES, (SMEM_LIMIT - _SMEM_SLACK) // per_stage)
    item = _itemsize(mxu_mode)
    pad = 1 if item == 2 and d % 2 else 0
    tma = base_aligned and (d * item) % 16 == 0
    tiles = -(-n // TILE_M) * slices
    return ProjectPlan(
        cta_n=cta_n, slices=slices, stages=stages,
        smem_bytes=project_smem_bytes(cta_n, mxu_mode, stages),
        route="tma" if tma else "cp.async", pad_columns=pad, tiles=tiles,
        grid=max(1, min(tiles, sm_count)),
        mask_columns=_mask_columns(d),
    )


# -- the CUDA kernels ----------------------------------------------------------

_MODE_CODES = {"f32": 0, "split2": 1, "bf16": 2}
_DECLARED: set = set()


def _lib():
    lib, _ = _build.load(_SRC)
    if _SRC not in _DECLARED:
        p, i64, i32, u32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                            ctypes.c_uint32)
        lib.rp_fused_project.argtypes = [
            p, p, p, i64, i64, i64, i32, ctypes.c_float, i32, i32, i32, i32,
            i32, p,
        ]
        lib.rp_fused_project.restype = i32
        lib.rp_mask_cache.argtypes = [p, i32, i64, i64, u32, u32, u32, u32, p]
        lib.rp_mask_cache.restype = i32
        lib.rp_fused_smem_bytes.argtypes = [i32, i32, i32]
        lib.rp_fused_smem_bytes.restype = i32
        lib.rp_lazy_matrix.argtypes = [
            p, i32, i64, u32, u32, u32, u32, ctypes.c_float, p,
        ]
        lib.rp_lazy_matrix.restype = i32
        lib.rp_error_string.argtypes = [i32]
        lib.rp_error_string.restype = ctypes.c_char_p
        _DECLARED.add(_SRC)
    return lib


def build_info() -> _build.Build:
    """Build (or reuse) the kernels' library and return its build record."""
    _lib()
    return _build.load(_SRC)[1]


def _check_launch(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{what} launch failed: CUDA error {rc} "
            f"({lib.rp_error_string(rc).decode()})"
        )


def _stream_ptr(device):
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def _sm_count(device) -> int:
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def rp_mask_cache(seed, n_components: int, n_features: int, density: float,
                  *, block_offset: int = 0, device="cuda"):
    """Launch the mask-cache writer: the unscaled mask as bf16, ``(k,
    dp)`` with ``dp`` = ``n_features`` rounded up to 64 and the columns
    past ``n_features`` zero, on the card (what ``rp_fused_project`` loads
    its mask tiles from)."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"rp_mask_cache writes on a CUDA device, got {device}")
    density = _validate(n_components, n_features, density)
    dp = _mask_columns(n_features)
    out = torch.empty((n_components, dp), dtype=torch.bfloat16, device=device)
    lib = _lib()
    lim_plus, lim_nonzero = mask_limits(density)
    with torch.cuda.device(device):
        rc = lib.rp_mask_cache(
            out.data_ptr(), n_components, n_features, dp, _seed_u32(seed),
            int(block_offset) & _MASK32, lim_plus, lim_nonzero,
            _stream_ptr(device),
        )
    _check_launch(lib, rc, "rp_mask_cache")
    LAUNCHES["rp_mask_cache"] += 1
    return out


def rp_fused_project(x, seed, n_components: int, density: float, *,
                     block_offset: int = 0, mxu_mode: str = "split2"):
    """Launch the fused kernel on ``x``'s card: the mask cache, then the
    tensor-core product on ``plan_project``'s plan.  ``x``: contiguous CUDA
    tensor, float32 (``'f32'``, ``'split2'``) or bfloat16 (``'bf16'``).
    Returns ``(n, k)`` float32."""
    import torch

    if not (isinstance(x, torch.Tensor) and x.is_cuda):
        raise ValueError("rp_fused_project takes a CUDA tensor")
    density = _validate_project(x, n_components, density, mxu_mode)
    want = torch.bfloat16 if mxu_mode == "bf16" else torch.float32
    if x.dtype != want or not x.is_contiguous():
        raise ValueError(
            f"rp_fused_project needs a contiguous 2-D {want} tensor in mode "
            f"{mxu_mode!r}, got {x.dtype} {tuple(x.shape)} "
            f"contiguous={x.is_contiguous()}"
        )
    n, d = x.shape
    y = torch.empty((n, n_components), dtype=torch.float32, device=x.device)
    if n == 0:
        return y
    plan = plan_project(n, d, n_components, mxu_mode, _sm_count(x.device),
                        base_aligned=x.data_ptr() % 16 == 0)
    if plan.pad_columns or x.data_ptr() % 4:
        # bf16 rows of odd width (or a 2-byte-aligned view): a copy with a
        # zero column, n·2 bytes of padding, so the cp.async route copies
        # aligned 4-byte pairs; the zero column meets a zero mask column
        # (d odd is never a multiple of 64, so d + 1 keeps the mask width)
        x = torch.nn.functional.pad(x, (0, plan.pad_columns))
        plan = plan_project(n, x.shape[1], n_components, mxu_mode,
                            _sm_count(x.device))
    mask = rp_mask_cache(seed, n_components, d, density,
                         block_offset=block_offset, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.rp_fused_project(
            x.data_ptr(), mask.data_ptr(), y.data_ptr(), n, x.shape[1],
            plan.mask_columns, n_components,
            1.0 / math.sqrt(density * n_components), _MODE_CODES[mxu_mode],
            plan.cta_n, plan.stages, int(plan.route == "tma"), plan.grid,
            _stream_ptr(x.device),
        )
    _check_launch(lib, rc, "rp_fused_project")
    LAUNCHES["rp_fused_project"] += 1
    return y


def rp_lazy_matrix(seed, n_components: int, n_features: int, density: float,
                   *, block_offset: int = 0, device="cuda"):
    """Launch the mask writer: ``M·scale`` as ``(k, d)`` float32 on the card."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"rp_lazy_matrix writes on a CUDA device, got {device}")
    density = _validate(n_components, n_features, density)
    out = torch.empty((n_components, n_features), dtype=torch.float32,
                      device=device)
    lib = _lib()
    lim_plus, lim_nonzero = mask_limits(density)
    with torch.cuda.device(device):
        rc = lib.rp_lazy_matrix(
            out.data_ptr(), n_components, n_features, _seed_u32(seed),
            int(block_offset) & _MASK32, lim_plus, lim_nonzero,
            1.0 / math.sqrt(density * n_components), _stream_ptr(out.device),
        )
    _check_launch(lib, rc, "rp_lazy_matrix")
    LAUNCHES["rp_lazy_matrix"] += 1
    return out


# -- public wrappers -----------------------------------------------------------


def fused_sparse_project(x, seed, n_components: int, density: float, *,
                         block_offset: int = 0, mxu_mode: str = "f32"):
    """``Y = X @ R(seed)ᵀ`` with ``R`` regenerated in the kernel, never
    stored.  ``x`` is an ``(n, d)`` float tensor; it is cast to the mode's
    dtype (bfloat16 for ``'bf16'``, else float32).  ``n_components`` must
    be a multiple of 8.  ``block_offset`` shifts the column-block indices
    (a shard holding ``X[:, lo:hi]``, ``lo`` 512-aligned, passes
    ``lo // 512``).

    ``mxu_mode`` selects the contraction arithmetic, not the matrix:
    ``'f32'`` (float32 products), ``'split2'`` (x split hi/lo bf16, two
    products, f32-grade output), ``'bf16'`` (x kept bfloat16, half the x
    bytes).  A CPU tensor is computed by ``fused_project``; a CUDA tensor
    by the kernel; each validates its arguments as ``_fused_raw`` does.
    """
    import torch

    x = x.to(torch.bfloat16 if mxu_mode == "bf16" else torch.float32)
    if x.device.type == "cpu":
        return fused_project(x, seed, n_components, density,
                             block_offset=block_offset, mxu_mode=mxu_mode)
    if x.device.type == "cuda":
        return rp_fused_project(x.contiguous(), seed, n_components, density,
                                block_offset=block_offset, mxu_mode=mxu_mode)
    raise ValueError(f"no fused kernel for device {x.device}")


def lazy_matrix(seed, n_components: int, n_features: int, density: float, *,
                block_offset: int = 0, device=None):
    """The exact matrix ``fused_sparse_project`` contracts, ``M·scale`` as
    ``(k, d)`` float32 on ``device``: the plain version on the CPU, the
    mask kernel on a card.  ``device=None`` is the card, and raises when
    there is none: the CPU runs only when asked (``device='cpu'``)."""
    from randomprojection_tpu_torch.backends.torch_backend import resolve_device

    device = resolve_device(device, how="device='cpu'")
    if device.type == "cpu":
        return lazy_matrix_plain(seed, n_components, n_features, density,
                                 block_offset=block_offset, device=device)
    return rp_lazy_matrix(seed, n_components, n_features, density,
                          block_offset=block_offset, device=device)
