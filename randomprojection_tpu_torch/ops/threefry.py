"""JAX's threefry2x32 PRNG in torch integer ops, on an explicit device.

The JAX backend of the reference draws its dense matrices with
``jax.random`` (threefry2x32, ``jax_threefry_partitionable=True``).  This
module reproduces that stream word for word, so the port's ``TorchBackend``
draws the same matrix for the same seed, on the CPU and on the card:

- ``threefry_2x32``: the 20-round hash of jax ``_src/prng.py``
  (``_threefry2x32_lowering``), rotations ``(13, 15, 26, 6)`` and
  ``(17, 29, 16, 24)``, key schedule ``k0, k1, k0 ^ k1 ^ 0x1BD11BDA``.
- ``seed_key``: ``jax.random.key(seed)`` as the reference runs it (64-bit
  types off: the seed wraps to 32 bits, so the high word is 0).
- ``fold_in``: ``threefry_2x32(key, threefry_seed(data))``.
- ``random_bits``: the partitionable form.  The counters are the flat
  element index as a 64-bit iota split into ``(hi, lo)`` words
  (``iota_2x32_shape``), and the 32-bit bits are ``bits1 ^ bits2``.
- ``uniform``, ``normal`` and ``bernoulli`` as in jax ``_src/random.py``:
  the mantissa trick (``bits >> 9 | 0x3F800000``, minus 1), the Gaussian
  as ``sqrt(2) · erf_inv(u)`` on ``u ∈ (nextafter(-1, 0), 1)``, Bernoulli
  mode ``'low'`` as ``uniform < p``.

Words are carried in ``int64`` and masked to 32 bits after every add and
shift: torch's ``uint32`` has too few operations, fewest on CUDA.  A key is
an ``int64`` tensor whose last axis holds its two words; a batch of keys
(one per column block) broadcasts against the counters, so a whole matrix
is one pass of elementwise ops.

``erf_inv`` transcribes XLA's float32 lowering (Giles' single-precision
polynomial in ``w = -log1p(-x²)``, Horner steps as fused multiply-adds).
XLA's own ``log1p`` is not correctly rounded and its source is not at
hand, so ``w`` may differ from the reference's in its last bit: ``erf_inv``
is held to the reference within 2 ulps and a Gaussian matrix within 4
(``tests/test_torch_threefry.py``; about 1% of entries differ at all), while
uniform and Bernoulli draws, and so the sparse and Rademacher matrices,
are bit-equal, on the CPU and on the card alike.  The float64 ``log1p`` of
the card and of the CPU may differ in their last bit, so a Gaussian drawn
on the card is within a few ulps of the same draw on the CPU (2 measured on
an H100, ``chip_smoke.py``).
"""

from __future__ import annotations

import math
import struct

__all__ = [
    "threefry_2x32",
    "threefry_seed",
    "seed_key",
    "fold_in",
    "random_bits",
    "uniform",
    "normal",
    "bernoulli",
    "erf_inv",
]

_MASK32 = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# Giles' single-precision erfinv polynomial as XLA lowers it (stablehlo's
# chlo.erf_inv for f32): one set for w < 5, one past it
_ERFINV_LT5 = (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941,
)
_ERFINV_GE5 = (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682,
)


# the coefficients rounded to float32, as the lowering holds them
_ERFINV_LT5_F32 = tuple(float(struct.unpack("f", struct.pack("f", c))[0])
                        for c in _ERFINV_LT5)
_ERFINV_GE5_F32 = tuple(float(struct.unpack("f", struct.pack("f", c))[0])
                        for c in _ERFINV_GE5)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK32


def threefry_2x32(k0, k1, x0, x1):
    """The threefry2x32 hash of counter words ``(x0, x1)`` under key words
    ``(k0, k1)``: int64 tensors holding uint32 values (broadcast together).
    Returns the two output words, int64 in ``[0, 2**32)``."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & _MASK32
    x1 = (x1 + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK32
    return x0, x1


def threefry_seed(seed: int):
    """jax ``_threefry_seed`` of a 64-bit integer: ``(seed >> 32, seed &
    0xFFFFFFFF)`` as Python ints."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return (seed >> 32) & _MASK32, seed & _MASK32


def seed_key(seed: int, device=None):
    """``jax.random.key(seed)`` as the reference runs it: with 64-bit types
    off, jax wraps the seed to int32 before ``_threefry_seed``, so the key
    is ``[0, seed mod 2**32]``.  An int64 tensor ``(2,)`` on ``device``
    (None: the card, raising when there is none); every draw from the key
    runs on its device."""
    import torch

    from randomprojection_tpu_torch.backends.torch_backend import resolve_device

    device = resolve_device(device, how="device='cpu'")
    hi, lo = threefry_seed(int(seed) & _MASK32)
    return torch.tensor([hi, lo], dtype=torch.int64, device=device)


def fold_in(key, data):
    """``jax.random.fold_in(key, data)``: ``data`` is an int or an int64
    tensor of uint32 values (one folded key per element).  Returns keys
    of shape ``data.shape + (2,)``."""
    import torch

    data = torch.as_tensor(data, dtype=torch.int64, device=key.device)
    b0, b1 = threefry_2x32(
        key[..., 0], key[..., 1], torch.zeros_like(data), data & _MASK32
    )
    return torch.stack([b0, b1], dim=-1)


def random_bits(key, shape):
    """32-bit random words of ``shape`` (int64 tensor), the partitionable
    form.  ``key`` is ``(2,)`` or a batch of keys ``(B, 2)``; a batch draws
    ``(B,) + shape``, each slice from its own key."""
    import torch

    n = math.prod(shape)
    if n > 2**32:
        raise ValueError(
            f"random_bits of {n} elements: counters past 2**32 are not "
            "reproduced"
        )
    lo = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    k0, k1 = key[..., 0], key[..., 1]
    for _ in shape:
        k0, k1 = k0.unsqueeze(-1), k1.unsqueeze(-1)
    # the high counter word is 0 below 2**32 elements
    b1, b2 = threefry_2x32(k0, k1, torch.zeros_like(lo), lo)
    return b1 ^ b2


def _float32_from_bits(bits):
    """uniform ``[0, 1)`` float32 from 32-bit words: the top 23 bits as a
    mantissa under exponent 0 (``[1, 2)``), minus one — exact."""
    import torch

    fb = (bits >> 9) | 0x3F800000
    return fb.to(torch.int32).view(torch.float32) - 1.0


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0):
    """``jax.random.uniform(key, shape, float32, minval, maxval)``; the
    scale and shift are one fused multiply-add, as XLA emits them (exact
    in float64, rounded once)."""
    import torch

    floats = _float32_from_bits(random_bits(key, shape))
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    scaled = (floats.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


def erf_inv(x):
    """XLA's float32 ``erf_inv``: Giles' polynomial in ``w = -log1p(-x²)``
    (``w < 5``: in ``w - 2.5``; else in ``sqrt(w) - 3``), times ``x``;
    ``±1`` gives ``±inf``.

    ``log1p`` runs in float64 and rounds once to float32: torch's float32
    ``log1p`` on the CPU gives different bits from one call to the next
    (its vector and scalar paths split the array where the threads do),
    and XLA's is not correctly rounded either.  Each Horner step is one
    float32 fused multiply-add as XLA emits it, done exactly in float64
    and rounded once."""
    import torch

    w = (-torch.log1p((x * -x).double())).float()
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    # each step selects its coefficient pair by scalars: no (..., 9) table
    p = None
    for c_lt, c_ge in zip(_ERFINV_LT5_F32, _ERFINV_GE5_F32):
        c = torch.where(lt, c_lt, c_ge).double()
        p = c if p is None else (c + p * w).float().double()
    p = p.float()
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key, shape, scale=None):
    """``jax.random.normal(key, shape, float32)``: ``sqrt(2) · erf_inv(u)``
    with ``u`` uniform on ``(nextafter(-1, 0), 1)``.  ``scale`` multiplies
    the draw as XLA compiles ``normal(...) * scale``: it folds the two
    float32 constants into one, ``erf_inv(u) · (sqrt(2) · scale)``."""
    import torch

    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    u = uniform(key, shape, lo, 1.0)
    c = torch.tensor(math.sqrt(2), dtype=torch.float32, device=key.device)
    if scale is not None:
        c = c * torch.tensor(scale, dtype=torch.float32, device=key.device)
    return erf_inv(u) * c


def bernoulli(key, p: float, shape):
    """``jax.random.bernoulli(key, p, shape)`` (mode ``'low'``): float32
    ``uniform < float32(p)``."""
    import torch

    pf = torch.tensor(p, dtype=torch.float32, device=key.device)
    return uniform(key, shape) < pf
