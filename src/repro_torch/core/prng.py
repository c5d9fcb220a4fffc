"""Threefry-2x32 random streams that reproduce ``jax.random`` bit for bit.

The reference draws cohorts, survival masks, PPQ masks and the synthetic
data from ``jax.random`` (threefry2x32, with ``jax_threefry_partitionable``
on, the default since jax 0.5).  Every participant must recompute the same
PPQ mask (``core.partial``), so the port needs the same bits: a
``torch.Generator`` cannot give them.

A key is a pair of Python ints ``(k0, k1)``, each a 32-bit word, as
``jax.random.PRNGKey`` holds them.  Deriving keys (``fold_in``, ``split``)
is host arithmetic on Python ints: no tensor, no device sync.  Drawing
bits for a shape is tensor arithmetic on ``device``.  PyTorch has almost
no uint32 arithmetic (ROADMAP C2), so the words are int64 holding values
below 2**32, masked after every add and rotate; the same code runs on
Python ints and on int64 tensors, on the CPU and on CUDA.

``device=None`` means the CPU: small control draws (cohort ids, masks)
belong on the host, where the callers index with them.  Bulk draws (the
synthetic frames) pass the device they feed.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

Key = Tuple[int, int]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(key: Key, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter pair ``(x0, x1)`` under
    ``key``; the counters are Python ints or int64 tensors of words."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def PRNGKey(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed (x64 off)."""
    return (0, int(seed) & _M32)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in``: the hash of the counter ``(0, data)``."""
    return threefry2x32(key, 0, int(data) & _M32)


def split(key: Key, num: int = 2) -> List[Key]:
    """``jax.random.split`` under ``jax_threefry_partitionable``: key ``i``
    is the hash of the 64-bit counter ``i``, i.e. ``fold_in(key, i)``."""
    return [threefry2x32(key, i >> 32, i & _M32) for i in range(num)]


def _counters(n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & _M32


def bits(key: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """32-bit random words (int64 tensor) of ``shape``, equal to
    ``jax.random.bits(key, shape, uint32)``: word ``i`` (row-major) is the
    XOR of the two output words for the counter ``i``."""
    shape = tuple(int(d) for d in shape)
    hi, lo = _counters(math.prod(shape), device)
    y0, y1 = threefry2x32(key, hi, lo)
    return (y0 ^ y1).reshape(shape)


def _float_from_bits(b: torch.Tensor) -> torch.Tensor:
    """[1, 2) from the top 23 bits, minus 1: jax's uniform in [0, 1)."""
    one = 0x3F800000
    f = ((b >> 9) | one).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key: Key, shape: Sequence[int] = (), device=None, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``, bit for bit.

    The reference's ``f·(hi − lo) + lo`` is contracted into one fused
    multiply-add by XLA; torch has none, so it is taken in float64 (the
    product of two f32 values is exact there) and rounded to f32 once.
    """
    f = _float_from_bits(bits(key, shape, device))
    lo = torch.tensor(minval, dtype=torch.float32, device=f.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=f.device)
    scaled = (f.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


# XLA's single-precision erf_inv (Giles, "Approximating the erfinv function"),
# the polynomial jax.lax.erf_inv lowers to.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """f32 inverse error function, XLA's polynomial in f32 arithmetic.

    ``torch.erfinv`` is a different approximation; this one follows XLA's
    steps, fused multiply-adds included, so it agrees with
    ``jax.lax.erf_inv`` up to the rounding of XLA's own ``log1p`` (the tests
    hold ``normal`` within 4 ulp of ``jax.random.normal``).
    """
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    wd = w.double()
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        # c + p·w as one fused multiply-add, as XLA contracts it (exact
        # product in float64, one rounding to f32)
        p = (torch.where(lt, a, b).double() + p.double() * wd).float()
    out = p * x
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max, out)


def normal(key: Key, shape: Sequence[int] = (), device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: ``sqrt(2)·erf_inv(u)`` with
    ``u`` uniform on ``[nextafter(-1, 0), 1)``.  The uniform is bit-exact;
    the result is within 4 ulp of jax's (see :func:`erf_inv`)."""
    u = uniform(key, shape, device, -(1.0 - 2.0**-24), 1.0)  # f32 nextafter(-1, 0)
    return erf_inv(u) * torch.tensor(math.sqrt(2), dtype=torch.float32, device=u.device)


def permutation(key: Key, n: int, device=None) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: jax's sort-based shuffle of
    ``arange(n)``, ``ceil(3·ln n / ln(2**32 − 1))`` rounds of a stable sort on
    fresh 32-bit keys.  int64 result."""
    x = torch.arange(n, dtype=torch.int64, device=device)
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(_M32)))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(bits(sub, (n,), device), stable=True).indices
        x = x[order]
    return x


def generator(key: Key, device: Optional[torch.device] = None) -> torch.Generator:
    """A ``torch.Generator`` seeded from a key's two words, for draws that
    need not match jax's bits (random init of a model)."""
    return torch.Generator(device=device or "cpu").manual_seed((key[0] << 32) | key[1])
