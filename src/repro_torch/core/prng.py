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
synthetic frames, a model's random init) pass the device they feed.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

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


# Words drawn at a time: a large draw (qwen2.5-3b's 311 M-value embedding)
# runs in chunks, so that its int64 and float64 temporaries stay near 1 GB.
_CHUNK = 1 << 24


def _words(key: Key, start: int, n: int, device) -> torch.Tensor:
    """Words ``start .. start + n`` of the stream: the XOR of the two output
    words for the 64-bit counter ``i``."""
    i = torch.arange(start, start + n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key, i >> 32, i & _M32)
    return y0 ^ y1


def _draw(key: Key, shape: Sequence[int], device, fn, dtype: torch.dtype) -> torch.Tensor:
    """``fn`` (elementwise) of the words of ``shape``, drawn in chunks of
    :data:`_CHUNK`; the chunks do not change the values.  On the meta device
    (shapes only) nothing is drawn."""
    shape = tuple(int(d) for d in shape)
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    n = math.prod(shape)
    if n <= _CHUNK:
        return fn(_words(key, 0, n, device)).reshape(shape)
    out = torch.empty(n, dtype=dtype, device=device)
    for start in range(0, n, _CHUNK):
        m = min(_CHUNK, n - start)
        out[start:start + m] = fn(_words(key, start, m, device))
    return out.reshape(shape)


def bits(key: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """32-bit random words (int64 tensor) of ``shape``, equal to
    ``jax.random.bits(key, shape, uint32)``: word ``i`` (row-major) is the
    XOR of the two output words for the counter ``i``."""
    return _draw(key, shape, device, lambda w: w, torch.int64)


def randint(key: Key, shape: Sequence[int], minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32 bounds), bit
    for bit, as an int64 tensor.

    jax draws two words per value from ``split(key)`` and folds them into
    ``[0, span)``: ``(hi % span)·m + lo % span`` with ``m = (2**16 % span)**2 %
    span``, every product and sum wrapped to 32 bits as jax's uint32 wraps
    (so ``m`` is 0 for a span above 2**16), then ``% span``.  The port has
    no uint32 arithmetic (ROADMAP C2), so it computes in int64 and masks to
    32 bits where jax's uint32 wraps.
    """
    lo_i32, hi_i32 = -(1 << 31), (1 << 31) - 1
    if not (lo_i32 <= minval <= hi_i32 and lo_i32 <= maxval <= hi_i32):
        raise ValueError(f"randint takes int32 bounds, got [{minval}, {maxval})")
    span = maxval - minval if maxval > minval else 1
    mult = ((2**16 % span) ** 2 & _M32) % span
    k1, k2 = split(key)
    hi, lo = bits(k1, shape, device), bits(k2, shape, device)
    off = ((((hi % span) * mult) & _M32) + lo % span) & _M32
    return off % span + minval


def _float_from_bits(b: torch.Tensor) -> torch.Tensor:
    """[1, 2) from the top 23 bits, minus 1: jax's uniform in [0, 1)."""
    one = 0x3F800000
    f = ((b >> 9) | one).to(torch.int32).view(torch.float32)
    return f - 1.0


def _uniform(w: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    f = _float_from_bits(w)
    lo = torch.tensor(minval, dtype=torch.float32, device=f.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=f.device)
    scaled = (f.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


def uniform(key: Key, shape: Sequence[int] = (), device=None, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``, bit for bit.

    The reference's ``f·(hi − lo) + lo`` is contracted into one fused
    multiply-add by XLA; torch has none, so it is taken in float64 (the
    product of two f32 values is exact there) and rounded to f32 once.
    """
    return _draw(key, shape, device, lambda w: _uniform(w, minval, maxval), torch.float32)


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

    def fn(w):
        u = _uniform(w, -(1.0 - 2.0**-24), 1.0)  # f32 nextafter(-1, 0)
        return erf_inv(u) * torch.tensor(math.sqrt(2), dtype=torch.float32, device=u.device)

    return _draw(key, shape, device, fn, torch.float32)


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



def gumbel(key: Key, shape: Sequence[int] = (), device=None) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` in jax's default ``"low"``
    mode: ``-log(-log(u))`` with ``u`` uniform on ``[tiny, 1)``.  The uniform
    is bit-exact; the two f32 logs are PyTorch's, which differ from XLA's by
    an ulp on some arguments (ROADMAP C3)."""
    tiny = torch.finfo(torch.float32).tiny
    return _draw(key, shape, device,
                 lambda w: -torch.log(-torch.log(_uniform(w, tiny, 1.0))), torch.float32)


def categorical(key: Key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis, with
    replacement: ``argmax(gumbel(key, logits.shape) + logits)``, the first
    maximum on a tie, as ``jnp.argmax`` takes it.  int64, shaped like
    ``logits`` without its last axis, on its device.  A draw equals jax's
    unless two candidates lie within the logs' rounding (ROADMAP C3)."""
    g = gumbel(key, tuple(logits.shape), logits.device)
    return torch.argmax(g + logits.to(torch.float32), dim=-1)
