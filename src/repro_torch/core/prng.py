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


def _normal_words(w: torch.Tensor) -> torch.Tensor:
    u = _uniform(w, -(1.0 - 2.0**-24), 1.0)  # f32 nextafter(-1, 0)
    return erf_inv(u) * torch.tensor(math.sqrt(2), dtype=torch.float32, device=u.device)


def normal(key: Key, shape: Sequence[int] = (), device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: ``sqrt(2)·erf_inv(u)`` with
    ``u`` uniform on ``[nextafter(-1, 0), 1)``.  The uniform is bit-exact;
    the result is within 4 ulp of jax's (see :func:`erf_inv`)."""
    return _draw(key, shape, device, _normal_words, torch.float32)


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


def categorical(key: Key, logits: torch.Tensor,
                shape: Optional[Sequence[int]] = None) -> torch.Tensor:
    """``jax.random.categorical(key, logits, shape=shape)`` over the last
    axis, with replacement: ``argmax(gumbel(key, shape + logits.shape[-1:]) +
    logits)``, the first maximum on a tie, as ``jnp.argmax`` takes it.
    ``shape`` (default: ``logits.shape[:-1]``) must end in the logits' batch
    shape; jax draws ``shape=(B,)`` from 1-d logits exactly as it draws from
    ``logits.expand(B, n)``.  int64 of ``shape`` on the logits' device.  A
    draw equals jax's unless two candidates lie within the logs' rounding
    (ROADMAP C3)."""
    if shape is not None:
        logits = logits.expand(*shape, logits.shape[-1])
    g = gumbel(key, tuple(logits.shape), logits.device)
    return torch.argmax(g + logits.to(torch.float32), dim=-1)


def exponential(key: Key, shape: Sequence[int] = (), device=None) -> torch.Tensor:
    """``jax.random.exponential(key, shape, float32)``: ``-log1p(-u)``.  The
    uniform is bit-exact; the ``log1p`` is PyTorch's (ROADMAP C3)."""
    return _draw(key, shape, device, lambda w: -torch.log1p(-_uniform(w, 0.0, 1.0)),
                 torch.float32)


# ---------------------------------------------------------------------------
# Gamma and Dirichlet draws: jax's Marsaglia-Tsang sampler, every element at once
# ---------------------------------------------------------------------------
#
# jax draws each element of a gamma sample under its own key (``split(key,
# n)``, row-major) with a rejection loop (``jax._src.random._gamma_one``).
# Here the keys of all elements are two int64 word tensors (``threefry2x32``
# takes tensor keys as it takes tensor counters), and the loop runs on the
# elements still active until none is.


def _split_keys(keys, num: int = 2):
    """``split`` of every key of a batch: ``num`` pairs of word tensors."""
    return [threefry2x32(keys, 0, i) for i in range(num)]


def _word0(keys) -> torch.Tensor:
    """Word 0 of each key's stream: ``bits(key, ())`` of every key."""
    y0, y1 = threefry2x32(keys, 0, 0)
    return y0 ^ y1


def _fma(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """f32 ``a·b + c`` rounded once, as XLA on the CPU contracts it (the
    product is exact in float64)."""
    return (a.double() * b.double() + c).float()


def _x_and_v(x_keys, c: torch.Tensor):
    """jax's inner loop: ``x = normal(split(k)[1], ())``, ``v = 1 + x·c``,
    ``k = split(k)[0]``, until ``v > 0``."""
    k0, k1 = x_keys[0].clone(), x_keys[1].clone()
    x, v = torch.empty_like(c), torch.empty_like(c)
    j = torch.arange(c.numel(), device=c.device)
    while j.numel():
        nxt, sub = _split_keys((k0[j], k1[j]))
        xj = _normal_words(_word0(sub))
        vj = _fma(xj, c[j], 1.0)
        x[j], v[j], k0[j], k1[j] = xj, vj, nxt[0], nxt[1]
        j = j[vj <= 0]
    return x, v


def _gamma_batch(keys, alpha: torch.Tensor, log_space: bool):
    """jax's ``_gamma_one`` on every element of the flat f32 ``alpha`` under
    its key of ``keys``; returns (samples, iterations of the outer loop).

    Where it can differ from jax: the normals (within 4 ulp, ``erf_inv``) and
    the f32 ``log``/``log1p`` (PyTorch's; XLA's differ by an ulp on some
    arguments, ROADMAP C3).  The fused multiply-adds XLA contracts are
    emulated (:func:`_fma`).  A rejection decision that flips sends that
    element down another key chain, so a flip gives a wholly different
    sample: the tests count them.
    """
    dev = alpha.device
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    boost = alpha >= 1
    a = torch.where(boost, alpha, alpha + 1)
    d = a - f32(1.0 / 3.0)
    c = f32(1.0 / 3.0) / torch.sqrt(d)
    (k0, k1), subkey = _split_keys(keys)
    k0, k1 = k0.clone(), k1.clone()
    V = torch.ones_like(alpha)
    iters = torch.zeros(alpha.shape, dtype=torch.int32, device=dev)
    i = torch.arange(alpha.numel(), device=dev)  # the elements not yet accepted
    while i.numel():
        nxt, x_key, u_key = _split_keys((k0[i], k1[i]), 3)
        x, v = _x_and_v(x_key, c[i])
        Xi, Vi = x * x, v * v * v
        U = _uniform(_word0(u_key), 0.0, 1.0)
        k0[i], k1[i], V[i] = nxt[0], nxt[1], Vi
        iters[i] += 1
        squeeze = U >= _fma(f32(-0.0331), Xi * Xi, 1.0)
        rest = torch.log(U) >= Xi * 0.5 + d[i] * ((1.0 - Vi) + torch.log(Vi))
        i = i[squeeze & rest]
    u = _uniform(_word0(subkey), 0.0, 1.0)
    if log_space:
        log_u = torch.log1p(-u)  # -exponential(subkey)
        log_boost = torch.where(boost | (log_u == 0), f32(0.0), log_u * (f32(1.0) / alpha))
        return torch.log(d) + torch.log(V) + log_boost, iters
    boost_f = torch.where(boost, f32(1.0), torch.pow(1.0 - u, f32(1.0) / alpha))
    return d * V * boost_f, iters


def _gamma(key: Key, a, shape, device, log_space: bool):
    a = torch.as_tensor(a, dtype=torch.float32, device=device)
    shape = tuple(a.shape) if shape is None else tuple(int(s) for s in shape)
    a = torch.broadcast_to(a, shape).reshape(-1)
    n = a.numel()
    idx = torch.arange(n, dtype=torch.int64, device=a.device)
    keys = threefry2x32(key, idx >> 32, idx & _M32)  # split(key, n), row-major
    out, iters = _gamma_batch(keys, a, log_space)
    return out.reshape(shape), iters.reshape(shape)


def gamma(key: Key, a, shape: Optional[Sequence[int]] = None, device=None):
    """``jax.random.gamma(key, a, shape, float32)``: Marsaglia-Tsang, one key
    per element (see :func:`_gamma_batch`)."""
    return _gamma(key, a, shape, device, log_space=False)[0]


def loggamma(key: Key, a, shape: Optional[Sequence[int]] = None, device=None,
             return_iterations: bool = False):
    """``jax.random.loggamma``: the log of :func:`gamma`'s sample taken in
    log space, ``log d + log V + log1p(-u)/a`` (the boost only where
    ``a < 1``), as jax computes it.  With ``return_iterations``, also each
    element's count of rejection-loop iterations (int32)."""
    out, iters = _gamma(key, a, shape, device, log_space=True)
    return (out, iters) if return_iterations else out


def dirichlet(key: Key, alpha, shape: Optional[Sequence[int]] = None, device=None,
              return_iterations: bool = False):
    """``jax.random.dirichlet(key, alpha, shape, float32)``:
    ``softmax(loggamma(key, alpha, shape + alpha.shape[-1:]))`` over the last
    axis, the softmax as jax writes it (``exp(x - max) / sum``).  Where a
    value underflows to a subnormal, XLA on the CPU flushes it to 0 and
    PyTorch keeps it (ROADMAP C1)."""
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=device)
    if alpha.dim() < 1:
        raise ValueError(f"dirichlet requires alpha.ndim >= 1, got {alpha.dim()}")
    batch = tuple(alpha.shape[:-1]) if shape is None else tuple(int(s) for s in shape)
    lg, iters = _gamma(key, alpha, batch + tuple(alpha.shape[-1:]), alpha.device,
                       log_space=True)
    e = torch.exp(lg - lg.amax(dim=-1, keepdim=True))
    out = e / e.sum(dim=-1, keepdim=True)
    return (out, iters) if return_iterations else out
