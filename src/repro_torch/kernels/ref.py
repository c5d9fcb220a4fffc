"""Plain PyTorch versions of the port's kernels (counterpart of ``repro.kernels.ref``).

Each kernel in ``csrc/`` computes the same function as one of these.  They
run on any device: the CPU path of ``ops`` uses them, the tests hold them
against the reference package, and ``chip_smoke.py`` holds the kernels
against them on the card.  They are built on ``core.formats`` and
``core.packing``, whose integer math is int64.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core.formats import FloatFormat, decode, encode, narrow, value_quantize, widen
from repro_torch.core.packing import bit_offsets, check_width, packed_words
from repro_torch.core.pvt import pvt_apply

from .agg import layout

_M32 = 0xFFFFFFFF


def ref_quantize(x: torch.Tensor, fmt: FloatFormat) -> torch.Tensor:
    """f32 -> codes (round to nearest even, subnormal-aware, saturating)."""
    return encode(x.to(torch.float32), fmt, quantize=True)


def ref_dequantize(codes: torch.Tensor, fmt: FloatFormat, s: Optional[torch.Tensor] = None,
                   b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """codes -> f32, optionally with the PVT affine (s·x + b)."""
    out = decode(codes, fmt)
    if s is not None:
        out = pvt_apply(out, s, b if b is not None else torch.zeros_like(s))
    return out


def ref_dequant_matmul(a: torch.Tensor, codes: torch.Tensor, fmt: FloatFormat,
                       s: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a[M, K] @ (s·decode(codes[K, N]) + b)`` in f32: the weight decoded
    with its affine, then one matmul (the reference's ``ref_dequant_matmul``)."""
    return a.to(torch.float32) @ pvt_apply(decode(codes, fmt), s, b)


def ref_quantize_stats(x: torch.Tensor, fmt: FloatFormat,
                       batch_axes: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes, sums) with ``sums[..., 4] = [Σv, Σṽ, Σvṽ, Σṽ²]`` per leading entry."""
    v = x.to(torch.float32)
    vq = value_quantize(v, fmt)
    codes = encode(vq, fmt, quantize=False)
    lead = tuple(v.shape[:batch_axes])
    v = v.reshape(math.prod(lead), -1)
    q = vq.reshape(v.shape)
    sums = torch.stack([v.sum(1), q.sum(1), (v * q).sum(1), (q * q).sum(1)], dim=-1)
    return codes, sums.reshape(lead + (4,))


def ref_fused_aggregate(srv_codes, srv_s, srv_b, cl_codes, cl_s, cl_b, weights, lr: float,
                        fmt: FloatFormat, *, batch_axes: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes, sums[entries, 4]) of one variable's compressed-domain server
    round (``agg.fused_aggregate``'s plain version).

    The kernel's operations in the kernel's order: clients summed one after
    another, each affine a multiply then an add, dead rows zeroed with
    ``where`` before the weighted sum, the weight sum taken in client order
    and floored at 1e-9.  So on the card the codes are the kernel's, bit for
    bit; the sums differ by the order of the f32 reduction.
    """
    lay = layout(srv_codes, srv_s, srv_b, cl_codes, cl_s, cl_b, weights, batch_axes)
    old = decode(lay.srv, fmt) * lay.srv_s[:, None] + lay.srv_b[:, None]
    acc = torch.zeros_like(old)
    wsum = torch.zeros((), dtype=torch.float32, device=old.device)
    for c in range(lay.cl.shape[0]):
        wc = lay.w[c]
        x = decode(lay.cl[c], fmt) * lay.cl_s[c][:, None] + lay.cl_b[c][:, None]
        x = torch.where(wc > 0, x, torch.zeros_like(x))
        acc = acc + x * wc
        wsum = wsum + wc
    new = old + float(lr) * (acc / torch.clamp(wsum, min=1e-9) - old)
    vq = value_quantize(new, fmt)
    codes = encode(vq, fmt, quantize=False).reshape(srv_codes.shape)
    sums = torch.stack([new.sum(1), vq.sum(1), (new * vq).sum(1), (vq * vq).sum(1)], dim=-1)
    return codes, sums


def ref_pack(codes: torch.Tensor, width: int) -> torch.Tensor:
    """Canonical exact-width bitstream (``core.packing.pack``'s plain version).

    Each field spans at most two words; contributions to one word occupy
    disjoint bits, so a scatter-ADD of the low/high parts equals a scatter-OR.
    """
    check_width(width)
    flat = widen(codes.reshape(-1))
    n = flat.shape[0]
    nwords = packed_words(n, width)
    word, sh = bit_offsets(torch.arange(n, device=flat.device), width)
    low = (flat << sh) & _M32
    # field >> (32 - sh) is undefined at sh == 0; (f >> (31 - sh)) >> 1 is safe.
    high = (flat >> (31 - sh)) >> 1
    out = torch.zeros(nwords + 1, dtype=torch.int64, device=flat.device)
    out.index_add_(0, word, low)
    out.index_add_(0, word + 1, high)
    return narrow(out[:nwords], torch.uint32)


def ref_unpack(words: torch.Tensor, width: int, n: int,
               dtype: torch.dtype = torch.uint32) -> torch.Tensor:
    """Inverse of :func:`ref_pack`."""
    check_width(width)
    w = widen(words.reshape(-1))
    w = torch.cat([w, torch.zeros(1, dtype=torch.int64, device=w.device)])
    word, sh = bit_offsets(torch.arange(n, device=w.device), width)
    lo = w[word] >> sh
    hi = ((w[word + 1] << (31 - sh)) & _M32) << 1
    return narrow((lo | hi) & ((1 << width) - 1), dtype)
