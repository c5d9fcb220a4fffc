"""Dispatch for the port's kernels, with launch counters.

Counterpart of ``repro.kernels.ops``.  Dispatch is on the tensors' device:

  * CUDA tensors go to the hand-written Hopper kernels (``quantize``,
    ``bitpack``, ``agg``, ``dequant_matmul``), which launch or raise;
  * CPU tensors go to the plain versions (``ref``).

There is no fallback: no switch sends a CUDA tensor to a plain version.
Every call bumps a counter keyed ``"<op>.cuda"`` or ``"<op>.ref"`` after
its launch returns, so a run can show that its path went through the
kernels (:func:`launch_counts`, :func:`reset_launch_counts`).

The reference's public names are here too, over the same counter and the
same functions: :func:`dispatch_counts`, :func:`reset_dispatch_counts`,
:func:`pack_bits` and :func:`unpack_bits`.  The counting rule differs from
the reference's: it counts once per traced specialization (its wrappers are
jitted), the port counts once per launch (per call), eager as it is.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Optional

import torch

from repro_torch.core.formats import FloatFormat
from repro_torch.core.pvt import pvt_from_sums

from . import agg as _agg
from . import bitpack as _bp
from . import dequant_matmul as _dm
from . import quantize as _q
from . import ref

_LAUNCHES: Counter = Counter()


def launch_counts() -> Dict[str, int]:
    """``{"<op>.<backend>": calls}`` accumulated since import or reset."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES.clear()


def dispatch_counts() -> Dict[str, int]:
    """The reference's name for :func:`launch_counts`: the same counter.
    Counts are per launch (one per call), not per traced specialization as
    the reference's are; keys are ``"<op>.cuda"`` or ``"<op>.ref"``, with
    ``pack``/``unpack`` for :func:`pack_bits`/:func:`unpack_bits`."""
    return launch_counts()


def reset_dispatch_counts() -> None:
    """The reference's name for :func:`reset_launch_counts` (one counter)."""
    reset_launch_counts()


def _on_cuda(op: str, *tensors: Optional[torch.Tensor]) -> bool:
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"{op}: tensors on {sorted(kinds)}; expected all on CUDA or all on the CPU")


def quantize(x: torch.Tensor, fmt: FloatFormat) -> torch.Tensor:
    """f32 -> codes only (the encode half of :func:`quantize_stats`)."""
    if _on_cuda("quantize", x):
        out = _q.quantize(x, fmt)
        _LAUNCHES["quantize.cuda"] += 1
    else:
        out = ref.ref_quantize(x, fmt)
        _LAUNCHES["quantize.ref"] += 1
    return out


def dequantize(codes: torch.Tensor, fmt: FloatFormat, s: Optional[torch.Tensor] = None,
               b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """codes -> f32 with the PVT affine ``decode(codes)·s + b`` fused."""
    if _on_cuda("dequantize", codes, s, b):
        out = _q.dequantize(codes, fmt, s, b)
        _LAUNCHES["dequantize.cuda"] += 1
    else:
        out = ref.ref_dequantize(codes, fmt, s, b)
        _LAUNCHES["dequantize.ref"] += 1
    return out


def dequant_matmul(a: torch.Tensor, codes: torch.Tensor, fmt: FloatFormat, s: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """``a[M, K] @ (s·decode(codes[K, N]) + b)`` in f32, the weight read as codes.

    One (s, b) pair, as one-element f32 tensors; an unsupported input raises
    ``ValueError`` on either device (``dequant_matmul.check_inputs``)."""
    if _on_cuda("dequant_matmul", a, codes, s, b):
        out = _dm.dequant_matmul(a, codes, fmt, s, b)
        _LAUNCHES["dequant_matmul.cuda"] += 1
    else:
        _dm.check_inputs(a, codes, fmt, s, b)
        out = ref.ref_dequant_matmul(a, codes, fmt, s, b)
        _LAUNCHES["dequant_matmul.ref"] += 1
    return out


def quantize_stats(x: torch.Tensor, fmt: FloatFormat, batch_axes: int = 0):
    """(codes, sums[..., 4]) — fused quantize + PVT statistics per entry."""
    if _on_cuda("quantize_stats", x):
        out = _q.quantize_stats(x, fmt, batch_axes)
        _LAUNCHES["quantize_stats.cuda"] += 1
    else:
        out = ref.ref_quantize_stats(x, fmt, batch_axes)
        _LAUNCHES["quantize_stats.ref"] += 1
    return out


def pack(codes: torch.Tensor, width: int) -> torch.Tensor:
    """codes (values < 2**width) -> exact uint32 bitstream (wire form)."""
    if _on_cuda("pack", codes):
        out = _bp.pack(codes, width)
        _LAUNCHES["pack.cuda"] += 1
    else:
        out = ref.ref_pack(codes, width)
        _LAUNCHES["pack.ref"] += 1
    return out


def unpack(words: torch.Tensor, width: int, n: int,
           dtype: torch.dtype = torch.uint32) -> torch.Tensor:
    """Inverse of :func:`pack`: recover ``n`` codes as ``dtype``."""
    if _on_cuda("unpack", words):
        out = _bp.unpack(words, width, n, dtype)
        _LAUNCHES["unpack.cuda"] += 1
    else:
        out = ref.ref_unpack(words, width, n, dtype)
        _LAUNCHES["unpack.ref"] += 1
    return out


def pack_bits(codes: torch.Tensor, width: int) -> torch.Tensor:
    """The reference's name for :func:`pack`; counted as ``pack.<backend>``,
    once per launch."""
    return pack(codes, width)


def unpack_bits(words: torch.Tensor, width: int, n: int,
                dtype: torch.dtype = torch.uint32) -> torch.Tensor:
    """The reference's name for :func:`unpack`; counted as
    ``unpack.<backend>``, once per launch."""
    return unpack(words, width, n, dtype)


def fused_aggregate(srv_codes, srv_s, srv_b, cl_codes, cl_s, cl_b, weights, lr: float,
                    fmt: FloatFormat, batch_axes: int = 0, pvt: bool = True):
    """Compressed-domain server round for one variable (``repro.kernels.ops``'s
    ``fused_aggregate``): ``(new_codes, s, b)`` in storage form, ``(s, b)``
    solved from the kernel's masked PVT sums with the closed form, shaped
    ``[*stack, 1, ...]`` for ``batch_axes > 0`` and 0-d otherwise; with
    ``pvt=False``, ``(codes, 1, 0)``."""
    if _on_cuda("fused_aggregate", srv_codes, cl_codes):
        codes, sums = _agg.fused_aggregate(srv_codes, srv_s, srv_b, cl_codes, cl_s, cl_b,
                                           weights, lr, fmt, batch_axes=batch_axes)
        _LAUNCHES["fused_aggregate.cuda"] += 1
    else:
        codes, sums = ref.ref_fused_aggregate(srv_codes, srv_s, srv_b, cl_codes, cl_s, cl_b,
                                              weights, lr, fmt, batch_axes=batch_axes)
        _LAUNCHES["fused_aggregate.ref"] += 1
    dev = srv_codes.device
    if not pvt:
        return codes, torch.ones((), device=dev), torch.zeros((), device=dev)
    shape = tuple(srv_codes.shape)
    s, b = pvt_from_sums(sums, srv_codes.numel() // sums.shape[0])
    bshape = shape[:batch_axes] + (1,) * (len(shape) - batch_axes) if batch_axes else ()
    return codes, s.reshape(bshape), b.reshape(bshape)
