"""Dispatch for the port's kernels, with launch counters.

Counterpart of ``repro.kernels.ops``.  Dispatch is on the tensors' device:

  * CUDA tensors go to the hand-written Hopper kernels (``quantize``,
    ``bitpack``), which launch or raise;
  * CPU tensors go to the plain versions (``ref``).

There is no fallback: no switch sends a CUDA tensor to a plain version.
Every call bumps a counter keyed ``"<op>.cuda"`` or ``"<op>.ref"`` after
its launch returns, so a run can show that its path went through the
kernels (:func:`launch_counts`, :func:`reset_launch_counts`).
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Optional

import torch

from repro_torch.core.formats import FloatFormat

from . import bitpack as _bp
from . import quantize as _q
from . import ref

_LAUNCHES: Counter = Counter()


def launch_counts() -> Dict[str, int]:
    """``{"<op>.<backend>": calls}`` accumulated since import or reset."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES.clear()


def _on_cuda(op: str, *tensors: Optional[torch.Tensor]) -> bool:
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"{op}: tensors on {sorted(kinds)}; expected all on CUDA or all on the CPU")


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
