"""Dispatch for the port's kernels, with launch counters.

Counterpart of ``repro.kernels.ops``.  Dispatch is on the tensors' device:

  * CUDA tensors go to the hand-written Hopper kernels (``quantize``,
    ``bitpack``, ``agg``, ``dequant_matmul``), which launch or raise;
  * CPU tensors go to the plain versions (``ref``).

There is no fallback: no switch sends a CUDA tensor to a plain version.
Every call bumps a counter keyed ``"<op>.cuda"`` or ``"<op>.ref"`` after
its launch returns, so a run can show that its path went through the
kernels (:func:`launch_counts`, :func:`reset_launch_counts`).

Meta tensors (shapes without data: the dry-run, ``launch/dryrun.py``) run
neither: a wrapper makes empty outputs of the kernel's shapes and dtypes,
counts ``"<op>.meta"``, and reports the call, its input and output tensors
and its FLOPs (``2·M·K·N`` for ``dequant_matmul``, 0 for the elementwise
kernels, as ``torch.utils.flop_counter`` counts) to the listeners of
:func:`meta_listener`.

The reference's public names are here too, over the same counter and the
same functions: :func:`dispatch_counts`, :func:`reset_dispatch_counts`,
:func:`pack_bits` and :func:`unpack_bits`.  The counting rule differs from
the reference's: it counts once per traced specialization (its wrappers are
jitted), the port counts once per launch (per call), eager as it is.
"""

from __future__ import annotations

import contextlib
import math
from collections import Counter
from typing import Callable, Dict, Optional, Sequence

import torch

from repro_torch.core.formats import FloatFormat
from repro_torch.core.packing import packed_words
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


_META_LISTENERS: list = []


@contextlib.contextmanager
def meta_listener(fn: Callable[[str, Sequence[torch.Tensor], Sequence[torch.Tensor], int], None]):
    """Within the block, ``fn(op, inputs, outputs, flops)`` hears every
    wrapper call on meta tensors."""
    _META_LISTENERS.append(fn)
    try:
        yield
    finally:
        _META_LISTENERS.remove(fn)


def _device(op: str, *tensors: Optional[torch.Tensor]) -> str:
    kinds = {t.device.type for t in tensors if t is not None}
    if len(kinds) == 1 and kinds <= {"cuda", "cpu", "meta"}:
        return kinds.pop()
    raise ValueError(f"{op}: tensors on {sorted(kinds)}; expected all on CUDA or all on the CPU "
                     f"(or all on meta, shapes only)")


def _meta(op: str, inputs, outputs, flops: int = 0):
    """Count and report one call on meta tensors; returns ``outputs``."""
    _LAUNCHES[f"{op}.meta"] += 1
    outs = outputs if isinstance(outputs, tuple) else (outputs,)
    for fn in _META_LISTENERS:
        fn(op, [t for t in inputs if t is not None], outs, flops)
    return outputs


def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def quantize(x: torch.Tensor, fmt: FloatFormat) -> torch.Tensor:
    """f32 -> codes only (the encode half of :func:`quantize_stats`)."""
    dev = _device("quantize", x)
    if dev == "meta":
        return _meta("quantize", (x,), _empty(x.shape, fmt.container_dtype))
    if dev == "cuda":
        out = _q.quantize(x, fmt)
        _LAUNCHES["quantize.cuda"] += 1
    else:
        out = ref.ref_quantize(x, fmt)
        _LAUNCHES["quantize.ref"] += 1
    return out


def dequantize(codes: torch.Tensor, fmt: FloatFormat, s: Optional[torch.Tensor] = None,
               b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """codes -> f32 with the PVT affine ``decode(codes)·s + b`` fused."""
    dev = _device("dequantize", codes, s, b)
    if dev == "meta":
        return _meta("dequantize", (codes, s, b), _empty(codes.shape, torch.float32))
    if dev == "cuda":
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
    dev = _device("dequant_matmul", a, codes, s, b)
    if dev == "meta":
        _dm.check_inputs(a, codes, fmt, s, b)
        (m, k), n = a.shape, codes.shape[1]
        return _meta("dequant_matmul", (a, codes, s, b), _empty((m, n), torch.float32),
                     2 * m * k * n)
    if dev == "cuda":
        out = _dm.dequant_matmul(a, codes, fmt, s, b)
        _LAUNCHES["dequant_matmul.cuda"] += 1
    else:
        _dm.check_inputs(a, codes, fmt, s, b)
        out = ref.ref_dequant_matmul(a, codes, fmt, s, b)
        _LAUNCHES["dequant_matmul.ref"] += 1
    return out


def quantize_stats(x: torch.Tensor, fmt: FloatFormat, batch_axes: int = 0):
    """(codes, sums[..., 4]) — fused quantize + PVT statistics per entry."""
    dev = _device("quantize_stats", x)
    if dev == "meta":
        return _meta("quantize_stats", (x,), (_empty(x.shape, fmt.container_dtype),
                                              _empty(tuple(x.shape[:batch_axes]) + (4,),
                                                     torch.float32)))
    if dev == "cuda":
        out = _q.quantize_stats(x, fmt, batch_axes)
        _LAUNCHES["quantize_stats.cuda"] += 1
    else:
        out = ref.ref_quantize_stats(x, fmt, batch_axes)
        _LAUNCHES["quantize_stats.ref"] += 1
    return out


def pack(codes: torch.Tensor, width: int) -> torch.Tensor:
    """codes (values < 2**width) -> exact uint32 bitstream (wire form)."""
    dev = _device("pack", codes)
    if dev == "meta":
        return _meta("pack", (codes,), _empty((packed_words(codes.numel(), width),),
                                              torch.uint32))
    if dev == "cuda":
        out = _bp.pack(codes, width)
        _LAUNCHES["pack.cuda"] += 1
    else:
        out = ref.ref_pack(codes, width)
        _LAUNCHES["pack.ref"] += 1
    return out


def unpack(words: torch.Tensor, width: int, n: int,
           dtype: torch.dtype = torch.uint32) -> torch.Tensor:
    """Inverse of :func:`pack`: recover ``n`` codes as ``dtype``."""
    dev = _device("unpack", words)
    if dev == "meta":
        return _meta("unpack", (words,), _empty((n,), dtype))
    if dev == "cuda":
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
    dev = _device("fused_aggregate", srv_codes, cl_codes)
    if dev == "meta":
        entries = math.prod(srv_codes.shape[:batch_axes])
        codes, sums = _meta("fused_aggregate",
                            (srv_codes, srv_s, srv_b, cl_codes, cl_s, cl_b, weights),
                            (_empty(srv_codes.shape, srv_codes.dtype),
                             _empty((entries, 4), torch.float32)))
    elif dev == "cuda":
        codes, sums = _agg.fused_aggregate(srv_codes, srv_s, srv_b, cl_codes, cl_s, cl_b,
                                           weights, lr, fmt, batch_axes=batch_axes)
        _LAUNCHES["fused_aggregate.cuda"] += 1
    else:
        codes, sums = ref.ref_fused_aggregate(srv_codes, srv_s, srv_b, cl_codes, cl_s, cl_b,
                                              weights, lr, fmt, batch_axes=batch_axes)
        _LAUNCHES["fused_aggregate.ref"] += 1
    if not pvt:
        device = srv_codes.device
        return codes, torch.ones((), device=device), torch.zeros((), device=device)
    shape = tuple(srv_codes.shape)
    s, b = pvt_from_sums(sums, srv_codes.numel() // sums.shape[0])
    bshape = shape[:batch_axes] + (1,) * (len(shape) - batch_axes) if batch_axes else ()
    return codes, s.reshape(bshape), b.reshape(bshape)
