"""CUDA kernels for Hopper: OMC quantize, dequantize and fused quantize + PVT statistics.

Wrappers over ``csrc/quantize.cu`` (see its header for the design and the
byte bounds).  Each wrapper checks device, dtype, contiguity and shape,
allocates its outputs with ``torch.empty``, launches on the current stream
and raises on a CUDA error.  They take CUDA tensors only; ``ops`` sends CPU
tensors to the plain versions in ``ref``.  :func:`kernel_variant` states
how ``dequantize`` decodes a format (``dequantize_variant`` in the source,
which decides; :func:`dequantize_plan` reports the launch it makes, and the
tests on the card hold the two against each other).

Replaces the Pallas kernels ``repro/kernels/quantize.py::quantize``,
``::dequantize`` and ``::quantize_stats``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.formats import FloatFormat

from . import build

DECODE_RUNTIME = 0  # decode.cuh's branch-free decode, the format read at run time
DECODE_S1E3M7 = 1  # served and trained format compiled in: two u16 codes a word
DECODE_S1E4M14 = 2  # the training driver's format compiled in (u32)


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _entries(s: Optional[torch.Tensor], codes: torch.Tensor) -> int:
    """How many stacked entries ``s`` gives (s, b) for: 1 for one value, L for
    the ``[L, 1, ...]`` scalars of a leaf stacked on its leading axes."""
    if s is None or s.numel() == 1:
        return 1
    lead = tuple(s.shape)
    while lead and lead[-1] == 1:
        lead = lead[:-1]
    if s.ndim != codes.ndim or tuple(codes.shape[:len(lead)]) != lead:
        raise ValueError(f"PVT scalars of shape {tuple(s.shape)} do not stack codes of shape "
                         f"{tuple(codes.shape)}")
    return s.numel()


def _scalars(v: Optional[torch.Tensor], default: float, name: str, entries: int,
             device: torch.device) -> torch.Tensor:
    if v is None:
        return torch.full((entries,), default, dtype=torch.float32, device=device)
    _require(v, name, torch.float32, device)
    if v.numel() != entries:
        raise ValueError(f"{name} holds {v.numel()} values, expected {entries}")
    return v


def quantize(x: torch.Tensor, fmt: FloatFormat) -> torch.Tensor:
    """f32 -> codes (round to nearest even, subnormal-aware, saturating, NaN kept)."""
    if x.device.type != "cuda":
        raise ValueError(f"quantize kernel needs a CUDA tensor, got {x.device}")
    dev = x.device
    _require(x, "x", torch.float32, dev)
    codes = torch.empty(x.shape, dtype=fmt.container_dtype, device=dev)
    lib = build.load_library()
    rc = lib.omc_quantize(x.data_ptr(), codes.data_ptr(), fmt.container_bytes_per_value,
                          x.numel(), fmt.exp_bits, fmt.mant_bits, _stream(dev))
    build.check(rc, "quantize")
    return codes


def kernel_variant(fmt: FloatFormat) -> int:
    """How ``dequantize`` decodes ``fmt``: ``DECODE_S1E3M7`` and
    ``DECODE_S1E4M14`` compiled in, ``DECODE_RUNTIME`` for every other
    format.  The rule of ``dequantize_variant`` in ``csrc/quantize.cu``,
    which decides."""
    compiled = {(3, 7): DECODE_S1E3M7, (4, 14): DECODE_S1E4M14}
    return compiled.get((fmt.exp_bits, fmt.mant_bits), DECODE_RUNTIME)


def dequantize_plan(codes: torch.Tensor, fmt: FloatFormat,
                    s: Optional[torch.Tensor] = None) -> Dict[str, int]:
    """The launch :func:`dequantize` makes for these arguments:
    ``{variant, vec (16-byte vectors, else one code a step), idx32 (32-bit
    indices), blocks}``, ``variant`` as :func:`kernel_variant` states it.
    The output, fresh from ``torch.empty``, is 16-byte aligned; ``codes``'
    own offset counts."""
    entries = _entries(s, codes)
    p = (ctypes.c_longlong * 4)()
    build.check(build.load_library().omc_dequantize_plan(
        codes.data_ptr(), 0, codes.numel() // entries, entries, fmt.container_bytes_per_value,
        fmt.exp_bits, fmt.mant_bits, ctypes.addressof(p)), "dequantize plan")
    return dict(variant=p[0], vec=bool(p[1]), idx32=bool(p[2]), blocks=p[3])


def dequantize(codes: torch.Tensor, fmt: FloatFormat, s: Optional[torch.Tensor] = None,
               b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """codes -> f32 ``decode(codes)·s + b`` on the card.

    ``s``, ``b``: one value each, or ``[L, 1, ...]`` (one pair per entry of
    a leaf stacked on its leading axes), as ``CompressedVariable`` holds them.
    """
    if codes.device.type != "cuda":
        raise ValueError(f"dequantize kernel needs a CUDA tensor, got {codes.device}")
    dev = codes.device
    _require(codes, "codes", fmt.container_dtype, dev)
    entries = _entries(s, codes)
    if b is not None and _entries(b, codes) != entries:
        raise ValueError("s and b must have the same shape")
    s = _scalars(s, 1.0, "s", entries, dev)
    b = _scalars(b, 0.0, "b", entries, dev)
    if not 1 <= entries <= 65535:
        raise ValueError(f"dequantize takes 1..65535 stacked entries, got {entries}")
    out = torch.empty(codes.shape, dtype=torch.float32, device=dev)
    lib = build.load_library()
    rc = lib.omc_dequantize(codes.data_ptr(), fmt.container_bytes_per_value, s.data_ptr(),
                            b.data_ptr(), out.data_ptr(), codes.numel() // entries, entries,
                            fmt.exp_bits, fmt.mant_bits, _stream(dev))
    build.check(rc, "dequantize")
    return out


def quantize_stats(x: torch.Tensor, fmt: FloatFormat,
                   batch_axes: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (codes, sums) with ``sums[..., 4] = [Σv, Σṽ, Σvṽ, Σṽ²]`` per entry.

    The leading ``batch_axes`` axes are independent entries; ``sums`` has
    shape ``x.shape[:batch_axes] + (4,)``.
    """
    if x.device.type != "cuda":
        raise ValueError(f"quantize_stats kernel needs a CUDA tensor, got {x.device}")
    dev = x.device
    _require(x, "x", torch.float32, dev)
    if not 0 <= batch_axes <= x.ndim:
        raise ValueError(f"batch_axes={batch_axes} out of range for rank {x.ndim}")
    lead = tuple(x.shape[:batch_axes])
    entries = math.prod(lead)
    n_per_entry = math.prod(x.shape[batch_axes:])
    if n_per_entry == 0 or not 1 <= entries <= 65535:
        raise ValueError(f"quantize_stats takes 1..65535 non-empty entries, got shape "
                         f"{tuple(x.shape)} with batch_axes={batch_axes}")
    lib = build.load_library()
    blocks = lib.omc_quantize_stats_blocks(n_per_entry)
    codes = torch.empty(x.shape, dtype=fmt.container_dtype, device=dev)
    partials = torch.empty((entries, blocks, 4), dtype=torch.float32, device=dev)
    sums = torch.empty((entries, 4), dtype=torch.float32, device=dev)
    rc = lib.omc_quantize_stats(x.data_ptr(), codes.data_ptr(), fmt.container_bytes_per_value,
                                partials.data_ptr(), sums.data_ptr(), n_per_entry, entries,
                                fmt.exp_bits, fmt.mant_bits, _stream(dev))
    build.check(rc, "quantize_stats")
    return codes, sums.reshape(lead + (4,))
