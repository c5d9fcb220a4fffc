"""CUDA kernels for Hopper: OMC dequantize and fused quantize + PVT statistics.

Wrappers over ``csrc/quantize.cu`` (see its header for the design and the
byte bounds).  Each wrapper checks device, dtype, contiguity and shape,
allocates its outputs with ``torch.empty``, launches on the current stream
and raises on a CUDA error.  They take CUDA tensors only; ``ops`` sends CPU
tensors to the plain versions in ``ref``.

Replaces the Pallas kernels ``repro/kernels/quantize.py::dequantize`` and
``::quantize_stats``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core.formats import FloatFormat

from . import build


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _scalar(v: Optional[torch.Tensor], default: float, name: str,
            device: torch.device) -> torch.Tensor:
    if v is None:
        return torch.full((), default, dtype=torch.float32, device=device)
    _require(v, name, torch.float32, device)
    if v.numel() != 1:
        raise ValueError(f"{name} must hold one value, got shape {tuple(v.shape)}")
    return v


def dequantize(codes: torch.Tensor, fmt: FloatFormat, s: Optional[torch.Tensor] = None,
               b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """codes -> f32 ``decode(codes)·s + b`` (s, b one-element device tensors)."""
    if codes.device.type != "cuda":
        raise ValueError(f"dequantize kernel needs a CUDA tensor, got {codes.device}")
    dev = codes.device
    _require(codes, "codes", fmt.container_dtype, dev)
    s = _scalar(s, 1.0, "s", dev)
    b = _scalar(b, 0.0, "b", dev)
    out = torch.empty(codes.shape, dtype=torch.float32, device=dev)
    lib = build.load_library()
    rc = lib.omc_dequantize(codes.data_ptr(), fmt.container_bytes_per_value, s.data_ptr(),
                            b.data_ptr(), out.data_ptr(), codes.numel(), fmt.exp_bits,
                            fmt.mant_bits, _stream(dev))
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
