"""CUDA kernels for Hopper: exact-width bitstream pack / unpack.

Wrappers over ``csrc/bitpack.cu`` (see its header for the design and the
byte bounds).  They take CUDA tensors only; ``ops`` sends CPU tensors to the
plain versions in ``core.packing``.  The stream is the canonical one of
``repro_torch.core.packing``, bit-identical with the plain versions.

Replaces the Pallas kernels ``repro/kernels/bitpack.py::pack`` and
``::unpack``.
"""

from __future__ import annotations

import torch

from repro_torch.core.packing import check_width, packed_words

from . import build

_CONTAINERS = (torch.uint8, torch.uint16, torch.uint32)


def _check_container(dtype: torch.dtype, width: int, name: str) -> None:
    if dtype not in _CONTAINERS:
        raise TypeError(f"{name} must be uint8/uint16/uint32, got {dtype}")
    if width > 8 * dtype.itemsize:
        raise ValueError(f"width {width} does not fit {name} of dtype {dtype}")


def pack(codes: torch.Tensor, width: int) -> torch.Tensor:
    """Codes (unsigned container, values < 2**width) -> uint32 words."""
    check_width(width)
    if codes.device.type != "cuda":
        raise ValueError(f"pack kernel needs a CUDA tensor, got {codes.device}")
    _check_container(codes.dtype, width, "codes")
    if not codes.is_contiguous():
        raise ValueError("codes must be contiguous")
    n = codes.numel()
    nwords = packed_words(n, width)
    words = torch.empty(nwords, dtype=torch.uint32, device=codes.device)
    lib = build.load_library()
    rc = lib.omc_pack(codes.data_ptr(), codes.dtype.itemsize, words.data_ptr(), n, nwords,
                      width, torch.cuda.current_stream(codes.device).cuda_stream)
    build.check(rc, "pack")
    return words


def unpack(words: torch.Tensor, width: int, n: int,
           dtype: torch.dtype = torch.uint32) -> torch.Tensor:
    """uint32 words -> ``n`` codes of ``width`` bits, as ``dtype``."""
    check_width(width)
    if words.device.type != "cuda":
        raise ValueError(f"unpack kernel needs a CUDA tensor, got {words.device}")
    if words.dtype != torch.uint32 or not words.is_contiguous():
        raise TypeError(f"words must be contiguous uint32, got {words.dtype}")
    _check_container(dtype, width, "the output")
    if words.numel() < packed_words(n, width):
        raise ValueError(f"{words.numel()} words cannot hold {n} fields of {width} bits")
    out = torch.empty(n, dtype=dtype, device=words.device)
    lib = build.load_library()
    rc = lib.omc_unpack(words.data_ptr(), words.numel(), out.data_ptr(), dtype.itemsize, n,
                        width, torch.cuda.current_stream(words.device).cuda_stream)
    build.check(rc, "unpack")
    return out
