"""Exact-width bit packing of minifloat codes into a uint32 bitstream.

Port of ``repro.core.packing``.  On the wire OMC sends the exact
``ceil(n * bits / 32)`` words: little-endian bit order within uint32 words,
zero tail padding.  The stream is canonical (unique given the field values),
so the CUDA kernels (``kernels/csrc/bitpack.cu``) and the plain versions
(``kernels/ref.py``) emit the same words.

The public :func:`pack` / :func:`unpack` dispatch through
``repro_torch.kernels.ops``: the kernels for CUDA tensors, the plain versions
for CPU tensors.

Bit offsets are 64-bit.  The reference's jnp oracle computes them as
``arange(n, uint32) * width``, which wraps once ``n·width >= 2**32`` — e.g.
the stacked MLP weights of qwen2.5-3b hold 811,597,824 codes, 8.9e9 bits at
11 bits each.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .formats import FloatFormat


def packed_words(n: int, width: int) -> int:
    return -(-n * width // 32)


def check_width(width: int) -> None:
    if not (1 <= width <= 32):
        raise ValueError(f"width must be in [1, 32], got {width}")


def bit_offsets(index: torch.Tensor, width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Field index -> (word index, bit shift within the word), in int64."""
    offs = index.to(torch.int64) * width
    return offs >> 5, offs & 31


def pack(codes: torch.Tensor, width: int) -> torch.Tensor:
    """Pack ``codes`` (unsigned container, values < 2**width) into uint32 words."""
    check_width(width)
    from repro_torch.kernels import ops  # deferred: kernels imports this module

    return ops.pack(codes, width)


def unpack(words: torch.Tensor, width: int, n: int,
           dtype: torch.dtype = torch.uint32) -> torch.Tensor:
    """Inverse of :func:`pack`: recover ``n`` codes of ``width`` bits as ``dtype``."""
    check_width(width)
    from repro_torch.kernels import ops  # deferred: kernels imports this module

    return ops.unpack(words, width, int(n), dtype)


def packed_bytes(n: int, fmt: FloatFormat) -> int:
    """Exact wire bytes for ``n`` values of ``fmt`` (uint32-word granularity)."""
    return 4 * packed_words(n, fmt.bits)


def packed_bytes_width(n: int, width: int) -> int:
    """Exact wire bytes for ``n`` values of an arbitrary bit width (e.g. the
    2-bit ternary codes of the reference's ``compress.ternary``)."""
    return 4 * packed_words(n, width)
