"""CUDA kernels for Hopper: exact-width bitstream pack / unpack.

Wrappers over ``csrc/bitpack.cu`` (see its header for the design and the
byte bounds).  ``pack`` runs in tiles of ``TILE_FIELDS`` fields, one
superblock (32 fields, ``width`` words) a thread, with the width compiled
into one kernel of a table (u8: 1-8, u16: 1-16, u32: 1-32);
:func:`pack_plan` states the tiling.  They take CUDA tensors only; ``ops``
sends CPU tensors to the plain versions in ``core.packing``.  The stream is
the canonical one of ``repro_torch.core.packing``, bit-identical with the
plain versions.

Replaces the Pallas kernels ``repro/kernels/bitpack.py::pack`` and
``::unpack``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.packing import check_width, packed_words

from . import build

_CONTAINERS = (torch.uint8, torch.uint16, torch.uint32)
TILE_FIELDS = 8192  # 256 superblocks of 32 fields: a block of 256 threads
_GRID_X_MAX = 2**31 - 1


def _check_container(dtype: torch.dtype, width: int, name: str) -> None:
    if dtype not in _CONTAINERS:
        raise TypeError(f"{name} must be uint8/uint16/uint32, got {dtype}")
    if width > 8 * dtype.itemsize:
        raise ValueError(f"width {width} does not fit {name} of dtype {dtype}")


def pack_plan(n: int, width: int, dtype: torch.dtype) -> dict:
    """The tiling ``pack`` takes for ``n`` codes of ``width`` bits in
    ``dtype``: ``{"kernel": (container bits, width), "tile_fields",
    "tile_words" (a full tile's output, 16-byte aligned), "tiles"}``.
    Raises ``ValueError`` on a width outside 1..32 or the container, or a
    stream of more tiles than a grid holds."""
    check_width(width)
    _check_container(dtype, width, "codes")
    tiles = -(-n // TILE_FIELDS)
    if n < 0 or tiles > _GRID_X_MAX:
        raise ValueError(f"pack takes 0..{_GRID_X_MAX * TILE_FIELDS} codes, got {n}")
    return dict(kernel=(8 * dtype.itemsize, width), tile_fields=TILE_FIELDS,
                tile_words=TILE_FIELDS * width // 32, tiles=tiles)


def pack_moved_bytes(n: int, width: int, dtype: torch.dtype = torch.uint32) -> int:
    """Device-memory bytes ``pack`` moves for ``n`` codes of ``width`` bits in
    ``dtype``, counted over :func:`pack_plan`'s tiles: each full tile reads
    ``tile_fields`` codes and writes ``tile_words`` words; the last tile reads
    only the fields below ``n`` and writes only the stream's words.  So the
    total is the byte bound itself, ``n·itemsize + 4·ceil(n·width/32)``: no
    padding is read or written (the reference's u32 tiles pad both)."""
    plan = pack_plan(n, width, dtype)
    if plan["tiles"] == 0:
        return 0
    full = plan["tiles"] - 1
    last_fields = n - full * plan["tile_fields"]
    last_words = packed_words(n, width) - full * plan["tile_words"]
    return (full * (plan["tile_fields"] * dtype.itemsize + 4 * plan["tile_words"])
            + last_fields * dtype.itemsize + 4 * last_words)


def unpack_moved_bytes(n: int, width: int, dtype: torch.dtype = torch.uint32) -> int:
    """Device-memory bytes ``unpack`` moves: the stream's words read (each
    thread reads its field's word and the next, from cache), ``n`` codes of
    ``dtype`` written; the same count as :func:`pack_moved_bytes`."""
    return pack_moved_bytes(n, width, dtype)


def kernel_pack_plan(n: int, width: int, dtype: torch.dtype) -> dict:
    """:func:`pack_plan`'s numbers as the C entry computes them (on the card)."""
    p = (ctypes.c_longlong * 3)()
    build.check(build.load_library().omc_pack_plan(n, width, dtype.itemsize,
                                                   ctypes.addressof(p)), "pack plan")
    return dict(kernel=(8 * dtype.itemsize, width), tile_fields=p[0], tile_words=p[1],
                tiles=p[2])


def pack(codes: torch.Tensor, width: int) -> torch.Tensor:
    """Codes (unsigned container, values < 2**width) -> uint32 words."""
    check_width(width)
    if codes.device.type != "cuda":
        raise ValueError(f"pack kernel needs a CUDA tensor, got {codes.device}")
    n = codes.numel()
    pack_plan(n, width, codes.dtype)
    if not codes.is_contiguous():
        raise ValueError("codes must be contiguous")
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
