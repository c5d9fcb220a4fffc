"""CUDA kernel for Hopper: fused compressed-domain cohort aggregation.

Wrapper over ``csrc/agg.cu`` (see its header for the design and the byte
bound).  Replaces the Pallas kernel ``repro/kernels/agg.py::fused_aggregate``.

:func:`layout` flattens one variable's arguments to the kernel's form —
``[entries, m]`` server codes, ``[C, entries, m]`` client codes, per-entry
and per-(client, entry) PVT scalars, ``[C]`` weights — the same for the
kernel and its plain version (``ref.ref_fused_aggregate``).  Both return
``(codes, sums)``: the new codes in the server leaf's shape and the masked
PVT sums ``[entries, 4]``; ``ops.fused_aggregate`` solves ``(s, b)`` from
the sums.

One launch per call: the kernel sums each entry's per-block partials
itself, in a fixed order, counting finished blocks on a per-entry ticket
that it leaves at zero; the tickets live in one zeroed buffer per device
and stream, made at first use (:func:`_tickets`).  :func:`kernel_variant`
states the kernel's choice of how it decodes client codes, which the C
entry makes from the format and the cohort size (``variant`` in the
source; :func:`plan` reports it, and the tests on the card hold the two
against each other).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.formats import FloatFormat

from . import build
from .quantize import _require, _stream

MAX_ENTRIES = 65535
MAX_CLIENTS = 4096
DECODE_RUNTIME = 0  # decode.cuh's branch-free decode, the format read at run time
DECODE_S1E3M7 = 1  # the trained format compiled in: pair decode, constant server half
TABLE = 2  # per-client tables of weighted values in shared memory
TABLE_MAX_BITS = 12
TABLE_BYTES = 96 * 1024  # all of a block's tables


class Layout(NamedTuple):
    srv: torch.Tensor  # [entries, m] codes
    srv_s: torch.Tensor  # [entries] f32
    srv_b: torch.Tensor  # [entries] f32
    cl: torch.Tensor  # [C, entries, m] codes
    cl_s: torch.Tensor  # [C, entries] f32
    cl_b: torch.Tensor  # [C, entries] f32
    w: torch.Tensor  # [C] f32


def _col(x, entries: int, device) -> torch.Tensor:
    """PVT scalar (one value, or one per stacked entry) -> [entries] f32."""
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    if x.numel() == entries:
        return x.reshape(entries).contiguous()
    return x.reshape(()).expand(entries).contiguous()


def _ccol(x, c: int, entries: int, device) -> torch.Tensor:
    """Per-client PVT scalar (one per client, or per (client, entry)) -> [C, entries]."""
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    if x.numel() == c * entries:
        return x.reshape(c, entries).contiguous()
    return x.reshape(c, 1).expand(c, entries).contiguous()


def layout(srv_codes, srv_s, srv_b, cl_codes, cl_s, cl_b, weights, batch_axes: int) -> Layout:
    shape = tuple(srv_codes.shape)
    entries = math.prod(shape[:batch_axes])
    m = srv_codes.numel() // entries
    c = cl_codes.shape[0]
    if tuple(cl_codes.shape[1:]) != shape:
        raise ValueError(f"client codes {tuple(cl_codes.shape)} do not stack the server "
                         f"leaf {shape}")
    dev = srv_codes.device
    return Layout(srv_codes.reshape(entries, m), _col(srv_s, entries, dev),
                  _col(srv_b, entries, dev), cl_codes.reshape(c, entries, m),
                  _ccol(cl_s, c, entries, dev), _ccol(cl_b, c, entries, dev),
                  torch.as_tensor(weights, dtype=torch.float32, device=dev).reshape(c).contiguous())


def kernel_variant(fmt: FloatFormat, clients: int) -> int:
    """How the kernel decodes client codes for ``fmt`` at a cohort of
    ``clients``: ``DECODE_S1E3M7`` for the trained format (compiled in),
    ``TABLE`` for formats of at most ``TABLE_MAX_BITS`` bits whose tables,
    one float a code and client, fit in ``TABLE_BYTES``, else
    ``DECODE_RUNTIME``.  The rule of ``variant`` in ``csrc/agg.cu``, which
    decides."""
    if not 1 <= clients <= MAX_CLIENTS:
        raise ValueError(f"fused_aggregate takes 1..{MAX_CLIENTS} clients, got {clients}")
    if (fmt.exp_bits, fmt.mant_bits) == (3, 7):
        return DECODE_S1E3M7
    if fmt.bits <= TABLE_MAX_BITS and (clients << fmt.bits) * 4 <= TABLE_BYTES:
        return TABLE
    return DECODE_RUNTIME


def _check(lay: Layout, fmt: FloatFormat) -> None:
    entries, m = lay.srv.shape
    c = lay.cl.shape[0]
    dev = lay.srv.device
    for name in ("srv", "cl"):
        _require(getattr(lay, name), name, fmt.container_dtype, dev)
    for name in ("srv_s", "srv_b", "cl_s", "cl_b", "w"):
        _require(getattr(lay, name), name, torch.float32, dev)
    if m == 0 or not 1 <= entries <= MAX_ENTRIES or not 1 <= c <= MAX_CLIENTS:
        raise ValueError(f"fused_aggregate takes 1..{MAX_ENTRIES} non-empty entries and "
                         f"1..{MAX_CLIENTS} clients, got {entries} x {m} and {c}")


_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


def _tickets(dev: torch.device, stream: int) -> torch.Tensor:
    """The per-entry tickets of launches on ``stream``: zeros, which every
    launch leaves at zero."""
    key = (dev.index, stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros(MAX_ENTRIES, dtype=torch.int32, device=dev)
    return _TICKETS[key]


@functools.lru_cache(maxsize=256)
def _plan_for(m: int, entries: int, clients: int, fmt: FloatFormat, srv_off: int, cl_off: int,
              out_off: int) -> Tuple[int, int, bool, int]:
    """The C entry's plan (blocks per entry, variant, vectors, shared memory).
    It reads the pointers only for their 16-byte alignment, so their offsets
    from the 16-byte grid (``ptr % 16``) stand in for them, and key the cache."""
    p = (ctypes.c_longlong * 4)()
    build.check(build.load_library().omc_fused_aggregate_plan(
        srv_off, cl_off, out_off, m, entries, clients, fmt.container_bytes_per_value,
        fmt.exp_bits, fmt.mant_bits, ctypes.addressof(p)), "fused_aggregate plan")
    return p[0], p[1], bool(p[2]), p[3]


def _plan(lay: Layout, out: torch.Tensor, fmt: FloatFormat) -> Tuple[int, int, bool, int]:
    (entries, m), c = lay.srv.shape, lay.cl.shape[0]
    return _plan_for(m, entries, c, fmt, lay.srv.data_ptr() % 16, lay.cl.data_ptr() % 16,
                     out.data_ptr() % 16)


def plan(lay: Layout, fmt: FloatFormat) -> dict:
    """The grid and variant the kernel takes for this call (on the card):
    ``{"blocks": per entry, "variant": v, "vec": 16-byte loads, "smem":
    dynamic shared memory bytes}``, ``v`` as :func:`kernel_variant` states it."""
    _check(lay, fmt)
    return dict(zip(("blocks", "variant", "vec", "smem"), _plan(lay, lay.srv, fmt)))


def fused_aggregate(srv_codes, srv_s, srv_b, cl_codes, cl_s, cl_b, weights, lr: float,
                    fmt: FloatFormat, *, batch_axes: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One variable's server round in the code domain, on the card.

    Returns ``(codes, sums)``: codes shaped like ``srv_codes`` and
    ``sums[entries, 4] = [Σnew, Σṽ, Σnew·ṽ, Σṽ²]`` per stacked entry.
    """
    if srv_codes.device.type != "cuda":
        raise ValueError(f"fused_aggregate kernel needs CUDA tensors, got {srv_codes.device}")
    dev = srv_codes.device
    lay = layout(srv_codes, srv_s, srv_b, cl_codes, cl_s, cl_b, weights, batch_axes)
    _check(lay, fmt)
    entries, m = lay.srv.shape
    out = torch.empty(srv_codes.shape, dtype=fmt.container_dtype, device=dev)
    blocks = _plan(lay, out, fmt)[0]
    scratch = torch.empty(entries * 4 * (1 + blocks), dtype=torch.float32, device=dev)
    sums, partials = scratch[:entries * 4].view(entries, 4), scratch[entries * 4:]
    stream = _stream(dev)
    rc = build.load_library().omc_fused_aggregate(
        lay.srv.data_ptr(), lay.srv_s.data_ptr(), lay.srv_b.data_ptr(), lay.cl.data_ptr(),
        lay.cl_s.data_ptr(), lay.cl_b.data_ptr(), lay.w.data_ptr(), lay.cl.shape[0], float(lr),
        out.data_ptr(), fmt.container_bytes_per_value, partials.data_ptr(), sums.data_ptr(),
        _tickets(dev, stream).data_ptr(), m, entries, fmt.exp_bits, fmt.mant_bits, stream)
    build.check(rc, "fused_aggregate")
    return out, sums


def fused_aggregate_moved_bytes(cohort: int, n: int, fmt: FloatFormat, *,
                                stack_entries: int = 1, live: Optional[int] = None) -> int:
    """Device-memory bytes the fused pass must move: the ``live`` client
    planes (all ``cohort`` by default; the kernel never reads a dead
    client's plane) and the server plane read once, the new plane written
    once, the PVT scalars, weights and lr, and the ``[entries, 4]`` sums.
    No tile padding."""
    sb = stack_entries
    planes = cohort if live is None else live
    codes = (planes + 2) * n * fmt.container_bytes_per_value
    scalars = 4 * (2 * sb + 2 * cohort * sb + cohort + 1)
    return codes + scalars + 4 * sb * 4
