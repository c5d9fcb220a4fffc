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
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.core.formats import FloatFormat

from . import build
from .quantize import _require, _stream


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
    entries, m = lay.srv.shape
    c = lay.cl.shape[0]
    for name in ("srv", "cl"):
        _require(getattr(lay, name), name, fmt.container_dtype, dev)
    for name in ("srv_s", "srv_b", "cl_s", "cl_b", "w"):
        _require(getattr(lay, name), name, torch.float32, dev)
    if m == 0 or not 1 <= entries <= 65535 or not 1 <= c <= 4096:
        raise ValueError(f"fused_aggregate takes 1..65535 non-empty entries and 1..4096 "
                         f"clients, got {entries} x {m} and {c}")
    lib = build.load_library()
    blocks = lib.omc_fused_aggregate_blocks(m, entries)
    out = torch.empty(srv_codes.shape, dtype=fmt.container_dtype, device=dev)
    partials = torch.empty((entries, blocks, 4), dtype=torch.float32, device=dev)
    sums = torch.empty((entries, 4), dtype=torch.float32, device=dev)
    rc = lib.omc_fused_aggregate(
        lay.srv.data_ptr(), lay.srv_s.data_ptr(), lay.srv_b.data_ptr(), lay.cl.data_ptr(),
        lay.cl_s.data_ptr(), lay.cl_b.data_ptr(), lay.w.data_ptr(), c, float(lr),
        out.data_ptr(), fmt.container_bytes_per_value, partials.data_ptr(), sums.data_ptr(),
        m, entries, fmt.exp_bits, fmt.mant_bits, _stream(dev))
    build.check(rc, "fused_aggregate")
    return out, sums


def fused_aggregate_moved_bytes(cohort: int, n: int, fmt: FloatFormat, *,
                                stack_entries: int = 1) -> int:
    """Device-memory bytes the fused pass must move: C client planes and the
    server plane read once, the new plane written once, the PVT scalars,
    weights and lr, and the ``[entries, 4]`` sums.  No tile padding."""
    sb = stack_entries
    codes = (cohort + 2) * n * fmt.container_bytes_per_value
    scalars = 4 * (2 * sb + 2 * cohort * sb + cohort + 1)
    return codes + scalars + 4 * sb * 4
