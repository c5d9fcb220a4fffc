"""Compressed parameter storage (paper Fig. 1), port of ``repro.core.store``.

``CompressedVariable`` holds one variable in OMC storage form: the minifloat
bitfield codes in the smallest uint container (the resident form on the
device), plus the per-variable transformation scalars ``s, b`` — 0-d for a
single variable, ``[L, 1, ...]`` for a stack of L independent entries.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from .formats import SIGNED_TWIN, FloatFormat
from .pvt import pvt_from_sums
from .tree import tree_items, tree_map


@dataclasses.dataclass
class CompressedVariable:
    """One variable in OMC storage form."""

    codes: torch.Tensor  # uint container, original shape
    s: torch.Tensor  # f32 PVT scale: 0-d, or [L, 1, ...] for stacked entries
    b: torch.Tensor  # f32 PVT bias, same shape as s
    fmt: FloatFormat

    @property
    def size(self) -> int:
        return self.codes.numel()

    @property
    def device(self) -> torch.device:
        return self.codes.device

    def __getitem__(self, index) -> "CompressedVariable":
        """Index the stacked leading axis (codes, s and b together)."""
        if self.s.ndim == 0:
            raise IndexError("a single (unstacked) variable has no entry axis")
        return CompressedVariable(self.codes[index], self.s[index], self.b[index], self.fmt)

    def rows(self, index: torch.Tensor) -> "CompressedVariable":
        """Gather rows of a single variable; decode and affine are elementwise
        with scalar (s, b), so decoding the gathered rows equals gathering the
        decoded table, bit for bit."""
        if self.s.ndim != 0:
            raise ValueError("rows() needs a single variable with scalar (s, b)")
        # gather through the signed twin: indexing kernels cover every signed dtype
        twin = SIGNED_TWIN.get(self.codes.dtype, self.codes.dtype)
        codes = self.codes.view(twin)[index].view(self.codes.dtype)
        return CompressedVariable(codes, self.s, self.b, self.fmt)

    def to(self, device) -> "CompressedVariable":
        return CompressedVariable(self.codes.to(device), self.s.to(device),
                                  self.b.to(device), self.fmt)

    def dequantize(self) -> torch.Tensor:
        from repro_torch.kernels import ops  # deferred: kernels imports core

        return ops.dequantize(self.codes, self.fmt, self.s, self.b)


def compress_variable(
    v: torch.Tensor, fmt: FloatFormat, *, pvt: bool = True, batch_axes: int = 0,
) -> CompressedVariable:
    """Quantize one variable to OMC storage form in one fused pass.

    ``batch_axes > 0`` treats the leading axes as stacked independent
    variables: (s, b) are solved per entry.  With ``pvt`` the codes and the
    four PVT sums come from one ``quantize_stats`` launch and (s, b) from the
    closed form on those plain f32 sums — the reference's ``fast=True``
    solver, which its ``compress_params`` and transport use.  Without it the
    ``quantize`` kernel writes the codes alone and (s, b) = (1, 0).
    """
    from repro_torch.kernels import ops  # deferred: kernels imports core

    lead = tuple(v.shape[:batch_axes])
    if pvt:
        codes, sums = ops.quantize_stats(v, fmt, batch_axes)
        s, b = pvt_from_sums(sums, math.prod(v.shape[batch_axes:]))
    else:
        codes = ops.quantize(v, fmt)
        s = torch.ones(lead, dtype=torch.float32, device=v.device)
        b = torch.zeros(lead, dtype=torch.float32, device=v.device)
    shape = lead + (1,) * (v.ndim - batch_axes) if batch_axes else ()
    return CompressedVariable(codes, s.reshape(shape), b.reshape(shape), fmt)


def is_compressed(x: Any) -> bool:
    return isinstance(x, CompressedVariable)


def decompress_tree(ctree):
    return tree_map(lambda x: x.dequantize() if is_compressed(x) else x, ctree)


def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same dtype, shape and bits (NaN payloads and signed zeros included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    twin = {**SIGNED_TWIN, torch.float32: torch.int32}.get(a.dtype, a.dtype)
    return torch.equal(a.view(twin), b.view(twin).to(a.device))


def trees_bit_equal(a, b) -> bool:
    """Same paths and formats, and every tensor (codes, s, b, raw leaves)
    equal bit for bit."""
    la, lb = list(tree_items(a)), list(tree_items(b))
    if [p for p, _ in la] != [p for p, _ in lb]:
        return False
    for (_, x), (_, y) in zip(la, lb):
        if is_compressed(x) != is_compressed(y):
            return False
        if is_compressed(x):
            if x.fmt != y.fmt or not all(bit_equal(u, v) for u, v in
                                         ((x.codes, y.codes), (x.s, y.s), (x.b, y.b))):
                return False
        elif not bit_equal(x, y):
            return False
    return True
