"""The paper's OMC quantization as a ``CompressionStrategy`` (port of
``repro.compress.omc_quant``, DESIGN.md §11).

A thin adapter over ``repro_torch.core``: the wire leaf is the ordinary
``CompressedVariable`` and its size ``packed_bytes + 8 B·(s, b)``, so the
strategy interface costs the OMC path nothing.  On a CUDA tensor the encode
runs the kernels: ``fast=True`` (the federated storage path's solver)
launches ``quantize_stats`` (B1) through ``core.store.compress_variable``;
``fast=False`` on an unstacked leaf writes the codes with ``quantize`` (B3)
and solves (s, b) with the exact ``pvt_solve``, as the reference's
``compress_variable(fast=False)`` does; without PVT, ``quantize`` writes
the codes and (s, b) = (1, 0) as 0-d tensors.  The decode is B2
``dequantize``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import packing
from repro_torch.core.formats import FloatFormat, value_quantize
from repro_torch.core.omc import OMCConfig, qdq_pvt_leaf
from repro_torch.core.pvt import pvt_apply, pvt_solve, pvt_solve_fast, pvt_solve_rows
from repro_torch.core.store import CompressedVariable, compress_variable, is_compressed

from .base import CompressionStrategy, register_strategy

_PVT_BYTES_PER_ENTRY = 8  # s and b, f32 each: as the store, codec and accounting


@register_strategy
@dataclasses.dataclass(frozen=True)
class OMCQuantStrategy(CompressionStrategy):
    """Minifloat quantization with the per-variable transformation (paper §2).
    The delta rule on repeat sends is the codec's sparse XOR-delta."""

    fmt: FloatFormat = FloatFormat(3, 7)  # S1E3M7, the paper's 11-bit format
    pvt: bool = True
    fast: bool = True

    name = "omc"
    wire_version = 1
    delta_rule = "xor-sparse"

    @classmethod
    def parse(cls, fmt: str, **kw) -> "OMCQuantStrategy":
        return cls(fmt=FloatFormat.parse(fmt), **kw)

    @property
    def label(self) -> str:
        return f"omc-{self.fmt.name.lower()}" + ("" if self.pvt else "-nopvt")

    def encode_leaf(self, v, *, batch_axes: int = 0) -> CompressedVariable:
        from repro_torch.kernels import ops  # deferred: kernels imports core

        if self.pvt and (self.fast or batch_axes):
            return compress_variable(v, self.fmt, pvt=True, batch_axes=batch_axes)
        codes = ops.quantize(v, self.fmt)
        if self.pvt:
            s, b = pvt_solve(v, value_quantize(v, self.fmt))
        else:
            s = torch.ones((), dtype=torch.float32, device=v.device)
            b = torch.zeros((), dtype=torch.float32, device=v.device)
        return CompressedVariable(codes, s, b, self.fmt)

    def decode_leaf(self, leaf: CompressedVariable) -> torch.Tensor:
        return leaf.dequantize()

    def qdq_leaf(self, v, *, batch_axes: int = 0, client_axis: bool = False) -> torch.Tensor:
        vq = value_quantize(v, self.fmt)
        if not self.pvt:
            return vq
        if batch_axes > int(client_axis) or self.fast:
            s, b = pvt_solve_fast(v, vq, batch_axes)
        elif client_axis:
            s, b = pvt_solve_rows(v, vq)
            s, b = (t.reshape((-1,) + (1,) * (v.ndim - 1)) for t in (s, b))
        else:
            s, b = pvt_solve(v, vq)
        return pvt_apply(vq, s, b)

    def train_qdq_leaf(self, v, *, batch_axes: int = 0, client_axis: bool = False) -> torch.Tensor:
        """Exactly ``core.omc.qdq_pvt_leaf`` (the exact per-variable solve, no
        stacked-axis split): what ``simulate.client_view`` applies without a
        strategy, so training under this strategy gives the same bits."""
        return qdq_pvt_leaf(v, OMCConfig(fmt=self.fmt, pvt=self.pvt), client_axis)

    def leaf_wire_bytes(self, leaf: CompressedVariable) -> int:
        if not is_compressed(leaf):
            raise TypeError(f"expected CompressedVariable, got {type(leaf)}")
        return (packing.packed_bytes(leaf.codes.numel(), leaf.fmt)
                + _PVT_BYTES_PER_ENTRY * leaf.s.numel())

    def plan_wire_bytes(self, n_elems: int, stack_entries: int) -> int:
        sb = stack_entries if self.pvt else 1
        return packing.packed_bytes(n_elems, self.fmt) + _PVT_BYTES_PER_ENTRY * sb

    def describe(self):
        d = super().describe()
        d.update(fmt=self.fmt.name, pvt=self.pvt)
        return d
