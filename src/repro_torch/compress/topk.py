"""Magnitude top-k sparsification (port of ``repro.compress.topk``; Konečný
et al., arxiv 1610.05492).

Each selected variable travels as the ``k = max(1, round(density·n))``
entries of largest magnitude: sorted positions plus their values, raw f32
or quantized to a minifloat ``value_fmt`` and bit-packed.  The receiver
scatters into zeros.  The wire size is ``4·k`` index bytes plus the value
bytes, known from the shape.

The selection runs where the tensor lies.  Ties at the threshold go to the
lowest positions: a stable descending sort of the magnitudes, whose first k
positions are then sorted.  The reference leaves that choice to numpy's
``argpartition``, so the two agree bit for bit wherever no tie crosses the
threshold (ROADMAP C17).  Positions are int64 on the device and narrow to
uint32 only on the wire (the codec).  A minifloat ``value_fmt`` writes its
codes with ``quantize`` (B3) and packs them with ``pack`` (B4) on a CUDA
tensor; the decode unpacks with ``unpack`` (B4) and decodes with the plain
``formats.decode``, which keeps the sign of a zero (B2's affine would turn
``-0·1 + 0`` into ``+0``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from repro_torch.core import packing
from repro_torch.core.formats import FP32, FloatFormat, decode, value_quantize

from .base import CompressionStrategy, StrategyLeaf, register_strategy


def num_kept(n: int, density: float) -> int:
    """k for an n-element variable: shared by encode, qdq and the plan."""
    return max(1, min(n, int(round(n * float(density)))))


def top_positions(flat: torch.Tensor, k: int) -> torch.Tensor:
    """Sorted int64 positions of the k largest magnitudes of ``flat``, ties at
    the threshold broken by lowest position."""
    order = torch.sort(flat.abs(), descending=True, stable=True).indices
    return torch.sort(order[:k]).values


def threshold_mask(flat: torch.Tensor, k: int) -> torch.Tensor:
    """The qdq views' rule: ``|v| >= sort(|v|)[n - k]`` (ties keep extra
    entries, as the reference's elementwise mask does).  The threshold is
    the smallest of the k largest magnitudes, NaN ordered last as ``sort``
    orders it, without sorting all n.  A 2-D ``flat`` holds one variable a
    row, each with its own threshold."""
    mag = flat.abs()
    return mag >= torch.topk(mag, k, dim=-1).values[..., -1:]


def client_rows(v: torch.Tensor, client_axis: bool) -> torch.Tensor:
    """``v`` flattened: one row per client with ``client_axis``, else 1-D."""
    return v.reshape(v.shape[0], -1) if client_axis else v.reshape(-1)


def scatter_dense(idx: torch.Tensor, vals: torch.Tensor, shape) -> torch.Tensor:
    out = torch.zeros((math.prod(shape),), dtype=torch.float32, device=vals.device)
    out[idx] = vals
    return out.reshape(shape)


@dataclasses.dataclass
class TopKSparseVariable(StrategyLeaf):
    """One variable as (sorted positions, surviving values)."""

    idx: torch.Tensor  # int64[k], sorted ascending
    values: torch.Tensor  # f32[k] (identity value_fmt) or packed uint32 words
    shape: Tuple[int, ...]
    value_fmt: FloatFormat

    kind = "topk"

    @property
    def k(self) -> int:
        return self.idx.numel()

    def dequantize(self) -> torch.Tensor:
        if self.value_fmt.is_identity:
            vals = self.values
        else:
            codes = packing.unpack(self.values, self.value_fmt.bits, self.k,
                                   self.value_fmt.container_dtype)
            vals = decode(codes, self.value_fmt)
        return scatter_dense(self.idx.to(vals.device), vals, self.shape)

    def wire_body_bytes(self) -> int:
        return self.index_bytes() + self._value_bytes()

    def _value_bytes(self) -> int:
        if self.value_fmt.is_identity:
            return 4 * self.k
        return packing.packed_bytes(self.k, self.value_fmt)

    def index_bytes(self) -> int:
        return 4 * self.k


@register_strategy
@dataclasses.dataclass(frozen=True)
class TopKSparseStrategy(CompressionStrategy):
    """Keep the ``density`` fraction of largest-magnitude entries."""

    density: float = 0.1
    value_fmt: FloatFormat = FP32  # identity: raw f32 values on the wire
    #: carry the dropped coordinates in a per-client residual (training
    #: paths only; the wire format is unaffected)
    error_feedback: bool = True

    name = "topk"
    wire_version = 1
    delta_rule = None  # full only: the support moves every send
    upload_only = True  # sparse codes compress the client->server direction

    def __post_init__(self):
        if not (0.0 < self.density <= 1.0):
            raise ValueError(f"density must be in (0, 1], got {self.density}")

    @property
    def label(self) -> str:
        tag = f"topk-{self.density:g}"
        return tag if self.value_fmt.is_identity else f"{tag}-{self.value_fmt.name.lower()}"

    def encode_leaf(self, v, *, batch_axes: int = 0) -> TopKSparseVariable:
        flat = v.detach().to(torch.float32).reshape(-1)
        idx = top_positions(flat, num_kept(flat.numel(), self.density))
        vals = flat[idx]
        if not self.value_fmt.is_identity:
            from repro_torch.kernels import ops  # deferred: kernels imports core

            codes = ops.quantize(vals, self.value_fmt)
            vals = packing.pack(codes, self.value_fmt.bits)
        return TopKSparseVariable(idx, vals, tuple(v.shape), self.value_fmt)

    def decode_leaf(self, leaf: TopKSparseVariable) -> torch.Tensor:
        return leaf.dequantize()

    def qdq_leaf(self, v, *, batch_axes: int = 0, client_axis: bool = False) -> torch.Tensor:
        flat = client_rows(v, client_axis)
        keep = threshold_mask(flat, num_kept(flat.shape[-1], self.density))
        kept = torch.where(keep, flat, torch.zeros((), dtype=flat.dtype, device=flat.device))
        if not self.value_fmt.is_identity:
            kept = value_quantize(kept, self.value_fmt)
        return kept.reshape(v.shape)

    def leaf_wire_bytes(self, leaf: TopKSparseVariable) -> int:
        return leaf.wire_body_bytes()

    def plan_wire_bytes(self, n_elems: int, stack_entries: int) -> int:
        k = num_kept(n_elems, self.density)
        vb = 4 * k if self.value_fmt.is_identity else packing.packed_bytes(k, self.value_fmt)
        return 4 * k + vb

    def describe(self):
        d = super().describe()
        d.update(density=self.density, value_fmt=self.value_fmt.name)
        return d
