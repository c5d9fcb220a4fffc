"""Ternary TNT weights (port of ``repro.compress.ternary``; the TWN closed
form of "Target Non-retraining Ternary" quantization).

Each selected variable becomes ``w ≈ scale · t`` with ``t ∈ {-1, 0, +1}``:
threshold ``Δ = 0.7·mean(|v|)``, ``t = sign(v)`` where ``|v| > Δ`` else 0,
``scale`` the mean magnitude of the surviving entries; one ``(Δ, scale)`` per
stacked entry.  On the wire: codes ``{0, 1, 2}`` (for -1, 0, +1) packed at 2
bits by the codec (``pack`` / ``unpack``, B4, on a CUDA tree), plus one f32
scale per stacked entry.

The means are f32 reductions, whose order is XLA's in the reference and
PyTorch's here: Δ and the scale may differ by an ulp, and a code flips only
where |v| lies within that ulp of Δ (ROADMAP C18).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from repro_torch.core import packing

from .base import CompressionStrategy, StrategyLeaf, register_strategy

TERNARY_BITS = 2


def ternarize(v: torch.Tensor, batch_axes: int = 0, threshold_factor: float = 0.7):
    """(t, scale): t ∈ {-1, 0, +1} shaped like v, scale per stacked entry.
    Backs both the wire encode and the training qdq view."""
    v = v.to(torch.float32)
    axes = tuple(range(batch_axes, v.ndim))
    mag = v.abs()
    zero = torch.zeros((), dtype=torch.float32, device=v.device)
    if axes:
        delta = threshold_factor * mag.mean(dim=axes, keepdim=True)
        mask = mag > delta
        kept = torch.where(mask, mag, zero).sum(dim=axes, keepdim=True)
        count = mask.sum(dim=axes, keepdim=True).to(torch.float32)
    else:  # every axis stacked: each entry is its own variable
        mask = mag > threshold_factor * mag
        kept, count = torch.where(mask, mag, zero), mask.to(torch.float32)
    scale = kept / torch.clamp(count, min=1.0)
    t = torch.where(mask, torch.sign(v), zero)
    return t, scale.reshape(v.shape[:batch_axes])


@dataclasses.dataclass
class TernaryVariable(StrategyLeaf):
    """One variable as ternary codes plus a scale per stacked entry."""

    codes: torch.Tensor  # uint8, the variable's shape, values in {0, 1, 2}
    scale: torch.Tensor  # f32, the leading batch axes of the codes
    shape: Tuple[int, ...]

    kind = "ternary"

    def dequantize(self) -> torch.Tensor:
        t = self.codes.to(torch.float32) - 1.0
        bshape = tuple(self.scale.shape) + (1,) * (len(self.shape) - self.scale.ndim)
        return t * self.scale.reshape(bshape)

    def wire_body_bytes(self) -> int:
        return packing.packed_bytes_width(math.prod(self.shape), TERNARY_BITS) + self.meta_bytes()

    def meta_bytes(self) -> int:
        return 4 * self.scale.numel()


@register_strategy
@dataclasses.dataclass(frozen=True)
class TernaryTNTStrategy(CompressionStrategy):
    """TNT/TWN ternary weights: 2-bit codes plus one scale per stacked entry."""

    threshold_factor: float = 0.7  # the TWN Δ = 0.7·E|v| rule
    #: accumulate the ternarization error in a per-client residual
    error_feedback: bool = True

    name = "ternary"
    wire_version = 1
    delta_rule = None
    upload_only = True  # a ternarized download would destroy the model

    @property
    def label(self) -> str:
        return "ternary-tnt"

    def encode_leaf(self, v, *, batch_axes: int = 0) -> TernaryVariable:
        t, scale = ternarize(v.detach(), batch_axes, self.threshold_factor)
        return TernaryVariable((t + 1.0).to(torch.uint8), scale, tuple(v.shape))

    def decode_leaf(self, leaf: TernaryVariable) -> torch.Tensor:
        return leaf.dequantize()

    def qdq_leaf(self, v, *, batch_axes: int = 0, client_axis: bool = False) -> torch.Tensor:
        # a scale per stacked entry: the client axis is one of batch_axes
        t, scale = ternarize(v, batch_axes, self.threshold_factor)
        return t * scale.reshape(tuple(scale.shape) + (1,) * (t.ndim - scale.ndim))

    def leaf_wire_bytes(self, leaf: TernaryVariable) -> int:
        return leaf.wire_body_bytes()

    def plan_wire_bytes(self, n_elems: int, stack_entries: int) -> int:
        return packing.packed_bytes_width(n_elems, TERNARY_BITS) + 4 * stack_entries

    def describe(self):
        d = super().describe()
        d.update(threshold_factor=self.threshold_factor)
        return d
