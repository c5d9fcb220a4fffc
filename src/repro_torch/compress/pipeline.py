"""Stacked quantize → sparsify → entropy-code pipeline (port of
``repro.compress.pipeline``; Grativol et al., arxiv 2310.14693).

Keep the top-k magnitudes, quantize the survivors to a minifloat, then
squeeze the positions and codes with DEFLATE (``zlib``): the gaps between
sorted positions are small and the codes peaked.  On a CUDA tensor the
selection runs on the card (``topk.top_positions``, ties to the lowest
positions: ROADMAP C17), the codes come from ``quantize`` (B3) and pack with
``pack`` (B4); the delta-encoded positions and the words are then copied to
the host for ``zlib.compress``.  The blob is the reference's bit for bit
wherever no tie crosses the threshold.  The decode inflates on the host,
unpacks with ``unpack`` (B4) on the leaf's device and decodes with the plain
``formats.decode``.

DEFLATE makes the wire size depend on the data: ``plan_wire_bytes`` stays
``None``, and byte accounting measures the encoded leaf.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.core.formats import FloatFormat, decode, value_quantize

from .base import CompressionStrategy, StrategyLeaf, register_strategy
from .topk import client_rows, num_kept, scatter_dense, threshold_mask, top_positions


@dataclasses.dataclass
class PipelineVariable(StrategyLeaf):
    """One variable as a DEFLATE blob of (delta positions, packed codes);
    ``device`` is where it decodes to."""

    blob: bytes
    k: int
    shape: Tuple[int, ...]
    fmt: FloatFormat
    device: torch.device = torch.device("cpu")

    kind = "pipeline"

    def dequantize(self) -> torch.Tensor:
        raw = zlib.decompress(self.blob)
        idx_delta = np.frombuffer(raw, np.uint32, self.k)
        nwords = packing.packed_words(self.k, self.fmt.bits)
        words = np.frombuffer(raw, np.uint32, nwords, 4 * self.k).copy()
        idx = torch.from_numpy(np.cumsum(idx_delta.astype(np.int64))).to(self.device)
        codes = packing.unpack(torch.from_numpy(words).to(self.device), self.fmt.bits, self.k,
                               self.fmt.container_dtype)
        return scatter_dense(idx, decode(codes, self.fmt), self.shape)

    def wire_body_bytes(self) -> int:
        return len(self.blob)


@register_strategy
@dataclasses.dataclass(frozen=True)
class PipelineStrategy(CompressionStrategy):
    """quantize(fmt) ∘ top-k(density) ∘ DEFLATE(level)."""

    fmt: FloatFormat = FloatFormat(3, 7)  # stage 1: the paper's minifloat
    density: float = 0.1  # stage 2: magnitude top-k
    level: int = 6  # stage 3: DEFLATE effort
    #: the lossy stages are top-k and quantize: error feedback as for top-k
    error_feedback: bool = True

    name = "pipeline"
    wire_version = 1
    delta_rule = None
    upload_only = True  # sparse: compresses the client->server direction

    def __post_init__(self):
        if not (0.0 < self.density <= 1.0):
            raise ValueError(f"density must be in (0, 1], got {self.density}")
        if not (1 <= self.level <= 9):
            raise ValueError(f"level must be in [1, 9], got {self.level}")

    @classmethod
    def parse(cls, fmt: str, **kw) -> "PipelineStrategy":
        return cls(fmt=FloatFormat.parse(fmt), **kw)

    @property
    def label(self) -> str:
        return f"pipe-{self.fmt.name.lower()}-{self.density:g}"

    def encode_leaf(self, v, *, batch_axes: int = 0) -> PipelineVariable:
        from repro_torch.kernels import ops  # deferred: kernels imports core

        flat = v.detach().to(torch.float32).reshape(-1)
        k = num_kept(flat.numel(), self.density)
        idx = top_positions(flat, k)
        words = packing.pack(ops.quantize(flat[idx], self.fmt), self.fmt.bits)
        # delta-encoded sorted positions: small gaps deflate far better
        idx_delta = torch.diff(idx, prepend=idx.new_zeros(1))
        raw = (idx_delta.cpu().numpy().astype(np.uint32).tobytes()
               + words.cpu().numpy().tobytes())
        return PipelineVariable(zlib.compress(raw, self.level), k, tuple(v.shape), self.fmt,
                                v.device)

    def decode_leaf(self, leaf: PipelineVariable) -> torch.Tensor:
        return leaf.dequantize()

    def qdq_leaf(self, v, *, batch_axes: int = 0, client_axis: bool = False) -> torch.Tensor:
        # the lossy stages only: DEFLATE never changes a decoded bit
        flat = client_rows(v, client_axis)
        keep = threshold_mask(flat, num_kept(flat.shape[-1], self.density))
        kept = torch.where(keep, value_quantize(flat, self.fmt),
                           torch.zeros((), dtype=torch.float32, device=flat.device))
        return kept.reshape(v.shape)

    def leaf_wire_bytes(self, leaf: PipelineVariable) -> int:
        return leaf.wire_body_bytes()

    # plan_wire_bytes stays None: DEFLATE's output depends on the data; budget
    # with `compress.tree_wire_bytes` over an actual encode instead

    def describe(self):
        d = super().describe()
        d.update(fmt=self.fmt.name, density=self.density, level=self.level)
        return d
