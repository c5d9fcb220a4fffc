"""Shared model pieces: param specs, identity materializer, init, norms, RoPE.

Port of ``repro.models.common``.  Models are plain functions over nested
``dict`` parameter trees keyed like the reference's.  Per-block parameters
are stacked on a leading layer axis; where the reference scans over that
axis under remat, the port runs a Python loop and lets each layer's decoded
weights go when the next layer starts.

``ParamSpec`` keeps the reference's logical axes as plain data: the port has
no sharding, but the number of axes a spec describes is what tells stacked
axes apart (``federated.state.n_stack_axes``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Logical axes of one parameter: at rest (storage) and during compute."""

    storage: Tuple[Optional[str], ...]
    gathered: Tuple[Optional[str], ...]


def wspec(*axes: Optional[str]) -> ParamSpec:
    """Weight spec: storage as given; gathered = with 'fsdp' removed."""
    return ParamSpec(storage=tuple(axes),
                     gathered=tuple(None if a == "fsdp" else a for a in axes))


RSPEC = ParamSpec(storage=("replicated",), gathered=("replicated",))  # any rank


class Materializer:
    """Maps stored layer params -> compute weights.  This base is the
    identity (f32 params); ``federated.materialize.OMCMaterializer`` decodes
    compressed leaves."""

    def __call__(self, subtree):
        return subtree

    def leaf(self, x):
        """Materialize a single leaf."""
        return x


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               layers: Tuple[int, ...] = ()) -> torch.Tensor:
    """N(0, 1/d_in) weights of shape ``layers + (d_in, d_out)``."""
    w = torch.randn(layers + (d_in, d_out), generator=gen, device=gen.device)
    return w.mul_(1.0 / d_in ** 0.5)


def embed_init(gen: torch.Generator, vocab: int, d: int) -> torch.Tensor:
    return torch.randn((vocab, d), generator=gen, device=gen.device).mul_(0.02)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale).to(x.dtype)


def swiglu(x, w1, w3, w2):
    """LLaMA-style gated MLP: (silu(x@w1) * (x@w3)) @ w2."""
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0):
    """x: [..., S, H, hd]; positions: [..., S] (int).  Computed in f32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # [hd/2]
    ang = positions[..., None].to(torch.float32) * freqs  # [..., S, hd/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
