"""Shared model pieces: param specs, identity materializer, init, norms, RoPE,
chunked cross-entropy and the layer loop.

Port of ``repro.models.common``.  Models are plain functions over nested
``dict`` parameter trees keyed like the reference's.  Per-block parameters
are stacked on a leading layer axis; where the reference scans over that
axis under remat, the port runs a Python loop (``scan_blocks``), each layer
under ``torch.utils.checkpoint`` when gradients are taken.

A model multiplies by a weight matrix through :func:`linear`, which takes
the weight as an f32 tensor or in code form (a ``CompressedVariable``, which
``OMCMaterializer`` leaves for the matmul operands a model names) and then
streams the codes through the ``dequant_matmul`` kernel.

``ParamSpec`` keeps the reference's logical axes as plain data: the port has
no sharding, but the number of axes a spec describes is what tells stacked
axes apart (``federated.state.n_stack_axes``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.store import is_compressed
from repro_torch.core.tree import tree_items, tree_map
from repro_torch.kernels import ops


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
    compressed leaves, but for the top-level keys named in ``operands``
    (the layer's matmul operands, which :func:`linear` takes in code form)."""

    def __call__(self, subtree, operands=()):
        return subtree

    def leaf(self, x):
        """Materialize a single leaf."""
        return x


IDENTITY_MAT = Materializer()


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               layers: Tuple[int, ...] = (), scale: float = 1.0) -> torch.Tensor:
    """N(0, scale²/d_in) weights of shape ``layers + (d_in, d_out)``."""
    w = torch.randn(layers + (d_in, d_out), generator=gen, device=gen.device)
    return w.mul_(scale / d_in ** 0.5)


def embed_init(gen: torch.Generator, vocab: int, d: int) -> torch.Tensor:
    return torch.randn((vocab, d), generator=gen, device=gen.device).mul_(0.02)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale).to(x.dtype)


def linear(x: torch.Tensor, w) -> torch.Tensor:
    """``x [..., K] @ w [K, N]``.  A weight in code form (one 2-D
    ``CompressedVariable`` entry) goes through ``ops.dequant_matmul`` with
    ``x`` flattened to a contiguous ``[M, K]``; an f32 weight is ``x @ w``."""
    if not is_compressed(w):
        return x @ w
    lead, a = x.shape[:-1], x.reshape(-1, x.shape[-1])
    if not a.is_contiguous():
        a = a.contiguous()
    out = ops.dequant_matmul(a, w.codes, w.fmt, w.s, w.b)
    return out.reshape(lead + (out.shape[-1],))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def swiglu(x, w1, w3, w2):
    """LLaMA-style gated MLP: (silu(x@w1) * (x@w3)) @ w2."""
    return linear(F.silu(linear(x, w1)) * linear(x, w3), w2)


def stack_entry(tree, i: int):
    """Entry ``i`` of every stacked leaf of a flat dict (tensor or
    ``CompressedVariable``, which indexes its codes and (s, b) together)."""
    return {k: v[i] for k, v in tree.items()}


def embed_lookup(table, tokens: torch.Tensor, mat: Materializer) -> torch.Tensor:
    """Token rows of the embedding; a compressed table decodes only those rows
    (one ``dequantize`` launch), bit for bit the rows of the decoded table."""
    flat = tokens.reshape(-1)
    rows = table.rows(flat) if is_compressed(table) else table[flat]
    return mat.leaf(rows).reshape(tokens.shape + (-1,))


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


def layer_norm(x: torch.Tensor, scale, bias, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis, population variance (``jnp.var``)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def group_norm(x: torch.Tensor, scale, bias, groups: int, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm over channel groups of the last axis, per position (the
    paper swaps BatchNorm for it: batch statistics do not carry across
    non-IID clients)."""
    *lead, c = x.shape
    xf = x.float().reshape(*lead, groups, c // groups)
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    xn = ((xf - mu) * torch.rsqrt(var + eps)).reshape(*lead, c)
    return (xn * scale + bias).to(x.dtype)


def softmax_xent_chunked(hidden: torch.Tensor, head_w: torch.Tensor, labels: torch.Tensor,
                         mask: Optional[torch.Tensor] = None, chunk: int = 1024) -> torch.Tensor:
    """Mean cross-entropy over (masked) positions, logits in sequence chunks.

    The chunk shrinks until it divides the sequence, as in the reference;
    the label's logit is picked by a masked sum over the vocabulary.
    """
    b, s, _ = hidden.shape
    chunk = min(chunk, s)
    while s % chunk:
        chunk -= 1
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=hidden.device)
    mask = mask.float()
    vocab = torch.arange(head_w.shape[-1], device=hidden.device)
    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s, chunk):
        logits = (hidden[:, i:i + chunk] @ head_w).float()
        lse = torch.logsumexp(logits, dim=-1)
        onehot = vocab == labels[:, i:i + chunk, None]
        picked = torch.where(onehot, logits, torch.zeros((), device=logits.device)).sum(-1)
        m = mask[:, i:i + chunk]
        loss_sum = loss_sum + ((lse - picked) * m).sum()
        count = count + m.sum()
    return loss_sum / torch.clamp(count, min=1.0)


def scan_blocks(block_fn: Callable, stacked_params, x: torch.Tensor,
                mat: Materializer) -> torch.Tensor:
    """Loop over stacked layer params: ``carry = block_fn(carry, w)``.

    Each layer is materialized inside its own ``checkpoint`` (non-reentrant),
    so its decoded weights and activations are not kept for the backward
    pass but recomputed there — the reference's remat around each scan step.
    The stacked leaves are unbound once: their gradient is then one stack
    of the per-layer gradients, not a full-size zero-filled tensor per layer.
    """
    n = next(tree_items(stacked_params))[1].shape[0]
    slices = tree_map(lambda a: a.unbind(0), stacked_params)

    def body(carry, i):
        return block_fn(carry, mat(tree_map(lambda a: a[i], slices)))

    for i in range(n):
        if torch.is_grad_enabled():
            x = checkpoint(body, x, i, use_reentrant=False)
        else:
            x = body(x, i)
    return x


def stack_layer_params(layer_list):
    """``[{...}, {...}]`` -> ``{...}`` with leaves stacked on a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs, 0), *layer_list)
