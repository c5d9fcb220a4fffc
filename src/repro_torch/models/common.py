"""Shared model pieces: param specs, identity materializer, init, norms, RoPE,
chunked cross-entropy and the layer loop.

Port of ``repro.models.common``.  Models are plain functions over nested
``dict`` parameter trees keyed like the reference's.  Per-block parameters
are stacked on a leading layer axis; where the reference scans over that
axis under remat, the port runs a Python loop (``scan_blocks``), each layer
under ``torch.utils.checkpoint`` when gradients are taken.  Where the
reference ``vmap``s a client's loss over a cohort, ``scan_blocks_clients``
runs the layers of C clients at once: each layer's ``checkpoint`` wraps a
``torch.func.vmap`` of the block over the client axis (a checkpoint cannot
sit inside ``vmap``: its saved-tensor hooks do not compose with it).

A model multiplies by a weight matrix through :func:`linear`, which takes
the weight as an f32 tensor or in code form (a ``CompressedVariable``, which
``OMCMaterializer`` leaves for the matmul operands a model names) and then
streams the codes through the ``dequant_matmul`` kernel.

``ParamSpec`` keeps the reference's logical axes as plain data: the number
of axes a spec describes is what tells stacked axes apart
(``federated.state.n_stack_axes``).  The sharding helpers resolve those axes
against a mesh as the reference's do (``resolve_spec``: mesh axes tried in
order, divisibility wins) into the port's own :class:`PartitionSpec` and
:class:`NamedSharding`.  They say where each leaf *would* live on a mesh
(``launch/specs.py``, the meta-device dry-run); the port runs on one card,
with no process group and no ``DTensor``, so :func:`shard_hint` moves
nothing: outside :class:`activate_mesh` it is the identity, inside it checks
the hint's rank and returns its tensor.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import prng
from repro_torch.core.store import is_compressed
from repro_torch.core.tree import tree_items, tree_map
from repro_torch.kernels import ops


# ---------------------------------------------------------------------------
# Logical axis rules, the mesh context and layouts
# ---------------------------------------------------------------------------

# logical axis -> tuple of mesh axis names (tried in order, divisibility wins)
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "fsdp": ("pod", "data"),  # weight storage shard (ZeRO-3 style)
    "tensor": ("model",),  # tensor-parallel dim (heads / ffn / vocab)
    "kv_seq": ("model",),  # decode KV-cache sequence sharding (MQA/GQA)
    "expert": ("model",),  # expert-parallel dim (only when divisible)
    "qblk": ("model",),  # train/prefill attention: q-block dim
    "seq": ("model",),  # sequence-sharded residual stream
    "dstate": ("model",),  # recurrent state feature dim
    "replicated": (),
}


class PartitionSpec(tuple):
    """A leaf's layout: per dimension ``None`` (replicated), a mesh axis
    name, or a tuple of names (split over their product); dimensions past
    the end are replicated.  A tuple, as jax's ``PartitionSpec`` is."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def _mesh_axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """Where a leaf would live: ``spec`` over ``mesh``'s named axes."""

    mesh: Any
    spec: PartitionSpec

    def shard_shape(self, global_shape: Sequence[int]) -> Tuple[int, ...]:
        """The per-device shape of a leaf of ``global_shape``."""
        sizes = _mesh_axis_sizes(self.mesh)
        out = []
        for i, dim in enumerate(global_shape):
            entry = self.spec[i] if i < len(self.spec) else None
            axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
            n = math.prod(sizes[a] for a in axes)
            if dim % n:
                raise ValueError(f"dimension {i} of {tuple(global_shape)} does not divide "
                                 f"over {axes} ({n} devices)")
            out.append(dim // n)
        return tuple(out)


class _MeshCtx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: Dict[str, Tuple[str, ...]] = dict(DEFAULT_RULES)


_CTX = _MeshCtx()


class activate_mesh:
    """Context manager: resolve logical-axis hints against ``mesh`` (state
    per thread).  Outside it every hint is the identity."""

    def __init__(self, mesh, rules: Optional[Dict[str, Tuple[str, ...]]] = None):
        self.mesh = mesh
        self.rules = dict(DEFAULT_RULES)
        if rules:
            self.rules.update(rules)

    def __enter__(self):
        self._old = (_CTX.mesh, _CTX.rules)
        _CTX.mesh, _CTX.rules = self.mesh, self.rules
        return self.mesh

    def __exit__(self, *exc):
        _CTX.mesh, _CTX.rules = self._old
        return False


def current_mesh():
    return _CTX.mesh


def resolve_spec(logical: Sequence[Optional[str]], shape: Sequence[int], mesh=None,
                 rules=None) -> PartitionSpec:
    """Logical axes -> PartitionSpec: each logical axis takes the mesh axes
    of its rule in order, each only if it is unused and the dimension
    divides over the product so far; the reference's rule."""
    mesh = mesh if mesh is not None else _CTX.mesh
    rules = rules if rules is not None else _CTX.rules
    if mesh is None:
        return PartitionSpec()
    sizes = _mesh_axis_sizes(mesh)
    out, used = [], set()
    for dim, name in zip(shape, logical):
        if name is None or name == "replicated":
            out.append(None)
            continue
        axes, prod = [], 1
        for ax in rules.get(name, ()):
            if ax in used or ax not in sizes:
                continue
            if dim % (prod * sizes[ax]) == 0:
                axes.append(ax)
                prod *= sizes[ax]
        used.update(axes)
        out.append(tuple(axes) if len(axes) > 1 else (axes[0] if axes else None))
    return PartitionSpec(*out)


def shard_hint(x, *logical: Optional[str]):
    """The reference's ``with_sharding_constraint`` by logical axes.  One
    card holds every leaf whole, so it returns ``x``; under an active mesh
    it first checks that the hint names one axis per dimension."""
    if _CTX.mesh is None or not hasattr(x, "shape"):
        return x
    if len(logical) != x.ndim:
        raise ValueError(f"shard_hint: {len(logical)} logical axes {logical} for a "
                         f"{x.ndim}-d tensor of shape {tuple(x.shape)}")
    return x


def named_sharding(logical: Sequence[Optional[str]], shape, mesh=None) -> NamedSharding:
    mesh = mesh if mesh is not None else _CTX.mesh
    return NamedSharding(mesh, resolve_spec(logical, shape, mesh))


def _pad_spec(axes: Tuple[Optional[str], ...], ndim: int) -> Tuple[Optional[str], ...]:
    """Right-align a spec to the leaf rank (a layer slice drops the L dim)."""
    axes = tuple(axes)
    if len(axes) >= ndim:
        return axes[len(axes) - ndim:]
    return (None,) * (ndim - len(axes)) + axes


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


def spec_leaf_for(path_unused, leaf_spec: ParamSpec, leaf) -> ParamSpec:
    return leaf_spec


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


def as_f32(x: float) -> float:
    """``x`` rounded to f32: a float64 constant applied to an f32 array in
    JAX (x64 off) multiplies as its f32 value."""
    return torch.tensor(x, dtype=torch.float32).item()


def dense_init(key: prng.Key, d_in: int, d_out: int, scale: float = 1.0,
               device=None) -> torch.Tensor:
    """``jax.random.normal(key, (d_in, d_out)) · f32(scale / sqrt(d_in))``,
    the reference's ``dense_init``, within :func:`prng.normal`'s 4 ulp."""
    return prng.normal(key, (d_in, d_out), device).mul_(as_f32(scale / math.sqrt(d_in)))


def embed_init(key: prng.Key, vocab: int, d: int, device=None) -> torch.Tensor:
    return prng.normal(key, (vocab, d), device).mul_(as_f32(0.02))


def init_layers(layer_init: Callable[[prng.Key], dict], keys) -> dict:
    """``stack_layer_params([layer_init(k) for k in keys])``, with each layer
    copied into its slot of the stacked leaves as soon as it is drawn, so
    that a full-width init holds the stack and one layer, not two copies."""
    out = None
    for i, k in enumerate(keys):
        layer = layer_init(k)
        if out is None:
            out = tree_map(lambda a: a.new_empty((len(keys),) + tuple(a.shape)), layer)
        for (_, dst), (_, src) in zip(tree_items(out), tree_items(layer)):
            dst[i].copy_(src)
    return out


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


def gelu_mlp(x, w1, b1, w2, b2):
    """The encoder-decoder's MLP: gelu(x@w1 + b1) @ w2 + b2 (tanh gelu)."""
    return linear(gelu(linear(x, w1) + b1), w2) + b2


def stack_entry(tree, i: int):
    """Entry ``i`` of every stacked leaf of a flat dict (tensor or
    ``CompressedVariable``, which indexes its codes and (s, b) together)."""
    return {k: v[i] for k, v in tree.items()}


def embed_lookup(table, tokens: torch.Tensor, mat: Materializer) -> torch.Tensor:
    """Token rows of the embedding; a compressed table decodes only those rows
    (one ``dequantize`` launch), bit for bit the rows of the decoded table
    (a training ``QParam`` takes its sink's rows with them)."""
    flat = tokens.reshape(-1)
    rows = table[flat] if isinstance(table, torch.Tensor) else table.rows(flat)
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


def unstack(stacked_params) -> list:
    """The entries of a tree's stacked leaves along axis 0, one tree each,
    every leaf unbound once (a tensor, ``CompressedVariable`` or ``QParam``):
    a doubly stacked leaf ``[n_super, per_super, ...]`` gives ``n_super``
    stacks that :func:`scan_blocks` unbinds again."""
    slices = tree_map(lambda a: a.unbind(0), stacked_params)
    n = len(next(tree_items(slices))[1])
    return [tree_map(lambda a: a[i], slices) for i in range(n)]


def layer_call(block_fn: Callable, stored, x, mat: Materializer, i: int = 0,
               operands: Sequence[str] = ()):
    """``block_fn(x, mat(stored, operands), i)``, materialized inside its own
    ``checkpoint`` (non-reentrant) when gradients are taken, so that the
    layer's decoded weights and activations are recomputed in the backward
    pass instead of kept: the reference's remat around each scan step.
    ``operands`` names the matmul operands that serving keeps in code form
    (a training ``QParam`` is always decoded)."""

    def body(carry, idx):
        return block_fn(carry, mat(stored, operands=operands), idx)

    if torch.is_grad_enabled():
        return checkpoint(body, x, i, use_reentrant=False)
    return body(x, i)


def scan_blocks(block_fn: Callable, stacked_params, x, mat: Materializer,
                operands: Sequence[str] = ()):
    """Loop over stacked layer params: ``carry = block_fn(carry, w, i)``, ``i``
    the layer's index.  The carry is a tensor or a tuple of tensors.

    Each layer runs through :func:`layer_call`.  The stacked leaves are
    unbound once (:func:`unstack`): their gradient is then one stack of the
    per-layer gradients, not a full-size zero-filled tensor per layer.  A
    leaf is a tensor or anything else with ``unbind`` (a
    ``CompressedVariable``, the training materializer's ``QParam``), so that
    a layer's codes are decoded inside its ``checkpoint`` and again in the
    recompute.
    """
    for i, stored in enumerate(unstack(stacked_params)):
        x = layer_call(block_fn, stored, x, mat, i, operands)
    return x


def layer_call_clients(block_fn: Callable, stored, x, i: int = 0):
    """:func:`layer_call` for C clients: ``x`` and every leaf of ``stored``
    carry a leading client axis, and the block runs under
    ``torch.func.vmap`` over it, inside one ``checkpoint`` (non-reentrant)
    when gradients are taken.  The weights are f32 (training's identity
    materializer)."""

    def body(carry, w):
        return torch.func.vmap(lambda c, ww: block_fn(c, ww, i))(carry, w)

    if torch.is_grad_enabled():
        return checkpoint(body, x, stored, use_reentrant=False)
    return body(x, stored)


def scan_blocks_clients(block_fn: Callable, stacked_params, x):
    """:func:`scan_blocks` over C clients: ``x [C, ...]`` and every stacked
    leaf ``[C, L, ...]``; each layer through :func:`layer_call_clients`.
    The leaves are unbound once along the layer axis, so a leaf's gradient
    is one stack of the per-layer gradients."""
    slices = tree_map(lambda a: a.unbind(1), stacked_params)
    n = len(next(tree_items(slices))[1])
    for i in range(n):
        x = layer_call_clients(block_fn, tree_map(lambda a: a[i], slices), x, i)
    return x
