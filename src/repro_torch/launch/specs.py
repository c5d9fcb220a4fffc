"""Input stand-ins and sharding annotations for the dry-run (port of
``repro.launch.specs``).

``batch_specs`` gives a cell's model inputs as ``meta`` tensors (shapes and
dtypes, no memory); the ``annotate_*`` functions return a tree of the same
structure with each tensor leaf replaced by :class:`Sharded`, the leaf beside
the :class:`~repro_torch.models.common.NamedSharding` that says where it
would live on ``mesh`` (the reference's ``ShapeDtypeStruct(..., sharding=)``).
A ``CompressedVariable`` keeps its structure: its codes follow the leaf's
storage spec, its ``(s, b)`` are replicated.  Values that are not tensors
(host counters, PRNG keys, the decode state's ``length``) pass through.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from repro_torch.configs.shapes import Shape
from repro_torch.core.store import CompressedVariable, is_compressed
from repro_torch.core.tree import tree_map
from repro_torch.models.common import (
    NamedSharding,
    ParamSpec,
    PartitionSpec,
    _pad_spec,
    resolve_spec,
)

@dataclasses.dataclass(frozen=True)
class Sharded:
    """A leaf and where it would live."""

    value: torch.Tensor
    sharding: NamedSharding

    @property
    def shape(self):
        return self.value.shape

    @property
    def dtype(self):
        return self.value.dtype

    def shard_nbytes(self) -> int:
        """Bytes one device holds: the shard shape's size times the itemsize."""
        return math.prod(self.sharding.shard_shape(self.value.shape)) * self.value.element_size()


def maybe_ep_partitions(cfg, mesh) -> Any:
    """MoE: set ep_partitions so stored experts divide the model axis."""
    if not hasattr(cfg, "n_experts") or mesh is None:
        return cfg
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    m = sizes.get("model", 1)
    if cfg.n_experts % m == 0 or m % cfg.n_experts != 0:
        return cfg
    return dataclasses.replace(cfg, ep_partitions=m // cfg.n_experts)


def batch_specs(arch_mod, cfg, shape: Shape) -> Dict[str, torch.Tensor]:
    """Model-input stand-ins for one cell (no params, no caches), on meta."""
    b, s = shape.global_batch, shape.seq_len
    fam = arch_mod.FAMILY

    def tok(n):  # the port's token dtype (prng.randint, argmax): int64
        return torch.empty((b, n), dtype=torch.int64, device="meta")

    def embeds(n, d):
        return torch.empty((b, n, d), dtype=torch.float32, device="meta")

    if fam in ("transformer", "moe", "xlstm", "griffin"):
        if shape.kind == "train":
            return dict(tokens=tok(s), labels=tok(s))
        return dict(tokens=tok(s if shape.kind == "prefill" else 1))
    if fam == "vlm":  # the stubbed frontend's patch embeddings, then the tokens
        nt = s - cfg.prefix_embeds
        patches = embeds(cfg.prefix_embeds, cfg.d_model)
        if shape.kind == "train":
            return dict(patches=patches, tokens=tok(nt), labels=tok(nt))
        if shape.kind == "prefill":
            return dict(patches=patches, tokens=tok(nt))
        return dict(tokens=tok(1))
    if fam == "encdec":  # the stubbed frontend's frames; the decoder's s // dec_ratio tokens
        sd = s // cfg.dec_ratio
        if shape.kind == "train":
            return dict(frames=embeds(s, cfg.d_model), tokens=tok(sd), labels=tok(sd))
        if shape.kind == "prefill":
            return dict(frames=embeds(s, cfg.d_model), tokens=tok(sd))
        return dict(tokens=tok(1))
    raise ValueError(f"no input specs for family {fam}")


_BATCH_AXES = {
    "tokens": ("batch", None),
    "labels": ("batch", None),
    "mask": ("batch", None),
    "patches": ("batch", None, None),
    "frames": ("batch", None, None),
}


def annotate_batch(specs: Dict[str, torch.Tensor], mesh) -> Dict[str, Sharded]:
    return {k: Sharded(v, NamedSharding(mesh, resolve_spec(_BATCH_AXES[k][:v.ndim], v.shape,
                                                            mesh)))
            for k, v in specs.items()}


def _leaf_sharding(mesh, axes, shape) -> NamedSharding:
    return NamedSharding(mesh, resolve_spec(_pad_spec(axes, len(shape)), shape, mesh))


def _annotate_leaf(leaf, axes, mesh):
    if not isinstance(leaf, torch.Tensor):
        return leaf
    sh = (_leaf_sharding(mesh, axes, leaf.shape) if axes is not None
          else NamedSharding(mesh, PartitionSpec()))
    return Sharded(leaf, sh)


def annotate_tree(tree, specs_tree, mesh):
    """Storage shardings for a parameter tree (``CompressedVariable`` or
    tensor leaves).  ``specs_tree`` is the family's ``ParamSpec`` tree, of
    the same structure; leaves without a spec (``specs_tree=None``) are
    replicated."""

    def ann(sub, spec):
        axes = spec.storage if isinstance(spec, ParamSpec) else None
        if is_compressed(sub):
            return CompressedVariable(codes=_annotate_leaf(sub.codes, axes, mesh),
                                      s=_annotate_leaf(sub.s, None, mesh),
                                      b=_annotate_leaf(sub.b, None, mesh), fmt=sub.fmt)
        return _annotate_leaf(sub, axes, mesh)

    if specs_tree is None:
        return _map_any(lambda leaf: ann(leaf, None), tree)
    return tree_map(ann, tree, specs_tree)


def _map_any(fn, tree):
    """``fn`` over the leaves of dicts, tuples and named tuples (an optimizer
    state is a named tuple of counters and trees)."""
    if isinstance(tree, dict):
        return {k: _map_any(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_any(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_any(fn, v) for v in tree)
    return fn(tree)


def annotate_state(state, specs, mesh):
    """Storage shardings for a ``TrainState``: params by their specs, the
    optimizer state replicated (its round, counters and key are host
    values, left as they are)."""
    from repro_torch.federated.state import TrainState

    return TrainState(params=annotate_tree(state.params, specs, mesh),
                      opt_state=annotate_tree(state.opt_state, None, mesh),
                      round=state.round, rng=state.rng)


def population_sharding(mesh, ndim: int, leading: int = 0) -> NamedSharding:
    """Stacked per-client state: axis 0 on ``clients``.  Without a
    ``clients`` axis, with a 1-wide one, or where its size does not divide
    ``leading`` (when known), the layout replicates; one card always does."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    n = sizes.get("clients", 1)
    if "clients" not in sizes or n <= 1 or (leading and leading % n != 0):
        return NamedSharding(mesh, PartitionSpec())
    return NamedSharding(mesh, PartitionSpec("clients", *(None,) * (ndim - 1)))


def annotate_population(tree, mesh):
    """A stacked ``[num_clients, ...]`` tree placed by
    :func:`population_sharding`: each leaf moved to the mesh's first device
    (a replicated layout, or a mesh of one card) beside its sharding."""
    dev = mesh.devices.flat[0]

    def place(x):
        x = torch.as_tensor(x)
        return Sharded(x.to(dev), population_sharding(mesh, x.ndim, x.shape[0]))

    return tree_map(place, tree)


_KV = (None, "batch", "kv_seq", "tensor", None)  # [L, B, S, KVH, hd]
_KVPOS = (None, "batch", "kv_seq")


def decode_state_axes(family: str, cfg, struct):
    """Logical-axes tree matching each family's decode-state structure (the
    models' ``cache_shard_hint`` / ``state_shard_hint`` layouts)."""
    from repro_torch.models import attention as attn

    if family in ("transformer", "vlm", "moe"):
        return attn.KVCache(k=_KV, v=_KV, pos=_KVPOS, length=())
    if family == "encdec":
        return dict(self_kv=attn.KVCache(k=_KV, v=_KV, pos=_KVPOS, length=()),
                    cross_k=_KV, cross_v=_KV, cross_pos=_KVPOS, length=())
    if family == "xlstm":
        m = dict(conv=(None, None, "batch", None, "dstate"),
                 C=(None, None, "batch", None, "dstate", None),
                 n=(None, None, "batch", None, None),
                 m=(None, None, "batch", None))
        axes = dict(mlstm=m, slstm={k: (None, "batch", None, None) for k in ("c", "n", "m", "h")},
                    length=())
        if "extra_m" in struct:
            axes["extra_m"] = {k: v[1:] for k, v in m.items()}
        return axes
    if family == "griffin":
        axes = dict(
            rec=dict(conv=(None, None, "batch", None, "dstate"),
                     h=(None, None, "batch", "dstate")),
            att=dict(k=_KV, v=_KV, pos=_KVPOS),
            length=(),
        )
        if "extra_rec" in struct:
            axes["extra_rec"] = dict(conv=(None, "batch", None, "dstate"),
                                     h=(None, "batch", "dstate"))
        return axes
    raise ValueError(f"no decode-state axes for family {family}")


def annotate_cache(cache, family: str, cfg, mesh):
    """Storage shardings for a decode state: a ``KVCache`` (the transformer's,
    the encoder-decoder's self cache) keeps its class, a dict its keys."""
    from repro_torch.models import attention as attn

    def ann(leaf, axes):
        if isinstance(leaf, attn.KVCache):
            return attn.KVCache(**{f.name: ann(getattr(leaf, f.name), getattr(axes, f.name))
                                   for f in dataclasses.fields(leaf)})
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return Sharded(leaf, NamedSharding(mesh, resolve_spec(axes[:leaf.ndim], leaf.shape, mesh)))

    axes_tree = decode_state_axes(family, cfg, cache)
    if isinstance(cache, attn.KVCache):
        return ann(cache, axes_tree)
    return tree_map(ann, cache, axes_tree)
