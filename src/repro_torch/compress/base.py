"""The ``CompressionStrategy`` interface and the strategy zoo (port of
``repro.compress.base``, DESIGN.md §11).

The paper's OMC quantization is one point of a wider design space: top-k
sparsification (Konečný et al., arxiv 1610.05492), ternary TNT weights and
stacked quantize + sparsify + entropy-code pipelines (Grativol et al., arxiv
2310.14693).  This module holds the one interface they share, so that the
codec (``repro_torch.api.codecs``), the byte ledgers
(``repro_torch.federated.accounting``) and the training paths treat them
alike:

  * :class:`CompressionStrategy` — encode and decode one selected variable
    to a self-describing wire leaf, a quantize→dequantize view (and its
    straight-through form) for training, and exact byte accounting:
    shape-determined strategies predict their wire bytes from
    ``(n_elems, stack_entries)`` (:meth:`~CompressionStrategy.plan_wire_bytes`),
    data-dependent ones return ``None`` there and are measured from the
    encoded leaf.
  * :class:`StrategyLeaf` — the encoded wire leaves of the strategies other
    than OMC.  Each decodes itself (``dequantize``) and knows how many body
    bytes the codec writes for it (``wire_body_bytes``).
  * the registry — ``register_strategy`` / ``get_strategy`` /
    ``available_strategies`` / ``default_zoo``.  The registered name is the
    payload's strategy tag and ``wire_version`` the version the codec checks.

Leaves hold torch tensors on the device they were encoded on, so the work
of an encode or a decode (top-k selection, the ``quantize`` and ``pack`` /
``unpack`` kernels) runs on the card for a CUDA tree; the reference keeps
numpy on the host.  Copies to the host happen only in the codec.

The tree helpers (``encode_tree`` / ``decode_tree`` / ``qdq_tree`` /
``tree_wire_bytes``) apply a strategy under OMC's own selection policy, with
stacked-axis awareness from ``repro_torch.federated.state`` when the
family's specs are given, so every strategy compresses exactly the
variables OMC would.
"""

from __future__ import annotations

import abc
import math
from typing import Any, Dict, List, Optional, Type

import torch

from repro_torch.core.omc import OMCConfig
from repro_torch.core.policy import path_str
from repro_torch.core.store import is_compressed
from repro_torch.core.tree import tree_items, tree_map, tree_map_with_path


class StrategyLeaf:
    """Base class of the encoded per-variable wire leaves (not OMC's).

    ``dequantize()`` returns the f32 tensor the receiver materializes, on
    the leaf's device; ``wire_body_bytes()`` is the exact number of body
    bytes the codec writes for it, split into ``index_bytes()`` (positions)
    and ``meta_bytes()`` (scales) for ``payload_bytes_report``'s per-kind
    breakdown; ``to(device)`` moves its tensors.
    """

    kind: str = "?"  # manifest leaf kind == strategy name

    def dequantize(self) -> torch.Tensor:
        raise NotImplementedError

    def wire_body_bytes(self) -> int:
        raise NotImplementedError

    def index_bytes(self) -> int:
        return 0

    def meta_bytes(self) -> int:
        return 0


class CompressionStrategy(abc.ABC):
    """One transport compressor: parameter tree <-> wire leaves, exact bytes.

    Implementations are deterministic and stable as codecs: encoding the
    decoded value of a leaf again gives the same wire leaf.
    """

    #: registry key and the payload's strategy tag
    name: str = "?"
    #: per-strategy wire format version, checked by ``decode_payload``
    wire_version: int = 1
    #: delta rule on repeat sends: "xor-sparse" (OMC's) or None (full only)
    delta_rule: Optional[str] = None
    #: training contract (DESIGN.md §12): ``True`` compresses only the
    #: client->server direction, and its qdq applies to the client's update;
    #: ``False`` makes the qdq the client's view of the download too
    upload_only: bool = False
    #: whether the training paths carry a per-client error-feedback residual
    error_feedback: bool = False

    # -- per-variable codec -------------------------------------------------
    @abc.abstractmethod
    def encode_leaf(self, v: torch.Tensor, *, batch_axes: int = 0):
        """f32 tensor -> wire leaf (StrategyLeaf or CompressedVariable)."""

    @abc.abstractmethod
    def decode_leaf(self, leaf) -> torch.Tensor:
        """Wire leaf -> the f32 tensor the receiver materializes."""

    # -- training view --------------------------------------------------------
    @abc.abstractmethod
    def qdq_leaf(self, v: torch.Tensor, *, batch_axes: int = 0,
                 client_axis: bool = False) -> torch.Tensor:
        """Quantize->dequantize view, equal to ``decode_leaf(encode_leaf(v))``
        up to the encode's tie rule, in plain PyTorch.  With ``client_axis``
        the leading axis holds C clients' copies of the variable (counted in
        ``batch_axes``), each compressed as a call on ``v[c]`` would."""

    def qdq_ste_leaf(self, v: torch.Tensor, *, batch_axes: int = 0,
                     client_axis: bool = False) -> torch.Tensor:
        """qdq with a straight-through gradient: ``v + (q - v).detach()``."""
        q = self.qdq_leaf(v, batch_axes=batch_axes, client_axis=client_axis)
        return v + (q - v).detach()

    def train_qdq_leaf(self, v: torch.Tensor, *, batch_axes: int = 0,
                       client_axis: bool = False) -> torch.Tensor:
        """The qdq the training client view applies (DESIGN.md §12); the wire
        qdq unless a strategy overrides it (OMC does)."""
        return self.qdq_leaf(v, batch_axes=batch_axes, client_axis=client_axis)

    def train_qdq_ste_leaf(self, v: torch.Tensor, *, batch_axes: int = 0,
                           client_axis: bool = False) -> torch.Tensor:
        """:meth:`train_qdq_leaf` with a straight-through gradient."""
        q = self.train_qdq_leaf(v, batch_axes=batch_axes, client_axis=client_axis)
        return v + (q - v).detach()

    # -- byte accounting ----------------------------------------------------
    @abc.abstractmethod
    def leaf_wire_bytes(self, leaf) -> int:
        """Exact wire body bytes of one encoded leaf (measured)."""

    def plan_wire_bytes(self, n_elems: int, stack_entries: int) -> Optional[int]:
        """Wire body bytes predicted from the shape alone, or None when the
        size depends on the data.  When not None it equals
        ``leaf_wire_bytes`` of any encode of that shape."""
        return None

    def describe(self) -> Dict[str, Any]:
        """Identification row for reports."""
        return dict(strategy=self.name, wire_version=self.wire_version, label=self.label)

    @property
    def label(self) -> str:
        return self.name


# ---------------------------------------------------------------------------
# registry — the strategy zoo
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Type[CompressionStrategy]] = {}


def register_strategy(cls: Type[CompressionStrategy]) -> Type[CompressionStrategy]:
    """Class decorator: add a strategy to the zoo under ``cls.name``."""
    if not cls.name or cls.name == "?":
        raise ValueError(f"{cls.__name__} must declare a registry name")
    if not isinstance(cls.wire_version, int) or cls.wire_version < 1:
        raise ValueError(f"{cls.__name__} must declare wire_version >= 1")
    prev = _REGISTRY.get(cls.name)
    if prev is not None and prev is not cls:
        raise ValueError(f"strategy name {cls.name!r} already registered")
    _REGISTRY[cls.name] = cls
    return cls


def get_strategy(name: str, **params) -> CompressionStrategy:
    """Instantiate a registered strategy by name."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown compression strategy {name!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**params)


def strategy_class(name: str) -> Type[CompressionStrategy]:
    if name not in _REGISTRY:
        raise KeyError(f"unknown compression strategy {name!r}")
    return _REGISTRY[name]


def available_strategies() -> List[str]:
    return sorted(_REGISTRY)


def default_zoo() -> List[CompressionStrategy]:
    """One instance per family, as the reference's benchmark sweeps them."""
    from .omc_quant import OMCQuantStrategy
    from .pipeline import PipelineStrategy
    from .ternary import TernaryTNTStrategy
    from .topk import TopKSparseStrategy

    return [
        OMCQuantStrategy(),  # the paper's S1E3M7 + PVT
        OMCQuantStrategy.parse("S1E4M3"),  # aggressive 8-bit minifloat
        TopKSparseStrategy(density=0.1),
        TernaryTNTStrategy(),
        PipelineStrategy(),  # quant -> top-k -> DEFLATE
    ]


def is_strategy_leaf(x: Any) -> bool:
    return isinstance(x, StrategyLeaf)


def is_encoded_leaf(x: Any) -> bool:
    """True for any wire leaf: OMC's ``CompressedVariable`` or a StrategyLeaf."""
    return is_compressed(x) or isinstance(x, StrategyLeaf)


# ---------------------------------------------------------------------------
# tree-level application under the OMC selection policy
# ---------------------------------------------------------------------------


def _map_selected(fn, params, omc: OMCConfig, specs=None):
    if specs is None:
        # the policy alone (no stacked-axis information): batch_axes = 0
        def f(path, leaf):
            if omc.enabled and omc.policy.selects(path_str(path), leaf):
                return fn(leaf, 0)
            return leaf

        return tree_map_with_path(f, params)

    from repro_torch.federated.state import n_stack_axes, selected

    def g(path, spec, leaf):
        if selected(omc, path_str(path), spec, leaf):
            return fn(leaf, n_stack_axes(spec, leaf))
        return leaf

    return tree_map_with_path(g, specs, params)


def encode_tree(strategy: CompressionStrategy, params, omc: OMCConfig, specs=None):
    """f32 tree -> wire tree: the policy-selected leaves encoded under
    ``strategy``, the rest passed through (they travel raw f32).  ``omc``
    gives the selection policy only; ``specs`` (the family's ParamSpec tree)
    adds stacked-axis-aware selection and per-entry scales."""
    return _map_selected(lambda leaf, ax: strategy.encode_leaf(leaf, batch_axes=ax),
                         params, omc, specs)


def decode_tree(tree):
    """Wire tree -> f32 tree (every encoded leaf dequantized)."""
    return tree_map(lambda x: x.dequantize() if is_encoded_leaf(x) else x, tree)


def qdq_tree(strategy: CompressionStrategy, params, omc: OMCConfig, specs=None):
    """The quantize->dequantize view of the whole tree, the training-side
    counterpart of ``decode_tree(encode_tree(...))``."""
    return _map_selected(lambda leaf, ax: strategy.qdq_leaf(leaf, batch_axes=ax),
                         params, omc, specs)


def tree_wire_bytes(tree) -> Dict[str, Any]:
    """Exact wire body bytes of an encoded tree, split per strategy kind:
    the totals a serialized full payload's body measures and the split
    ``payload_bytes_report`` gives.  Only shapes are read."""
    from repro_torch.core import packing

    total = dict(wire_bytes=0, fp32_bytes=0, num_params=0)
    per: Dict[str, Dict[str, int]] = {}

    def bucket(kind):
        return per.setdefault(kind, dict(payload_bytes=0, index_bytes=0, meta_bytes=0,
                                         num_leaves=0, num_params=0))

    for _, leaf in tree_items(tree):
        if is_compressed(leaf):
            n = leaf.codes.numel()
            meta = 8 * leaf.s.numel()
            body = packing.packed_bytes(n, leaf.fmt) + meta
            b = bucket("omc")
            b["meta_bytes"] += meta
        elif isinstance(leaf, StrategyLeaf):
            n = math.prod(leaf.shape)
            body = leaf.wire_body_bytes()
            b = bucket(leaf.kind)
            b["index_bytes"] += leaf.index_bytes()
            b["meta_bytes"] += leaf.meta_bytes()
        else:
            n = leaf.numel()
            body = n * leaf.element_size()
            b = bucket("raw")
        b["payload_bytes"] += body
        b["num_leaves"] += 1
        b["num_params"] += n
        total["wire_bytes"] += body
        total["fp32_bytes"] += 4 * n
        total["num_params"] += n
    total["wire_ratio"] = total["wire_bytes"] / max(total["fp32_bytes"], 1)
    total["per_strategy"] = per
    return total
