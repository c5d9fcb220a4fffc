"""Which parameters get quantized — 'weight matrices only' (paper §2.4).

Port of ``repro.core.policy``.  Parameter trees are nested ``dict``s keyed
like the reference's, so ``path_str`` renders the same 'a/b/c' names.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, List, Optional, Sequence, Tuple

from .tree import tree_items, tree_map_with_path


def path_str(path: Sequence[Any]) -> str:
    """Render a tree path (sequence of keys) as 'a/b/0/c'."""
    return "/".join(str(p) for p in path)


@dataclasses.dataclass(frozen=True)
class QuantizePolicy:
    """Selects quantizable variables by shape and name.

    weights_only: if True, only leaves with ndim >= min_ndim are candidates.
    min_ndim:     minimum rank for the weights-only rule (2 = matrices).
    min_size:     skip tiny variables (their s/b overhead isn't worth it).
    exclude_re:   path regexes never quantized (sensitive params).
    include_re:   if set, only matching paths are candidates.
    """

    weights_only: bool = True
    min_ndim: int = 2
    min_size: int = 256
    exclude_re: Tuple[str, ...] = ()
    include_re: Optional[Tuple[str, ...]] = None

    def selects(self, path: str, leaf: Any) -> bool:
        """All rules, with the leaf's own rank (no stacked axes)."""
        if not hasattr(leaf, "is_floating_point") or not leaf.is_floating_point():
            return False
        if self.weights_only and leaf.ndim < self.min_ndim:
            return False
        return self.selects_name(path, leaf.numel())

    def selects_name(self, path: str, size: int) -> bool:
        """The size and path rules.  The rank rule (``weights_only``,
        ``min_ndim``) needs the stacked-axis count and lives in
        ``federated.state.selected``."""
        if size < self.min_size:
            return False
        if any(re.search(pat, path) for pat in self.exclude_re):
            return False
        if self.include_re is not None:
            return any(re.search(p, path) for p in self.include_re)
        return True


def quantizable_names(params, policy: QuantizePolicy) -> List[str]:
    """Paths of the leaves ``policy`` selects, in leaf order."""
    return [path_str(p) for p, leaf in tree_items(params) if policy.selects(path_str(p), leaf)]


def selection_mask_tree(params, policy: QuantizePolicy):
    """Tree of Python bools: True where ``policy`` selects the leaf."""
    return tree_map_with_path(lambda p, leaf: policy.selects(path_str(p), leaf), params)


def coverage(params, policy: QuantizePolicy) -> float:
    """Fraction of parameters (by count) that ``policy`` selects."""
    sel = tot = 0
    for p, leaf in tree_items(params):
        if not hasattr(leaf, "numel"):
            continue
        tot += leaf.numel()
        if policy.selects(path_str(p), leaf):
            sel += leaf.numel()
    return sel / max(tot, 1)
