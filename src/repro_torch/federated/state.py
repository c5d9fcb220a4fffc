"""Compressed-at-rest server parameters (port of ``repro.federated.state``).

``compress_params`` applies the OMC policy to an f32 parameter tree:
selected variables become ``CompressedVariable`` (the paper's storage model —
no persistent f32 master).  The number of PVT batch axes per leaf (stacked
layers) comes from the ParamSpec: stacked axes are exactly the leading axes
the spec does not describe.  ``TrainState``/``init_state`` serve
``federated/round.py``'s training round, not ported yet (ROADMAP).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core import packing
from repro_torch.core.omc import OMCConfig
from repro_torch.core.policy import path_str
from repro_torch.core.store import compress_variable, is_compressed
from repro_torch.core.tree import tree_items, tree_map_with_path
from repro_torch.models.common import ParamSpec


def n_stack_axes(spec: ParamSpec, leaf) -> int:
    """Leading stacked axes = rank beyond what the spec describes."""
    return max(leaf.ndim - len(spec.storage), 0)


def effective_ndim(spec: ParamSpec, leaf) -> int:
    return leaf.ndim - n_stack_axes(spec, leaf)


def selected(omc: OMCConfig, path: str, spec: ParamSpec, leaf) -> bool:
    """Weights-only policy with stacked-axis awareness (paper §2.4)."""
    if not omc.enabled:
        return False
    if not isinstance(leaf, torch.Tensor) or not leaf.is_floating_point():
        return False
    if omc.policy.weights_only and effective_ndim(spec, leaf) < omc.policy.min_ndim:
        return False
    return omc.policy.selects_name(path, leaf.numel())


def compress_params(params, specs, omc: OMCConfig):
    """f32 tree -> storage tree (selected leaves CompressedVariable).

    ``specs`` and ``params`` share one structure; the CUDA path compresses
    each selected leaf with one ``quantize_stats`` launch.
    """

    def f(path, spec, leaf):
        if selected(omc, path_str(path), spec, leaf):
            return compress_variable(leaf, omc.fmt, pvt=omc.pvt,
                                     batch_axes=n_stack_axes(spec, leaf))
        return leaf

    return tree_map_with_path(f, specs, params)


def state_bytes_report(params) -> Dict[str, Any]:
    """Byte accounting over the actual storage tree (paper's memory columns)."""
    total = dict(fp32_bytes=0, container_bytes=0, packed_bytes=0,
                 num_params=0, num_compressed=0)
    for _, leaf in tree_items(params):
        if is_compressed(leaf):
            n = leaf.size
            total["num_params"] += n
            total["num_compressed"] += n
            total["fp32_bytes"] += 4 * n
            total["container_bytes"] += (
                n * leaf.fmt.container_bytes_per_value + 8 * leaf.s.numel())
            total["packed_bytes"] += packing.packed_bytes(n, leaf.fmt) + 8 * leaf.s.numel()
        elif isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            n = leaf.numel()
            total["num_params"] += n
            total["fp32_bytes"] += 4 * n
            total["container_bytes"] += 4 * n
            total["packed_bytes"] += 4 * n
    total["container_ratio"] = total["container_bytes"] / max(total["fp32_bytes"], 1)
    total["packed_ratio"] = total["packed_bytes"] / max(total["fp32_bytes"], 1)
    return total
