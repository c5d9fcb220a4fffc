"""Server training state: compressed-at-rest parameters + optimizer state
(port of ``repro.federated.state``).

``init_state`` applies the OMC policy to a freshly initialized f32 parameter
tree (``compress_params``): selected variables become ``CompressedVariable``
(the paper's storage model — no persistent f32 master exists between
rounds; the decoded values are transient).  The number of PVT batch axes per
leaf (stacked layers) comes from the ParamSpec: stacked axes are exactly the
leading axes the spec does not describe.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.core import packing, prng
from repro_torch.core.omc import OMCConfig
from repro_torch.core.policy import path_str
from repro_torch.core.store import compress_variable, is_compressed
from repro_torch.core.tree import tree_items, tree_map, tree_map_with_path
from repro_torch.models.common import ParamSpec


@dataclasses.dataclass
class TrainState:
    """The reference's fields in its order (a checkpoint's leaf order)."""

    params: Any  # tree: CompressedVariable | f32 leaves
    opt_state: Any
    round: int
    rng: prng.Key

    def to(self, device) -> "TrainState":
        """A copy with every tensor (codes, (s, b), moments) on ``device``."""

        def move(x):
            if isinstance(x, dict):
                return {k: move(v) for k, v in x.items()}
            if isinstance(x, tuple) and hasattr(x, "_fields"):  # an optimizer state
                return type(x)(*map(move, x))
            return x.to(device) if hasattr(x, "to") else x

        return TrainState(move(self.params), move(self.opt_state), self.round, self.rng)


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


def init_state(key: prng.Key, family, cfg, omc: OMCConfig, server_opt,
               device="cuda") -> TrainState:
    """Initialize params (f32, on ``device``), compress per policy, set up
    the server optimizer over zeros shaped like the codes, as the reference
    does."""
    params = family.init(key, cfg, device)
    storage = compress_params(params, family.param_specs(cfg), omc) if omc.enabled else params
    del params
    opt_state = server_opt.init(tree_map(
        lambda v: torch.zeros(v.codes.shape, dtype=torch.float32, device=v.device)
        if is_compressed(v) else v, storage))
    return TrainState(params=storage, opt_state=opt_state, round=0,
                      rng=prng.fold_in(key, 0xF3D))


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
