"""Online Model Compression configuration (paper §2), port of ``repro.core.omc``.

``OMCConfig`` bundles the format, PVT, the weights-only policy and partial
parameter quantization (PPQ).  ``effective_params`` is the simulation mode:
f32 weights pass through quantize→dequantize(+PVT) per (round, client) PPQ
mask.  The masks come from ``core.prng`` and equal the reference's.
``compress`` / ``decompress`` / ``bytes_report`` are the storage mode and
its byte accounting under one config (``core.store``).
"""

from __future__ import annotations

import dataclasses

import torch

from . import prng
from .formats import FloatFormat, value_quantize
from .partial import ppq_mask
from .policy import QuantizePolicy, path_str, quantizable_names
from .pvt import pvt_apply, pvt_solve, pvt_solve_rows
from .store import compress_tree, decompress_tree, tree_bytes_report
from .tree import tree_map_with_path

DEFAULT_POLICY = QuantizePolicy()


@dataclasses.dataclass(frozen=True)
class OMCConfig:
    """Configuration of Online Model Compression."""

    fmt: FloatFormat = FloatFormat(3, 7)  # S1E3M7 — the paper's 11-bit format
    pvt: bool = True
    quantize_fraction: float = 0.9  # PPQ; 1.0 = all selected vars quantized
    policy: QuantizePolicy = DEFAULT_POLICY
    ppq_seed: int = 1729  # deterministic PPQ stream

    @classmethod
    def parse(cls, fmt: str, **kw) -> "OMCConfig":
        return cls(fmt=FloatFormat.parse(fmt), **kw)

    @property
    def enabled(self) -> bool:
        return not self.fmt.is_identity or self.quantize_fraction < 1.0

    def ppq_key(self) -> prng.Key:
        return prng.PRNGKey(self.ppq_seed)


def qdq_pvt_leaf(v: torch.Tensor, cfg: OMCConfig, client_axis: bool = False) -> torch.Tensor:
    """quantize→dequantize one variable, with the PVT correction when on.

    One (s, b) for the whole tensor, stacked layers included (the reference
    solves it so, without batch axes).  With ``client_axis`` the leading
    axis holds C clients' copies of the variable, and each gets its own
    (s, b): the same bits as C calls on ``v[c]``."""
    vq = value_quantize(v, cfg.fmt)
    if not cfg.pvt:
        return vq
    if client_axis:
        s, b = pvt_solve_rows(v, vq)
        shape = (-1,) + (1,) * (v.ndim - 1)
        return pvt_apply(vq, s.reshape(shape), b.reshape(shape))
    s, b = pvt_solve(v, vq)
    return pvt_apply(vq, s, b)


def effective_params(params, cfg: OMCConfig, round_index: int = 0, client_id: int = 0):
    """Simulation-mode view of the params a client trains on: qdq(+PVT) of
    each policy-selected variable whose PPQ bit is set for (round, client)."""
    if not cfg.enabled:
        return params
    names = quantizable_names(params, cfg.policy)
    if not names:
        return params
    mask = ppq_mask(cfg.ppq_key(), round_index, client_id, len(names),
                    cfg.quantize_fraction).tolist()
    index = {n: i for i, n in enumerate(names)}

    def f(path, leaf):
        i = index.get(path_str(path))
        return qdq_pvt_leaf(leaf, cfg) if i is not None and mask[i] else leaf

    return tree_map_with_path(f, params)


def compress(params, cfg: OMCConfig):
    """Storage-mode compression of a parameter tree (full selection)."""
    return compress_tree(params, cfg.fmt, cfg.policy, pvt=cfg.pvt)


def decompress(ctree):
    return decompress_tree(ctree)


def bytes_report(params, cfg: OMCConfig):
    return tree_bytes_report(params, cfg.fmt, cfg.policy, fraction=cfg.quantize_fraction)
