"""Per-client error-feedback residuals (port of ``repro.compress.feedback``,
DESIGN.md §12).

Sparse upload strategies (top-k, ternary, the top-k pipeline) drop most of
a client's update on every send.  Error feedback (Konečný et al., arxiv
1610.05492) keeps what the compressor dropped in a residual ``e`` and adds
it back before the next send::

    comp  = delta + e          # compensated update
    sent  = qdq(comp)          # what travels
    e'    = comp - sent        # carried to the client's next round

so that ``sent + e' == comp`` (exact for f32 top-k; one rounding step
otherwise, and subnormal differences are flushed by XLA on the reference's
CPU side, ROADMAP C1).  Dense strategies drop nothing worth keeping: they
never allocate a residual.

The residual state is one dict per population, keyed by the selected
variables' paths in ``accounting.walk_selected`` order (the PPQ mask
order), each ``f32[num_clients, *shape]`` on the parameters' device.  The
loop, the engine and the async runtime share the layout, and the async
checkpoint carries it.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.omc import OMCConfig

from .base import CompressionStrategy


def takes_residual(omc: OMCConfig, strategy: Optional[CompressionStrategy]) -> bool:
    """True when training under ``strategy`` threads a residual: a strategy is
    given, OMC selects variables (``omc.enabled``), and the strategy is a
    sparse upload-direction compressor with error feedback on."""
    return (strategy is not None and omc.enabled and strategy.upload_only
            and bool(strategy.error_feedback))


def init_ef_state(params_f32, specs, omc: OMCConfig,
                  num_clients: int) -> Dict[str, torch.Tensor]:
    """Zeroed residuals: ``{selected path: f32[num_clients, *shape]}``."""
    from repro_torch.federated import accounting

    sel, _ = accounting.walk_selected(params_f32, specs, omc)
    return {name: torch.zeros((int(num_clients),) + tuple(leaf.shape), dtype=torch.float32,
                              device=leaf.device)
            for name, _, leaf in sel}


def gather_rows(ef: Dict[str, torch.Tensor], client_ids) -> Dict[str, torch.Tensor]:
    """The residual rows of ``client_ids`` (an int, a list or an int tensor)."""
    return {k: v[client_ids] for k, v in ef.items()}


def scatter_rows(ef: Dict[str, torch.Tensor], client_ids,
                 rows: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A new population state with ``rows`` written at ``client_ids`` (which
    must be unique); ``ef`` itself is left as it was."""
    out = {}
    for k, v in ef.items():
        out[k] = v.clone()
        out[k][client_ids] = rows[k]
    return out


def ef_bytes(ef: Optional[Dict[str, torch.Tensor]]) -> int:
    """Client-state memory the residuals take (f32)."""
    if not ef:
        return 0
    return sum(4 * v.numel() for v in ef.values())


def ef_norms(ef: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Per-variable L2 norm over the whole population."""
    return {k: float(torch.sqrt(torch.sum(torch.square(v)))) for k, v in ef.items()}


def total_norm(ef: Optional[Dict[str, torch.Tensor]]) -> float:
    if not ef:
        return 0.0
    return float(torch.sqrt(sum(torch.sum(torch.square(v)) for v in ef.values())))


def compensate_leaf(strategy: CompressionStrategy, delta, residual, mask_bit, *,
                    batch_axes: int = 0, ste: bool = False, client_axis: bool = False):
    """One variable's send rule: ``(sent, new_residual)``.  With the client's
    PPQ bit unset the variable travels f32: the compensated update arrives
    exactly and the residual drains to 0.  With ``client_axis`` the leading
    axis holds C clients (counted in ``batch_axes``) and ``mask_bit`` is
    their ``bool[C]`` bits: each row as a call on its own would give."""
    comp = delta + residual
    qdq = strategy.train_qdq_ste_leaf if ste else strategy.train_qdq_leaf
    if client_axis:
        bits = torch.as_tensor(mask_bit, dtype=torch.bool)
        sent = comp
        if bool(bits.any()):
            sent = torch.where(bits.to(comp.device).reshape((-1,) + (1,) * (comp.ndim - 1)),
                               qdq(comp, batch_axes=batch_axes, client_axis=True), comp)
    else:
        sent = qdq(comp, batch_axes=batch_axes) if bool(mask_bit) else comp
    return sent, comp - sent
