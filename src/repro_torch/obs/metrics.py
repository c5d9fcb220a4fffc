"""Round metric bundles, built after a round returns (port of
``repro.obs.metrics``, DESIGN.md §15).

A **metric bundle** is a flat ``{name: 0-d f32 tensor}`` dict computed from
a round's ordinary outputs.  What makes it safe to leave on:

  * the round itself never gains metric math: with ``collect_metrics=True``
    it only hands back the cohort mean it already computed, and every
    statistic here runs *after* the round returns, eagerly, on the tensors'
    own device (on the card the two decodes of old and new storage are B2
    ``dequantize`` launches), so the stored tree is the same bits with a
    handle on or off;
  * nothing crosses to the host inside the round: a bundle moves once per
    round or flush, in one transfer (:func:`finalize_bundle`), and the
    host-side :class:`MetricsSink` folds it into a record.

Bundle keys (the schema ``repro_torch.obs.report`` reads, the reference's):

  * ``loss`` / ``alive``: the round's weighted loss and survivor count;
  * ``update_norm``: L2 of the applied server step (new - old, f32 view);
  * ``qerr_norm``: L2 of the server's requantization error, what the
    re-compress threw away this round (``qerr/<var>`` per leaf), only where
    an f32 cohort mean exists (the unfused paths);
  * ``ef_norm``: L2 of the cohort's error-feedback residual rows (training
    under an EF strategy, DESIGN.md §12).

The bundle is built one leaf at a time, each decoded leaf dropped once
used, so it holds one leaf's old, new and ideal f32 values at a time, not
the whole trees.  Sums run in the reference's leaf order; the reductions
inside a leaf run in torch's order, not XLA's, so norms agree with the
reference's to f32 rounding, not in bits (ROADMAP C19).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.core.policy import path_str
from repro_torch.core.store import is_compressed
from repro_torch.core.tree import tree_items

Bundle = Dict[str, torch.Tensor]


def _f32(leaf) -> torch.Tensor:
    return (leaf.dequantize() if is_compressed(leaf) else leaf).to(torch.float32)


def _zero(tree) -> torch.Tensor:
    for _, leaf in tree_items(tree):
        return torch.zeros((), dtype=torch.float32, device=leaf.device)
    return torch.zeros((), dtype=torch.float32)


def tree_sq_sum(tree) -> torch.Tensor:
    """Σ x² over every leaf of an f32 tree (0-d f32), leaf by leaf in the
    tree's order."""
    tot = _zero(tree)
    for _, x in tree_items(tree):
        tot = tot + torch.sum(torch.square(x.to(torch.float32)))
    return tot


def server_round_bundle(specs, old, new_storage, mean_model, server_lr: float, *,
                        per_leaf: bool = True) -> Bundle:
    """The bundle of one server round (any path: loop, engine, async).

    ``old`` is the pre-round server tree, compressed storage or f32; it is
    decoded here, leaf by leaf.  ``mean_model`` is the f32 cohort mean the
    server interpolated toward: the *ideal* new state is
    ``old + lr·(mean − old)``, so ``qerr`` measures exactly the error the
    re-compress introduced.  ``mean_model=None`` (the compressed-domain
    rounds and flushes, which never form a mean) gives the update norm
    alone.  ``specs`` names the leaves, as in the reference.
    """
    del specs  # the storage trees carry the same paths
    with torch.no_grad():
        olds = dict(tree_items(old))
        means = dict(tree_items(mean_model)) if mean_model is not None else None
        upd_sq = qerr_sq = _zero(new_storage)
        per: Dict[str, torch.Tensor] = {}
        for path, srv in tree_items(new_storage):
            new_leaf, old_leaf = _f32(srv), _f32(olds[path])
            upd_sq = upd_sq + torch.sum(torch.square(new_leaf - old_leaf))
            if means is not None and is_compressed(srv):
                # exact leaves: their requantization error is identically 0
                ideal = old_leaf + server_lr * (means[path] - old_leaf)
                sq = torch.sum(torch.square(new_leaf - ideal))
                del ideal
                qerr_sq = qerr_sq + sq
                if per_leaf:
                    per[f"qerr/{path_str(path)}"] = torch.sqrt(sq)
            del new_leaf, old_leaf
        out: Bundle = {"update_norm": torch.sqrt(upd_sq)}
        if means is None:
            return out
        out.update(per)
        out["qerr_norm"] = torch.sqrt(qerr_sq)
        return out


def ef_rows_norm(rows: Optional[Dict[str, torch.Tensor]]) -> torch.Tensor:
    """L2 over a cohort's error-feedback residual rows (0 when EF is off)."""
    if not rows:
        return torch.zeros((), dtype=torch.float32)
    with torch.no_grad():
        return torch.sqrt(tree_sq_sum(rows))


def chunk_partial_bundle(server_f32, stacked_masked, w: torch.Tensor) -> Bundle:
    """A streamed round's partials (DESIGN.md §14): per-chunk weighted sums.

    ``update_sq_wsum`` is ``Σ_c w_c·‖model_c − server‖²``, the cohort's
    update dispersion; a client of weight 0 counts 0, whatever its row
    holds.  :func:`fold_partial_bundles` reduces the chunks."""
    with torch.no_grad():
        tot = _zero(server_f32)
        for (_, s), (_, x) in zip(tree_items(server_f32), tree_items(stacked_masked)):
            wb = w.to(x.device).reshape((-1,) + (1,) * (x.ndim - 1))
            d = x - torch.where(wb > 0, s[None], torch.zeros((), dtype=x.dtype, device=x.device))
            tot = tot + torch.sum(torch.square(d) * wb)
        return {"update_sq_wsum": tot}


def fold_partial_bundles(acc: Optional[Bundle], part: Bundle) -> Bundle:
    if acc is None:
        return dict(part)
    return {k: acc[k] + part[k] for k in acc}


def finalize_bundle(bundle: Bundle) -> Dict[str, float]:
    """Host side: a device bundle as plain floats, in its key order.

    The scalars of each device are stacked and moved in one transfer (one
    on the card), not fetched one ``.item()`` a key."""
    out: Dict[str, Any] = {}
    by_device: Dict[torch.device, list] = {}
    for k, v in bundle.items():
        by_device.setdefault(v.device, []).append(k)
    for keys in by_device.values():
        # f64 holds every f32 (and every small count) exactly
        host = torch.stack([bundle[k].detach().reshape(()).to(torch.float64)
                            for k in keys]).cpu().tolist()
        out.update(zip(keys, host))
    return {k: out[k] for k in bundle}


class MetricsSink:
    """Host-side fold of per-round and per-event records.

    One sink a run.  ``record(kind, ...)`` appends a plain-dict record
    (a bundle is turned into floats here, its one device-to-host transfer);
    :meth:`records` hands the ordered list to the exporters.  The sink never
    feeds anything back into training."""

    def __init__(self) -> None:
        self._records: list = []

    def __len__(self) -> int:
        return len(self._records)

    def record(self, kind: str, bundle: Optional[Bundle] = None,
               **fields: Any) -> Dict[str, Any]:
        rec: Dict[str, Any] = {"kind": str(kind)}
        rec.update(fields)
        if bundle:
            rec.update(finalize_bundle(bundle))
        self._records.append(rec)
        return rec

    def records(self, kind: Optional[str] = None) -> list:
        if kind is None:
            return list(self._records)
        return [r for r in self._records if r.get("kind") == kind]
