"""Two-level tree aggregation over a sharded population (port of
``repro.scale.hierarchy``, DESIGN.md §14).

The flat engine aggregates a round in one reduction over the stacked
cohort.  At population scale the cohort's members live in different shards
(:class:`repro_torch.scale.store.ShardLayout`), so aggregation goes
through a two-level tree instead:

  * **leaves**: each shard streams its cohort members through the
    fixed-capacity partial-aggregate function
    (:func:`repro_torch.scale.stream.make_stream_fn`), producing the shard's
    weighted sums ``(Σ w·model, Σ w, Σ w·loss)``;
  * **root**: the sums are added and normalized **once**
    (``mean = Σ w·x / max(Σ w, 1e-9)``, algebraically
    ``cohort.aggregate_weighted`` on the flat stack), then the ordinary
    server step runs (``engine.apply_server_step``: interpolate toward the
    mean with ``sim.server_lr`` and re-compress, the helper the engine's
    unfused round uses).  The root is unfused under ``fused_agg`` too, as
    in the reference: its decode is ``dequantize`` and its re-compress
    ``quantize_stats``, never ``fused_aggregate``.

Equivalence contract: with the same key and round the sharded round draws
the same cohort and survival mask as ``engine.run_round_vectorized`` (both
defer to :mod:`repro_torch.federated.cohort`), and its tree matches the
flat round's within one quantization step: f32 reassociation across chunk
and shard boundaries and, under ``fused_agg``, the one transport RNE per
upload of the fused round.  Wire ledgers are exact: the bytes a client
uploads do not depend on which shard aggregates it
(``engine.round_wire_metrics``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.omc import OMCConfig
from repro_torch.core.store import decompress_tree
from repro_torch.core.tree import tree_items, tree_map
from repro_torch.federated import accounting
from repro_torch.federated import cohort as cohort_lib
from repro_torch.federated import engine, simulate
from repro_torch.federated.simulate import SimConfig
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import null_span

from .store import PopulationStore, ShardLayout
from .stream import iter_chunks, make_stream_fn, pad_chunk


def tree_aggregate(stacked, weights, num_shards: int):
    """The two-level weighted mean alone (the tree-aggregation algebra).

    Splits the leading client axis into ``num_shards`` contiguous balanced
    groups (the :class:`ShardLayout` rule), takes per-group weighted sums,
    then adds them at the root and normalizes once.  Equals
    ``cohort.aggregate_weighted`` up to f32 reassociation.
    """
    w = torch.as_tensor(weights, dtype=torch.float32)
    starts = ShardLayout(int(w.shape[0]), num_shards).starts
    wtot = torch.clamp(w.sum(), min=1e-9)

    def leaf(x):
        wx = w.to(x.device)
        parts = []
        for i in range(num_shards):
            lo, hi = int(starts[i]), int(starts[i + 1])
            parts.append((x[lo:hi] * wx[lo:hi].reshape((-1,) + (1,) * (x.ndim - 1))).sum(0))
        root = parts[0]
        for p in parts[1:]:
            root = root + p
        return root / wtot.to(x.device)

    return tree_map(leaf, stacked)


def make_root_fn(specs, omc: OMCConfig, sim: SimConfig):
    """Root combine: ``(storage, wsum_tree, wtot) -> new storage``.

    Normalizes the accumulated partial sums into the cohort mean and applies
    the engine's server step (``engine.apply_server_step``: interpolation
    with ``sim.server_lr`` and the policy's re-compress), one
    re-quantization a round.  The round's metric bundle is built by
    :func:`run_round_sharded` from the same ``wsum``/``wtot``, so this
    function is the same with metrics on or off.
    """

    def root_fn(storage, wsum, wtot):
        with torch.no_grad():
            server_f32 = decompress_tree(storage)
            mean = tree_map(lambda p: p / torch.clamp(wtot, min=1e-9), wsum)
            return engine.apply_server_step(server_f32, mean, specs, omc, sim.server_lr)

    return root_fn


def _add_trees(a, b):
    if a is None:
        return b
    return tree_map(torch.add, a, b)


def run_round_sharded(family, cfg, specs, omc: OMCConfig, sim: SimConfig, server_params,
                      data_fn, plan: cohort_lib.CohortPlan, layout: ShardLayout,
                      round_index: int, key: prng.Key, *, capacity: Optional[int] = None,
                      stream_fn=None, root_fn=None, strategy=None, ste: bool = False,
                      fused_agg: bool = False, store: Optional[PopulationStore] = None,
                      wire_table: Optional[accounting.WireTable] = None,
                      ledger: Optional[accounting.StreamLedger] = None,
                      on_chunk: Optional[Callable[[int, int, int], None]] = None,
                      obs=None) -> Tuple[Any, Dict[str, Any]]:
    """One tree-aggregated round over a sharded population.

    Samples the cohort the flat engine would (``cohort.sample_cohort`` and
    ``survival_mask`` under the same key), groups members by their owning
    shard, streams each shard's members through the fixed-capacity function
    in ``capacity``-sized chunks, and root-combines the partials.  Returns
    ``(new server storage, metrics)``: the engine's metric keys plus
    ``shards`` / ``chunks`` / ``stream_capacity``.

    ``store`` supplies per-client state: error-feedback rows are gathered
    per chunk and scattered back alive-masked (re-encoded when the store
    packs them), and its counters advance.  ``ledger`` (an
    ``accounting.StreamLedger``) records the streaming; ``on_chunk(shard,
    n_real, chunk_index)`` is an instrumentation hook (the population
    benchmark samples device bytes from it).

    ``obs`` (DESIGN.md §15): chunk metric partials fold across shards and
    the round's bundle is built after the root from the same
    ``wsum``/``wtot``; a cached ``stream_fn`` built with another
    ``collect_metrics`` than the round asks for raises ``ValueError``
    (ROADMAP C21).
    """
    takes_ef = simulate.ef_lib.takes_residual(omc, strategy)
    if plan.num_clients != layout.num_clients:
        raise ValueError(f"plan covers {plan.num_clients} clients but the layout shards "
                         f"{layout.num_clients}")
    if takes_ef and (store is None or not store.has_ef):
        raise ValueError(f"strategy {strategy.label!r} uses error feedback: pass a "
                         f"PopulationStore with init_ef() applied (DESIGN.md §14)")
    collect = obs is not None and obs.collect_metrics
    if capacity is None:
        capacity = min(plan.cohort_size, 64)
    if stream_fn is None:
        stream_fn = make_stream_fn(family, cfg, specs, omc, sim, data_fn, capacity,
                                   strategy=strategy, ste=ste, fused_agg=fused_agg,
                                   collect_metrics=collect)
    elif getattr(stream_fn, "collect_metrics", False) != collect:
        raise ValueError(f"stream_fn was built with collect_metrics="
                         f"{getattr(stream_fn, 'collect_metrics', False)} but this round "
                         f"{'collects' if collect else 'does not collect'} metrics: build it "
                         f"with make_stream_fn(collect_metrics={collect})")
    if root_fn is None:
        root_fn = make_root_fn(specs, omc, sim)

    ids = cohort_lib.sample_cohort(key, plan, round_index)
    alive = cohort_lib.survival_mask(key, plan, round_index)
    ids_np = ids.numpy().astype(np.int64)
    alive_np = alive.numpy().astype(bool)
    shard_of = layout.shard_of(ids_np)

    wsum = wtot = loss_wsum = None
    chunk_bundles = None
    n_chunks = shards_used = 0
    for shard in range(layout.num_shards):
        pos = np.flatnonzero(shard_of == shard)
        if pos.size == 0:
            continue
        shards_used += 1
        for chunk_pos in iter_chunks(pos, capacity):
            cids, w = pad_chunk(ids_np[chunk_pos], alive_np[chunk_pos], capacity)
            n_real = int(chunk_pos.size)
            if takes_ef:
                res = stream_fn(server_params, cids, w, round_index, store.gather_ef(cids))
                new_rows = res[3]
                store.scatter_ef(cids[:n_real], {k: v[:n_real] for k, v in new_rows.items()},
                                 mask=alive_np[chunk_pos])
                del new_rows
            else:
                res = stream_fn(server_params, cids, w, round_index)
            pw, pwt, pl = res[:3]
            if collect:
                chunk_bundles = obs_metrics.fold_partial_bundles(chunk_bundles, res[-1])
            del res
            wsum = _add_trees(wsum, pw)
            wtot = pwt if wtot is None else wtot + pwt
            loss_wsum = pl if loss_wsum is None else loss_wsum + pl
            del pw
            n_chunks += 1
            if ledger is not None:
                ledger.on_chunk(n_real)
            if on_chunk is not None:
                on_chunk(shard, n_real, n_chunks)

    new_storage = root_fn(server_params, wsum, wtot)
    n_alive = int(alive_np.sum())
    loss = float(loss_wsum / torch.clamp(wtot, min=1.0))
    bundle = None
    if collect:
        # built after the root, on the host's schedule, from the same
        # accumulators the root consumed (DESIGN.md §15)
        with torch.no_grad():
            mean = tree_map(lambda p: p / torch.clamp(wtot, min=1e-9), wsum)
            bundle = obs_metrics.server_round_bundle(specs, server_params, new_storage, mean,
                                                     sim.server_lr)
        bundle["loss"] = torch.tensor(loss, dtype=torch.float32)
        bundle["alive"] = torch.tensor(float(n_alive), dtype=torch.float32)
        if chunk_bundles is not None:
            bundle.update(chunk_bundles)
    del wsum
    if store is not None:
        store.note_round(ids_np, alive_np)
    metrics: Dict[str, Any] = dict(loss=loss, cohort=n_alive,
                                   dropped=int(plan.cohort_size - n_alive), shards=shards_used,
                                   chunks=n_chunks, stream_capacity=int(capacity))
    if wire_table is not None:
        metrics.update(engine.round_wire_metrics(wire_table, omc, [omc], [ids], alive,
                                                 round_index, strategy=strategy))
    if obs is not None:
        obs.record("round", bundle, round=int(round_index), **metrics)
    return new_storage, metrics


def run_training_sharded(family, cfg, omc: OMCConfig, sim: SimConfig,
                         plan: cohort_lib.CohortPlan, layout: ShardLayout, data_fn,
                         init_key: prng.Key, num_rounds: int, *,
                         capacity: Optional[int] = None, strategy=None, ste: bool = False,
                         fused_agg: bool = False, store: Optional[PopulationStore] = None,
                         wire: bool = True, init_params=None,
                         log: Optional[Callable[[str], None]] = None, obs=None,
                         device="cuda"
                         ) -> Tuple[Any, List[Dict[str, Any]],
                                    Optional[accounting.StreamLedger]]:
    """Sharded mirror of ``engine.run_training_vectorized``.

    Builds the stream and root functions once, derives the round key with
    the same ``fold_in(init_key, 0xC047)`` as the flat paths (so every path
    samples the same cohorts from one seed), and returns ``(final storage,
    history, ledger)``.  Runs where ``init_params`` lie, else on ``device``
    (default the card).  A ``store`` is allocated when the strategy needs
    error feedback (f32 at rest, on the parameters' device: the equivalence
    mode); pass one to keep rows packed at rest or counters across calls.
    """
    specs = family.param_specs(cfg)
    params, storage = simulate.init_storage(family, cfg, omc, specs, init_key, init_params,
                                            device)
    if capacity is None:
        capacity = min(plan.cohort_size, 64)
    if simulate.ef_lib.takes_residual(omc, strategy) and store is None:
        store = PopulationStore(layout, device=next(tree_items(params))[1].device)
        store.init_ef(params, specs, omc)
    collect = obs is not None and obs.collect_metrics
    stream_fn = make_stream_fn(family, cfg, specs, omc, sim, data_fn, capacity,
                               strategy=strategy, ste=ste, fused_agg=fused_agg,
                               collect_metrics=collect)
    root_fn = make_root_fn(specs, omc, sim)
    table = accounting.build_wire_table(params, specs, omc) if wire else None
    del params
    ledger = accounting.StreamLedger(table, omc, capacity) if table is not None else None
    key = prng.fold_in(init_key, 0xC047)
    history: List[Dict[str, Any]] = []
    for r in range(num_rounds):
        with null_span(obs, "round", round=r):
            storage, metrics = run_round_sharded(
                family, cfg, specs, omc, sim, storage, data_fn, plan, layout, r, key,
                capacity=capacity, stream_fn=stream_fn, root_fn=root_fn, strategy=strategy,
                ste=ste, fused_agg=fused_agg, store=store, wire_table=table, ledger=ledger,
                obs=obs)
        history.append(dict(round=r, **metrics))
        if log and ((r + 1) % 10 == 0 or r == 0):
            log(f"round {r + 1}/{num_rounds}: " + ", ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in metrics.items()))
    return storage, history, ledger
