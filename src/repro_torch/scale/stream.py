"""Fixed-capacity cohort streaming (port of ``repro.scale.stream``, DESIGN.md §14).

The engine's round holds the whole cohort's stacked client models at once,
so "cohort = the population" is out of reach.  The streamed round feeds
arbitrarily many chunks of at most ``capacity`` clients through one
*partial-aggregate* function, each returning only the weighted **sums**
(``Σ w·model``, ``Σ w``, ``Σ w·loss``), which the caller accumulates.  Peak
live bytes are then ``O(capacity)`` per chunk plus one accumulator tree,
whatever the number of clients streamed (the
:class:`repro_torch.federated.accounting.StreamLedger` bound, measured in
``benchmarks_torch/population_scale.py``).

Padding contract, as the reference's: a short final chunk repeats its first
client in the pad lanes with weight 0; dead rows are zeroed with ``where``
*before* the weighted sum, so a diverged dead client (NaN update) cannot
poison the partials.  The reference trains every lane of its padded
``vmap``; the port trains a chunk's real lanes in one call of the batched
body its engine and async runtime run
(:func:`repro_torch.federated.simulate.make_batch_client_fn`) and skips the
pad lanes, which it knows because cohort ids are distinct (a lane repeating
an earlier lane's client is a pad).  The partial sums add lane after lane
from +0, so a pad lane's ``+0`` term would leave them unchanged: they are
the same bits with the pads trained or skipped (ROADMAP C22).

``fused_agg=True`` mirrors the fused engine's transport semantics (§13):
each compressed variable's chunk stack is transport-encoded
(:func:`repro_torch.federated.engine.transport_encode_stacked`: one
``quantize_stats`` launch, or ``quantize`` with PVT off) and decoded (one
``dequantize``) before the partial sum, so the streamed result carries the
fused round's one quantization step per upload while partials stay f32
(re-quantization happens once, at the root, :mod:`.hierarchy`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.omc import OMCConfig
from repro_torch.core.store import CompressedVariable, decompress_tree, is_compressed
from repro_torch.core.tree import tree_map_with_path
from repro_torch.federated import engine, simulate
from repro_torch.federated.simulate import SimConfig
from repro_torch.federated.state import n_stack_axes
from repro_torch.obs import metrics as obs_metrics


def pad_chunk(client_ids, alive, capacity: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a (possibly short) chunk to the fixed width.

    Returns ``(cids int32[capacity], w float32[capacity])``: pad lanes
    repeat the chunk's first (real) client with weight 0 and contribute
    exactly nothing to the partial sums.
    """
    ids = np.asarray(client_ids, np.int64)
    a = np.asarray(alive, bool)
    if ids.size == 0 or ids.size > capacity:
        raise ValueError(f"chunk must hold 1..{capacity} clients, got {ids.size}")
    pad = capacity - ids.size
    cids = np.concatenate([ids, np.full((pad,), ids[0], np.int64)])
    w = np.concatenate([a.astype(np.float32), np.zeros((pad,), np.float32)])
    return cids.astype(np.int32), w


def trained_lanes(cids) -> list:
    """The lanes a chunk trains: each client's first lane; a later lane
    repeating a client is a pad (cohort ids are distinct)."""
    seen, lanes = set(), []
    for i, c in enumerate(cids):
        if c not in seen:
            seen.add(c)
            lanes.append(i)
    return lanes


def lane_sum(terms, zero: torch.Tensor) -> torch.Tensor:
    """``Σ terms`` added one after another from +0: a ``+0`` term (a weight-0
    lane) leaves the sum's bits as they were."""
    acc = torch.zeros_like(zero)
    for t in terms:
        acc = acc + t
    return acc


def partial_sums(specs, storage, stacked, losses: torch.Tensor, w: torch.Tensor,
                 omc: OMCConfig, fused_agg: bool = False):
    """``(Σ w·model tree, Σ w, Σ w·loss, masked stack)`` of a chunk's trained
    lanes (``stacked`` ``[L, ...]``, ``losses`` and ``w`` ``[L]`` on the
    device).  Dead rows (``w == 0``) are zeroed in place first; with
    ``fused_agg`` each compressed variable's stack goes through the
    transport encode and its decode before the sum."""
    mask = w > 0
    engine.zero_dead_rows_(stacked, mask)
    wl = w.unbind(0)

    def leaf(path, spec_t, srv, x):
        if fused_agg and is_compressed(srv):
            # transport-encode each upload row (§13): the one RNE step the
            # fused round's compressed-domain path applies
            codes, s, b = engine.transport_encode_stacked(
                x, srv.fmt, omc.pvt, n_stack_axes(spec_t, srv.codes))
            if not omc.pvt:
                s = s.reshape((-1,) + (1,) * (x.ndim - 1))
                b = b.reshape((-1,) + (1,) * (x.ndim - 1))
            x = CompressedVariable(codes, s, b, srv.fmt).dequantize()
        return lane_sum((x[i] * wl[i] for i in range(x.shape[0])), x[0])

    wsum = tree_map_with_path(leaf, specs, storage, stacked)
    zero = torch.zeros((), dtype=torch.float32, device=w.device)
    loss_terms = torch.where(mask, losses, zero) * w
    return (wsum, lane_sum(wl, zero), lane_sum(loss_terms.unbind(0), zero), stacked)


def make_stream_fn(family, cfg, specs, omc: OMCConfig, sim: SimConfig, data_fn,
                   capacity: int, *, strategy=None, ste: bool = False, fused_agg: bool = False,
                   takes_residual: Optional[bool] = None, collect_metrics: bool = False):
    """Build the fixed-capacity partial-aggregate function.

    ``(storage, cids[cap], w[cap], round_index) -> (wsum_tree, wtot,
    loss_wsum)``, all on the storage's device; with error feedback
    (``takes_residual``) a residual-rows dict ``{name: [cap, ...]}`` rides
    as a fifth argument and comes back, updated in place for the trained
    lanes, as a fourth output (the caller scatters only the real, alive
    lanes, ``PopulationStore.scatter_ef``).

    The client body is
    :func:`repro_torch.federated.simulate.make_batch_client_fn`, the one the
    engine and the async runtime run, over the chunk's real lanes at once;
    ``data_fn(client, round, step)`` draws each lane's batches.  One
    function serves every chunk of every shard of every round.

    ``collect_metrics=True`` (DESIGN.md §15) appends the chunk's metric
    *partial* bundle (``update_sq_wsum``) as the last output; the caller
    folds chunk partials with ``obs.metrics.fold_partial_bundles``.  The
    main outputs are the same bits either way.  The function carries its
    ``collect_metrics`` as an attribute, checked by the round (ROADMAP C21).
    """
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    if fused_agg and (strategy is not None or not omc.enabled):
        raise ValueError("fused_agg=True needs OMC enabled and no zoo strategy "
                         "(DESIGN.md §13/§14)")
    if takes_residual is None:
        takes_residual = simulate.ef_lib.takes_residual(omc, strategy)
    many = simulate.make_batch_client_fn(family, cfg, specs, omc, sim, strategy, ste,
                                         takes_residual=takes_residual)

    def stream_fn(storage, cids, w, round_index, ef_rows=None):
        if takes_residual and ef_rows is None:
            raise ValueError("this stream trains under an error-feedback strategy: pass the "
                             "chunk's residual rows")
        cids = [int(c) for c in torch.as_tensor(cids).reshape(-1).tolist()]
        if len(cids) != capacity:
            raise ValueError(f"chunk has {len(cids)} lanes, the stream's capacity is {capacity}")
        r = int(round_index)
        with torch.no_grad():
            server_f32 = decompress_tree(storage)
        lanes = trained_lanes(cids)
        ids = [cids[i] for i in lanes]
        batches = simulate.cohort_batches(data_fn, ids, [r] * len(ids), sim.local_steps)
        if takes_residual:
            stacked, losses, rows = many(server_f32, batches, [r] * len(ids), ids,
                                         {k: v[lanes] for k, v in ef_rows.items()})
            with torch.no_grad():
                for k, v in ef_rows.items():
                    v[lanes] = rows[k].to(v.device)
            del rows
        else:
            stacked, losses, _ = many(server_f32, batches, [r] * len(ids), ids)
        with torch.no_grad():
            w_t = torch.as_tensor(w, dtype=torch.float32).to(losses.device)[lanes]
            wsum, wtot, loss_wsum, masked = partial_sums(specs, storage, stacked, losses, w_t,
                                                         omc, fused_agg)
            out = (wsum, wtot, loss_wsum) + ((ef_rows,) if takes_residual else ())
            if collect_metrics:
                out += (obs_metrics.chunk_partial_bundle(server_f32, masked, w_t),)
        return out

    stream_fn.collect_metrics = collect_metrics
    return stream_fn


def iter_chunks(positions: np.ndarray, capacity: int):
    """Yield fixed-capacity slices of a shard's cohort positions."""
    for i in range(0, len(positions), capacity):
        yield positions[i:i + capacity]
