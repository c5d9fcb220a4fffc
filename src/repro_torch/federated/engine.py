"""Vectorized heterogeneous-cohort engine (port of ``repro.federated.engine``).

The reference runs a whole round as one jitted XLA program that ``vmap``s
the single-client body (``simulate.make_client_fn``) over the cohort, or
``lax.map``s it over blocks of ``client_chunk`` clients to bound memory.
The port does the same with the batched body
(``simulate.make_batch_client_fn``): each tier's invited clients train in
one call (``client_chunk=None``, the default) or in blocks of
``client_chunk``, each block one forward and backward pass over ``[k, ...]``
stacks, and the blocks' models go into the rows of the cohort's ``[C, ...]``
stacks for the server half.  ``client_chunk=1`` runs the one-client body
client after client, the serial path the batched one is held against.

Semantics kept from the reference:

  * the cohort, survival mask, PPQ masks and data stream are the loop's
    (``core.prng`` equals ``jax.random``), so with one default tier the
    engine and ``simulate.run_training`` agree within reassociation and
    their ledgers to the byte;
  * dead clients are computed too, weighted 0, and their rows zeroed with
    ``where`` before any mean, so a diverged dead client cannot poison it;
  * ``finish`` decodes, averages, interpolates and re-compresses;
    ``finish_fused`` (``fused_agg=True``) transport-encodes each compressed
    leaf's stack and hands the encoded stacks to :func:`fused_server_step`
    (also the async runtime's fused flush): one ``ops.fused_aggregate``
    launch per compressed leaf; unselected leaves keep the f32 mean.

``strategy`` and ``ste`` train every tier's clients under a zoo
compressor (DESIGN.md §12), through the same bodies; under an
error-feedback strategy ``ef`` holds the population's residuals: a block
gathers its clients' ``[k, ...]`` rows before it trains and writes back
only its surviving clients' rows after (a dead client keeps its residual,
as in the reference).  A strategy runs the unfused server round:
``fused_agg=True`` with a strategy raises ``ValueError``, as in the
reference.  ``obs`` (a
``repro_torch.obs.Obs``, DESIGN.md §15) times each round in a wall span and
records it; with metrics on, the unfused round hands back the cohort mean
it already computed and the bundle is built from it after the round, so the
stored tree is the same bits as with ``obs=None``.  ``data_mode`` is
accepted for the reference's signature, and both modes draw each block's
batches on the host side, client after client.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.formats import FloatFormat
from repro_torch.core.omc import OMCConfig
from repro_torch.core.partial import ppq_mask
from repro_torch.core.policy import path_str
from repro_torch.core.pvt import pvt_from_sums
from repro_torch.core.store import (CompressedVariable, compress_variable, decompress_tree,
                                    is_compressed)
from repro_torch.core.tree import tree_map, tree_map_with_path
from repro_torch.kernels import ops as kernel_ops
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import null_span

from . import accounting
from . import cohort as cohort_lib
from . import simulate
from .simulate import SimConfig
from .state import compress_params, n_stack_axes


# ---------------------------------------------------------------------------
# Device profiles and cohort specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """One device tier: how its clients quantize compute and transport.
    ``None`` fields inherit the server's :class:`OMCConfig`."""

    name: str = "default"
    fmt: Optional[str] = None  # e.g. "S1E4M3"; None -> server format
    quantize_fraction: Optional[float] = None  # None -> server fraction

    def resolve(self, base: OMCConfig) -> OMCConfig:
        kw: Dict[str, Any] = {}
        if self.fmt is not None:
            kw["fmt"] = FloatFormat.parse(self.fmt)
        if self.quantize_fraction is not None:
            kw["quantize_fraction"] = float(self.quantize_fraction)
        return dataclasses.replace(base, **kw) if kw else base


PROFILES: Dict[str, DeviceProfile] = {
    "default": DeviceProfile(),
    "f32": DeviceProfile("f32", fmt="S1E8M23", quantize_fraction=1.0),
    "s1e3m7": DeviceProfile("s1e3m7", fmt="S1E3M7"),
    "s1e4m3": DeviceProfile("s1e4m3", fmt="S1E4M3"),
    "s1e4m14": DeviceProfile("s1e4m14", fmt="S1E4M14"),
}


def profile(name: str) -> DeviceProfile:
    try:
        return PROFILES[name]
    except KeyError:
        raise KeyError(f"unknown device profile {name!r}; known: {sorted(PROFILES)}") from None


@dataclasses.dataclass(frozen=True)
class CohortSpec:
    """A cohort plan plus its device-tier composition.

    With no ``tiers`` the cohort is homogeneous and samples exactly as the
    loop does.  With tiers, client ``i`` belongs to tier ``i % n_tiers`` and
    each round samples ``quotas[t]`` clients from tier ``t``.
    ``client_chunk`` is the reference's: ``None`` trains each tier's clients
    in one batched call (its pure ``vmap``), ``k`` in blocks of ``k`` (its
    ``lax.map`` of vmapped blocks: live memory bounded by ``k`` clients), and
    ``1`` one client after another through the one-client body.
    """

    plan: cohort_lib.CohortPlan
    tiers: Tuple[DeviceProfile, ...] = ()
    quotas: Optional[Tuple[int, ...]] = None  # default: even split
    client_chunk: Optional[int] = None

    def __post_init__(self):
        if self.tiers:
            n = len(self.tiers)
            if self.quotas is None:
                base, rem = divmod(self.plan.cohort_size, n)
                object.__setattr__(self, "quotas",
                                   tuple(base + (1 if t < rem else 0) for t in range(n)))
            if len(self.quotas) != n:
                raise ValueError("quotas must have one entry per tier")
            if sum(self.quotas) != self.plan.cohort_size:
                raise ValueError(f"quotas {self.quotas} must sum to cohort_size "
                                 f"{self.plan.cohort_size}")
            for t, q in enumerate(self.quotas):
                pop = self.tier_population(t).shape[0]
                if q > pop:
                    raise ValueError(f"tier {t} quota {q} exceeds its population {pop}")
        elif self.quotas is not None:
            raise ValueError("quotas given but no tiers")
        for q in self.group_sizes:
            if self.client_chunk and q > self.client_chunk and q % self.client_chunk:
                raise ValueError(f"client_chunk {self.client_chunk} must divide tier "
                                 f"quotas larger than it (got {q})")

    @property
    def n_tiers(self) -> int:
        return max(len(self.tiers), 1)

    @property
    def is_hetero(self) -> bool:
        return bool(self.tiers)

    @property
    def group_sizes(self) -> Tuple[int, ...]:
        return self.quotas if self.is_hetero else (self.plan.cohort_size,)

    def tier_population(self, t: int) -> np.ndarray:
        return np.arange(t, self.plan.num_clients, self.n_tiers, dtype=np.int32)

    def tier_omcs(self, base: OMCConfig) -> List[OMCConfig]:
        return [p.resolve(base) for p in (self.tiers or (DeviceProfile(),))]


def sample_tiered_cohort(key: prng.Key, spec: CohortSpec, round_index: int) -> List[torch.Tensor]:
    """Per-tier int64 id tensors on the host (concatenation order = the
    survival mask's order).  Homogeneous specs sample as the loop does."""
    if not spec.is_hetero:
        return [cohort_lib.sample_cohort(key, spec.plan, round_index)]
    k = prng.fold_in(key, round_index)
    out = []
    for t, q in enumerate(spec.quotas):
        pop = torch.from_numpy(spec.tier_population(t)).to(torch.int64)
        perm = prng.permutation(prng.fold_in(k, 0x7E0 + t), pop.shape[0])
        out.append(pop[perm[:q]])
    return out


# ---------------------------------------------------------------------------
# Compressed-domain (fused) aggregation
# ---------------------------------------------------------------------------


def fused_aggregation_supported(spec: CohortSpec, omc: OMCConfig, strategy=None) -> bool:
    """The fused server path needs a homogeneous cohort, OMC enabled and no
    compression strategy."""
    return omc.enabled and not spec.is_hetero and strategy is None


def transport_encode_stacked(stacked_leaf: torch.Tensor, fmt: FloatFormat, pvt: bool,
                             batch_axes: int):
    """Encode a ``[C, ...]`` stack of client uploads to transport form:
    ``(codes, s, b)`` with the client axis leading.

    With ``pvt`` one ``quantize_stats`` launch gives the codes and the PVT
    sums per (client, stacked entry), solved with the closed form (the
    reference's ``pvt_solve_fast`` with ``batch_axes + 1``).  Without it one
    ``quantize`` launch gives the codes and ``(s, b) = (1, 0)`` per client.
    Dead clients' rows may hold garbage; the fused kernel's
    ``where(w > 0, ·, 0)`` discards them exactly.
    """
    c = stacked_leaf.shape[0]
    if not pvt:
        ones = torch.ones((c,), dtype=torch.float32, device=stacked_leaf.device)
        return kernel_ops.quantize(stacked_leaf, fmt), ones, torch.zeros_like(ones)
    ba = batch_axes + 1
    codes, sums = kernel_ops.quantize_stats(stacked_leaf, fmt, ba)
    s, b = pvt_from_sums(sums, stacked_leaf[(0,) * ba].numel())
    shape = tuple(stacked_leaf.shape[:ba]) + (1,) * (stacked_leaf.ndim - ba)
    return codes, s.reshape(shape), b.reshape(shape)


# ---------------------------------------------------------------------------
# Server-side round algebra
# ---------------------------------------------------------------------------


def _alive_rows(alive: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return alive.to(x.device).reshape((-1,) + (1,) * (x.ndim - 1))


def mask_dead_rows(stacked, alive: torch.Tensor):
    """Zero dead clients' rows of a ``[C, ...]`` stack with ``where`` (NaN-safe
    FedAvg: ``0·inf`` would poison the mean); a ``CompressedVariable``'s
    codes, ``s`` and ``b`` alike, each in its own dtype."""

    def f(x):
        if is_compressed(x):
            return CompressedVariable(f(x.codes), f(x.s), f(x.b), x.fmt)
        return torch.where(_alive_rows(alive, x), x,
                           torch.zeros((), dtype=x.dtype, device=x.device))

    return tree_map(f, stacked)


def zero_dead_rows_(stacked, alive: torch.Tensor):
    """:func:`mask_dead_rows` in place, in the same bits (a dead row becomes
    +0, NaN and inf included), without a second copy of the stack."""
    dead = [i for i, ok in enumerate(alive.tolist()) if not ok]

    def f(x):
        if is_compressed(x):
            for t in (x.codes, x.s, x.b):
                f(t)
        else:
            for i in dead:
                x[i].zero_()
        return x

    return tree_map(f, stacked)


def apply_server_step(server_f32, mean_model, specs, omc: OMCConfig, server_lr: float):
    """Interpolate toward the cohort mean with ``server_lr`` and re-compress
    under the policy: the server half of every unfused round."""
    new_f32 = tree_map(lambda old, new: old + server_lr * (new - old), server_f32, mean_model)
    return compress_params(new_f32, specs, omc) if omc.enabled else new_f32


def fused_server_step(storage, stacked, w: torch.Tensor, specs, omc: OMCConfig,
                      server_lr: float):
    """The server half of every fused round: each compressed leaf of
    ``storage`` aggregates its stack of transport-encoded uploads
    (``stacked``'s ``CompressedVariable`` with a leading client axis) with
    one ``ops.fused_aggregate`` launch under weights ``w``; unselected
    leaves take the f32 weighted mean of their stack and the interpolation
    with ``server_lr``."""

    def f(path, spec_t, srv, stack):
        if is_compressed(srv):
            new_codes, s, b = kernel_ops.fused_aggregate(
                srv.codes, srv.s, srv.b, stack.codes, stack.s, stack.b, w, server_lr, srv.fmt,
                batch_axes=n_stack_axes(spec_t, srv.codes), pvt=omc.pvt)
            return CompressedVariable(new_codes, s, b, srv.fmt)
        mean = cohort_lib.aggregate_weighted(stack, w)
        return srv + server_lr * (mean - srv)

    return tree_map_with_path(f, specs, storage, stacked)


# ---------------------------------------------------------------------------
# The round
# ---------------------------------------------------------------------------


def make_round_fn(family, cfg, specs, omc: OMCConfig, sim: SimConfig, spec: CohortSpec,
                  data_fn: Callable[[int, int, int], Any], data_mode: str = "vmap",
                  strategy=None, ste: bool = False, fused_agg: bool = False,
                  collect_metrics: bool = False):
    """Build the engine's round:
    ``(storage, ids_per_tier, alive, round_index, ef=None) -> (new_storage,
    loss, n_alive)``.

    Server decompress, the clients of every tier (each drawing its batches
    from ``data_fn(client, round, step)``), the zero-weight FedAvg, the
    server step and the re-compress — or, with ``fused_agg``, the
    compressed-domain server round.  ``loss`` and ``n_alive`` are 0-d
    tensors on the device.  Under an error-feedback strategy the round
    takes the population's residuals ``ef`` and updates the surviving
    clients' rows in place.

    ``collect_metrics=True`` appends, as the round's **last** output, the
    cohort mean the unfused round already computed and interpolated toward
    (the same tensor, not a second reduction), and ``None`` on the fused
    path, which forms no f32 mean; nothing else in the round changes.
    """
    if data_mode not in ("vmap", "host"):
        raise ValueError(f"data_mode must be 'vmap' or 'host', got {data_mode!r}")
    if fused_agg and not fused_aggregation_supported(spec, omc, strategy):
        raise ValueError("fused_agg=True needs a homogeneous cohort, OMC enabled, and no "
                         "compression strategy")
    takes_ef = simulate.ef_lib.takes_residual(omc, strategy)
    make = simulate.make_client_fn if spec.client_chunk == 1 else simulate.make_batch_client_fn
    ones = [make(family, cfg, specs, omc_t, sim, strategy, ste, takes_residual=takes_ef)
            for omc_t in spec.tier_omcs(omc)]

    def losses_and_weights(loss_c, alive):
        w = alive.to(loss_c.device, torch.float32)
        loss_c = torch.where(alive.to(loss_c.device), loss_c, torch.zeros((), device=loss_c.device))
        n_alive = w.sum()
        return w, (loss_c * w).sum() / torch.clamp(n_alive, min=1.0), n_alive

    def finish(server_f32, stacked, loss_c, alive):
        w, loss, n_alive = losses_and_weights(loss_c, alive)
        mean_model = cohort_lib.aggregate_weighted(zero_dead_rows_(stacked, alive), w)
        new = apply_server_step(server_f32, mean_model, specs, omc, sim.server_lr)
        return (new, loss, n_alive) + ((mean_model,) if collect_metrics else ())

    def finish_fused(storage, stacked, loss_c, alive):
        w, loss, n_alive = losses_and_weights(loss_c, alive)

        def encode(path, spec_t, srv, stack):
            if is_compressed(srv):
                codes_c, s_c, b_c = transport_encode_stacked(
                    stack, srv.fmt, omc.pvt, n_stack_axes(spec_t, srv.codes))
                return CompressedVariable(codes_c, s_c, b_c, srv.fmt)
            # unselected leaves keep the f32 mean: dead rows zeroed first
            return zero_dead_rows_(stack, alive)

        encoded = tree_map_with_path(encode, specs, storage, stacked)
        new = fused_server_step(storage, encoded, w, specs, omc, sim.server_lr)
        return (new, loss, n_alive) + ((None,) if collect_metrics else ())

    def round_fn(storage, ids_per_tier, alive, round_index: int, ef=None):
        if takes_ef and ef is None:
            raise ValueError("this round trains under an error-feedback strategy: pass ef=")
        with torch.no_grad():
            server_f32 = decompress_tree(storage)
        alive_l = alive.tolist()
        # each block's models go into their rows of the cohort's stacks as
        # soon as they are trained, so the cohort's models are held once
        stacked, losses = None, []
        n = sum(len(ids_t) for ids_t in ids_per_tier)
        for one, ids_t in zip(ones, ids_per_tier):
            ids = ids_t.tolist()
            width = spec.client_chunk or max(len(ids), 1)
            for i in range(0, len(ids), width):
                block = ids[i:i + width]
                off = sum(x.numel() for x in losses)
                if spec.client_chunk == 1:
                    m, loss = train_one(one, server_f32, block[0], round_index, ef,
                                        alive_l[off])
                    with torch.no_grad():
                        stacked = simulate.stack_into(stacked, off, m, n)
                else:
                    m, loss = train_block(one, server_f32, block, round_index, ef,
                                          alive_l[off:off + len(block)])
                    with torch.no_grad():
                        stacked = simulate.stack_rows_into(stacked, off, m, n)
                del m
                losses.append(loss.reshape(-1))
        with torch.no_grad():
            if fused_agg:
                return finish_fused(storage, stacked, torch.cat(losses), alive)
            return finish(server_f32, stacked, torch.cat(losses), alive)

    def train_one(one, server_f32, cid, round_index, ef, alive_c):
        batches = simulate.client_batches(data_fn, cid, round_index, sim.local_steps)
        if not takes_ef:
            return one(server_f32, batches, round_index, cid)
        m, loss, rows = one(server_f32, batches, round_index, cid,
                            {k: v[cid] for k, v in ef.items()})
        if alive_c:  # a dead client keeps its residual
            for k, v in ef.items():
                v[cid] = rows[k]
        return m, loss

    def train_block(many, server_f32, block, round_index, ef, alive_b):
        rounds = [round_index] * len(block)
        batches = simulate.cohort_batches(data_fn, block, rounds, sim.local_steps)
        if not takes_ef:
            m, loss, _ = many(server_f32, batches, rounds, block)
            return m, loss
        m, loss, rows = many(server_f32, batches, rounds, block,
                             simulate.ef_lib.gather_rows(ef, block))
        keep = [j for j, ok in enumerate(alive_b) if ok]  # dead clients keep theirs
        if keep:
            with torch.no_grad():
                for k, v in ef.items():
                    v[[block[j] for j in keep]] = rows[k][keep].to(v.device)
        return m, loss

    round_fn.collect_metrics = collect_metrics
    return round_fn


def run_round_vectorized(family, cfg, specs, omc: OMCConfig, sim: SimConfig, server_params,
                         data_fn, spec: CohortSpec, round_index: int, key: prng.Key,
                         round_fn=None, wire_table: Optional[accounting.WireTable] = None,
                         data_mode: str = "vmap", strategy=None, ste: bool = False, ef=None,
                         fused_agg: bool = False, obs=None) -> Tuple[Any, Dict[str, float]]:
    """One round; returns ``(new server storage, metrics)``.  Dead clients
    contribute weight 0 (the same mean as dropping them); the server
    interpolates toward the cohort mean and re-compresses.  ``strategy``,
    ``ste`` and ``ef`` as in the loop (``simulate.run_round``): an EF
    strategy without ``ef`` raises ``ValueError``.

    ``obs`` times the round in a ``round`` wall span and records it with the
    byte ledger; with ``obs.collect_metrics`` the metric bundle (update,
    quantization-error and EF residual norms) is built after the round from
    its outputs and its cohort mean.  A cached ``round_fn`` must have been
    built with the matching ``collect_metrics``, else ``ValueError`` (the
    reference builds the bundle without the mean instead, ROADMAP C21)."""
    takes_ef = simulate.ef_lib.takes_residual(omc, strategy)
    if takes_ef and ef is None:
        raise ValueError(f"strategy {strategy.label!r} uses error feedback: pass the ef= "
                         f"state (repro_torch.compress.feedback.init_ef_state)")
    collect = obs is not None and obs.collect_metrics
    if round_fn is None:
        round_fn = make_round_fn(family, cfg, specs, omc, sim, spec, data_fn, data_mode,
                                 strategy=strategy, ste=ste, fused_agg=fused_agg,
                                 collect_metrics=collect)
    elif getattr(round_fn, "collect_metrics", False) != collect:
        raise ValueError(f"round_fn was built with collect_metrics="
                         f"{getattr(round_fn, 'collect_metrics', False)} but this round "
                         f"{'collects' if collect else 'does not collect'} metrics: build it "
                         f"with make_round_fn(collect_metrics={collect})")
    ids_per_tier = sample_tiered_cohort(key, spec, round_index)
    alive = cohort_lib.survival_mask(key, spec.plan, round_index)
    with null_span(obs, "round", round=int(round_index)):
        res = round_fn(server_params, ids_per_tier, alive, round_index,
                       **(dict(ef=ef) if takes_ef else {}))
    new_storage, loss, n_alive = res[:3]
    bundle = None
    if collect:
        # built after the round, from its outputs: the round's own
        # arithmetic never sees it (DESIGN.md §15)
        bundle = obs_metrics.server_round_bundle(specs, server_params, new_storage,
                                                 res[3],
                                                 sim.server_lr)
        bundle["loss"] = loss
        bundle["alive"] = n_alive
        if takes_ef:
            ids_all = torch.cat(list(ids_per_tier))
            bundle["ef_norm"] = obs_metrics.ef_rows_norm(
                {k: v[ids_all.to(v.device)] for k, v in ef.items()})
    del res
    n_alive = int(n_alive)
    metrics: Dict[str, float] = dict(loss=float(loss), cohort=n_alive,
                                     dropped=int(spec.plan.cohort_size - n_alive))
    if wire_table is not None:
        metrics.update(round_wire_metrics(wire_table, omc, spec.tier_omcs(omc), ids_per_tier,
                                          alive, round_index, strategy=strategy))
    if obs is not None:
        obs.record("round", bundle, round=int(round_index), **metrics)
    return new_storage, metrics


def round_wire_metrics(table: accounting.WireTable, omc: OMCConfig,
                       tier_omcs: Sequence[OMCConfig], ids_per_tier: Sequence[torch.Tensor],
                       alive: torch.Tensor, round_index: int, strategy=None) -> Dict[str, int]:
    """Exact per-round wire bytes: every invited client downloads the
    compressed server state; every surviving client uploads its PPQ-masked,
    tier-format transport payload.  With ``strategy`` the upload sizes come
    from the strategy's plan (a data-dependent one raises)."""
    invited = sum(len(i) for i in ids_per_tier)
    down = accounting.download_bytes_train(table, omc, strategy) * invited
    alive_np = np.asarray(alive.cpu().numpy(), bool)
    up, off = 0, 0
    for omc_t, ids_t in zip(tier_omcs, ids_per_tier):
        q = len(ids_t)
        if strategy is None:
            per_client = accounting.cohort_upload_bytes(table, omc_t, round_index,
                                                        ids_t.tolist())
        else:
            per_client = accounting.cohort_upload_bytes_strategy(table, omc_t, strategy,
                                                                 round_index, ids_t.tolist())
        up += int(per_client[alive_np[off:off + q]].sum())
        off += q
    return dict(down_bytes=int(down), up_bytes=int(up))


def run_training_vectorized(family, cfg, omc: OMCConfig, sim: SimConfig, spec: CohortSpec,
                            data_fn, init_key: prng.Key, num_rounds: int,
                            eval_fn: Optional[Callable[[Any, int], float]] = None,
                            eval_every: int = 10, init_params=None,
                            log: Optional[Callable[[str], None]] = None,
                            data_mode: str = "vmap", wire: bool = True, strategy=None,
                            ste: bool = False, ef=None, fused_agg: bool = False, obs=None,
                            device="cuda"):
    """Mirror of :func:`simulate.run_training` through the engine.  History
    rows carry ``down_bytes`` / ``up_bytes`` when ``wire=True``.  Runs where
    ``init_params`` lie, else on ``device`` (default the card).  Under an EF
    strategy ``ef`` is updated in place (allocated here when None).
    ``obs`` attaches telemetry: a ``round`` wall span and record per round,
    with the metric bundle when ``obs.collect_metrics``."""
    specs = family.param_specs(cfg)
    params, storage = simulate.init_storage(family, cfg, omc, specs, init_key, init_params,
                                            device)
    round_fn = make_round_fn(family, cfg, specs, omc, sim, spec, data_fn, data_mode,
                             strategy=strategy, ste=ste, fused_agg=fused_agg,
                             collect_metrics=obs is not None and obs.collect_metrics)
    if ef is None and simulate.ef_lib.takes_residual(omc, strategy):
        ef = simulate.ef_lib.init_ef_state(params, specs, omc, spec.plan.num_clients)
    table = accounting.build_wire_table(params, specs, omc) if wire else None
    del params
    key = prng.fold_in(init_key, 0xC047)
    history = []
    for r in range(num_rounds):
        storage, metrics = run_round_vectorized(family, cfg, specs, omc, sim, storage, data_fn,
                                                spec, r, key, round_fn=round_fn,
                                                wire_table=table, data_mode=data_mode,
                                                strategy=strategy, ste=ste, ef=ef, obs=obs)
        if eval_fn is not None and (r + 1) % eval_every == 0:
            metrics["eval"] = float(eval_fn(decompress_tree(storage), r))
        history.append(dict(round=r, **metrics))
        if log and ((r + 1) % eval_every == 0 or r == 0):
            log(f"round {r + 1}/{num_rounds}: " + ", ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in metrics.items()))
    return storage, history


def masked_upload_tree(trained_f32, specs, omc: OMCConfig, round_index: int, client_id: int):
    """Storage tree of one client's transport payload: PPQ-selected variables
    compressed under ``omc.fmt``, everything else f32."""
    if not omc.enabled:
        return trained_f32
    names = accounting.selected_names(trained_f32, specs, omc)
    if not names:
        return trained_f32
    mask = ppq_mask(omc.ppq_key(), round_index, client_id, len(names),
                    omc.quantize_fraction).tolist()
    index = {n: i for i, n in enumerate(names)}

    def f(path, spec, leaf):
        i = index.get(path_str(path))
        if i is None or not mask[i]:
            return leaf
        return compress_variable(leaf, omc.fmt, pvt=omc.pvt, batch_axes=n_stack_axes(spec, leaf))

    return tree_map_with_path(f, specs, trained_f32)
