"""Vectorized heterogeneous-cohort engine (port of ``repro.federated.engine``).

The reference runs a whole round as one jitted XLA program that ``vmap``s
the single-client body (``simulate.make_client_fn``) over the cohort.  The
port runs the invited clients of each tier one after another on the card,
each with its own full-width forward and backward, and stacks their
results into ``[C, ...]`` tensors for the server half.  A loop computes the
same function as ``vmap``; it is used because the client body's
quantize→dequantize goes through ``Tensor.view(dtype)`` bit operations,
which ``torch.func.vmap`` does not batch reliably.

Semantics kept from the reference:

  * the cohort, survival mask, PPQ masks and data stream are the loop's
    (``core.prng`` equals ``jax.random``), so with one default tier the
    engine and ``simulate.run_training`` agree within reassociation and
    their ledgers to the byte;
  * dead clients are computed too, weighted 0, and their rows zeroed with
    ``where`` before any mean, so a diverged dead client cannot poison it;
  * ``finish`` decodes, averages, interpolates and re-compresses;
    ``finish_fused`` (``fused_agg=True``) transport-encodes each compressed
    leaf's stack and aggregates it in the code domain with one
    ``ops.fused_aggregate`` launch per leaf; unselected leaves keep the f32
    mean.

``strategy``, ``ste``, ``ef`` and ``obs`` belong to later slices (ROADMAP
A7, A9) and raise ``NotImplementedError``; ``data_mode`` is accepted for
the reference's signature, and both modes draw batches on the host side of
the loop.
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

from . import accounting
from . import cohort as cohort_lib
from . import simulate
from .simulate import SimConfig, check_unported
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
    ``client_chunk`` keeps the reference's name and validation; the port runs
    clients one at a time, so it has no effect on the result or on memory.
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
    FedAvg: ``0·inf`` would poison the mean)."""
    return tree_map(lambda x: torch.where(_alive_rows(alive, x), x, torch.zeros((), device=x.device)),
                    stacked)


def apply_server_step(server_f32, mean_model, specs, omc: OMCConfig, server_lr: float):
    """Interpolate toward the cohort mean with ``server_lr`` and re-compress
    under the policy: the server half of every unfused round."""
    new_f32 = tree_map(lambda old, new: old + server_lr * (new - old), server_f32, mean_model)
    return compress_params(new_f32, specs, omc) if omc.enabled else new_f32


# ---------------------------------------------------------------------------
# The round
# ---------------------------------------------------------------------------


def make_round_fn(family, cfg, specs, omc: OMCConfig, sim: SimConfig, spec: CohortSpec,
                  data_fn: Callable[[int, int, int], Any], data_mode: str = "vmap",
                  strategy=None, ste: bool = False, fused_agg: bool = False,
                  collect_metrics: bool = False):
    """Build the engine's round:
    ``(storage, ids_per_tier, alive, round_index) -> (new_storage, loss, n_alive)``.

    Server decompress, the clients of every tier (each drawing its batches
    from ``data_fn(client, round, step)``), the zero-weight FedAvg, the
    server step and the re-compress — or, with ``fused_agg``, the
    compressed-domain server round.  ``loss`` and ``n_alive`` are 0-d
    tensors on the device.
    """
    if data_mode not in ("vmap", "host"):
        raise ValueError(f"data_mode must be 'vmap' or 'host', got {data_mode!r}")
    check_unported(strategy, ste)
    if collect_metrics:
        raise NotImplementedError("metric bundles (collect_metrics) are not ported yet "
                                  "(ROADMAP A9)")
    if fused_agg and not fused_aggregation_supported(spec, omc, strategy):
        raise ValueError("fused_agg=True needs a homogeneous cohort, OMC enabled, and no "
                         "compression strategy")
    ones = [simulate.make_client_fn(family, cfg, specs, omc_t, sim)
            for omc_t in spec.tier_omcs(omc)]

    def losses_and_weights(loss_c, alive):
        w = alive.to(loss_c.device, torch.float32)
        loss_c = torch.where(alive.to(loss_c.device), loss_c, torch.zeros((), device=loss_c.device))
        n_alive = w.sum()
        return w, (loss_c * w).sum() / torch.clamp(n_alive, min=1.0), n_alive

    def finish(server_f32, stacked, loss_c, alive):
        w, loss, n_alive = losses_and_weights(loss_c, alive)
        mean_model = cohort_lib.aggregate_weighted(mask_dead_rows(stacked, alive), w)
        return apply_server_step(server_f32, mean_model, specs, omc, sim.server_lr), loss, n_alive

    def finish_fused(storage, stacked, loss_c, alive):
        w, loss, n_alive = losses_and_weights(loss_c, alive)

        def f(path, spec_t, srv, stack):
            if is_compressed(srv):
                ba = n_stack_axes(spec_t, srv.codes)
                codes_c, s_c, b_c = transport_encode_stacked(stack, srv.fmt, omc.pvt, ba)
                new_codes, s, b = kernel_ops.fused_aggregate(
                    srv.codes, srv.s, srv.b, codes_c, s_c, b_c, w, sim.server_lr, srv.fmt,
                    batch_axes=ba, pvt=omc.pvt)
                return CompressedVariable(new_codes, s, b, srv.fmt)
            # unselected leaves keep the f32 mean and interpolation
            x = torch.where(_alive_rows(alive, stack), stack, torch.zeros((), device=stack.device))
            mean = cohort_lib.aggregate_weighted(x, w)
            return srv + sim.server_lr * (mean - srv)

        return tree_map_with_path(f, specs, storage, stacked), loss, n_alive

    def round_fn(storage, ids_per_tier, alive, round_index: int):
        with torch.no_grad():
            server_f32 = decompress_tree(storage)
        models, losses = [], []
        for one, ids_t in zip(ones, ids_per_tier):
            for cid in ids_t.tolist():
                batches = simulate.client_batches(data_fn, cid, round_index, sim.local_steps)
                m, loss = one(server_f32, batches, round_index, cid)
                models.append(m)
                losses.append(loss)
        with torch.no_grad():
            stacked = simulate.stack_trees(models)
            del models
            if fused_agg:
                return finish_fused(storage, stacked, torch.stack(losses), alive)
            return finish(server_f32, stacked, torch.stack(losses), alive)

    return round_fn


def run_round_vectorized(family, cfg, specs, omc: OMCConfig, sim: SimConfig, server_params,
                         data_fn, spec: CohortSpec, round_index: int, key: prng.Key,
                         round_fn=None, wire_table: Optional[accounting.WireTable] = None,
                         data_mode: str = "vmap", strategy=None, ste: bool = False, ef=None,
                         fused_agg: bool = False, obs=None) -> Tuple[Any, Dict[str, float]]:
    """One round; returns ``(new server storage, metrics)``.  Dead clients
    contribute weight 0 (the same mean as dropping them); the server
    interpolates toward the cohort mean and re-compresses."""
    check_unported(strategy, ste, ef, obs)
    if round_fn is None:
        round_fn = make_round_fn(family, cfg, specs, omc, sim, spec, data_fn, data_mode,
                                 fused_agg=fused_agg)
    ids_per_tier = sample_tiered_cohort(key, spec, round_index)
    alive = cohort_lib.survival_mask(key, spec.plan, round_index)
    new_storage, loss, n_alive = round_fn(server_params, ids_per_tier, alive, round_index)
    n_alive = int(n_alive)
    metrics: Dict[str, float] = dict(loss=float(loss), cohort=n_alive,
                                     dropped=int(spec.plan.cohort_size - n_alive))
    if wire_table is not None:
        metrics.update(round_wire_metrics(wire_table, omc, spec.tier_omcs(omc), ids_per_tier,
                                          alive, round_index))
    return new_storage, metrics


def round_wire_metrics(table: accounting.WireTable, omc: OMCConfig,
                       tier_omcs: Sequence[OMCConfig], ids_per_tier: Sequence[torch.Tensor],
                       alive: torch.Tensor, round_index: int, strategy=None) -> Dict[str, int]:
    """Exact per-round wire bytes: every invited client downloads the
    compressed server state; every surviving client uploads its PPQ-masked,
    tier-format transport payload."""
    invited = sum(len(i) for i in ids_per_tier)
    down = accounting.download_bytes_train(table, omc, strategy) * invited
    alive_np = np.asarray(alive.cpu().numpy(), bool)
    up, off = 0, 0
    for omc_t, ids_t in zip(tier_omcs, ids_per_tier):
        q = len(ids_t)
        per_client = accounting.cohort_upload_bytes(table, omc_t, round_index, ids_t.tolist())
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
    ``init_params`` lie, else on ``device`` (default the card)."""
    check_unported(strategy, ste, ef, obs)
    specs = family.param_specs(cfg)
    params, storage = simulate.init_storage(family, cfg, omc, specs, init_key, init_params,
                                            device)
    round_fn = make_round_fn(family, cfg, specs, omc, sim, spec, data_fn, data_mode,
                             fused_agg=fused_agg)
    table = accounting.build_wire_table(params, specs, omc) if wire else None
    del params
    key = prng.fold_in(init_key, 0xC047)
    history = []
    for r in range(num_rounds):
        storage, metrics = run_round_vectorized(family, cfg, specs, omc, sim, storage, data_fn,
                                                spec, r, key, round_fn=round_fn,
                                                wire_table=table, data_mode=data_mode)
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
