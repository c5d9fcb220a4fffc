"""Event-driven asynchronous federated runtime (port of
``repro.federated.async_engine``, DESIGN.md §10).

The sync paths (:mod:`.simulate`, :mod:`.engine`) are hard-barrier: every
round waits for the slowest invited client.  This runtime removes the
barrier.  Clients *check in* against a virtual clock driven by a
:mod:`.traces` model, download the server state stamped with its current
**version**, train, and upload whenever they finish; the server runs
**buffered aggregation** (FedBuff): an aggregate is applied whenever
``buffer_goal`` (K) uploads accumulate, each weighted by a decay of its
**staleness** ``server_version - base_version``.

Training is lazy and batched by version, as in the reference: the first
upload of a version trains every still-untrained client that downloaded it,
in chunks of ``AsyncConfig.capacity`` lanes, each chunk one call of
:func:`make_batch_train_fn` (the batched body the engine runs,
:func:`.simulate.make_batch_client_fn`), each lane keyed by its client's own
round counter, never the server version.  The reference pads a short chunk
to its fixed width and discards the pad lanes; the port trains no pad lane.
The flush decodes the storage (B2 ``dequantize``), takes the
staleness-weighted mean, interpolates with ``server_lr`` and re-compresses
(B1 ``quantize_stats``).  With ``fused_agg=True`` each trained lane is
transport-encoded at once (``compress_params``, one B1 launch per selected
leaf) and the flush aggregates each selected leaf in the code domain with
one B5 ``fused_aggregate`` launch, with the flush weights; unselected
leaves take the f32 weighted mean and the interpolation.

Equivalence contract: with ``buffer_goal`` equal to the population, a
zero-jitter :class:`~.traces.FixedTrace` and decay 0, every version's
buffer holds one fresh update per client and the runtime reproduces the
sync engine within one quantization step, its wire bytes to the byte.

Checkpoints of the whole runtime state (buffer, version storages, pending
tickets, trace counters, ledger) are
:func:`repro_torch.checkpoint.save_async_state` /
:func:`~repro_torch.checkpoint.restore_async_state`.  ``strategy`` and
``ste`` train the lanes under a zoo compressor (DESIGN.md §12); under an
error-feedback strategy ``runner.ef`` holds one residual row per client,
which each chunk gathers before it trains and writes back after (no pad
lane exists to discard), and the checkpoint carries it.
``fused_agg=True`` with a strategy raises, as in the reference.  ``obs``
(a ``repro_torch.obs.Obs``, DESIGN.md §15) adds a
``client_round`` virtual span per check-in (its sampled latency on the
virtual clock), a ``dispatch`` wall span per trained chunk (its lane count
in the args, as the reference's), ``flush`` wall spans, and a ``flush``
record per flush with the staleness list and the wire ledger; with metrics
on, the unfused flush hands back the buffer mean it already computed and
the bundle is built from it afterwards.  ``population`` (a
``repro_torch.scale.PopulationStore`` over ``num_clients`` clients) keeps
the per-client round and event counters in the store's arrays instead of
dicts; its EF residuals are not used here (``runner.ef`` stays dense), as in
the reference.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.omc import OMCConfig
from repro_torch.core.store import decompress_tree
from repro_torch.core.tree import tree_map
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import null_span

from . import accounting
from . import cohort as cohort_lib
from . import simulate
from .engine import apply_server_step, fused_server_step
from .simulate import SimConfig
from .state import compress_params
from .traces import ClientTrace, FixedTrace

_PRIO_UPLOAD = 0  # at equal times, uploads (and their flush) land first
_PRIO_CHECKIN = 1


# ---------------------------------------------------------------------------
# Staleness weighting
# ---------------------------------------------------------------------------


def _f32(staleness) -> torch.Tensor:
    if isinstance(staleness, torch.Tensor):
        return staleness.to(torch.float32)
    return torch.from_numpy(np.asarray(staleness, np.float32))


def staleness_weights(staleness, decay: float, mode: str = "poly") -> torch.Tensor:
    """Un-normalized buffer weights ``w(s)`` for staleness ``s >= 0``, f32.

    ``poly``: ``(1 + s)^-decay``; ``exp``: ``e^(-decay * s)``.  Both give
    ``w(0) = 1``, ``0 < w(s) <= 1``, monotone non-increasing.  ``decay = 0``
    gives exact 1.0s: buffered aggregation is then the sync engine's FedAvg.
    """
    s = _f32(staleness)
    if decay < 0:
        raise ValueError(f"decay must be >= 0, got {decay}")
    if mode not in ("poly", "exp"):
        raise ValueError(f"decay_mode must be 'poly' or 'exp', got {mode!r}")
    if decay == 0:
        return torch.ones_like(s)
    if mode == "poly":
        return (1.0 + s) ** (-decay)
    return torch.exp(-decay * s)


def buffer_weights(staleness, decay: float, mode: str = "poly") -> torch.Tensor:
    """Normalized per-buffer weights (non-negative, summing to 1), computed in
    log space shifted by the freshest entry, so a uniformly stale buffer at a
    large ``decay * staleness`` does not underflow to 0/0."""
    w = staleness_weights(staleness, decay, mode)  # validates the arguments
    s = _f32(staleness)
    if decay == 0:
        return w / w.sum()
    logw = -decay * (torch.log1p(s) if mode == "poly" else s)
    logw = logw - logw.max()
    e = torch.exp(logw)
    return e / e.sum()


def flush_weights(staleness, decay: float, mode: str = "poly") -> torch.Tensor:
    """The weights a flush hands to the aggregation: exact 1.0s at decay 0
    (the sync engine's all-alive weights, which the equivalence gate rests
    on), else :func:`buffer_weights` (the aggregation renormalizes)."""
    s = _f32(staleness)
    if decay == 0:
        staleness_weights(s, decay, mode)  # still validates the mode
        return torch.ones_like(s)
    return buffer_weights(s, decay, mode)


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """Buffered-aggregation knobs.

    ``buffer_goal`` (K) is validated against the population with the sync
    report goal's gate (:func:`.cohort.validate_report_goal`) when a runner
    is built.  ``train_capacity`` is the most lanes one training call takes
    (:attr:`capacity`, default K: one call per flush in the steady state);
    larger groups train in several calls.
    """

    buffer_goal: int
    decay: float = 0.0
    decay_mode: str = "poly"
    max_staleness: Optional[int] = None  # drop (don't aggregate) staler uploads
    train_capacity: Optional[int] = None

    def __post_init__(self):
        staleness_weights(torch.zeros((1,)), self.decay, self.decay_mode)
        if self.max_staleness is not None and self.max_staleness < 0:
            raise ValueError(f"max_staleness must be >= 0, got {self.max_staleness}")
        if self.train_capacity is not None and self.train_capacity < 1:
            raise ValueError(f"train_capacity must be >= 1, got {self.train_capacity}")

    @property
    def capacity(self) -> int:
        return self.train_capacity or self.buffer_goal


# ---------------------------------------------------------------------------
# Batched client training
# ---------------------------------------------------------------------------


def make_batch_train_fn(family, cfg, specs, omc: OMCConfig, sim: SimConfig, data_fn,
                        capacity: int, strategy=None, ste: bool = False,
                        takes_residual: bool = False):
    """``(storage, cids, rounds) -> (models, losses)``: up to ``capacity``
    lanes trained in one call of the batched body the engine runs
    (:func:`.simulate.make_batch_client_fn`), ``models`` one tree of
    ``[lanes, ...]`` stacks and ``losses`` ``[lanes]``.  ``rounds`` is each
    client's own round counter, never the server version: a client that
    trains twice under one version draws fresh data and a fresh PPQ mask.
    With ``takes_residual`` the lanes' residual rows ``{name: [lanes, ...]}``
    ride as a fourth argument and their updated rows come back as a third
    output.  Every lane given is trained (the reference's pad lanes too).

    The function's ``from_decoded`` attribute takes the decoded server tree
    in place of ``storage``, so that a version's chunks share one decode."""
    many = simulate.make_batch_client_fn(family, cfg, specs, omc, sim, strategy, ste,
                                         takes_residual)

    def from_decoded(server_f32, cids, rounds, ef_rows=None):
        cids = [int(c) for c in torch.as_tensor(cids).reshape(-1).tolist()]
        rounds = [int(r) for r in torch.as_tensor(rounds).reshape(-1).tolist()]
        if not 1 <= len(cids) <= capacity or len(rounds) != len(cids):
            raise ValueError(f"{len(cids)} lanes and {len(rounds)} rounds for a capacity of "
                             f"{capacity}")
        batches = simulate.cohort_batches(data_fn, cids, rounds, sim.local_steps)
        models, losses, rows = many(server_f32, batches, rounds, cids, ef_rows)
        return (models, losses, rows) if takes_residual else (models, losses)

    def batch_fn(storage, cids, rounds, ef_rows=None):
        with torch.no_grad():
            server_f32 = decompress_tree(storage)
        return from_decoded(server_f32, cids, rounds, ef_rows)

    batch_fn.from_decoded = from_decoded
    return batch_fn


# ---------------------------------------------------------------------------
# The buffer flush
# ---------------------------------------------------------------------------


def make_flush_fn(specs, omc: OMCConfig, sim: SimConfig, collect_metrics: bool = False):
    """``(storage, stacked[K, ...], weights[K]) -> new storage``: the
    staleness-weighted FedBuff step — decode, weighted mean over the buffer
    (renormalized, :func:`.cohort.aggregate_weighted`), interpolation with
    ``sim.server_lr`` and re-compress.  With unit weights this is the sync
    engine's ``finish`` on an all-alive cohort of size K.

    ``collect_metrics=True`` returns ``(new storage, mean)``: the buffer mean
    the flush interpolated toward, for the metric bundle."""

    def flush_fn(storage, stacked, weights):
        with torch.no_grad():
            mean_model = cohort_lib.aggregate_weighted(stacked, weights)
            new = apply_server_step(decompress_tree(storage), mean_model, specs, omc,
                                    sim.server_lr)
            return (new, mean_model) if collect_metrics else new

    return flush_fn


def make_fused_flush_fn(specs, omc: OMCConfig, sim: SimConfig, collect_metrics: bool = False):
    """Compressed-domain flush (DESIGN.md §13):
    ``(storage, stacked compressed entries[K, ...], weights[K]) -> storage``.

    The entries are transport-encoded already, so this is the sync engine's
    fused server step (:func:`.engine.fused_server_step`) with the flush
    weights: one ``fused_aggregate`` launch per selected leaf.  With
    ``collect_metrics`` it returns ``(new storage, None)``: no f32 buffer mean
    exists in the code domain, and the bundle is the update norm alone."""

    def flush_fn(storage, stacked, weights):
        with torch.no_grad():
            new = fused_server_step(storage, stacked, weights, specs, omc, sim.server_lr)
            return (new, None) if collect_metrics else new

    return flush_fn


# ---------------------------------------------------------------------------
# The runtime
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Pending:
    """An in-flight client round: ``round_index`` (the client's own counter)
    keys its data and PPQ mask, ``base_version`` its download and staleness."""

    base_version: int
    round_index: int
    upload_at: float


@dataclasses.dataclass
class _BufferEntry:
    client_id: int
    base_version: int
    # the trained client model: an f32 tree, or with fused_agg its
    # transport-encoded upload (CompressedVariable leaves at selected vars)
    model: Any
    loss: float


class AsyncRunner:
    """The event-driven server: virtual clock, tickets, buffer, flushes.

    Drive it with :meth:`step` (one event), :meth:`run_until` or
    :func:`run_async_training`.  The mutable state is plain attributes, so
    :mod:`repro_torch.checkpoint` can save a mid-buffer snapshot and restore
    it deterministically (traces are counter-based).  Runs where
    ``init_params`` lie, else on ``device`` (default the card; without one it
    raises unless ``device="cpu"``).
    """

    def __init__(self, family, cfg, omc: OMCConfig, sim: SimConfig, acfg: AsyncConfig,
                 trace: Optional[ClientTrace] = None, *, num_clients: int,
                 data_fn: Callable[[Any, Any, Any], Any], init_key=None, init_params=None,
                 wire: bool = True, strategy=None, ste: bool = False, fused_agg: bool = False,
                 population=None, obs=None, device="cuda"):
        if population is not None and population.layout.num_clients != int(num_clients):
            raise ValueError(f"population store holds {population.layout.num_clients} clients "
                             f"but the runner was given num_clients={num_clients}")
        if init_key is None and init_params is None:
            raise ValueError("need init_key or init_params")
        if fused_agg and (strategy is not None or not omc.enabled):
            raise ValueError("fused_agg=True needs OMC enabled and no zoo strategy "
                             "(DESIGN.md §13)")
        cohort_lib.validate_report_goal(acfg.buffer_goal, num_clients, what="buffer_goal")
        self.family, self.cfg, self.omc, self.sim = family, cfg, omc, sim
        self.acfg = acfg
        self.trace = trace if trace is not None else FixedTrace()
        self.num_clients = int(num_clients)
        self.data_fn = data_fn
        self.specs = family.param_specs(cfg)
        params, self.storage = simulate.init_storage(family, cfg, omc, self.specs, init_key,
                                                     init_params, device)
        # training under a strategy (DESIGN.md §12): residuals live per client
        # here and are checkpointed with the rest of the runtime state
        self.strategy, self.ste = strategy, ste
        takes_ef = simulate.ef_lib.takes_residual(omc, strategy)
        self.ef = (simulate.ef_lib.init_ef_state(params, self.specs, omc, self.num_clients)
                   if takes_ef else None)
        self._batch_fn = make_batch_train_fn(family, cfg, self.specs, omc, sim, data_fn,
                                             acfg.capacity, strategy, ste, takes_ef)
        # telemetry (DESIGN.md §15): obs=None is a strict no-op, the same
        # flush and no spans or records
        self.obs = obs
        self._collect_metrics = obs is not None and obs.collect_metrics
        # fused mode (§13): buffer entries live transport-encoded and the
        # flush aggregates in the compressed domain
        self.fused_agg = bool(fused_agg)
        make = make_fused_flush_fn if self.fused_agg else make_flush_fn
        self._flush_fn = make(self.specs, omc, sim, collect_metrics=self._collect_metrics)
        self.stats = (accounting.AsyncWireStats(
            accounting.build_wire_table(params, self.specs, omc), strategy=strategy)
            if wire else None)
        del params

        # --- mutable runtime state (checkpointed as a unit) ---------------
        self.version = 0
        self.clock = 0.0
        self.events_processed = 0
        self.completed = 0  # uploads aggregated into some buffer
        self.dropped_stale = 0
        self.buffer: List[_BufferEntry] = []
        self.pending: Dict[int, _Pending] = {}  # cid -> in-flight round
        self.idle: Dict[int, float] = {  # cid -> next check-in time
            c: self.trace.first_checkin(c) for c in range(self.num_clients)}
        # per-client counters: plain dicts, or with ``population=`` the
        # store's dense arrays behind the same mapping surface (DESIGN.md §14)
        self.population = population
        if population is not None:
            self.event_counters: Any = population.event_view()
            self.round_counters: Any = population.round_view()
        else:
            self.event_counters = {c: 0 for c in range(self.num_clients)}
            self.round_counters = {c: 0 for c in range(self.num_clients)}
        self.version_storages: Dict[int, Any] = {}  # v -> storage at v
        self.trained: Dict[Tuple[int, int], Tuple[Any, float]] = {}
        self.history: List[Dict[str, Any]] = []
        self._rebuild_heap()

    # -- event loop ---------------------------------------------------------

    def _rebuild_heap(self) -> None:
        """(Re)build the event heap from ``pending`` and ``idle``: the dicts
        are the source of truth (checkpointed; heap entries are invalidated
        lazily against them), so a restored runner derives the same order."""
        self._heap: List[Tuple[float, int, int]] = (
            [(p.upload_at, _PRIO_UPLOAD, c) for c, p in self.pending.items()]
            + [(t, _PRIO_CHECKIN, c) for c, t in self.idle.items()])
        heapq.heapify(self._heap)

    def _heap_valid(self, ev: Tuple[float, int, int]) -> bool:
        t, prio, c = ev
        if prio == _PRIO_UPLOAD:
            p = self.pending.get(c)
            return p is not None and p.upload_at == t
        return self.idle.get(c) == t

    def _next_event(self) -> Optional[Tuple[float, int, int]]:
        """``(time, prio, client)`` of the earliest event, or None.  Ties break
        on ``(prio, client)``: at equal times uploads precede check-ins, so
        the flush a K-th upload triggers lands before a same-instant
        check-in downloads the state."""
        while self._heap:
            ev = self._heap[0]
            if self._heap_valid(ev):
                return ev
            heapq.heappop(self._heap)  # superseded schedule
        return None

    def step(self) -> Dict[str, Any]:
        """Process one event; returns a small record of what happened."""
        ev = self._next_event()
        if ev is None:
            raise RuntimeError("no schedulable events (empty population?)")
        heapq.heappop(self._heap)
        t, prio, cid = ev
        self.clock = max(self.clock, t)
        self.events_processed += 1
        if prio == _PRIO_CHECKIN:
            return self._on_checkin(cid, t)
        return self._on_upload(cid, t)

    def _on_checkin(self, cid: int, t: float) -> Dict[str, Any]:
        del self.idle[cid]
        base = self.version
        self.version_storages.setdefault(base, self.storage)
        rnd = self.round_counters[cid]
        self.round_counters[cid] = rnd + 1
        k = self.event_counters[cid]
        latency = self.trace.round_latency(cid, k, t)
        self.event_counters[cid] = k + 1
        self.pending[cid] = _Pending(base, rnd, t + latency)
        heapq.heappush(self._heap, (t + latency, _PRIO_UPLOAD, cid))
        if self.stats is not None:
            self.stats.start_round(self.omc, rnd, cid)
        if self.obs is not None:
            # constructed, never timed: the loop knows both ends at check-in
            self.obs.vspan("client_round", t, latency, client=cid, version=base, round=rnd)
        return dict(event="checkin", client=cid, t=t, version=base, round=rnd, latency=latency)

    def _on_upload(self, cid: int, t: float) -> Dict[str, Any]:
        p = self.pending[cid]
        base, rnd = p.base_version, p.round_index
        staleness = self.version - base
        model, loss = self._train(cid, base)
        del self.pending[cid]
        dropped = self.acfg.max_staleness is not None and staleness > self.acfg.max_staleness
        if self.stats is not None:
            self.stats.finish_round(self.omc, rnd, cid, staleness, dropped=dropped)
        if dropped:
            self.dropped_stale += 1
        else:
            self.buffer.append(_BufferEntry(cid, base, model, loss))
            self.completed += 1
        self._gc_versions()
        k = self.event_counters[cid]
        delay = self.trace.checkin_delay(cid, k, t)
        self.event_counters[cid] = k + 1
        self.idle[cid] = t + delay
        heapq.heappush(self._heap, (t + delay, _PRIO_CHECKIN, cid))
        flushed = False
        if len(self.buffer) >= self.acfg.buffer_goal:
            self._flush()
            flushed = True
        return dict(event="upload", client=cid, t=t, staleness=staleness, dropped=dropped,
                    flushed=flushed)

    # -- lazy batched training ---------------------------------------------

    def _train(self, cid: int, base: int) -> Tuple[Any, float]:
        """The trained model of ``(cid, base)``: trains every still-untrained
        client that downloaded version ``base``, in ``pending``'s order and
        in chunks of ``capacity`` lanes, each lane keyed by its own round
        counter, and caches the results."""
        key = (base, cid)
        if key not in self.trained:
            group = [(c, p.round_index) for c, p in self.pending.items()
                     if p.base_version == base and (base, c) not in self.trained]
            with torch.no_grad():
                server_f32 = decompress_tree(self.version_storages[base])
            cap = self.acfg.capacity
            for i in range(0, len(group), cap):
                self._train_chunk(server_f32, base, group[i:i + cap])
            del server_f32
        return self.trained.pop(key)

    def _train_chunk(self, server_f32, base: int, chunk) -> None:
        cids = [c for c, _ in chunk]
        rounds = [r for _, r in chunk]
        with null_span(self.obs, "dispatch", version=base, lanes=len(chunk)):
            if self.ef is not None:
                models, losses, rows = self._batch_fn.from_decoded(
                    server_f32, cids, rounds, simulate.ef_lib.gather_rows(self.ef, cids))
                with torch.no_grad():
                    for k, v in self.ef.items():
                        v[cids] = rows[k].to(v.device)
                del rows
            else:
                models, losses = self._batch_fn.from_decoded(server_f32, cids, rounds)
        for j, (c, loss) in enumerate(zip(cids, losses.tolist())):
            model = tree_map(lambda x: x[j], models)
            if self.fused_agg:
                # transport-encode each lane at once (§13): the cached upload,
                # and later the buffer, holds codes, not f32 trees
                with torch.no_grad():
                    model = compress_params(model, self.specs, self.omc)
            self.trained[(base, c)] = (model, loss)

    def _gc_versions(self) -> None:
        live = {p.base_version for p in self.pending.values()}
        live.add(self.version)
        for v in [v for v in self.version_storages if v not in live]:
            del self.version_storages[v]
        for k in [k for k in self.trained if k[0] not in live]:
            del self.trained[k]

    # -- buffered aggregation ----------------------------------------------

    def _flush(self) -> None:
        entries = self.buffer[:self.acfg.buffer_goal]
        self.buffer = self.buffer[self.acfg.buffer_goal:]
        staleness = np.asarray([self.version - e.base_version for e in entries], np.float32)
        w = flush_weights(staleness, self.acfg.decay, self.acfg.decay_mode)
        stacked = None
        for i, e in enumerate(entries):  # each upload dropped once in its row
            stacked = simulate.stack_into(stacked, i, e.model, len(entries))
            e.model = None
        bundle = None
        with null_span(self.obs, "flush", version=self.version, buffer=len(entries)):
            old_storage = self.storage
            out = self._flush_fn(self.storage, stacked, w)
            del stacked
            if self._collect_metrics:
                # built after the flush (DESIGN.md §15): the flush's own
                # arithmetic never sees it
                self.storage, mean_model = out
                bundle = obs_metrics.server_round_bundle(self.specs, old_storage, self.storage,
                                                         mean_model, self.sim.server_lr)
            else:
                self.storage = out
            del old_storage, out
        self.version += 1
        rec = dict(
            version=self.version,
            clock=round(float(self.clock), 6),
            buffer=len(entries),
            loss=float(np.mean([e.loss for e in entries])),
            staleness_mean=float(staleness.mean()),
            staleness_max=int(staleness.max()),
            completed=self.completed,
            dropped_stale=self.dropped_stale,
        )
        if self.stats is not None:
            rec.update(self.stats.snapshot())
        self.history.append(rec)
        if self.obs is not None:
            self.obs.record("flush", bundle, staleness=[float(s) for s in staleness], **rec)
        self._gc_versions()

    # -- driving ------------------------------------------------------------

    def run_until(self, *, flushes: Optional[int] = None, uploads: Optional[int] = None,
                  time_limit: Optional[float] = None, max_events: int = 10_000_000) -> None:
        """Advance the virtual clock until a target is reached (whichever of
        ``flushes`` / ``uploads`` / ``time_limit`` comes first)."""
        if flushes is None and uploads is None and time_limit is None:
            raise ValueError("need flushes, uploads, or time_limit")
        target_v = self.version + flushes if flushes is not None else None
        target_u = self.completed + uploads if uploads is not None else None
        for _ in range(max_events):
            if target_v is not None and self.version >= target_v:
                return
            if target_u is not None and self.completed >= target_u:
                return
            nxt = self._next_event()
            if nxt is None or (time_limit is not None and nxt[0] > time_limit):
                return
            self.step()
        raise RuntimeError(f"run_until exceeded max_events={max_events}")

    def server_params(self):
        """Decompressed f32 view of the current server model."""
        with torch.no_grad():
            return decompress_tree(self.storage)


def run_async_training(family, cfg, omc: OMCConfig, sim: SimConfig, acfg: AsyncConfig,
                       trace: ClientTrace, data_fn, init_key, *, num_clients: int,
                       flushes: int, wire: bool = True,
                       log: Optional[Callable[[str], None]] = None, strategy=None,
                       ste: bool = False, fused_agg: bool = False, obs=None,
                       init_params=None, device="cuda"
                       ) -> Tuple[Any, List[Dict[str, Any]], AsyncRunner]:
    """Async mirror of :func:`.engine.run_training_vectorized`: runs the event
    loop for ``flushes`` buffer flushes and returns ``(final storage,
    history, runner)``, one history row per flush with the virtual clock,
    the staleness distribution and (``wire=True``) the cumulative
    :class:`~.accounting.AsyncWireStats` ledger."""
    runner = AsyncRunner(family, cfg, omc, sim, acfg, trace, num_clients=num_clients,
                         data_fn=data_fn, init_key=init_key, init_params=init_params,
                         wire=wire, strategy=strategy, ste=ste, fused_agg=fused_agg, obs=obs,
                         device=device)
    for i in range(flushes):
        runner.run_until(flushes=1)
        if log and (i == 0 or (i + 1) % max(flushes // 4, 1) == 0):
            h = runner.history[-1]
            log(f"flush {i + 1}/{flushes}: " + ", ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}" for k, v in h.items()))
    return runner.storage, runner.history, runner
