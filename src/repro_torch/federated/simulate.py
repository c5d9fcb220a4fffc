"""Faithful federated simulation (paper semantics, client granularity), port
of ``repro.federated.simulate``.

The numerics reference the engine is held against:

  * the server stores the model in OMC form (``CompressedVariable`` leaves);
  * each round a cohort is sampled; each surviving client
      1. receives the decompressed server model,
      2. applies its own PPQ mask (per round, per client, paper §2.5):
         selected variables pass through quantize→dequantize(+PVT), the
         rest keep the received f32 values,
      3. runs ``local_steps`` of plain SGD (``p − lr·g``) on its batches,
      4. re-quantizes the updated variables under the same mask (the
         transport compression);
  * the server averages the client models over the survivors, interpolates
    with ``server_lr`` and re-compresses its state.

Every entry point also takes ``strategy=`` (a
``repro_torch.compress.CompressionStrategy``) to train under a zoo
compressor instead of the hardcoded OMC qdq (DESIGN.md §12).
``strategy=None`` is the path above, and ``strategy=get_strategy("omc")``
gives the same bits.  Dense strategies replace the masked qdq view in both
directions; sparse upload-only ones (top-k, ternary, pipeline) train on the
dense download and compress the update ``trained - received`` on the way up,
with a per-client error-feedback residual (``ef``,
``repro_torch.compress.feedback``) where the strategy keeps one.  ``ste``
takes the straight-through form of the strategy's qdq.  ``obs`` (a
``repro_torch.obs.Obs``, DESIGN.md §15) adds a ``round`` wall span and a
``round`` record whose metric bundle is built from the loop's own f32 mean
after the round, so the stored tree is the same bits as with ``obs=None``.

Two round bodies serve every path: :func:`make_client_fn` trains one
client (the loop, the sessions, and the engine at ``client_chunk=1``), and
:func:`make_batch_client_fn` trains C clients at once, as the reference's
``vmap`` of the one-client body does (the engine, the async runtime and
the streamed round).  The batched body builds the C client views on
``[C, ...]`` stacks outside any ``vmap`` (the minifloat bit operations do
not batch under it), runs one forward and backward pass for the C clients
through the family's ``loss_clients``, and compresses the C uploads on the
stacks again.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import prng
from repro_torch.core.omc import OMCConfig, qdq_pvt_leaf
from repro_torch.core.partial import ppq_mask
from repro_torch.core.policy import path_str
from repro_torch.core.store import CompressedVariable, decompress_tree, is_compressed
from repro_torch.core.tree import tree_items, tree_map, tree_map_with_path
from repro_torch.models.common import IDENTITY_MAT
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import null_span

from . import accounting
from . import cohort as cohort_lib
from .state import compress_params, n_stack_axes


class _LazyEF:
    """``repro_torch.compress.feedback``, imported at first use: the package
    imports the codec, which imports this package."""

    def __getattr__(self, name):
        from repro_torch.compress import feedback

        return getattr(feedback, name)


ef_lib = _LazyEF()


def stack_trees(trees):
    """``[tree, tree, ...]`` -> one tree with leaves stacked on a new leading
    axis; a ``CompressedVariable`` stacks its codes, ``s`` and ``b``."""

    def f(*xs):
        if is_compressed(xs[0]):
            return CompressedVariable(*(torch.stack([getattr(x, k) for x in xs])
                                        for k in ("codes", "s", "b")), xs[0].fmt)
        return torch.stack(xs)

    return tree_map(f, *trees)


def stack_into(stacked, i: int, tree, n: int):
    """Copy ``tree`` into row ``i`` of ``stacked``, the ``[n, ...]`` stacks
    :func:`stack_trees` makes, and return them: the stacks are filled one
    tree at a time, so the trees need not all live at once (each can be
    dropped once copied).  With ``stacked`` None they are first allocated
    from ``tree``, uninitialised until every row is copied.  The same bits
    as :func:`stack_trees` once all ``n`` rows are in."""

    def new(x):
        return torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)

    def alloc(x):
        if is_compressed(x):
            return CompressedVariable(new(x.codes), new(x.s), new(x.b), x.fmt)
        return new(x)

    def copy(st, x):
        if is_compressed(st):
            for k in ("codes", "s", "b"):
                getattr(st, k)[i].copy_(getattr(x, k))
        else:
            st[i].copy_(x)
        return st

    if stacked is None:
        stacked = tree_map(alloc, tree)
    return tree_map(copy, stacked, tree)


def stack_rows_into(stacked, start: int, rows, n: int):
    """Copy the f32 ``[k, ...]`` stacks ``rows`` into rows ``start:start + k``
    of ``stacked``, the ``[n, ...]`` stacks (allocated from ``rows`` when
    None), and return them; with ``k == n`` and ``stacked`` None, ``rows``
    itself."""
    k = next(tree_items(rows))[1].shape[0]
    if stacked is None and start == 0 and k == n:
        return rows
    if stacked is None:
        stacked = tree_map(lambda x: x.new_empty((n,) + tuple(x.shape[1:])), rows)

    def copy(st, x):
        st[start:start + k].copy_(x)
        return st

    return tree_map(copy, stacked, rows)


def _masks(params_f32, specs, omc: OMCConfig, round_index: int, client_id: int):
    """``{selected path: PPQ bit}`` of one client in one round (empty when
    nothing is selected)."""
    names = accounting.selected_names(params_f32, specs, omc)
    if not names:
        return {}
    mask = ppq_mask(omc.ppq_key(), round_index, client_id, len(names),
                    omc.quantize_fraction).tolist()
    return dict(zip(names, mask))


def client_view(params_f32, specs, omc: OMCConfig, round_index: int, client_id: int,
                strategy=None, ste: bool = False):
    """The client's PPQ-masked quantize→dequantize(+PVT) view of ``params_f32``.

    Under a zoo ``strategy`` the masked variables go through its
    ``train_qdq_leaf`` (or the straight-through form with ``ste``) instead;
    an upload-only strategy leaves the download as it is."""
    if not omc.enabled or (strategy is not None and strategy.upload_only):
        return params_f32
    bits = _masks(params_f32, specs, omc, round_index, client_id)
    if not bits:
        return params_f32
    if strategy is not None:
        qdq = strategy.train_qdq_ste_leaf if ste else strategy.train_qdq_leaf

    def f(path, spec, leaf):
        if not bits.get(path_str(path), False):
            return leaf
        if strategy is None:
            return qdq_pvt_leaf(leaf, omc)
        return qdq(leaf, batch_axes=n_stack_axes(spec, leaf))

    return tree_map_with_path(f, specs, params_f32)


def strategy_upload(trained, received, residual, specs, omc: OMCConfig, strategy,
                    round_index: int, client_id: int, ste: bool = False):
    """The upload rule of a sparse (upload-only) strategy (DESIGN.md §12).

    The client sends its update ``delta = trained - received`` through the
    strategy's qdq under its PPQ mask; the server sees ``received + sent``.
    With error feedback, ``residual`` (this client's rows, ``{path:
    tensor}``) is added before compressing and what was dropped comes back
    as the new residual; without it ``residual`` is returned unchanged.
    Returns ``(model, new_residual)``."""
    if not omc.enabled:
        return trained, dict(residual or {})
    bits = _masks(trained, specs, omc, round_index, client_id)
    if not bits:
        return trained, dict(residual or {})
    use_ef = bool(strategy.error_feedback) and residual is not None
    qdq = strategy.train_qdq_ste_leaf if ste else strategy.train_qdq_leaf
    new_residual: Dict[str, Any] = {}

    def f(path, spec, t, rcv):
        name = path_str(path)
        if name not in bits:
            return t  # unselected variables travel f32 and arrive exact
        delta = t - rcv
        ax = n_stack_axes(spec, t)
        if use_ef:
            sent, new_residual[name] = ef_lib.compensate_leaf(
                strategy, delta, residual[name], bits[name], batch_axes=ax, ste=ste)
        else:
            sent = qdq(delta, batch_axes=ax) if bits[name] else delta
        return rcv + sent

    out = tree_map_with_path(f, specs, trained, received)
    return out, (new_residual if use_ef else dict(residual or {}))


@dataclasses.dataclass
class SimConfig:
    local_steps: int = 1
    client_lr: float = 0.05
    server_lr: float = 1.0


def _sgd(loss_fn, params, batches, lr: float) -> Tuple[Any, torch.Tensor]:
    """One plain SGD step (``p − lr·g``) per batch: ``g`` the gradient of the
    sum of ``loss_fn(params, batch)``; returns (params, the losses stacked)."""
    losses = []
    for batch in batches:
        leaves = {}

        def track(path, p):
            p = p.detach().requires_grad_(True)
            leaves[path] = p
            return p

        params = tree_map_with_path(track, params)
        loss = loss_fn(params, batch)
        grads = dict(zip(leaves, torch.autograd.grad(loss.sum(), list(leaves.values()))))
        with torch.no_grad():
            params = tree_map_with_path(lambda path, p: p - lr * grads[path], params)
        del grads, leaves
        losses.append(loss.detach())
    return params, torch.stack(losses)


def sgd_steps(family, cfg, params, batches, lr: float) -> Tuple[Any, torch.Tensor]:
    """One plain SGD step (``p − lr·g``, autograd through ``family.loss``) per
    batch of ``batches``; returns (params, losses ``[steps]``)."""
    return _sgd(lambda p, b: family.loss(cfg, p, b, IDENTITY_MAT), params, batches, lr)


def make_client_fn(family, cfg, specs, omc: OMCConfig, sim: SimConfig, strategy=None,
                   ste: bool = False, takes_residual: Optional[bool] = None):
    """Single-client round body:
    ``(server_f32, batches, round, client_id) -> (model, mean loss)``; with
    ``takes_residual`` (by default ``feedback.takes_residual(omc, strategy)``)
    the client's residual rows are threaded through:
    ``(..., residual) -> (model, mean loss, new_residual)``.

    ``batches`` is a list of ``local_steps`` batches.  The loop
    (:func:`run_round`), the engine and the async runtime all run this one
    body, which is what their equivalence rests on.  A tier whose ``omc`` is
    disabled passes the residual rows through unchanged.
    """
    if takes_residual is None:
        takes_residual = ef_lib.takes_residual(omc, strategy)
    sparse = strategy is not None and strategy.upload_only

    def train(server_f32, batches, round_index, client_id):
        eff = client_view(server_f32, specs, omc, round_index, client_id, strategy, ste)
        trained, losses = sgd_steps(family, cfg, eff, batches, sim.client_lr)
        return eff, trained, losses.mean()

    if takes_residual:

        def client_update_ef(server_f32, batches, round_index: int, client_id: int, residual):
            eff, trained, loss = train(server_f32, batches, round_index, client_id)
            with torch.no_grad():
                out, new_residual = strategy_upload(trained, eff, residual, specs, omc,
                                                    strategy, round_index, client_id, ste)
            return out, loss, new_residual

        return client_update_ef

    def client_update(server_f32, batches, round_index: int, client_id: int):
        eff, trained, loss = train(server_f32, batches, round_index, client_id)
        with torch.no_grad():
            if sparse and omc.enabled:
                # a sparse strategy without error feedback: the raw update
                out, _ = strategy_upload(trained, eff, None, specs, omc, strategy,
                                         round_index, client_id, ste)
            else:
                # the transport compression: re-quantize under the same mask
                out = client_view(trained, specs, omc, round_index, client_id, strategy, ste)
        return out, loss

    return client_update


def make_client_update(family, cfg, specs, omc: OMCConfig, sim: SimConfig, strategy=None,
                       ste: bool = False, takes_residual: Optional[bool] = None):
    """:func:`make_client_fn` (the reference jits it; PyTorch runs eagerly)."""
    return make_client_fn(family, cfg, specs, omc, sim, strategy, ste, takes_residual)


def client_batches(data_fn, client_id: int, round_index: int, local_steps: int):
    return [data_fn(client_id, round_index, s) for s in range(local_steps)]


def cohort_batches(data_fn, client_ids, round_indices, local_steps: int):
    """The batches of C clients: one tree a local step, each tensor
    ``[C, ...]``, client ``c``'s rows drawn by ``data_fn(c, round, step)``
    by :func:`client_batches`, client after client."""
    per_client = [client_batches(data_fn, int(c), int(r), local_steps)
                  for c, r in zip(client_ids, round_indices)]
    return [stack_trees(step) for step in zip(*per_client)]


def _client_bits(names, omc: OMCConfig, round_indices, client_ids):
    """``{selected path: bool[C]}`` on the host: the PPQ bits of C clients,
    each keyed by its own round."""
    rows = torch.stack([ppq_mask(omc.ppq_key(), int(r), int(c), len(names),
                                 omc.quantize_fraction)
                        for r, c in zip(round_indices, client_ids)])
    return {n: rows[:, i] for i, n in enumerate(names)}


def _where_clients(bits: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row ``c`` of ``a`` where ``bits[c]`` (host bools), else of ``b``."""
    if bool(bits.all()):
        return a
    return torch.where(bits.to(a.device).reshape((-1,) + (1,) * (a.ndim - 1)), a, b)


def client_view_batch(stack, specs, omc: OMCConfig, bits, strategy=None, ste: bool = False):
    """:func:`client_view` of C clients on ``[C, ...]`` stacks, with their
    PPQ bits ``bits`` (:func:`_client_bits`): row ``c`` is client ``c``'s view,
    the same bits as :func:`client_view` of that row."""
    if not omc.enabled or (strategy is not None and strategy.upload_only) or not bits:
        return stack
    if strategy is not None:
        qdq = strategy.train_qdq_ste_leaf if ste else strategy.train_qdq_leaf

    def f(path, spec, leaf):
        b = bits.get(path_str(path))
        if b is None or not bool(b.any()):
            return leaf
        if strategy is None:
            q = qdq_pvt_leaf(leaf, omc, client_axis=True)
        else:
            q = qdq(leaf, batch_axes=n_stack_axes(spec, leaf[0]) + 1, client_axis=True)
        return _where_clients(b, q, leaf)

    return tree_map_with_path(f, specs, stack)


def strategy_upload_batch(trained, received, residual, specs, omc: OMCConfig, strategy,
                          bits, ste: bool = False):
    """:func:`strategy_upload` of C clients on ``[C, ...]`` stacks, with
    ``residual`` their ``{path: [C, ...]}`` rows (or None)."""
    if not omc.enabled or not bits:
        return trained, dict(residual or {})
    use_ef = bool(strategy.error_feedback) and residual is not None
    qdq = strategy.train_qdq_ste_leaf if ste else strategy.train_qdq_leaf
    new_residual: Dict[str, Any] = {}

    def f(path, spec, t, rcv):
        name = path_str(path)
        if name not in bits:
            return t  # unselected variables travel f32 and arrive exact
        delta = t - rcv
        ax = n_stack_axes(spec, t[0]) + 1
        if use_ef:
            sent, new_residual[name] = ef_lib.compensate_leaf(
                strategy, delta, residual[name], bits[name], batch_axes=ax, ste=ste,
                client_axis=True)
        elif bool(bits[name].any()):
            sent = _where_clients(bits[name], qdq(delta, batch_axes=ax, client_axis=True),
                                  delta)
        else:
            sent = delta
        return rcv + sent

    out = tree_map_with_path(f, specs, trained, received)
    return out, (new_residual if use_ef else dict(residual or {}))


def make_batch_client_fn(family, cfg, specs, omc: OMCConfig, sim: SimConfig, strategy=None,
                         ste: bool = False, takes_residual: Optional[bool] = None):
    """The round body of C clients at once, the reference's ``vmap`` of
    :func:`make_client_fn`'s body:
    ``(server_f32, batches, round_indices[C], client_ids[C], ef_rows=None)
    -> (models, losses[C], new_rows)``.

    ``batches`` is :func:`cohort_batches`' list of ``local_steps`` trees of
    ``[C, ...]`` tensors; ``models`` is one tree of ``[C, ...]`` stacks, row
    ``c`` client ``c``'s upload; ``losses`` each client's mean loss over its
    steps.  Each client is keyed by its own round (its data and PPQ mask).
    With ``takes_residual`` (by default ``feedback.takes_residual(omc,
    strategy)``) ``ef_rows`` are the C clients' ``{path: [C, ...]}``
    residual rows and ``new_rows`` their updated rows; otherwise
    ``new_rows`` is ``{}``.

    A family trains batched through its ``loss_clients`` (conformer, the
    dense transformer); for any other family a call with C > 1 raises
    ``ValueError`` naming it, and C = 1 runs :func:`make_client_fn`'s body.
    """
    if takes_residual is None:
        takes_residual = ef_lib.takes_residual(omc, strategy)
    sparse = strategy is not None and strategy.upload_only
    batched = hasattr(family, "loss_clients")
    one = None if batched else make_client_fn(family, cfg, specs, omc, sim, strategy, ste,
                                              takes_residual)

    def unbatched(server_f32, batches, r, c, ef_rows):
        def row(tree):
            return tree_map(lambda x: x[0], tree)

        one_batches = [row(b) for b in batches]
        if takes_residual:
            m, loss, rows = one(server_f32, one_batches, r, c, row(ef_rows))
        else:
            (m, loss), rows = one(server_f32, one_batches, r, c), {}
        return (tree_map(lambda x: x.unsqueeze(0), m), loss.reshape(1),
                {k: v.unsqueeze(0) for k, v in rows.items()})

    def batch_client(server_f32, batches, round_indices, client_ids, ef_rows=None):
        rounds = [int(r) for r in round_indices]
        cids = [int(c) for c in client_ids]
        n = len(cids)
        if takes_residual and ef_rows is None:
            raise ValueError("this body trains under an error-feedback strategy: pass ef_rows")
        if not batched:
            if n != 1:
                name = family.__name__.rsplit(".", 1)[-1]
                raise ValueError(f"the {name} family has no batched client "
                                 f"body (loss_clients): train it one client at a time "
                                 f"(client_chunk=1, train_capacity=1 or capacity=1)")
            return unbatched(server_f32, batches, rounds[0], cids[0], ef_rows)
        names = accounting.selected_names(server_f32, specs, omc) if omc.enabled else []
        bits = _client_bits(names, omc, rounds, cids) if names else {}
        stack = tree_map(lambda x: x.expand((n,) + tuple(x.shape)), server_f32)
        eff = client_view_batch(stack, specs, omc, bits, strategy, ste)
        # one forward and backward pass a step for the C clients: the
        # gradient of the sum of their losses is each client's own gradient
        trained, losses = _sgd(lambda p, b: family.loss_clients(cfg, p, b), eff, batches,
                               sim.client_lr)
        with torch.no_grad():
            if sparse:
                # the update, with the residual rows under error feedback
                out, rows = strategy_upload_batch(trained, eff, ef_rows, specs, omc, strategy,
                                                  bits, ste)
            else:
                # the transport compression: re-quantize under the same masks
                out, rows = client_view_batch(trained, specs, omc, bits, strategy, ste), {}
        return out, losses.mean(0), rows

    return batch_client


def run_round(family, cfg, specs, omc: OMCConfig, sim: SimConfig, server_params,
              data_fn: Callable[[int, int, int], Any], plan: cohort_lib.CohortPlan,
              round_index: int, key: prng.Key, client_update=None, wire_table=None,
              strategy=None, ste: bool = False, ef=None, obs=None
              ) -> Tuple[Any, Dict[str, float]]:
    """One faithful round; returns ``(new server storage, metrics)``.

    ``wire_table`` adds exact per-round ``down_bytes`` / ``up_bytes``,
    computed one client at a time (the engine computes them batched; the
    two are equal to the byte).  ``strategy``/``ste`` train under a zoo
    compressor; ``ef`` is the population's error-feedback state
    (``feedback.init_ef_state``), whose rows of the surviving clients are
    updated in place, and an EF strategy without it raises ``ValueError``.
    ``obs`` records the round with its metric bundle, built from the f32
    mean the server interpolated toward, after the round's arithmetic."""
    takes_ef = ef_lib.takes_residual(omc, strategy)
    if takes_ef and ef is None:
        raise ValueError(f"strategy {strategy.label!r} uses error feedback: pass the ef= "
                         f"state (repro_torch.compress.feedback.init_ef_state)")
    with torch.no_grad():
        server_f32 = decompress_tree(server_params)
    ids = cohort_lib.sample_cohort(key, plan, round_index).tolist()
    alive = cohort_lib.survival_mask(key, plan, round_index).tolist()
    if client_update is None:
        client_update = make_client_update(family, cfg, specs, omc, sim, strategy, ste)

    models, losses = [], []
    up_bytes = 0
    for cid, ok in zip(ids, alive):
        if not ok:
            continue
        batches = client_batches(data_fn, cid, round_index, sim.local_steps)
        if takes_ef:
            m, loss, rows = client_update(server_f32, batches, round_index, cid,
                                          {k: v[cid] for k, v in ef.items()})
            for k, v in ef.items():
                v[cid] = rows[k]
        else:
            m, loss = client_update(server_f32, batches, round_index, cid)
        models.append(m)
        losses.append(float(loss))
        if wire_table is not None:
            if strategy is None:
                up_bytes += accounting.client_upload_bytes(wire_table, omc, round_index, cid)
            else:
                up_bytes += accounting.client_upload_bytes_strategy(wire_table, omc, strategy,
                                                                    round_index, cid)

    with torch.no_grad():
        dev = next(tree_items(models[0]))[1].device
        w = torch.ones((len(models),), dtype=torch.float32, device=dev)
        mean_model = cohort_lib.aggregate_weighted(stack_trees(models), w)
        new_f32 = tree_map(lambda old, new: old + sim.server_lr * (new - old), server_f32,
                           mean_model)
        new_storage = compress_params(new_f32, specs, omc) if omc.enabled else new_f32
    metrics = dict(loss=float(torch.tensor(losses, dtype=torch.float32).mean()),
                   cohort=len(models), dropped=int(plan.cohort_size - len(models)))
    if wire_table is not None:
        metrics["down_bytes"] = (accounting.download_bytes_train(wire_table, omc, strategy)
                                 * plan.cohort_size)
        metrics["up_bytes"] = int(up_bytes)
    if obs is not None:
        bundle = None
        if obs.collect_metrics:
            bundle = obs_metrics.server_round_bundle(specs, server_f32, new_storage,
                                                     mean_model, sim.server_lr)
            bundle["alive"] = torch.tensor(float(len(models)), device=dev)
            if takes_ef:
                rows = torch.tensor(ids, dtype=torch.int64)
                bundle["ef_norm"] = obs_metrics.ef_rows_norm(
                    {k: v[rows.to(v.device)] for k, v in ef.items()})
        obs.record("round", bundle, round=int(round_index), **metrics)
    return new_storage, metrics


def init_storage(family, cfg, omc: OMCConfig, specs, init_key: prng.Key, init_params,
                 device):
    """(f32 params, storage tree): ``init_params`` if given, else
    ``family.init(init_key, cfg)`` on ``device``, the reference's params
    within ``prng.normal``'s 4 ulp."""
    if init_params is None:
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' (or CPU "
                               "init_params) to train on the CPU")
        init_params = family.init(init_key, cfg, device)
    with torch.no_grad():
        storage = compress_params(init_params, specs, omc) if omc.enabled else init_params
    return init_params, storage


def run_training(family, cfg, omc: OMCConfig, sim: SimConfig, plan: cohort_lib.CohortPlan,
                 data_fn, init_key: prng.Key, num_rounds: int,
                 eval_fn: Optional[Callable[[Any, int], float]] = None, eval_every: int = 10,
                 init_params=None, log: Optional[Callable[[str], None]] = None,
                 wire: bool = False, strategy=None, ste: bool = False, ef=None, obs=None,
                 device="cuda"):
    """Full simulation loop.  Returns ``(final storage, history)``.

    Runs where ``init_params`` lie, else on ``device`` (default the card)
    from a random init seeded by ``init_key``; the cohort stream is
    ``fold_in(init_key, 0xC047)``, as in the reference.  Under an EF
    strategy pass ``ef=feedback.init_ef_state(...)`` to see the final
    residuals (updated in place), or leave it None to have one allocated.
    ``obs`` adds a ``round`` wall span and record per round."""
    specs = family.param_specs(cfg)
    params, storage = init_storage(family, cfg, omc, specs, init_key, init_params, device)
    client_update = make_client_update(family, cfg, specs, omc, sim, strategy, ste)
    if ef is None and ef_lib.takes_residual(omc, strategy):
        ef = ef_lib.init_ef_state(params, specs, omc, plan.num_clients)
    wire_table = accounting.build_wire_table(params, specs, omc) if wire else None
    key = prng.fold_in(init_key, 0xC047)
    history = []
    for r in range(num_rounds):
        with null_span(obs, "round", round=r):
            storage, metrics = run_round(family, cfg, specs, omc, sim, storage, data_fn, plan,
                                         r, key, client_update=client_update,
                                         wire_table=wire_table, strategy=strategy, ste=ste,
                                         ef=ef, obs=obs)
        if eval_fn is not None and (r + 1) % eval_every == 0:
            metrics["eval"] = float(eval_fn(decompress_tree(storage), r))
        history.append(dict(round=r, **metrics))
        if log and ((r + 1) % eval_every == 0 or r == 0):
            log(f"round {r + 1}/{num_rounds}: " + ", ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in metrics.items()))
    return storage, history
