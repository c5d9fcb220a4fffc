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

Compression strategies, straight-through estimation, error feedback and
observability (``strategy``, ``ste``, ``ef``, ``obs``) belong to later
slices (ROADMAP A7, A9) and raise ``NotImplementedError``.
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

from . import accounting
from . import cohort as cohort_lib
from .state import compress_params


def check_unported(strategy=None, ste: bool = False, ef=None, obs=None) -> None:
    """Raise for the arguments of later slices instead of ignoring them."""
    if strategy is not None or ste or ef is not None:
        raise NotImplementedError("compression strategies, STE and error feedback are not "
                                  "ported yet (ROADMAP A7)")
    if obs is not None:
        raise NotImplementedError("observability (obs=) is not ported yet (ROADMAP A9)")


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


def client_view(params_f32, specs, omc: OMCConfig, round_index: int, client_id: int,
                strategy=None, ste: bool = False):
    """The client's PPQ-masked quantize→dequantize(+PVT) view of ``params_f32``."""
    check_unported(strategy, ste)
    if not omc.enabled:
        return params_f32
    names = accounting.selected_names(params_f32, specs, omc)
    if not names:
        return params_f32
    mask = ppq_mask(omc.ppq_key(), round_index, client_id, len(names),
                    omc.quantize_fraction).tolist()
    index = {n: i for i, n in enumerate(names)}

    def f(path, leaf):
        i = index.get(path_str(path))
        return qdq_pvt_leaf(leaf, omc) if i is not None and mask[i] else leaf

    return tree_map_with_path(f, params_f32)


@dataclasses.dataclass
class SimConfig:
    local_steps: int = 1
    client_lr: float = 0.05
    server_lr: float = 1.0


def sgd_steps(family, cfg, params, batches, lr: float) -> Tuple[Any, torch.Tensor]:
    """One plain SGD step (``p − lr·g``, autograd through ``family.loss``) per
    batch of ``batches``; returns (params, losses ``[steps]``)."""
    losses = []
    for batch in batches:
        leaves = {}

        def track(path, p):
            p = p.detach().requires_grad_(True)
            leaves[path] = p
            return p

        params = tree_map_with_path(track, params)
        loss = family.loss(cfg, params, batch, IDENTITY_MAT)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        with torch.no_grad():
            params = tree_map_with_path(lambda path, p: p - lr * grads[path], params)
        losses.append(loss.detach())
    return params, torch.stack(losses)


def make_client_fn(family, cfg, specs, omc: OMCConfig, sim: SimConfig, strategy=None,
                   ste: bool = False, takes_residual: Optional[bool] = None):
    """Single-client round body:
    ``(server_f32, batches, round, client_id) -> (model, mean loss)``.

    ``batches`` is a list of ``local_steps`` batches.  The loop
    (:func:`run_round`) and the engine (``federated.engine``) both run this
    one body, which is what the engine's equivalence rests on.
    """
    check_unported(strategy, ste, ef=True if takes_residual else None)

    def client_update(server_f32, batches, round_index: int, client_id: int):
        eff = client_view(server_f32, specs, omc, round_index, client_id)
        trained, losses = sgd_steps(family, cfg, eff, batches, sim.client_lr)
        with torch.no_grad():
            out = client_view(trained, specs, omc, round_index, client_id)
        return out, losses.mean()

    return client_update


def make_client_update(family, cfg, specs, omc: OMCConfig, sim: SimConfig, strategy=None,
                       ste: bool = False, takes_residual: Optional[bool] = None):
    """:func:`make_client_fn` (the reference jits it; PyTorch runs eagerly)."""
    return make_client_fn(family, cfg, specs, omc, sim, strategy, ste, takes_residual)


def client_batches(data_fn, client_id: int, round_index: int, local_steps: int):
    return [data_fn(client_id, round_index, s) for s in range(local_steps)]


def run_round(family, cfg, specs, omc: OMCConfig, sim: SimConfig, server_params,
              data_fn: Callable[[int, int, int], Any], plan: cohort_lib.CohortPlan,
              round_index: int, key: prng.Key, client_update=None, wire_table=None,
              strategy=None, ste: bool = False, ef=None, obs=None
              ) -> Tuple[Any, Dict[str, float]]:
    """One faithful round; returns ``(new server storage, metrics)``.

    ``wire_table`` adds exact per-round ``down_bytes`` / ``up_bytes``,
    computed one client at a time (the engine computes them batched; the
    two are equal to the byte)."""
    check_unported(strategy, ste, ef, obs)
    with torch.no_grad():
        server_f32 = decompress_tree(server_params)
    ids = cohort_lib.sample_cohort(key, plan, round_index).tolist()
    alive = cohort_lib.survival_mask(key, plan, round_index).tolist()
    if client_update is None:
        client_update = make_client_update(family, cfg, specs, omc, sim)

    models, losses = [], []
    up_bytes = 0
    for cid, ok in zip(ids, alive):
        if not ok:
            continue
        m, loss = client_update(server_f32, client_batches(data_fn, cid, round_index,
                                                           sim.local_steps), round_index, cid)
        models.append(m)
        losses.append(float(loss))
        if wire_table is not None:
            up_bytes += accounting.client_upload_bytes(wire_table, omc, round_index, cid)

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
        metrics["down_bytes"] = (accounting.download_bytes_train(wire_table, omc)
                                 * plan.cohort_size)
        metrics["up_bytes"] = int(up_bytes)
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
    ``fold_in(init_key, 0xC047)``, as in the reference."""
    check_unported(strategy, ste, ef, obs)
    specs = family.param_specs(cfg)
    params, storage = init_storage(family, cfg, omc, specs, init_key, init_params, device)
    client_update = make_client_update(family, cfg, specs, omc, sim)
    wire_table = accounting.build_wire_table(params, specs, omc) if wire else None
    key = prng.fold_in(init_key, 0xC047)
    history = []
    for r in range(num_rounds):
        storage, metrics = run_round(family, cfg, specs, omc, sim, storage, data_fn, plan, r,
                                     key, client_update=client_update, wire_table=wire_table)
        if eval_fn is not None and (r + 1) % eval_every == 0:
            metrics["eval"] = float(eval_fn(decompress_tree(storage), r))
        history.append(dict(round=r, **metrics))
        if log and ((r + 1) % eval_every == 0 or r == 0):
            log(f"round {r + 1}/{num_rounds}: " + ", ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in metrics.items()))
    return storage, history
