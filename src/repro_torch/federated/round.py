"""The federated training round, its eval and the serve functions (port of
``repro.federated.round``).

One round over the compressed server state (the reference's, DESIGN.md §4,
on one card):

  1. every compressed layer is decoded + PVT-corrected on the fly inside
     its ``checkpoint`` (``dequantize`` on CUDA), grafted onto a zero
     gradient sink (``materialize.QParam``);
  2. the batch's loss and its gradient w.r.t. the sinks, i.e. w.r.t. the
     effective (decoded) weights: the batch mean *is* the cohort mean of
     the client deltas;
  3. the server optimizer applies ``lr·grads`` (FedOpt: the server's
     gradient is the negated mean delta) to the decoded values, and each
     selected leaf is re-compressed (``quantize_stats`` on CUDA, or
     ``quantize`` with PVT off): no f32 master persists between rounds.

The reference's storage-sharding constraints and hints have no counterpart
on one card.  The round runs eagerly (the reference's is ``jit``-ed by its
caller); the same function of the state, to f32 reassociation.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.core import prng
from repro_torch.core.omc import OMCConfig
from repro_torch.core.store import compress_variable, is_compressed
from repro_torch.core.tree import tree_items, tree_map
from repro_torch.optim import Optimizer

from .materialize import OMCMaterializer, make_sinks, pack_qparams
from .state import TrainState, n_stack_axes


def make_round_fn(family, cfg, omc: OMCConfig, server_opt: Optimizer,
                  client_lr=1e-2) -> Callable[[TrainState, Any],
                                              Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Build the federated-round step ``round_fn(state, batch) -> (state,
    {"loss", "grad_norm"})``; ``client_lr`` is a float or a schedule of the
    round."""
    specs = family.param_specs(cfg)
    mat = OMCMaterializer()

    def round_fn(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        sinks = make_sinks(state.params)
        loss = family.loss(cfg, pack_qparams(state.params, sinks), batch, mat)
        leaves = [s for _, s in tree_items(sinks)]
        by_sink = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
        grads = tree_map(lambda s: by_sink[id(s)], sinks)
        del sinks, leaves, by_sink

        lr = torch.as_tensor(client_lr(state.round) if callable(client_lr) else client_lr,
                             dtype=torch.float32)
        # FedOpt: server-grad = -mean_delta = +lr * grads
        upd, new_opt_state = server_opt.update(tree_map(lambda g: lr * g, grads),
                                               state.opt_state)

        def leaf_update(spec, p, u):
            if is_compressed(p):
                return compress_variable(p.dequantize() + u, p.fmt, pvt=omc.pvt,
                                         batch_axes=n_stack_axes(spec, u))
            return p + u

        new_state = TrainState(params=tree_map(leaf_update, specs, state.params, upd),
                               opt_state=new_opt_state, round=state.round + 1,
                               rng=prng.fold_in(state.rng, state.round))
        # per-leaf sums of squares, as the reference sums them
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for _, g in tree_items(grads)))
        return new_state, dict(loss=loss.detach(), grad_norm=gnorm)

    return round_fn


def make_eval_fn(family, cfg):
    """Forward-only loss on the compressed (or f32) server params."""
    mat = OMCMaterializer()

    def eval_fn(params, batch) -> torch.Tensor:
        with torch.no_grad():
            return family.loss(cfg, pack_qparams(params), batch, mat)

    return eval_fn


def make_serve_fns(family, cfg):
    """(prefill_fn, decode_fn) over a storage tree — the serving path."""
    mat = OMCMaterializer()

    def prefill_fn(params, batch, cache):
        return family.prefill(cfg, params, batch, mat, cache)

    def decode_fn(params, cache, tokens):
        return family.decode_step(cfg, params, cache, tokens, mat)

    return prefill_fn, decode_fn
