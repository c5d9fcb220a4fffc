"""Optimizers as (init, update) pairs over parameter trees (port of
``repro.optim.optimizers``).

``update(grads, state, params) -> (updates, new_state)`` returns *additive*
updates (apply as ``params + updates``), the optax convention, so that the
federated server can treat the aggregated client delta as a sign-flipped
"gradient" for the server optimizer (the FedOpt framework).

The states are ``NamedTuple``s with the reference's names and field order,
which fixes a checkpoint's leaf order (``repro_torch.checkpoint``); a step
``count`` is a Python int.  Trees are nested dicts of tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Union

import torch

from repro_torch.core.tree import tree_map

Schedule = Union[float, Callable[[int], Any]]


def _lr_at(lr: Schedule, step: int) -> torch.Tensor:
    """The rate at ``step`` as a 0-d f32 tensor (on the CPU: a scalar operand)."""
    return torch.as_tensor(lr(step) if callable(lr) else lr, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., Any]  # (grads, state, params=None) -> (updates, state)


class _CountState(NamedTuple):
    count: int


def sgd(lr: Schedule) -> Optimizer:
    def init(params):
        return _CountState(0)

    def update(grads, state, params=None):
        s = _lr_at(lr, state.count)
        return tree_map(lambda g: -s * g, grads), _CountState(state.count + 1)

    return Optimizer(init, update)


class _MomentumState(NamedTuple):
    count: int
    mu: Any


def momentum(lr: Schedule, beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params):
        return _MomentumState(0, tree_map(torch.zeros_like, params))

    def update(grads, state, params=None):
        s = _lr_at(lr, state.count)
        mu = tree_map(lambda m, g: beta * m + g, state.mu, grads)
        if nesterov:
            upd = tree_map(lambda m, g: -s * (beta * m + g), mu, grads)
        else:
            upd = tree_map(lambda m: -s * m, mu)
        return upd, _MomentumState(state.count + 1, mu)

    return Optimizer(init, update)


class _AdamState(NamedTuple):
    count: int
    mu: Any
    nu: Any


def adamw(lr: Schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return _AdamState(0, tree_map(torch.zeros_like, params),
                          tree_map(torch.zeros_like, params))

    def update(grads, state, params=None):
        c = state.count + 1
        s = _lr_at(lr, state.count)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(lambda n, g: b2 * n + (1 - b2) * torch.square(g), state.nu, grads)
        cf = torch.tensor(float(c), dtype=torch.float32)
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** cf
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** cf

        def u(m, n, p=None):
            upd = -s * (m / bc1) / (torch.sqrt(n / bc2) + eps)
            if weight_decay and p is not None:
                upd = upd - s * weight_decay * p
            return upd

        upd = tree_map(u, mu, nu) if params is None else tree_map(u, mu, nu, params)
        return upd, _AdamState(c, mu, nu)

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Server optimizers (FedOpt family): they consume the *negated mean client
# delta* as the gradient, grads = -mean_delta.
# ---------------------------------------------------------------------------


def fedavg(server_lr: Schedule = 1.0, server_momentum: float = 0.0) -> Optimizer:
    """FedAvg: params += server_lr * mean_delta (optionally with momentum)."""
    return momentum(server_lr, server_momentum) if server_momentum else sgd(server_lr)


def fedadam(server_lr: Schedule = 1e-2, b1: float = 0.9, b2: float = 0.99,
            eps: float = 1e-3) -> Optimizer:
    return adamw(server_lr, b1, b2, eps)


class _State(NamedTuple):
    """fedadagrad's state (the reference defines it inside ``fedadagrad``)."""

    count: int
    nu: Any


def fedadagrad(server_lr: Schedule = 1e-2, eps: float = 1e-3) -> Optimizer:
    def init(params):
        return _State(0, tree_map(torch.zeros_like, params))

    def update(grads, state, params=None):
        s = _lr_at(server_lr, state.count)
        nu = tree_map(lambda n, g: n + torch.square(g), state.nu, grads)
        upd = tree_map(lambda g, n: -s * g / (torch.sqrt(n) + eps), grads, nu)
        return upd, _State(state.count + 1, nu)

    return Optimizer(init, update)
