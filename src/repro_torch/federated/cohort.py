"""Cohort sampling, client failures and stragglers (port of ``repro.federated.cohort``).

The server invites ``cohort_size`` clients and closes the round once
``report_goal`` reports arrive.  A per-round survival mask reproduces that;
FedAvg weighting renormalizes over the survivors.  Every draw comes from
``core.prng``, so cohorts and masks equal the reference's bit for bit.
Cohort ids and masks are small control data and live on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import prng
from repro_torch.core.tree import tree_map


def validate_report_goal(goal: int, cohort_size: int, *, what: str = "report_goal") -> int:
    """Shared gate for "close after N reports" knobs: ``1 <= N <= cohort``."""
    goal = int(goal)
    if not 1 <= goal <= cohort_size:
        raise ValueError(f"{what} must satisfy 1 <= {what} <= {cohort_size}, got {goal}")
    return goal


@dataclasses.dataclass(frozen=True)
class CohortPlan:
    num_clients: int  # population size
    cohort_size: int  # invited per round
    report_goal: Optional[int] = None  # round closes at this many reports
    failure_rate: float = 0.0  # iid client dropout probability
    straggler_rate: float = 0.0  # fraction dropped at the deadline (slowest)

    def __post_init__(self):
        if self.cohort_size < 1 or self.cohort_size > self.num_clients:
            raise ValueError(f"cohort_size must satisfy 1 <= cohort_size <= "
                             f"{self.num_clients}, got {self.cohort_size}")
        if self.report_goal is None:
            object.__setattr__(self, "report_goal", self.cohort_size)
        validate_report_goal(self.report_goal, self.cohort_size)


def sample_cohort(key: prng.Key, plan: CohortPlan, round_index: int) -> torch.Tensor:
    """int64[cohort_size] client ids (host), sampled without replacement."""
    perm = prng.permutation(prng.fold_in(key, round_index), plan.num_clients)
    return perm[: plan.cohort_size]


def survival_mask(key: prng.Key, plan: CohortPlan, round_index: int) -> torch.Tensor:
    """bool[cohort_size] (host): True = the client's report arrives in time.

    Failures are iid drops; stragglers are a further slowest-k cut at the
    deadline, from random latencies.  At least one client always survives:
    when every client failed, the fastest by raw latency makes it.
    """
    k = prng.fold_in(prng.fold_in(key, round_index), 0x57A6)
    kf, kl = prng.split(k)
    alive = prng.uniform(kf, (plan.cohort_size,)) >= plan.failure_rate
    raw_latency = prng.uniform(kl, (plan.cohort_size,))
    latency = torch.where(alive, raw_latency, torch.full_like(raw_latency, float("inf")))
    n_keep = max(1, min(plan.report_goal,
                        int(round(plan.cohort_size * (1.0 - plan.straggler_rate)))))
    order = torch.argsort(latency, stable=True)
    keep = torch.zeros((plan.cohort_size,), dtype=torch.bool)
    keep[order[:n_keep]] = True
    keep = keep & alive
    if not bool(keep.any()):
        keep = torch.zeros_like(keep)
        keep[torch.argmin(raw_latency)] = True
    return keep


def aggregate_weighted(deltas, weights: torch.Tensor):
    """Weighted mean over the leading client axis, per leaf.

    ``deltas``: tree of ``[C, ...]`` leaves; ``weights``: ``[C]`` (0 for
    dropped clients).  Renormalizes by ``max(Σw, 1e-9)``.
    """
    wsum = torch.clamp(weights.sum(), min=1e-9)

    def f(x):
        w = weights.to(x.device).reshape((-1,) + (1,) * (x.ndim - 1))
        return (x * w).sum(0) / wsum.to(x.device)

    return tree_map(f, deltas)
