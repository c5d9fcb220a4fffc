"""Partial Parameter Quantization (paper §2.5), port of ``repro.core.partial``.

Each client quantizes only a subset (default 90%) of the quantizable weight
matrices; the selection varies per round and per client.  It is an
exact-fraction choice (the rank of per-variable uniform scores),
deterministic in (seed, round, client), so every participant recomputes the
same mask.  The scores come from ``core.prng``, which reproduces
``jax.random`` bit for bit, so the port's masks are the reference's.
"""

from __future__ import annotations

from typing import Sequence

import torch

from . import prng


def num_selected(num_vars: int, fraction: float) -> int:
    return int(round(num_vars * float(fraction)))


def ppq_mask(seed_key: prng.Key, round_index: int, client_id: int, num_vars: int,
             fraction: float, device=None) -> torch.Tensor:
    """bool[num_vars]: True = quantize this variable for this (round, client)."""
    if fraction >= 1.0:
        return torch.ones((num_vars,), dtype=torch.bool, device=device)
    if fraction <= 0.0:
        return torch.zeros((num_vars,), dtype=torch.bool, device=device)
    k = num_selected(num_vars, fraction)
    key = prng.fold_in(prng.fold_in(seed_key, round_index), client_id)
    scores = prng.uniform(key, (num_vars,), device)
    ranks = torch.argsort(torch.argsort(scores, stable=True), stable=True)
    return ranks < k


def ppq_masks_batch(seed_key: prng.Key, round_index: int, client_ids: Sequence[int],
                    num_vars: int, fraction: float, device=None) -> torch.Tensor:
    """bool[num_clients, num_vars]: one :func:`ppq_mask` per client."""
    rows = [ppq_mask(seed_key, round_index, int(c), num_vars, fraction, device)
            for c in client_ids]
    if not rows:
        return torch.zeros((0, num_vars), dtype=torch.bool, device=device)
    return torch.stack(rows)
