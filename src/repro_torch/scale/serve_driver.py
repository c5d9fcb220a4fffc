"""Serve-side scale driver: hot-swap under sustained query traffic (port of
``repro.scale.serve_driver``, DESIGN.md §14).

While the sharded runtime lands training rounds, the serving side must keep
answering queries and ingest each new round's payload without pausing.
:func:`run_serve_under_swap` drives a
:class:`repro_torch.api.session.ServeSession` with a synthetic query stream,
hot-swapping freshly produced payloads between queries, and measures:

  * steady-state query latency (p50 / p95 over the whole run),
  * swap wall time (payload decode and the new storage ready),
  * **swap stall**: the latency of the first query after each swap over
    the steady-state median.  The session's serve functions are reused
    across swaps, so this should be about 1x; a stall (a rebuild, a
    reallocation) would show as a large ratio, which the benchmark asserts
    against.

Used by ``benchmarks_torch/population_scale.py`` and
``examples_torch/population_scale.py``.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from repro_torch.api.session import sync
from repro_torch.obs import null_span


def _percentile(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else 0.0


def synthetic_token_batch(batch: int, prefill_len: int, vocab: int, seed: int = 0,
                          device="cuda") -> Dict[str, torch.Tensor]:
    """Deterministic token-model query batch (transformer-family inputs): the
    reference's tokens, from numpy's generator, on ``device``."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(batch, prefill_len))
    return dict(tokens=torch.as_tensor(toks, dtype=torch.int64).to(device))


def run_serve_under_swap(session, payloads: Iterable[bytes], *,
                         make_query: Callable[[int], Dict[str, torch.Tensor]],
                         queries_per_swap: int = 8, batch: int = 1, max_len: int = 32,
                         decode_steps: int = 4, warmup_queries: int = 2,
                         obs=None) -> Dict[str, Any]:
    """Interleave query traffic with payload hot-swaps; return latency stats.

    ``payloads`` is the stream of wire payloads training produces (full or
    delta: ``ServeSession.hot_swap`` takes both); between consecutive swaps
    this issues ``queries_per_swap`` generate calls built by
    ``make_query(query_index)``.  Every latency is wall time to the tokens
    being ready on the session's device (``torch.cuda.synchronize`` on the
    card).

    ``obs`` (DESIGN.md §15) records a wall span per query and per hot-swap
    plus one ``kind=serve`` record carrying the returned stats.
    """
    if queries_per_swap < 1:
        raise ValueError(f"queries_per_swap must be >= 1, got {queries_per_swap}")
    q_ms: List[float] = []
    first_after_swap_ms: List[float] = []
    qi = 0

    def one_query(record: Optional[List[float]] = None) -> float:
        nonlocal qi
        cache = session.init_cache(batch, max_len)
        query = make_query(qi)
        sync(session.device)
        t0 = time.perf_counter()
        with null_span(obs, "query", index=qi), torch.no_grad():
            session.generate(query, cache, decode_steps)
            sync(session.device)
        ms = (time.perf_counter() - t0) * 1e3
        qi += 1
        if record is not None:
            record.append(ms)
        return ms

    for _ in range(max(warmup_queries, 1)):  # first-use costs land here
        one_query()

    swaps_before = session.swaps
    for payload in payloads:
        for _ in range(queries_per_swap - 1):
            one_query(q_ms)
        with null_span(obs, "hot_swap", swap=int(session.swaps)):
            session.hot_swap(payload)
        first_after_swap_ms.append(one_query(q_ms))

    p50 = _percentile(q_ms, 50)
    stats = session.serve_stats()
    result = dict(
        queries=len(q_ms),
        swaps=int(session.swaps - swaps_before),
        query_ms_p50=p50,
        query_ms_p95=_percentile(q_ms, 95),
        swap_ms_mean=stats["swap_ms_mean"],
        swap_ms_max=stats["swap_ms_max"],
        first_query_after_swap_ms_p50=_percentile(first_after_swap_ms, 50),
        # post-swap first-query latency over the steady-state median: about
        # 1x when the serve functions survive the swap (they must)
        swap_stall_ratio=_percentile(first_after_swap_ms, 50) / p50 if p50 > 0 else 0.0,
    )
    if obs is not None:
        obs.record("serve", **result)
    return result
