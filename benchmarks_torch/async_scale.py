#!/usr/bin/env python3
"""Async vs sync throughput under straggler traces, on the port
(counterpart of ``benchmarks/async_scale.py``).

Runs the event-driven buffered runtime
(``repro_torch.federated.async_engine``) against the barrier-synchronous
engine (``repro_torch.federated.engine``) on the same population, model,
data stream and Pareto heavy-tail latency trace:

  * completed client updates per virtual second: a sync round's makespan
    is the largest latency over the invited cohort (the barrier), while the
    async runtime keeps aggregating with stragglers in flight.  The run
    asserts async >= 2x sync, the reference's gate;
  * wall time per aggregate: sync rounds and async flushes timed
    interleaved (one of each per iteration, medians), so host noise hits
    both alike;
  * loss drop per wire MB at a matched budget of completed client updates,
    the async bytes from the ``AsyncWireStats`` ledger.

    python3 benchmarks_torch/async_scale.py            # conformer_s at full width, on the card
    python3 benchmarks_torch/async_scale.py --smoke    # the reference's CI config, on the CPU
    python3 benchmarks_torch/async_scale.py --reference-row [--device cpu]

``--smoke`` is the reference's smoke run (its 2-layer, d 32 conformer,
cohort 8, buffer 4, 3 rounds, batch 1, 8 frames) through the plain
versions.  Without it the model is conformer_s' published config (17
layers, d 512) on the card at the reference's cohort 64 and buffer 16: the
engine's round holds the cohort's 64 trained f32 models once, in their
stack, beside the trained models the async runner keeps cached, and an
H100 80GB peaks at about 53 GB.  ``--reference-row`` runs the reference's
default row (``REFERENCE_ROW``: its 2-layer, d 32 conformer at cohort 64,
buffer 16, 5 rounds, batch 1, 8 frames, Pareto 1.5) on the card, or with
``--device cpu`` on the CPU, so that its columns can be set beside the
reference's; it writes ``async_scale_reference_row.json``.  The row
records the process's peak device memory.  Writes
``experiments/bench_torch/async_scale.json`` (``async_scale_smoke.json``
with ``--smoke``); ``--trace``
also records the run's telemetry (``repro_torch.obs``: a wall span per sync
round and per flush, a virtual span per async client round, a metric bundle
per flush) into ``experiments/obs/async_scale.{obs.jsonl,perfetto.json}``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmarks_torch.common import (bench_device, device_name, print_table,  # noqa: E402
                                     save_result)
from repro_torch.api.session import sync  # noqa: E402
from repro_torch.configs import conformer_s  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.omc import OMCConfig  # noqa: E402
from repro_torch.data.synthetic import make_frame_task  # noqa: E402
from repro_torch.federated import accounting, async_engine, engine, simulate, traces  # noqa: E402
from repro_torch.federated.cohort import CohortPlan  # noqa: E402
from repro_torch.federated.state import compress_params  # noqa: E402
from repro_torch.models import conformer as cf  # noqa: E402
from repro_torch.obs import Obs, null_span  # noqa: E402

SMOKE_CFG = cf.ConformerConfig(n_layers=2, d_model=32, n_heads=4, d_ff=64, n_classes=16, d_in=8)
# the reference's default row: its CFG (SMOKE_CFG here) at its run()'s defaults
REFERENCE_ROW = dict(cohort=64, buffer_goal=16, rounds=5, batch=1, seq=8, alpha=1.5,
                     fmt="S1E3M7")


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def bench(cfg, cohort: int, buffer_goal: int, rounds: int, batch: int, seq: int, alpha: float,
          fmt: str, seed: int, device, obs=None) -> dict:
    """One comparison row: the whole population takes part in both paths;
    sync invites everyone each round, async buffers K uploads.  ``obs``
    traces the run (a ``sync_round`` wall span per timed sync round, the
    runner's spans and flush records); the caller flushes it."""
    omc = OMCConfig.parse(fmt)
    sim = simulate.SimConfig(local_steps=1, client_lr=0.1)
    task = make_frame_task(d_in=cfg.d_in, n_classes=cfg.n_classes, seq_len=seq,
                           num_clients=cohort, device=str(device))
    data_fn = lambda c, r, s: task.batch(c, r, s, batch)  # noqa: E731
    spec = engine.CohortSpec(CohortPlan(num_clients=cohort, cohort_size=cohort))
    trace = traces.ParetoTrace(seed=seed, latency=1.0, alpha=alpha)
    key = prng.PRNGKey(seed)
    specs = cf.param_specs(cfg)
    params = cf.init(key, cfg, device)
    storage0 = compress_params(params, specs, omc)
    table = accounting.build_wire_table(params, specs, omc)
    rkey = prng.fold_in(key, 0xC047)
    budget = cohort * rounds  # matched completed-client-update budget

    round_fn = engine.make_round_fn(cf, cfg, specs, omc, sim, spec, data_fn)
    runner = async_engine.AsyncRunner(
        cf, cfg, omc, sim, async_engine.AsyncConfig(buffer_goal=buffer_goal, decay=0.5), trace,
        num_clients=cohort, data_fn=data_fn, init_params=params, obs=obs)
    del params
    # warm-up of both paths, untimed; the warm round trains from the initial
    # model, so its loss is the baseline of both quality-per-byte deltas
    _, warm = engine.run_round_vectorized(cf, cfg, specs, omc, sim, storage0, data_fn, spec, 0,
                                          rkey, round_fn=round_fn)
    init_loss = float(warm["loss"])
    runner.run_until(flushes=1)
    sync(device)

    sync_makespans = [max(trace.round_latency(c, r, 0.0) for c in range(cohort))
                      for r in range(rounds)]
    # interleaved wall timing: one sync round, one async flush, repeat
    sync_t, flush_t = [], []
    sync_storage, sync_metrics = storage0, None
    r = 1
    while r <= rounds or runner.completed < budget:
        if r <= rounds:
            t0 = time.perf_counter()
            with null_span(obs, "sync_round", round=r):
                sync_storage, sync_metrics = engine.run_round_vectorized(
                    cf, cfg, specs, omc, sim, sync_storage, data_fn, spec, r, rkey,
                    round_fn=round_fn, wire_table=table)
            sync(device)
            sync_t.append(time.perf_counter() - t0)
        if runner.completed < budget:
            t0 = time.perf_counter()
            runner.run_until(flushes=1)
            sync(device)
            flush_t.append(time.perf_counter() - t0)
        r += 1

    # virtual-time throughput: the barrier against no barrier
    sync_ups = cohort * rounds / float(np.sum(sync_makespans))
    async_ups = runner.completed / runner.clock
    speedup = async_ups / sync_ups

    # quality per wire byte at the matched update budget; timed sync rounds
    # are 1..rounds (the warm round took index 0), and PPQ upload masks
    # depend on the round index
    sync_loss = float(sync_metrics["loss"])
    sync_wire = (table.download_bytes(omc) * cohort * rounds
                 + sum(int(accounting.cohort_upload_bytes(table, omc, rr,
                                                          list(range(cohort))).sum())
                       for rr in range(1, rounds + 1)))
    async_loss = runner.history[-1]["loss"]
    snap = runner.stats.snapshot()
    async_wire = snap["down_bytes"] + snap["up_bytes"]
    mb = 1024.0 * 1024.0
    return dict(
        cohort=cohort,
        buffer_goal=buffer_goal,
        alpha=alpha,
        update_budget=budget,
        sync_updates_per_vs=round(sync_ups, 4),
        async_updates_per_vs=round(async_ups, 4),
        vtime_speedup=round(speedup, 2),
        sync_wall_s_per_round=round(_median(sync_t), 4),
        async_wall_s_per_flush=round(_median(flush_t), 4),
        sync_wall_updates_per_s=round(cohort / _median(sync_t), 2),
        async_wall_updates_per_s=round(buffer_goal / _median(flush_t), 2),
        init_loss=round(init_loss, 4),
        sync_loss=round(sync_loss, 4),
        async_loss=round(async_loss, 4),
        sync_wire_mb=round(sync_wire / mb, 3),
        async_wire_mb=round(async_wire / mb, 3),
        sync_quality_per_mb=round((init_loss - sync_loss) / (sync_wire / mb), 5),
        async_quality_per_mb=round((init_loss - async_loss) / (async_wire / mb), 5),
        async_stale_fraction=round(snap["stale_fraction"], 4),
        async_dropped_fraction=round(snap["dropped_fraction"], 4),
        peak_in_flight_mb=round(snap["peak_in_flight_bytes"] / mb, 3),
        peak_device_gb=(round(torch.cuda.max_memory_allocated(device) / 1e9, 2)
                        if device.type == "cuda" else None),
        device=device_name(device),
    )


def run(cohort=64, buffer_goal=16, rounds=5, batch=1, seq=8, alpha=1.5, fmt="S1E3M7", seed=0,
        smoke=False, trace=False, reference_row=False, device=None):
    """One row.  ``smoke``: the CPU and the 2-layer config; ``reference_row``:
    the 2-layer config on ``device`` (the card by default); else conformer_s
    on the card."""
    rounds = max(1, min(rounds, int(os.environ.get("BENCH_ROUNDS", rounds))))
    if reference_row:
        device = torch.device(device or "cuda")
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device cpu to run the "
                               "reference's row on the CPU")
    else:
        device = bench_device(smoke)
    cfg = SMOKE_CFG if smoke or reference_row else conformer_s.config()
    obs = Obs(run_name="async_scale") if trace else None
    row = bench(cfg, cohort, buffer_goal, rounds, batch, seq, alpha, fmt, seed, device, obs=obs)
    print_table("Async vs sync under Pareto stragglers (virtual + wall clock)", [row],
                ["cohort", "buffer_goal", "sync_updates_per_vs", "async_updates_per_vs",
                 "vtime_speedup", "sync_wall_s_per_round", "async_wall_s_per_flush",
                 "async_stale_fraction", "async_dropped_fraction", "peak_in_flight_mb",
                 "peak_device_gb"])
    print_table("Quality per wire byte at matched update budget", [row],
                ["update_budget", "init_loss", "sync_loss", "async_loss", "sync_wire_mb",
                 "async_wire_mb", "sync_quality_per_mb", "async_quality_per_mb"])
    name = ("async_scale_reference_row" if reference_row else
            "async_scale_smoke" if smoke else "async_scale")
    path = save_result(name, dict(smoke=smoke, fmt=fmt, rounds=rounds, batch=batch, seq_len=seq,
                                  rows=[row]))
    print(f"wrote {path}")
    if obs is not None:
        paths = obs.flush()
        print(f"wrote {paths['jsonl']} and {paths['perfetto']}")
    # the reference's gate: non-barrier aggregation beats the straggler
    # barrier by >= 2x in completed updates per virtual second
    assert row["vtime_speedup"] >= 2.0, row
    return [row]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's CI config on the CPU: cohort 8, buffer 4, 3 rounds")
    ap.add_argument("--cohort", type=int, default=64)
    ap.add_argument("--buffer", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=8)
    ap.add_argument("--alpha", type=float, default=1.5,
                    help="Pareto tail index (smaller = heavier stragglers)")
    ap.add_argument("--fmt", default="S1E3M7")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", action="store_true",
                    help="record obs telemetry (JSONL + Perfetto under experiments/obs/)")
    ap.add_argument("--reference-row", action="store_true",
                    help="the reference's default row (its 2-layer config, cohort 64, buffer "
                         "16, 5 rounds) on --device")
    ap.add_argument("--device", default="cuda",
                    help="the device of --reference-row (default: cuda)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    if args.reference_row:
        rows = run(**REFERENCE_ROW, seed=args.seed, trace=args.trace, reference_row=True,
                   device=args.device)
        print(f"\n{rows[0]['device']}: {time.perf_counter() - t0:.1f} s")
        return 0
    if args.smoke:
        cohort, buffer_goal, rounds = 8, 4, args.rounds or 3
    else:
        cohort, buffer_goal, rounds = args.cohort, args.buffer, args.rounds or 5
    run(cohort=cohort, buffer_goal=buffer_goal, rounds=rounds, batch=args.batch, seq=args.seq,
        alpha=args.alpha, fmt=args.fmt, seed=args.seed, smoke=args.smoke, trace=args.trace)
    print(f"\n{device_name(bench_device(args.smoke))}: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
