#!/usr/bin/env python3
"""Scenario driver for the async federated runtime (port of
``examples/async_scenarios.py``).

Each scenario runs the event-driven buffered runtime
(:mod:`repro_torch.federated.async_engine`) under one of the
availability/latency regimes production fleets actually see:

  * ``heavytail``     — Pareto straggler latency: the sync barrier waits
                        for the p99 device, the async buffer does not
  * ``diurnal``       — sine-modulated availability over a virtual day
                        with per-client timezone phase: check-ins roll
                        around the clock, buffers fill slower at night
  * ``async_vs_sync`` — same population, matched update budget: wire
                        bytes, staleness profile, and loss for the
                        buffered runtime vs the barrier engine

    python3 examples_torch/async_scenarios.py --scenario heavytail
    python3 examples_torch/async_scenarios.py --smoke --device cpu

``--smoke`` shrinks flush counts for CI; every run prints per-flush loss,
staleness, virtual clock, and the exact async wire ledger.  Runs on the card
(``--device``, default ``cuda``); without one it raises unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.core import prng  # noqa: E402
from repro_torch.core.omc import OMCConfig  # noqa: E402
from repro_torch.data.synthetic import make_frame_task  # noqa: E402
from repro_torch.federated import async_engine, engine, simulate, traces  # noqa: E402
from repro_torch.federated.cohort import CohortPlan  # noqa: E402
from repro_torch.models import conformer as cf  # noqa: E402

CFG = cf.ConformerConfig(n_layers=2, d_model=32, n_heads=4, d_ff=64, n_classes=16, d_in=8)
OMC = OMCConfig.parse("S1E3M7")
SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


def _data_fn(num_clients: int, device: str):
    task = make_frame_task(d_in=CFG.d_in, n_classes=CFG.n_classes, seq_len=24,
                           num_clients=num_clients, device=device)
    return lambda c, r, s: task.batch(c, r, s, 4)


def _run(trace, acfg, flushes, label, device, num_clients=32, local_steps=1):
    sim = simulate.SimConfig(local_steps=local_steps, client_lr=0.1)
    _, hist, runner = async_engine.run_async_training(
        cf, CFG, OMC, sim, acfg, trace, _data_fn(num_clients, device), prng.PRNGKey(0),
        num_clients=num_clients, flushes=flushes, log=print, device=device)
    first, last = hist[0], hist[-1]
    print(f"[{label}] loss {first['loss']:.4f} -> {last['loss']:.4f}; "
          f"virtual clock {last['clock']:.1f}s, "
          f"{last['completed']} updates, staleness_max {last['staleness_max']}, "
          f"down={last['down_bytes']}B up={last['up_bytes']}B "
          f"(stale {last['stale_up_bytes']}B)")
    return hist, runner


@scenario
def heavytail(flushes: int, device: str):
    """Pareto(1.3) stragglers, buffer K=8 of 32 clients, staleness decay."""
    hist, runner = _run(traces.ParetoTrace(latency=1.0, alpha=1.3),
                        async_engine.AsyncConfig(buffer_goal=8, decay=0.5), flushes,
                        "heavytail", device)
    stale = runner.stats.n_stale / max(runner.stats.n_uploads, 1)
    print(f"[heavytail] {stale:.0%} of uploads arrived stale and were "
          f"decay-weighted instead of blocking a barrier")


@scenario
def diurnal(flushes: int, device: str):
    """Virtual day of 24s, 90% availability swing, timezone phase spread."""
    hist, _ = _run(traces.DiurnalTrace(interval=1.0, period=24.0, depth=0.9),
                   async_engine.AsyncConfig(buffer_goal=8), flushes, "diurnal", device)
    gaps = [round(b["clock"] - a["clock"], 2) for a, b in zip(hist, hist[1:])]
    print(f"[diurnal] inter-flush gaps (virtual s): {gaps} — buffers fill "
          f"slower through the trough of the day")


@scenario
def async_vs_sync(flushes: int, device: str):
    """Same 32 clients, matched update budget: buffered vs barrier."""
    trace = traces.ParetoTrace(latency=1.0, alpha=1.5)
    acfg = async_engine.AsyncConfig(buffer_goal=8, decay=0.5)
    hist, runner = _run(trace, acfg, flushes, "async", device)

    plan = CohortPlan(num_clients=32, cohort_size=32)
    sim = simulate.SimConfig(local_steps=1, client_lr=0.1)
    rounds = max(runner.completed // 32, 1)
    _, sync_hist = engine.run_training_vectorized(
        cf, CFG, OMC, sim, engine.CohortSpec(plan), _data_fn(32, device), prng.PRNGKey(0),
        num_rounds=rounds, device=device)
    sync_vtime = sum(max(trace.round_latency(c, r, 0.0) for c in range(32))
                     for r in range(rounds))
    down = sum(h["down_bytes"] for h in sync_hist)
    up = sum(h["up_bytes"] for h in sync_hist)
    print(f"[sync]  loss {sync_hist[0]['loss']:.4f} -> "
          f"{sync_hist[-1]['loss']:.4f}; virtual time {sync_vtime:.1f}s for "
          f"{rounds * 32} updates, down={down}B up={up}B")
    print(f"[async_vs_sync] updates/virtual-s: "
          f"async {runner.completed / runner.clock:.2f} vs "
          f"sync {rounds * 32 / sync_vtime:.2f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", choices=sorted(SCENARIOS) + ["all"], default="all")
    ap.add_argument("--flushes", type=int, default=None)
    ap.add_argument("--smoke", action="store_true", help="3 flushes, CI-sized")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")
    flushes = args.flushes or (3 if args.smoke else 12)
    names = sorted(SCENARIOS) if args.scenario == "all" else [args.scenario]
    for name in names:
        print(f"\n=== scenario: {name} ===")
        SCENARIOS[name](flushes, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
