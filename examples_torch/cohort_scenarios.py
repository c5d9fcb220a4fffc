#!/usr/bin/env python3
"""Scenario driver for the vectorized cohort engine (port of
``examples/cohort_scenarios.py``).

Each scenario is a self-contained federated run on the engine
(:mod:`repro_torch.federated.engine`) exercising one of the situations the
paper and its related work care about:

  * ``noniid``     — Dirichlet(α) label/speaker skew via the pluggable
                     partitioner (paper Table 3)
  * ``mixed``      — heterogeneous cohort: S1E3M7 + S1E4M3 + f32 device
                     tiers with per-tier wire accounting (paper §2.2 formats)
  * ``stragglers`` — over-provisioned cohort with failures + a report-goal
                     deadline dropping the slowest clients
  * ``shards``     — pathological shard partition (2 sources/client)

    python3 examples_torch/cohort_scenarios.py --scenario noniid
    python3 examples_torch/cohort_scenarios.py --scenario mixed --smoke --device cpu

``--smoke`` shrinks rounds for CI; every run prints per-round loss, cohort
survival, and exact down/up wire bytes.  Runs on the card (``--device``,
default ``cuda``); without one it raises unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.core import prng  # noqa: E402
from repro_torch.core.omc import OMCConfig  # noqa: E402
from repro_torch.data.partition import (DirichletPartition, IIDPartition,  # noqa: E402
                                        ShardPartition, make_partitioned_batch_fn)
from repro_torch.data.synthetic import make_frame_task  # noqa: E402
from repro_torch.federated import engine, simulate  # noqa: E402
from repro_torch.federated.cohort import CohortPlan  # noqa: E402
from repro_torch.models import conformer as cf  # noqa: E402

CFG = cf.ConformerConfig(n_layers=2, d_model=32, n_heads=4, d_ff=64, n_classes=16, d_in=8)
SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


def _task(num_clients: int, device: str):
    return make_frame_task(d_in=CFG.d_in, n_classes=CFG.n_classes, seq_len=24,
                           num_clients=num_clients, device=device)


def _run(spec, data_fn, omc, rounds, label, device, local_steps=1):
    sim = simulate.SimConfig(local_steps=local_steps, client_lr=0.1)
    _, hist = engine.run_training_vectorized(
        cf, CFG, omc, sim, spec, data_fn, prng.PRNGKey(0), num_rounds=rounds,
        eval_every=max(rounds // 4, 1), log=print, device=device)
    first, last = hist[0], hist[-1]
    print(f"[{label}] loss {first['loss']:.4f} -> {last['loss']:.4f}; "
          f"last round: {last['cohort']} reports, "
          f"down={last['down_bytes']}B up={last['up_bytes']}B")
    return hist


@scenario
def noniid(rounds: int, device: str):
    """Dirichlet(0.1) speaker skew vs IID, same format (paper Table 3)."""
    task = _task(32, device)
    plan = CohortPlan(num_clients=32, cohort_size=8)
    omc = OMCConfig.parse("S1E3M7")
    for name, part in [("iid", IIDPartition()), ("dirichlet(0.1)", DirichletPartition(alpha=0.1))]:
        data_fn = make_partitioned_batch_fn(task, part, batch_size=4)
        _run(engine.CohortSpec(plan), data_fn, omc, rounds, f"noniid/{name}", device)


@scenario
def shards(rounds: int, device: str):
    """Each client holds 2 of 16 sources — the pathological non-IID split."""
    task = _task(32, device)
    plan = CohortPlan(num_clients=32, cohort_size=8)
    data_fn = make_partitioned_batch_fn(task, ShardPartition(shards_per_client=2), batch_size=4)
    _run(engine.CohortSpec(plan), data_fn, OMCConfig.parse("S1E3M7"), rounds, "shards", device)


@scenario
def mixed(rounds: int, device: str):
    """Mixed-bitwidth cohort: 11-bit, 8-bit, and f32 device tiers."""
    task = _task(48, device)
    plan = CohortPlan(num_clients=48, cohort_size=12)
    spec = engine.CohortSpec(
        plan, tiers=(engine.profile("s1e3m7"), engine.profile("s1e4m3"), engine.profile("f32")),
        quotas=(6, 3, 3))
    data_fn = lambda c, r, s: task.batch(c, r, s, 4)  # noqa: E731
    print(f"tiers: {[t.name for t in spec.tiers]}, quotas {spec.quotas} "
          f"(population striped round-robin)")
    _run(spec, data_fn, OMCConfig.parse("S1E3M7"), rounds, "mixed", device)


@scenario
def stragglers(rounds: int, device: str):
    """Over-provisioned cohort, 20% failures, report goal at 6 of 12."""
    task = _task(48, device)
    plan = CohortPlan(num_clients=48, cohort_size=12, report_goal=6, failure_rate=0.2,
                      straggler_rate=0.25)
    data_fn = lambda c, r, s: task.batch(c, r, s, 4)  # noqa: E731
    hist = _run(engine.CohortSpec(plan), data_fn, OMCConfig.parse("S1E3M7"), rounds,
                "stragglers", device)
    drops = sum(h["dropped"] for h in hist)
    print(f"[stragglers] {drops} reports dropped across {rounds} rounds "
          f"(goal 6/12 + failures); every round still aggregated >= 1 report")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", choices=sorted(SCENARIOS) + ["all"], default="all")
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--smoke", action="store_true", help="2 rounds, CI-sized")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")
    rounds = args.rounds or (2 if args.smoke else 8)
    names = sorted(SCENARIOS) if args.scenario == "all" else [args.scenario]
    for name in names:
        print(f"\n=== scenario: {name} ===")
        SCENARIOS[name](rounds, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
