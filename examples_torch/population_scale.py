#!/usr/bin/env python3
"""Sharded population runtime walkthrough (port of ``examples/population_scale.py``).

Runs tree-aggregated, streamed federated rounds over a population far
larger than any cohort the flat engine could stack (DESIGN.md §14):

  * the population's per-client state (counters, and optionally packed
    error-feedback residuals) lives in a
    :class:`repro_torch.scale.PopulationStore` partitioned by a
    :class:`~repro_torch.scale.ShardLayout`,
  * each round streams the cohort through one fixed-capacity function per
    shard chunk (peak memory set by the capacity, not the population),
  * the shards' partial sums combine at the root with the engine's server
    step (held to the flat engine in ``tests/test_torch_population.py``).

    python3 examples_torch/population_scale.py
    python3 examples_torch/population_scale.py \\
        --population 50000 --shards 16 --capacity 64 --rounds 3 --fused
    python3 examples_torch/population_scale.py --smoke --device cpu

``--fused`` aggregates in the fused transport-encoded mode (DESIGN.md
§13/§14); ``--ef-fmt S1E4M14`` trains under top-k with error-feedback
residuals packed at rest in that format and reports the at-rest byte
ratio.  ``--smoke`` shrinks the run for CI (population 200, cohort 8,
capacity 4, 2 shards, 1 round).  Runs on the card (``--device``, default
``cuda``); without one it raises unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.compress import get_strategy  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.omc import OMCConfig  # noqa: E402
from repro_torch.data.synthetic import make_frame_task  # noqa: E402
from repro_torch.federated import simulate  # noqa: E402
from repro_torch.federated.cohort import CohortPlan  # noqa: E402
from repro_torch.models import conformer as cf  # noqa: E402
from repro_torch.scale import PopulationStore, ShardLayout, run_training_sharded  # noqa: E402

CFG = cf.ConformerConfig(n_layers=2, d_model=32, n_heads=4, d_ff=64, n_classes=16, d_in=8)
OMC = OMCConfig.parse("S1E3M7")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--population", type=int, default=10_000)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--cohort", type=int, default=64)
    ap.add_argument("--capacity", type=int, default=16,
                    help="stream chunk width (bounds peak memory)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--fused", action="store_true",
                    help="compressed-domain aggregation (DESIGN.md §13/§14)")
    ap.add_argument("--ef-fmt", default=None,
                    help="train under EF top-k with residuals packed at rest in this format "
                         "(e.g. S1E4M14)")
    ap.add_argument("--smoke", action="store_true", help="a CI-sized run")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.population, args.shards, args.cohort = 200, 2, 8
        args.capacity, args.rounds = 4, 1
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu")

    plan = CohortPlan(num_clients=args.population, cohort_size=args.cohort, failure_rate=0.1)
    layout = ShardLayout(args.population, args.shards)
    task = make_frame_task(d_in=CFG.d_in, n_classes=CFG.n_classes, seq_len=24,
                           num_clients=args.population, device=str(device))
    data_fn = lambda c, r, s: task.batch(c, r, s, 4)  # noqa: E731
    sim = simulate.SimConfig(local_steps=2, client_lr=0.1)
    key = prng.PRNGKey(0)

    strategy = store = None
    if args.ef_fmt:
        if args.fused:
            raise SystemExit("--fused and --ef-fmt are mutually exclusive (zoo strategies "
                             "gate fused off, DESIGN.md §13)")
        strategy = get_strategy("topk", density=0.25)
        store = PopulationStore(layout, device=device)
        store.init_ef(cf.init(key, CFG, "meta"), cf.param_specs(CFG), OMC, ef_fmt=args.ef_fmt)

    print(f"population={args.population} shards={args.shards} cohort={args.cohort} "
          f"capacity={args.capacity} fused={args.fused} ef_fmt={args.ef_fmt} device={device}")
    storage, history, ledger = run_training_sharded(
        cf, CFG, OMC, sim, plan, layout, data_fn, key, args.rounds, capacity=args.capacity,
        fused_agg=args.fused, strategy=strategy, store=store, wire=strategy is None, log=print,
        device=device)
    for h in history:
        print(f"round {h['round']}: loss={h['loss']:.4f} cohort={h['cohort']} "
              f"shards={h['shards']} chunks={h['chunks']}")
    if ledger is not None:
        snap = ledger.snapshot()
        print(f"streamed {snap['clients_streamed']} client updates in {snap['chunks']} chunks; "
              f"peak resident model bytes bounded by {snap['peak_bound_bytes']:,} "
              f"(capacity-determined)")
    if store is not None:
        rep = store.bytes_report()
        print(f"EF at rest: {rep['ef_at_rest_bytes']:,} B ({rep['ef_fmt']}) vs f32 "
              f"{rep['ef_fp32_bytes']:,} B -> x{rep['ef_at_rest_bytes'] / rep['ef_fp32_bytes']:.2f}")


if __name__ == "__main__":
    main()
