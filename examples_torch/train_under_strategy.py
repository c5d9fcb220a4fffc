#!/usr/bin/env python3
"""Train a federated model under any zoo compressor (port of
``examples/train_under_strategy.py``).

Picks a path (the loop, the engine or the async runtime) and a strategy
from the zoo, and trains a small Conformer with that compressor on the
wire: per-client error-feedback residuals for the sparse strategies, and
the exact byte ledger beside the loss curve.

    python3 examples_torch/train_under_strategy.py                  # engine + EF top-k, on the card
    python3 examples_torch/train_under_strategy.py --strategy ternary
    python3 examples_torch/train_under_strategy.py --strategy omc --path loop
    python3 examples_torch/train_under_strategy.py --path async --rounds 6
    python3 examples_torch/train_under_strategy.py --no-error-feedback   # plain top-k
    python3 examples_torch/train_under_strategy.py --smoke --device cpu

``--strategy none`` trains the hardcoded OMC path, which the ``omc``
strategy reproduces bit for bit.  ``--strategy pipeline`` implies
``--no-wire``: its DEFLATE stage depends on the data, so there is no byte
plan to report.  Without a card it raises unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch import compress  # noqa: E402
from repro_torch.compress import feedback  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.omc import OMCConfig  # noqa: E402
from repro_torch.core.store import decompress_tree  # noqa: E402
from repro_torch.data.synthetic import make_frame_task  # noqa: E402
from repro_torch.federated import async_engine, engine, simulate, traces  # noqa: E402
from repro_torch.federated.cohort import CohortPlan  # noqa: E402
from repro_torch.models import conformer as cf  # noqa: E402
from repro_torch.models.common import IDENTITY_MAT  # noqa: E402

CFG = cf.ConformerConfig(n_layers=2, d_model=32, n_heads=4, d_ff=64, n_classes=16, d_in=8)
OMC = OMCConfig.parse("S1E3M7")


def _strategy(args):
    if args.strategy == "none":
        return None
    kw = {}
    if args.strategy == "topk":
        kw = dict(density=args.density, error_feedback=not args.no_error_feedback)
    elif args.strategy in ("ternary", "pipeline"):
        kw = dict(error_feedback=not args.no_error_feedback)
    return compress.get_strategy(args.strategy, **kw)


def _eval(params_f32, batches) -> float:
    with torch.no_grad():
        return float(sum(cf.loss(CFG, params_f32, b, IDENTITY_MAT) for b in batches)
                     / len(batches))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--strategy", default="topk",
                    choices=["none"] + compress.available_strategies())
    ap.add_argument("--path", default="engine", choices=["loop", "engine", "async"])
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--density", type=float, default=0.1)
    ap.add_argument("--no-error-feedback", action="store_true",
                    help="sparse strategies: drop the residual accumulator")
    ap.add_argument("--no-wire", action="store_true",
                    help="skip byte accounting (forced for pipeline)")
    ap.add_argument("--smoke", action="store_true", help="2 rounds, tiny eval")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")
    if args.smoke:
        args.rounds = 2

    strategy = _strategy(args)
    wire = not (args.no_wire or args.strategy == "pipeline")
    rounds = args.rounds
    plan = CohortPlan(num_clients=8, cohort_size=4)
    task = make_frame_task(d_in=CFG.d_in, n_classes=CFG.n_classes, seq_len=24,
                           num_clients=plan.num_clients, device=str(device))
    data_fn = lambda c, r, s: task.batch(c, r, s, 4)  # noqa: E731
    eval_batches = [task.batch(100 + i, 10_000, 0, 4) for i in range(1 if args.smoke else 4)]
    sim = simulate.SimConfig(local_steps=2, client_lr=0.1)
    key = prng.PRNGKey(0)
    label = strategy.label if strategy is not None else "omc (hardcoded)"
    print(f"path={args.path}  strategy={label}  rounds={rounds}  wire={wire}  device={device}")

    ef = None
    if feedback.takes_residual(OMC, strategy):
        ef = feedback.init_ef_state(cf.init(key, CFG, device), cf.param_specs(CFG), OMC,
                                    plan.num_clients)
        print(f"error-feedback state: {len(ef)} vars, "
              f"{feedback.ef_bytes(ef) / 2**20:.2f} MiB resident")

    if args.path == "loop":
        storage, hist = simulate.run_training(
            cf, CFG, OMC, sim, plan, data_fn, key, num_rounds=rounds, eval_every=10_000,
            wire=wire, strategy=strategy, ef=ef, device=device)
    elif args.path == "engine":
        storage, hist = engine.run_training_vectorized(
            cf, CFG, OMC, sim, engine.CohortSpec(plan), data_fn, key, num_rounds=rounds,
            eval_every=10_000, wire=wire, strategy=strategy, ef=ef, device=device)
    else:
        storage, hist, runner = async_engine.run_async_training(
            cf, CFG, OMC, sim, async_engine.AsyncConfig(buffer_goal=plan.cohort_size),
            traces.ParetoTrace(alpha=1.5), data_fn, key, num_clients=plan.num_clients,
            flushes=rounds, wire=wire, strategy=strategy, device=device)
        ef = runner.ef

    for h in hist:
        line = f"  round {h.get('round', h.get('version', '?'))}: loss={h['loss']:.4f}"
        if wire and "up_bytes" in h:
            line += f"  up={h['up_bytes'] / 2**20:.3f}MiB  down={h['down_bytes'] / 2**20:.3f}MiB"
        print(line)

    print(f"final eval loss: {_eval(decompress_tree(storage), eval_batches):.4f}")
    if wire:
        up = sum(h.get("up_bytes", 0) for h in hist)
        down = sum(h.get("down_bytes", 0) for h in hist)
        if args.path == "async":  # the ledger's rows are cumulative there
            up, down = hist[-1]["up_bytes"], hist[-1]["down_bytes"]
        print(f"cumulative wire: up={up / 2**20:.2f}MiB down={down / 2**20:.2f}MiB")
    if ef is not None:
        print(f"residual norm after training: {feedback.total_norm(ef):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
