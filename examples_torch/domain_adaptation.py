#!/usr/bin/env python3
"""Domain adaptation under OMC (paper Table 2 scenario; port of
``examples/domain_adaptation.py``).

Pretrains a streaming Conformer on a source domain in FP32, then adapts to
a target domain with aggressive 6-bit (S1E2M3) OMC — adaptation tolerates
much coarser formats than from-scratch training.

    python3 examples_torch/domain_adaptation.py [--smoke] [--device cpu]

The reference's configuration: conformer_s' smoke config, 8 clients, cohort
4, 16 rounds a phase (``--smoke``: 2).  Runs on the card (``--device``,
default ``cuda``); without one it raises unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.omc import OMCConfig  # noqa: E402
from repro_torch.core.store import decompress_tree  # noqa: E402
from repro_torch.data.synthetic import make_frame_task  # noqa: E402
from repro_torch.federated import simulate  # noqa: E402
from repro_torch.federated.cohort import CohortPlan  # noqa: E402
from repro_torch.models import conformer as cf  # noqa: E402
from repro_torch.models.common import IDENTITY_MAT  # noqa: E402

cfg = get_arch("conformer_s").smoke_config()
sim = simulate.SimConfig(local_steps=1, client_lr=0.1)
plan = CohortPlan(num_clients=8, cohort_size=4)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="2 rounds per phase (CI-sized)")
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")
    rounds = args.rounds or (2 if args.smoke else 16)
    src = make_frame_task(d_in=cfg.d_in, n_classes=cfg.n_classes, seq_len=32, num_clients=8,
                          domain=0, device=args.device)
    tgt = make_frame_task(d_in=cfg.d_in, n_classes=cfg.n_classes, seq_len=32, num_clients=8,
                          domain=1, device=args.device)

    def evaluate(params):
        batches = [tgt.batch(100 + i, 9999, 0, 4) for i in range(4)]
        with torch.no_grad():
            return float(sum(cf.loss(cfg, params, b, IDENTITY_MAT) for b in batches)
                         / len(batches))

    print("pretraining on source domain (FP32)...")
    pre, _ = simulate.run_training(
        cf, cfg, OMCConfig.parse("S1E8M23"), sim, plan, lambda c, r, s: src.batch(c, r, s, 4),
        prng.PRNGKey(0), num_rounds=rounds, log=print, device=args.device)
    print(f"target-domain loss before adaptation: {evaluate(decompress_tree(pre)):.4f}")

    print("adapting on target domain with 6-bit OMC (S1E2M3)...")
    adapted, _ = simulate.run_training(
        cf, cfg, OMCConfig.parse("S1E2M3"), sim, plan, lambda c, r, s: tgt.batch(c, r, s, 4),
        prng.PRNGKey(1), num_rounds=rounds, init_params=decompress_tree(pre), log=print)
    print(f"target-domain loss after 6-bit adaptation: "
          f"{evaluate(decompress_tree(adapted)):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
