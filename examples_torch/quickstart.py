#!/usr/bin/env python3
"""Quickstart: OMC in 40 lines — compress, train a round, inspect savings
(port of ``examples/quickstart.py``).

    python3 examples_torch/quickstart.py                        # on the card
    python3 examples_torch/quickstart.py --smoke --device cpu   # 2 rounds on the CPU

The reference's configuration: a 4-layer GQA transformer (d 128, vocab 512),
S1E3M7 storage, 10 rounds on the IID LM task.  ``--smoke`` runs 2 rounds;
without a card it raises unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.core import prng  # noqa: E402
from repro_torch.core.omc import OMCConfig  # noqa: E402
from repro_torch.data.synthetic import make_lm_task  # noqa: E402
from repro_torch.federated.round import make_round_fn  # noqa: E402
from repro_torch.federated.state import init_state, state_bytes_report  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.optim import fedavg  # noqa: E402

# a small GQA transformer LM
CFG = tr.TransformerConfig(n_layers=4, d_model=128, n_heads=8, n_kv_heads=4, d_ff=256,
                           vocab=512)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="2 rounds, CI-sized")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")
    rounds = 2 if args.smoke else 10

    # Online Model Compression: 11-bit S1E3M7 storage, per-variable
    # transformation, weights-only policy (paper §2)
    omc = OMCConfig.parse("S1E3M7")

    state = init_state(prng.PRNGKey(0), tr, CFG, omc, fedavg(1.0), device=device)
    report = state_bytes_report(state.params)
    print(f"parameters:       {report['num_params'] / 1e6:.2f} M")
    print(f"storage (u16):    {report['container_ratio']:.0%} of FP32")
    print(f"wire ({omc.fmt.bits}-bit):    {report['packed_ratio']:.0%} of FP32")

    # one federated round = compressed transport -> local step -> aggregate ->
    # re-compress
    task = make_lm_task(vocab=512, seq_len=64, num_clients=8, device=str(device))
    round_fn = make_round_fn(tr, CFG, omc, fedavg(1.0), client_lr=0.05)
    for r in range(rounds):
        state, metrics = round_fn(state, task.batch(r % 8, r, 0, 8))
        print(f"round {r}: loss={float(metrics['loss']):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
