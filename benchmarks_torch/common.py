"""Shared harness of the paper-table reruns on the port (counterpart of
``benchmarks/common.py``).

Every table trains the paper's Conformer under the faithful federated
simulation (``repro_torch.federated.simulate.run_training``: per-client PPQ
views, transport re-quantization, storage re-compression each round) and
compares f32 with OMC on loss curves and exact byte accounting, as the
reference's scripts do (loss in place of WER: there is no LibriSpeech
offline).

Where it runs:

  * by default, on the card at full width: conformer_s' published config
    (17 layers, d 512, ff 2048, 1024 classes; ``configs.conformer_s.config``),
    random weights drawn as the reference draws them (``prng``), the
    storage re-compression through ``quantize_stats``, the decode through
    ``dequantize``, the PVT-off rows' codes through ``quantize``.  Without a
    card this raises; it does not fall back to the CPU;
  * with ``smoke=True`` (``--smoke`` on a script's command line): the
    reference's ``smoke_config()`` on the CPU, through the plain versions,
    where its numbers can be held to the reference's (tests/test_torch_tables.py).

The budget knobs are the reference's, by the same environment variables and
with the same defaults: ``BENCH_ROUNDS`` (24), ``BENCH_CLIENTS`` (8),
``BENCH_COHORT`` (4), ``BENCH_BATCH`` (4); the data keeps the reference's
shape (32 frames a sequence).  Results go to ``experiments/bench_torch/``;
a process that ran on the card records the card's name and power limit
beside each payload (``card``, as ``nvidia-smi`` gives them).

Speed: the first ``run_fl`` of a process on a device first runs one untimed
warm round, so that no row's ``rounds_per_min`` holds the device's cold
start (on the card: the context, cuBLAS's handles, loading the kernels).
``speed_pct`` is then computed from ``rounds_per_min`` as the reference
computes it.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from repro_torch.api.session import sync
from repro_torch.configs import conformer_s
from repro_torch.core import prng
from repro_torch.core.omc import OMCConfig, bytes_report
from repro_torch.core.store import decompress_tree
from repro_torch.data.synthetic import make_frame_task
from repro_torch.federated import simulate
from repro_torch.federated.cohort import CohortPlan
from repro_torch.models import conformer
from repro_torch.models.common import IDENTITY_MAT

BENCH_ROUNDS = int(os.environ.get("BENCH_ROUNDS", 24))
BENCH_CLIENTS = int(os.environ.get("BENCH_CLIENTS", 8))
BENCH_COHORT = int(os.environ.get("BENCH_COHORT", 4))
BENCH_BATCH = int(os.environ.get("BENCH_BATCH", 4))
OUT_DIR = Path(__file__).resolve().parents[1] / "experiments" / "bench_torch"

_WARMED = set()  # device types whose untimed warm round has run in this process


def bench_device(smoke: bool) -> torch.device:
    """The CPU for ``smoke``; else the card, or ``RuntimeError``."""
    if smoke:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --smoke to run the reference's "
                           "smoke config on the CPU")
    return torch.device("cuda")


def conformer_setup(iid: bool = True, domain: int = 0, seed: int = 0, smoke: bool = False,
                    device=None):
    """``(family, cfg, task, data_fn, eval_batches)`` as the reference's, at
    full width on the card, or the smoke config on the CPU with ``smoke``;
    ``device`` puts either on another device."""
    cfg = conformer_s.smoke_config() if smoke else conformer_s.config()
    task = make_frame_task(d_in=cfg.d_in, n_classes=cfg.n_classes, seq_len=32,
                           num_clients=BENCH_CLIENTS, iid=iid, seed=seed, domain=domain,
                           device=str(device or bench_device(smoke)))
    data_fn = lambda c, r, s: task.batch(c, r, s, BENCH_BATCH)  # noqa: E731
    eval_batches = [task.batch(100 + i, 10_000, 0, BENCH_BATCH) for i in range(4)]
    return conformer, cfg, task, data_fn, eval_batches


def eval_loss(family, cfg, params, batches) -> float:
    """Mean loss over ``batches``, summed in f32 as the reference sums it."""
    with torch.no_grad():
        return float(sum(family.loss(cfg, params, b, IDENTITY_MAT) for b in batches)
                     / len(batches))


def device_name(device) -> str:
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def run_fl(family, cfg, omc: OMCConfig, data_fn, eval_batches, rounds: Optional[int] = None,
           seed: int = 0, local_steps: int = 1, client_lr: float = 0.1,
           device="cuda") -> Dict:
    """One row: ``simulate.run_training`` from ``PRNGKey(seed)`` on ``device``
    (where ``data_fn``'s batches lie), evaluated every ``rounds // 6``
    rounds; the reference's row keys, plus ``device``."""
    rounds = rounds or BENCH_ROUNDS
    device = torch.device(device)
    sim = simulate.SimConfig(local_steps=local_steps, client_lr=client_lr)
    plan = CohortPlan(num_clients=BENCH_CLIENTS, cohort_size=BENCH_COHORT)

    def train(n, **kw):
        return simulate.run_training(family, cfg, omc, sim, plan, data_fn, prng.PRNGKey(seed),
                                     num_rounds=n, device=device, **kw)

    if device.type not in _WARMED:
        train(1)
        sync(device)
        _WARMED.add(device.type)
    t0 = time.perf_counter()
    params, hist = train(rounds, eval_every=max(rounds // 6, 1),
                         eval_fn=lambda p, r: eval_loss(family, cfg, p, eval_batches))
    sync(device)
    dt = time.perf_counter() - t0
    final_eval = eval_loss(family, cfg, decompress_tree(params), eval_batches)
    return dict(
        fmt=omc.fmt.name,
        pvt=omc.pvt,
        fraction=omc.quantize_fraction,
        weights_only=omc.policy.weights_only,
        rounds=rounds,
        final_eval=final_eval,
        train_curve=[h["loss"] for h in hist],
        eval_curve=[h.get("eval") for h in hist if "eval" in h],
        wall_s=round(dt, 1),
        rounds_per_min=round(60 * rounds / dt, 2),
        device=device_name(device),
    )


def bytes_summary(family, cfg, omc: OMCConfig, device="cuda") -> Dict:
    """``omc.bytes_report`` of ``family.init(PRNGKey(0), cfg)`` on ``device``."""
    return bytes_report(family.init(prng.PRNGKey(0), cfg, device), omc)


@functools.lru_cache(maxsize=1)
def card() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()


def save_result(name: str, payload) -> str:
    """Write ``payload`` to ``OUT_DIR/<name>.json``; if this process has used
    the card, with ``card`` beside it (a dict's key, or each row's)."""
    if torch.cuda.is_initialized():
        if isinstance(payload, dict):
            payload = dict(payload, card=card())
        else:
            payload = [dict(row, card=card()) for row in payload]
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    path = OUT_DIR / f"{name}.json"
    path.write_text(json.dumps(payload, indent=1))
    return str(path)


def print_table(title: str, rows: List[Dict], cols: List[str]):
    print(f"\n== {title} ==")
    widths = {c: max(len(c), max((len(_fmt(r.get(c))) for r in rows), default=0))
              for c in cols}
    print("  ".join(c.ljust(widths[c]) for c in cols))
    for r in rows:
        print("  ".join(_fmt(r.get(c)).ljust(widths[c]) for c in cols))


def main(run) -> None:
    """A table script's command line: ``run()`` on the card at full width, or
    ``run(smoke=True)`` with ``--smoke``; prints the device and wall time."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's smoke config, on the CPU")
    args = ap.parse_args()
    t0 = time.perf_counter()
    run(smoke=args.smoke)
    print(f"\n{device_name(bench_device(args.smoke))}: {time.perf_counter() - t0:.1f} s")


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.4f}"
    return str(v)
