#!/usr/bin/env python3
"""The client axis on the card: the engine's round batched against serial,
and the conformer's depthwise conv in four forms, one client and C batched.

    python3 benchmarks_torch/bench_client_axis.py            # conformer_s, full width, on the card
    python3 benchmarks_torch/bench_client_axis.py --smoke --device cpu

The configuration of chip_smoke.py's phase 7: conformer_s, random weights
from seed 0, the synthetic frame task (80-dim frames, 256 frames, batch 8,
16 clients), cohort 8 with failure rate 0.25, 2 local steps at lr 0.1,
S1E3M7 with PVT and PPQ 0.9.  (a) One fused engine round from one storage
at ``client_chunk`` 1, None, 1, None, in that order, each timed on the
host clock around ``torch.cuda.synchronize``: the first of each is its
first call in the process, the second warm.  (b) One SGD step of one
client (``simulate.sgd_steps``) and of ``--cohort`` clients batched
(``conformer.loss_clients``), each timed over repetitions after a warm
one, with the depthwise conv as the module has it (the k shifted windows
stacked on a leading tap axis) and in three other forms: the windows
stacked on a last tap axis, the k products added one by one, and
``unfold`` (whose backward runs through vmap's per-sample fallback).
Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import conformer_s  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.omc import OMCConfig  # noqa: E402
from repro_torch.core.store import decompress_tree  # noqa: E402
from repro_torch.core.tree import tree_map  # noqa: E402
from repro_torch.data.synthetic import make_frame_task  # noqa: E402
from repro_torch.federated import accounting, engine, simulate  # noqa: E402
from repro_torch.federated.cohort import CohortPlan  # noqa: E402
from repro_torch.federated.state import compress_params  # noqa: E402
from repro_torch.models import conformer  # noqa: E402
from repro_torch.models.common import group_norm, layer_norm  # noqa: E402


def _glu_padded(cfg, w, x):
    h = layer_norm(x, w["conv_scale"], w["conv_bias"], cfg.norm_eps)
    a, g = (h @ w["conv_pw1"]).chunk(2, dim=-1)
    h = a * torch.sigmoid(g)
    k = cfg.conv_kernel
    left = k - 1 if cfg.causal_conv else (k - 1) // 2
    return F.pad(h, (0, 0, left, k - 1 - left)), k, x.shape[1]


def _finish(cfg, w, x, acc):
    h = group_norm(acc, w["conv_gn_scale"], w["conv_gn_bias"], cfg.gn_groups, cfg.norm_eps)
    return x + F.silu(h) @ w["conv_pw2"]


def conv_taps_last(cfg, w, x):
    hp, k, s = _glu_padded(cfg, w, x)
    win = torch.stack([hp[:, i:i + s] for i in range(k)], -1)
    return _finish(cfg, w, x, (win * w["conv_dw"].T).sum(-1))


def conv_shifted_adds(cfg, w, x):
    hp, k, s = _glu_padded(cfg, w, x)
    acc = hp[:, 0:s] * w["conv_dw"][0]
    for i in range(1, k):
        acc = acc + hp[:, i:i + s] * w["conv_dw"][i]
    return _finish(cfg, w, x, acc)


def conv_unfold(cfg, w, x):
    hp, k, s = _glu_padded(cfg, w, x)
    return _finish(cfg, w, x, (hp.unfold(1, k, 1) * w["conv_dw"].T).sum(-1))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true", help="conformer_s' smoke config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cohort", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    device = torch.device(args.device)
    on_card = device.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = None
    if on_card:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True, timeout=60).stdout.strip()
        print(card)

    def timed(fn, reps=1):
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        if on_card:
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    cfg = conformer_s.smoke_config() if args.smoke else conformer_s.config()
    seq, batch = (24, 4) if args.smoke else (256, 8)
    task = make_frame_task(d_in=cfg.d_in, n_classes=cfg.n_classes, seq_len=seq,
                           num_clients=16, device=str(device))
    data_fn = lambda c, r, s: task.batch(c, r, s, batch)  # noqa: E731
    omc = OMCConfig.parse("S1E3M7")
    sim = simulate.SimConfig(local_steps=2, client_lr=0.1)
    spec = engine.CohortSpec(CohortPlan(num_clients=16, cohort_size=8, failure_rate=0.25))
    key = prng.PRNGKey(0)
    params = conformer.init(key, cfg, device)
    specs = conformer.param_specs(cfg)
    storage = compress_params(params, specs, omc)
    table = accounting.build_wire_table(params, specs, omc)

    rounds = []
    for chunk in (1, None, 1, None):
        ms = timed(lambda: engine.run_round_vectorized(
            conformer, cfg, specs, omc, sim, storage, data_fn,
            dataclasses.replace(spec, client_chunk=chunk), 0, prng.fold_in(key, 0xC047),
            wire_table=table, fused_agg=True))
        rounds.append(dict(client_chunk=chunk, ms=ms))
        print(f"(a) fused round, client_chunk={chunk}: {ms:.1f} ms", flush=True)

    server = decompress_tree(storage)
    stack = tree_map(lambda x: x.expand((args.cohort,) + tuple(x.shape)), server)
    one_batch = [data_fn(0, 0, 0)]
    many_batch = simulate.cohort_batches(data_fn, range(args.cohort), [0] * args.cohort, 1)
    module_conv = conformer._conv_module
    convs = {}
    try:
        for name, conv in (("taps on a leading axis (the module's)", module_conv),
                           ("taps on the last axis", conv_taps_last),
                           ("shifted adds", conv_shifted_adds), ("unfold", conv_unfold)):
            conformer._conv_module = conv

            def one():
                simulate.sgd_steps(conformer, cfg, server, one_batch, sim.client_lr)

            def many():
                simulate._sgd(lambda p, b: conformer.loss_clients(cfg, p, b), stack,
                              many_batch, sim.client_lr)

            timed(one)
            one_ms = timed(one, args.reps)
            timed(many)
            many_ms = timed(many, args.reps)
            convs[name] = dict(one_client_ms=one_ms, batched_ms=many_ms)
            print(f"(b) conv as {name}: one client's SGD step {one_ms:.1f} ms, "
                  f"{args.cohort} clients batched {many_ms:.1f} ms", flush=True)
    finally:
        conformer._conv_module = module_conv
    print(json.dumps(dict(card=card, smoke=args.smoke, cohort=args.cohort, rounds=rounds,
                          convs=convs)))


if __name__ == "__main__":
    main()
