#!/usr/bin/env python3
"""Cohort-scale benchmark on the port: loop vs engine, seconds per round
(counterpart of ``benchmarks/cohort_scale.py``).

Times the per-client loop (``repro_torch.federated.simulate``) against the
vectorized engine (``repro_torch.federated.engine``) on identical rounds —
same cohort sample, survival mask, PPQ masks and data stream — across
growing cohort sizes.  One warm-up round per path per size is untimed; the
timed rounds are interleaved between the two paths so host noise hits both
alike, and each path's median s/round is reported.  Each row also carries
the engine's exact wire-byte accounting and its reconciliation against the
wire codec (``payload_bytes_report`` must equal the table's download bytes),
the reference's gate.

    python3 benchmarks_torch/cohort_scale.py            # conformer_s at full width, on the card
    python3 benchmarks_torch/cohort_scale.py --smoke    # the reference's CI config, on the CPU
    python3 benchmarks_torch/cohort_scale.py --tiers s1e3m7,s1e4m3,f32

``--smoke`` is the reference's CI run (its 2-layer, d 32 conformer, cohorts
4 and 8, 2 timed rounds, batch 1, 8 frames) through the plain versions.
Without it the model is conformer_s' published config (17 layers, d 512) on
the card at the reference's cohorts 4, 16 and 64: the loop holds a cohort's
trained f32 models and their stack, about 53 GB at cohort 64.
``--obs-overhead`` (telemetry cost) waits for ``obs`` (ROADMAP A9).  Writes
``experiments/bench_torch/cohort_scale.json`` (``cohort_scale_smoke.json``
with ``--smoke``).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from benchmarks_torch.common import (bench_device, device_name, print_table,  # noqa: E402
                                     save_result)
from repro_torch.api.codecs import payload_bytes_report  # noqa: E402
from repro_torch.api.session import sync  # noqa: E402
from repro_torch.configs import conformer_s  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.omc import OMCConfig  # noqa: E402
from repro_torch.data.synthetic import make_frame_task  # noqa: E402
from repro_torch.federated import accounting, engine, simulate  # noqa: E402
from repro_torch.federated.cohort import CohortPlan  # noqa: E402
from repro_torch.federated.state import compress_params  # noqa: E402
from repro_torch.models import conformer as cf  # noqa: E402

SMOKE_CFG = cf.ConformerConfig(n_layers=2, d_model=32, n_heads=4, d_ff=64, n_classes=16, d_in=8)


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def _setup(cfg, cohort: int, batch: int, seq: int, device):
    plan = CohortPlan(num_clients=2 * cohort, cohort_size=cohort)
    task = make_frame_task(d_in=cfg.d_in, n_classes=cfg.n_classes, seq_len=seq,
                           num_clients=plan.num_clients, device=str(device))
    return plan, lambda c, r, s: task.batch(c, r, s, batch)


def _init(cfg, fmt: str, seed: int, device):
    omc = OMCConfig.parse(fmt)
    specs = cf.param_specs(cfg)
    key = prng.PRNGKey(seed)
    params = cf.init(key, cfg, device)
    storage0 = compress_params(params, specs, omc)
    table = accounting.build_wire_table(params, specs, omc)
    return omc, specs, storage0, table, prng.fold_in(key, 0xC047)


def _timed(fn, device):
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def bench_size(cfg, cohort: int, rounds: int, batch: int, seq: int, fmt: str, seed: int,
               device) -> dict:
    sim = simulate.SimConfig(local_steps=1, client_lr=0.1)
    plan, data_fn = _setup(cfg, cohort, batch, seq, device)
    omc, specs, storage0, table, rkey = _init(cfg, fmt, seed, device)

    client_update = simulate.make_client_update(cf, cfg, specs, omc, sim)
    spec = engine.CohortSpec(plan)
    round_fn = engine.make_round_fn(cf, cfg, specs, omc, sim, spec, data_fn)
    # warm both paths (round 0, untimed)
    simulate.run_round(cf, cfg, specs, omc, sim, storage0, data_fn, plan, 0, rkey,
                       client_update=client_update)
    engine.run_round_vectorized(cf, cfg, specs, omc, sim, storage0, data_fn, spec, 0, rkey,
                                round_fn=round_fn)

    # interleave the two paths round by round; report per-path medians
    loop_t, vec_t = [], []
    loop_storage = vec_storage = storage0
    for r in range(1, rounds + 1):
        (loop_storage, loop_metrics), dt = _timed(lambda: simulate.run_round(
            cf, cfg, specs, omc, sim, loop_storage, data_fn, plan, r, rkey,
            client_update=client_update, wire_table=table), device)
        loop_t.append(dt)
        (vec_storage, vec_metrics), dt = _timed(lambda: engine.run_round_vectorized(
            cf, cfg, specs, omc, sim, vec_storage, data_fn, spec, r, rkey, round_fn=round_fn,
            wire_table=table), device)
        vec_t.append(dt)
    loop_s, vec_s = _median(loop_t), _median(vec_t)

    # cross-checks: identical accounting, codec reconciliation
    wire_match = (loop_metrics["down_bytes"] == vec_metrics["down_bytes"]
                  and loop_metrics["up_bytes"] == vec_metrics["up_bytes"])
    codec_match = payload_bytes_report(storage0)["wire_bytes"] == table.download_bytes(omc)
    return dict(
        cohort=cohort,
        loop_s_per_round=round(loop_s, 4),
        vec_s_per_round=round(vec_s, 4),
        loop_rounds_per_s=round(1.0 / loop_s, 3),
        vec_rounds_per_s=round(1.0 / vec_s, 3),
        speedup=round(loop_s / vec_s, 2),
        down_bytes=vec_metrics["down_bytes"],
        up_bytes=vec_metrics["up_bytes"],
        wire_match=wire_match,
        codec_match=codec_match,
        loss=round(float(vec_metrics["loss"]), 4),
        peak_device_gb=(round(torch.cuda.max_memory_allocated(device) / 1e9, 2)
                        if device.type == "cuda" else None),
        device=device_name(device),
    )


def bench_tiers(cfg, cohort: int, rounds: int, batch: int, seq: int, tier_names, fmt: str,
                seed: int, device) -> dict:
    """Engine-only timing of a mixed-bitwidth cohort (the loop has no tiers)."""
    sim = simulate.SimConfig(local_steps=1, client_lr=0.1)
    plan, data_fn = _setup(cfg, cohort, batch, seq, device)
    omc, specs, storage0, table, rkey = _init(cfg, fmt, seed, device)
    spec = engine.CohortSpec(plan, tiers=tuple(engine.profile(n) for n in tier_names))
    round_fn = engine.make_round_fn(cf, cfg, specs, omc, sim, spec, data_fn)
    engine.run_round_vectorized(cf, cfg, specs, omc, sim, storage0, data_fn, spec, 0, rkey,
                                round_fn=round_fn)
    storage = storage0
    sync(device)
    t0 = time.perf_counter()
    for r in range(1, rounds + 1):
        storage, m = engine.run_round_vectorized(cf, cfg, specs, omc, sim, storage, data_fn,
                                                 spec, r, rkey, round_fn=round_fn,
                                                 wire_table=table)
    sync(device)
    vec_s = (time.perf_counter() - t0) / rounds
    return dict(cohort=cohort, tiers=",".join(tier_names), quotas=list(spec.quotas),
                vec_s_per_round=round(vec_s, 4), vec_rounds_per_s=round(1.0 / vec_s, 3),
                down_bytes=m["down_bytes"], up_bytes=m["up_bytes"])


def run(cohorts=(4, 16, 64), rounds=5, batch=1, seq=8, fmt="S1E3M7", seed=0, tiers=None,
        smoke=False, obs_overhead=False):
    if obs_overhead:
        raise NotImplementedError("--obs-overhead times the engine with telemetry on, and "
                                  "obs is not ported yet (ROADMAP A9)")
    # the reference's suite budget knob: BENCH_ROUNDS caps the timed rounds
    rounds = max(1, min(rounds, int(os.environ.get("BENCH_ROUNDS", rounds))))
    device = bench_device(smoke)
    cfg = SMOKE_CFG if smoke else conformer_s.config()
    rows = []
    for c in cohorts:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        rows.append(bench_size(cfg, c, rounds, batch, seq, fmt, seed, device))
        if device.type == "cuda":
            torch.cuda.empty_cache()
    print_table("Cohort scaling: loop vs vectorized (steady-state s/round)", rows,
                ["cohort", "loop_s_per_round", "vec_s_per_round", "speedup", "wire_match",
                 "codec_match", "peak_device_gb"])
    payload = dict(smoke=smoke, fmt=fmt, rounds=rounds, batch=batch, seq_len=seq,
                   n_layers=cfg.n_layers, d_model=cfg.d_model, sizes=rows)
    if tiers:
        hrow = bench_tiers(cfg, max(cohorts), rounds, batch, seq, tiers, fmt, seed, device)
        print_table("Mixed-bitwidth cohort (engine only)", [hrow],
                    ["cohort", "tiers", "vec_s_per_round", "up_bytes"])
        payload["hetero"] = hrow
    path = save_result("cohort_scale_smoke" if smoke else "cohort_scale", payload)
    print(f"wrote {path}")
    assert all(r["wire_match"] and r["codec_match"] for r in rows), rows
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's CI config on the CPU: cohorts 4,8 and 2 timed rounds")
    ap.add_argument("--cohorts", default=None, help="comma-separated cohort sizes (default 4,16,64)")
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=8)
    ap.add_argument("--fmt", default="S1E3M7")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiers", default=None,
                    help="comma-separated profile names for a hetero row, e.g. s1e3m7,s1e4m3,f32")
    ap.add_argument("--obs-overhead", action="store_true",
                    help="also time engine rounds with telemetry on (needs ROADMAP A9)")
    args = ap.parse_args(argv)
    if args.smoke:
        cohorts, rounds = (4, 8), args.rounds or 2
    else:
        cohorts = tuple(int(c) for c in (args.cohorts or "4,16,64").split(","))
        rounds = args.rounds or 5
    tiers = args.tiers.split(",") if args.tiers else None
    t0 = time.perf_counter()
    run(cohorts=cohorts, rounds=rounds, batch=args.batch, seq=args.seq, fmt=args.fmt,
        seed=args.seed, tiers=tiers, smoke=args.smoke, obs_overhead=args.obs_overhead)
    print(f"\n{device_name(bench_device(args.smoke))}: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
