#!/usr/bin/env python3
"""Sharded population runtime scale sweep on the port (counterpart of
``benchmarks/population_scale.py``, DESIGN.md §14).

    python3 benchmarks_torch/population_scale.py                     # the reference's sweep, on the card
    python3 benchmarks_torch/population_scale.py --arch conformer_s  # conformer_s at full width, on the card
    python3 benchmarks_torch/population_scale.py --smoke             # the reference's CI config, on the CPU

Three sections, one result file:

  * **sweep**: streamed tree-aggregated rounds (``scale.run_round_sharded``)
    at growing populations through one stream function and one root
    function: client updates/s, seconds a round, the ``StreamLedger``'s
    peak bound and the measured peak.  Acceptance, the reference's: the
    bound is the same at every population and the measured peaks stay
    within 1.5x of each other.  On the card the measured peak is
    ``torch.cuda.max_memory_allocated`` over each population's timed rounds
    (reset before them); on the CPU it is the process's resident bytes
    sampled at each chunk boundary (``/proc/self/statm``).
  * **ef_at_rest**: ``PopulationStore`` residual bytes, packed against f32
    (S1E3M7 must be under half of f32).
  * **serve**: hot-swap under synthetic query traffic
    (``scale.run_serve_under_swap``) on the reference's 2-layer transformer:
    latencies, swap wall time and the swap-stall ratio, which must stay
    under 10.

Without flags: the reference's default sweep (its 2-layer, d 32 conformer;
populations 1k, 10k, 100k; cohort 128, capacity 32, 8 shards, 2 timed
rounds after one warm round a population) on the card.  ``--arch
conformer_s`` trains conformer_s' published config (17 layers, d 512) on
the synthetic frame task (batch 8 x 256 frames, 2 local steps) at
populations 1k and 100k, cohort 16, capacity 4, 4 shards, 1 timed round,
the EF section at 16 clients.  ``--smoke`` is the reference's CI run on
the CPU through the plain versions.  Writes
``experiments/bench_torch/population_scale.json`` (``_smoke`` /
``_conformer_s`` suffixed).
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
from repro_torch.api import codecs  # noqa: E402
from repro_torch.api.session import ServeSession, sync  # noqa: E402
from repro_torch.configs import conformer_s  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.omc import OMCConfig  # noqa: E402
from repro_torch.core.tree import tree_map  # noqa: E402
from repro_torch.data.synthetic import make_frame_task  # noqa: E402
from repro_torch.federated import accounting, simulate  # noqa: E402
from repro_torch.federated.cohort import CohortPlan  # noqa: E402
from repro_torch.federated.state import compress_params  # noqa: E402
from repro_torch.models import conformer as cf  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.scale import (PopulationStore, ShardLayout, make_root_fn,  # noqa: E402
                               run_round_sharded, run_serve_under_swap,
                               synthetic_token_batch)
from repro_torch.scale.stream import make_stream_fn  # noqa: E402

OMC = OMCConfig.parse("S1E3M7")
SMOKE_CFG = cf.ConformerConfig(n_layers=2, d_model=32, n_heads=4, d_ff=64, n_classes=16, d_in=8)
SIM = simulate.SimConfig(local_steps=2, client_lr=0.1)
SERVE_CFG = tr.TransformerConfig(n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
                                 vocab=128)


def _resident_bytes() -> int:
    """The process's resident bytes now (Linux ``/proc/self/statm``)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def sweep_section(cfg, populations, cohort, capacity, shards, rounds, batch, seq, device):
    specs = cf.param_specs(cfg)
    key = prng.PRNGKey(0)
    params = cf.init(key, cfg, device)
    table = accounting.build_wire_table(params, specs, OMC)
    storage0 = compress_params(params, specs, OMC)
    del params
    task = make_frame_task(d_in=cfg.d_in, n_classes=cfg.n_classes, seq_len=seq,
                           num_clients=max(populations), device=str(device))
    data_fn = lambda c, r, s: task.batch(c, r, s, batch)  # noqa: E731
    # one stream function and one root function for every population: the
    # shapes they see depend on the capacity alone (§14)
    stream_fn = make_stream_fn(cf, cfg, specs, OMC, SIM, data_fn, capacity)
    root_fn = make_root_fn(specs, OMC, SIM)
    on_card = device.type == "cuda"

    rows = []
    for population in populations:
        plan = CohortPlan(num_clients=population, cohort_size=cohort, failure_rate=0.1)
        layout = ShardLayout(population, shards)
        store = PopulationStore(layout, device=device)
        ledger = accounting.StreamLedger(table, OMC, capacity)
        resident = [0]

        def on_chunk(shard, n_real, n_chunks):
            if not on_card:
                resident[0] = max(resident[0], _resident_bytes())

        def one_round(storage, r):
            return run_round_sharded(cf, cfg, specs, OMC, SIM, storage, data_fn, plan, layout,
                                     r, key, capacity=capacity, stream_fn=stream_fn,
                                     root_fn=root_fn, store=store, wire_table=table,
                                     ledger=ledger, on_chunk=on_chunk)

        storage, _ = one_round(storage0, 0)  # warm, untimed
        sync(device)
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        resident[0] = 0
        t0 = time.perf_counter()
        streamed = 0
        for r in range(1, rounds + 1):
            storage, m = one_round(storage, r)
            streamed += m["cohort"] + m["dropped"]
        sync(device)
        dt = time.perf_counter() - t0
        measured = torch.cuda.max_memory_allocated(device) if on_card else resident[0]
        del storage
        rows.append(dict(
            population=population, shards=shards, cohort=cohort, capacity=capacity,
            rounds=rounds, round_wall_s=dt / rounds, updates_per_s=streamed / dt,
            chunks=int(ledger.chunks), peak_bound_bytes=int(ledger.peak_bound_bytes()),
            peak_measured_bytes=int(measured),
            measured_as="device max_memory_allocated" if on_card else "process resident bytes",
            host_counter_bytes=int(store.bytes_report()["counter_bytes"]),
        ))

    bounds = {r["peak_bound_bytes"] for r in rows}
    assert len(bounds) == 1, f"StreamLedger bound must not depend on the population: {bounds}"
    measured = [r["peak_measured_bytes"] for r in rows]
    assert max(measured) <= 1.5 * min(measured), f"measured peak grew with population: {measured}"
    print_table(f"streamed rounds: population sweep (capacity {capacity})", rows,
                ["population", "shards", "cohort", "chunks", "round_wall_s", "updates_per_s",
                 "peak_bound_bytes", "peak_measured_bytes", "host_counter_bytes"])
    return rows


def ef_section(cfg, population, shards):
    specs = cf.param_specs(cfg)
    shapes = cf.init(prng.PRNGKey(0), cfg, "meta")
    out = {}
    for fmt in (None, "S1E4M14", "S1E3M7"):
        store = PopulationStore(ShardLayout(population, shards), device="cpu")
        store.init_ef(shapes, specs, OMC, ef_fmt=fmt)
        rep = store.bytes_report()
        out[fmt or "f32"] = dict(ef_at_rest_bytes=rep["ef_at_rest_bytes"],
                                 ratio_vs_f32=rep["ef_at_rest_bytes"] / max(rep["ef_fp32_bytes"], 1))
        del store
    rows = [dict(fmt=k, **v) for k, v in out.items()]
    print_table(f"EF residuals at rest ({population} clients)", rows,
                ["fmt", "ef_at_rest_bytes", "ratio_vs_f32"])
    assert out["S1E3M7"]["ratio_vs_f32"] < 0.5  # about 11/32 plus the per-row PVT pair
    return out


def serve_section(swaps, queries_per_swap, decode_steps, device):
    cfg = SERVE_CFG
    specs = tr.param_specs(cfg)
    key = prng.PRNGKey(1)
    params = tr.init(key, cfg, device)
    session = ServeSession(tr, cfg, compress_params(params, specs, OMC))
    payloads = []
    for i in range(swaps):
        k = prng.fold_in(key, i + 1)
        perturbed = tree_map(lambda p: p + 0.01 * prng.normal(k, p.shape, p.device), params)
        payloads.append(codecs.encode_payload(compress_params(perturbed, specs, OMC),
                                              round_index=i + 1))
    stats = run_serve_under_swap(
        session, payloads,
        make_query=lambda i: synthetic_token_batch(1, 4, cfg.vocab, seed=i, device=device),
        queries_per_swap=queries_per_swap, decode_steps=decode_steps)
    print_table("serve under hot-swap", [stats],
                ["queries", "swaps", "query_ms_p50", "query_ms_p95", "swap_ms_mean",
                 "swap_ms_max", "swap_stall_ratio"])
    assert stats["swaps"] == swaps
    assert stats["swap_stall_ratio"] < 10.0, (
        f"the first query after a swap stalled {stats['swap_stall_ratio']:.1f}x")
    return stats


def run(smoke: bool = False, arch: str = None):
    device = bench_device(smoke)
    if smoke:
        cfg, batch, seq, ef_pop = SMOKE_CFG, 4, 24, 1_000
        sweep = ([200, 1_000], 16, 8, 2, 1)
        swaps, qps, steps = 2, 4, 3
    elif arch == "conformer_s":
        cfg, batch, seq, ef_pop = conformer_s.config(), 8, 256, 16
        sweep = ([1_000, 100_000], 16, 4, 4, 1)
        swaps, qps, steps = 4, 8, 4
    else:
        cfg, batch, seq, ef_pop = SMOKE_CFG, 4, 24, 1_000
        sweep = ([1_000, 10_000, 100_000], 128, 32, 8, 2)
        swaps, qps, steps = 4, 8, 4
    pops, coh, cap, sh, rnd = sweep
    t0 = time.perf_counter()
    payload = dict(
        config=dict(model=arch or "conformer-tiny", omc=OMC.fmt.name, cohort=coh, capacity=cap,
                    shards=sh, smoke=bool(smoke), device=device_name(device)),
        sweep=sweep_section(cfg, pops, coh, cap, sh, rnd, batch, seq, device),
        ef_at_rest=ef_section(cfg, ef_pop, min(8, ef_pop)),
        serve=serve_section(swaps, qps, steps, device),
    )
    name = "population_scale" + ("_smoke" if smoke else f"_{arch}" if arch else "")
    path = save_result(name, payload)
    print(f"\nwrote {path}; {device_name(device)}: {time.perf_counter() - t0:.1f} s")
    return payload


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's CI config on the CPU (small populations, 1 round)")
    ap.add_argument("--arch", choices=["conformer_s"], default=None,
                    help="conformer_s at full width instead of the reference's 2-layer model")
    args = ap.parse_args(argv)
    run(smoke=args.smoke, arch=args.arch)


if __name__ == "__main__":
    main()
