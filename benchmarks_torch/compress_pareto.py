#!/usr/bin/env python3
"""Quality against wire bytes across the strategy zoo, on the port
(counterpart of ``benchmarks/compress_pareto.py``, DESIGN.md §11).

For each model family (conformer_s and a small transformer LM) this
briefly trains f32 weights with plain SGD, pushes them through every
strategy of ``repro_torch.compress.default_zoo()`` (the paper's OMC
minifloats, top-k, ternary TNT and the quantize -> top-k -> DEFLATE
pipeline) and records the (eval loss, wire bytes) point.  Points no other
beats on both axes are flagged ``pareto``; the f32 model is the anchor.

Every row's wire bytes are reconciled three ways before they are reported
(byte-exact, asserted):

  * ``compress.tree_wire_bytes`` over the encoded tree,
  * the serialized payload's ``body_bytes`` (``repro_torch.api.codecs``),
    decoded back to the same digest,
  * for shape-determined strategies the planning ledger
    ``WireTable.download_bytes_strategy``; and for the paper's S1E3M7 + PVT
    point ``WireTable.download_bytes(omc)``, which must stay inside the
    ~59% reduction (``wire_ratio <= 0.6``).

``--trained`` moves the frontier from the transport of frozen weights to
training: each strategy drives the engine (DESIGN.md §12) for N rounds and
the point is (final eval loss, cumulative wire MB).  ``strategy="omc"``
must land on the hard-coded path's loss and bytes exactly, EF top-k and
plain top-k must ship the same bytes, and at full size EF top-k must reach
a lower eval loss than plain top-k.

    python3 benchmarks_torch/compress_pareto.py                   # full width, on the card
    python3 benchmarks_torch/compress_pareto.py --smoke           # the reference's CI config, CPU
    python3 benchmarks_torch/compress_pareto.py --smoke --static  # the frozen-weights section only

Without ``--smoke`` conformer_s runs at its published width (17 layers,
d 512; ``benchmarks_torch.common.conformer_setup``) with 40 pretraining
steps and 30 trained rounds a point; ``--smoke`` is the reference's smoke
config (6 steps, 4 rounds, 2 eval batches) through the plain versions.
The transformer LM is the reference's own 2-layer, d 64, vocab 256 config in
both.  ``--device`` moves either.  Writes
``experiments/bench_torch/compress_strategies.json``
(``compress_strategies_smoke.json`` with ``--smoke``; sections merge, so
``--static`` and ``--trained`` update one file).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from benchmarks_torch.common import (BENCH_CLIENTS, BENCH_COHORT, OUT_DIR,  # noqa: E402
                                     bench_device, conformer_setup, device_name, eval_loss,
                                     print_table, save_result)
from repro_torch import compress  # noqa: E402
from repro_torch.api import codecs  # noqa: E402
from repro_torch.api.session import sync  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.omc import OMCConfig  # noqa: E402
from repro_torch.core.store import decompress_tree  # noqa: E402
from repro_torch.data.synthetic import make_lm_task  # noqa: E402
from repro_torch.federated import accounting, engine, simulate  # noqa: E402
from repro_torch.federated.cohort import CohortPlan  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402

LM_CFG = tr.TransformerConfig(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                              vocab=256)


def _pretrain(family, cfg, task, steps: int, batch: int, device, lr: float = 0.1,
              seed: int = 0):
    """A few plain SGD steps: enough structure in the weights that lossy
    transport visibly moves the eval loss."""
    params = family.init(prng.PRNGKey(seed), cfg, device)
    for i in range(steps):
        params, _ = simulate.sgd_steps(family, cfg, params, [task.batch(i % 4, i, 0, batch)], lr)
    return params


def _model_setups(smoke: bool, seed: int, device):
    """``(name, family, cfg, params_f32, eval_batches)`` per model family."""
    steps = 6 if smoke else 40
    batch = 2 if smoke else 4
    cf, ccfg, ctask, _, c_eval = conformer_setup(seed=seed, smoke=smoke, device=device)
    c_eval = c_eval[:2] if smoke else c_eval
    ltask = make_lm_task(vocab=LM_CFG.vocab, seq_len=32, num_clients=4, seed=seed,
                         device=str(device))
    l_eval = [ltask.batch(100 + i, 10_000, 0, batch) for i in range(2 if smoke else 4)]
    return [("conformer_s", cf, ccfg, _pretrain(cf, ccfg, ctask, steps, batch, device, seed=seed),
             c_eval),
            ("transformer_lm", tr, LM_CFG,
             _pretrain(tr, LM_CFG, ltask, steps, batch, device, seed=seed), l_eval)]


def _measure(strategy, family, cfg, params_f32, eval_batches, omc, wt, device):
    """One point: encode, reconcile the bytes three ways, evaluate."""
    specs = family.param_specs(cfg)
    sync(device)
    t0 = time.perf_counter()
    with torch.no_grad():
        tree = compress.encode_tree(strategy, params_f32, omc, specs)
    sync(device)
    t_encode = time.perf_counter() - t0
    twb = compress.tree_wire_bytes(tree)

    # the serialized body == the tree's accounting == the codec's report
    payload = codecs.encode_payload(tree, strategy=strategy)
    info = codecs.peek_payload(payload)
    rep = codecs.payload_bytes_report(tree)
    assert info.body_bytes == twb["wire_bytes"] == rep["wire_bytes"], (
        strategy.label, info.body_bytes, twb["wire_bytes"], rep["wire_bytes"])
    assert info.strategy == strategy.name
    decoded, _ = codecs.decode_payload(payload, device=device)
    assert codecs.tree_digest(decoded) == codecs.tree_digest(tree)

    # the planning ledger (shape-determined strategies only)
    planned = strategy.plan_wire_bytes(1, 1) is not None
    if planned:
        assert wt.download_bytes_strategy(strategy) == twb["wire_bytes"], (
            strategy.label, wt.download_bytes_strategy(strategy), twb["wire_bytes"])

    with torch.no_grad():
        loss = eval_loss(family, cfg, compress.decode_tree(tree), eval_batches)
    return dict(strategy=strategy.name, label=strategy.label,
                wire_version=strategy.wire_version, delta_rule=strategy.delta_rule,
                wire_bytes=twb["wire_bytes"], wire_mb=round(twb["wire_bytes"] / 2**20, 4),
                wire_ratio=round(twb["wire_ratio"], 4), loss=loss, planned=planned,
                reconciled=True, encode_ms=round(t_encode * 1e3, 1),
                per_strategy=twb["per_strategy"])


def _pareto_flags(rows):
    """Non-dominated on (wire_bytes, loss): smaller is better on both."""
    for r in rows:
        r["pareto"] = not any(
            o is not r and o["wire_bytes"] <= r["wire_bytes"] and o["loss"] <= r["loss"]
            and (o["wire_bytes"] < r["wire_bytes"] or o["loss"] < r["loss"]) for o in rows)
    return rows


def run_static(smoke: bool = False, seed: int = 0, device=None):
    device = torch.device(device or bench_device(smoke))
    zoo = compress.default_zoo()
    omc = OMCConfig.parse("S1E3M7")  # the selection policy every point shares
    models, all_rows = {}, []
    for name, family, cfg, params_f32, eval_batches in _model_setups(smoke, seed, device):
        specs = family.param_specs(cfg)
        wt = accounting.build_wire_table(params_f32, specs, omc)
        baseline = eval_loss(family, cfg, params_f32, eval_batches)
        fp32_bytes = wt.fp32_total
        rows = [dict(strategy="fp32", label="fp32", wire_version=0, delta_rule=None,
                     wire_bytes=fp32_bytes, wire_mb=round(fp32_bytes / 2**20, 4),
                     wire_ratio=1.0, loss=baseline, planned=True, reconciled=True,
                     encode_ms=0.0, per_strategy={})]
        rows += [_measure(s, family, cfg, params_f32, eval_batches, omc, wt, device)
                 for s in zoo]
        # the paper's own point stays inside the ~59%-reduction envelope
        paper = next(r for r in rows if r["label"] == "omc-s1e3m7")
        assert paper["wire_bytes"] == wt.download_bytes(omc)
        assert paper["wire_ratio"] <= 0.6, paper["wire_ratio"]
        _pareto_flags(rows)
        for r in rows:
            r["model"] = name
            r["delta_loss"] = round(r["loss"] - baseline, 6)
        models[name] = dict(baseline_loss=baseline, fp32_bytes=fp32_bytes,
                            n_layers=cfg.n_layers, d_model=cfg.d_model, points=rows)
        all_rows.extend(rows)
    print_table("Quality vs wire bytes (Pareto frontier)", all_rows,
                ["model", "label", "wire_mb", "wire_ratio", "loss", "delta_loss", "pareto",
                 "planned", "encode_ms"])
    return dict(smoke=smoke, seed=seed, device=device_name(device),
                strategies=[s.describe() for s in zoo], selection_fmt=omc.fmt.name,
                models=models)


def _train_point(label, strategy, family, cfg, data_fn, eval_batches, omc, sim, spec, rounds,
                 seed, device):
    """Train under one strategy; return the frontier point."""
    sync(device)
    t0 = time.perf_counter()
    storage, hist = engine.run_training_vectorized(
        family, cfg, omc, sim, spec, data_fn, prng.PRNGKey(seed), num_rounds=rounds,
        eval_every=10_000, strategy=strategy, device=device)
    sync(device)
    dt = time.perf_counter() - t0
    up = sum(h["up_bytes"] for h in hist)
    down = sum(h["down_bytes"] for h in hist)
    final = eval_loss(family, cfg, decompress_tree(storage), eval_batches)
    return dict(label=label, strategy=strategy.name if strategy is not None else "omc",
                error_feedback=bool(getattr(strategy, "error_feedback", False)), rounds=rounds,
                final_eval=round(final, 6), up_mb=round(up / 2**20, 4),
                down_mb=round(down / 2**20, 4), wire_mb=round((up + down) / 2**20, 4),
                up_bytes=up, down_bytes=down, train_curve=[round(h["loss"], 5) for h in hist],
                wall_s=round(dt, 1), s_per_round=round(dt / rounds, 3))


def run_trained(smoke: bool = False, seed: int = 0, device=None):
    """The trained frontier: eval loss against cumulative wire MB."""
    device = torch.device(device or bench_device(smoke))
    family, cfg, _, data_fn, eval_batches = conformer_setup(seed=seed, smoke=smoke,
                                                            device=device)
    eval_batches = eval_batches[:2] if smoke else eval_batches
    rounds = 4 if smoke else 30
    omc = OMCConfig.parse("S1E3M7")
    sim = simulate.SimConfig(local_steps=2, client_lr=0.1)
    spec = engine.CohortSpec(CohortPlan(num_clients=BENCH_CLIENTS, cohort_size=BENCH_COHORT))
    density = 0.1
    points = [
        ("omc-hardcoded", None),
        ("omc-strategy", compress.get_strategy("omc")),
        ("topk-ef", compress.get_strategy("topk", density=density)),
        ("topk-plain", compress.get_strategy("topk", density=density, error_feedback=False)),
        ("ternary-ef", compress.get_strategy("ternary")),
    ]
    rows = [_train_point(lbl, s, family, cfg, data_fn, eval_batches, omc, sim, spec, rounds,
                         seed, device) for lbl, s in points]
    by = {r["label"]: r for r in rows}

    # the strategy seam costs nothing: strategy="omc" is the hard-coded path
    assert by["omc-strategy"]["final_eval"] == by["omc-hardcoded"]["final_eval"]
    assert by["omc-strategy"]["up_bytes"] == by["omc-hardcoded"]["up_bytes"]
    assert by["omc-strategy"]["down_bytes"] == by["omc-hardcoded"]["down_bytes"]
    # matched wire cost: EF and plain top-k ship the same bytes
    assert by["topk-ef"]["up_bytes"] == by["topk-plain"]["up_bytes"]
    ef_wins = by["topk-ef"]["final_eval"] < by["topk-plain"]["final_eval"]
    if not smoke:
        # the residual memory must pay off at this budget
        assert ef_wins, (by["topk-ef"]["final_eval"], by["topk-plain"]["final_eval"])

    for r in rows:
        r["wire_bytes"], r["loss"] = r["up_bytes"] + r["down_bytes"], r["final_eval"]
    _pareto_flags(rows)
    for r in rows:
        del r["wire_bytes"], r["loss"]
    print_table("Trained frontier (eval loss vs wire MB)", rows,
                ["label", "rounds", "final_eval", "up_mb", "down_mb", "wire_mb",
                 "error_feedback", "pareto", "s_per_round"])
    return dict(smoke=smoke, seed=seed, device=device_name(device), rounds=rounds,
                density=density, n_layers=cfg.n_layers, cohort=spec.plan.cohort_size,
                num_clients=spec.plan.num_clients, local_steps=sim.local_steps,
                client_lr=sim.client_lr, ef_wins=bool(ef_wins), points=rows)


def _merge_save(section_updates, name: str):
    """Update sections of ``<name>.json``, keeping the others."""
    path = OUT_DIR / f"{name}.json"
    payload = json.loads(path.read_text()) if path.exists() else {}
    payload.update(section_updates)
    save_result(name, payload)
    return payload


def run(smoke: bool = False, seed: int = 0, static: bool = True, trained: bool = True,
        device=None):
    sections = {}
    if static:
        sections.update(run_static(smoke=smoke, seed=seed, device=device))
    if trained:
        sections["trained"] = run_trained(smoke=smoke, seed=seed, device=device)
    return _merge_save(sections, "compress_strategies_smoke" if smoke else "compress_strategies")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's CI config (fewer steps, eval batches, rounds), CPU")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--static", action="store_true",
                    help="only the frozen-weights transport frontier")
    ap.add_argument("--trained", action="store_true", help="only the trained frontier")
    ap.add_argument("--device", default=None,
                    help="default: cpu with --smoke, else cuda (raises without a card)")
    args = ap.parse_args(argv)
    both = args.static == args.trained  # neither flag (or both): everything
    t0 = time.perf_counter()
    run(smoke=args.smoke, seed=args.seed, static=both or args.static,
        trained=both or args.trained, device=args.device)
    device = args.device or bench_device(args.smoke)
    print(f"\n{device_name(device)}: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
