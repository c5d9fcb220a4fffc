"""Loopback wire-format demo: download -> train -> upload -> aggregate (port
of ``repro.api.demo``).

Runs the whole client/server boundary in one process: the server
(``FLSession``) hands out compressed wire payloads, loopback clients
(``FLClient``) decode them, run local SGD on their synthetic LM shard and
upload delta-encoded payloads; the server aggregates and re-compresses.
After the rounds a ``ServeSession`` hot-swaps the final model's delta
payload and generates a few tokens over the compressed weights.

    PYTHONPATH=src python -m repro_torch.api.demo --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.api.demo            # on the card

Prints a per-round payload-bytes report (stderr) and checks that the codec's
bytes reconcile with ``state_bytes_report`` exactly and with
``tree_bytes_report`` within 1%; exits 1 when an S1E3M7 download is more
than 60% of f32.  On the card the rounds run ``quantize_stats``,
``dequantize`` and ``pack``/``unpack``, and the served transformer's block
matrices go through ``dequant_matmul``.  ``--smoke`` writes its traffic
record to ``experiments/bench_torch/api_demo_smoke.json``.  ``--obs`` records
the run's telemetry (the sessions' and clients' payload spans, the serve
hot-swap, the log lines as records) and writes
``experiments/obs/api_demo.{obs.jsonl,perfetto.json}``, which
``python -m repro_torch.obs.report`` renders.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

from repro_torch.core import prng
from repro_torch.core.omc import OMCConfig
from repro_torch.core.store import tree_bytes_report
from repro_torch.data.synthetic import make_lm_task
from repro_torch.federated.cohort import CohortPlan
from repro_torch.federated.simulate import sgd_steps
from repro_torch.federated.state import state_bytes_report
from repro_torch.models import transformer as tr
from repro_torch.obs import Obs
from repro_torch.obs.log import Logger

from .codecs import payload_bytes_report
from .session import FLClient, FLSession, ServeSession, session_device

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "bench_torch"


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="tiny model + 2 rounds (CI-sized)")
    ap.add_argument("--fmt", default="S1E3M7")
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--cohort", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--client-lr", type=float, default=0.05)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quiet", action="store_true",
                    help="suppress stderr text (records still go to --obs)")
    ap.add_argument("--obs", action="store_true",
                    help="record telemetry (obs JSONL + Perfetto trace under experiments/obs/)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    device = session_device(args.device)
    rounds = args.rounds or (2 if args.smoke else 8)
    obs = Obs(run_name="api_demo") if args.obs else None
    log = Logger(quiet=args.quiet, obs=obs)

    if args.smoke:
        cfg = tr.TransformerConfig(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                                   vocab=256)
    else:
        cfg = tr.TransformerConfig(n_layers=4, d_model=128, n_heads=8, n_kv_heads=4, d_ff=256,
                                   vocab=512)
    omc = OMCConfig.parse(args.fmt)
    task = make_lm_task(vocab=cfg.vocab, seq_len=32, num_clients=args.clients,
                        device=str(device))
    losses: Dict[int, float] = {}

    def train_fn(params, client_id, round_index):
        batches = [task.batch(client_id, round_index, s, args.batch)
                   for s in range(args.local_steps)]
        trained, step_losses = sgd_steps(tr, cfg, params, batches, args.client_lr)
        losses[client_id] = float(step_losses.mean())
        return trained

    plan = CohortPlan(num_clients=args.clients, cohort_size=args.cohort)
    server = FLSession(tr, cfg, omc, plan=plan, seed=args.seed, device=device, obs=obs)
    clients = {cid: FLClient(cid, tr, cfg, omc, train_fn, device=device, obs=obs)
               for cid in range(args.clients)}

    # reconcile the codec's byte accounting with the core reports: exact
    # against state_bytes_report (both count 8 B per PVT (s, b) entry), and
    # within the per-variable-vs-per-entry PVT overhead of tree_bytes_report
    wire = payload_bytes_report(server.storage)
    state_rep = state_bytes_report(server.storage)
    theory = tree_bytes_report(tr.init(prng.PRNGKey(args.seed), cfg, "meta"), omc.fmt,
                               omc.policy, fraction=1.0)
    if wire["wire_bytes"] != state_rep["packed_bytes"]:
        raise RuntimeError(f"codec and state_bytes_report disagree: {wire} {state_rep}")
    if abs(wire["wire_bytes"] - theory["packed_bytes"]) > 0.01 * theory["packed_bytes"]:
        raise RuntimeError(f"codec and tree_bytes_report disagree: {wire} {theory}")
    log.info(f"model: {wire['num_params'] / 1e6:.2f} M params, fmt {omc.fmt.name}, "
             f"device {device}")
    log.info(f"wire body (codec):        {wire['wire_bytes']:>9d} B "
             f"({wire['wire_ratio']:.1%} of f32)")
    log.info(f"state_bytes_report packed: {state_rep['packed_bytes']:>8d} B (exact)")
    log.info(f"tree_bytes_report packed:  {theory['packed_bytes']:>8d} B "
             f"({theory['packed_ratio']:.1%} of f32)")

    serve = None
    for r in range(rounds):
        if r == rounds - 1:
            # snapshot the pre-final-round model into a serving session; the
            # final round's delta payload hot-swaps against exactly it
            serve = ServeSession.from_payload(tr, cfg, server.server_payload(), device=device,
                                              obs=obs)
        ticket = server.begin_round()
        up_bytes = []
        for cid in ticket.client_ids:
            info = server.ingest(cid, clients[cid].run_round(ticket))
            up_bytes.append(info.total_bytes)
        down_b = list(ticket.issued_bytes)
        m = server.close_round()
        mean_loss = sum(losses[c] for c in ticket.client_ids) / len(ticket.client_ids)
        mean_down = sum(down_b) // len(down_b)
        log.info(f"round {m['round']}: loss={mean_loss:.4f} "
                 f"reports={m['reports']}/{m['invited']} "
                 f"down={mean_down}B/client ({mean_down / wire['fp32_bytes']:.1%} of f32, "
                 f"{ticket.issued_delta}/{len(down_b)} delta) "
                 f"up={sum(up_bytes) // len(up_bytes)}B/client")

    t = server.traffic
    down_ratio = t["down_bytes"] / max(t["down_fp32_bytes"], 1)
    up_ratio = t["up_bytes"] / max(t["up_fp32_bytes"], 1)
    log.result(f"totals: down {t['down_bytes']}B ({down_ratio:.1%} of f32), "
               f"up {t['up_bytes']}B ({up_ratio:.1%} of f32)")

    # serve over the wire: hot-swap the final round's delta payload into the
    # session snapshotted before that round, then generate on the new weights
    info = serve.hot_swap(server.server_payload(delta=True))
    cache = serve.init_cache(2, 64)
    toks = prng.randint(prng.PRNGKey(1), (2, 16), 0, cfg.vocab, device)
    with torch.no_grad():
        _, gen = serve.generate(dict(tokens=toks), cache, 8)
    log.info(f"serve: hot-swapped round-{info.round_index} payload ({info.total_bytes}B, "
             f"delta={info.is_delta}); generated {gen.shape[1]} tokens/seq over compressed "
             f"weights")

    ok = down_ratio <= 0.60
    enforced = omc.fmt.name == "S1E3M7"
    log.result(f"payload check: download {down_ratio:.1%} of f32 "
               f"({'<=' if ok else '>'} 60% target; "
               f"{'enforced for' if enforced else 'informational for'} {omc.fmt.name})")
    if args.smoke:
        # the smoke run's traffic record (the reference's CI artifact)
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        path = OUT_DIR / "api_demo_smoke.json"
        path.write_text(json.dumps(dict(fmt=omc.fmt.name, rounds=rounds,
                                        down_ratio=round(down_ratio, 4),
                                        up_ratio=round(up_ratio, 4),
                                        wire_bytes=wire["wire_bytes"],
                                        fp32_bytes=wire["fp32_bytes"],
                                        **{k: int(v) for k, v in t.items()}), indent=1))
        log.info(f"wrote {os.path.normpath(path)}", path=os.path.normpath(path))
    if obs is not None:
        paths = obs.flush()
        log.info(f"wrote {paths['jsonl']} and {paths['perfetto']}", **paths)
    if not ok and enforced:
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
