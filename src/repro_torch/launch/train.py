"""End-to-end federated training driver with checkpoint/restart (port of
``repro.launch.train``).

Runs the federated round (``federated.round.make_round_fn``, compressed-state
OMC by default) on the synthetic frame task, checkpointing atomically every
``--ckpt-every`` rounds and resuming from the latest checkpoint in
``--ckpt-dir`` if there is one (fault tolerance: kill the process at any
point and rerun the same command).  On the card each round decodes every
compressed layer with ``dequantize`` (again in the backward pass's
recompute) and re-compresses the updated leaves with ``quantize_stats``.

    # CPU-scale smoke run
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --rounds 4 --ckpt-every 2 --ckpt-dir ckpts/smoke

    # conformer_s at full width on the card (103.5 M parameters)
    PYTHONPATH=src python -m repro_torch.launch.train --rounds 300 --batch 16

    # paper FP32 control
    ... --fmt S1E8M23

``--device`` defaults to ``cuda``; without a card the driver raises unless
``--device cpu`` is given.  On the card it runs with
``torch.use_deterministic_algorithms(True)`` (and cuBLAS's deterministic
workspace), so that a resumed run replays the uninterrupted one bit for
bit.  The transformer family trains on the LM task (``--arch qwen2.5-3b``),
IID or, with ``--non-iid``, with each client's transitions re-weighted by
a Dirichlet draw; griffin, moe and xlstm wait for their ``forward``/``loss``
(ROADMAP A10).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch import checkpoint as ck
from repro_torch.api.session import sync
from repro_torch.configs.registry import get_arch
from repro_torch.core import prng
from repro_torch.core.omc import OMCConfig
from repro_torch.data.synthetic import make_frame_task, make_lm_task
from repro_torch.federated.round import make_round_fn
from repro_torch.federated.state import init_state, state_bytes_report
from repro_torch.kernels import ops
from repro_torch.models.registry import get_family
from repro_torch.obs.log import Logger
from repro_torch.optim import fedavg


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="conformer_s")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU scale)")
    ap.add_argument("--fmt", default="S1E4M14")
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=48)
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--non-iid", action="store_true")
    ap.add_argument("--client-lr", type=float, default=0.05)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--quiet", action="store_true", help="suppress stderr text")
    return ap.parse_args(argv)


def make_task(arch, cfg, seq: int, num_clients: int, iid: bool, seed: int, device):
    """``data_fn(client, round, step, batch)`` of the arch's task on ``device``."""
    fam = arch.FAMILY
    if fam == "conformer":
        task = make_frame_task(d_in=cfg.d_in, n_classes=cfg.n_classes, seq_len=seq,
                               num_clients=num_clients, iid=iid, seed=seed, device=str(device))
        return task.batch
    if fam in ("moe", "xlstm", "griffin"):
        raise NotImplementedError(
            f"{arch.ID} ({fam}) has no forward/loss in the port yet (ROADMAP A10)")
    if fam == "transformer":
        task = make_lm_task(vocab=min(cfg.vocab, 4096), seq_len=seq, num_clients=num_clients,
                            iid=iid, seed=seed, device=str(device))
        return task.batch
    raise SystemExit(f"train driver supports LM/conformer tasks, not {fam}")


def _delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def run(args: argparse.Namespace) -> Dict[str, Any]:
    """Train as the CLI would; return the report (and the final state under
    ``"state"``, which ``main`` does not print).

    The report holds the loss and grad norm of every round run, the wall ms
    of each (synchronized), the kernel launches of the init and of each round
    (``kernels.ops`` counters, read as differences, never reset), the byte
    report of the storage, the checkpoints written and their bytes on disk,
    and on the card the peak device memory."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to train on the CPU")
    arch = get_arch(args.arch)
    cfg = arch.smoke_config() if args.smoke else arch.config()
    data_fn = make_task(arch, cfg, args.seq, args.clients, not args.non_iid, args.seed, device)
    log = Logger(quiet=args.quiet)
    deterministic = torch.are_deterministic_algorithms_enabled()
    if device.type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
        torch.cuda.reset_peak_memory_stats(device)
    try:
        report = _train(args, arch, cfg, data_fn, device, log)
    finally:
        torch.use_deterministic_algorithms(deterministic)
    if device.type == "cuda":
        report["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
    return report


def _train(args, arch, cfg, data_fn, device, log: Logger) -> Dict[str, Any]:
    family = get_family(arch.FAMILY)
    omc = OMCConfig.parse(args.fmt)
    opt = fedavg(1.0)

    counts = ops.launch_counts()
    state = init_state(prng.PRNGKey(args.seed), family, cfg, omc, opt, device=device)
    init_launches = _delta(ops.launch_counts(), counts)
    rep = state_bytes_report(state.params)
    log.info(f"arch={args.arch} fmt={args.fmt} params={rep['num_params'] / 1e6:.1f}M "
             f"container={rep['container_ratio']:.0%} packed={rep['packed_ratio']:.0%} of FP32")

    start_round = 0
    if args.ckpt_dir:
        found = ck.latest_checkpoint(args.ckpt_dir)
        if found:
            state, manifest = ck.restore_state(found[0], state)
            start_round = manifest["step"]
            log.info(f"resumed from {found[0]} at round {start_round}")

    round_fn = make_round_fn(family, cfg, omc, opt, client_lr=args.client_lr)
    report: Dict[str, Any] = dict(arch=args.arch, smoke=bool(args.smoke), fmt=omc.fmt.name,
                                  device=str(device), start_round=start_round,
                                  rounds=args.rounds, state_bytes=rep,
                                  init_launches=init_launches, losses=[], grad_norms=[],
                                  round_ms=[], round_launches=[], checkpoints=[])
    t0 = time.perf_counter()
    for r in range(start_round, args.rounds):
        counts = ops.launch_counts()
        sync(device)
        t_round = time.perf_counter()
        state, metrics = round_fn(state, data_fn(r % args.clients, r, 0, args.batch))
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        sync(device)
        report["round_ms"].append((time.perf_counter() - t_round) * 1e3)
        report["round_launches"].append(_delta(ops.launch_counts(), counts))
        report["losses"].append(loss)
        report["grad_norms"].append(gnorm)
        if (r + 1) % args.log_every == 0 or r == start_round:
            dt = time.perf_counter() - t0
            log.info(f"round {r + 1}/{args.rounds} loss={loss:.4f} gnorm={gnorm:.3f} "
                     f"({(r + 1 - start_round) / max(dt, 1e-9):.2f} rounds/s)")
        if args.ckpt_dir and (r + 1) % args.ckpt_every == 0:
            report["checkpoints"].append(ck.save_state(args.ckpt_dir, r + 1, state))
            log.info(f"checkpointed -> {report['checkpoints'][-1]}")
    if args.ckpt_dir:  # the final state, as the reference saves it (again, if just saved)
        path = ck.save_state(args.ckpt_dir, args.rounds, state)
        if path not in report["checkpoints"]:
            report["checkpoints"].append(path)
        report["ckpt_bytes"] = os.path.getsize(os.path.join(path, "arrays.npz"))
    if not all(map(math.isfinite, report["losses"])):
        raise RuntimeError(f"non-finite loss: {report['losses']}")
    log.result("done", rounds=args.rounds - start_round)
    report["state"] = state
    return report


def main(argv: Optional[Sequence[str]] = None) -> None:
    report = run(parse_args(argv))
    report.pop("state")
    print(json.dumps(report))


if __name__ == "__main__":
    main()
