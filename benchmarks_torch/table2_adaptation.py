#!/usr/bin/env python3
"""Paper Table 2: Streaming Conformer domain adaptation (surrogate), on the
port (counterpart of ``benchmarks/table2_adaptation.py``).

Pretrain on the Non-MF analogue (domain 0), adapt on MF (domain 1).
Domain adaptation tolerates smaller bitwidths: S1E3M7 matches f32; even
S1E2M3 improves over the before-adaptation baseline (asserted).

    python3 benchmarks_torch/table2_adaptation.py            # full width, on the card
    python3 benchmarks_torch/table2_adaptation.py --smoke    # smoke config, on the CPU
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from benchmarks_torch.common import (BENCH_BATCH, BENCH_CLIENTS, BENCH_COHORT,  # noqa: E402
                                     BENCH_ROUNDS, bytes_summary, conformer_setup, eval_loss,
                                     main, print_table, save_result)
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.omc import OMCConfig  # noqa: E402
from repro_torch.core.store import decompress_tree  # noqa: E402
from repro_torch.data.synthetic import make_frame_task  # noqa: E402
from repro_torch.federated import simulate  # noqa: E402
from repro_torch.federated.cohort import CohortPlan  # noqa: E402


def run(smoke: bool = False, rounds=None):
    rounds = rounds or BENCH_ROUNDS
    fam, cfg, task, _, _ = conformer_setup(smoke=smoke)
    dev = task.device
    # domain 0 = source (Non-MF analogue); domain 1 = target (MF analogue)
    src = make_frame_task(d_in=cfg.d_in, n_classes=cfg.n_classes, seq_len=32,
                          num_clients=BENCH_CLIENTS, iid=True, domain=0, device=dev)
    tgt = make_frame_task(d_in=cfg.d_in, n_classes=cfg.n_classes, seq_len=32,
                          num_clients=BENCH_CLIENTS, iid=True, domain=1, device=dev)
    tgt_eval = [tgt.batch(100 + i, 10_000, 0, BENCH_BATCH) for i in range(4)]

    # pretrain once in f32 on the source domain
    omc_fp = OMCConfig.parse("S1E8M23")
    sim = simulate.SimConfig(local_steps=1, client_lr=0.1)
    plan = CohortPlan(num_clients=BENCH_CLIENTS, cohort_size=BENCH_COHORT)
    pre_params, _ = simulate.run_training(
        fam, cfg, omc_fp, sim, plan, lambda c, r, s: src.batch(c, r, s, BENCH_BATCH),
        prng.PRNGKey(0), num_rounds=rounds, eval_every=10**9, device=dev)
    before = eval_loss(fam, cfg, decompress_tree(pre_params), tgt_eval)

    rows = [dict(fmt="before-adaptation", final_eval=before)]
    for fmt in ("S1E8M23", "S1E3M7", "S1E2M3"):
        omc = OMCConfig.parse(fmt)
        params, _ = simulate.run_training(
            fam, cfg, omc, sim, plan, lambda c, r, s: tgt.batch(c, r, s, BENCH_BATCH),
            prng.PRNGKey(1), num_rounds=rounds, eval_every=10**9,
            init_params=decompress_tree(pre_params))
        byt = bytes_summary(fam, cfg, omc, device=dev)
        rows.append(dict(fmt=fmt, final_eval=eval_loss(fam, cfg, decompress_tree(params),
                                                       tgt_eval),
                         mem_pct=round(100 * byt["packed_ratio"])))
    print_table("Table 2: Streaming Conformer, domain adaptation",
                rows, ["fmt", "final_eval", "mem_pct"])
    assert rows[-1]["final_eval"] < rows[0]["final_eval"], \
        "S1E2M3 should still improve over before-adaptation"
    save_result("table2_adaptation", rows)
    return rows


if __name__ == "__main__":
    main(run)
