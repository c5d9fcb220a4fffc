#!/usr/bin/env python3
"""Paper Table 1: Non-Streaming Conformer on IID LibriSpeech (surrogate), on
the port (counterpart of ``benchmarks/table1_iid.py``).

f32 (S1E8M23) against OMC S1E4M14: comparable loss at 64% parameter
memory / communication, with the round-speed overhead in ``speed_pct``.

    python3 benchmarks_torch/table1_iid.py            # full width, on the card
    python3 benchmarks_torch/table1_iid.py --smoke    # smoke config, on the CPU
"""

import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from benchmarks_torch.common import (bytes_summary, conformer_setup, main,  # noqa: E402
                                     print_table, run_fl, save_result)
from repro_torch.core.omc import OMCConfig  # noqa: E402


def run(smoke: bool = False, rounds=None):
    fam, cfg_s, task, data_fn, evalb = conformer_setup(iid=True, smoke=smoke)
    cfg = dataclasses.replace(cfg_s, window=None, causal_conv=False)  # non-streaming
    rows = []
    for fmt in ("S1E8M23", "S1E4M14"):
        omc = OMCConfig.parse(fmt)
        r = run_fl(fam, cfg, omc, data_fn, evalb, rounds=rounds, device=task.device)
        byt = bytes_summary(fam, cfg, omc, device=task.device)
        r["mem_ratio"] = byt["packed_ratio"]
        rows.append(r)
    base = rows[0]
    for r in rows:
        r["speed_pct"] = round(100 * r["rounds_per_min"] / max(base["rounds_per_min"], 1e-9))
        r["mem_pct"] = round(100 * r["mem_ratio"])
    print_table("Table 1: Non-Streaming Conformer, IID",
                rows, ["fmt", "final_eval", "mem_pct", "speed_pct", "rounds_per_min"])
    save_result("table1_iid", rows)
    return rows


if __name__ == "__main__":
    main(run)
