#!/usr/bin/env python3
"""Paper Table 3: Non-Streaming Conformer on Non-IID LibriSpeech
(surrogate), on the port (counterpart of ``benchmarks/table3_noniid.py``).

Same formats as Table 1, with the per-speaker (non-IID) partition.

    python3 benchmarks_torch/table3_noniid.py            # full width, on the card
    python3 benchmarks_torch/table3_noniid.py --smoke    # smoke config, on the CPU
"""

import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from benchmarks_torch.common import (conformer_setup, main, print_table,  # noqa: E402
                                     run_fl, save_result)
from repro_torch.core.omc import OMCConfig  # noqa: E402


def run(smoke: bool = False, rounds=None):
    fam, cfg_s, task, data_fn, evalb = conformer_setup(iid=False, smoke=smoke)
    cfg = dataclasses.replace(cfg_s, window=None, causal_conv=False)
    rows = []
    for fmt in ("S1E8M23", "S1E4M14"):
        rows.append(run_fl(fam, cfg, OMCConfig.parse(fmt), data_fn, evalb, rounds=rounds,
                           device=task.device))
    print_table("Table 3: Non-Streaming Conformer, Non-IID", rows, ["fmt", "final_eval"])
    save_result("table3_noniid", rows)
    return rows


if __name__ == "__main__":
    main(run)
