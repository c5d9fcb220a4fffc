#!/usr/bin/env python3
"""Paper Fig. 4: PPQ at 11 bits (90%) against APQ at 13-bit formats (100%),
on the port (counterpart of ``benchmarks/fig4_ppq_vs_apq.py``).

    python3 benchmarks_torch/fig4_ppq_vs_apq.py            # full width, on the card
    python3 benchmarks_torch/fig4_ppq_vs_apq.py --smoke    # smoke config, on the CPU
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from benchmarks_torch.common import (conformer_setup, main, print_table,  # noqa: E402
                                     run_fl, save_result)
from repro_torch.core.omc import OMCConfig  # noqa: E402

VARIANTS = [
    ("PPQ S1E3M7 @90%", OMCConfig.parse("S1E3M7", quantize_fraction=0.9)),
    ("APQ S1E3M9", OMCConfig.parse("S1E3M9", quantize_fraction=1.0)),
    ("APQ S1E4M8", OMCConfig.parse("S1E4M8", quantize_fraction=1.0)),
    ("APQ S1E5M7", OMCConfig.parse("S1E5M7", quantize_fraction=1.0)),
]


def run(smoke: bool = False, rounds=None):
    fam, cfg, task, data_fn, evalb = conformer_setup(iid=True, smoke=smoke)
    rows = []
    for name, omc in VARIANTS:
        r = run_fl(fam, cfg, omc, data_fn, evalb, rounds=rounds, device=task.device)
        r["variant"] = name
        rows.append(r)
    print_table("Fig 4: PPQ@11b vs APQ@13b", rows, ["variant", "final_eval"])
    save_result("fig4_ppq_vs_apq", rows)
    return rows


if __name__ == "__main__":
    main(run)
