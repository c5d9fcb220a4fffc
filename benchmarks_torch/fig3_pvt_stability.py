#!/usr/bin/env python3
"""Paper Fig. 3: PVT stabilizes from-scratch training at S1E5M10, on the
port (counterpart of ``benchmarks/fig3_pvt_stability.py``).  The PVT-off
rows encode through ``quantize``.

    python3 benchmarks_torch/fig3_pvt_stability.py            # full width, on the card
    python3 benchmarks_torch/fig3_pvt_stability.py --smoke    # smoke config, on the CPU
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from benchmarks_torch.common import (conformer_setup, main, print_table,  # noqa: E402
                                     run_fl, save_result)
from repro_torch.core.omc import OMCConfig  # noqa: E402


def run(smoke: bool = False, rounds=None):
    fam, cfg, task, data_fn, evalb = conformer_setup(iid=True, smoke=smoke)
    rows = []
    # S1E5M10 is the paper's format (its instability shows over ~12k rounds);
    # S1E2M3 makes the PVT effect visible at benchmark scale.
    for fmt in ("S1E5M10", "S1E2M3"):
        for pvt in (False, True):
            omc = OMCConfig.parse(fmt, pvt=pvt, quantize_fraction=1.0)
            r = run_fl(fam, cfg, omc, data_fn, evalb, rounds=rounds, device=task.device)
            r["pvt"] = pvt
            rows.append(r)
    print_table("Fig 3: from-scratch training, with/without PVT",
                rows, ["fmt", "pvt", "final_eval"])
    save_result("fig3_pvt_stability", rows)
    return rows


if __name__ == "__main__":
    main(run)
