#!/usr/bin/env python3
"""Paper Table 4: ablation — quantize -> +PVT -> +weights-only -> +PPQ, on
the port (counterpart of ``benchmarks/table4_ablation.py``).

Reproduces the ordering: raw S1E3M7 hurts, each mechanism recovers loss.
The "quant" row (PVT off, every parameter) encodes through ``quantize``.

    python3 benchmarks_torch/table4_ablation.py            # full width, on the card
    python3 benchmarks_torch/table4_ablation.py --smoke    # smoke config, on the CPU
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from benchmarks_torch.common import (conformer_setup, main, print_table,  # noqa: E402
                                     run_fl, save_result)
from repro_torch.core.omc import OMCConfig  # noqa: E402
from repro_torch.core.policy import QuantizePolicy  # noqa: E402

ALL_PARAMS = QuantizePolicy(weights_only=False, min_ndim=0, min_size=1)
VARIANTS = [
    ("fp32", OMCConfig.parse("S1E8M23")),
    ("quant", OMCConfig.parse("S1E3M7", pvt=False, quantize_fraction=1.0, policy=ALL_PARAMS)),
    ("quant+pvt", OMCConfig.parse("S1E3M7", pvt=True, quantize_fraction=1.0, policy=ALL_PARAMS)),
    ("quant+pvt+weights", OMCConfig.parse("S1E3M7", pvt=True, quantize_fraction=1.0)),
    ("quant+pvt+weights+ppq", OMCConfig.parse("S1E3M7", pvt=True, quantize_fraction=0.9)),
]


def run(smoke: bool = False, rounds=None):
    fam, cfg, task, data_fn, evalb = conformer_setup(iid=True, smoke=smoke)
    rows = []
    for name, omc in VARIANTS:
        r = run_fl(fam, cfg, omc, data_fn, evalb, rounds=rounds, device=task.device)
        r["variant"] = name
        rows.append(r)
    print_table("Table 4: ablation (S1E3M7)", rows, ["variant", "final_eval"])
    save_result("table4_ablation", rows)
    return rows


if __name__ == "__main__":
    main(run)
