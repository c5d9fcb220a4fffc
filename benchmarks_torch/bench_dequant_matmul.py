#!/usr/bin/env python3
"""``dequant_matmul`` alone at the serve paths' products, on the card: right, and how fast.

    python3 benchmarks_torch/bench_dequant_matmul.py

Phase 2 of ``chip_smoke.py`` for this one kernel, in about a minute: the
environment phase (the card's name and power limit, the build), then
``chip_smoke.check_dequant_matmul`` with its timer on each of chip_smoke's
serve products (``DM_SERVE`` and ``DM_PREFILL_SPLIT_K``, S1E3M7) and on decode
w1 in S1E5M10, a u16 format the kernel reads at run time.  Each case is
checked elementwise against the plain version within ``2e-5 * (|A| @
|W_eff|)``, with the same bits from two launches, and timed with CUDA
events (median of 20, L2 flushed before each launch) beside the plain
version, ``torch.matmul`` on the pre-decoded weight ("matmul alone") and
the bounds.  One JSON line per case, then one for the run.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.formats import FloatFormat  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bench_dequant_matmul: no CUDA device available")
    env = cs.phase_environment()
    timer = cs.Timer()
    cases = [(mkn, cs.FMT) for mkn in cs.DM_SERVE + cs.DM_PREFILL_SPLIT_K]
    cases.append((cs.DECODE_W1, FloatFormat.parse("S1E5M10")))
    rows = []
    for mkn, fmt in cases:
        r = cs.check_dequant_matmul(mkn, fmt, timer, seed=sum(mkn))
        print(json.dumps(r))
        rows.append(r)
        torch.cuda.empty_cache()
    print(json.dumps(dict(device=torch.cuda.get_device_name(0), smi=env["smi"], cases=rows)))


if __name__ == "__main__":
    main()
