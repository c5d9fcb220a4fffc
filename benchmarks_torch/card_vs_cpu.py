#!/usr/bin/env python3
"""Phases 4 and 6 of ``chip_smoke.py`` alone: the served models' logits on the card against the CPU.

    python3 benchmarks_torch/card_vs_cpu.py [--arch qwen2.5-3b|recurrentgemma-2b]

Builds each model's storage at full width as chip_smoke's serve phases do
(random weights from seed 0 on the card, compressed to S1E3M7; the wire
roundtrip they add gives bit-identical storage), cuts it as chip_smoke
does (qwen2.5-3b to 1 layer, recurrentgemma-2b to its first super block,
3 layers, both to the first 32,768 rows of the tied embedding) and runs ``chip_smoke.card_vs_cpu``: prefill and 1 decode step
twice on the card (the same bits both times) and once on the CPU (over
the tree decoded once by the plain version), the
largest logit difference within 1e-3, and the sha256 of
each step's logits on both sides.  The environment phase prints the card,
the CPU's instruction set as ATen dispatches it and the CPU threads, so
that runs on other hosts or under other settings (``OMP_NUM_THREADS``,
``ATEN_CPU_CAPABILITY``, ``MKL_ENABLE_INSTRUCTIONS``) can be compared.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

from repro_torch.launch import serve  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=("qwen2.5-3b", "recurrentgemma-2b"), action="append",
                    help="the model (default: both)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("card_vs_cpu: no CUDA device available")
    cs.phase_environment()
    check = {"qwen2.5-3b": cs.phase_card_vs_cpu,
             "recurrentgemma-2b": cs.phase_griffin_card_vs_cpu}
    for arch in args.arch or list(check):
        sess, _, _ = serve.build_session(serve.parse_args(["--arch", arch]))
        check[arch](sess)
        del sess
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
