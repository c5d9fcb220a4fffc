#!/usr/bin/env python3
"""The dry-run's roofline table (counterpart of ``benchmarks/roofline_report.py``).

Reads each ``<arch>_<shape>_pod*.json`` that ``python -m
repro_torch.launch.dryrun`` wrote to ``experiments/dryrun_torch/`` (or
``--dir``) into one table per (arch x shape x mesh): the compute, memory
and collective terms in ms (the collective term is 0: the port has no
collective schedule, ROADMAP C25), the dominant term and MODEL_FLOPS over
the counted FLOPs.  The terms are bounds from the H100's data-sheet rates
over meta-device counts, not card times.  Writes
``experiments/bench_torch/roofline_report.json``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    python3 benchmarks_torch/roofline_report.py
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from benchmarks_torch.common import print_table, save_result  # noqa: E402

DRYRUN_DIR = ROOT / "experiments" / "dryrun_torch"


def run(dryrun_dir=None):
    rows = []
    for path in sorted(Path(dryrun_dir or DRYRUN_DIR).glob("*_pod*.json")):
        d = json.loads(path.read_text())
        r = d["roofline"]
        tag = path.name.split("_pod", 1)[1].replace(".json", "").lstrip("_") or "base"
        rows.append(dict(
            tag=tag,
            arch=d["arch"], shape=d["shape"],
            mesh="x".join(map(str, d["mesh"])),
            fmt=d["fmt"],
            compute_ms=round(r["compute_s"] * 1e3, 3),
            memory_ms=round(r["memory_s"] * 1e3, 3),
            coll_ms=round(r["collective_s"] * 1e3, 3),
            dominant=r["dominant"],
            useful=round(r["useful_flops_ratio"], 2),
        ))
    print_table("Roofline terms per (arch x shape x mesh), meta-device counts", rows,
                ["arch", "shape", "mesh", "fmt", "tag", "compute_ms", "memory_ms", "coll_ms",
                 "dominant", "useful"])
    save_result("roofline_report", rows)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default=None, help="the dry-run's JSON directory")
    run(ap.parse_args(argv).dir)


if __name__ == "__main__":
    main()
