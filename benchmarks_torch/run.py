"""Benchmark driver of the port: one entry per paper table and figure
(counterpart of ``benchmarks/run.py``).

    python -m benchmarks_torch.run [names...]

Runs each named script's ``run()`` (all of ``BENCHES`` without names): on
the card at full width, as each script runs without ``--smoke``.  The
budget knobs are the reference's environment variables (``BENCH_ROUNDS``,
``BENCH_CLIENTS``, ``BENCH_COHORT``, ``BENCH_BATCH``).

``BENCHES`` maps the reference's 14 names to the port's scripts, each with
a ``run()``; ``TOOLS`` lists the port's card-only probes, which this driver
does not run; ``ARTIFACTS`` maps every committed
``experiments/bench_torch/*.json`` to the bench that regenerates it.
``tests/test_torch_bench_registry.py`` audits all three against the scripts
on disk, the reference's registry and the committed artifacts.
"""

import importlib
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

#: name -> module path (lazy: importing a bench may touch the card).
BENCHES = {
    "table1_iid": "benchmarks_torch.table1_iid",
    "table2_adaptation": "benchmarks_torch.table2_adaptation",
    "table3_noniid": "benchmarks_torch.table3_noniid",
    "table4_ablation": "benchmarks_torch.table4_ablation",
    "fig3_pvt_stability": "benchmarks_torch.fig3_pvt_stability",
    "fig4_ppq_vs_apq": "benchmarks_torch.fig4_ppq_vs_apq",
    "memory_measured": "benchmarks_torch.memory_measured",
    "kernels_micro": "benchmarks_torch.kernels_micro",
    "roofline_report": "benchmarks_torch.roofline_report",
    "api_wire": "benchmarks_torch.api_wire",
    "compress_pareto": "benchmarks_torch.compress_pareto",
    "cohort_scale": "benchmarks_torch.cohort_scale",
    "async_scale": "benchmarks_torch.async_scale",
    "population_scale": "benchmarks_torch.population_scale",
}

#: the port's card-only probes (each run alone as a script) -> what it measures.
TOOLS = {
    "bench_client_axis": "the engine's round batched against serial and the conformer's "
                         "depthwise conv in four forms, one client and C batched",
    "bench_dequant_matmul": "B6 dequant_matmul alone at the serve products: error against "
                            "its bound, events time",
    "bench_dequantize": "B2 dequantize at the main paths' shapes beside its variants and an "
                        "earlier tree's kernel",
    "bench_pack_agg": "B4 pack and B5 fused_aggregate beside their variants and an earlier "
                      "tree's kernels",
    "card_vs_cpu": "chip_smoke phases 4 and 6 alone: served logits card against CPU",
    "profile_decode": "device busy against wall time per decode step and prefill",
    "profile_round": "host phases and device kernels of one training round",
}

#: committed experiments/bench_torch artifact -> the bench that regenerates it.
ARTIFACTS = {
    "async_scale.json": "async_scale",
    "compress_strategies.json": "compress_pareto",
    "kernels_micro.json": "kernels_micro",
    "population_scale.json": "population_scale",
}


def run_bench(name: str) -> None:
    importlib.import_module(BENCHES[name]).run()


def main(argv=None) -> None:
    names = list(sys.argv[1:] if argv is None else argv) or list(BENCHES)
    unknown = [n for n in names if n not in BENCHES]
    if unknown:
        raise SystemExit(f"unknown bench(es) {unknown}; known: {sorted(BENCHES)}")
    for name in names:
        t0 = time.time()
        print(f"\n######## {name} ########")
        run_bench(name)
        print(f"[{name}: {time.time() - t0:.0f}s]")


if __name__ == "__main__":
    main()
