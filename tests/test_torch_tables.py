"""PyTorch port vs the JAX reference: the paper-table reruns.

The port's ``benchmarks_torch/common.run_fl`` against the reference's
``benchmarks/common.run_fl`` at the reference's smoke size (conformer_s'
``smoke_config``, the ``BENCH_*`` defaults: 8 clients, cohort 4, batch 4)
for 3 rounds from the same seed.  Both packages draw the same init
(``prng`` follows ``jax.random``; ROADMAP C10), so no params are carried
across.  The gate is tests/test_torch_engine.py's: each round's ``cohort``
and ``dropped`` equal (``run_fl`` keeps no byte ledger: ``wire`` is off),
the train and eval curves and ``final_eval`` within 1e-3, and the byte
columns (``bytes_summary``) equal.  Rows: Table 1's two (non-streaming
conformer), Table 4's "quant" (PVT off, every parameter) and
"quant+pvt+weights+ppq".

Then each of the six scripts' ``run(smoke=True)`` on the CPU for one round,
which must go through the plain versions of ``quantize_stats`` and
``dequantize`` (and of ``quantize`` where a row has PVT off), as
``chip_smoke.py``'s phase 9 requires of the kernels on the card.
"""

import dataclasses
import importlib
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import common as jcommon  # noqa: E402
from benchmarks_torch import common as tcommon  # noqa: E402
from repro.core.omc import OMCConfig as JOMC  # noqa: E402
from repro.core.policy import QuantizePolicy as JPolicy  # noqa: E402
from repro.federated import simulate as jsimulate  # noqa: E402
from repro_torch.core.omc import OMCConfig  # noqa: E402
from repro_torch.core.policy import QuantizePolicy  # noqa: E402
from repro_torch.federated import simulate  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

torch.set_num_threads(1)

ROUNDS = 3
ALL_PARAMS = dict(weights_only=False, min_ndim=0, min_size=1)
# row -> (non-streaming config?, format, OMCConfig fields with the policy's as a dict)
ROWS = {
    "table1-S1E8M23": (True, "S1E8M23", {}),
    "table1-S1E4M14": (True, "S1E4M14", {}),
    "table4-quant": (False, "S1E3M7", dict(pvt=False, quantize_fraction=1.0,
                                           policy=ALL_PARAMS)),
    "table4-quant+pvt+weights+ppq": (False, "S1E3M7", dict(pvt=True, quantize_fraction=0.9)),
}


def _omc(cls, policy_cls, fmt, fields):
    fields = dict(fields)
    if "policy" in fields:
        fields["policy"] = policy_cls(**fields["policy"])
    return cls.parse(fmt, **fields)


def _histories(monkeypatch, module):
    """Record the history of every ``run_training`` that ``module`` runs."""
    seen, run_training = [], module.run_training

    def spy(*args, **kw):
        out = run_training(*args, **kw)
        seen.append(out[1])
        return out

    monkeypatch.setattr(module, "run_training", spy)
    return seen


def _row(common, non_streaming, omc, **kw):
    fam, cfg, _, data_fn, evalb = common.conformer_setup(iid=True, **kw)
    if non_streaming:
        cfg = dataclasses.replace(cfg, window=None, causal_conv=False)
    run_kw = dict(device="cpu") if kw else {}
    return (common.run_fl(fam, cfg, omc, data_fn, evalb, rounds=ROUNDS, **run_kw),
            common.bytes_summary(fam, cfg, omc, **run_kw))


@pytest.mark.parametrize("row", list(ROWS))
def test_table_row_matches_reference(row, monkeypatch):
    non_streaming, fmt, fields = ROWS[row]
    jhist, thist = _histories(monkeypatch, jsimulate), _histories(monkeypatch, simulate)
    want, want_bytes = _row(jcommon, non_streaming, _omc(JOMC, JPolicy, fmt, fields))
    got, got_bytes = _row(tcommon, non_streaming, _omc(OMCConfig, QuantizePolicy, fmt, fields),
                          smoke=True)
    assert got_bytes == want_bytes
    # the timed run is each side's last (the port runs an untimed warm round first)
    assert len(jhist[-1]) == len(thist[-1]) == ROUNDS
    for a, b in zip(jhist[-1], thist[-1]):
        for k in ("round", "cohort", "dropped", "down_bytes", "up_bytes"):
            assert a.get(k) == b.get(k), (k, a, b)
    for k in ("fmt", "pvt", "fraction", "weights_only", "rounds"):
        assert got[k] == want[k], k
    for k in ("train_curve", "eval_curve"):
        assert len(got[k]) == len(want[k]) == ROUNDS
        assert max(abs(x - y) for x, y in zip(got[k], want[k])) < 1e-3, (k, got[k], want[k])
    assert abs(got["final_eval"] - want["final_eval"]) < 1e-3
    assert set(want) <= set(got) and got["device"] == "cpu"


# script -> plain versions its smoke run must reach
SCRIPTS = {
    "table1_iid": ("quantize_stats", "dequantize"),
    "table2_adaptation": ("quantize_stats", "dequantize"),
    "table3_noniid": ("quantize_stats", "dequantize"),
    "table4_ablation": ("quantize_stats", "dequantize", "quantize"),
    "fig3_pvt_stability": ("quantize_stats", "dequantize", "quantize"),
    "fig4_ppq_vs_apq": ("quantize_stats", "dequantize"),
}


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_table_script_runs_on_the_cpu_with_smoke(script, monkeypatch, tmp_path):
    monkeypatch.setattr(tcommon, "OUT_DIR", tmp_path)
    mod = importlib.import_module(f"benchmarks_torch.{script}")
    ops.reset_launch_counts()
    rows = mod.run(smoke=True, rounds=1)
    counts = ops.launch_counts()
    assert (tmp_path / f"{script}.json").exists()
    assert not any(k.endswith(".cuda") for k in counts), counts
    for op in SCRIPTS[script]:
        assert counts.get(f"{op}.ref", 0) > 0, (op, counts)
    assert all(torch.isfinite(torch.tensor(r["final_eval"])) for r in rows)
    if script == "table1_iid":
        assert [r["mem_pct"] for r in rows] == [100, 64]
