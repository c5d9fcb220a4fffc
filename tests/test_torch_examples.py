"""The scripts built on the non-IID path, ``examples_torch/`` and
``benchmarks_torch/cohort_scale.py``, on the CPU (the engine round on
Dirichlet data is held against the reference's in tests/test_torch_engine.py).

  * Each example's ``--smoke --device cpu`` runs and exits 0; the scenario
    drivers at one round a scenario (``--rounds 1``), the async scenarios at
    the smoke run's 3 flushes, which their staleness and gap lines need.
  * ``cohort_scale.py --smoke`` reconciles its codec bytes, and its rows'
    wire bytes equal the reference's analytic accounting for the same plan
    (``engine.round_wire_metrics`` on the reference's cohort and survival
    draws; no reference engine runs).
"""

import contextlib
import importlib.util
import io
import sys
from pathlib import Path

import jax
import pytest
import torch

from repro.core.omc import OMCConfig as JOMC
from repro.federated import accounting as jaccounting
from repro.federated import cohort as jcohort
from repro.federated import engine as jengine
from repro.federated.cohort import CohortPlan as JPlan
from repro.models import conformer as jcf

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
JCFG = jcf.ConformerConfig(n_layers=2, d_model=32, n_heads=4, d_ff=64, n_classes=16, d_in=8)


@pytest.fixture(scope="module")
def jinit():
    return jax.jit(lambda k: jcf.init(k, JCFG))(jax.random.PRNGKey(0))


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(f"_port_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ONE_ROUND = dict(cohort_scenarios=["--rounds", "1"], domain_adaptation=["--rounds", "1"])


@pytest.mark.parametrize("script", ["quickstart", "cohort_scenarios", "domain_adaptation",
                                    "async_scenarios"])
def test_example_smoke_runs_on_the_cpu(script):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = _load(ROOT / "examples_torch" / f"{script}.py").main(
            ["--smoke", "--device", "cpu", *ONE_ROUND.get(script, [])])
    text = out.getvalue()
    assert rc == 0, text
    want = dict(quickstart="round 1: loss=", cohort_scenarios="[noniid/dirichlet(0.1)] loss",
                domain_adaptation="target-domain loss after 6-bit adaptation",
                async_scenarios="[async_vs_sync] updates/virtual-s")[script]
    assert want in text, text
    assert "nan" not in text.lower()


def test_cohort_scale_smoke_reconciles_with_reference_accounting(jinit):
    sys.path.insert(0, str(ROOT))
    from benchmarks_torch import cohort_scale

    with contextlib.redirect_stdout(io.StringIO()):
        rows = cohort_scale.run(cohorts=(4, 8), rounds=2, smoke=True)
    assert (ROOT / "experiments" / "bench_torch" / "cohort_scale_smoke.json").exists()
    omc = JOMC.parse("S1E3M7")
    table = jaccounting.build_wire_table(jinit, jcf.param_specs(JCFG), omc)
    rkey = jax.random.fold_in(jax.random.PRNGKey(0), 0xC047)
    for row, cohort in zip(rows, (4, 8)):
        assert row["wire_match"] and row["codec_match"] and row["device"] == "cpu"
        spec = jengine.CohortSpec(JPlan(num_clients=2 * cohort, cohort_size=cohort))
        want = jengine.round_wire_metrics(
            table, omc, spec.tier_omcs(omc), jengine.sample_tiered_cohort(rkey, spec, 2),
            jcohort.survival_mask(rkey, spec.plan, 2), 2)
        assert (row["down_bytes"], row["up_bytes"]) == (want["down_bytes"], want["up_bytes"])
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        cohort_scale.run(cohorts=(4,), rounds=1, smoke=True, obs_overhead=True)
