"""The port's examples (``examples_torch/``, the non-IID scenario drivers
and the strategy walkthroughs) and ``benchmarks_torch/cohort_scale.py``, on
the CPU (the engine round on
Dirichlet data is held against the reference's in tests/test_torch_engine.py).

  * Each example's ``--smoke --device cpu`` runs and exits 0; the scenario
    drivers at one round a scenario (``--rounds 1``), the async scenarios at
    the smoke run's 3 flushes, which their staleness and gap lines need.
    So do the telemetry runs: the demo with ``--obs``, ``cohort_scale.py
    --obs-overhead`` and ``async_scale.py --trace`` (one timed round each),
    each writing a JSONL that ``python -m repro_torch.obs.report`` renders.
  * ``cohort_scale.py --smoke`` reconciles its codec bytes, and its rows'
    wire bytes equal the reference's analytic accounting for the same plan
    (``engine.round_wire_metrics`` on the reference's cohort and survival
    draws; no reference engine runs).
  * ``serve_omc.py`` and ``train_100m.py`` run the port's CLIs with the
    reference's argument lists (read from the reference's files, which run
    at import, and stated here), and exit 0 with ``--device cpu``.
  * ``async_scale.py --reference-row`` runs the reference's default row:
    its ``CFG`` and its ``run()``'s defaults (not run here: about 40 s).
"""

import ast
import contextlib
import dataclasses
import importlib
import importlib.util
import inspect
import io
import subprocess
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
# the telemetry runs: (script, arguments, the JSONL it writes under experiments/obs/)
TELEMETRY = {
    "demo --obs": ("repro_torch.api.demo", ["--smoke", "--device", "cpu", "--obs"], "api_demo"),
    "cohort_scale --obs-overhead": (ROOT / "benchmarks_torch" / "cohort_scale.py",
                                    ["--smoke", "--rounds", "1", "--obs-overhead"], None),
    "async_scale --trace": (ROOT / "benchmarks_torch" / "async_scale.py",
                            ["--smoke", "--trace"], "async_scale"),
}


@pytest.mark.parametrize("script", ["quickstart", "cohort_scenarios", "domain_adaptation",
                                    "async_scenarios", "compress_strategies",
                                    "train_under_strategy", *TELEMETRY])
def test_example_smoke_runs_on_the_cpu(script, tmp_path, monkeypatch):
    out = io.StringIO()
    if script in TELEMETRY:
        path, argv, run = TELEMETRY[script]
        monkeypatch.chdir(tmp_path)  # experiments/obs/ lands here
        sys.path.insert(0, str(ROOT))
        mod = importlib.import_module(path) if isinstance(path, str) else _load(path)
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
            rc = mod.main(argv)
    else:
        with contextlib.redirect_stdout(out):
            rc = _load(ROOT / "examples_torch" / f"{script}.py").main(
                ["--smoke", "--device", "cpu", *ONE_ROUND.get(script, [])])
    text = out.getvalue()
    assert rc == 0, text
    want = dict(quickstart="round 1: loss=", cohort_scenarios="[noniid/dirichlet(0.1)] loss",
                domain_adaptation="target-domain loss after 6-bit adaptation",
                async_scenarios="[async_vs_sync] updates/virtual-s",
                compress_strategies="pipe-s1e3m7-0.1    tag=pipeline v1",
                train_under_strategy="residual norm after training",
                **{"demo --obs": "wrote experiments/obs/api_demo.obs.jsonl",
                   "cohort_scale --obs-overhead": "Telemetry overhead (engine, obs on vs off)",
                   "async_scale --trace": "wrote experiments/obs/async_scale.obs.jsonl"})[script]
    assert want in text, text
    assert "nan" not in text.lower()
    if script in TELEMETRY and TELEMETRY[script][2]:
        from repro_torch.obs import report
        from repro_torch.obs.export import read_jsonl

        jsonl = tmp_path / "experiments" / "obs" / f"{TELEMETRY[script][2]}.obs.jsonl"
        kinds = {r["kind"] for r in read_jsonl(str(jsonl))}
        assert {"meta", "span"} <= kinds and ("flush" in kinds or "log" in kinds), kinds
        with contextlib.redirect_stdout(io.StringIO()):
            assert report.main([str(jsonl)]) == 0


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


# The reference's argument lists, as examples/serve_omc.py:13-18 and
# examples/train_100m.py:15-22 build them (``full``: ``--full`` given).
REFERENCE_SERVE = ["-m", "repro.launch.serve", "--arch", "qwen2.5-3b", "--smoke", "--batch",
                   "4", "--prompt-len", "32", "--gen", "16", "--fmt", "S1E3M7"]


def reference_train(full: bool) -> list:
    return (["-m", "repro.launch.train", "--arch", "conformer_s", "--rounds",
             "200" if full else "30", "--batch", "8", "--fmt", "S1E3M7", "--ckpt-dir",
             "/tmp/omc_train_100m", "--ckpt-every", "10"] + ([] if full else ["--smoke"]))


def _reference_list(name: str, full: bool) -> list:
    """The first list literal of ``examples/<name>.py``, evaluated without
    running the file: ``sys.executable`` and ``"200" if full else "30"``."""
    tree = ast.parse((ROOT / "examples" / f"{name}.py").read_text())
    node = next(n for n in ast.walk(tree) if isinstance(n, ast.List))

    def value(e):
        if isinstance(e, ast.IfExp):
            assert isinstance(e.test, ast.Name) and e.test.id == "full"
            return value(e.body if full else e.orelse)
        if isinstance(e, ast.Attribute):
            assert (e.value.id, e.attr) == ("sys", "executable")
            return sys.executable
        return e.value

    return [value(e) for e in node.elts]


def _ported(args: list) -> list:
    return [a.replace("repro.launch", "repro_torch.launch")
            .replace("/tmp/omc_train_100m", "/tmp/omc_train_100m_torch") for a in args]


@pytest.mark.parametrize("name,full", [("serve_omc", False), ("train_100m", False),
                                       ("train_100m", True)])
def test_script_examples_pass_the_reference_s_arguments(name, full):
    example = _load(ROOT / "examples_torch" / f"{name}.py")
    if name == "serve_omc":
        stated, got = REFERENCE_SERVE, example.command()
        on_file = _reference_list(name, full)
    else:
        stated, got = reference_train(full), example.command(full)
        on_file = _reference_list(name, full) + ([] if full else ["--smoke"])
    assert on_file == [sys.executable] + stated
    assert got == [sys.executable] + _ported(stated)
    extra = ["--device", "cpu", "--rounds", "2"]
    more = example.command(extra) if name == "serve_omc" else example.command(full, extra)
    assert more == got + extra  # further arguments follow the reference's


@pytest.mark.parametrize("name", ["serve_omc", "train_100m"])
def test_script_examples_run_on_the_cpu(name, tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    argv = ["--device", "cpu", "--quiet"]
    if name == "train_100m":
        argv += ["--rounds", "2", "--ckpt-dir", str(tmp_path)]
    assert _load(ROOT / "examples_torch" / f"{name}.py").main(argv) == 0
    if name == "train_100m":
        assert (tmp_path / "ckpt_2" / "arrays.npz").exists()


@pytest.mark.parametrize("name", ["serve_omc", "train_100m"])
def test_script_examples_without_a_card_fail_instead_of_using_the_cpu(name, tmp_path,
                                                                      monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the example would run on it")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    argv = ["--quiet"] + (["--ckpt-dir", str(tmp_path)] if name == "train_100m" else [])
    with pytest.raises(subprocess.CalledProcessError):
        _load(ROOT / "examples_torch" / f"{name}.py").main(argv)
    assert not list(tmp_path.iterdir())


def test_async_scale_reference_row_is_the_reference_s_default_row():
    sys.path.insert(0, str(ROOT))
    from benchmarks import async_scale as jbench
    from benchmarks_torch import async_scale as bench

    assert dataclasses.asdict(bench.SMOKE_CFG) == dataclasses.asdict(jbench.CFG)
    defaults = {k: p.default for k, p in inspect.signature(jbench.run).parameters.items()}
    assert bench.REFERENCE_ROW == {k: defaults[k] for k in bench.REFERENCE_ROW}
    assert set(defaults) - set(bench.REFERENCE_ROW) == {"seed", "smoke", "trace"}
    assert (defaults["seed"], defaults["smoke"]) == (0, False)


def test_async_scale_reference_row_without_a_card_raises(monkeypatch):
    sys.path.insert(0, str(ROOT))
    from benchmarks_torch import async_scale as bench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        bench.main(["--reference-row"])
