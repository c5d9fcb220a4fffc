"""The PyTorch port stands alone: no JAX, nothing of the reference package.

``src/repro_torch``, ``chip_smoke.py``, ``benchmarks_torch`` and
``examples_torch`` import ``torch``, ``numpy`` and the standard library
only; their entry points run on the card unless the CPU is asked for.
"""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.configs.registry import get_arch
from repro_torch.launch import serve, train
from repro_torch.models.registry import get_family

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))


def test_importing_every_module_loads_no_jax_and_no_reference():
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert len(_modules()) >= 25 and "repro_torch.data.partition" in _modules()


def test_examples_import_no_jax_and_no_reference():
    """Each ``examples_torch`` script, imported (not run), loads no JAX."""
    code = ("import importlib.util, pathlib, sys\n"
            f"for p in sorted(pathlib.Path({str(ROOT / 'examples_torch')!r}).glob('*.py')):\n"
            "    spec = importlib.util.spec_from_file_location('ex_' + p.stem, p)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert len(list((ROOT / "examples_torch").glob("*.py"))) == 4


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
                         + sorted((ROOT / "benchmarks_torch").glob("*.py"))
                         + sorted((ROOT / "examples_torch").glob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_reference(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_serve_without_a_card_raises_instead_of_using_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.run(serve.parse_args(["--smoke"]))


def test_griffin_serve_without_a_card_raises_instead_of_using_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert get_family(get_arch("recurrentgemma-2b").FAMILY).__name__ == "repro_torch.models.griffin"
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.run(serve.parse_args(["--smoke", "--arch", "recurrentgemma-2b"]))


def test_train_without_a_card_raises_instead_of_using_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.run(train.parse_args(["--smoke", "--rounds", "1"]))
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.run(train.parse_args([]))  # the full-width default, conformer_s


def test_async_runtime_without_a_card_raises_instead_of_using_the_cpu(monkeypatch):
    from repro_torch.core import prng
    from repro_torch.core.omc import OMCConfig
    from repro_torch.federated import async_engine, simulate, traces
    from repro_torch.models import conformer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = conformer.ConformerConfig(n_layers=1, d_model=16, n_heads=2, d_ff=32, n_classes=8,
                                    d_in=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        async_engine.run_async_training(
            conformer, cfg, OMCConfig.parse("S1E3M7"), simulate.SimConfig(),
            async_engine.AsyncConfig(buffer_goal=2), traces.FixedTrace(), None,
            prng.PRNGKey(0), num_clients=2, flushes=1)


def test_sessions_without_a_card_raise_instead_of_using_the_cpu(monkeypatch):
    from repro_torch.api import demo
    from repro_torch.api.session import FLClient, FLSession, ServeSession
    from repro_torch.core.omc import OMCConfig
    from repro_torch.models import transformer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = transformer.TransformerConfig(n_layers=1, d_model=16, n_heads=2, n_kv_heads=1,
                                        d_ff=32, vocab=32)
    omc = OMCConfig.parse("S1E3M7")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FLSession(transformer, cfg, omc)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FLClient(0, transformer, cfg, omc, lambda p, c, r: p)
    payload = FLSession(transformer, cfg, omc, device="cpu").server_payload()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeSession.from_payload(transformer, cfg, payload)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        demo.main(["--smoke"])


def test_unported_archs_and_families_name_the_roadmap():
    assert get_arch("qwen2.5-3b").ID == "qwen2.5-3b"
    with pytest.raises(KeyError, match="ROADMAP"):
        get_arch("mixtral-8x7b")
    with pytest.raises(KeyError, match="ROADMAP"):
        get_family("moe")


def test_partitioned_data_without_a_card_raises_instead_of_using_the_cpu(monkeypatch):
    from repro_torch.data.partition import DirichletPartition, make_partitioned_batch_fn
    from repro_torch.data.synthetic import make_frame_task

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    task = make_frame_task(d_in=4, n_classes=8, seq_len=8, num_clients=4)  # device="cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_partitioned_batch_fn(task, DirichletPartition(), 2)
    assert make_partitioned_batch_fn(make_frame_task(d_in=4, n_classes=8, seq_len=8,
                                                     num_clients=4, device="cpu"),
                                     DirichletPartition(), 2)(1, 0, 0)["labels"].shape == (2, 8)


@pytest.mark.parametrize("script", ["quickstart", "cohort_scenarios"])
def test_examples_without_a_card_raise_instead_of_using_the_cpu(monkeypatch, script):
    import importlib.util

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = ROOT / "examples_torch" / f"{script}.py"
    spec = importlib.util.spec_from_file_location(f"_noc_{script}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(RuntimeError, match="--device cpu"):
        mod.main(["--smoke"])
