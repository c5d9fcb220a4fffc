"""The PyTorch port stands alone: no JAX, nothing of the reference package.

``src/repro_torch``, ``chip_smoke.py`` and ``benchmarks_torch`` import
``torch``, ``numpy`` and the standard library only; their entry points run
on the card unless the CPU is asked for.
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
from repro_torch.launch import serve
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
    assert len(_modules()) >= 25


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
                         + sorted((ROOT / "benchmarks_torch").glob("*.py")),
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


def test_unported_archs_and_families_name_the_roadmap():
    assert get_arch("qwen2.5-3b").ID == "qwen2.5-3b"
    with pytest.raises(KeyError, match="ROADMAP"):
        get_arch("mixtral-8x7b")
    with pytest.raises(KeyError, match="ROADMAP"):
        get_family("moe")
