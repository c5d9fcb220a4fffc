"""``benchmarks_torch/run.py``'s registry audit, and the card beside saved results.

Invariants, as ``tests/test_benchmarks_registry.py`` holds the reference's:
  * every script in ``benchmarks_torch/`` is in ``BENCHES`` or in ``TOOLS``,
    not in both, and ``BENCHES`` has the reference's names;
  * each entry's module resolves to a file, and each bench has ``run()``;
  * every ``ARTIFACTS`` generator is a bench, and every git-tracked
    ``experiments/bench_torch/*.json`` names one, is listed, and records the
    card it ran on;
  * an unknown name raises ``SystemExit``.
``common.save_result`` writes ``card`` beside a payload only in a process
that has used the card.
"""

import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks.run import BENCHES as REFERENCE_BENCHES  # noqa: E402
from benchmarks_torch import common  # noqa: E402
from benchmarks_torch.run import ARTIFACTS, BENCHES, TOOLS, main  # noqa: E402

torch.set_num_threads(1)

_NON_BENCH = {"run.py", "common.py", "__init__.py"}
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def _scripts_on_disk():
    return {f[:-3] for f in os.listdir(ROOT / "benchmarks_torch")
            if f.endswith(".py") and f not in _NON_BENCH}


def _committed():
    try:
        out = subprocess.run(["git", "ls-files", "experiments/bench_torch"], cwd=ROOT,
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        pytest.skip("git unavailable")
    if out.returncode != 0:
        pytest.skip("not a git checkout")
    return {os.path.basename(p) for p in out.stdout.split() if p.endswith(".json")}


def test_every_script_is_a_bench_or_a_tool():
    on_disk = _scripts_on_disk()
    assert not set(BENCHES) & set(TOOLS)
    assert on_disk == set(BENCHES) | set(TOOLS), (
        f"unregistered scripts: {sorted(on_disk - set(BENCHES) - set(TOOLS))}; "
        f"entries without a script: {sorted(set(BENCHES) | set(TOOLS) - on_disk)}")


def test_benches_are_the_reference_s():
    assert set(BENCHES) == set(REFERENCE_BENCHES)


@pytest.mark.parametrize("name", sorted(BENCHES) + sorted(TOOLS))
def test_registry_modules_resolve(name):
    module = BENCHES.get(name, f"benchmarks_torch.{name}")
    assert module == f"benchmarks_torch.{name}"
    assert (ROOT / Path(*module.split("."))).with_suffix(".py").exists()
    if name in BENCHES:
        assert callable(importlib.import_module(module).run)
    else:
        assert TOOLS[name].strip()


def test_artifact_generators_registered():
    for artifact, bench in ARTIFACTS.items():
        assert bench in BENCHES, f"{artifact} names unknown bench {bench!r}"


def test_committed_artifacts_have_generators_and_cards():
    committed = _committed()
    assert committed == set(ARTIFACTS), (
        f"committed without a generator: {sorted(committed - set(ARTIFACTS))}; "
        f"listed but not committed: {sorted(set(ARTIFACTS) - committed)}")
    for artifact in committed:
        payload = json.loads((ROOT / "experiments" / "bench_torch" / artifact).read_text())
        assert payload["card"].startswith("NVIDIA H100"), (artifact, payload.get("card"))


def test_unknown_bench_raises():
    with pytest.raises(SystemExit, match="unknown bench"):
        main(["not_a_bench"])


def test_main_runs_the_named_benches(monkeypatch):
    ran = []
    monkeypatch.setattr("benchmarks_torch.run.run_bench", ran.append)
    main(["async_scale", "api_wire"])
    main([])
    assert ran == ["async_scale", "api_wire"] + list(BENCHES)


@pytest.mark.parametrize("payload", [dict(a=1), [dict(a=1), dict(a=2)]])
def test_save_result_records_the_card_only_after_the_card_was_used(payload, tmp_path,
                                                                   monkeypatch):
    monkeypatch.setattr(common, "OUT_DIR", tmp_path)
    monkeypatch.setattr(common, "card", lambda: CARD)
    common.save_result("plain", payload)
    assert json.loads((tmp_path / "plain.json").read_text()) == payload
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    common.save_result("carded", payload)
    got = json.loads((tmp_path / "carded.json").read_text())
    if isinstance(payload, dict):
        assert got == dict(payload, card=CARD)
    else:
        assert got == [dict(row, card=CARD) for row in payload]
    assert "card" not in (payload if isinstance(payload, dict) else payload[0])
