"""The package-level names of ``core``, ``api``, ``data`` and ``obs``: the
port's against the reference's.

Each package's public names (its ``__all__``; the reference's ``api`` has
none, so its public non-module names) are compared.  The port must define
every name it exports, export none the reference lacks, and lack exactly
the reference's names of later slices: the six that come with the
compression strategies in ``core`` (ROADMAP A7) and the six of ``Obs`` and
its tracer in ``obs`` (ROADMAP A9).
"""

import importlib
import types

import pytest

A7 = {"FP32", "qdq", "qdq_ste", "qdq_pvt", "coverage", "selection_mask_tree"}
A9 = {"Obs", "MetricsSink", "Tracer", "Span", "Bundle", "maybe_span"}


def _public(mod):
    names = getattr(mod, "__all__", None)
    if names is not None:
        return set(names)
    return {n for n, v in vars(mod).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)}


@pytest.mark.parametrize("pkg, missing", [("core", A7), ("api", set()), ("data", set()),
                                          ("obs", A9)])
def test_package_names_match_the_reference(pkg, missing):
    ref = importlib.import_module(f"repro.{pkg}")
    port = importlib.import_module(f"repro_torch.{pkg}")
    names = set(port.__all__)
    assert len(names) == len(port.__all__), "duplicate names"
    assert names <= _public(ref), names - _public(ref)
    assert _public(ref) - names == missing
    for n in names:
        assert hasattr(port, n), n


def test_package_name_counts():
    import repro.core
    import repro_torch.api
    import repro_torch.core

    assert len(repro.core.__all__) == 35 and len(repro_torch.core.__all__) == 29
    assert len(repro_torch.api.__all__) == 15
