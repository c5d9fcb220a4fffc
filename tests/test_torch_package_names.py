"""The package-level names of ``core``, ``api``, ``data``, ``obs``,
``scale``, ``roofline``, ``configs`` and ``models``: the port's against the
reference's.

Each package's public names (its ``__all__``; the reference's ``api`` has
none, so its public non-module names) are compared.  The port must define
every name it exports, export none the reference lacks, and lack none:
``core`` has all of the reference's since the compression strategies came
(ROADMAP A7), ``obs`` its seven since telemetry came (ROADMAP A11), ``scale``
its twelve since the sharded population runtime came (ROADMAP A9),
``configs`` and ``models`` their five and two since A13.
``roofline`` lacks ``analyze_compiled`` and ``collective_bytes``, which
read XLA's HLO text (ROADMAP C25).
"""

import importlib
import types

import pytest

def _public(mod):
    names = getattr(mod, "__all__", None)
    if names is not None:
        return set(names)
    return {n for n, v in vars(mod).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)}


@pytest.mark.parametrize("pkg, missing", [("core", set()), ("api", set()), ("data", set()),
                                          ("obs", set()), ("scale", set()),
                                          ("roofline", {"analyze_compiled",
                                                        "collective_bytes"}),
                                          ("configs", set()), ("models", set())])
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

    assert len(repro.core.__all__) == 35 and len(repro_torch.core.__all__) == 35
    assert len(repro_torch.api.__all__) == 15
    import repro_torch.obs

    assert len(repro_torch.obs.__all__) == 7
    import repro.scale
    import repro_torch.scale

    assert len(repro.scale.__all__) == 12 and len(repro_torch.scale.__all__) == 12


def test_assigned_archs_are_the_references():
    import repro.configs.registry
    import repro_torch.configs.registry

    assert repro_torch.configs.registry.ASSIGNED == repro.configs.registry.ASSIGNED
    assert repro_torch.configs.registry.list_archs() == repro.configs.registry.list_archs()


@pytest.mark.parametrize("pkg", ["models", "configs"])
def test_models_and_configs_hold_every_reference_module(pkg):
    """The port's ``models/`` and ``configs/`` hold a module for each of the
    reference's; each family module exposes the reference's public
    functions (``init``, ``param_specs``, ``loss`` and, where servable,
    ``prefill``, ``decode_step``, ``init_decode_state``)."""
    import pkgutil

    ref, port = (importlib.import_module(f"{p}.{pkg}") for p in ("repro", "repro_torch"))
    names = {m.name for m in pkgutil.iter_modules(ref.__path__)}
    assert names == {m.name for m in pkgutil.iter_modules(port.__path__)}
    if pkg == "configs":
        return
    from repro.models import registry as jreg
    from repro_torch.models import registry as reg

    assert reg.SERVABLE == jreg.SERVABLE
    for fam, jmod in jreg._FAMILIES.items():
        mod = reg.get_family(fam)
        assert mod.__name__ == jmod.__name__.replace("repro.", "repro_torch.", 1)
        want = {"init", "param_specs", "loss"}
        if fam in jreg.SERVABLE:
            want |= {"prefill", "decode_step", "init_decode_state"}
        assert want <= {n for n in dir(jmod) if callable(getattr(jmod, n))}
        assert all(callable(getattr(mod, n, None)) for n in want), (fam, want)
