"""PyTorch port vs the JAX reference: the engine's compressed-domain server
round (``fused_agg=True``) and its gating.

The same training as tests/test_torch_engine.py, with each compressed leaf's
client stack transport-encoded and aggregated by ``fused_aggregate`` (13
launches a round; the plain version here on the CPU, the reference's
``ref_fused_aggregate`` on its side).  Gates, those of tests/test_engine.py:
ledgers equal, losses within 1e-3, trees within max |d| 6e-3 and mean |d|
1e-3 per leaf.  ``transport_encode_stacked``: codes bit-exact, (s, b) within
rtol=1e-4 / atol=1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.formats import FloatFormat as JFormat
from repro.core.omc import OMCConfig as JOMC
from repro.core.store import decompress_tree as jdecompress
from repro.federated import engine as jengine
from repro.federated.cohort import CohortPlan as JPlan
from repro.models import conformer as jcf
from repro_torch.core import prng
from repro_torch.core.formats import FloatFormat
from repro_torch.core.omc import OMCConfig
from repro_torch.federated import engine, simulate
from repro_torch.federated.cohort import CohortPlan
from repro_torch.kernels import ops
from repro_torch.models import conformer as cf

from test_torch_engine import (CFG, JCFG, ROUNDS, _decoded, _leaves, assert_same_training,
                               data, init, jdata, jsim, sim, torch_params)  # noqa: F401

torch.set_num_threads(1)


def test_fused_engine_matches_reference_fused_engine(init):  # noqa: F811
    jstorage, jhist = jengine.run_training_vectorized(
        jcf, JCFG, JOMC.parse("S1E3M7"), jsim(),
        jengine.CohortSpec(JPlan(16, 8, failure_rate=0.25)), jdata, jax.random.PRNGKey(0),
        num_rounds=ROUNDS, eval_every=100, init_params=init[0],
        fused_agg=True)
    ops.reset_launch_counts()
    storage, hist = engine.run_training_vectorized(
        cf, CFG, OMCConfig.parse("S1E3M7"), sim(),
        engine.CohortSpec(CohortPlan(16, 8, failure_rate=0.25)), data, prng.PRNGKey(0),
        num_rounds=ROUNDS, eval_every=100, init_params=torch_params(init),
        fused_agg=True)
    assert ops.launch_counts()["fused_aggregate.ref"] == 13 * ROUNDS
    assert_same_training(hist, jhist, _decoded(storage), _leaves(jdecompress(jstorage)))


@pytest.mark.parametrize("pvt", [True, False])
@pytest.mark.parametrize("name", ["S1E2M3", "S1E3M7", "S1E4M14"])
@pytest.mark.parametrize("shape,batch_axes", [((8, 37, 19), 0), ((8, 3, 40, 17), 1),
                                              ((8, 2, 3, 13), 2)], ids=str)
def test_transport_encode_stacked_matches_reference(shape, batch_axes, name, pvt):
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    x[3] = np.nan  # a dead client's garbage row
    codes, s, b = engine.transport_encode_stacked(torch.from_numpy(x), FloatFormat.parse(name),
                                                  pvt, batch_axes)
    jcodes, js, jb = jengine.transport_encode_stacked(jnp.asarray(x), JFormat.parse(name), pvt,
                                                      batch_axes)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    assert s.shape == js.shape and b.shape == jb.shape
    alive = np.arange(shape[0]) != 3
    np.testing.assert_allclose(s.numpy()[alive], np.asarray(js)[alive], rtol=1e-4)
    np.testing.assert_allclose(b.numpy()[alive], np.asarray(jb)[alive], atol=1e-5)


def test_fused_gating_matches_reference():
    """``fused_aggregation_supported`` picks the path as the reference does;
    an unsupported configuration refuses loudly instead of falling back."""
    omc, jomc = OMCConfig.parse("S1E3M7"), JOMC.parse("S1E3M7")
    spec, jspec = engine.CohortSpec(CohortPlan(16, 8)), jengine.CohortSpec(JPlan(16, 8))
    tiers = ("s1e3m7", "f32")
    hetero = engine.CohortSpec(CohortPlan(16, 8), tiers=tuple(engine.profile(t) for t in tiers))
    jhetero = jengine.CohortSpec(JPlan(16, 8), tiers=tuple(jengine.profile(t) for t in tiers))
    f32, jf32 = engine.profile("f32").resolve(omc), jengine.profile("f32").resolve(jomc)
    for (s, o), (js, jo) in (((spec, omc), (jspec, jomc)), ((hetero, omc), (jhetero, jomc)),
                             ((spec, f32), (jspec, jf32))):
        assert (engine.fused_aggregation_supported(s, o)
                == jengine.fused_aggregation_supported(js, jo))
    assert not engine.fused_aggregation_supported(spec, omc, strategy=object())
    with pytest.raises(ValueError, match="homogeneous"):
        engine.run_training_vectorized(cf, CFG, omc, simulate.SimConfig(), hetero, data,
                                       prng.PRNGKey(0), num_rounds=1, fused_agg=True,
                                       device="cpu")


@pytest.mark.parametrize("kw", [dict(strategy=object()), dict(ste=True), dict(ef={}),
                                dict(obs=object())], ids=["strategy", "ste", "ef", "obs"])
def test_later_slices_raise_naming_the_roadmap(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        engine.run_training_vectorized(cf, CFG, OMCConfig.parse("S1E3M7"), simulate.SimConfig(),
                                       engine.CohortSpec(CohortPlan(16, 8)), data,
                                       prng.PRNGKey(0), num_rounds=1, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        simulate.run_training(cf, CFG, OMCConfig.parse("S1E3M7"), simulate.SimConfig(),
                              CohortPlan(16, 8), data, prng.PRNGKey(0), num_rounds=1,
                              device="cpu", **kw)


def test_cohort_spec_validation_matches_reference():
    for kw in (dict(tiers=(engine.profile("f32"),), quotas=(3, 5)), dict(quotas=(8,)),
               dict(client_chunk=3)):
        jkw = {k: (tuple(jengine.profile(p.name) for p in v) if k == "tiers" else v)
               for k, v in kw.items()}
        with pytest.raises(ValueError):
            jengine.CohortSpec(JPlan(16, 8), **jkw)
        with pytest.raises(ValueError):
            engine.CohortSpec(CohortPlan(16, 8), **kw)
    assert engine.CohortSpec(CohortPlan(16, 8), client_chunk=4).group_sizes == (8,)
    with pytest.raises(KeyError):
        engine.profile("s1e9m9")


def test_training_without_a_card_raises_instead_of_using_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (lambda: engine.run_training_vectorized(
                    cf, CFG, OMCConfig.parse("S1E3M7"), simulate.SimConfig(),
                    engine.CohortSpec(CohortPlan(16, 8)), data, prng.PRNGKey(0), num_rounds=1),
                lambda: simulate.run_training(
                    cf, CFG, OMCConfig.parse("S1E3M7"), simulate.SimConfig(), CohortPlan(16, 8),
                    data, prng.PRNGKey(0), num_rounds=1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run()
