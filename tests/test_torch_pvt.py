"""PyTorch port vs the JAX reference: the compensated PVT solve and the
clients' quantize→dequantize(+PVT) view.

``repro_torch.core.pvt.pvt_solve`` adds the f32 sums of 1024-value chunks in
float64 where the reference runs a Neumaier cascade over them in f32; both
round the chunk sums' total to f32.  Tolerances: the sums within 1e-6
relative; ``s`` within rtol=1e-6 and ``b`` within 1e-6 of the largest |v|
on weight-like data (the chunk sums themselves are f32 sums taken in
another order); ``qdq_pvt_leaf`` and ``client_view`` within
rtol=1e-6, atol=1e-7; the value quantization under them bit-exact, and the
PPQ masks that pick the variables equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import omc as jomc
from repro.core import pvt as jpvt
from repro.federated import simulate as jsim
from repro.models import conformer as jcf
from repro_torch import interop
from repro_torch.core import pvt
from repro_torch.core.omc import OMCConfig, effective_params, qdq_pvt_leaf
from repro_torch.core.tree import tree_items
from repro_torch.federated import simulate
from repro_torch.models import conformer as cf

torch.set_num_threads(1)

JCFG = jcf.ConformerConfig(n_layers=2, d_model=32, n_heads=4, d_ff=64, n_classes=16, d_in=8)
CFG = cf.ConformerConfig(**JCFG.__dict__)


def _x(shape, seed, mean=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 0.05 + mean).astype(np.float32)


@pytest.mark.parametrize("shape,mean", [((3, 40, 17), 0.0), ((5000,), 0.0), ((7, 1500), 3.0),
                                        ((2, 64, 1024), -0.5)], ids=str)
def test_compensated_sums_match_reference(shape, mean):
    """The four sums behind the solve, offset data included: within 1e-6
    relative of the reference's head + tail."""
    x = _x(shape, seed=len(shape), mean=mean).reshape(-1)
    for v in (x, x * x):
        want = float(jax.jit(jpvt._csum)(jnp.asarray(v)))
        got = float(pvt._csum(torch.from_numpy(v)))
        assert abs(got - want) <= 1e-6 * abs(want), (got, want)


@pytest.mark.parametrize("shape,mean", [((3, 40, 17), 0.0), ((5000,), 0.0), ((7, 1500), 0.02),
                                        ((2, 64, 1024), -0.01)], ids=str)
@pytest.mark.parametrize("name", ["S1E2M3", "S1E3M7", "S1E4M14"])
def test_pvt_solve_matches_compensated_reference(shape, mean, name):
    """(s, b) on weight-like data.  With |mean| far above the spread the f32
    closed form cancels (n·ΣṼ² ≈ (ΣṼ)²) in the reference as much as here, so
    the offset cases above check the sums instead."""
    x = _x(shape, seed=len(shape), mean=mean)
    from repro.core.formats import value_quantize as jvq

    xq = np.asarray(jvq(jnp.asarray(x), jomc.FloatFormat.parse(name)))
    js, jb = jax.jit(jpvt.pvt_solve)(jnp.asarray(x), jnp.asarray(xq))
    s, b = pvt.pvt_solve(torch.from_numpy(x), torch.from_numpy(xq))
    assert s.shape == () and b.shape == ()
    np.testing.assert_allclose(float(s), float(js), rtol=1e-6)
    assert abs(float(b) - float(jb)) <= 1e-6 * np.abs(x).max()


@pytest.mark.parametrize("pvt_on", [True, False])
@pytest.mark.parametrize("name", ["S1E3M7", "S1E4M14"])
def test_qdq_pvt_leaf_solves_one_affine_for_a_stacked_leaf(pvt_on, name):
    """The view's qdq solves one (s, b) over the whole stacked leaf, as the
    reference does (no batch axes), unlike storage and transport."""
    x = _x((3, 40, 17), seed=11)
    jcfg = jomc.OMCConfig.parse(name, pvt=pvt_on)
    cfg = OMCConfig.parse(name, pvt=pvt_on)
    want = np.asarray(jax.jit(lambda v: jomc.qdq_pvt_leaf(v, jcfg))(jnp.asarray(x)))
    got = qdq_pvt_leaf(torch.from_numpy(x), cfg).numpy()
    if pvt_on:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.fixture(scope="module")
def params():
    jp = jax.jit(lambda k: jcf.init(k, JCFG))(jax.random.PRNGKey(0))
    return jp, interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _leaves(tree):
    return {tuple(k.key for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("fraction", [0.9, 0.5, 1.0])
def test_client_view_matches_reference(params, fraction):
    jp, tp = params
    jcfg = jomc.OMCConfig.parse("S1E3M7", quantize_fraction=fraction)
    cfg = OMCConfig.parse("S1E3M7", quantize_fraction=fraction)
    jspecs, specs = jcf.param_specs(JCFG), cf.param_specs(CFG)
    for r, c in ((0, 0), (1, 5), (3, 11)):
        want = _leaves(jax.jit(lambda p: jsim.client_view(p, jspecs, jcfg, r, c))(jp))
        got = dict(tree_items(simulate.client_view(tp, specs, cfg, r, c)))
        assert sorted(got) == sorted(want)
        changed = 0
        for path, leaf in got.items():
            np.testing.assert_allclose(leaf.numpy(), want[path], rtol=1e-6, atol=1e-7)
            changed += not np.array_equal(leaf.numpy(), _leaves(jp)[path])
        assert changed == (13 if fraction == 1.0 else round(13 * fraction) if fraction < 1 else 0)


def test_effective_params_matches_reference(params):
    jp, tp = params
    jcfg, cfg = jomc.OMCConfig.parse("S1E3M7"), OMCConfig.parse("S1E3M7")
    want = _leaves(jax.jit(lambda p: jomc.effective_params(p, jcfg, 2, 7))(jp))
    for path, leaf in tree_items(effective_params(tp, cfg, 2, 7)):
        np.testing.assert_allclose(leaf.numpy(), want[path], rtol=1e-6, atol=1e-7)
