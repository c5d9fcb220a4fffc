"""PyTorch port vs the JAX reference: the error-feedback residuals
(``repro_torch.compress.feedback``) and the upload rule built on them
(``simulate.strategy_upload``).

Fixed numpy inputs go through both packages.  Gates: ``sent + e' == comp``
bit for bit for f32 top-k (each coordinate goes one way), within one
rounding of the subtraction otherwise; the port's ``sent`` and residual
equal the reference's bit for bit for top-k and the pipeline, and within
the ternary scale's gate (ROADMAP C18) for ternary, on normal inputs.
Subnormal inputs are in their own cases (ROADMAP C1): the port keeps them,
where XLA on the CPU flushes them, so the reference's EF subtraction loses
them and the port's does not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compress import feedback as jfeedback
from repro.compress import get_strategy as jget
from repro.core.omc import OMCConfig as JOMC
from repro.federated import simulate as jsimulate
from repro.models import conformer as jcf
from repro_torch import interop
from repro_torch.compress import feedback, get_strategy
from repro_torch.core.omc import OMCConfig
from repro_torch.federated import simulate
from repro_torch.models import conformer as cf

torch.set_num_threads(1)

OMC, JOMC_ = OMCConfig.parse("S1E3M7"), JOMC.parse("S1E3M7")
JCFG = jcf.ConformerConfig(n_layers=1, d_model=16, n_heads=2, d_ff=32, n_classes=8, d_in=4)
CFG = cf.ConformerConfig(**JCFG.__dict__)
SPARSE = [("topk", dict(density=0.25)), ("topk", dict(density=0.5)), ("ternary", {}),
          ("pipeline", {})]
SPARSE_IDS = ["topk-0.25", "topk-0.5", "ternary", "pipeline"]


def _vec(seed, n=96, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(n) * scale).astype(np.float32)


def _assert_close(name, got, want):
    if name == "ternary":  # the scale's f32 mean (C18)
        np.testing.assert_allclose(got, want, rtol=4e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def params():
    jp = jax.jit(lambda k: jcf.init(k, JCFG))(jax.random.PRNGKey(0))
    return interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu"), jp


def test_takes_residual_matches_reference():
    off, joff = (OMCConfig.parse("S1E8M23", quantize_fraction=1.0),
                 JOMC.parse("S1E8M23", quantize_fraction=1.0))
    for name, kw in [("topk", {}), ("ternary", {}), ("pipeline", {}), ("omc", {}),
                     ("topk", dict(error_feedback=False)), ("ternary", dict(error_feedback=False))]:
        for o, jo in ((OMC, JOMC_), (off, joff)):
            assert (feedback.takes_residual(o, get_strategy(name, **kw))
                    == jfeedback.takes_residual(jo, jget(name, **kw))), (name, kw)
    assert not feedback.takes_residual(OMC, None)


def test_init_gather_scatter_bytes_and_norms_match_reference(params):
    p, jp = params
    ef = feedback.init_ef_state(p, cf.param_specs(CFG), OMC, num_clients=5)
    jef = jfeedback.init_ef_state(jp, jcf.param_specs(JCFG), JOMC_, num_clients=5)
    assert list(ef) == list(jef)
    for k in ef:
        assert tuple(ef[k].shape) == jef[k].shape and ef[k].dtype == torch.float32
        assert not ef[k].any()
    assert feedback.ef_bytes(ef) == jfeedback.ef_bytes(jef) > 0
    assert feedback.total_norm(ef) == 0.0 and feedback.ef_bytes(None) == 0
    rows = {k: v + torch.from_numpy(_vec(i, v[0].numel() * 2).reshape(v.shape))
            for i, (k, v) in enumerate(feedback.gather_rows(ef, [3, 1]).items())}
    ef2 = feedback.scatter_rows(ef, [3, 1], rows)
    jef2 = jfeedback.scatter_rows(jef, jnp.asarray([3, 1]),
                                  {k: jnp.asarray(v.numpy()) for k, v in rows.items()})
    assert not any(v.any() for v in ef.values())  # functional, as the reference's
    for k in ef2:
        np.testing.assert_array_equal(ef2[k].numpy(), np.asarray(jef2[k]))
        assert not ef2[k][[0, 2, 4]].any()
    norms, jnorms = feedback.ef_norms(ef2), jfeedback.ef_norms(jef2)
    assert set(norms) == set(jnorms)
    for k in norms:
        assert norms[k] == pytest.approx(jnorms[k], rel=1e-6)
    assert feedback.total_norm(ef2) == pytest.approx(jfeedback.total_norm(jef2), rel=1e-6)


@pytest.mark.parametrize("name,kw", SPARSE, ids=SPARSE_IDS)
@pytest.mark.parametrize("mask_bit", [True, False])
@pytest.mark.parametrize("ste", [False, True])
def test_compensate_leaf_matches_reference(name, kw, mask_bit, ste):
    delta, residual = _vec(1, 128, 0.01), _vec(2, 128, 0.003)
    sent, new_r = feedback.compensate_leaf(get_strategy(name, **kw), torch.from_numpy(delta),
                                           torch.from_numpy(residual), mask_bit, ste=ste)
    jsent, jnew_r = jfeedback.compensate_leaf(jget(name, **kw), jnp.asarray(delta),
                                              jnp.asarray(residual), jnp.asarray(mask_bit),
                                              ste=ste)
    _assert_close(name, sent.numpy(), np.asarray(jsent))
    _assert_close(name, new_r.numpy(), np.asarray(jnew_r))
    comp = delta + residual
    if not mask_bit:  # the variable travels f32: all of it, residual drained
        np.testing.assert_array_equal(sent.numpy(), comp)
        assert not new_r.any()
    elif name == "topk" and not ste:  # each coordinate goes one way, exactly
        np.testing.assert_array_equal(sent.numpy() + new_r.numpy(), comp)
        assert not (sent * new_r).any()
    else:  # one rounding of the subtraction
        np.testing.assert_allclose(sent.numpy() + new_r.numpy(), comp, rtol=0,
                                   atol=float(np.spacing(np.abs(comp).max())))


def test_residual_telescopes_and_stays_bounded():
    """Over several sends sum(sent) + e == sum(delta), and dropping the
    smallest coordinates never grows the vector."""
    s = get_strategy("topk", density=0.25)
    residual = torch.zeros(24)
    total_delta, total_sent = torch.zeros(24), torch.zeros(24)
    for r in range(5):
        delta = torch.from_numpy(_vec(10 + r, 24))
        comp = delta + residual
        sent, residual = feedback.compensate_leaf(s, delta, residual, True)
        assert residual.norm() <= comp.norm()
        total_delta, total_sent = total_delta + delta, total_sent + sent
    np.testing.assert_allclose((total_sent + residual).numpy(), total_delta.numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,kw", SPARSE, ids=SPARSE_IDS)
def test_strategy_upload_matches_reference(params, name, kw):
    """The whole upload rule of one client (PPQ mask, stacked axes,
    compensate, ``received + sent``) from the same inputs."""
    p, jp = params
    specs, jspecs = cf.param_specs(CFG), jcf.param_specs(JCFG)
    rng = np.random.default_rng(7)
    trained = {k: v + torch.from_numpy(
        (rng.standard_normal(tuple(v.shape)) * 0.01).astype(np.float32))
        for k, v in _flat_items(p)}
    trained = _unflat(trained)
    ef = feedback.init_ef_state(p, specs, OMC, 4)
    resid = {k: torch.from_numpy((rng.standard_normal(tuple(v.shape[1:])) * 0.002)
                                 .astype(np.float32)) for k, v in ef.items()}
    out, new_r = simulate.strategy_upload(trained, p, resid, specs, OMC,
                                          get_strategy(name, **kw), 1, 2)
    jout, jnew_r = jsimulate.strategy_upload(
        jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), trained,
                               is_leaf=lambda t: isinstance(t, torch.Tensor)),
        jp, {k: jnp.asarray(v.numpy()) for k, v in resid.items()}, jspecs, JOMC_,
        jget(name, **kw), jnp.int32(1), jnp.int32(2))
    assert set(new_r) == set(jnew_r)
    for k in new_r:
        _assert_close(name, new_r[k].numpy(), np.asarray(jnew_r[k]))
    jflat = {"/".join(x.key for x in path): np.asarray(v)
             for path, v in jax.tree_util.tree_flatten_with_path(jout)[0]}
    for k, v in _flat_items(out):
        _assert_close(name, v.numpy(), jflat[k])
    # without a residual: the raw update compressed, the residual passed on
    out2, same = simulate.strategy_upload(trained, p, None, specs, OMC,
                                          get_strategy(name, **kw), 1, 2)
    assert same == {}


def _flat_items(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat_items(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _unflat(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


SUBNORMALS = np.asarray([0.0, 1.4e-45, -3.0e-39, 2.0, -1.0e-40, 0.5, 1.1754942e-38, -0.25],
                        np.float32)


@pytest.mark.parametrize("denom", [1, 2, 4])
def test_subnormal_topk_reconstruction_is_exact_in_the_port(denom):
    """C1's case, the one the reference's property test trips on: f32 top-k
    splits a vector holding subnormals into sent + e' == comp bit for bit in
    the port; XLA on the CPU flushes the subnormals of the reference's."""
    comp = torch.from_numpy(SUBNORMALS.copy())
    sent, new_r = feedback.compensate_leaf(get_strategy("topk", density=1.0 / denom), comp,
                                           torch.zeros_like(comp), True)
    np.testing.assert_array_equal((sent + new_r).numpy(), SUBNORMALS)
    assert not (sent * new_r).any()
    jsent, jnew_r = jfeedback.compensate_leaf(jget("topk", density=1.0 / denom),
                                              jnp.asarray(SUBNORMALS),
                                              jnp.zeros(8, jnp.float32), jnp.asarray(True))
    jsum = np.asarray(jsent) + np.asarray(jnew_r)
    normal = np.abs(SUBNORMALS) >= np.finfo(np.float32).tiny
    # the two agree on every normal entry; the difference is confined to subnormals
    np.testing.assert_array_equal(jsum[normal], SUBNORMALS[normal])
    assert np.all(np.abs(jsum[~normal] - SUBNORMALS[~normal]) < np.finfo(np.float32).tiny)


def test_dense_strategy_residual_is_rounding_only():
    """OMC through compensate_leaf leaves only its quantization error behind
    (the training paths never allocate it a residual)."""
    delta = torch.from_numpy(_vec(3, 32))
    sent, new_r = feedback.compensate_leaf(get_strategy("omc"), delta, torch.zeros_like(delta),
                                           True)
    np.testing.assert_allclose((sent + new_r).numpy(), delta.numpy(), rtol=0, atol=1e-6)
    assert new_r.abs().max() <= 0.02 * delta.abs().max()
