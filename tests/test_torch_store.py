"""PyTorch port vs the JAX reference: compressing a parameter tree.

The qwen2.5-3b smoke tree is built by the reference (``jax.random``), carried
across as f32 with ``repro_torch.interop``, and compressed by both
``compress_params``.  Codes are bit-exact; (s, b) agree within
tests/test_pvt_fast.py's bounds (rtol=1e-4 on s, atol=1e-5 on b), since the
f32 sums behind them are taken in another order; the byte report is equal.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import qwen2_5_3b as jcfg
from repro.core.omc import OMCConfig as JOMC
from repro.federated import state as jstate
from repro.models import transformer as jtr
from repro_torch import interop
from repro_torch.core.omc import OMCConfig
from repro_torch.core.store import compress_variable, decompress_tree, is_compressed
from repro_torch.core.tree import tree_items
from repro_torch.federated import state
from repro_torch.models import transformer as tr

torch.set_num_threads(1)

FMTS = ["S1E2M3", "S1E3M7", "S1E4M14"]


@pytest.fixture(scope="module")
def jparams():
    return jax.jit(lambda k: jtr.init(k, jcfg.smoke_config()))(jax.random.PRNGKey(0))


@functools.partial(jax.jit, static_argnames="name")
def _jcompress(params, name):
    """One compiled program instead of many small eager ones (same math)."""
    cfg = jcfg.smoke_config()
    return jstate.compress_params(params, jtr.param_specs(cfg), JOMC.parse(name))


def _compress_both(jparams, name):
    cfg = jcfg.smoke_config()
    params = interop.params_from_numpy(jparams, device="cpu")
    storage = state.compress_params(params, tr.param_specs(cfg), OMCConfig.parse(name))
    return _jcompress(jparams, name), storage


@pytest.mark.parametrize("name", FMTS)
def test_compress_params_matches_reference(jparams, name):
    jstorage, storage = _compress_both(jparams, name)
    jleaves = dict(jax.tree_util.tree_flatten_with_path(
        jstorage, is_leaf=lambda x: hasattr(x, "codes"))[0])
    jleaves = {"/".join(k.key for k in path): leaf for path, leaf in jleaves.items()}
    leaves = {"/".join(p): leaf for p, leaf in tree_items(storage)}
    assert sorted(leaves) == sorted(jleaves)
    n_comp = 0
    for path, leaf in leaves.items():
        jleaf = jleaves[path]
        if is_compressed(leaf):
            n_comp += 1
            assert leaf.fmt.name == jleaf.fmt.name
            np.testing.assert_array_equal(leaf.codes.numpy(), np.asarray(jleaf.codes))
            assert leaf.s.shape == np.shape(jleaf.s) and leaf.b.shape == np.shape(jleaf.b)
            np.testing.assert_allclose(leaf.s.numpy(), np.asarray(jleaf.s), rtol=1e-4)
            np.testing.assert_allclose(leaf.b.numpy(), np.asarray(jleaf.b), atol=1e-5)
        else:
            assert not hasattr(jleaf, "codes"), path
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(jleaf))
    assert n_comp == 8  # embed + the 7 stacked block matrices


@pytest.mark.parametrize("name", FMTS)
def test_state_bytes_report_equal(jparams, name):
    jstorage, storage = _compress_both(jparams, name)
    assert state.state_bytes_report(storage) == jstate.state_bytes_report(jstorage)


def test_decompress_tree_matches_reference(jparams):
    """Decoding the carried-over reference storage: same f32 values (the
    affine within the reference's own dequantize tolerance, rtol=1e-6,
    atol=1e-7 from tests/test_kernels.py)."""
    from repro.core.store import decompress_tree as jdecompress

    jstorage, _ = _compress_both(jparams, "S1E3M7")
    storage = interop.storage_from_numpy(jstorage, device="cpu")
    got = dict(tree_items(decompress_tree(storage)))
    want = jax.jit(jdecompress)(jstorage)
    for path, leaf in got.items():
        w = want
        for k in path:
            w = w[k]
        np.testing.assert_allclose(leaf.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_compress_variable_guards():
    from repro_torch.core.pvt import pvt_solve_fast

    x = torch.randn(40, 30)
    fmt = OMCConfig().fmt
    single = compress_variable(x, fmt)  # a single variable: the closed-form solver
    s, b = pvt_solve_fast(x, compress_variable(x, fmt, pvt=False).dequantize())
    # same closed form; the f32 sums are taken in another order (rtol=1e-5)
    assert single.s.shape == () and single.b.shape == ()
    torch.testing.assert_close(single.s, s, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(single.b, b, rtol=1e-5, atol=1e-7)
    cv = compress_variable(x, fmt, pvt=False)
    assert float(cv.s) == 1.0 and float(cv.b) == 0.0 and cv.s.shape == ()
    stacked = compress_variable(torch.randn(3, 40, 30), OMCConfig().fmt, batch_axes=1)
    assert stacked.s.shape == (3, 1, 1)
    assert stacked[1].codes.shape == (40, 30) and stacked[1].s.shape == (1, 1)
    with pytest.raises(IndexError):
        cv[0]


@pytest.mark.parametrize("shape,batch_axes", [((37, 19), 0), ((3, 40, 17), 1), ((2, 3, 130), 2)],
                         ids=["single", "stacked1", "stacked2"])
def test_pvt_solve_fast_matches_reference(shape, batch_axes):
    """(s, b) from the closed form on plain f32 sums: the shapes the reference
    gives back, values within tests/test_pvt_fast.py's bounds."""
    import jax.numpy as jnp

    from repro.core.formats import FloatFormat as JFormat
    from repro.core.formats import value_quantize as jvq
    from repro.core.pvt import pvt_solve_fast as jsolve
    from repro_torch.core.pvt import pvt_solve_fast

    v = np.random.default_rng(len(shape)).standard_normal(shape).astype(np.float32) * 0.1
    vq = np.asarray(jvq(jnp.asarray(v), JFormat.parse("S1E3M7")))
    js, jb = jsolve(jnp.asarray(v), jnp.asarray(vq), batch_axes)
    s, b = pvt_solve_fast(torch.from_numpy(v), torch.from_numpy(vq.copy()), batch_axes)
    assert s.shape == np.shape(js) and b.shape == np.shape(jb)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-4)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), atol=1e-5)
