"""PyTorch port vs the JAX reference: the conformer's loss and gradients.

Parameters come from the reference's init (``jax.random``), carried across as
numpy with ``repro_torch.interop``; batches are numpy draws from a seed.
The port's backward is autograd's.  Tolerances (f32, different reduction
orders): loss within rtol=1e-5; every gradient leaf within 1e-5 of its
largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import conformer as jcf
from repro.models.common import IDENTITY_MAT as JIDENTITY
from repro.models.common import group_norm as jgroup_norm
from repro.models.common import layer_norm as jlayer_norm
from repro.models.common import softmax_xent_chunked as jxent
from repro_torch import interop
from repro_torch.core.tree import tree_items
from repro_torch.models import common, conformer as cf
from repro_torch.models.common import IDENTITY_MAT

torch.set_num_threads(1)

BASE = dict(n_layers=2, d_model=32, n_heads=4, d_ff=64, n_classes=16, d_in=8)


def _batch(seed, b=3, s=24, d_in=8, classes=16):
    rng = np.random.default_rng(seed)
    return dict(frames=rng.standard_normal((b, s, d_in)).astype(np.float32),
                labels=rng.integers(0, classes, (b, s)).astype(np.int32))


@pytest.mark.parametrize("window,causal_conv", [(None, True), (8, True), (8, False)],
                         ids=["full", "window8", "window8-centered-conv"])
def test_loss_and_gradients_match_reference(window, causal_conv):
    jcfg = jcf.ConformerConfig(**BASE, window=window, causal_conv=causal_conv)
    cfg = cf.ConformerConfig(**BASE, window=window, causal_conv=causal_conv)
    jp = jax.jit(lambda k: jcf.init(k, jcfg))(jax.random.PRNGKey(1))
    batch = _batch(seed=2)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jcf.loss(jcfg, p, b, JIDENTITY)))(jp, {k: jnp.asarray(v)
                                                             for k, v in batch.items()})
    tp = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    leaves = {path: leaf.requires_grad_(True) for path, leaf in tree_items(tp)}
    loss = cf.loss(cfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()}, IDENTITY_MAT)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    want = {tuple(k.key for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jg)[0]}
    assert sorted(want) == sorted(leaves)
    for path, g in zip(leaves, grads):
        scale = np.abs(want[path]).max()
        np.testing.assert_allclose(g.numpy(), want[path], rtol=0, atol=1e-5 * scale,
                                   err_msg=str(path))


def test_param_tree_matches_reference():
    jcfg, cfg = jcf.ConformerConfig(**BASE), cf.ConformerConfig(**BASE)
    jp = jax.eval_shape(lambda k: jcf.init(k, jcfg), jax.random.PRNGKey(0))
    tp = cf.init(torch.Generator().manual_seed(0), cfg)
    want = {tuple(k.key for k in p): v.shape for p, v in
            jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert {p: tuple(v.shape) for p, v in tree_items(tp)} == want
    assert cfg.param_count() == jcfg.param_count()  # the reference's estimate, kept as is


def test_full_conformer_s_size():
    """conformer_s at full width: 103,535,104 parameters, 13 of its leaves
    (103,342,080 values) selected for compression by the default policy."""
    from repro_torch.configs import conformer_s
    from repro_torch.core.omc import OMCConfig
    from repro_torch.federated import accounting

    cfg = conformer_s.config()
    tp = cf.init(torch.Generator().manual_seed(0), cfg)
    assert sum(v.numel() for _, v in tree_items(tp)) == 103_535_104
    table = accounting.build_wire_table(tp, cf.param_specs(cfg), OMCConfig())
    assert table.num_vars == 13 and sum(table.n_elems) == 103_342_080


@pytest.mark.parametrize("groups", [1, 4])
def test_norms_and_chunked_xent_match_reference(groups):
    rng = np.random.default_rng(groups)
    x = rng.standard_normal((2, 10, 16)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(16).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    t = [torch.from_numpy(a) for a in (x, scale, bias)]
    np.testing.assert_allclose(common.layer_norm(*t).numpy(),
                               np.asarray(jlayer_norm(x, scale, bias)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(common.group_norm(*t, groups).numpy(),
                               np.asarray(jgroup_norm(x, scale, bias, groups)),
                               rtol=1e-5, atol=1e-5)
    head = rng.standard_normal((16, 12)).astype(np.float32)
    labels = rng.integers(0, 12, (2, 10)).astype(np.int32)
    mask = (rng.random((2, 10)) > 0.3).astype(np.float32)
    for chunk in (1024, 4, 3):  # 4 and 3 shrink to 2 and 2 on a sequence of 10
        got = common.softmax_xent_chunked(t[0], torch.from_numpy(head), torch.from_numpy(labels),
                                          torch.from_numpy(mask), chunk=chunk)
        want = jxent(jnp.asarray(x), jnp.asarray(head), jnp.asarray(labels), jnp.asarray(mask),
                     chunk=chunk)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
