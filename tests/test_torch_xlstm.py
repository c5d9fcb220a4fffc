"""PyTorch port vs the JAX reference: xlstm-350m (sLSTM + mLSTM blocks).

Both packages serve the same storage tree (the reference's
``compress_params`` output in S1E3M7 on the smoke config: 5 layers, two
super blocks of one mLSTM and one sLSTM block, then one extra mLSTM block;
d 32, 2 heads), carried across with ``repro_torch.interop``, and run the
same f32 params for the loss.  Tolerances as for the zoo
(tests/test_torch_zoo.py): logits within 1e-4 and greedy tokens equal;
loss and gradients within 1e-4; ``prefill(n) + decode`` against
``prefill(n + 1)`` within the reference's 5e-4; init within 4 ulp.  The
chunked mLSTM against the recurrent one: the reference's own
tests/test_xlstm_chunked.py gates (rtol 2e-4, atol 2e-5).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.session import ServeSession as JServeSession
from repro.configs import xlstm_350m as jmod
from repro.core.omc import OMCConfig as JOMC
from repro.federated import state as jstate
from repro.models import common as jcommon
from repro.models import xlstm as jx
from repro_torch import interop
from repro_torch.api.session import ServeSession
from repro_torch.configs import xlstm_350m
from repro_torch.configs.registry import get_arch
from repro_torch.core import prng
from repro_torch.core.store import is_compressed
from repro_torch.core.tree import tree_items, tree_map
from repro_torch.federated.round import make_serve_fns
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, serve
from repro_torch.models import xlstm as xl
from repro_torch.models.common import IDENTITY_MAT
from repro_torch.models.registry import get_family

torch.set_num_threads(1)

B = 2


def _t(x):
    return torch.from_numpy(np.array(x))


def _flat(tree):
    return {tuple(k.key for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tokens(n, seed, vocab=256, batch=B):
    return np.random.default_rng(seed).integers(0, vocab, (batch, n + 1), dtype=np.int32)


@pytest.fixture(scope="module")
def trees():
    jcfg = jmod.smoke_config()
    js = jax.jit(lambda k: jstate.compress_params(
        jx.init(k, jcfg), jx.param_specs(jcfg), JOMC.parse("S1E3M7")))(jax.random.PRNGKey(0))
    return js, interop.storage_from_numpy(js, device="cpu"), JServeSession(jx, jcfg, js)


def test_configs_and_c29_param_count():
    for name in ("config", "smoke_config"):
        jc, c = getattr(jmod, name)(), getattr(xlstm_350m, name)()
        assert dataclasses.asdict(jc) == dataclasses.asdict(c)
        for prop in ("d_inner", "m_head_dim", "s_head_dim", "n_super", "m_per_super",
                     "n_extra_m", "n_slstm"):
            assert getattr(c, prop) == getattr(jc, prop), prop
        assert c.param_count() == jc.param_count()
    assert (xlstm_350m.ID, xlstm_350m.FAMILY, xlstm_350m.LONG_CONTEXT_OK) == \
        (jmod.ID, jmod.FAMILY, jmod.LONG_CONTEXT_OK)
    assert get_arch("xlstm-350m") is xlstm_350m and get_family("xlstm") is xl
    full = xlstm_350m.config()
    assert (full.n_super, full.m_per_super, full.n_extra_m) == (3, 7, 0)
    # C29: the formula counts b_if (2H) as a second d-vector, (d - 2H) an mLSTM block
    held = sum(v.numel() for _, v in tree_items(xl.init(prng.PRNGKey(0), full, "meta")))
    jheld = sum(v.size for v in jax.tree_util.tree_leaves(
        jax.eval_shape(lambda k: jx.init(k, full), jax.random.PRNGKey(0))))
    assert held == jheld == 467_347_624
    assert full.param_count() == 467_368_960 == held + (1024 - 2 * 4) * 21


def test_init_and_storage_match_reference_within_4_ulp(trees):
    jcfg = jmod.smoke_config()
    want = _flat(jax.jit(lambda k: jx.init(k, jcfg))(jax.random.PRNGKey(2)))
    got = {p: v.numpy() for p, v in tree_items(xl.init(prng.PRNGKey(2), jcfg))}
    assert sorted(got) == sorted(want)
    for path, x in got.items():
        assert x.shape == want[path].shape, path
        d = np.abs(x.view(np.int32).astype(np.int64)
                   - want[path].view(np.int32).astype(np.int64))
        assert d.max() <= 4, path
    # the doubly stacked mLSTM leaves carry per-entry (s, b) across
    _, storage, _ = trees
    w_up = storage["super_blocks"]["mlstm"]["w_up"]
    assert tuple(w_up.codes.shape) == (2, 1, 32, 128) and tuple(w_up.s.shape)[:2] == (2, 1)
    assert not is_compressed(storage["super_blocks"]["mlstm"]["b_if"])
    assert tuple(storage["super_blocks"]["slstm"]["r_gates"].s.shape)[0] == 2


def _mlstm_inputs(b=2, s=48, h=3, dk=16, dv=16, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((b, s, h, dk)).astype(f),
            (rng.standard_normal((b, s, h, dk)) / 4).astype(f),
            rng.standard_normal((b, s, h, dv)).astype(f),
            rng.standard_normal((b, s, h)).astype(f),
            (rng.standard_normal((b, s, h)) + 2.0).astype(f))


def _close(a, b, rtol=2e-4, atol=2e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("chunk", [1, 7, 16, 48])
def test_chunked_equals_recurrent_and_the_reference(chunk):
    x = _mlstm_inputs()
    h1, st1 = xl._mlstm_scan(*map(_t, x), None)
    h2, st2 = xl._mlstm_chunked(*map(_t, x), None, chunk=chunk)
    _close(h1, h2)
    for a, c in zip(st1, st2):
        _close(a, c)
    jh, jst = jx._mlstm_chunked(*map(jnp.asarray, x), None, chunk=chunk)
    _close(h2, jh, 1e-5, 1e-5)
    for a, c in zip(st2, jst):
        _close(a, c, 1e-5, 1e-5)
    if chunk == 48:
        jh, jst = jx._mlstm_scan(*map(jnp.asarray, x), None)
        _close(h1, jh, 1e-5, 1e-5)


def test_state_carries_across_chunked_and_recurrent():
    x = _mlstm_inputs(s=64)
    head, tail = ([_t(a[:, :40]) for a in x], [_t(a[:, 40:]) for a in x])
    _, st_a = xl._mlstm_scan(*head, None)
    _, st_b = xl._mlstm_chunked(*head, None, chunk=8)
    ha, _ = xl._mlstm_scan(*tail, st_a)
    hb, _ = xl._mlstm_chunked(*tail, st_b, chunk=8)
    _close(ha, hb)
    jh, _ = jx._mlstm_chunked(*[jnp.asarray(a[:, 40:]) for a in x],
                              jx._mlstm_chunked(*[jnp.asarray(a[:, :40]) for a in x], None,
                                                chunk=8)[1], chunk=8)
    _close(hb, jh, 1e-5, 1e-5)


def _loss_and_grads(jcfg, batch, seed=1):
    jparams = jax.jit(lambda k: jx.init(k, jcfg))(jax.random.PRNGKey(seed))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jx.loss(jcfg, p, jb, jcommon.Materializer())))(jparams)
    params = tree_map(lambda a: a.requires_grad_(True),
                      interop.params_from_numpy(jparams, device="cpu"))
    tb = {k: _t(v).long() for k, v in batch.items()}
    loss = xl.loss(jcfg, params, tb, IDENTITY_MAT)
    grads = torch.autograd.grad(loss, [v for _, v in tree_items(params)])
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4, atol=1e-4)
    want = _flat(jgrads)
    for (path, _), g in zip(tree_items(params), grads):
        np.testing.assert_allclose(g.numpy(), want[path], rtol=1e-4, atol=1e-4,
                                   err_msg=str(path))
    return params, tb, loss.item()


def test_loss_and_gradients_match_reference_and_the_recurrent_form():
    """The smoke config over 12 tokens (one chunk); the chunked loss equals
    the recurrent form's (the reference's test_full_model_forward_equivalence),
    also at chunk 4 over 13 tokens, which runs at chunk 1 (13 is prime)."""
    t = _tokens(12, seed=3)
    jcfg = jmod.smoke_config()
    params, tb, loss = _loss_and_grads(jcfg, dict(tokens=t[:, :-1], labels=t[:, 1:]))
    rec = dataclasses.replace(jcfg, mlstm_impl="recurrent")
    np.testing.assert_allclose(xl.loss(rec, params, tb, IDENTITY_MAT).item(), loss, rtol=1e-4)
    t = _t(_tokens(13, seed=4)).long()
    tb = dict(tokens=t[:, :-1], labels=t[:, 1:])
    with torch.no_grad():
        chunked = xl.loss(dataclasses.replace(jcfg, mlstm_chunk=4), params, tb, IDENTITY_MAT)
        np.testing.assert_allclose(chunked.item(), xl.loss(rec, params, tb, IDENTITY_MAT).item(),
                                   rtol=1e-4)


def test_prefill_and_decode_logits_and_state_match_reference(trees):
    jstorage, storage, jsess = trees
    cfg = xlstm_350m.smoke_config()
    prefill, decode = make_serve_fns(xl, cfg)
    toks = _tokens(9, seed=1)[:, :-1]
    jc, jlogits = jsess.prefill(dict(tokens=jnp.asarray(toks)), jsess.init_cache(B, 32))
    c = xl.init_decode_state(cfg, B, 32, device="cpu")
    ops.reset_launch_counts()
    c, logits = prefill(storage, dict(tokens=_t(toks).long()), c)
    # 3 mLSTM blocks x 6 + 2 sLSTM blocks x 2 matrices; 3 conv_w, 2 r_gates,
    # the embedding rows and the tied head decoded
    assert ops.launch_counts() == {"dequant_matmul.ref": 22, "dequantize.ref": 7}
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    for _ in range(4):
        tok = np.asarray(jnp.argmax(jlogits[:, -1], axis=-1))[:, None].astype(np.int32)
        jc, jlogits = jsess.decode_step(jc, jnp.asarray(tok))
        c, logits = decode(storage, c, _t(tok).long())
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    assert c["length"] == int(jc["length"]) == 13
    for part in ("mlstm", "slstm", "extra_m"):
        for key, v in c[part].items():
            np.testing.assert_allclose(v.numpy(), np.asarray(jc[part][key]), rtol=1e-4,
                                       atol=1e-4, err_msg=f"{part}/{key}")


def test_generate_greedy_tokens_match_reference(trees):
    _, storage, jsess = trees
    toks = _tokens(8, seed=2)[:, :-1]
    _, jgen = jsess.generate(dict(tokens=jnp.asarray(toks)), jsess.init_cache(B, 32), 6)
    sess = ServeSession(xl, xlstm_350m.smoke_config(), storage)
    _, gen = sess.generate(dict(tokens=_t(toks).long()), sess.init_cache(B, 32), 6)
    np.testing.assert_array_equal(gen.numpy(), np.asarray(jgen))


@pytest.mark.parametrize("s", [7, 16])
def test_prefill_then_decode_equals_longer_prefill(trees, s):
    """Prefill runs the chunked form (16 tokens: one chunk; 17 tokens, prime:
    chunk 1 at ``mlstm_chunk=4``), decode the recurrent one."""
    _, storage, _ = trees
    cfg = dataclasses.replace(xlstm_350m.smoke_config(), mlstm_chunk=4)
    prefill, decode = make_serve_fns(xl, cfg)
    toks = _t(_tokens(s + 1, seed=s)[:, :-1]).long()
    st0 = xl.init_decode_state(cfg, B, 64, device="cpu")
    _, la = prefill(storage, dict(tokens=toks), st0)
    st, _ = prefill(storage, dict(tokens=toks[:, :s]), st0)
    _, lb = decode(storage, st, toks[:, s:s + 1])
    assert torch.isfinite(lb).all()
    np.testing.assert_allclose(la.numpy(), lb.numpy(), rtol=5e-4, atol=5e-4)


def test_serve_cli_on_cpu_with_wire_roundtrip(capsys):
    serve.main(["--arch", "xlstm-350m", "--smoke", "--device", "cpu", "--wire-roundtrip",
                "--batch", "2", "--prompt-len", "8", "--gen", "4", "--quiet"])
    out = capsys.readouterr().out
    assert '"swap_bit_identical": true' in out
    assert '"arch": "xlstm-350m"' in out and '"n_layers": 5' in out


def test_dryrun_cells_at_a_small_size(tmp_path):
    """``prefill_32k`` and ``train_4k`` at 16 tokens and 2 layers: the host
    loops walk every token, so the meta trace counts each step (C25)."""
    out = dryrun.run_cell("xlstm-350m", "decode_32k", out_dir=str(tmp_path))
    assert out["kernel_calls"] == {"dequant_matmul": 132, "dequantize": 26}
    small = {"n_layers": "2", "slstm_every": "2"}
    cell = dryrun.build_cell("xlstm-350m", "prefill_32k", overrides=small)
    assert tuple(cell.inputs["batch"]["tokens"].shape) == (32, 32_768)
    from repro_torch.configs.shapes import Shape

    for kind in ("prefill", "train"):
        shape = Shape(f"{kind}_16", kind, 16, 2)
        cell = dryrun.build_cell("xlstm-350m", shape, overrides=small)
        counter = dryrun.trace_cell(cell)
        assert counter.flops > 0 and counter.bytes > 0
        calls = {k[len("kernel."):]: v for k, v in counter.ops.items() if k.startswith("kernel.")}
        assert calls["dequantize"] >= 3
    assert math.isfinite(out["roofline"]["memory_s"])
