"""PyTorch port vs the JAX reference: serving griffin (recurrentgemma-2b).

Both packages serve the same storage tree — the reference's
``compress_params`` output on the recurrentgemma-2b smoke config (5 layers:
one super block of two recurrent blocks and one attention block, then two
extra recurrent blocks; d 40, window 16), carried across with
``repro_torch.interop`` — through their ``make_serve_fns`` and
``ServeSession``.  On the CPU the port's block matrices go through the
plain version of ``dequant_matmul``, which decodes and multiplies as the
reference's serve path does.

Tolerances: logits within rtol = atol = 1e-4, as for the dense transformer
(tests/test_torch_serve.py): the decoded weights agree up to the affine's
fused-vs-unfused rounding, f32 sums are taken in another order, and the
RG-LRU runs a Hillis-Steele scan where the reference runs
``lax.associative_scan`` (the measured maximum difference here is below
1e-6).  The RG-LRU and the causal conv alone: within 1e-5.  Greedy tokens
equal; ``prefill(n) + decode`` against ``prefill(n + 1)`` within the
reference's own 5e-4 (tests/test_models_smoke.py).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.session import ServeSession as JServeSession
from repro.configs import recurrentgemma_2b as jcfg
from repro.core.omc import OMCConfig as JOMC
from repro.federated import state as jstate
from repro.federated.round import make_serve_fns as jmake_serve_fns
from repro.models import griffin as jgr
from repro_torch import interop
from repro_torch.api.session import ServeSession
from repro_torch.configs import recurrentgemma_2b
from repro_torch.core.omc import OMCConfig
from repro_torch.core.store import is_compressed
from repro_torch.core.tree import tree_items
from repro_torch.federated.round import make_serve_fns
from repro_torch.federated.state import compress_params
from repro_torch.kernels import ops
from repro_torch.models import griffin as gr

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
B, MAX_LEN = 2, 32  # 16 ring slots: min(MAX_LEN, window)


@pytest.fixture(scope="module")
def trees():
    cfg = jcfg.smoke_config()
    jstorage = jax.jit(lambda k: jstate.compress_params(
        jgr.init(k, cfg), jgr.param_specs(cfg), JOMC.parse("S1E3M7")))(jax.random.PRNGKey(0))
    return jstorage, interop.storage_from_numpy(jstorage, device="cpu")


def _tokens(n, seed):
    return np.random.default_rng(seed).integers(0, jcfg.smoke_config().vocab, (B, n),
                                                dtype=np.int32)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_configs_and_trees_match_reference(trees):
    for name in ("config", "smoke_config"):
        jc, c = getattr(jcfg, name)(), getattr(recurrentgemma_2b, name)()
        assert dataclasses.asdict(jc) == dataclasses.asdict(c)
        for prop in ("lru", "hd", "n_super", "rec_per_super", "n_extra_rec"):
            assert getattr(jc, prop) == getattr(c, prop)
        assert jc.param_count() == c.param_count()
    full = recurrentgemma_2b.config()
    assert (full.n_super, full.rec_per_super, full.n_extra_rec) == (8, 2, 2)
    # the port's init: the reference's tree and shapes, the constant Λ; its
    # storage: the same leaves compressed, with the same (s, b) shapes
    cfg = recurrentgemma_2b.smoke_config()
    params = gr.init(torch.Generator().manual_seed(0), cfg)
    jshapes = jax.eval_shape(lambda k: jgr.init(k, jcfg.smoke_config()), jax.random.PRNGKey(0))
    assert {p: tuple(v.shape) for p, v in tree_items(params)} == {
        tuple(k.key for k in p): tuple(v.shape)
        for p, v in jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    _, ref_storage = trees
    np.testing.assert_array_equal(params["extra_rec"]["lam"].numpy(),
                                  ref_storage["extra_rec"]["lam"].numpy())
    storage = compress_params(params, gr.param_specs(cfg), OMCConfig.parse("S1E3M7"))

    def compressed(tree):
        return {p: (tuple(v.codes.shape), tuple(v.s.shape)) for p, v in tree_items(tree)
                if is_compressed(v)}

    port = compressed(storage)
    assert port == compressed(ref_storage)
    assert port[("super_blocks", "rec", "w_x")][1] == (1, 2, 1, 1)
    assert ("super_blocks", "rec", "conv_w") in port and ("extra_rec", "lam") not in port


def test_rg_lru_and_causal_conv_with_carries_match_reference():
    rng = np.random.default_rng(0)
    b, s, r = 2, 7, 12
    x = rng.standard_normal((b, s, r)).astype(np.float32)
    w = dict(w_rg=rng.standard_normal((r, r)).astype(np.float32) * 0.3,
             w_ig=rng.standard_normal((r, r)).astype(np.float32) * 0.3,
             b_rg=rng.standard_normal(r).astype(np.float32) * 0.1,
             b_ig=rng.standard_normal(r).astype(np.float32) * 0.1,
             lam=rng.standard_normal(r).astype(np.float32) - 4.0)
    h0 = rng.standard_normal((b, r)).astype(np.float32)
    for carried in (None, h0):
        y, h_last = gr._rg_lru(_t(x), {k: _t(v) for k, v in w.items()},
                               None if carried is None else _t(carried))
        jy, jh = jgr._rg_lru(jnp.asarray(x), {k: jnp.asarray(v) for k, v in w.items()},
                             None if carried is None else jnp.asarray(carried))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(h_last.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)
    conv_w = rng.standard_normal((4, r)).astype(np.float32)
    carry = rng.standard_normal((b, 3, r)).astype(np.float32)
    for c in (None, carry):
        y, nc = gr._causal_conv(_t(x), _t(conv_w), None if c is None else _t(c))
        jy, jnc = jgr._causal_conv(jnp.asarray(x), jnp.asarray(conv_w),
                                   None if c is None else jnp.asarray(c))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(nc.numpy(), np.asarray(jnc))
    # decode: one step from the carried state
    y1, h1 = gr._rg_lru(_t(x[:, :1]), {k: _t(v) for k, v in w.items()}, _t(h0))
    jy1, jh1 = jgr._rg_lru(jnp.asarray(x[:, :1]), {k: jnp.asarray(v) for k, v in w.items()},
                           jnp.asarray(h0))
    np.testing.assert_allclose(y1.numpy(), np.asarray(jy1), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h1.numpy(), np.asarray(jh1), rtol=1e-5, atol=1e-5)


def test_prefill_and_decode_logits_and_state_match_reference(trees):
    jstorage, storage = trees
    jc, cfg = jcfg.smoke_config(), recurrentgemma_2b.smoke_config()
    jprefill, jdecode = (jax.jit(f) for f in jmake_serve_fns(jgr, jc))
    prefill, decode = make_serve_fns(gr, cfg)
    toks = _tokens(12, seed=1)
    jst = jgr.init_decode_state(jc, B, MAX_LEN, dtype=jnp.float32)
    st = gr.init_decode_state(cfg, B, MAX_LEN, dtype=torch.float32, device="cpu")
    jst, jlogits = jprefill(jstorage, dict(tokens=jnp.asarray(toks)), jst)
    ops.reset_launch_counts()
    st, logits = prefill(storage, dict(tokens=_t(toks).long()), st)
    # one forward pass: 4 recurrent x 8 + 1 attention x 7 block matrices;
    # 4 conv_w, the embedding rows and the tied head decoded
    assert ops.launch_counts() == {"dequant_matmul.ref": 39, "dequantize.ref": 6}
    assert logits.shape == (B, 1, cfg.vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    for _ in range(8):  # 12 + 8 positions: the 16-slot ring wraps
        tok = np.asarray(jnp.argmax(jlogits[:, -1], axis=-1))[:, None].astype(np.int32)
        jst, jlogits = jdecode(jstorage, jst, jnp.asarray(tok))
        st, logits = decode(storage, st, _t(tok).long())
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    assert st["length"] == 20 == int(jst["length"])
    np.testing.assert_array_equal(st["att"]["pos"].numpy(), np.asarray(jst["att"]["pos"]))
    for part, key in (("att", "k"), ("att", "v"), ("rec", "conv"), ("rec", "h"),
                      ("extra_rec", "conv"), ("extra_rec", "h")):
        np.testing.assert_allclose(st[part][key].numpy(), np.asarray(jst[part][key]),
                                   rtol=1e-4, atol=1e-4)


def test_generate_greedy_tokens_match_reference_through_a_ring_wrap(trees):
    jstorage, storage = trees
    toks = _tokens(12, seed=2)
    jsess = JServeSession(jgr, jcfg.smoke_config(), jstorage)
    _, jgen = jsess.generate(dict(tokens=jnp.asarray(toks)), jsess.init_cache(B, MAX_LEN), 8)
    sess = ServeSession(gr, recurrentgemma_2b.smoke_config(), storage)
    cache, gen = sess.generate(dict(tokens=_t(toks).long()), sess.init_cache(B, MAX_LEN), 8)
    np.testing.assert_array_equal(gen.numpy(), np.asarray(jgen))
    assert cache["length"] == 19 and cache["att"]["k"].shape[2] == 16  # wrapped past slot 15


def test_prefill_then_decode_equals_longer_prefill(trees):
    _, storage = trees
    cfg = recurrentgemma_2b.smoke_config()
    prefill, decode = make_serve_fns(gr, cfg)
    for s in (7, 16, 20):  # shorter than the ring, exactly the ring, wrapped
        toks = _t(_tokens(s + 1, seed=s)).long()
        st0 = gr.init_decode_state(cfg, B, MAX_LEN, dtype=torch.float32, device="cpu")
        _, la = prefill(storage, dict(tokens=toks), st0)
        st, _ = prefill(storage, dict(tokens=toks[:, :s]), st0)
        _, lb = decode(storage, st, toks[:, s:s + 1])
        assert not torch.isnan(lb).any()
        np.testing.assert_allclose(la.numpy(), lb.numpy(), rtol=5e-4, atol=5e-4)


def test_serve_cli_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "recurrentgemma-2b",
         "--smoke", "--device", "cpu", "--wire-roundtrip", "--batch", "2", "--prompt-len", "12",
         "--gen", "8"], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert '"swap_bit_identical": true' in proc.stdout
    assert '"arch": "recurrentgemma-2b"' in proc.stdout
