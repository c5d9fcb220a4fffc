"""PyTorch port vs the JAX reference: the dense decoder configs
(h2o-danube-3-4b, mistral-nemo-12b, qwen1.5-110b), the VLM prefix
(internvl2-1b) and the transformer's remaining config surface
(``swa_every``, ``prefix_embeds``, ``sp_residuals``).

Both packages serve the same storage tree (the reference's
``compress_params`` output in S1E3M7 on each smoke config, carried across
with ``repro_torch.interop``) and run the same f32 params for the loss.
Tolerances: logits within 1e-4 and greedy tokens equal, as for qwen2.5-3b
(tests/test_torch_serve.py); loss and gradients within 1e-4;
``prefill(n) + decode`` against ``prefill(n + 1)`` within the reference's
own 5e-4 (tests/test_models_smoke.py); init within 4 ulp.
"""

import dataclasses
import importlib
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.session import ServeSession as JServeSession
from repro.core.omc import OMCConfig as JOMC
from repro.federated import round as jround
from repro.federated import state as jstate
from repro.models import common as jcommon
from repro.models import transformer as jtr
from repro_torch import interop
from repro_torch.api.session import ServeSession
from repro_torch.configs import internvl2_1b
from repro_torch.configs.registry import get_arch
from repro_torch.core import prng
from repro_torch.core.tree import tree_items, tree_map
from repro_torch.federated.round import make_serve_fns
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, serve
from repro_torch.models import transformer as tr
from repro_torch.models.common import IDENTITY_MAT
from repro_torch.models.registry import get_family

torch.set_num_threads(1)

ZOO = {"h2o-danube-3-4b": "h2o_danube3_4b", "mistral-nemo-12b": "mistral_nemo_12b",
       "qwen1.5-110b": "qwen1_5_110b", "internvl2-1b": "internvl2_1b"}
B, S, MAX_LEN = 2, 6, 32


def _mods(arch_id):
    name = ZOO[arch_id]
    return (importlib.import_module(f"repro.configs.{name}"),
            importlib.import_module(f"repro_torch.configs.{name}"))


def _pcfg(jcfg):
    return tr.TransformerConfig(**dataclasses.asdict(jcfg))


def _t(x):
    return torch.from_numpy(np.array(x))


def _flat(tree):
    return {tuple(k.key for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _batch(cfg, n, seed, batch=B, labels=False):
    """numpy tokens (and the VLM's patches, the next tokens as labels)."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, cfg.vocab, (batch, n + 1), dtype=np.int32)
    out = dict(tokens=t[:, :-1])
    if labels:
        out["labels"] = t[:, 1:]
    if cfg.prefix_embeds:
        out["patches"] = rng.standard_normal((batch, cfg.prefix_embeds, cfg.d_model)).astype(
            np.float32)
    return out


def _torch(b):
    return {k: _t(v).long() if v.dtype == np.int32 else _t(v) for k, v in b.items()}


def _jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


_STORAGE = {}


def _storage(arch_id):
    if arch_id not in _STORAGE:
        jcfg = _mods(arch_id)[0].smoke_config()
        js = jax.jit(lambda k: jstate.compress_params(
            jtr.init(k, jcfg), jtr.param_specs(jcfg), JOMC.parse("S1E3M7")))(
            jax.random.PRNGKey(0))
        _STORAGE[arch_id] = (js, interop.storage_from_numpy(js, device="cpu"),
                             JServeSession(jtr, jcfg, js))  # its jitted serve fns, shared
    return _STORAGE[arch_id]


@pytest.mark.parametrize("arch_id", list(ZOO))
def test_configs_match_reference(arch_id):
    jmod, mod = _mods(arch_id)
    assert (mod.ID, mod.FAMILY, mod.LONG_CONTEXT_OK) == (jmod.ID, jmod.FAMILY,
                                                         jmod.LONG_CONTEXT_OK)
    assert get_arch(arch_id) is mod and get_family(mod.FAMILY) is tr
    for name in ("config", "smoke_config"):
        jc, c = getattr(jmod, name)(), getattr(mod, name)()
        assert dataclasses.asdict(jc) == dataclasses.asdict(c)
        for prop in ("hd", "q_dim", "kv_dim", "uniform_window"):
            assert getattr(c, prop) == getattr(jc, prop), prop
        assert [c.layer_window(i) for i in range(c.n_layers)] == \
            [jc.layer_window(i) for i in range(jc.n_layers)]
        assert c.param_count() == jc.param_count()
    if arch_id == "internvl2-1b":
        assert mod.N_PATCHES == jmod.N_PATCHES == mod.config().prefix_embeds == 1024
        full = mod.config()  # C28: the reference's comment swallows three fields
        assert (full.vocab, full.tie_embeddings, full.qkv_bias, full.head_dim) == \
            (151_808, False, False, None)


@pytest.mark.parametrize("arch_id", list(ZOO))
def test_param_count_is_the_meta_inits_leaf_sizes(arch_id):
    cfg = _mods(arch_id)[1].config()
    params = tr.init(prng.PRNGKey(0), cfg, "meta")
    assert cfg.param_count() == sum(leaf.numel() for _, leaf in tree_items(params))


@pytest.mark.parametrize("arch_id", list(ZOO))
def test_init_matches_reference_within_4_ulp(arch_id):
    jcfg = _mods(arch_id)[0].smoke_config()
    want = _flat(jax.jit(lambda k: jtr.init(k, jcfg))(jax.random.PRNGKey(2)))
    got = {p: v.numpy() for p, v in tree_items(tr.init(prng.PRNGKey(2), _pcfg(jcfg)))}
    assert sorted(got) == sorted(want)
    for path, x in got.items():
        assert x.shape == want[path].shape, path
        d = np.abs(x.view(np.int32).astype(np.int64)
                   - want[path].view(np.int32).astype(np.int64))
        assert d.max() <= 4, path


def _loss_and_grads(jcfg, batch, seed=1):
    jparams = jax.jit(lambda k: jtr.init(k, jcfg))(jax.random.PRNGKey(seed))
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: jtr.loss(
        jcfg, p, _jax(batch), jcommon.Materializer())))(jparams)
    params = tree_map(lambda a: a.requires_grad_(True),
                      interop.params_from_numpy(jparams, device="cpu"))
    loss = tr.loss(_pcfg(jcfg), params, _torch(batch), IDENTITY_MAT)
    paths = [p for p, _ in tree_items(params)]
    grads = dict(zip(paths, torch.autograd.grad(loss, [v for _, v in tree_items(params)])))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4, atol=1e-4)
    want = _flat(jgrads)
    assert sorted(grads) == sorted(want)
    for path, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[path], rtol=1e-4, atol=1e-4,
                                   err_msg=str(path))
    return loss.item()


@pytest.mark.parametrize("masked", [False, True])
def test_vlm_loss_and_gradients_mask_the_prefix(masked):
    """The prefix positions carry no target; a batch mask covers the tokens."""
    jcfg = internvl2_1b.smoke_config()
    batch = _batch(jcfg, 10, seed=3, labels=True)
    if masked:
        batch["mask"] = (np.arange(10) % 3 != 0).astype(np.float32)[None].repeat(B, 0)
    loss = _loss_and_grads(_jcfg_of(jcfg), batch)
    # the patches reach the loss only through attention: the prefix is not scored
    cfg = _pcfg(_jcfg_of(jcfg))
    params = tr.init(prng.PRNGKey(1), cfg)
    hidden = tr.forward(cfg, params, _torch(batch), IDENTITY_MAT)
    assert hidden.shape == (B, cfg.prefix_embeds + 10, cfg.d_model) and np.isfinite(loss)


def _jcfg_of(cfg):
    return jtr.TransformerConfig(**dataclasses.asdict(cfg))


def test_mixed_window_forward_loss_and_gradients_match_reference():
    """``swa_every=2``: every second layer attends in full, the others in a
    window of 4, each layer under its own checkpoint."""
    jcfg = jtr.TransformerConfig(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                                 vocab=128, head_dim=8, window=4, swa_every=2)
    assert jcfg.uniform_window is None
    cfg = _pcfg(jcfg)
    assert [cfg.layer_window(i) for i in range(2)] == [4, None]
    batch = _batch(jcfg, 12, seed=5, labels=True)
    _loss_and_grads(jcfg, batch)
    jparams = jax.jit(lambda k: jtr.init(k, jcfg))(jax.random.PRNGKey(1))
    want = jax.jit(lambda p: jtr.forward(jcfg, p, _jax(batch), jcommon.Materializer()))(jparams)
    got = tr.forward(cfg, interop.params_from_numpy(jparams, device="cpu"), _torch(batch),
                     IDENTITY_MAT)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # the window matters: the uniform-window forward differs
    uniform = tr.forward(dataclasses.replace(cfg, swa_every=1),
                         interop.params_from_numpy(jparams, device="cpu"), _torch(batch),
                         IDENTITY_MAT)
    assert (uniform - got).abs().max() > 1e-3


def test_mixed_window_prefill_uses_the_uniform_window_as_the_reference():
    jcfg = jtr.TransformerConfig(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                                 vocab=128, head_dim=8, window=4, swa_every=2)
    js = jax.jit(lambda k: jstate.compress_params(
        jtr.init(k, jcfg), jtr.param_specs(jcfg), JOMC.parse("S1E3M7")))(jax.random.PRNGKey(4))
    storage = interop.storage_from_numpy(js, device="cpu")
    batch = _batch(jcfg, 10, seed=6)
    jprefill, jdecode = (jax.jit(f) for f in jround.make_serve_fns(jtr, jcfg))
    prefill, decode = make_serve_fns(tr, _pcfg(jcfg))
    jc, jl = jprefill(js, _jax(batch), jtr.init_decode_state(jcfg, B, 16, dtype=jnp.float32))
    c, lg = prefill(storage, _torch(batch),
                    tr.init_decode_state(_pcfg(jcfg), B, 16, dtype=torch.float32, device="cpu"))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    jc, jl = jdecode(js, jc, jnp.asarray(tok))
    c, lg = decode(storage, c, _t(tok).long())
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch_id", list(ZOO))
def test_prefill_and_decode_logits_match_reference(arch_id):
    jstorage, storage, jsess = _storage(arch_id)
    jcfg, cfg = _mods(arch_id)[0].smoke_config(), _mods(arch_id)[1].smoke_config()
    jprefill, jdecode = (lambda st, b, c: jsess.prefill(b, c),
                         lambda st, c, t: jsess.decode_step(c, t))
    prefill, decode = make_serve_fns(tr, cfg)
    batch = _batch(cfg, S, seed=1)
    jc = jtr.init_decode_state(jcfg, B, MAX_LEN, dtype=jnp.float32)
    c = tr.init_decode_state(cfg, B, MAX_LEN, dtype=torch.float32, device="cpu")
    jc, jlogits = jprefill(jstorage, _jax(batch), jc)
    ops.reset_launch_counts()
    c, logits = prefill(storage, _torch(batch), c)
    # the embedding rows and the head (the tied table or lm_head) decoded
    assert ops.launch_counts() == {"dequant_matmul.ref": 7 * cfg.n_layers,
                                   "dequantize.ref": 2}
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    steps = 12 if cfg.window else 3  # h2o: 6 + 12 positions wrap its 16-slot ring
    for _ in range(steps):
        tok = np.asarray(jnp.argmax(jlogits[:, -1], axis=-1))[:, None].astype(np.int32)
        jc, jlogits = jdecode(jstorage, jc, jnp.asarray(tok))
        c, logits = decode(storage, c, _t(tok).long())
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    assert c.length == int(jc.length) == S + steps + cfg.prefix_embeds
    np.testing.assert_array_equal(c.pos.numpy(), np.asarray(jc.pos))


@pytest.mark.parametrize("arch_id", list(ZOO))
def test_generate_greedy_tokens_match_reference(arch_id):
    jstorage, storage, jsess = _storage(arch_id)
    jcfg, cfg = _mods(arch_id)[0].smoke_config(), _mods(arch_id)[1].smoke_config()
    batch = _batch(cfg, S, seed=2)
    steps = 14 if cfg.window else 5
    _, jgen = jsess.generate(_jax(batch), jsess.init_cache(B, MAX_LEN), steps)
    sess = ServeSession(tr, cfg, storage)
    _, gen = sess.generate(_torch(batch), sess.init_cache(B, MAX_LEN), steps)
    np.testing.assert_array_equal(gen.numpy(), np.asarray(jgen))


@pytest.mark.parametrize("arch_id", ["internvl2-1b", "h2o-danube-3-4b"])
def test_prefill_then_decode_equals_longer_prefill(arch_id):
    _, storage, _ = _storage(arch_id)
    cfg = _mods(arch_id)[1].smoke_config()
    prefill, decode = make_serve_fns(tr, cfg)
    for s in (5, 16, 20):  # h2o: shorter than the ring, exactly the ring, wrapped
        full = _torch(_batch(cfg, s + 1, seed=s))
        part = dict(full, tokens=full["tokens"][:, :s])
        st0 = tr.init_decode_state(cfg, B, 64, dtype=torch.float32, device="cpu")
        _, la = prefill(storage, full, st0)
        st, _ = prefill(storage, part, st0)
        _, lb = decode(storage, st, full["tokens"][:, s:s + 1])
        np.testing.assert_allclose(la.numpy(), lb.numpy(), rtol=5e-4, atol=5e-4)


def _reference_cli(arch_id, batch, prompt_len, gen, seed=0):
    """``repro.launch.serve.main``'s computation with its logits kept."""
    jcfg = _mods(arch_id)[0].smoke_config()
    key = jax.random.PRNGKey(seed)
    storage = jax.jit(lambda k: jstate.compress_params(  # one program, the same math
        jtr.init(k, jcfg), jtr.param_specs(jcfg), JOMC.parse("S1E3M7")))(key)
    sess = JServeSession(jtr, jcfg, storage)
    b = dict(tokens=jax.random.randint(jax.random.fold_in(key, 1), (batch, prompt_len), 0,
                                       jcfg.vocab))
    if jcfg.prefix_embeds:
        b["patches"] = jax.random.normal(jax.random.fold_in(key, 2),
                                         (batch, jcfg.prefix_embeds, jcfg.d_model))
    cache, logits = sess.prefill(b, sess.init_cache(batch, 4 * (prompt_len + gen),
                                                    dtype=jnp.float32))
    out, toks = [np.asarray(logits)], []
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None]
    for _ in range(gen):
        cache, logits = sess.decode_step(cache, tok)
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None]
        out.append(np.asarray(logits))
        toks.append(np.asarray(tok))
    return out, np.concatenate(toks, axis=1)


def _replay(sess, arch_id, batch, prompt_len, gen, cache_len):
    b = serve.request_batch(prng.PRNGKey(0), get_arch(arch_id).FAMILY, sess.cfg, batch,
                            prompt_len, "cpu")
    cache, logits = sess.prefill(b, sess.init_cache(batch, cache_len))
    out = [logits.numpy()]
    for _ in range(gen):
        cache, logits = sess.decode_step(cache, torch.argmax(logits[:, -1], -1)[:, None])
        out.append(logits.numpy())
    return out


@pytest.mark.parametrize("prompt_len,gen", [(6, 3), (1, 1)])
def test_vlm_serve_cli_matches_the_reference_cli(prompt_len, gen):
    """C28: both CLIs size the cache as ``4 * (prompt + gen)``, without the
    prefix.  At prompt 1 and 1 token that is 8 slots for a 9-position
    stream: prefill keeps the last 8, and the decode step overwrites the
    last slot; the logits then differ from a cache that holds the stream."""
    report = serve.run(serve.parse_args(
        ["--arch", "internvl2-1b", "--smoke", "--device", "cpu", "--batch", "2",
         "--prompt-len", str(prompt_len), "--gen", str(gen), "--quiet"]))
    want, jtokens = _reference_cli("internvl2-1b", 2, prompt_len, gen)
    np.testing.assert_array_equal(np.asarray(report["tokens"]), jtokens)
    sess = report["session"]
    got = _replay(sess, "internvl2-1b", 2, prompt_len, gen, 4 * (prompt_len + gen))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    whole = _replay(sess, "internvl2-1b", 2, prompt_len, gen, 64)
    gap = np.abs(whole[-1] - got[-1]).max()
    assert (gap > 1e-3) == (prompt_len == 1), gap


def test_dryrun_cell_of_the_vlm(tmp_path):
    """internvl2-1b ``decode_32k`` through ``run_cell`` on the 16 x 16 mesh:
    the batch holds one token (the patches only at prefill and training)."""
    t0 = time.perf_counter()
    out = dryrun.run_cell("internvl2-1b", "decode_32k", out_dir=str(tmp_path))
    assert time.perf_counter() - t0 < 10
    assert out["kernel_calls"] == {"dequant_matmul": 7 * 24, "dequantize": 2}
    assert out["memory_analysis"]["argument_size_in_bytes"] > 0
    cell = dryrun.build_cell("internvl2-1b", "prefill_32k")
    assert tuple(cell.inputs["batch"]["patches"].shape) == (32, 1024, 896)
    assert tuple(cell.inputs["batch"]["tokens"].shape) == (32, 32_768 - 1024)
