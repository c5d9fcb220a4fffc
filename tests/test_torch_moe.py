"""PyTorch port vs the JAX reference: the MoE family (mixtral-8x7b, dbrx-132b).

Both packages run on the same inputs: the reference's init (or its
``compress_params`` output in S1E3M7) carried across with
``repro_torch.interop``, activations and router weights made with numpy
from a seed.  The reference runs its single-device dispatch (no mesh); its
``shard_map`` path is not called here.

Tolerances: routing ids equal, gates and the aux loss within 1e-6; the MoE
FFN with dropped pairs (``capacity_factor`` 0.5) within 1e-5; loss and its
gradients within 1e-4; serving logits over S1E3M7 storage within 1e-4
(each expert matrix through ``dequant_matmul``'s plain version, which the
reference's decode-then-multiply is held to), greedy tokens equal;
``prefill(n) + decode`` against ``prefill(n + 1)`` within the reference's
own 5e-4 (tests/test_models_smoke.py); init within 4 ulp
(tests/test_torch_init.py).  No routing flip is allowed on these fixed
samples (ROADMAP C26: flips can only come from f32 near-ties).
"""

import dataclasses
import math
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
from repro.configs import dbrx_132b as jdbrx
from repro.configs import mixtral_8x7b as jmixtral
from repro.core.omc import OMCConfig as JOMC
from repro.core.store import is_compressed as jis_compressed
from repro.federated import round as jround
from repro.federated import state as jstate
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro.optim import fedavg as jfedavg
from repro_torch import interop
from repro_torch.api.session import ServeSession
from repro_torch.configs import dbrx_132b, mixtral_8x7b
from repro_torch.configs.registry import get_arch
from repro_torch.core import prng
from repro_torch.core.omc import OMCConfig
from repro_torch.core.tree import tree_items, tree_map
from repro_torch.federated.round import make_serve_fns
from repro_torch.kernels import ops
from repro_torch.launch import serve, train
from repro_torch.models import moe
from repro_torch.models.common import IDENTITY_MAT
from repro_torch.models.registry import get_family

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = {"mixtral-8x7b": (jmixtral, mixtral_8x7b), "dbrx-132b": (jdbrx, dbrx_132b)}
B, S, MAX_LEN = 2, 8, 32
ULP = 4


def _pcfg(jcfg):
    """The port's MoEConfig with the reference config's fields."""
    return moe.MoEConfig(**dataclasses.asdict(jcfg))


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def _flat(tree):
    return {tuple(k.key for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


_STORAGE = {}


def _storage(arch_id):
    """The reference's S1E3M7 storage of the arch's smoke config, both sides."""
    if arch_id not in _STORAGE:
        jcfg = ARCHS[arch_id][0].smoke_config()
        js = jax.jit(lambda k: jstate.compress_params(
            jmoe.init(k, jcfg), jmoe.param_specs(jcfg), JOMC.parse("S1E3M7")))(
            jax.random.PRNGKey(0))
        _STORAGE[arch_id] = (js, interop.storage_from_numpy(js, device="cpu"),
                             JServeSession(jmoe, jcfg, js))  # its jitted serve fns, shared
    return _STORAGE[arch_id]


def _tokens(n, seed, batch=B):
    return np.random.default_rng(seed).integers(0, 512, (batch, n), dtype=np.int32)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("arch_id", list(ARCHS))
def test_configs_match_reference(arch_id):
    jmod, mod = ARCHS[arch_id]
    assert (mod.ID, mod.FAMILY, mod.LONG_CONTEXT_OK) == (jmod.ID, jmod.FAMILY,
                                                         jmod.LONG_CONTEXT_OK)
    assert get_arch(arch_id) is mod and get_family("moe") is moe
    for name in ("config", "smoke_config"):
        jc, c = getattr(jmod, name)(), getattr(mod, name)()
        assert dataclasses.asdict(jc) == dataclasses.asdict(c)
        for ep in (1, 2):
            jce, ce = (dataclasses.replace(x, ep_partitions=ep) for x in (jc, c))
            for prop in ("stored_experts", "f_local", "hd", "q_dim", "kv_dim"):
                assert getattr(ce, prop) == getattr(jce, prop), prop
            assert ce.param_count() == jce.param_count()
            assert ce.active_param_count() == jce.active_param_count()


@pytest.mark.parametrize("arch_id", list(ARCHS))
def test_param_counts_are_the_meta_inits_leaf_sizes(arch_id):
    """C8's check: ``param_count`` is the sum of the full config's init leaf
    sizes (on meta, nothing allocated), at ``ep_partitions`` 1 and 2;
    ``active_param_count`` is that less the unrouted experts' matrices."""
    cfg = ARCHS[arch_id][1].config()
    for ep in (1, 2):
        c = dataclasses.replace(cfg, ep_partitions=ep)
        params = moe.init(prng.PRNGKey(0), c, "meta")
        total = sum(leaf.numel() for _, leaf in tree_items(params))
        assert c.param_count() == total
        assert params["blocks"]["w1"].shape == (c.n_layers, c.stored_experts, c.d_model,
                                                c.f_local)
        unrouted = c.n_layers * 3 * c.d_model * c.d_ff * (c.n_experts - c.top_k)
        assert c.active_param_count() == total - unrouted
    if arch_id == "mixtral-8x7b":
        assert cfg.param_count() == 46_702_792_704


@pytest.mark.parametrize("ep", [1, 2])
def test_init_matches_reference_within_4_ulp(ep):
    jcfg = dataclasses.replace(jmixtral.smoke_config(), ep_partitions=ep, n_layers=1)
    want = _flat(jax.jit(lambda k: jmoe.init(k, jcfg))(jax.random.PRNGKey(3)))
    got = {p: v.numpy() for p, v in tree_items(moe.init(prng.PRNGKey(3), _pcfg(jcfg)))}
    assert sorted(got) == sorted(want)
    for path, x in got.items():
        assert x.shape == want[path].shape and x.dtype == want[path].dtype, path
        assert np.array_equal(np.signbit(x), np.signbit(want[path])), path
        assert _ulps(x, want[path]).max() <= ULP, path


def test_capacity_matches_reference():
    cfgs = [jmixtral.config(), jmixtral.smoke_config(), jdbrx.config(),
            dataclasses.replace(jmixtral.config(), capacity_factor=0.5)]
    for jc in cfgs:
        c = _pcfg(jc)
        assert [moe._capacity(t, c) for t in range(1, 4097)] == \
            [jmoe._capacity(t, jc) for t in range(1, 4097)]


def test_top_k_resolves_ties_as_the_reference():
    """Equal values: the lower index first, as ``jax.lax.top_k``; the
    capacity priority's unrouted pairs all score -1."""
    x = np.array([[0.5, 0.25, 0.5, 0.25, 0.5, -1.0, -1.0, 0.25],
                  [-1.0] * 8, [0.1, 0.3, 0.3, 0.3, 0.0, 0.3, 0.2, 0.3]], np.float32)
    for k in (1, 2, 3, 5, 8):
        v, i = moe.top_k(_t(x), k)
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def _route_inputs(seed, t=64, d=32, e=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((t, d)).astype(np.float32),
            (rng.standard_normal((d, e)) * 0.3).astype(np.float32))


@pytest.mark.parametrize("top_k,tied", [(2, False), (4, False), (2, True)])
def test_route_matches_reference(top_k, tied):
    x, rw = _route_inputs(top_k)
    if tied:  # experts 1, 4 and 6 get the same column: every token's gates tie
        rw[:, 4] = rw[:, 1]
        rw[:, 6] = rw[:, 1]
    jc = dataclasses.replace(jmixtral.smoke_config(), n_experts=8, top_k=top_k)
    gv, gi, aux = moe._route(_t(x), _t(rw), _pcfg(jc))
    jgv, jgi, jaux = jmoe._route(jnp.asarray(x), jnp.asarray(rw), jc)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(jgi))
    np.testing.assert_allclose(gv.numpy(), np.asarray(jgv), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6, atol=1e-6)
    if tied:
        probs = torch.softmax(_t(x) @ _t(rw), -1)
        top = gi[:, 0]
        tie_first = (probs[:, 1] == probs.max(-1).values)
        assert tie_first.any() and (top[tie_first] == 1).all()  # never 4 or 6 before 1


def _expert_weights(seed, e, d, f):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) / math.sqrt(shape[1])).astype(np.float32)
            for shape in ((e, d, f), (e, d, f), (e, f, d))]


@pytest.mark.parametrize("ep", [1, 2])
def test_moe_ffn_with_drops_matches_reference(ep):
    """``capacity_factor`` 0.5: experts drop pairs by gate priority."""
    jc = dataclasses.replace(jmixtral.smoke_config(), capacity_factor=0.5, ep_partitions=ep)
    c = _pcfg(jc)
    rng = np.random.default_rng(ep)
    x = rng.standard_normal((4, 16, c.d_model)).astype(np.float32)
    router = (rng.standard_normal((c.d_model, c.n_experts)) * 0.3).astype(np.float32)
    w1, w3, w2 = _expert_weights(ep, c.stored_experts, c.d_model, c.f_local)
    w = dict(router=router, w1=w1, w3=w3, w2=w2)
    cap = moe._capacity(64, c)
    assert cap < 64 * c.top_k // c.n_experts  # fewer slots than an even share: drops
    y, aux = moe.moe_ffn(_t(x), {k: _t(v) for k, v in w.items()}, c)
    jy, jaux = jmoe.moe_ffn(jnp.asarray(x), {k: jnp.asarray(v) for k, v in w.items()}, jc)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6, atol=1e-6)


def test_ep_partitions_2_is_ep_1_resliced():
    """The same weights with each expert's FFN dim split over two stored
    experts: outputs equal to f32 reassociation."""
    c1 = mixtral_8x7b.smoke_config()
    c2 = dataclasses.replace(c1, ep_partitions=2)
    rng = np.random.default_rng(7)
    x = _t(rng.standard_normal((2, 8, c1.d_model)).astype(np.float32))
    w1, w3, w2 = (_t(a) for a in _expert_weights(7, c1.n_experts, c1.d_model, c1.d_ff))
    router = _t((rng.standard_normal((c1.d_model, c1.n_experts)) * 0.3).astype(np.float32))
    h = c1.d_ff // 2
    split = dict(w1=torch.stack([w1[e][:, j * h:(j + 1) * h] for e in range(4) for j in (0, 1)]),
                 w3=torch.stack([w3[e][:, j * h:(j + 1) * h] for e in range(4) for j in (0, 1)]),
                 w2=torch.stack([w2[e][j * h:(j + 1) * h] for e in range(4) for j in (0, 1)]))
    y1, a1 = moe.moe_ffn(x, dict(router=router, w1=w1, w3=w3, w2=w2), c1)
    y2, a2 = moe.moe_ffn(x, dict(router=router, **split), c2)
    assert moe.local_experts(c2) == [0, 0, 1, 1, 2, 2, 3, 3]
    torch.testing.assert_close(y2, y1, rtol=1e-5, atol=1e-5)
    assert a1.item() == a2.item()


@pytest.mark.parametrize("arch_id", list(ARCHS))
def test_loss_and_gradients_match_reference(arch_id):
    jcfg = ARCHS[arch_id][0].smoke_config()
    cfg = ARCHS[arch_id][1].smoke_config()
    jparams = jax.jit(lambda k: jmoe.init(k, jcfg))(jax.random.PRNGKey(1))
    t = _tokens(17, seed=4)
    batch = dict(tokens=t[:, :-1], labels=t[:, 1:])
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: jmoe.loss(
        jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}, jcommon.Materializer())))(
        jparams)
    params = tree_map(lambda a: a.requires_grad_(True),
                      interop.params_from_numpy(jparams, device="cpu"))
    loss = moe.loss(cfg, params, {k: _t(v).long() for k, v in batch.items()}, IDENTITY_MAT)
    leaves = [v for _, v in tree_items(params)]
    grads = dict(zip([p for p, _ in tree_items(params)], torch.autograd.grad(loss, leaves)))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4, atol=1e-4)
    want = _flat(jgrads)
    assert sorted(grads) == sorted(want)
    for path, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[path], rtol=1e-4, atol=1e-4,
                                   err_msg=str(path))


@pytest.mark.parametrize("arch_id", list(ARCHS))
def test_prefill_and_decode_logits_match_reference(arch_id):
    jstorage, storage, jsess = _storage(arch_id)
    jcfg, cfg = ARCHS[arch_id][0].smoke_config(), ARCHS[arch_id][1].smoke_config()
    jprefill, jdecode = (lambda st, b, c: jsess.prefill(b, c),
                         lambda st, c, t: jsess.decode_step(c, t))
    prefill, decode = make_serve_fns(moe, cfg)
    toks = _tokens(S, seed=1)
    jc = jmoe.init_decode_state(jcfg, B, MAX_LEN, dtype=jnp.float32)
    c = moe.init_decode_state(cfg, B, MAX_LEN, dtype=torch.float32, device="cpu")
    jc, jlogits = jprefill(jstorage, dict(tokens=jnp.asarray(toks)), jc)
    c, logits = prefill(storage, dict(tokens=_t(toks).long()), c)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    steps = 10 if cfg.window else 3  # 8 + 10 positions: mixtral's 16-slot ring wraps
    for _ in range(steps):
        tok = np.asarray(jnp.argmax(jlogits[:, -1], axis=-1))[:, None].astype(np.int32)
        jc, jlogits = jdecode(jstorage, jc, jnp.asarray(tok))
        c, logits = decode(storage, c, _t(tok).long())
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    assert c.length == S + steps == int(jc.length)
    np.testing.assert_array_equal(c.pos.numpy(), np.asarray(jc.pos))
    np.testing.assert_allclose(c.k.numpy(), np.asarray(jc.k), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch_id", list(ARCHS))
def test_generate_greedy_tokens_match_reference(arch_id):
    jstorage, storage, jsess = _storage(arch_id)
    toks = _tokens(S, seed=2)
    _, jgen = jsess.generate(dict(tokens=jnp.asarray(toks)), jsess.init_cache(B, MAX_LEN), 12)
    sess = ServeSession(moe, ARCHS[arch_id][1].smoke_config(), storage)
    _, gen = sess.generate(dict(tokens=_t(toks).long()), sess.init_cache(B, MAX_LEN), 12)
    np.testing.assert_array_equal(gen.numpy(), np.asarray(jgen))


def test_forward_pass_launches_every_expert_through_dequant_matmul():
    """Per forward pass: ``L·(4 + 3·E_stored)`` ``dequant_matmul`` launches
    (attention's four, each stored expert's three) and ``L + 2``
    ``dequantize`` (the routers, the embedding rows, the head)."""
    _, storage, _ = _storage("mixtral-8x7b")
    cfg = mixtral_8x7b.smoke_config()
    prefill, decode = make_serve_fns(moe, cfg)
    want = {"dequant_matmul.ref": cfg.n_layers * (4 + 3 * cfg.stored_experts),
            "dequantize.ref": cfg.n_layers + 2}
    assert want == {"dequant_matmul.ref": 32, "dequantize.ref": 4}
    cache = moe.init_decode_state(cfg, B, MAX_LEN, dtype=torch.float32, device="cpu")
    ops.reset_launch_counts()
    cache, logits = prefill(storage, dict(tokens=_t(_tokens(S, seed=5)).long()), cache)
    assert ops.launch_counts() == want
    ops.reset_launch_counts()
    decode(storage, cache, torch.argmax(logits[:, -1], dim=-1)[:, None])
    assert ops.launch_counts() == want


def test_prefill_then_decode_equals_longer_prefill():
    _, storage, _ = _storage("mixtral-8x7b")
    cfg = mixtral_8x7b.smoke_config()
    prefill, decode = make_serve_fns(moe, cfg)
    for s in (7, 16, 20):  # shorter than the ring, exactly the ring, wrapped
        toks = _t(_tokens(s + 1, seed=s)).long()
        st0 = moe.init_decode_state(cfg, B, MAX_LEN, dtype=torch.float32, device="cpu")
        _, la = prefill(storage, dict(tokens=toks), st0)
        st, _ = prefill(storage, dict(tokens=toks[:, :s]), st0)
        _, lb = decode(storage, st, toks[:, s:s + 1])
        np.testing.assert_allclose(la.numpy(), lb.numpy(), rtol=5e-4, atol=5e-4)


def test_tied_head_serving_raises_naming_c28():
    """The reference's MoE prefill multiplies by None with a tied head
    (moe.py:384-388); the port raises instead."""
    cfg = dataclasses.replace(mixtral_8x7b.smoke_config(), tie_embeddings=True, n_layers=1)
    params = moe.init(prng.PRNGKey(0), cfg)
    assert "lm_head" not in params
    prefill, decode = make_serve_fns(moe, cfg)
    cache = moe.init_decode_state(cfg, 1, 8, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="C28"):
        prefill(params, dict(tokens=torch.zeros((1, 4), dtype=torch.long)), cache)
    with pytest.raises(ValueError, match="C28"):
        decode(params, cache, torch.zeros((1, 1), dtype=torch.long))
    # training with a tied head is defined: the loss reads the embedding
    loss = moe.loss(cfg, params, dict(tokens=torch.zeros((1, 4), dtype=torch.long),
                                      labels=torch.ones((1, 4), dtype=torch.long)),
                    IDENTITY_MAT)
    assert torch.isfinite(loss)


def test_under_a_mesh_the_dispatch_runs_over_the_whole_batch():
    """C27: under an active mesh the port dispatches as without one (the
    reference's shard_map path takes each shard's tokens)."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.common import activate_mesh

    c = mixtral_8x7b.smoke_config()
    rng = np.random.default_rng(11)
    x = _t(rng.standard_normal((4, 4, c.d_model)).astype(np.float32))
    w1, w3, w2 = (_t(a) for a in _expert_weights(11, c.n_experts, c.d_model, c.d_ff))
    w = dict(router=_t((rng.standard_normal((c.d_model, 4)) * 0.3).astype(np.float32)),
             w1=w1, w3=w3, w2=w2)
    y, aux = moe.moe_ffn(x, w, c)
    with activate_mesh(make_host_mesh(1, 1, device="cpu")):
        ym, auxm = moe.moe_ffn(x, w, c)
    assert torch.equal(y, ym) and torch.equal(aux, auxm)


def _reference_cli(jcfg, arch_id, batch, prompt_len, gen, seed=0):
    """The reference CLI's computation (``repro.launch.serve.main``), with its
    logits kept: init, compress, the prompts, prefill and greedy decode."""
    from repro.models.registry import get_family as jget_family

    jfam = jget_family(get_arch(arch_id).FAMILY)
    key = jax.random.PRNGKey(seed)
    storage = jax.jit(lambda k: jstate.compress_params(  # one program, the same math
        jfam.init(k, jcfg), jfam.param_specs(jcfg), JOMC.parse("S1E3M7")))(key)
    sess = JServeSession(jfam, jcfg, storage)
    toks = jax.random.randint(jax.random.fold_in(key, 1), (batch, prompt_len), 0, jcfg.vocab)
    b = dict(tokens=toks)
    if jcfg.prefix_embeds:
        b["patches"] = jax.random.normal(jax.random.fold_in(key, 2),
                                         (batch, jcfg.prefix_embeds, jcfg.d_model))
    cache = sess.init_cache(batch, 4 * (prompt_len + gen), dtype=jnp.float32)
    cache, logits = sess.prefill(b, cache)
    out, tokens = [np.asarray(logits)], []
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None]
    for _ in range(gen):
        cache, logits = sess.decode_step(cache, tok)
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None]
        out.append(np.asarray(logits))
        tokens.append(np.asarray(tok))
    return out, np.concatenate(tokens, axis=1)


def port_cli_logits(report, arch_id, batch, prompt_len, gen, seed=0):
    """Replay ``serve.run``'s requests on its session: the prefill's and each
    decode step's logits (``run`` reports the tokens only)."""
    sess = report["session"]
    key = prng.PRNGKey(seed)
    b = serve.request_batch(key, get_arch(arch_id).FAMILY, sess.cfg, batch, prompt_len, "cpu")
    cache, logits = sess.prefill(b, sess.init_cache(batch, 4 * (prompt_len + gen)))
    out = [logits.numpy()]
    for _ in range(gen):
        cache, logits = sess.decode_step(cache, torch.argmax(logits[:, -1], -1)[:, None])
        out.append(logits.numpy())
    return out


def test_serve_cli_matches_the_reference_cli():
    args = ["--arch", "mixtral-8x7b", "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "12", "--gen", "3", "--quiet"]
    report = serve.run(serve.parse_args(args))
    want, jtokens = _reference_cli(jmixtral.smoke_config(), "mixtral-8x7b", 2, 12, 3)
    np.testing.assert_array_equal(np.asarray(report["tokens"]), jtokens)
    for got, w in zip(port_cli_logits(report, "mixtral-8x7b", 2, 12, 3), want):
        np.testing.assert_allclose(got, w, rtol=1e-4, atol=1e-4)


def test_serve_cli_subprocess_with_wire_roundtrip():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "mixtral-8x7b", "--smoke",
         "--device", "cpu", "--wire-roundtrip", "--batch", "2", "--prompt-len", "8",
         "--gen", "2"], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert '"swap_bit_identical": true' in proc.stdout
    assert '"arch": "mixtral-8x7b"' in proc.stdout


def test_train_driver_round_matches_the_reference_round(tmp_path):
    """``launch.train --arch mixtral-8x7b --smoke --device cpu``, one round:
    its loss against the reference's round from the same state (the port's
    ``init_state`` carried to the reference) on the same batch."""
    args = train.parse_args(["--arch", "mixtral-8x7b", "--smoke", "--device", "cpu",
                             "--rounds", "1", "--quiet"])
    report = train.run(args)
    assert len(report["losses"]) == 1 and math.isfinite(report["losses"][0])
    cfg = mixtral_8x7b.smoke_config()
    from repro_torch.federated.state import init_state
    from repro_torch.optim import fedavg

    st = init_state(prng.PRNGKey(0), moe, cfg, OMCConfig.parse(args.fmt), fedavg(1.0),
                    device="cpu")
    data_fn = train.make_task(get_arch("mixtral-8x7b"), cfg, args.seq, args.clients, True,
                              args.seed, "cpu")
    batch = data_fn(0, 0, 0, args.batch)
    jcfg = jmixtral.smoke_config()
    jstorage = _to_reference_storage(st.params)
    zeros = jax.tree_util.tree_map(
        lambda v: jnp.zeros(v.codes.shape, jnp.float32) if jis_compressed(v) else v,
        jstorage, is_leaf=jis_compressed)
    jst = jstate.TrainState(params=jstorage, opt_state=jfedavg(1.0).init(zeros),
                            round=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0))
    jfn = jax.jit(jround.make_round_fn(jmoe, jcfg, JOMC.parse(args.fmt), jfedavg(1.0),
                                       client_lr=args.client_lr))
    _, jm = jfn(jst, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    np.testing.assert_allclose(report["losses"][0], float(jm["loss"]), rtol=1e-4)


def _to_reference_storage(tree):
    from repro.core.formats import FloatFormat as JFloatFormat
    from repro.core.store import CompressedVariable as JCV
    from repro_torch.core.store import is_compressed

    def conv(v):
        if is_compressed(v):
            return JCV(codes=jnp.asarray(v.codes.numpy()), s=jnp.asarray(v.s.numpy()),
                       b=jnp.asarray(v.b.numpy()), fmt=JFloatFormat.parse(v.fmt.name))
        return jnp.asarray(v.numpy())

    return {k: _to_reference_storage(v) if isinstance(v, dict) else conv(v)
            for k, v in tree.items()}
