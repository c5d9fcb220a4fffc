"""PyTorch port vs the JAX reference: seamless-m4t-medium (encoder-decoder).

Both packages serve the same storage tree (the reference's
``compress_params`` output in S1E3M7 on the smoke config: 2 + 2 layers, d
64, 4 heads, vocab 512), carried across with ``repro_torch.interop``, and
run the same f32 params for the loss.  The requests are the serve CLI's: a
batch of 2, a 6-token prompt, 2 new tokens, so ``4 * (6 + 2) = 32`` frames
and a decoder self cache of ``max(32 // 4, 8) = 8`` slots, which decode
steps past position 7 overwrite at the last slot, as in the reference.
Tolerances as for the zoo (tests/test_torch_zoo.py): logits within 1e-4
and greedy tokens equal; loss and gradients within 1e-4; ``prefill(n) +
decode`` against ``prefill(n + 1)`` within the reference's 5e-4; init
within 4 ulp.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.session import ServeSession as JServeSession
from repro.configs import seamless_m4t_medium as jmod
from repro.core.omc import OMCConfig as JOMC
from repro.federated import state as jstate
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import encdec as jed
from repro_torch import interop
from repro_torch.configs import seamless_m4t_medium
from repro_torch.configs.registry import get_arch
from repro_torch.core import prng
from repro_torch.core.tree import tree_items, tree_map
from repro_torch.federated.round import make_serve_fns
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, serve, train
from repro_torch.models import attention as attn
from repro_torch.models import encdec as ed
from repro_torch.models.common import IDENTITY_MAT
from repro_torch.models.registry import get_family

torch.set_num_threads(1)

B, PROMPT, GEN = 2, 6, 2
FRAMES = 4 * (PROMPT + GEN)


def _t(x):
    return torch.from_numpy(np.array(x))


def _flat(tree):
    return {tuple(k.key for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def trees():
    jcfg = jmod.smoke_config()
    js = jax.jit(lambda k: jstate.compress_params(
        jed.init(k, jcfg), jed.param_specs(jcfg), JOMC.parse("S1E3M7")))(jax.random.PRNGKey(0))
    return js, interop.storage_from_numpy(js, device="cpu"), JServeSession(jed, jcfg, js)


def _request(seed, prompt=PROMPT, frames=FRAMES):
    rng = np.random.default_rng(seed)
    return dict(tokens=rng.integers(0, 512, (B, prompt), dtype=np.int32),
                frames=rng.standard_normal((B, frames, 64)).astype(np.float32))


def _torch(b):
    return {k: _t(v).long() if v.dtype == np.int32 else _t(v) for k, v in b.items()}


def test_configs_and_c29_param_count():
    for name in ("config", "smoke_config"):
        jc, c = getattr(jmod, name)(), getattr(seamless_m4t_medium, name)()
        assert dataclasses.asdict(jc) == dataclasses.asdict(c)
        assert c.hd == jc.hd and c.param_count() == jc.param_count()
    assert (seamless_m4t_medium.ID, seamless_m4t_medium.FAMILY,
            seamless_m4t_medium.LONG_CONTEXT_OK) == (jmod.ID, jmod.FAMILY, jmod.LONG_CONTEXT_OK)
    assert get_arch("seamless-m4t-medium") is seamless_m4t_medium and get_family("encdec") is ed
    full = seamless_m4t_medium.config()
    assert full.dec_ratio == 4  # C28: the reference's comment swallows it; the default holds
    # C29: the formula counts 2d for the final norms, which hold 4d
    held = sum(v.numel() for _, v in tree_items(ed.init(prng.PRNGKey(0), full, "meta")))
    jheld = sum(v.size for v in jax.tree_util.tree_leaves(
        jax.eval_shape(lambda k: jed.init(k, full), jax.random.PRNGKey(0))))
    assert held == jheld == 877_383_680
    assert full.param_count() == 877_381_632 == held - 2 * 1024


def test_init_matches_reference_within_4_ulp():
    jcfg = jmod.smoke_config()
    want = _flat(jax.jit(lambda k: jed.init(k, jcfg))(jax.random.PRNGKey(2)))
    got = {p: v.numpy() for p, v in tree_items(ed.init(prng.PRNGKey(2), jcfg))}
    assert sorted(got) == sorted(want)
    for path, x in got.items():
        assert x.shape == want[path].shape, path
        d = np.abs(x.view(np.int32).astype(np.int64)
                   - want[path].view(np.int32).astype(np.int64))
        assert d.max() <= 4, path


def test_loss_and_gradients_match_reference():
    jcfg = jmod.smoke_config()
    rng = np.random.default_rng(3)
    t = rng.integers(0, 512, (B, 5), dtype=np.int32)
    batch = dict(frames=rng.standard_normal((B, 16, 64)).astype(np.float32), tokens=t[:, :-1],
                 labels=t[:, 1:], mask=(np.arange(4) != 2).astype(np.float32)[None].repeat(B, 0))
    jparams = jax.jit(lambda k: jed.init(k, jcfg))(jax.random.PRNGKey(1))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jed.loss(jcfg, p, jb, jcommon.Materializer())))(jparams)
    params = tree_map(lambda a: a.requires_grad_(True),
                      interop.params_from_numpy(jparams, device="cpu"))
    loss = ed.loss(jcfg, params, _torch(batch), IDENTITY_MAT)
    grads = torch.autograd.grad(loss, [v for _, v in tree_items(params)])
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4, atol=1e-4)
    want = _flat(jgrads)
    for (path, _), g in zip(tree_items(params), grads):
        np.testing.assert_allclose(g.numpy(), want[path], rtol=1e-4, atol=1e-4,
                                   err_msg=str(path))


def test_decode_attend_cross_is_unmasked_by_position():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((B, 1, 4, 8)).astype(np.float32)
    k, v = (rng.standard_normal((B, 10, 4, 8)).astype(np.float32) for _ in range(2))
    pos = np.broadcast_to(np.arange(10, dtype=np.int32), (B, 10)).copy()
    pos[:, 8:] = -1  # empty slots stay masked
    for causal in (True, False):
        got = attn.decode_attend(_t(q), _t(k), _t(v), _t(pos), 3, causal=causal)
        want = jattn.decode_attend(*map(jnp.asarray, (q, k, v, pos)), 3, causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # positions 4-7 lie after the query's: visible only without the causal mask
    a = attn.decode_attend(_t(q), _t(k), _t(v), _t(pos), 3, causal=False)
    c = attn.decode_attend(_t(q), _t(k), _t(v), _t(pos), 3)
    assert (a - c).abs().max() > 1e-3


def test_prefill_and_decode_logits_and_state_match_reference(trees):
    jstorage, storage, jsess = trees
    cfg = seamless_m4t_medium.smoke_config()
    prefill, decode = make_serve_fns(ed, cfg)
    req = _request(1)
    jc, jlogits = jsess.prefill({k: jnp.asarray(v) for k, v in req.items()},
                                jsess.init_cache(B, FRAMES))
    c = ed.init_decode_state(cfg, B, FRAMES, dtype=torch.float32, device="cpu")
    assert c["self_kv"].buf_len == 8 and int(c["cross_pos"].max()) == -1
    ops.reset_launch_counts()
    c, logits = prefill(storage, _torch(req), c)
    # 2 encoder layers x 6 + 2 decoder layers x 10 matrices (the cross K/V
    # once); the embedding rows and lm_head decoded
    assert ops.launch_counts() == {"dequant_matmul.ref": 32, "dequantize.ref": 2}
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    for step in range(4):  # positions 6-9: 8 and 9 into the last of the 8 slots
        tok = np.asarray(jnp.argmax(jlogits[:, -1], axis=-1))[:, None].astype(np.int32)
        jc, jlogits = jsess.decode_step(jc, jnp.asarray(tok))
        ops.reset_launch_counts()
        c, logits = decode(storage, c, _t(tok).long())
        if step == 0:  # self 4 + cross q/o 2 + MLP 2 a layer
            assert ops.launch_counts() == {"dequant_matmul.ref": 16, "dequantize.ref": 2}
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    assert c["length"] == int(jc["length"]) == c["self_kv"].length == PROMPT + 4
    np.testing.assert_array_equal(c["self_kv"].pos.numpy(), np.asarray(jc["self_kv"].pos))
    np.testing.assert_array_equal(c["cross_pos"].numpy(), np.asarray(jc["cross_pos"]))
    for key in ("cross_k", "cross_v"):
        np.testing.assert_allclose(c[key].numpy(), np.asarray(jc[key]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(c["self_kv"].k.numpy(), np.asarray(jc["self_kv"].k), rtol=1e-4,
                               atol=1e-4)


def test_prefill_then_decode_equals_longer_prefill(trees):
    _, storage, _ = trees
    cfg = seamless_m4t_medium.smoke_config()
    prefill, decode = make_serve_fns(ed, cfg)
    full = _torch(_request(5, prompt=PROMPT + 1))
    part = dict(full, tokens=full["tokens"][:, :PROMPT])
    st0 = ed.init_decode_state(cfg, B, FRAMES, dtype=torch.float32, device="cpu")
    _, la = prefill(storage, full, st0)
    st, _ = prefill(storage, part, st0)
    _, lb = decode(storage, st, full["tokens"][:, PROMPT:])
    assert torch.isfinite(lb).all()
    np.testing.assert_allclose(la.numpy(), lb.numpy(), rtol=5e-4, atol=5e-4)


def test_serve_cli_matches_the_reference_cli(trees):
    """``launch.serve --arch seamless-m4t-medium --smoke --device cpu``: the
    reference CLI's frames (``normal(fold_in(key, 2), (B, 4 * (prompt +
    gen), d))``) and prompts, its cache sizing, its greedy tokens."""
    report = serve.run(serve.parse_args(
        ["--arch", "seamless-m4t-medium", "--smoke", "--device", "cpu", "--batch", str(B),
         "--prompt-len", str(PROMPT), "--gen", str(GEN), "--quiet"]))
    assert (report["n_enc_layers"], report["n_dec_layers"]) == (2, 2)
    _, _, jsess = trees  # the CLI's storage: PRNGKey(0), S1E3M7
    key = jax.random.PRNGKey(0)
    jb = dict(tokens=jax.random.randint(jax.random.fold_in(key, 1), (B, PROMPT), 0, 512),
              frames=jax.random.normal(jax.random.fold_in(key, 2), (B, FRAMES, 64)))
    _, jgen = jsess.generate(jb, jsess.init_cache(B, FRAMES), GEN + 1)
    # the CLI reports the tokens its decode steps pick (after prefill's)
    np.testing.assert_array_equal(np.asarray(report["tokens"]), np.asarray(jgen)[:, 1:])
    sess = report["session"]
    b = serve.request_batch(prng.PRNGKey(0), "encdec", sess.cfg, B, PROMPT, "cpu", GEN)
    np.testing.assert_allclose(b["frames"].numpy(), np.asarray(jb["frames"]), rtol=0,
                               atol=4 * np.finfo(np.float32).eps * 8)
    cut = serve.run(serve.parse_args(
        ["--arch", "seamless-m4t-medium", "--smoke", "--device", "cpu", "--layers", "1",
         "--batch", "1", "--prompt-len", "2", "--gen", "1", "--quiet"]))
    assert (cut["session"].cfg.n_enc_layers, cut["session"].cfg.n_dec_layers) == (1, 1)


def test_train_driver_refuses_the_encdec_as_the_reference():
    with pytest.raises(SystemExit, match="encdec"):
        train.run(train.parse_args(["--arch", "seamless-m4t-medium", "--smoke", "--device",
                                    "cpu", "--rounds", "1", "--quiet"]))


def test_dryrun_cells(tmp_path):
    """``decode_32k`` at full size; ``prefill_32k`` and ``train_4k`` at 64
    frames (16 decoder tokens) and 1 + 1 layers."""
    out = dryrun.run_cell("seamless-m4t-medium", "decode_32k", out_dir=str(tmp_path))
    assert out["kernel_calls"] == {"dequant_matmul": 96, "dequantize": 2}
    cell = dryrun.build_cell("seamless-m4t-medium", "train_4k")
    b = cell.inputs["batch"]
    assert tuple(b["frames"].shape) == (256, 4096, 1024)
    assert tuple(b["tokens"].shape) == tuple(b["labels"].shape) == (256, 1024)
    from repro_torch.configs.shapes import Shape

    small = {"n_enc_layers": "1", "n_dec_layers": "1"}
    for kind, want in (("prefill", {"dequant_matmul": 16, "dequantize": 2}), ("train", None)):
        cell = dryrun.build_cell("seamless-m4t-medium", Shape(f"{kind}_64", kind, 64, 2),
                                 overrides=small)
        calls = {k[len("kernel."):]: v for k, v in dryrun.trace_cell(cell).ops.items()
                 if k.startswith("kernel.")}
        if want:
            assert calls == want
        else:  # every compressed leaf decoded, again in the recompute, and at the update
            assert calls["dequantize"] > 0 and calls["quantize_stats"] > 0
