"""PyTorch port vs the JAX reference: serving over compressed weights.

Both packages serve the same storage tree — the reference's
``compress_params`` output on the qwen2.5-3b smoke config, carried across
with ``repro_torch.interop`` — through their ``make_serve_fns`` and
``ServeSession``.

Logits agree within rtol=atol=1e-4: the decoded weights are the same up to
the affine's fused-vs-unfused rounding, and the f32 matmuls and softmax sums
are taken in another order (the measured maximum difference here is about
1e-6).  Greedy tokens must be equal.  The port's block matrices go through
``dequant_matmul`` (its plain version on the CPU); the reference's serve
path decodes them and multiplies, which is the function the port is held to.
"""

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
from repro.configs import qwen2_5_3b as jcfg
from repro.core.omc import OMCConfig as JOMC
from repro.federated import state as jstate
from repro.federated.round import make_serve_fns as jmake_serve_fns
from repro.models import transformer as jtr
from repro_torch import interop
from repro_torch.api.codecs import encode_payload
from repro_torch.api.session import ServeSession
from repro_torch.configs import qwen2_5_3b
from repro_torch.core.store import trees_bit_equal
from repro_torch.federated.round import make_serve_fns
from repro_torch.kernels import ops
from repro_torch.models import transformer as tr

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
B, S, MAX_LEN = 2, 8, 32


@pytest.fixture(scope="module")
def trees():
    cfg = jcfg.smoke_config()
    # jit: one compiled program instead of many small eager ones (same math)
    jstorage = jax.jit(lambda k: jstate.compress_params(
        jtr.init(k, cfg), jtr.param_specs(cfg), JOMC.parse("S1E3M7")))(jax.random.PRNGKey(0))
    return jstorage, interop.storage_from_numpy(jstorage, device="cpu")


def _tokens(n=S, seed=1):
    return np.random.default_rng(seed).integers(0, qwen2_5_3b.smoke_config().vocab, (B, n),
                                                dtype=np.int32)


def test_prefill_and_decode_logits_match_reference(trees):
    jstorage, storage = trees
    jcfg_, cfg = jcfg.smoke_config(), qwen2_5_3b.smoke_config()
    jprefill, jdecode = (jax.jit(f) for f in jmake_serve_fns(jtr, jcfg_))
    prefill, decode = make_serve_fns(tr, cfg)
    toks = _tokens()
    jcache = jtr.init_decode_state(jcfg_, B, MAX_LEN, dtype=jnp.float32)
    cache = tr.init_decode_state(cfg, B, MAX_LEN, dtype=torch.float32, device="cpu")
    jcache, jlogits = jprefill(jstorage, dict(tokens=jnp.asarray(toks)), jcache)
    cache, logits = prefill(storage, dict(tokens=torch.from_numpy(toks).long()), cache)
    assert logits.shape == (B, 1, cfg.vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    for _ in range(3):
        tok = np.asarray(jnp.argmax(jlogits[:, -1], axis=-1))[:, None].astype(np.int32)
        jcache, jlogits = jdecode(jstorage, jcache, jnp.asarray(tok))
        cache, logits = decode(storage, cache, torch.from_numpy(tok).long())
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    assert cache.length == S + 3 == int(jcache.length)
    np.testing.assert_array_equal(cache.pos.numpy(), np.asarray(jcache.pos))


def test_forward_pass_streams_every_block_matrix_through_dequant_matmul(trees):
    """Over OMC storage one forward pass sends each layer's seven block
    matrices through ``dequant_matmul`` and decodes only the embedding rows
    and the tied head (``dequantize``); on the CPU both are plain versions."""
    _, storage = trees
    cfg = qwen2_5_3b.smoke_config()
    prefill, decode = make_serve_fns(tr, cfg)
    cache = tr.init_decode_state(cfg, B, MAX_LEN, dtype=torch.float32, device="cpu")
    want = {"dequant_matmul.ref": 7 * cfg.n_layers, "dequantize.ref": 2}
    ops.reset_launch_counts()
    cache, logits = prefill(storage, dict(tokens=torch.from_numpy(_tokens()).long()), cache)
    assert ops.launch_counts() == want
    ops.reset_launch_counts()
    decode(storage, cache, torch.argmax(logits[:, -1], dim=-1)[:, None])
    assert ops.launch_counts() == want


def test_generate_greedy_tokens_match_reference(trees):
    jstorage, storage = trees
    toks = _tokens(seed=2)
    jsess = JServeSession(jtr, jcfg.smoke_config(), jstorage)
    _, jgen = jsess.generate(dict(tokens=jnp.asarray(toks)), jsess.init_cache(B, MAX_LEN), 5)
    sess = ServeSession(tr, qwen2_5_3b.smoke_config(), storage)
    _, gen = sess.generate(dict(tokens=torch.from_numpy(toks).long()),
                           sess.init_cache(B, MAX_LEN), 5)
    np.testing.assert_array_equal(gen.numpy(), np.asarray(jgen))
    assert sess.serve_stats()["queries"] == 1


def test_hot_swap_is_bit_transparent(trees):
    _, storage = trees
    sess = ServeSession(tr, qwen2_5_3b.smoke_config(), storage)
    info = sess.hot_swap(encode_payload(storage))
    assert not info.is_delta and sess.swaps == 1 and len(sess.swap_ms) == 1
    assert sess.storage is not storage and trees_bit_equal(storage, sess.storage)
    _, gen = sess.generate(dict(tokens=torch.zeros((1, 4), dtype=torch.long)),
                           sess.init_cache(1, 16), 3)
    assert gen.shape == (1, 3)


def test_prefill_then_decode_equals_longer_prefill(trees):
    """prefill(n+1)'s last logits == prefill(n) + decode_step(token n), with
    the tolerance of the reference's own test (test_models_smoke.py)."""
    _, storage = trees
    cfg = qwen2_5_3b.smoke_config()
    prefill, decode = make_serve_fns(tr, cfg)
    toks = torch.from_numpy(_tokens(S + 1, seed=3)).long()
    cache0 = tr.init_decode_state(cfg, B, MAX_LEN, dtype=torch.float32, device="cpu")
    _, la = prefill(storage, dict(tokens=toks), cache0)
    cache, _ = prefill(storage, dict(tokens=toks[:, :S]), cache0)
    _, lb = decode(storage, cache, toks[:, S:S + 1])
    assert not torch.isnan(lb).any()
    np.testing.assert_allclose(la.numpy(), lb.numpy(), rtol=5e-4, atol=5e-4)


def test_serve_cli_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen2.5-3b", "--smoke",
         "--device", "cpu", "--wire-roundtrip", "--batch", "2", "--prompt-len", "8",
         "--gen", "2"], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert '"swap_bit_identical": true' in proc.stdout
