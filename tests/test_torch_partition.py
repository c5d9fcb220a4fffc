"""PyTorch port vs the JAX reference: the non-IID data path.

``prng.gamma`` / ``loggamma`` / ``dirichlet`` against ``jax.random``, the
partitioners of ``data/partition.py`` and ``make_partitioned_batch_fn``
against ``repro.data.partition`` (an engine round on their data is in
tests/test_torch_examples.py).

jax draws a gamma sample per element with a rejection loop (Marsaglia-Tsang,
``jax._src.random._gamma_one``).  A rejection decision that flipped would
send that element down another key chain and give a wholly different
sample, so the tests count those flips: ``jax_loggamma_iters`` restates
``_gamma_one`` in jax with a counter of its outer loop (its samples are
checked equal to ``jax.random.loggamma`` bit for bit, so it is jax's own
path) and every element's iteration count must equal the port's.  The gate
is 0 differing elements on these fixed samples (ROADMAP C3 records the
count).  Elsewhere the port differs from jax by the rounding of the f32
``log``/``log1p`` and of ``normal`` (ROADMAP C3):

  * ``loggamma``: within 16 ulp of ``max(|x|, 1)`` (5.7 measured);
  * ``gamma``: within ``16·eps·max(|log x|, 1)`` relative, the same bound
    carried through ``exp``;
  * ``dirichlet``: within ``16·eps·max(max|loggamma|, 1)`` relative, plus an
    absolute slack of the smallest normal f32 where the softmax underflows
    to subnormals, which XLA flushes to 0 and PyTorch keeps (ROADMAP C1;
    the alpha 0.01 and 0.05 cases hold 1820 and 65 such entries).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.data import partition as jpart
from repro.data.synthetic import make_frame_task as jmake_frame_task
from repro_torch.core import prng
from repro_torch.data import partition as tpart
from repro_torch.data.synthetic import make_frame_task

torch.set_num_threads(1)

EPS = float(np.finfo(np.float32).eps)
TINY = float(np.finfo(np.float32).tiny)
ULPS = 16
CASES = [(s, a, n) for s, (a, n) in enumerate(
    [(a, n) for n in (16, 4096) for a in (0.1, 0.3, 1.0, 2.5, 16.0)])]
SUBNORMAL_CASES = [(20, 0.01, 4096), (21, 0.05, 4096)]


@jax.jit
def jax_loggamma_iters(key, alpha):
    """``jax.random.loggamma(key, alpha)`` as ``_gamma_one`` computes it, with
    each element's count of outer-loop iterations."""

    def one(key, alpha):
        boost = alpha >= 1
        a = jnp.where(boost, alpha, alpha + 1)
        d = a - jnp.float32(1 / 3)
        c = jnp.float32(1 / 3) / jnp.sqrt(d)
        key, subkey = jax.random.split(key)

        def cond(s):
            _, X, V, U, _ = s
            return (U >= 1 - jnp.float32(0.0331) * (X * X)) & (
                jnp.log(U) >= X * 0.5 + d * ((1 - V) + jnp.log(V)))

        def inner(s):
            k, sk = jax.random.split(s[0])
            x = jax.random.normal(sk, ())
            return k, x, 1 + x * c

        def body(s):
            k, xk, uk = jax.random.split(s[0], 3)
            _, x, v = lax.while_loop(lambda t: t[2] <= 0, inner,
                                     (xk, jnp.float32(0), jnp.float32(-1)))
            return k, x * x, v * v * v, jax.random.uniform(uk, ()), s[4] + 1

        z = jnp.float32(0)
        _, _, V, _, n = lax.while_loop(cond, body, (key, z, jnp.float32(1), jnp.float32(2), 0))
        log_u = -jax.random.exponential(subkey, ())
        log_boost = jnp.where(boost | (log_u == 0), z, log_u * (1 / alpha))
        return jnp.log(d) + jnp.log(V) + log_boost, n

    return jax.vmap(one)(jax.random.split(key, alpha.shape[0]), alpha)


def _draws(seed, alpha, n):
    a = np.full((n,), alpha, np.float32)
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    ref_lg, ref_iters = jax_loggamma_iters(jk, jnp.asarray(a))
    want = dict(loggamma=np.asarray(jax.random.loggamma(jk, jnp.asarray(a))),
                gamma=np.asarray(jax.random.gamma(jk, jnp.asarray(a))),
                dirichlet=np.asarray(jax.random.dirichlet(jk, jnp.asarray(a))))
    # the restatement is jax's own path: the same bits as jax.random.loggamma
    np.testing.assert_array_equal(np.asarray(ref_lg), want["loggamma"])
    lg, iters = prng.loggamma(tk, torch.from_numpy(a), return_iterations=True)
    got = dict(loggamma=lg.numpy(), gamma=prng.gamma(tk, torch.from_numpy(a)).numpy(),
               dirichlet=prng.dirichlet(tk, torch.from_numpy(a)).numpy())
    flips = int((iters.numpy() != np.asarray(ref_iters)).sum())
    return want, got, flips


def _check_dirichlet(got, want, loggamma):
    scale = ULPS * EPS * max(float(np.abs(loggamma).max()), 1.0)
    err = np.abs(got.astype(np.float64) - want)
    assert np.all(err <= scale * want + TINY), (err / (want + TINY)).max()
    assert abs(float(got.astype(np.float64).sum()) - 1.0) < 1e-5


@pytest.mark.parametrize("seed, alpha, n", CASES)
def test_gamma_draws_match_jax_random(seed, alpha, n):
    want, got, flips = _draws(seed, alpha, n)
    assert flips == 0, f"{flips} of {n} elements took another rejection path"
    for k in got:
        assert got[k].shape == (n,) and got[k].dtype == np.float32
        assert np.isfinite(got[k]).all()
    wl = want["loggamma"].astype(np.float64)
    assert np.all(np.abs(got["loggamma"] - wl) <= ULPS * EPS * np.maximum(np.abs(wl), 1))
    wg = want["gamma"].astype(np.float64)
    rel = ULPS * EPS * np.maximum(np.abs(np.log(np.maximum(wg, TINY))), 1)
    assert np.all(np.abs(got["gamma"] - wg) <= rel * wg + TINY)
    _check_dirichlet(got["dirichlet"], want["dirichlet"].astype(np.float64), wl)


@pytest.mark.parametrize("seed, alpha, n", SUBNORMAL_CASES)
def test_dirichlet_underflow_to_subnormals(seed, alpha, n):
    want, got, flips = _draws(seed, alpha, n)
    assert flips == 0, f"{flips} of {n} elements took another rejection path"
    d, wd = got["dirichlet"], want["dirichlet"].astype(np.float64)
    assert (wd < TINY).sum() > 0 and (d < TINY).sum() > 0  # the case C1 covers
    _check_dirichlet(d, wd, want["loggamma"].astype(np.float64))


def test_exponential_and_batched_categorical_match_jax_random():
    jk, tk = jax.random.PRNGKey(3), prng.PRNGKey(3)
    want = np.asarray(jax.random.exponential(jk, (64, 33))).astype(np.float64)
    got = prng.exponential(tk, (64, 33)).numpy()
    assert np.all(np.abs(got - want) <= 4 * np.spacing(np.maximum(want, 1).astype(np.float32)))
    # categorical(shape=(B,)) on 1-d logits draws as on logits.expand(B, n)
    logits = np.log(np.random.default_rng(0).dirichlet(np.full(16, 0.3)) + 1e-9).astype(np.float32)
    want = np.asarray(jax.random.categorical(jk, jnp.asarray(logits), shape=(4096,)))
    got = prng.categorical(tk, torch.from_numpy(logits), shape=(4096,))
    assert got.shape == (4096,) and int((got.numpy() != want).sum()) == 0


PARTS = {
    "iid": (jpart.IIDPartition(), tpart.IIDPartition()),
    "dirichlet": (jpart.DirichletPartition(alpha=0.1), tpart.DirichletPartition(alpha=0.1)),
    "shard": (jpart.ShardPartition(2), tpart.ShardPartition(2)),
    "domain": (jpart.DomainPartition(2, jpart.DirichletPartition(0.3, seed=1)),
               tpart.DomainPartition(2, tpart.DirichletPartition(0.3, seed=1))),
}


@pytest.mark.parametrize("name", sorted(PARTS))
def test_source_weights_match_reference(name):
    jp, tp = PARTS[name]
    for c in range(8):
        want = np.asarray(jp.source_weights(jax.random.PRNGKey(7), c, 16))
        got = tp.source_weights(prng.PRNGKey(7), c, 16).numpy()
        assert got.shape == (16,) and got.dtype == np.float32
        assert tp.domain_of(c) == int(jp.domain_of(c))
        if name in ("iid", "shard"):  # bit for bit
            np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
        else:
            alpha = np.full((16,), tp.inner.alpha if name == "domain" else tp.alpha, np.float32)
            seed = tp.inner.seed if name == "domain" else tp.seed
            kc = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(7), seed), c)
            lg = np.asarray(jax.random.loggamma(kc, jnp.asarray(alpha))).astype(np.float64)
            _check_dirichlet(got, want.astype(np.float64), lg)
    if name == "shard":
        assert (got > 0).sum() == 2 and got.sum() == 1.0


def jax_sources(task, part, c, r, s, batch):
    """The reference's draw of a batch's sources (``partition.py:134-145``)."""
    k = jax.random.fold_in(jax.random.fold_in(
        jax.random.fold_in(jax.random.PRNGKey(task.seed + 6), c), r), s)
    _, ks = jax.random.split(k)
    w = part.source_weights(jax.random.PRNGKey(task.seed + 7), c, 16)
    return np.asarray(jax.random.categorical(ks, jnp.log(w + 1e-9), shape=(batch,)))


@pytest.mark.parametrize("name", sorted(PARTS))
def test_partitioned_batches_match_reference(name):
    jp, tp = PARTS[name]
    jtask = jmake_frame_task(d_in=8, n_classes=16, seq_len=24, num_clients=8)
    task = make_frame_task(d_in=8, n_classes=16, seq_len=24, num_clients=8, device="cpu")
    jfn = jpart.make_partitioned_batch_fn(jtask, jp, 4)
    fn = tpart.make_partitioned_batch_fn(task, tp, 4)
    flips = total = 0
    for c, r, s in [(0, 0, 0), (1, 0, 1), (5, 2, 0), (7, 3, 1)]:
        jb, b = jfn(c, r, s), fn(c, r, s)
        np.testing.assert_array_equal(fn.sources(c, r, s).numpy(),
                                      jax_sources(jtask, jp, c, r, s, 4))
        assert b["frames"].shape == (4, 24, 8) and b["labels"].dtype == torch.int32
        want = np.asarray(jb["frames"]).astype(np.float64)
        ulp = np.spacing(np.maximum(np.abs(want), 1).astype(np.float32))
        assert np.all(np.abs(b["frames"].numpy() - want) <= 4 * ulp)
        flips += int((b["labels"].numpy() != np.asarray(jb["labels"])).sum())
        total += b["labels"].numel()
    assert flips == 0, f"{flips} of {total} labels differ"
    if name == "shard":  # every drawn source is one of the client's two
        for c in range(8):
            held = set(torch.nonzero(fn.weights(c)).flatten().tolist())
            assert len(held) == 2 and set(fn.sources(c, 1, 0).tolist()) <= held
