"""PyTorch port vs the JAX reference: the threefry stream and what is drawn from it.

``repro_torch.core.prng`` reproduces ``jax.random`` (threefry2x32 with
``jax_threefry_partitionable`` on, jax 0.9).  Tolerances: key derivation
(``PRNGKey``, ``fold_in``, ``split``), ``bits``, ``uniform`` and
``permutation`` are bit-exact, and so are the cohorts, survival masks,
tiered cohorts and PPQ masks drawn from them; ``normal`` is within 4 ulp
(XLA's ``erf_inv`` polynomial and fused multiply-adds, but another
``log1p``; 3 ulp measured).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.partial import ppq_mask as jppq_mask
from repro.core.partial import ppq_masks_batch as jppq_masks_batch
from repro.federated import cohort as jcohort
from repro.federated import engine as jengine
from repro_torch.core import prng
from repro_torch.core.partial import num_selected, ppq_mask, ppq_masks_batch
from repro_torch.federated import cohort, engine

torch.set_num_threads(1)

SEEDS = [0, 7, 1729, 2**31 - 1]


def _key(k):
    return tuple(int(v) for v in np.asarray(k))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_derivation_is_bit_exact(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    assert _key(jk) == tk
    for data in (0, 1, 0xC047, 0x57A6, 2**31 - 1):
        jk, tk = jax.random.fold_in(jk, data), prng.fold_in(tk, data)  # a chain of folds
        assert _key(jk) == tk
    for num in (1, 2, 5):
        assert [_key(k) for k in jax.random.split(jk, num)] == prng.split(tk, num)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(), (1,), (7,), (3, 5), (2, 3, 33)], ids=str)
def test_bits_and_uniform_are_bit_exact(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    want = np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(prng.bits(tk, shape).numpy(), want)
    for lo, hi in ((0.0, 1.0), (-2.5, 3.0)):
        want = np.asarray(jax.random.uniform(jk, shape, jnp.float32, lo, hi))
        got = prng.uniform(tk, shape, None, lo, hi).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 2, 13, 16, 100, 1000])
def test_permutation_is_bit_exact(seed, n):
    k = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    got = prng.permutation(prng.fold_in(prng.PRNGKey(seed), 3), n).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.random.permutation(k, n)))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_four_ulp(seed):
    shape = (64, 1001)
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    got = prng.normal(prng.PRNGKey(seed), shape).numpy()
    ulp = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert np.sign(got).tolist() == np.sign(want).tolist()
    assert ulp.max() <= 4, ulp.max()


PLANS = [
    jcohort.CohortPlan(num_clients=16, cohort_size=8, failure_rate=0.0),
    jcohort.CohortPlan(num_clients=16, cohort_size=8, failure_rate=0.25),
    jcohort.CohortPlan(num_clients=16, cohort_size=8, failure_rate=1.0),
    jcohort.CohortPlan(num_clients=37, cohort_size=11, failure_rate=0.25, straggler_rate=0.3),
    jcohort.CohortPlan(num_clients=12, cohort_size=12, report_goal=7, failure_rate=0.1),
]


@pytest.mark.parametrize("jplan", PLANS, ids=lambda p: f"{p.num_clients}-{p.cohort_size}-"
                         f"f{p.failure_rate}-s{p.straggler_rate}-g{p.report_goal}")
def test_cohort_and_survival_are_bit_exact(jplan):
    plan = cohort.CohortPlan(jplan.num_clients, jplan.cohort_size, jplan.report_goal,
                             jplan.failure_rate, jplan.straggler_rate)
    jkey = jax.random.fold_in(jax.random.PRNGKey(0), 0xC047)
    key = prng.fold_in(prng.PRNGKey(0), 0xC047)
    for r in range(6):
        np.testing.assert_array_equal(cohort.sample_cohort(key, plan, r).numpy(),
                                      np.asarray(jcohort.sample_cohort(jkey, jplan, r)))
        alive = cohort.survival_mask(key, plan, r).numpy()
        np.testing.assert_array_equal(alive, np.asarray(jcohort.survival_mask(jkey, jplan, r)))
        assert alive.sum() >= 1


def test_tiered_cohort_is_bit_exact():
    jspec = jengine.CohortSpec(jcohort.CohortPlan(num_clients=20, cohort_size=9),
                               tiers=(jengine.profile("s1e3m7"), jengine.profile("f32"),
                                      jengine.profile("s1e4m3")))
    spec = engine.CohortSpec(cohort.CohortPlan(num_clients=20, cohort_size=9),
                             tiers=(engine.profile("s1e3m7"), engine.profile("f32"),
                                    engine.profile("s1e4m3")))
    assert spec.quotas == jspec.quotas
    jkey, key = jax.random.PRNGKey(5), prng.PRNGKey(5)
    for r in range(4):
        got = engine.sample_tiered_cohort(key, spec, r)
        want = jengine.sample_tiered_cohort(jkey, jspec, r)
        assert [g.tolist() for g in got] == [np.asarray(w).tolist() for w in want]
    homo = engine.CohortSpec(cohort.CohortPlan(16, 8))
    jhomo = jengine.CohortSpec(jcohort.CohortPlan(16, 8))
    assert (engine.sample_tiered_cohort(key, homo, 3)[0].tolist()
            == np.asarray(jengine.sample_tiered_cohort(jkey, jhomo, 3)[0]).tolist())


@pytest.mark.parametrize("num_vars,fraction", [(13, 0.9), (13, 0.5), (1, 0.9), (40, 0.25),
                                               (13, 1.0), (13, 0.0)])
def test_ppq_masks_are_bit_exact(num_vars, fraction):
    jkey, key = jax.random.PRNGKey(1729), prng.PRNGKey(1729)
    for r in range(3):
        for c in (0, 5, 15, 1000):
            got = ppq_mask(key, r, c, num_vars, fraction).numpy()
            np.testing.assert_array_equal(got, np.asarray(jppq_mask(jkey, r, c, num_vars,
                                                                    fraction)))
            if 0 < fraction < 1:
                assert got.sum() == num_selected(num_vars, fraction)
        ids = [3, 1, 4, 15]
        np.testing.assert_array_equal(
            ppq_masks_batch(key, r, ids, num_vars, fraction).numpy(),
            np.asarray(jppq_masks_batch(jkey, r, jnp.asarray(ids), num_vars, fraction)))
