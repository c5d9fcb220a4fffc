"""PyTorch port vs the JAX reference: one engine round over a heterogeneous
cohort (S1E3M7, S1E4M3 and f32 tiers with quotas 3, 2, 1), and the knobs
that must not change a round.

Gates, those of tests/test_engine.py: stratified cohorts and ledgers equal,
loss within 1e-3, decompressed trees within max |d| 6e-3 and mean |d| 1e-3
per leaf.  ``client_chunk`` and ``data_mode`` leave the port's round bit
for bit the same on the CPU (the cohort batched in one call or in blocks of
4; tests/test_torch_client_axis.py holds the widths to the reference's gate
as well).
"""

import jax
import numpy as np
import torch

from repro.core.omc import OMCConfig as JOMC
from repro.core.store import decompress_tree as jdecompress
from repro.federated import accounting as jaccounting
from repro.federated import engine as jengine
from repro.federated import simulate as jsimulate
from repro.federated.cohort import CohortPlan as JPlan
from repro.federated.state import compress_params as jcompress_params
from repro.models import conformer as jcf
from repro_torch import interop
from repro_torch.core import prng
from repro_torch.core.omc import OMCConfig
from repro_torch.core.store import trees_bit_equal
from repro_torch.federated import accounting, engine, simulate
from repro_torch.federated.cohort import CohortPlan
from repro_torch.federated.state import compress_params
from repro_torch.models import conformer as cf

from test_torch_engine import (CFG, JCFG, _decoded, _leaves, data, jdata)

torch.set_num_threads(1)

TIERS = ("s1e3m7", "s1e4m3", "f32")


def test_hetero_tier_round_matches_reference():
    jspec = jengine.CohortSpec(JPlan(num_clients=24, cohort_size=6),
                               tiers=tuple(jengine.profile(t) for t in TIERS), quotas=(3, 2, 1))
    spec = engine.CohortSpec(CohortPlan(num_clients=24, cohort_size=6),
                             tiers=tuple(engine.profile(t) for t in TIERS), quotas=(3, 2, 1))
    jomc, omc = JOMC.parse("S1E3M7"), OMCConfig.parse("S1E3M7")
    jspecs, specs = jcf.param_specs(JCFG), cf.param_specs(CFG)
    jp = jax.jit(lambda k: jcf.init(k, JCFG))(jax.random.PRNGKey(0))
    tp = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    jstorage, jm = jengine.run_round_vectorized(
        jcf, JCFG, jspecs, jomc, jsimulate.SimConfig(local_steps=1, client_lr=0.1),
        jcompress_params(jp, jspecs, jomc), jdata, jspec, 0, jax.random.PRNGKey(2),
        wire_table=jaccounting.build_wire_table(jp, jspecs, jomc))
    storage, m = engine.run_round_vectorized(
        cf, CFG, specs, omc, simulate.SimConfig(local_steps=1, client_lr=0.1),
        compress_params(tp, specs, omc), data, spec, 0, prng.PRNGKey(2),
        wire_table=accounting.build_wire_table(tp, specs, omc))
    for k in ("cohort", "dropped", "down_bytes", "up_bytes"):
        assert m[k] == jm[k], (k, m, jm)
    assert abs(m["loss"] - jm["loss"]) < 1e-3
    want = _leaves(jdecompress(jstorage))
    for path, x in _decoded(storage).items():
        d = np.abs(x - want[path])
        assert d.max() <= 6e-3 and d.mean() <= 1e-3, (path, d.max(), d.mean())


def test_client_chunk_and_data_mode_leave_the_round_unchanged():
    omc = OMCConfig.parse("S1E3M7")
    specs = cf.param_specs(CFG)
    params = cf.init(prng.PRNGKey(0), CFG)
    storage = compress_params(params, specs, omc)
    sim = simulate.SimConfig(local_steps=1, client_lr=0.1)
    out = []
    for chunk, mode in ((None, "vmap"), (4, "vmap"), (None, "host")):
        spec = engine.CohortSpec(CohortPlan(16, 8, failure_rate=0.25), client_chunk=chunk)
        out.append(engine.run_round_vectorized(cf, CFG, specs, omc, sim, storage, data, spec, 0,
                                               prng.PRNGKey(0), data_mode=mode))
    for tree, metrics in out[1:]:
        assert metrics == out[0][1]
        assert trees_bit_equal(tree, out[0][0])
