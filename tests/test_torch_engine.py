"""PyTorch port vs the JAX reference: federated training through the engine
and the loop, unfused server round.

Both packages train the conformer of tests/test_engine.py (2 layers, d 32)
from one init (the reference's, carried across as numpy) on the synthetic
frame task, cohort 8 of 16 with failure rate 0.25, S1E3M7 with PPQ 0.9,
2 rounds of 2 local steps.  Gates, those of tests/test_engine.py:
cohort, drop count and wire ledgers equal; losses within 1e-3; decompressed
server trees within max |d| 6e-3 (one S1E3M7 step on a boundary element)
and mean |d| 1e-3 per leaf.  The PPQ masks, cohorts and survival masks are
bit-exact (tests/test_torch_prng.py), so any difference is f32 arithmetic.
The last test holds one round on Dirichlet(0.1) data (``data/partition.py``)
to the same gate; it runs after the reference's first engine run in this
module, whose compiled eager ops it reuses.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core.omc import OMCConfig as JOMC
from repro.core.store import decompress_tree as jdecompress
from repro.data import partition as jpart
from repro.data.synthetic import make_frame_task as jmake_frame_task
from repro.federated import accounting as jaccounting
from repro.federated import engine as jengine
from repro.federated import simulate as jsimulate
from repro.federated.cohort import CohortPlan as JPlan
from repro.models import conformer as jcf
from repro_torch import interop
from repro_torch.core import prng
from repro_torch.core.omc import OMCConfig
from repro_torch.core.store import decompress_tree, is_compressed
from repro_torch.core.tree import tree_items
from repro_torch.data import partition as tpart
from repro_torch.data.synthetic import make_frame_task
from repro_torch.federated import accounting, engine, simulate
from repro_torch.federated.cohort import CohortPlan
from repro_torch.kernels import ops
from repro_torch.models import conformer as cf

torch.set_num_threads(1)

JCFG = jcf.ConformerConfig(n_layers=2, d_model=32, n_heads=4, d_ff=64, n_classes=16, d_in=8)
CFG = cf.ConformerConfig(**JCFG.__dict__)
JTASK = jmake_frame_task(d_in=8, n_classes=16, seq_len=24, num_clients=16)
TASK = make_frame_task(d_in=8, n_classes=16, seq_len=24, num_clients=16, device="cpu")
ROUNDS = 2


def jdata(c, r, s):
    return JTASK.batch(c, r, s, 4)


def data(c, r, s):
    return TASK.batch(c, r, s, 4)


def jsim():
    return jsimulate.SimConfig(local_steps=2, client_lr=0.1)


def sim():
    return simulate.SimConfig(local_steps=2, client_lr=0.1)


@pytest.fixture(scope="module")
def init():
    jp = jax.jit(lambda k: jcf.init(k, JCFG))(jax.random.PRNGKey(0))
    return jp, jax.tree_util.tree_map(np.asarray, jp)


def torch_params(init):
    return interop.params_from_numpy(init[1], "cpu")


def _leaves(tree):
    return {tuple(k.key for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_same_training(hist_a, hist_b, tree_a, tree_b):
    """The gate of tests/test_engine.py; trees are decoded f32 leaf dicts."""
    assert len(hist_a) == len(hist_b) == ROUNDS
    for a, b in zip(hist_a, hist_b):
        for k in ("cohort", "dropped", "down_bytes", "up_bytes"):
            assert a[k] == b[k], (k, a, b)
        assert abs(a["loss"] - b["loss"]) < 1e-3, (a, b)
    assert sorted(tree_a) == sorted(tree_b)
    for path, x in tree_a.items():
        d = np.abs(x - tree_b[path])
        assert d.max() <= 6e-3, (path, d.max())
        assert d.mean() <= 1e-3, (path, d.mean())


@pytest.fixture(scope="module")
def jax_unfused(init):
    storage, hist = jengine.run_training_vectorized(
        jcf, JCFG, JOMC.parse("S1E3M7"), jsim(),
        jengine.CohortSpec(JPlan(16, 8, failure_rate=0.25)), jdata, jax.random.PRNGKey(0),
        num_rounds=ROUNDS, eval_every=100, init_params=init[0])
    return _leaves(jdecompress(storage)), hist


@pytest.fixture(scope="module")
def port_unfused(init):
    ops.reset_launch_counts()
    storage, hist = engine.run_training_vectorized(
        cf, CFG, OMCConfig.parse("S1E3M7"), sim(),
        engine.CohortSpec(CohortPlan(16, 8, failure_rate=0.25)), data, prng.PRNGKey(0),
        num_rounds=ROUNDS, eval_every=100, init_params=torch_params(init))
    counts = ops.launch_counts()
    return storage, hist, counts


def _decoded(storage):
    return {p: v.numpy() for p, v in tree_items(decompress_tree(storage))}


def test_engine_matches_reference_engine(jax_unfused, port_unfused):
    storage, hist, counts = port_unfused
    assert_same_training(hist, jax_unfused[1], _decoded(storage), jax_unfused[0])
    # the server half ran decode and re-compress, no code-domain aggregate
    assert counts.get("quantize_stats.ref", 0) > 0 and counts.get("dequantize.ref", 0) > 0
    assert "fused_aggregate.ref" not in counts
    assert sum(is_compressed(v) for _, v in tree_items(storage)) == 13


def test_loop_matches_engine(init, port_unfused):
    """The port's paper loop against the port's engine: the reference's own
    loop-vs-engine gate."""
    storage, hist = simulate.run_training(
        cf, CFG, OMCConfig.parse("S1E3M7"), sim(), CohortPlan(16, 8, failure_rate=0.25), data,
        prng.PRNGKey(0), num_rounds=ROUNDS, eval_every=100, init_params=torch_params(init),
        wire=True)
    assert_same_training(hist, port_unfused[1], _decoded(storage), _decoded(port_unfused[0]))


def test_wire_table_and_upload_ledger_match_reference(init):
    jspecs, specs = jcf.param_specs(JCFG), cf.param_specs(CFG)
    for name, frac, pvt in (("S1E3M7", 0.9, True), ("S1E4M14", 0.5, False), ("S1E2M3", 1.0, True)):
        jomc, omc = JOMC.parse(name, quantize_fraction=frac, pvt=pvt), OMCConfig.parse(
            name, quantize_fraction=frac, pvt=pvt)
        jt = jaccounting.build_wire_table(init[0], jspecs, jomc)
        t = accounting.build_wire_table(torch_params(init), specs, omc)
        assert t == accounting.WireTable(jt.names, jt.n_elems, jt.stack_entries, jt.raw_bytes)
        assert t.download_bytes(omc) == jt.download_bytes(jomc)
        assert accounting.download_bytes_train(t, omc) == jaccounting.download_bytes_train(
            jt, jomc, None)
        ids = [0, 3, 7, 15, 9]
        for r in range(3):
            np.testing.assert_array_equal(
                accounting.cohort_upload_bytes(t, omc, r, ids),
                jaccounting.cohort_upload_bytes(jt, jomc, r, np.asarray(ids, np.int32)))
            assert (accounting.client_upload_bytes(t, omc, r, 9)
                    == jaccounting.client_upload_bytes(jt, jomc, r, 9))


def test_masked_upload_tree_matches_reference(init):
    """One client's transport payload: the same variables compressed, the
    same codes; (s, b) within tests/test_torch_store.py's bounds."""
    jspecs, specs = jcf.param_specs(JCFG), cf.param_specs(CFG)
    jomc, omc = JOMC.parse("S1E3M7"), OMCConfig.parse("S1E3M7")
    want = dict((tuple(k.key for k in p), v) for p, v in jax.tree_util.tree_flatten_with_path(
        jengine.masked_upload_tree(init[0], jspecs, jomc, 1, 5),
        is_leaf=lambda x: hasattr(x, "codes"))[0])
    got = dict(tree_items(engine.masked_upload_tree(torch_params(init), specs, omc, 1, 5)))
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        assert is_compressed(leaf) == hasattr(want[path], "codes"), path
        if is_compressed(leaf):
            np.testing.assert_array_equal(leaf.codes.numpy(), np.asarray(want[path].codes))
            np.testing.assert_allclose(leaf.s.numpy(), np.asarray(want[path].s), rtol=1e-4)
            np.testing.assert_allclose(leaf.b.numpy(), np.asarray(want[path].b), atol=1e-5)
        else:
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(want[path]))


def test_engine_round_on_dirichlet_data_matches_reference(init):
    """cohort 8 of 16, failure rate 0.25, S1E3M7, 2 local steps, 1 round."""
    jstorage, jhist = jengine.run_training_vectorized(
        jcf, JCFG, JOMC.parse("S1E3M7"), jsim(),
        jengine.CohortSpec(JPlan(16, 8, failure_rate=0.25)),
        jpart.make_partitioned_batch_fn(JTASK, jpart.DirichletPartition(alpha=0.1), 4),
        jax.random.PRNGKey(0), num_rounds=1, eval_every=100, init_params=init[0])
    storage, hist = engine.run_training_vectorized(
        cf, CFG, OMCConfig.parse("S1E3M7"), sim(),
        engine.CohortSpec(CohortPlan(16, 8, failure_rate=0.25)),
        tpart.make_partitioned_batch_fn(TASK, tpart.DirichletPartition(alpha=0.1), 4),
        prng.PRNGKey(0), num_rounds=1, eval_every=100, init_params=torch_params(init))
    for k in ("round", "cohort", "dropped", "down_bytes", "up_bytes"):
        assert hist[0][k] == jhist[0][k], (k, hist, jhist)
    assert abs(hist[0]["loss"] - jhist[0]["loss"]) < 1e-3, (hist, jhist)
    want = _leaves(jdecompress(jstorage))
    got = _decoded(storage)
    assert sorted(got) == sorted(want)
    for path, x in got.items():
        d = np.abs(x - want[path])
        assert d.max() <= 6e-3 and d.mean() <= 1e-3, (path, d.max(), d.mean())
