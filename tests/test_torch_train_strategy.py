"""PyTorch port vs the JAX reference: training under the compression
strategies, on the loop, the engine and the async runtime (DESIGN.md §12).

The reference's test configuration (tests/test_train_strategy.py): the
conformer at 2 layers, d 32, from the reference's init carried across as
numpy; S1E3M7 with PPQ 0.9; cohort 8 of 16 with failure rate 0.25; 2
local steps at lr 0.1.  Gates:

  * ``strategy=get_strategy("omc")`` gives storage bit-identical to
    ``strategy=None``, with the same history and ledgers, on the loop, the
    engine and the async runtime (the reference's own gate);
  * top-k (density 0.25, error feedback), ternary and the pipeline, 2
    rounds of the loop against the reference's loop: cohorts and ledgers
    equal, losses within 1e-3, trees within 6e-3 max and 1e-3 mean per leaf
    (tests/test_torch_engine.py's gate), residuals within 1e-6 (the
    reference's gate) but for flips (ROADMAP C17): an f32 difference in a
    client's update can move an entry across the top-k threshold (its
    residual is then the whole value on one side) or across an S1E3M7
    rounding midpoint (the residuals one step apart); each such entry is
    checked to be a flip, and at most 2 a round are allowed (measured: 1, a
    midpoint, in the pipeline's second round, 0 elsewhere).  The
    second round starts from the reference's storage and residuals after
    the first: the two packages' re-compress can land one S1E3M7 step apart
    on a boundary element (the tree gate), and the selection turns such a
    step into many flips in the next round, so the residual gate is held
    round by round;
  * the port's engine against its loop under omc and top-k with error
    feedback (ternary and the pipeline share top-k's residual plumbing): the
    reference's loop-vs-engine gate (ledgers exact, trees, residuals within
    1e-6);
  * the async runtime's EF checkpoint resumes in the same bits and crosses
    packages both ways; a mismatch raises.
"""

import jax
import numpy as np
import pytest
import torch

from repro import checkpoint as jck
from repro.compress import feedback as jfeedback
from repro.compress import get_strategy as jget
from repro.core.omc import OMCConfig as JOMC
from repro.core.store import decompress_tree as jdecompress
from repro.data.synthetic import make_frame_task as jmake_frame_task
from repro.federated import accounting as jaccounting
from repro.federated import async_engine as jae
from repro.federated import simulate as jsimulate
from repro.federated import traces as jtraces
from repro.federated.cohort import CohortPlan as JPlan
from repro.federated.state import compress_params as jcompress_params
from repro.models import conformer as jcf
from repro_torch import checkpoint as ck
from repro_torch import interop
from repro_torch.compress import feedback, get_strategy
from repro_torch.core import prng
from repro_torch.core.omc import OMCConfig
from repro_torch.core.store import decompress_tree, trees_bit_equal
from repro_torch.core.tree import tree_items
from repro_torch.data.synthetic import make_frame_task
from repro_torch.federated import accounting, async_engine, engine, simulate, traces
from repro_torch.federated.cohort import CohortPlan
from repro_torch.federated.state import compress_params
from repro_torch.models import conformer as cf

torch.set_num_threads(1)

JCFG = jcf.ConformerConfig(n_layers=2, d_model=32, n_heads=4, d_ff=64, n_classes=16, d_in=8)
CFG = cf.ConformerConfig(**JCFG.__dict__)
OMC, JOMC_ = OMCConfig.parse("S1E3M7"), JOMC.parse("S1E3M7")
SIM = simulate.SimConfig(local_steps=2, client_lr=0.1)
JSIM = jsimulate.SimConfig(local_steps=2, client_lr=0.1)
PLAN, JPLAN_ = CohortPlan(16, 8, failure_rate=0.25), JPlan(16, 8, failure_rate=0.25)
TASK = make_frame_task(d_in=8, n_classes=16, seq_len=24, num_clients=16, device="cpu")
JTASK = jmake_frame_task(d_in=8, n_classes=16, seq_len=24, num_clients=16)
TREE_MAX, TREE_MEAN, RESID = 6e-3, 1e-3, 1e-6
FLIPS = 2  # C17: threshold flips allowed in a round against the reference (measured: 0-1)
SPARSE = {"topk": dict(density=0.25), "ternary": {}, "pipeline": {}}
C = 6  # the async degenerate trace: population == cohort == buffer goal


def data(c, r, s):
    return TASK.batch(c, r, s, 4)


def jdata(c, r, s):
    return JTASK.batch(c, r, s, 4)


@pytest.fixture(scope="module")
def init():
    jp = jax.jit(lambda k: jcf.init(k, JCFG))(jax.random.PRNGKey(0))
    return jp, jax.tree_util.tree_map(np.asarray, jp)


def _params(init):
    return interop.params_from_numpy(init[1], "cpu")


def _decoded(storage):
    return {"/".join(p): v.numpy() for p, v in tree_items(decompress_tree(storage))}


def _jdecoded(storage):
    return {"/".join(k.key for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jdecompress(storage))[0]}


def _assert_trees(a, b):
    assert sorted(a) == sorted(b)
    for k, x in a.items():
        d = np.abs(x - b[k])
        assert d.max() <= TREE_MAX and d.mean() <= TREE_MEAN, (k, d.max(), d.mean())


def _assert_metrics(m, jm):
    for k in ("cohort", "dropped", "down_bytes", "up_bytes"):
        assert m.get(k) == jm.get(k), (k, m, jm)
    assert abs(m["loss"] - jm["loss"]) < 1e-3, (m, jm)


def _assert_residuals(ef, jef, flips_allowed=0):
    """Every residual within RESID of the reference's, but for flips (ROADMAP
    C17): an entry one package kept and the other dropped at the top-k
    threshold (one residual at most the kept value's quantization error,
    2**-7 of it for S1E3M7 and 0 for f32, the other the whole value), or one
    rounded up and the other down at an S1E3M7 midpoint (the residuals one
    step apart, a power of two).  Returns the flips."""
    assert set(ef) == set(jef)
    flips = 0
    for k in ef:
        a, b = ef[k].numpy(), np.asarray(jef[k])
        off = np.abs(a - b) > RESID
        lo = np.minimum(np.abs(a[off]), np.abs(b[off]))
        hi = np.maximum(np.abs(a[off]), np.abs(b[off]))
        d = np.abs(a[off] - b[off]).astype(np.float64)
        step = 2.0 ** np.round(np.log2(d))
        assert np.all((lo <= hi * 2.0 ** -7) | (np.abs(d - step) <= RESID)), \
            (k, a[off], b[off])
        flips += int(off.sum())
    assert flips <= flips_allowed, flips
    return flips


# ---------------------------------------------------------------------------
# the gate: strategy="omc" is the hardcoded path, bit for bit
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def loops(init):
    """The port's 2-round loop with no strategy and with ``omc``, run once
    for the tests that read them."""
    return {None: _run("loop", init), "omc": _run("loop", init, strategy=get_strategy("omc"))}


def _run(path, init, **kw):
    key = prng.PRNGKey(0)
    if path == "loop":
        return simulate.run_training(cf, CFG, OMC, SIM, PLAN, data, key, 2, eval_every=100,
                                     init_params=_params(init), wire=True, **kw)
    if path == "engine":
        return engine.run_training_vectorized(cf, CFG, OMC, SIM, engine.CohortSpec(PLAN), data,
                                              key, 2, eval_every=100,
                                              init_params=_params(init), **kw)
    st, hist, runner = async_engine.run_async_training(
        cf, CFG, OMC, SIM, async_engine.AsyncConfig(buffer_goal=C),
        traces.FixedTrace(latency=1.0), data, key, num_clients=C, flushes=2,
        init_params=_params(init), **kw)
    return st, (hist, runner.stats.snapshot())


@pytest.mark.parametrize("path", ["loop", "engine", "async"])
def test_omc_strategy_is_bit_identical_to_none(init, loops, path):
    if path == "loop":
        (base, hist0), (strat, hist1) = loops[None], loops["omc"]
    else:
        base, hist0 = _run(path, init)
        strat, hist1 = _run(path, init, strategy=get_strategy("omc"))
    assert hist0 == hist1
    assert trees_bit_equal(base, strat)


# ---------------------------------------------------------------------------
# the zoo against the reference's loop, round by round
# ---------------------------------------------------------------------------


def _jax_two_rounds(jp, name):
    """The reference's loop (``run_round`` as ``run_training`` calls it):
    the storage, metrics and residuals after each of 2 rounds."""
    strategy = jget(name, **SPARSE[name])
    specs = jcf.param_specs(JCFG)
    wire = name != "pipeline"
    table = jaccounting.build_wire_table(jp, specs, JOMC_) if wire else None
    ef = jfeedback.init_ef_state(jp, specs, JOMC_, 16)
    cu = jsimulate.make_client_update(jcf, JCFG, specs, JOMC_, JSIM, strategy)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0xC047)
    storage, out = jcompress_params(jp, specs, JOMC_), []
    for r in range(2):
        storage, m = jsimulate.run_round(jcf, JCFG, specs, JOMC_, JSIM, storage, jdata, JPLAN_,
                                         r, key, client_update=cu, wire_table=table,
                                         strategy=strategy, ef=ef)
        out.append((storage, m, dict(ef)))
    return out


@pytest.mark.parametrize("name", sorted(SPARSE))
def test_sparse_strategy_loop_matches_reference(init, name):
    ref = _jax_two_rounds(init[0], name)
    strategy = get_strategy(name, **SPARSE[name])
    params = _params(init)
    specs = cf.param_specs(CFG)
    table = accounting.build_wire_table(params, specs, OMC) if name != "pipeline" else None
    key = prng.fold_in(prng.PRNGKey(0), 0xC047)

    def round_(storage, r, ef):
        return simulate.run_round(cf, CFG, specs, OMC, SIM, storage, data, PLAN, r, key,
                                  wire_table=table, strategy=strategy, ef=ef)

    ef = feedback.init_ef_state(params, specs, OMC, 16)
    st1, m1 = round_(compress_params(params, specs, OMC), 0, ef)
    _assert_metrics(m1, ref[0][1])
    _assert_residuals(ef, ref[0][2], FLIPS)
    _assert_trees(_decoded(st1), _jdecoded(ref[0][0]))
    # round 2 from the reference's state after round 1: residuals to the gate
    ef_ref = {k: torch.from_numpy(np.array(v)) for k, v in ref[0][2].items()}
    st2, m2 = round_(interop.storage_from_numpy(ref[0][0], "cpu"), 1, ef_ref)
    _assert_metrics(m2, ref[1][1])
    _assert_residuals(ef_ref, ref[1][2], FLIPS)
    _assert_trees(_decoded(st2), _jdecoded(ref[1][0]))


# ---------------------------------------------------------------------------
# the port's engine against its loop (the reference's own gate)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["omc", "topk"])
def test_engine_matches_loop_under_each_strategy(init, loops, name):
    strategy = get_strategy(name, **SPARSE.get(name, {}))
    takes_ef = feedback.takes_residual(OMC, strategy)
    params = _params(init)
    efs = [feedback.init_ef_state(params, cf.param_specs(CFG), OMC, 16) if takes_ef else None
           for _ in range(2)]
    if name in loops:
        loop, hist_l = loops[name]
    else:
        loop, hist_l = simulate.run_training(cf, CFG, OMC, SIM, PLAN, data, prng.PRNGKey(0), 2,
                                             eval_every=100, init_params=params, wire=True,
                                             strategy=strategy, ef=efs[0])
    eng, hist_e = engine.run_training_vectorized(
        cf, CFG, OMC, SIM, engine.CohortSpec(PLAN), data, prng.PRNGKey(0), 2, eval_every=100,
        init_params=_params(init), wire=True, strategy=strategy, ef=efs[1])
    for rl, re in zip(hist_l, hist_e):
        for k in ("cohort", "dropped", "down_bytes", "up_bytes"):
            assert rl.get(k) == re.get(k)
        assert abs(rl["loss"] - re["loss"]) < 1e-3
    _assert_trees(_decoded(loop), _decoded(eng))
    if takes_ef:
        _assert_residuals(efs[0], {k: v.numpy() for k, v in efs[1].items()})
        assert feedback.total_norm(efs[1]) > 0


def test_wire_and_ef_refusals_match_reference(init):
    params = _params(init)
    specs = cf.param_specs(CFG)
    storage = compress_params(params, specs, OMC)
    with pytest.raises(ValueError, match="data-dependent"):
        _run("loop", init, strategy=get_strategy("pipeline"))
    with pytest.raises(ValueError, match="data-dependent"):
        _run("engine", init, strategy=get_strategy("pipeline"))
    with pytest.raises(ValueError, match="error feedback"):
        simulate.run_round(cf, CFG, specs, OMC, SIM, storage, data, PLAN, 0, prng.PRNGKey(0),
                           strategy=get_strategy("topk"), ef=None)
    with pytest.raises(ValueError, match="error feedback"):
        engine.run_round_vectorized(cf, CFG, specs, OMC, SIM, storage, data,
                                    engine.CohortSpec(PLAN), 0, prng.PRNGKey(0),
                                    strategy=get_strategy("topk"))
    with pytest.raises(ValueError, match="no compression strategy"):
        _run("engine", init, strategy=get_strategy("omc"), fused_agg=True)
    with pytest.raises(ValueError, match="no zoo strategy"):
        _run("async", init, strategy=get_strategy("topk"), fused_agg=True)
    assert not engine.fused_aggregation_supported(engine.CohortSpec(PLAN), OMC,
                                                  get_strategy("omc"))


def test_sparse_upload_is_cheaper_than_dense_and_downloads_are_at_rest(init, loops):
    """The reference's ledger check: top-k at 5% uploads fewer bytes than the
    dense plan, and an upload-only strategy downloads the at-rest state."""
    _, h_omc = loops[None]
    _, h_topk = _run("loop", init, strategy=get_strategy("topk", density=0.05))
    assert h_topk[0]["up_bytes"] < h_omc[0]["up_bytes"]
    assert h_topk[0]["down_bytes"] == h_omc[0]["down_bytes"]


# ---------------------------------------------------------------------------
# the async runtime's residuals and their checkpoint
# ---------------------------------------------------------------------------


def _runner(init, strategy=None, fused=False):
    return async_engine.AsyncRunner(cf, CFG, OMC, SIM, async_engine.AsyncConfig(buffer_goal=C),
                                    traces.FixedTrace(latency=1.0), num_clients=C,
                                    data_fn=data, init_params=_params(init),
                                    strategy=strategy, fused_agg=fused)


def test_async_ef_checkpoint_resumes_in_the_same_bits(init, tmp_path):
    topk = get_strategy("topk", density=0.25)
    ref = _runner(init, topk)
    ref.run_until(flushes=1)
    ref.run_until(uploads=2)  # mid-buffer: two uploads wait for the next flush
    path = ck.save_async_state(str(tmp_path), ref)
    ref.run_until(flushes=1)
    res = _runner(init, topk)
    ck.restore_async_state(path, res)
    res.run_until(flushes=1)
    assert trees_bit_equal(ref.storage, res.storage)
    assert set(ref.ef) == set(res.ef) and feedback.total_norm(ref.ef) > 0
    for k in ref.ef:
        assert torch.equal(ref.ef[k], res.ef[k])
    assert ref.stats.snapshot() == res.stats.snapshot() and ref.history == res.history
    with pytest.raises(ValueError, match="error-feedback state mismatch"):
        ck.restore_async_state(path, _runner(init))  # no strategy: no residuals
    plain = ck.save_async_state(str(tmp_path / "plain"), _runner(init))
    with pytest.raises(ValueError, match="error-feedback state mismatch"):
        ck.restore_async_state(plain, _runner(init, topk))


def test_async_ef_checkpoint_crosses_packages(init, tmp_path):
    """The port's EF checkpoint restores into the reference's runner and the
    reference's into the port's: storage and residuals the same bits."""
    topk, jtopk = get_strategy("topk", density=0.25), jget("topk", density=0.25)
    runner = _runner(init, topk)
    runner.run_until(flushes=1)
    runner.run_until(uploads=2)
    path = ck.save_async_state(str(tmp_path / "port"), runner)
    jrunner = jae.AsyncRunner(jcf, JCFG, JOMC_, JSIM, jae.AsyncConfig(buffer_goal=C),
                              jtraces.FixedTrace(latency=1.0), num_clients=C, data_fn=jdata,
                              init_params=init[0], strategy=jtopk)
    jck.restore_async_state(path, jrunner)
    for k in runner.ef:
        np.testing.assert_array_equal(np.asarray(jrunner.ef[k]), runner.ef[k].numpy())
    assert jrunner.stats.snapshot() == runner.stats.snapshot()
    back = jck.save_async_state(str(tmp_path / "ref"), jrunner)
    fresh = _runner(init, topk)
    ck.restore_async_state(back, fresh)
    assert trees_bit_equal(fresh.storage, runner.storage)
    for k in runner.ef:
        assert torch.equal(fresh.ef[k], runner.ef[k])
    assert [(e.client_id, e.base_version) for e in fresh.buffer] == \
        [(e.client_id, e.base_version) for e in runner.buffer]
