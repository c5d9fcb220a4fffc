"""PyTorch port vs the JAX reference: the asynchronous runtime.

Both packages run the conformer of tests/test_torch_engine.py (2 layers,
d 32) from one init (the reference's, carried across as numpy), on the
synthetic frame task (16 frames, batch 4, 1 local step at lr 0.1), S1E3M7
with PVT and PPQ 0.9.  Three reference runs in all (module fixtures):

  * the degenerate trace: 6 clients, ``buffer_goal`` 6, ``FixedTrace``, decay
    0, 2 flushes — against the reference's async and the port's engine
    (cohort 6 of 6): history and ``AsyncWireStats`` equal (losses within
    rtol 1e-4), trees within 6e-3 max and 1e-4 mean per leaf
    (tests/test_async_engine.py's gate);
  * the straggler trace: 10 clients, ``buffer_goal`` 4,
    ``ParetoTrace(alpha=1.5)``, poly decay 0.5, ``max_staleness`` 1 (which
    drops 3 uploads), 3 flushes, unfused and fused: every event record,
    the staleness and drop counts and every ledger field equal, losses
    within rtol 1e-4, trees within 6e-3 / 1e-4 (unfused) and within the
    reference's fused gate, 4 S1E3M7 steps max and 1 step mean at each
    leaf's scale (fused).  The unfused reference run writes a mid-buffer
    checkpoint that the port restores.

The schedules are exact: traces draw from numpy as the reference's do.  The
staleness weights are exact at decay 0 and otherwise within 2 ulp of the
log weight, relative, where the reference's are normal; XLA on the CPU
flushes the subnormal ones to 0 (ROADMAP C1, C13).
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.core.omc import OMCConfig as JOMC
from repro.core.store import decompress_tree as jdecompress
from repro.data.synthetic import make_frame_task as jmake_frame_task
from repro import checkpoint as jck
from repro.federated import accounting as jaccounting
from repro.federated import async_engine as jae
from repro.federated import cohort as jcohort
from repro.federated import simulate as jsimulate
from repro.federated import traces as jtraces
from repro.federated import engine as jengine
from repro.models import conformer as jcf
from repro_torch import checkpoint as ck
from repro_torch import interop
from repro_torch.core import prng
from repro_torch.core.omc import OMCConfig
from repro_torch.core.store import decompress_tree, is_compressed, trees_bit_equal
from repro_torch.core.tree import tree_items
from repro_torch.data.synthetic import make_frame_task
from repro_torch.federated import accounting, async_engine, cohort, engine, simulate, traces
from repro_torch.kernels import ops
from repro_torch.models import conformer as cf
from repro_torch.scale import PopulationStore, ShardLayout

torch.set_num_threads(1)

JCFG = jcf.ConformerConfig(n_layers=2, d_model=32, n_heads=4, d_ff=64, n_classes=16, d_in=8)
CFG = cf.ConformerConfig(**JCFG.__dict__)
JTASK = jmake_frame_task(d_in=8, n_classes=16, seq_len=16, num_clients=64)
TASK = make_frame_task(d_in=8, n_classes=16, seq_len=16, num_clients=64, device="cpu")
FMT = "S1E3M7"
DEGENERATE = dict(clients=6, flushes=2)
STRAGGLER = dict(clients=10, goal=4, decay=0.5, max_staleness=1, flushes=3)
TREE_MAX, TREE_MEAN = 6e-3, 1e-4  # tests/test_async_engine.py's degenerate gate


def jdata(c, r, s):
    return JTASK.batch(c, r, s, 4)


def data(c, r, s):
    return TASK.batch(c, r, s, 4)


def jsim():
    return jsimulate.SimConfig(local_steps=1, client_lr=0.1)


def sim():
    return simulate.SimConfig(local_steps=1, client_lr=0.1)


@pytest.fixture(scope="module")
def init():
    jp = jax.jit(lambda k: jcf.init(k, JCFG))(jax.random.PRNGKey(0))
    return jp, jax.tree_util.tree_map(np.asarray, jp)


def torch_params(init):
    return interop.params_from_numpy(init[1], "cpu")


def _jleaves(tree):
    return {tuple(k.key for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _decoded(storage):
    return {p: v.numpy() for p, v in tree_items(decompress_tree(storage))}


def _straggler_cfgs(engine_mod, traces_mod):
    return (engine_mod.AsyncConfig(buffer_goal=STRAGGLER["goal"], decay=STRAGGLER["decay"],
                                   max_staleness=STRAGGLER["max_staleness"]),
            traces_mod.ParetoTrace(seed=0, latency=1.0, alpha=1.5))


def _save_point(runner) -> bool:
    """The mid-buffer save point: after the first flush, with buffered
    uploads and a trained-but-not-uploaded cache."""
    return runner.version == 1 and bool(runner.buffer) and bool(runner.trained)


def _drive(runner, flushes, ckpt_dir=None, ckpt_mod=ck):
    """Step ``runner`` to ``flushes`` flushes, recording every event; with
    ``ckpt_dir``, save an async checkpoint (``ckpt_mod``'s) at the mid-buffer
    save point."""
    events, saved = [], None
    while runner.version < flushes:
        events.append(runner.step())
        if ckpt_dir is not None and saved is None and _save_point(runner):
            saved = ckpt_mod.save_async_state(str(ckpt_dir), runner)
    return events, saved


def port_runner(init, fused=False, **kw):
    acfg, trace = _straggler_cfgs(async_engine, traces)
    return async_engine.AsyncRunner(cf, CFG, OMCConfig.parse(FMT), sim(), acfg, trace,
                                    num_clients=STRAGGLER["clients"], data_fn=data,
                                    init_params=torch_params(init), fused_agg=fused, **kw)


def jax_runner(init, fused=False):
    acfg, trace = _straggler_cfgs(jae, jtraces)
    return jae.AsyncRunner(jcf, JCFG, JOMC.parse(FMT), jsim(), acfg, trace,
                           num_clients=STRAGGLER["clients"], data_fn=jdata,
                           init_params=init[0], fused_agg=fused)


# ---------------------------------------------------------------------------
# Reference runs (three in all) and the port's counterparts
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_degenerate(init):
    c = DEGENERATE["clients"]
    runner = jae.AsyncRunner(jcf, JCFG, JOMC.parse(FMT), jsim(), jae.AsyncConfig(buffer_goal=c),
                             jtraces.FixedTrace(latency=1.0), num_clients=c, data_fn=jdata,
                             init_params=init[0])
    runner.run_until(flushes=DEGENERATE["flushes"])
    return _jleaves(jdecompress(runner.storage)), runner.history


@pytest.fixture(scope="module")
def port_degenerate(init):
    c = DEGENERATE["clients"]
    storage, hist, runner = async_engine.run_async_training(
        cf, CFG, OMCConfig.parse(FMT), sim(), async_engine.AsyncConfig(buffer_goal=c),
        traces.FixedTrace(latency=1.0), data, None, num_clients=c,
        flushes=DEGENERATE["flushes"], init_params=torch_params(init))
    return storage, hist, runner


@pytest.fixture(scope="module")
def jax_straggler(init, tmp_path_factory):
    out = {}
    for fused in (False, True):
        runner = jax_runner(init, fused)
        ckpt_dir = None if fused else tmp_path_factory.mktemp("jax_async")
        events, saved = _drive(runner, STRAGGLER["flushes"], ckpt_dir, jck)
        out[fused] = dict(events=events, history=runner.history, saved=saved,
                          tree=_jleaves(jdecompress(runner.storage)))
    return out


@pytest.fixture(scope="module")
def port_straggler(init, tmp_path_factory):
    out = {}
    for fused in (False, True):
        runner = port_runner(init, fused)
        ops.reset_launch_counts()
        events, saved = _drive(runner, STRAGGLER["flushes"],
                               tmp_path_factory.mktemp(f"port_async_{fused}"))
        out[fused] = dict(events=events, history=runner.history, saved=saved,
                          runner=runner, counts=ops.launch_counts())
    return out


def assert_same_history(hist, jhist):
    assert len(hist) == len(jhist)
    for a, b in zip(hist, jhist):
        assert sorted(a) == sorted(b)
        for k in a:
            if k == "loss":
                assert a[k] == pytest.approx(b[k], rel=1e-4), (a, b)
            else:
                assert a[k] == b[k], (k, a, b)


def assert_trees_within(tree, jtree, tmax=TREE_MAX, tmean=TREE_MEAN):
    assert sorted(tree) == sorted(jtree)
    for path, x in tree.items():
        d = np.abs(x - jtree[path])
        assert d.max() <= tmax, (path, d.max())
        assert d.mean() <= tmean, (path, d.mean())


def assert_within_fused_gate(tree, other):
    """The reference's fused-vs-unfused gate (tests/test_async_engine.py:
    94-124): at each leaf's scale, max |d| within 4 S1E3M7 steps and mean
    |d| within 1."""
    assert sorted(tree) == sorted(other)
    for path, x in tree.items():
        y = other[path]
        d = np.abs(x - y)
        scale = max(np.abs(x).max(), np.abs(y).max(), 2.0 ** -6)
        step = 2.0 ** (np.floor(np.log2(scale)) - 7)
        assert d.max() <= 4 * step, (path, d.max(), step)
        assert d.mean() <= step, (path, d.mean(), step)


# ---------------------------------------------------------------------------
# Traces and weights
# ---------------------------------------------------------------------------


def _trace_pair(name):
    from repro_torch.federated.engine import profile
    if name == "tiered":
        return (traces.TieredTrace(base=traces.ParetoTrace(seed=3, latency=2.0),
                                   profiles=(profile("f32"), profile("s1e3m7"),
                                             profile("s1e4m3"))),
                jtraces.TieredTrace(base=jtraces.ParetoTrace(seed=3, latency=2.0),
                                    profiles=(jengine.profile("f32"), jengine.profile("s1e3m7"),
                                              jengine.profile("s1e4m3"))))
    kw = dict(fixed=dict(seed=5, interval=0.5, latency=1.5, jitter=0.3),
              pareto=dict(seed=7, latency=2.0, alpha=1.2),
              diurnal=dict(seed=1, interval=1.0, period=24.0, depth=0.9),
              base=dict(seed=2, interval=0.25, latency=3.0))[name]
    cls = dict(fixed="FixedTrace", pareto="ParetoTrace", diurnal="DiurnalTrace",
               base="ClientTrace")[name]
    return getattr(traces, cls)(**kw), getattr(jtraces, cls)(**kw)


@pytest.mark.parametrize("name", ["base", "fixed", "pareto", "diurnal", "tiered"])
def test_traces_match_reference(name):
    """64 clients x 8 events: every first check-in, check-in delay and round
    latency equal to the reference's, exactly."""
    t, jt = _trace_pair(name)
    now = np.random.default_rng(0).uniform(0, 48, (64, 8))
    for c in range(64):
        assert t.first_checkin(c) == jt.first_checkin(c)
        for k in range(8):
            assert t.checkin_delay(c, k, now[c, k]) == jt.checkin_delay(c, k, now[c, k])
            assert t.round_latency(c, k, now[c, k]) == jt.round_latency(c, k, now[c, k])
    if name == "tiered":
        assert t.multipliers == jt.multipliers and t.tier_of(5) == jt.tier_of(5) == 2


def _staleness_vectors():
    rng = np.random.default_rng(20)
    out = [np.zeros(5, np.float32), np.asarray([0, 1, 3, 0, 2], np.float32)]
    out += [rng.integers(0, 51, n).astype(np.float32) for n in (1, 4, 8, 16, 16)]
    return out


@pytest.mark.parametrize("mode", ["poly", "exp"])
@pytest.mark.parametrize("decay", [0.0, 0.5, 2.0, 200.0])
def test_weights_match_reference(decay, mode):
    """Exact at decay 0; otherwise within 2 ulp of the largest |log weight|,
    relative, plus the smallest normal f32 (the reference flushes subnormal
    weights to 0, ROADMAP C1).  The contract on the same vectors: w(0) = 1,
    0 <= w <= 1 (0 only by underflow), monotone, normalized weights summing
    to 1."""
    tiny = np.finfo(np.float32).tiny
    for s in _staleness_vectors():
        got = {fn: getattr(async_engine, fn)(s, decay, mode).numpy()
               for fn in ("staleness_weights", "buffer_weights", "flush_weights")}
        for fn, a in got.items():
            b = np.asarray(getattr(jae, fn)(s, decay, mode))
            assert a.dtype == np.float32 and a.shape == b.shape
            if decay == 0:
                np.testing.assert_array_equal(a, b)
                continue
            logw = decay * (np.log1p(s) if mode == "poly" else s)
            rtol = 2 * float(np.spacing(np.float32(max(logw.max(), 1.0))))
            assert np.all(np.abs(a - b) <= rtol * np.abs(b) + tiny), (fn, s, a, b)
        raw, norm = got["staleness_weights"], got["buffer_weights"]
        assert np.all(raw[s == 0] == 1.0) and np.all((raw >= 0) & (raw <= 1))
        order = np.argsort(s, kind="stable")
        assert np.all(np.diff(raw[order]) <= 0) and np.all(np.diff(norm[order]) <= 1e-7)
        assert norm.sum() == pytest.approx(1.0, rel=1e-5) and norm.max() > 0
        if decay == 0:
            np.testing.assert_array_equal(got["flush_weights"], np.ones_like(s))


def test_async_config_and_goal_validation_match_reference():
    for kw in (dict(buffer_goal=2, decay=-1.0), dict(buffer_goal=2, decay_mode="nope"),
               dict(buffer_goal=2, max_staleness=-1)):
        with pytest.raises(ValueError) as want:
            jae.AsyncConfig(**kw)
        with pytest.raises(ValueError) as got:
            async_engine.AsyncConfig(**kw)
        assert str(got.value) == str(want.value)
    for bad in (0, -3, 99):
        with pytest.raises(ValueError) as want:
            jcohort.validate_report_goal(bad, 4, what="buffer_goal")
        with pytest.raises(ValueError) as got:
            cohort.validate_report_goal(bad, 4, what="buffer_goal")
        assert str(got.value) == str(want.value)
        with pytest.raises(ValueError, match="buffer_goal"):
            async_engine.AsyncRunner(cf, CFG, OMCConfig.parse(FMT), sim(),
                                     async_engine.AsyncConfig(buffer_goal=bad),
                                     traces.FixedTrace(), num_clients=4, data_fn=data,
                                     init_key=prng.PRNGKey(0), device="cpu")


# ---------------------------------------------------------------------------
# The degenerate trace: async equals the sync engine
# ---------------------------------------------------------------------------


def test_degenerate_trace_matches_port_engine(init, port_degenerate):
    """Every flush a full fresh cohort; cumulative wire bytes equal the
    engine's round ledgers summed; trees within the reference's gate."""
    storage, hist, runner = port_degenerate
    c = DEGENERATE["clients"]
    est, ehist = engine.run_training_vectorized(
        cf, CFG, OMCConfig.parse(FMT), sim(), engine.CohortSpec(cohort.CohortPlan(c, c)), data,
        prng.PRNGKey(0), DEGENERATE["flushes"], init_params=torch_params(init))
    for i, (eh, ah) in enumerate(zip(ehist, hist)):
        assert ah["buffer"] == c and ah["staleness_max"] == 0
        assert ah["loss"] == pytest.approx(eh["loss"], rel=1e-4)
        assert ah["down_bytes"] == sum(h["down_bytes"] for h in ehist[:i + 1])
        assert ah["up_bytes"] == sum(h["up_bytes"] for h in ehist[:i + 1])
    assert hist[-1]["stale_up_bytes"] == 0 and hist[-1]["in_flight_bytes"] == 0
    assert_trees_within(_decoded(storage), _decoded(est))


def test_degenerate_trace_matches_reference(jax_degenerate, port_degenerate):
    storage, hist, _ = port_degenerate
    assert_same_history(hist, jax_degenerate[1])
    assert_trees_within(_decoded(storage), jax_degenerate[0])


# ---------------------------------------------------------------------------
# The straggler trace, unfused and fused
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_straggler_trace_matches_reference(jax_straggler, port_straggler, fused):
    port, ref = port_straggler[fused], jax_straggler[fused]
    assert port["events"] == ref["events"]
    assert_same_history(port["history"], ref["history"])
    last = port["history"][-1]
    assert last["n_dropped"] == 3 and last["n_stale"] > 0 and last["dropped_fraction"] > 0
    assert port["runner"].dropped_stale == 3
    if fused:
        assert_within_fused_gate(_decoded(port["runner"].storage), ref["tree"])
    else:
        assert_trees_within(_decoded(port["runner"].storage), ref["tree"])


def test_fused_flush_matches_unfused_on_the_port(port_straggler):
    """The same run fused and unfused: the same events and ledgers, losses
    within rtol 1e-4, trees within the reference's fused gate; B5 launched
    once per selected leaf per fused flush and never unfused."""
    u, f = port_straggler[False], port_straggler[True]
    assert u["events"] == f["events"]
    assert_same_history(f["history"], u["history"])
    assert_within_fused_gate(_decoded(f["runner"].storage), _decoded(u["runner"].storage))
    n_comp = sum(is_compressed(v) for _, v in tree_items(u["runner"].storage))
    assert f["counts"]["fused_aggregate.ref"] == n_comp * STRAGGLER["flushes"]
    assert "fused_aggregate.ref" not in u["counts"]


def test_fused_buffer_holds_codes(port_straggler):
    r = port_straggler[True]["runner"]
    entry = next(iter(r.trained.values()))[0] if r.trained else r.buffer[0].model
    kinds = [(is_compressed(a), is_compressed(b))
             for (_, a), (_, b) in zip(tree_items(entry), tree_items(r.storage))]
    assert all(a == b for a, b in kinds) and any(a for a, _ in kinds)


# ---------------------------------------------------------------------------
# Async checkpoints
# ---------------------------------------------------------------------------


def _npz_and_extra(path):
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    with open(os.path.join(path, "manifest.json")) as f:
        return arrays, json.load(f)["extra"]


def _assert_same_checkpoint(a, b):
    (xa, ea), (xb, eb) = _npz_and_extra(a), _npz_and_extra(b)
    assert sorted(xa) == sorted(xb)
    for k in xa:
        assert xa[k].dtype == xb[k].dtype and xa[k].tobytes() == xb[k].tobytes(), k
    assert ea == eb


def _ledger(runner):
    return runner.stats.snapshot(), dict(runner.stats._pending)


@pytest.mark.parametrize("at", ["start", "mid_buffer"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_resume_is_bit_equal(init, port_straggler, tmp_path, fused, at):
    """A runner restored from a checkpoint (at the start: nothing buffered or
    trained; mid-buffer: both non-empty) runs to the same bits as the
    uninterrupted run: storage, history, ledger."""
    straight = port_straggler[fused]["runner"]
    if at == "start":
        path = ck.save_async_state(str(tmp_path), port_runner(init, fused))
    else:
        path = port_straggler[fused]["saved"]
        _, extra = _npz_and_extra(path)
        assert extra["buffer_meta"] and extra["trained_losses"] and extra["version"] == 1
    fresh = port_runner(init, fused)
    ck.restore_async_state(path, fresh)
    fresh.run_until(flushes=STRAGGLER["flushes"] - fresh.version)
    assert trees_bit_equal(fresh.storage, straight.storage)
    assert fresh.history == straight.history and _ledger(fresh) == _ledger(straight)
    assert (fresh.clock, fresh.events_processed, fresh.round_counters) == (
        straight.clock, straight.events_processed, straight.round_counters)


def test_port_restores_the_reference_checkpoint(init, jax_straggler, tmp_path):
    """The reference's mid-buffer checkpoint restores into the port's runner
    to the same bits: the port saves it again, arrays and extra equal."""
    path = jax_straggler[False]["saved"]
    runner = port_runner(init)
    extra = ck.restore_async_state(path, runner)
    assert runner.buffer and runner.trained and extra["pending"]
    again = ck.save_async_state(str(tmp_path), runner)
    _assert_same_checkpoint(again, path)
    runner.run_until(flushes=1)  # and it runs on
    assert runner.version == 2


def test_reference_restores_the_port_checkpoint(init, port_straggler, tmp_path):
    path = port_straggler[False]["saved"]
    jrunner = jax_runner(init)
    jck.restore_async_state(path, jrunner)
    assert jrunner.buffer and jrunner.trained
    again = jck.save_async_state(str(tmp_path), jrunner)
    _assert_same_checkpoint(again, path)


def test_restore_mismatches_raise(init, port_straggler, tmp_path):
    path = port_straggler[True]["saved"]
    with pytest.raises(ValueError, match="fused_agg mismatch"):
        ck.restore_async_state(path, port_runner(init, fused=False))
    for key, value, match in (("has_ef", True, "error-feedback state mismatch"),
                              ("population_layout", {"num_clients": 10, "num_shards": 2},
                               "population layout mismatch")):
        bad = tmp_path / key
        os.makedirs(bad)
        arrays, _ = _npz_and_extra(path)
        np.savez(bad / "arrays.npz", **arrays)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        manifest["extra"][key] = value
        (bad / "manifest.json").write_text(json.dumps(manifest))
        with pytest.raises(ValueError, match=match):
            ck.restore_async_state(str(bad), port_runner(init, fused=True))
    sync = ck.save_state(str(tmp_path / "sync"), 1, {"w": torch.zeros(3)})
    with pytest.raises(ValueError, match="not an async-runner checkpoint"):
        ck.restore_async_state(sync, port_runner(init))


# ---------------------------------------------------------------------------
# The runtime's own rules
# ---------------------------------------------------------------------------


def test_repeat_rounds_under_one_version_draw_fresh_data(init):
    """A fast client's second round under an unchanged version keys its data
    and PPQ mask by its own round counter, not the version."""
    runner = async_engine.AsyncRunner(
        cf, CFG, OMCConfig.parse(FMT), sim(), async_engine.AsyncConfig(buffer_goal=4),
        traces.TieredTrace(latency=1.0, multipliers=(1.0, 10.0)), num_clients=4, data_fn=data,
        init_params=torch_params(init))
    runner.run_until(uploads=3)
    assert runner.version == 0 and runner.round_counters[0] == 2
    by_client = {}
    for e in runner.buffer:
        by_client.setdefault(e.client_id, []).append(e.model)
    pair = next(ms for ms in by_client.values() if len(ms) == 2)
    diffs = [float((a - b).abs().max()) for (_, a), (_, b) in
             zip(tree_items(pair[0]), tree_items(pair[1]))]
    assert max(diffs) > 0.0


def test_in_flight_accounting(init):
    runner = async_engine.AsyncRunner(
        cf, CFG, OMCConfig.parse(FMT), sim(), async_engine.AsyncConfig(buffer_goal=4),
        traces.FixedTrace(latency=1.0), num_clients=4, data_fn=data,
        init_params=torch_params(init))
    runner.run_until(flushes=1)
    table, omc = runner.stats.table, OMCConfig.parse(FMT)
    assert runner.stats.in_flight_bytes == 0
    assert runner.stats.peak_in_flight_bytes == sum(
        table.download_bytes(omc) + accounting.client_upload_bytes(table, omc, 0, c)
        for c in range(4))
    runner.run_until(time_limit=1.5)
    assert len(runner.pending) == 4 and runner.stats.in_flight_bytes > 0


@pytest.mark.parametrize("kw,err,match", [
    (dict(strategy="topk", fused_agg=True), ValueError, "no zoo strategy"),
    (dict(obs=object()), AttributeError, "collect_metrics"),  # not an Obs: refused
    # a population store over another number of clients: the reference's refusal
    (dict(population=PopulationStore(ShardLayout(6, 2), device="cpu")), ValueError,
     "population store holds 6 clients"),
    (dict(fused_agg=True, omc="S1E8M23"), ValueError, "OMC enabled"),
], ids=["fused_with_strategy", "obs", "population", "fused_without_omc"])
def test_unported_and_invalid_arguments_raise(kw, err, match):
    from repro_torch.compress import get_strategy

    omc = OMCConfig.parse(kw.pop("omc", FMT), quantize_fraction=1.0)
    if "strategy" in kw:
        kw["strategy"] = get_strategy(kw["strategy"])
    with pytest.raises(err, match=match):
        async_engine.AsyncRunner(cf, CFG, omc, sim(), async_engine.AsyncConfig(2),
                                 traces.FixedTrace(), num_clients=4, data_fn=data,
                                 init_key=prng.PRNGKey(0), device="cpu", **kw)
    # metric bundles landed with obs: the flush hands back the buffer mean it
    # interpolated toward (f32 storage here: S1E8M23 at fraction 1 is OMC off)
    flush = async_engine.make_flush_fn({}, OMCConfig.parse("S1E8M23", quantize_fraction=1.0),
                                       sim(), collect_metrics=True)
    new, mean = flush({"w": torch.ones(3)}, {"w": torch.stack([torch.zeros(3), 4 * torch.ones(3)])},
                      torch.tensor([3.0, 1.0]))
    assert torch.equal(mean["w"], torch.ones(3)) and torch.equal(new["w"], torch.ones(3))


@pytest.mark.parametrize("kw", [dict(strategy="topk"), dict(ste=True)], ids=["strategy", "ste"])
def test_strategy_and_ste_reach_the_lanes(init, kw):
    """Under top-k with error feedback each trained lane writes its client's
    residual row and the ledger prices uploads by the strategy's plan;
    ``ste`` without a strategy gives the plain bits, as in the reference."""
    from repro_torch.compress import feedback, get_strategy

    def runner(**extra):
        r = async_engine.AsyncRunner(
            cf, CFG, OMCConfig.parse(FMT), sim(), async_engine.AsyncConfig(buffer_goal=4),
            traces.FixedTrace(latency=1.0), num_clients=4, data_fn=data,
            init_params=torch_params(init), **extra)
        r.run_until(flushes=1)
        return r

    plain = runner()
    if "ste" in kw:
        assert trees_bit_equal(runner(ste=True).storage, plain.storage)
        return
    topk = get_strategy(kw["strategy"], density=0.05)  # 0.4 B a parameter, S1E3M7 1.375
    r = runner(strategy=topk)
    assert r.stats.strategy is topk and feedback.total_norm(r.ef) > 0
    assert all(v.shape[0] == 4 for v in r.ef.values())
    # every client trained once: each holds a residual (a variable its PPQ bit
    # left f32 drains to 0)
    assert all(any(bool(v[c].any()) for v in r.ef.values()) for c in range(4))
    table, omc = r.stats.table, OMCConfig.parse(FMT)
    assert r.stats.up_bytes == sum(
        accounting.client_upload_bytes_strategy(table, omc, topk, 0, c) for c in range(4))
    assert r.stats.up_bytes < plain.stats.up_bytes
    assert r.stats.down_bytes == plain.stats.down_bytes  # the at-rest state


def test_wire_stats_snapshot_matches_reference(port_degenerate):
    """The same events into both ledgers: the same snapshot, key for key."""
    table = port_degenerate[2].stats.table
    jtable = jaccounting.WireTable(table.names, table.n_elems, table.stack_entries,
                                      table.raw_bytes)
    omc, jomc = OMCConfig.parse(FMT), JOMC.parse(FMT)
    a, b = accounting.AsyncWireStats(table), jaccounting.AsyncWireStats(jtable)
    for r in (a, b):
        assert r.snapshot()["stale_fraction"] == 0.0
    for cid, rnd, st, drop in ((0, 0, 0, False), (1, 0, 2, False), (2, 1, 3, True),
                               (3, 4, 0, False)):
        a.start_round(omc, rnd, cid)
        b.start_round(jomc, rnd, cid)
    for cid, rnd, st, drop in ((1, 0, 2, False), (0, 0, 0, False), (2, 1, 3, True)):
        assert (a.finish_round(omc, rnd, cid, st, dropped=drop)
                == b.finish_round(jomc, rnd, cid, st, dropped=drop))
    assert a.snapshot() == b.snapshot() and a._pending == b._pending
    assert dataclasses.asdict(a).keys() == dataclasses.asdict(b).keys()


def test_async_scale_smoke_holds_its_gate(monkeypatch, tmp_path):
    """``benchmarks_torch/async_scale.py --smoke`` (the reference's CI config,
    plain versions): async >= 2x sync in updates per virtual second, whose
    virtual times depend on the schedule alone."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from benchmarks_torch import async_scale
    from benchmarks_torch import common as tcommon

    monkeypatch.setattr(tcommon, "OUT_DIR", tmp_path)
    assert async_scale.main(["--smoke"]) == 0
    row = json.loads((tmp_path / "async_scale_smoke.json").read_text())["rows"][0]
    assert row["vtime_speedup"] >= 2.0 and row["device"] == "cpu"
    assert (row["cohort"], row["buffer_goal"], row["update_budget"]) == (8, 4, 24)
