"""The port's sharded population runtime against the port's own engine and
async runtime (``repro_torch.scale``, DESIGN.md §14).

At the reference test's size (tests/test_scale.py: conformer 2 layers, d 32,
cohort 8 of 16 with failure rate 0.25, S1E3M7 with PPQ 0.9, 2 local steps),
with the reference test's gates: the sharded round against the engine's,
unfused (max 6e-3, mean 1e-4) and fused (6e-3, 1e-3), with the same invited
and alive clients and the same ledgers; capacity and shard-count invariance
(1e-6, 1e-7); pad lanes skipped giving the partial sums' bits of pad lanes
trained (ROADMAP C22); store-backed top-k with error feedback against the
engine's dense EF (the rows the same bits; trees within the sharded gate,
ROADMAP C23); the population-backed
``AsyncRunner`` against the dict-backed one, its checkpoint stamp and
refusals; telemetry on the streamed round; and the smoke runs of
``benchmarks_torch/population_scale.py`` and
``examples_torch/population_scale.py``.  The reference itself is held in
tests/test_torch_scale.py.
"""

import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as ck
from repro_torch.compress import feedback, get_strategy
from repro_torch.core import prng
from repro_torch.core.omc import OMCConfig
from repro_torch.core.store import decompress_tree
from repro_torch.core.tree import tree_items, tree_map
from repro_torch.data.synthetic import make_frame_task
from repro_torch.federated import async_engine, cohort, engine, simulate, traces
from repro_torch.federated.cohort import CohortPlan
from repro_torch.models import conformer as cf
from repro_torch.obs import Obs
from repro_torch.scale import (ArrayCounters, PopulationStore, ShardLayout, make_stream_fn,
                               pad_chunk, run_round_sharded, run_training_sharded)
from repro_torch.scale.stream import partial_sums

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CFG = cf.ConformerConfig(n_layers=2, d_model=32, n_heads=4, d_ff=64, n_classes=16, d_in=8)
OMC = OMCConfig.parse("S1E3M7")
PLAN = CohortPlan(num_clients=16, cohort_size=8, failure_rate=0.25)
TASK = make_frame_task(d_in=8, n_classes=16, seq_len=24, num_clients=16, device="cpu")
SIM = simulate.SimConfig(local_steps=2, client_lr=0.1)
KEY = prng.PRNGKey(0)


def data(c, r, s):
    return TASK.batch(c, r, s, 4)


@pytest.fixture(scope="module")
def params():
    return cf.init(KEY, CFG, "cpu")


def _engine(params, rounds, **kw):
    return engine.run_training_vectorized(cf, CFG, OMC, SIM, engine.CohortSpec(PLAN), data, KEY,
                                          rounds, init_params=params, **kw)


def _sharded(params, rounds, shards=2, capacity=3, **kw):
    return run_training_sharded(cf, CFG, OMC, SIM, PLAN, ShardLayout(16, shards), data, KEY,
                                rounds, capacity=capacity, init_params=params, **kw)


def _gap(a, b):
    da, db = dict(tree_items(decompress_tree(a))), dict(tree_items(decompress_tree(b)))
    assert da.keys() == db.keys()
    d = [(da[k] - db[k]).abs() for k in da]
    return max(x.max().item() for x in d), max(x.mean().item() for x in d)


@pytest.mark.parametrize("fused,rounds,mean_gate", [(False, 2, 1e-4), (True, 1, 1e-3)],
                         ids=["unfused", "fused"])
def test_sharded_matches_engine(params, fused, rounds, mean_gate):
    """Capacity-3 chunks over 2 shards (short chunks, a cohort across the
    boundary): the engine's invited and alive clients, its ledgers to the
    byte, trees within the reference's gates."""
    eng, eng_hist = _engine(params, rounds, fused_agg=fused)
    store = PopulationStore(ShardLayout(16, 2), device="cpu")
    sh, sh_hist, ledger = _sharded(params, rounds, fused_agg=fused, store=store)
    invited, uploaded = np.zeros(16, np.int64), np.zeros(16, np.int64)
    rkey = prng.fold_in(KEY, 0xC047)
    for r, (eh, h) in enumerate(zip(eng_hist, sh_hist)):
        ids = engine.sample_tiered_cohort(rkey, engine.CohortSpec(PLAN), r)[0].numpy()
        alive = cohort.survival_mask(rkey, PLAN, r).numpy()
        invited[ids] += 1
        uploaded[ids[alive]] += 1
        for k in ("cohort", "dropped", "down_bytes", "up_bytes"):
            assert h[k] == eh[k], (k, h, eh)
        assert abs(h["loss"] - eh["loss"]) < 1e-3
        assert h["shards"] >= 1 and h["chunks"] >= h["shards"] and h["stream_capacity"] == 3
    assert np.array_equal(store.round_counters, invited)
    assert np.array_equal(store.event_counters, uploaded)
    assert ledger.clients_streamed == sum(h["cohort"] + h["dropped"] for h in sh_hist)
    mx, mean = _gap(eng, sh)
    assert mx <= 6e-3 and mean <= mean_gate, (mx, mean)


@pytest.fixture(scope="module")
def base_round(params):
    return _sharded(params, 1, shards=2, capacity=8)[0]


@pytest.mark.parametrize("shards,capacity", [(2, 2), (2, 5), (1, 8), (8, 8)], ids=str)
def test_capacity_and_shard_count_invariance(params, base_round, shards, capacity):
    """How the cohort is chunked and sharded moves the tree by f32
    reassociation only."""
    other = _sharded(params, 1, shards=shards, capacity=capacity)[0]
    mx, mean = _gap(base_round, other)
    assert mx <= 1e-6 and mean <= 1e-7, (mx, mean)


def test_pad_lanes_skipped_give_the_bits_of_pad_lanes_trained(params):
    """ROADMAP C22: the partial sums of a chunk's trained lanes equal, bit for
    bit, those with its pad lanes (a real lane's model again, weight 0)
    appended, fused and unfused; the stream trains no pad lane."""
    specs = cf.param_specs(CFG)
    storage = simulate.init_storage(cf, CFG, OMC, specs, KEY, params, "cpu")[1]
    rng = np.random.default_rng(0)
    real = {k: v + torch.from_numpy(rng.standard_normal((2,) + tuple(v.shape)).astype(np.float32))
            for k, v in _flat(params).items()}
    losses, w = torch.tensor([2.5, 3.25]), torch.tensor([1.0, 0.0])
    for fused in (False, True):
        def sums(n_pad):
            stack = {k: torch.cat([v, v[:1].expand((n_pad,) + v.shape[1:])]) for k, v in
                     real.items()}
            out = partial_sums(specs, storage, _unflat(stack, params), torch.cat(
                [losses, losses[:1].expand(n_pad)]), torch.cat([w, torch.zeros(n_pad)]), OMC,
                fused)
            return out[:3]

        (ws0, wt0, l0), (ws2, wt2, l2) = sums(0), sums(2)
        assert torch.equal(wt0, wt2) and torch.equal(l0, l2)
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_items(ws0), tree_items(ws2)))
    trained = []
    stream = make_stream_fn(cf, CFG, specs, OMC, SIM,
                            lambda c, r, s: trained.append(c) or data(c, r, s), 4)
    cids, wts = pad_chunk([5, 9], [True, False], 4)
    stream(storage, cids, wts, 0)
    assert trained == [5, 5, 9, 9]  # two local steps each, no pad lane


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)) if isinstance(v, dict) else {prefix + (k,): v})
    return out


def _unflat(flat, like, prefix=()):
    return {k: _unflat(flat, v, prefix + (k,)) if isinstance(v, dict) else flat[prefix + (k,)]
            for k, v in like.items()}


@pytest.mark.parametrize("rounds,capacity,gate", [(2, 3, (1e-5, 1e-6)), (1, 4, (6e-3, 1e-4))],
                         ids=["reference_config", "capacity_4"])
def test_store_backed_error_feedback_matches_dense(params, rounds, capacity, gate):
    """Top-k 0.25 with error feedback, an f32 store's run against the
    engine's dense EF.  At the reference test's configuration (2 rounds,
    capacity 3) the trees are within its gate (1e-5, 1e-6).  That gate
    holds only where no element of the re-compressed tree crosses a
    rounding midpoint; one round at capacity 4 crosses once (ROADMAP C23),
    so it is held to the sharded-against-engine gate (6e-3, 1e-4) with each
    client's residual rows the same bits (one port: no threshold flips,
    ROADMAP C17), and a packed S1E4M14 store within a few of its steps of
    the f32 rows."""
    specs = cf.param_specs(CFG)
    strat = get_strategy("topk", density=0.25)
    ef = feedback.init_ef_state(params, specs, OMC, 16)
    eng, _ = _engine(params, rounds, strategy=strat, ef=ef, wire=False)
    raw = PopulationStore(ShardLayout(16, 2), device="cpu")
    raw.init_ef(params, specs, OMC)
    sh = _sharded(params, rounds, capacity=capacity, strategy=strat, wire=False, store=raw)[0]
    mx, mean = _gap(eng, sh)
    assert mx <= gate[0] and mean <= gate[1], (mx, mean)
    assert raw.round_counters.sum() == rounds * PLAN.cohort_size
    assert 0 < raw.event_counters.sum() <= raw.round_counters.sum()
    if rounds > 1:
        return
    packed = PopulationStore(ShardLayout(16, 2), device="cpu")
    packed.init_ef(params, specs, OMC, ef_fmt="S1E4M14")
    _sharded(params, 1, capacity=capacity, strategy=strat, wire=False, store=packed)
    moved = np.flatnonzero(raw.event_counters)
    got, back = raw.gather_ef(np.arange(16)), packed.gather_ef(moved)
    for name, rows in ef.items():
        assert torch.equal(got[name], rows), name
        scale = rows[moved].abs().amax(dim=tuple(range(1, rows.ndim)), keepdim=True)
        # a few S1E4M14 steps at the row's largest |value|, or one step of its
        # subnormal range (2**-20: these rows lie below its 2**-6); the
        # reference gates 1e-4 absolute on 0.1-scale rows
        tol = torch.clamp(scale * 2.0 ** -12, min=2.0 ** -20)
        assert bool(((back[name] - rows[moved]).abs() <= tol).all()), name
    rep = packed.bytes_report()
    assert rep["ef_at_rest_bytes"] < rep["ef_fp32_bytes"] and rep["ef_fmt"] == "S1E4M14"
    with pytest.raises(ValueError, match="error feedback"):
        _sharded(params, 1, strategy=strat, store=PopulationStore(ShardLayout(16, 2), "cpu"))


def test_streamed_round_under_telemetry(params, tmp_path):
    """A live Obs records the round with its bundle (the chunks' folded
    partials included) and moves no stored bit; a cached stream built for the
    other telemetry setting raises (ROADMAP C21)."""
    specs = cf.param_specs(CFG)
    off = _sharded(params, 1)[0]
    obs = Obs(run_name="scale", out_dir=str(tmp_path))
    on, hist, _ = _sharded(params, 1, obs=obs)
    assert all(torch.equal(a.codes, b.codes) if hasattr(a, "codes") else torch.equal(a, b)
               for (_, a), (_, b) in zip(tree_items(off), tree_items(on)))
    (rec,) = obs.sink.records("round")
    assert rec["update_sq_wsum"] > 0 and rec["update_norm"] > 0 and rec["alive"] == hist[0]["cohort"]
    assert len(obs.tracer.spans("wall", "round")) == 1
    storage = simulate.init_storage(cf, CFG, OMC, specs, KEY, params, "cpu")[1]
    stream = make_stream_fn(cf, CFG, specs, OMC, SIM, data, 3)
    with pytest.raises(ValueError, match="collect_metrics"):
        run_round_sharded(cf, CFG, specs, OMC, SIM, storage, data, PLAN, ShardLayout(16, 2), 0,
                          prng.fold_in(KEY, 0xC047), capacity=3, stream_fn=stream,
                          obs=Obs(run_name="x", out_dir=str(tmp_path)))
    with pytest.raises(ValueError, match="layout shards"):
        run_round_sharded(cf, CFG, specs, OMC, SIM, storage, data, PLAN, ShardLayout(8, 2), 0,
                          KEY, capacity=3, stream_fn=stream)


def _runner(population=None, num_clients=4):
    task = make_frame_task(d_in=8, n_classes=16, seq_len=24, num_clients=num_clients,
                           device="cpu")
    return async_engine.AsyncRunner(
        cf, CFG, OMC, SIM, async_engine.AsyncConfig(buffer_goal=2), traces.FixedTrace(),
        num_clients=num_clients, data_fn=lambda c, r, s: task.batch(c, r, s, 4),
        init_key=KEY, population=population, device="cpu")


def test_population_backed_async_runner(tmp_path):
    """Counters in the store's arrays, the dict-backed run's values and
    history; the checkpoint stamps the layout, carries the counters as
    arrays, restores into the same layout and refuses another (or a
    dict-backed runner)."""
    store = PopulationStore(ShardLayout(4, 2), device="cpu")
    pop, plain = _runner(store), _runner()
    for r in (pop, plain):
        r.run_until(flushes=1)
    assert isinstance(pop.event_counters, ArrayCounters) and store.round_counters.sum() > 0
    assert dict(pop.round_counters.items()) == plain.round_counters
    assert dict(pop.event_counters.items()) == plain.event_counters
    assert pop.history == plain.history
    path = ck.save_async_state(str(tmp_path), pop, keep=1)
    with open(os.path.join(path, "manifest.json")) as f:
        extra = json.load(f)["extra"]
    assert extra["population_layout"] == dict(num_clients=4, num_shards=2)
    assert extra["event_counters"] is None and extra["round_counters"] is None
    store2 = PopulationStore(ShardLayout(4, 2), device="cpu")
    again = _runner(store2)
    ck.restore_async_state(path, again)
    assert np.array_equal(store2.round_counters, store.round_counters)
    assert np.array_equal(store2.event_counters, store.event_counters)
    assert again.round_counters.arr is store2.round_counters and again.version == pop.version
    for other in (_runner(PopulationStore(ShardLayout(4, 1), device="cpu")), _runner()):
        with pytest.raises(ValueError, match="layout"):
            ck.restore_async_state(path, other)
    with pytest.raises(ValueError, match="num_clients"):
        _runner(store, num_clients=6)


def _script(name: str):
    spec = importlib.util.spec_from_file_location(f"_pop_{name}", ROOT / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_population_scale_smoke_runs(capsys):
    """The benchmark's ``--smoke`` (the reference's CI config: the bound the
    same at populations 200 and 1,000, peaks within 1.5x, S1E3M7 at rest
    under half of f32, swap stall under 10x) and the example's ``--smoke``,
    on the CPU."""
    out = _script("benchmarks_torch/population_scale.py").run(smoke=True)
    assert [r["population"] for r in out["sweep"]] == [200, 1_000]
    assert len({r["peak_bound_bytes"] for r in out["sweep"]}) == 1
    assert out["ef_at_rest"]["S1E3M7"]["ratio_vs_f32"] < 0.5
    assert out["serve"]["swaps"] == 2 and out["serve"]["swap_stall_ratio"] < 10
    assert (ROOT / "experiments" / "bench_torch" / "population_scale_smoke.json").exists()
    _script("examples_torch/population_scale.py").main(["--smoke", "--device", "cpu",
                                                        "--ef-fmt", "S1E4M14"])
    text = capsys.readouterr().out
    assert "round 0: loss=" in text and "EF at rest:" in text and "(S1E4M14)" in text
