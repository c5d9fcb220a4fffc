"""PyTorch port vs the JAX reference: the sharded population runtime
(``repro_torch.scale`` against ``repro.scale``, DESIGN.md §14).

At the reference test's size (tests/test_scale.py: conformer 2 layers, d 32,
cohort 8 of 16 with failure rate 0.25, S1E3M7 with PPQ 0.9), with seeded
numpy inputs:

  * ``ShardLayout`` and ``pad_chunk`` equal on a grid of sizes, their
    refusals included;
  * the store's packed rows: words bit for bit and ``(s, b)`` within the
    f32 gate for the same rows, each package gathering the other's state
    tree (the affine within 1 ulp, ROADMAP C5), population checkpoints
    restored across the packages with their refusals;
  * ``tree_aggregate`` within f32 reassociation; ``StreamLedger.snapshot()``
    equal;
  * one reference ``run_training_sharded`` (unfused, 2 rounds, 2 shards,
    capacity 3) against the port's: invited and alive clients, ledgers and
    the stream ledger equal, trees within one transport-quant step.

The port's fused, EF, invariance and async cases are held to the port's own
engine and dict-backed runner in tests/test_torch_population.py.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jck
from repro.core.formats import FloatFormat as JFloatFormat
from repro.core.omc import OMCConfig as JOMC
from repro.data.synthetic import make_frame_task as jmake_frame_task
from repro.federated import accounting as jaccounting
from repro.federated import simulate as jsimulate
from repro.federated.cohort import CohortPlan as JPlan
from repro.models import conformer as jcf
from repro.scale import PopulationStore as JStore
from repro.scale import ShardLayout as JLayout
from repro.scale import pad_chunk as jpad_chunk
from repro.scale import run_training_sharded as jrun_training_sharded
from repro.scale import tree_aggregate as jtree_aggregate
from repro.scale.store import _EFVar as JEFVar
from repro_torch import checkpoint as ck
from repro_torch import interop
from repro_torch.core import prng
from repro_torch.core.formats import FloatFormat
from repro_torch.core.omc import OMCConfig
from repro_torch.core.store import decompress_tree
from repro_torch.core.tree import tree_items
from repro_torch.data.synthetic import make_frame_task
from repro_torch.federated import accounting, simulate
from repro_torch.federated.cohort import CohortPlan, aggregate_weighted
from repro_torch.models import conformer as cf
from repro_torch.scale import (PopulationStore, ShardLayout, pad_chunk, run_training_sharded,
                               tree_aggregate)
from repro_torch.scale.store import decode_rows, encode_rows

torch.set_num_threads(1)

JCFG = jcf.ConformerConfig(n_layers=2, d_model=32, n_heads=4, d_ff=64, n_classes=16, d_in=8)
CFG = cf.ConformerConfig(**JCFG.__dict__)
FMT = "S1E3M7"
PLAN = CohortPlan(num_clients=16, cohort_size=8, failure_rate=0.25)
JPLAN = JPlan(num_clients=16, cohort_size=8, failure_rate=0.25)
TASK = make_frame_task(d_in=8, n_classes=16, seq_len=24, num_clients=16, device="cpu")
JTASK = jmake_frame_task(d_in=8, n_classes=16, seq_len=24, num_clients=16)
ROUNDS = 2


@pytest.fixture(scope="module")
def init():
    """One init for both packages: the port's, carried to the reference."""
    tp = cf.init(prng.PRNGKey(0), CFG, "cpu")
    jp = {k: v for k, v in _nested(tp)}
    return jp, tp


def _nested(tree):
    for k, v in tree.items():
        yield k, dict(_nested(v)) if isinstance(v, dict) else jnp.asarray(v.numpy())


# ---------------------------------------------------------------------------
# ShardLayout and pad_chunk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,shards", [(1, 1), (10, 3), (16, 2), (17, 4), (100, 7), (4, 5),
                                      (4, 0), (8, 8)], ids=str)
def test_shard_layout_matches_reference(n, shards):
    try:
        want = JLayout(n, shards)
    except ValueError:
        with pytest.raises(ValueError, match="num_shards"):
            ShardLayout(n, shards)
        return
    got = ShardLayout(n, shards)
    assert got.shard_sizes == want.shard_sizes
    assert np.array_equal(got.starts, want.starts) and got.starts.dtype == np.int64
    ids = np.arange(n)
    assert np.array_equal(got.shard_of(ids), want.shard_of(ids))
    assert all(np.array_equal(got.clients_of(i), want.clients_of(i)) for i in range(shards))
    assert got.describe() == want.describe()
    for bad in ([n], [-1]):
        with pytest.raises(ValueError, match="client ids"):
            got.shard_of(bad)


@pytest.mark.parametrize("ids,alive,capacity", [
    ([5, 6], [True, False], 4), ([3], [False], 1), ([9, 2, 7], [1, 1, 1], 3),
    ([1, 2, 3], [1, 0, 1], 8), ([], [], 4), ([1, 2, 3], [1, 1, 1], 2)], ids=str)
def test_pad_chunk_matches_reference(ids, alive, capacity):
    try:
        want = jpad_chunk(ids, alive, capacity)
    except ValueError:
        with pytest.raises(ValueError, match="chunk must hold"):
            pad_chunk(ids, alive, capacity)
        return
    got = pad_chunk(ids, alive, capacity)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


# ---------------------------------------------------------------------------
# The store's rows, counters and checkpoints
# ---------------------------------------------------------------------------


def _stores(init, fmt, n=8, shards=2):
    jp, tp = init
    js = JStore(JLayout(n, shards))
    js.init_ef(jp, jcf.param_specs(JCFG), JOMC.parse(FMT), ef_fmt=fmt)
    ts = PopulationStore(ShardLayout(n, shards), device="cpu")
    ts.init_ef(tp, cf.param_specs(CFG), OMCConfig.parse(FMT), ef_fmt=fmt)
    return js, ts


def _rows(store, k, seed):
    rng = np.random.default_rng(seed)
    return {name: (0.1 * rng.standard_normal((k,) + store._ef[name].shape)).astype(np.float32)
            for name in store.ef_names}


def _ulps(a, b):
    return np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32))


@pytest.mark.parametrize("fmt", [None, "S1E3M7"])
def test_store_rows_match_reference(init, fmt):
    """Scattered rows at rest: f32 rows equal, packed words bit for bit and
    per-row (s, b) within the f32 gate; each package gathers the other's
    state tree, the decode within 1 ulp; bytes reports and counters equal.
    (S1E4M14's words: the checkpoint test.)  Every chunk is 2 rows wide, so
    the reference compiles its codec once."""
    js, ts = _stores(init, fmt)
    assert ts.ef_names == js.ef_names and ts.describe_ef() == js.describe_ef()
    ids, rows = [0, 5], _rows(ts, 3, seed=1)
    js.scatter_ef(ids, {k: jnp.asarray(v[:2]) for k, v in rows.items()})
    ts.scatter_ef(ids, {k: torch.from_numpy(v[:2]) for k, v in rows.items()})
    # the alive-masked scatter: client 2 keeps its row, 3 and 7 take theirs
    js.scatter_ef([2, 3, 7], {k: jnp.asarray(v) for k, v in rows.items()},
                  mask=[False, True, True])
    ts.scatter_ef([2, 3, 7], {k: torch.from_numpy(v) for k, v in rows.items()},
                  mask=[False, True, True])
    jt, tt = js.state_tree(), ts.state_tree()
    for name in ts.ef_names:
        if fmt is None:
            assert np.array_equal(tt["ef"][name]["raw"], jt["ef"][name]["raw"])
            continue
        assert np.array_equal(tt["ef"][name]["words"], jt["ef"][name]["words"]), name
        np.testing.assert_allclose(tt["ef"][name]["s"], jt["ef"][name]["s"], rtol=1e-5)
        np.testing.assert_allclose(tt["ef"][name]["b"], jt["ef"][name]["b"], atol=1e-7)
    # each package gathers the other's state: the same decode as its own
    tgot_own, jgot_own = ts.gather_ef(ids), js.gather_ef(ids)
    js.load_state_tree(tt)
    ts.load_state_tree(jt)
    tgot, jgot = ts.gather_ef(ids), js.gather_ef(ids)
    for name in ts.ef_names:
        assert tgot[name].dtype == torch.float32 and tgot[name].device.type == "cpu"
        assert _ulps(tgot[name].numpy(), np.asarray(jgot_own[name])).max() <= 1, name
        assert _ulps(np.asarray(jgot[name]), tgot_own[name].numpy()).max() <= 1, name
        if fmt is not None:  # one S1E3M7 step of 0.1-scale values
            assert np.abs(tgot[name].numpy() - rows[name][:2]).max() <= 4e-3
    assert all(not v.any() for v in ts.gather_ef([2]).values())  # the masked client
    assert ts.bytes_report() == js.bytes_report()
    ts.note_round([1, 2, 4], alive=[True, False, True])
    js.note_round([1, 2, 4], alive=[True, False, True])
    assert np.array_equal(ts.round_counters, js.round_counters)
    assert np.array_equal(ts.event_counters, js.event_counters)
    # device_ef: the same rows placed on a population mesh (one device replicates)
    from repro_torch.launch.mesh import make_population_mesh

    placed = ts.device_ef(make_population_mesh(num_shards=2, device="cpu"), ids)
    for name, got in ts.gather_ef(ids).items():
        assert placed[name].sharding.spec == ()
        assert torch.equal(placed[name].value.view(torch.int32), got.view(torch.int32)), name


def test_fresh_packed_rows_decode_to_zero_and_views_count(init):
    _, ts = _stores(init, "S1E4M14")
    assert all(bool((v == 0).all()) for v in ts.gather_ef([0, 6]).values())
    view = ts.event_view()
    view[5] = 7
    assert ts.event_counters[5] == 7 and view.get(5) == 7 and view.get(99, -1) == -1
    assert dict(view.items())[5] == 7 and len(view) == 8 and list(view) == list(range(8))


def test_codec_matches_reference_on_seeded_rows():
    """``encode_rows`` / ``decode_rows`` (the store's codec) against the
    reference store's codec on rows with a wide dynamic range."""
    rng = np.random.default_rng(7)
    rows = (rng.standard_normal((5, 3, 37)) * np.exp2(rng.integers(-20, 6, (5, 1, 1))))
    rows = rows.astype(np.float32)
    js = JStore(JLayout(5, 1))
    js._ef, js.ef_fmt = {"v": JEFVar("v", (3, 37))}, JFloatFormat.parse(FMT)
    dec, enc = js._codec("v")
    jw, jsv, jbv = (np.array(x) for x in enc(jnp.asarray(rows)))
    tw, tsv, tbv = encode_rows(torch.from_numpy(rows), FloatFormat.parse(FMT))
    assert tw.dtype == torch.uint32 and np.array_equal(tw.numpy(), jw)
    np.testing.assert_allclose(tsv.numpy(), jsv, rtol=1e-5)
    assert np.all(np.abs(tbv.numpy() - jbv) <= 1e-5 * np.abs(rows).reshape(5, -1).max(1))
    got = decode_rows(tw, torch.from_numpy(jsv), torch.from_numpy(jbv), FloatFormat.parse(FMT),
                      (3, 37))
    want = np.asarray(dec(jnp.asarray(jw), jnp.asarray(jsv), jnp.asarray(jbv)))
    assert _ulps(got.numpy(), want).max() <= 1


def test_population_checkpoints_cross_packages(init, tmp_path):
    """Each package restores the other's population checkpoint bit for bit,
    and both refuse another layout and another EF format."""
    js, ts = _stores(init, "S1E4M14")
    rows = _rows(ts, 1, seed=3)
    js.scatter_ef([1], {k: jnp.asarray(v) for k, v in rows.items()})
    ts.scatter_ef([1], {k: torch.from_numpy(v) for k, v in rows.items()})
    for s in (js, ts):
        s.note_round([0, 1], alive=[True, True])
    tpath = ck.save_population_state(str(tmp_path / "port"), 3, ts)
    jpath = jck.save_population_state(str(tmp_path / "ref"), 3, js)
    for path in (tpath, jpath):
        with open(os.path.join(path, "manifest.json")) as f:
            extra = json.load(f)["extra"]
        assert extra == dict(kind="population_store", layout=dict(num_clients=8, num_shards=2),
                             ef=ts.describe_ef())
    jfresh, tfresh = _stores(init, "S1E4M14")
    jck.restore_population_state(tpath, jfresh)
    ck.restore_population_state(jpath, tfresh)
    for a, b in ((jfresh.state_tree(), ts.state_tree()), (tfresh.state_tree(), js.state_tree())):
        assert np.array_equal(a["round_counters"], b["round_counters"])
        for name in ts.ef_names:
            assert np.array_equal(a["ef"][name]["words"], b["ef"][name]["words"])
    assert tfresh.round_counters.dtype == np.int64
    for name in ts.ef_names:
        assert np.array_equal(tfresh._ef[name].s, js._ef[name].s)
    wrong_layout = PopulationStore(ShardLayout(8, 4), device="cpu")
    wrong_layout.init_ef(init[1], cf.param_specs(CFG), OMCConfig.parse(FMT), ef_fmt="S1E4M14")
    with pytest.raises(ValueError, match="layout"):
        ck.restore_population_state(jpath, wrong_layout)
    _, wrong_fmt = _stores(init, None)
    with pytest.raises(ValueError, match="EF"):
        ck.restore_population_state(jpath, wrong_fmt)
    ck.save_state(str(tmp_path / "plain"), 1, {"w": torch.zeros(2)})
    with pytest.raises(ValueError, match="not a population-store checkpoint"):
        ck.restore_population_state(ck.latest_checkpoint(str(tmp_path / "plain"))[0], ts)


# ---------------------------------------------------------------------------
# Tree algebra and the stream ledger
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", [1, 2, 3, 10])
def test_tree_aggregate_matches_reference(shards):
    rng = np.random.default_rng(2)
    stacked = dict(a=rng.standard_normal((10, 4, 3)).astype(np.float32),
                   b=rng.standard_normal((10, 5)).astype(np.float32))
    w = rng.random(10).astype(np.float32)
    want = jtree_aggregate({k: jnp.asarray(v) for k, v in stacked.items()}, jnp.asarray(w), shards)
    tstack = {k: torch.from_numpy(v) for k, v in stacked.items()}
    got = tree_aggregate(tstack, torch.from_numpy(w), shards)
    flat = aggregate_weighted(tstack, torch.from_numpy(w))
    for k in stacked:
        assert np.abs(got[k].numpy() - np.asarray(want[k])).max() <= 1e-6
        assert np.abs(got[k].numpy() - flat[k].numpy()).max() <= 1e-6


def test_stream_ledger_matches_reference(init):
    jp, tp = init
    jt = jaccounting.build_wire_table(jp, jcf.param_specs(JCFG), JOMC.parse(FMT))
    tt = accounting.build_wire_table(tp, cf.param_specs(CFG), OMCConfig.parse(FMT))
    for cap, chunks in ((4, [4, 1, 3]), (16, [16]), (64, [5, 64])):
        jl = jaccounting.StreamLedger(jt, JOMC.parse(FMT), cap)
        tl = accounting.StreamLedger(tt, OMCConfig.parse(FMT), cap)
        for i, n in enumerate(chunks):
            jl.on_chunk(n, measured_bytes=1000 * i)
            tl.on_chunk(n, measured_bytes=1000 * i)
        assert tl.snapshot() == jl.snapshot()
        with pytest.raises(ValueError, match="capacity"):
            tl.on_chunk(cap + 1)
    with pytest.raises(ValueError, match="capacity"):
        accounting.StreamLedger(tt, OMCConfig.parse(FMT), 0)


# ---------------------------------------------------------------------------
# The sharded round against the reference's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_run(init):
    """The reference's sharded run (unfused, 2 rounds, 2 shards, capacity 3),
    with a store recording who was invited and who uploaded."""
    store = JStore(JLayout(16, 2))
    storage, hist, ledger = jrun_training_sharded(
        jcf, JCFG, JOMC.parse(FMT), jsimulate.SimConfig(local_steps=2, client_lr=0.1), JPLAN,
        JLayout(16, 2), lambda c, r, s: JTASK.batch(c, r, s, 4), jax.random.PRNGKey(0), ROUNDS,
        capacity=3, store=store, init_params=init[0])
    return storage, hist, ledger, store


def test_sharded_rounds_match_reference(init, reference_run):
    jstorage, jhist, jledger, jstore = reference_run
    store = PopulationStore(ShardLayout(16, 2), device="cpu")
    storage, hist, ledger = run_training_sharded(
        cf, CFG, OMCConfig.parse(FMT), simulate.SimConfig(local_steps=2, client_lr=0.1), PLAN,
        ShardLayout(16, 2), lambda c, r, s: TASK.batch(c, r, s, 4), prng.PRNGKey(0), ROUNDS,
        capacity=3, store=store, init_params=init[1])
    assert np.array_equal(store.round_counters, jstore.round_counters)  # invited
    assert np.array_equal(store.event_counters, jstore.event_counters)  # uploaded
    assert ledger.snapshot() == jledger.snapshot()
    for h, jh in zip(hist, jhist):
        assert {k: v for k, v in h.items() if k != "loss"} == \
            {k: v for k, v in jh.items() if k != "loss"}
        assert abs(h["loss"] - jh["loss"]) < 1e-3
    # the reference's storage decoded by the port's plain decode (within 1 ulp
    # of the reference's, ROADMAP C5): no eager compile of its decode
    want = dict(tree_items(decompress_tree(interop.storage_from_numpy(jstorage, "cpu"))))
    for path, leaf in tree_items(decompress_tree(storage)):
        d = np.abs(leaf.numpy() - want[path].numpy())
        assert d.max() <= 6e-3 and d.mean() <= 1e-4, (path, d.max(), d.mean())


# ---------------------------------------------------------------------------
# On the card: the store's codec against the plain versions
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built with nvcc and run on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["S1E3M7", "S1E4M14", "S1E2M3"])
@pytest.mark.parametrize("shape", [(3, 37), (4, 17, 64), (1, 8193)], ids=str)
def test_cuda_store_codec_matches_plain(cuda, fmt, shape):
    """The packed rows on the card (B1, B4 pack, B4 unpack, B2) against the
    plain versions on the CPU: words and decodes bit for bit, (s, b) within
    the f32 gate."""
    f = FloatFormat.parse(fmt)
    rng = np.random.default_rng(sum(shape))
    rows = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    w, s, b = encode_rows(torch.from_numpy(rows).to(cuda), f)
    pw, ps, pb = encode_rows(torch.from_numpy(rows), f)
    assert torch.equal(w.cpu(), pw)
    np.testing.assert_allclose(s.cpu().numpy(), ps.numpy(), rtol=1e-5)
    assert np.all(np.abs(b.cpu().numpy() - pb.numpy())
                  <= 1e-5 * np.abs(rows).reshape(shape[0], -1).max(1))
    got = decode_rows(w, ps.to(cuda), pb.to(cuda), f, shape[1:])
    assert torch.equal(got.cpu(), decode_rows(pw, ps, pb, f, shape[1:]))
