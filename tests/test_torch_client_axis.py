"""PyTorch port vs the JAX reference: the client axis.

The reference trains a cohort by ``vmap``-ing one client body over a client
axis: in the engine (``CohortSpec.client_chunk``: a pure ``vmap``, or
``lax.map`` over blocks), in the async runtime (``AsyncConfig.train_capacity``,
``make_batch_train_fn``) and in the streamed round.  The port trains C
clients in one forward and backward pass through
``simulate.make_batch_client_fn``.  Held here, at the reference's test size
(conformer, 2 layers, d 32; cohort 8 of 16 with failure rate 0.25):

  * the engine at ``client_chunk`` 4 and 1 against the reference's at the
    same value, with the reference's own gate between its chunk widths
    (``tests/test_engine.py::test_client_chunk_matches_full_vmap``: metrics
    within relative 1e-5, trees within 6e-3), ledgers exact; the default
    (None, the pure ``vmap``) is held against the reference's in
    ``tests/test_torch_engine.py``, fused in ``test_torch_engine_fused.py``;
  * the batched port against its serial path (``client_chunk=1``) within the
    same gate, the count of bit-equal leaves printed, and no vmap fallback;
  * top-k with error feedback batched against serial: dead clients' residual
    rows the same bits, and at most 2 threshold flips a round (ROADMAP C17);
  * the async runtime at ``train_capacity`` 3 against the reference's
    runner at the same capacity, with the reference's ``dispatch`` spans
    one for one; at 1 and None (the buffer goal) against that run within
    the gate, a version's lanes in ``ceil(group / capacity)`` calls; and
    ``ValueError`` at 0 (the default capacity against the reference's:
    ``tests/test_torch_async.py``);
  * the streamed round through the batched body: against the reference's
    in ``tests/test_torch_scale.py::test_sharded_rounds_match_reference``;
  * the dense transformer batched; griffin and xlstm raising for C > 1.
"""

import math
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.core.omc import OMCConfig as JOMC
from repro.core.store import decompress_tree as jdecompress
from repro.federated import accounting as jaccounting
from repro.federated import async_engine as jae
from repro.federated import engine as jengine
from repro.federated import simulate as jsimulate
from repro.federated import traces as jtraces
from repro.federated.cohort import CohortPlan as JPlan
from repro.obs import Obs as JObs
from repro_torch import interop
from repro_torch.compress import feedback, get_strategy
from repro_torch.core import prng
from repro_torch.core.omc import OMCConfig
from repro_torch.core.store import decompress_tree
from repro_torch.core.tree import tree_items
from repro_torch.data.synthetic import make_lm_task
from repro_torch.federated import accounting, async_engine, engine, simulate, traces
from repro_torch.federated.cohort import CohortPlan
from repro_torch.models import conformer as cf
from repro_torch.models import griffin, transformer, xlstm
from repro_torch.obs import Obs
from repro_torch.obs.trace import WALL

from test_torch_engine import CFG, JCFG, data, jdata

torch.set_num_threads(1)

FMT = "S1E3M7"
PLAN, JPLAN_ = CohortPlan(16, 8, failure_rate=0.25), JPlan(16, 8, failure_rate=0.25)
REL, ATOL = 1e-5, 6e-3  # tests/test_engine.py::test_client_chunk_matches_full_vmap
LEDGER = ("cohort", "dropped", "down_bytes", "up_bytes")


def sim():
    return simulate.SimConfig(local_steps=1, client_lr=0.1)


def jsim():
    return jsimulate.SimConfig(local_steps=1, client_lr=0.1)


@pytest.fixture(scope="module")
def init():
    jp = jax.jit(lambda k: jcf_init(k))(jax.random.PRNGKey(0))
    return jp, interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def jcf_init(k):
    from repro.models import conformer as jcf

    return jcf.init(k, JCFG)


def _leaves(storage):
    return {p: v.numpy() for p, v in tree_items(decompress_tree(storage))}


def _jleaves(storage):
    return {tuple(k.key for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jdecompress(storage))[0]}


def assert_within_gate(tree, other, m, om):
    """The reference's gate between chunk widths: ledgers exact, every metric
    within relative 1e-5, every leaf within 6e-3."""
    assert {k: m[k] for k in LEDGER} == {k: om[k] for k in LEDGER}
    assert m == pytest.approx(om, rel=REL)
    assert sorted(tree) == sorted(other)
    for path, x in tree.items():
        np.testing.assert_allclose(x, other[path], atol=ATOL, err_msg=str(path))


def port_round(params, chunk, **kw):
    from repro_torch.federated.state import compress_params

    specs, omc = cf.param_specs(CFG), OMCConfig.parse(FMT)
    return engine.run_round_vectorized(
        cf, CFG, specs, omc, sim(), compress_params(params, specs, omc), data,
        engine.CohortSpec(PLAN, client_chunk=chunk), 0, prng.PRNGKey(0),
        wire_table=accounting.build_wire_table(params, specs, omc), **kw)


@pytest.fixture(scope="module")
def port_rounds(init):
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # a vmap fallback is a failure
            return {chunk: port_round(init[1], chunk) for chunk in (None, 4, 1)}
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)


@pytest.mark.parametrize("chunk", [4, 1], ids=["chunk4", "chunk1"])
def test_engine_matches_reference_at_each_chunk(init, port_rounds, chunk):
    from repro.federated.state import compress_params as jcompress_params
    from repro.models import conformer as jcf

    jspecs, jomc = jcf.param_specs(JCFG), JOMC.parse(FMT)
    jstorage, jm = jengine.run_round_vectorized(
        jcf, JCFG, jspecs, jomc, jsim(), jcompress_params(init[0], jspecs, jomc), jdata,
        jengine.CohortSpec(JPLAN_, client_chunk=chunk), 0, jax.random.PRNGKey(0),
        wire_table=jaccounting.build_wire_table(init[0], jspecs, jomc))
    storage, m = port_rounds[chunk]
    assert_within_gate(_leaves(storage), _jleaves(jstorage), m, jm)


@pytest.mark.parametrize("chunk", [None, 4], ids=["vmap", "chunk4"])
def test_batched_matches_serial(port_rounds, chunk):
    (storage, m), (serial, sm) = port_rounds[chunk], port_rounds[1]
    a, b = _leaves(storage), _leaves(serial)
    assert_within_gate(a, b, m, sm)
    equal = sum(np.array_equal(a[p], b[p]) for p in a)
    print(f"client_chunk={chunk} against 1: {equal} of {len(a)} leaves bit-equal, "
          f"loss {m['loss']!r} against {sm['loss']!r}")


def test_client_chunk_must_divide_larger_quotas():
    with pytest.raises(ValueError, match="client_chunk 3 must divide"):
        engine.CohortSpec(PLAN, client_chunk=3)


def test_error_feedback_batched_against_serial(init):
    """Top-k 0.1 with error feedback, 2 rounds: the serial and batched paths'
    residuals.  Dead clients keep their rows (the same bits); the others
    agree within 1e-6 but for at most 2 threshold flips a round."""
    specs, omc = cf.param_specs(CFG), OMCConfig.parse(FMT)
    topk = get_strategy("topk", density=0.1)
    out = {}
    for chunk in (None, 1):
        ef = feedback.init_ef_state(init[1], specs, omc, PLAN.num_clients)
        storage, hist = engine.run_training_vectorized(
            cf, CFG, omc, sim(), engine.CohortSpec(PLAN, client_chunk=chunk), data,
            prng.PRNGKey(0), 2, init_params=init[1], strategy=topk, ef=ef)
        out[chunk] = (_leaves(storage), hist, ef)
    (a, ha, efa), (b, hb, efb) = out[None], out[1]
    for x, y in zip(ha, hb):
        assert {k: x[k] for k in LEDGER} == {k: y[k] for k in LEDGER}
        assert x["loss"] == pytest.approx(y["loss"], rel=REL)
    for p in a:
        np.testing.assert_allclose(a[p], b[p], atol=ATOL, err_msg=str(p))
    key = prng.fold_in(prng.PRNGKey(0), 0xC047)
    touched = set()
    for r in range(2):
        ids = engine.sample_tiered_cohort(key, engine.CohortSpec(PLAN), r)[0].numpy()
        alive = np.asarray(engine.cohort_lib.survival_mask(key, PLAN, r).numpy(), bool)
        touched |= set(ids[alive].tolist())
    flips, equal = 0, 0
    for k in efa:
        for c in range(PLAN.num_clients):
            x, y = efa[k][c], efb[k][c]
            if c not in touched:  # never a live upload: the zero row, unchanged
                assert torch.equal(x, y) and not bool(x.any()), (k, c)
                continue
            d = (x - y).abs()
            flips += int((d > 1e-6).sum())
            equal += int(torch.equal(x, y))
    assert flips <= 2 * 2, flips
    print(f"EF rows: {flips} flips over 2 rounds, {equal} live rows bit-equal")


# ---------------------------------------------------------------------------
# The async runtime: train_capacity and make_batch_train_fn
# ---------------------------------------------------------------------------


STRAGGLER = dict(clients=10, goal=4, decay=0.5, max_staleness=1, flushes=2)


def _async_cfg(mod, capacity):
    return mod.AsyncConfig(buffer_goal=STRAGGLER["goal"], decay=STRAGGLER["decay"],
                           max_staleness=STRAGGLER["max_staleness"], train_capacity=capacity)


def _port_async(init, capacity):
    obs = Obs("port", metrics=False)
    r = async_engine.AsyncRunner(cf, CFG, OMCConfig.parse(FMT), sim(),
                                 _async_cfg(async_engine, capacity),
                                 traces.ParetoTrace(seed=0, latency=1.0, alpha=1.5),
                                 num_clients=STRAGGLER["clients"], data_fn=data,
                                 init_params=init[1], obs=obs)
    r.run_until(flushes=STRAGGLER["flushes"])
    return r, [(s.args["version"], s.args["lanes"])
               for s in obs.tracer.spans(WALL, "dispatch")]


@pytest.fixture(scope="module")
def reference_async(init):
    """The reference's straggler run at ``train_capacity=3``, with its spans."""
    from repro.models import conformer as jcf

    jobs = JObs("ref", metrics=False)
    jr = jae.AsyncRunner(jcf, JCFG, JOMC.parse(FMT), jsim(), _async_cfg(jae, 3),
                         jtraces.ParetoTrace(seed=0, latency=1.0, alpha=1.5),
                         num_clients=STRAGGLER["clients"], data_fn=jdata, init_params=init[0],
                         obs=jobs)
    jr.run_until(flushes=STRAGGLER["flushes"])
    return jr, [(s.args["version"], s.args["lanes"]) for s in jobs.tracer.spans(WALL, "dispatch")]


@pytest.mark.parametrize("capacity", [3, 1, None], ids=["cap3", "cap1", "goal"])
def test_async_capacity_matches_reference(init, reference_async, capacity):
    jr, want = reference_async
    r, spans = _port_async(init, capacity)
    assert len(r.history) == len(jr.history)
    for a, b in zip(r.history, jr.history):
        assert {k: v for k, v in a.items() if k != "loss"} == \
            {k: v for k, v in b.items() if k != "loss"}
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-4)
    tree, jtree = _leaves(r.storage), _jleaves(jr.storage)
    for p in tree:
        np.testing.assert_allclose(tree[p], jtree[p], atol=ATOL, err_msg=str(p))
    cap = capacity or STRAGGLER["goal"]
    if capacity == 3:
        assert spans == want  # one dispatch span per training call, as the reference's
    # the same lanes trained under each version, in calls of at most cap lanes:
    # a group of g lanes in ceil(g / cap) calls, all full but its last
    lanes = {}
    for v, n in spans:
        lanes[v] = lanes.get(v, 0) + n
    jlanes = {}
    for v, n in want:
        jlanes[v] = jlanes.get(v, 0) + n
    assert lanes == jlanes and all(1 <= n <= cap for _, n in spans)
    assert len(spans) >= sum(math.ceil(g / cap) for g in lanes.values())
    if capacity == 1:
        assert len(spans) == sum(lanes.values())


def test_async_capacity_validation_and_batch_train_fn(init):
    with pytest.raises(ValueError, match="train_capacity must be >= 1, got 0") as got:
        async_engine.AsyncConfig(buffer_goal=4, train_capacity=0)
    with pytest.raises(ValueError) as want:
        jae.AsyncConfig(buffer_goal=4, train_capacity=0)
    assert str(got.value) == str(want.value)
    assert async_engine.AsyncConfig(4).capacity == 4
    assert async_engine.AsyncConfig(4, train_capacity=2).capacity == 2
    # make_batch_train_fn: the reference's signature, each lane keyed by its
    # own round; a lane equals the serial body's client on its own round
    from repro_torch.federated.state import compress_params

    specs, omc = cf.param_specs(CFG), OMCConfig.parse(FMT)
    storage = compress_params(init[1], specs, omc)
    fn = async_engine.make_batch_train_fn(cf, CFG, specs, omc, sim(), data, 3)
    models, losses = fn(storage, torch.tensor([2, 7, 2]), torch.tensor([0, 1, 1]))
    assert losses.shape == (3,)
    one = simulate.make_client_fn(cf, CFG, specs, omc, sim())
    m, loss = one(decompress_tree(storage), simulate.client_batches(data, 7, 1, 1), 1, 7)
    for (p, x), (_, y) in zip(tree_items(m), tree_items(models)):
        np.testing.assert_allclose(x.numpy(), y[1].numpy(), atol=ATOL, err_msg=str(p))
    assert float(loss) == pytest.approx(float(losses[1]), rel=REL)
    assert not torch.equal(losses[0], losses[2])  # client 2's two rounds draw apart
    with pytest.raises(ValueError, match="capacity of 3"):
        fn(storage, [0, 1, 2, 3], [0, 0, 0, 0])


# ---------------------------------------------------------------------------
# Families
# ---------------------------------------------------------------------------


TCFG = transformer.TransformerConfig(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                                     vocab=64)
LM = make_lm_task(vocab=64, seq_len=16, num_clients=16, device="cpu")


def lm_data(c, r, s):
    return LM.batch(c, r, s, 2)


def test_transformer_trains_batched():
    """The dense transformer's engine round batched against serial, under
    OMC and under top-k with error feedback."""
    params = transformer.init(prng.PRNGKey(1), TCFG)
    omc = OMCConfig.parse(FMT)
    for strategy in (None, get_strategy("topk", density=0.1)):
        out = {}
        for chunk in (None, 1):
            storage, hist = engine.run_training_vectorized(
                transformer, TCFG, omc, sim(), engine.CohortSpec(PLAN, client_chunk=chunk),
                lm_data, prng.PRNGKey(1), 1, init_params=params, strategy=strategy)
            out[chunk] = (_leaves(storage), hist[0])
        assert_within_gate(*out[None][:1], *out[1][:1], out[None][1], out[1][1])


@pytest.mark.parametrize("name", ["griffin", "xlstm"])
def test_recurrent_families_raise_for_more_than_one_client(name):
    """griffin and xlstm have no batched body: C > 1 raises, naming the
    family; C = 1 runs the one-client body."""
    from repro_torch.configs.registry import get_arch

    family = dict(griffin=griffin, xlstm=xlstm)[name]
    arch = dict(griffin="recurrentgemma-2b", xlstm="xlstm-350m")[name]
    cfg = get_arch(arch).smoke_config()
    params = family.init(prng.PRNGKey(0), cfg)
    specs, omc = family.param_specs(cfg), OMCConfig.parse(FMT)
    task = make_lm_task(vocab=cfg.vocab, seq_len=8, num_clients=4, device="cpu")
    batch_fn = simulate.make_batch_client_fn(family, cfg, specs, omc, sim())
    batches = simulate.cohort_batches(lambda c, r, s: task.batch(c, r, s, 1), [0, 1], [0, 0], 1)
    with pytest.raises(ValueError, match=f"the {name} family has no batched client body"):
        batch_fn(params, batches, [0, 0], [0, 1])
    models, losses, rows = batch_fn(params, [{k: v[:1] for k, v in b.items()}
                                             for b in batches], [0], [0])
    one = simulate.make_client_fn(family, cfg, specs, omc, sim())
    m, loss = one(params, simulate.client_batches(lambda c, r, s: task.batch(c, r, s, 1),
                                                  0, 0, 1), 0, 0)
    assert torch.equal(losses[0], loss) and rows == {}
    assert all(torch.equal(x, y[0]) for (_, x), (_, y) in zip(tree_items(m), tree_items(models)))
