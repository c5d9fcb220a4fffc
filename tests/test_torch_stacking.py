"""The cohort's trained models held once: rows stacked as each model is trained.

The engine's round and the async flush copy each trained model into its row
of ``[C, ...]`` stacks as soon as it exists (``simulate.stack_into``) and
zero dead clients' rows in place (``engine.zero_dead_rows_``), where they
once kept every model in a list, stacked the list into a second copy and
masked it into a third.  The summation runs on the same values in the same
order, so every result keeps its bits: the tests hold the new path against
the old composition (``simulate.stack_trees`` of the models, then
``engine.mask_dead_rows``) bit for bit, on the CPU, with the plain versions.
``mask_dead_rows`` on f32 leaves is also held against the reference's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.federated import engine as jengine
from repro_torch.core import prng
from repro_torch.core.formats import FloatFormat
from repro_torch.core.omc import OMCConfig
from repro_torch.core.store import (CompressedVariable, compress_variable, decompress_tree,
                                    trees_bit_equal)
from repro_torch.core.tree import tree_map, tree_map_with_path
from repro_torch.data.synthetic import make_frame_task
from repro_torch.federated import async_engine, cohort, engine, simulate, traces
from repro_torch.federated.state import compress_params, n_stack_axes
from repro_torch.kernels import ref
from repro_torch.models import conformer as cf

torch.set_num_threads(1)

CFG = cf.ConformerConfig(n_layers=2, d_model=32, n_heads=4, d_ff=64, n_classes=16, d_in=8)
TASK = make_frame_task(d_in=8, n_classes=16, seq_len=16, num_clients=8, device="cpu")
OMC = OMCConfig.parse("S1E3M7")
SIM = simulate.SimConfig(local_steps=1, client_lr=0.1)
ROWS = 5
ALIVE = [True, False, True, False, True]


def data(c, r, s):
    return TASK.batch(c, r, s, 2)


def _tree(seed: int):
    """An f32 tree with a 0-d leaf, and two compressed leaves: one stacked
    (per-entry (s, b)), one single; seed 1's tree has NaN and inf."""
    rng = np.random.default_rng(seed)

    def f32(*shape):
        return torch.from_numpy(np.asarray(rng.standard_normal(shape) * 0.1, np.float32))

    w = f32(3, 5, 16)
    if seed == 1:
        w[0, 0, :3] = torch.tensor([float("nan"), float("inf"), -float("inf")])
    fmt = FloatFormat.parse("S1E3M7")
    return dict(a=f32(7, 3), scalar=f32(), block=dict(w=compress_variable(w, fmt, batch_axes=1),
                                                      v=compress_variable(f32(33), fmt)))


def _alive():
    return torch.tensor(ALIVE)


@pytest.mark.parametrize("mask", [False, True], ids=["stack", "stack_and_mask"])
def test_stack_into_matches_stack_trees(mask):
    """Row by row into one set of stacks, then dead rows zeroed in place:
    the bits of ``stack_trees`` then ``mask_dead_rows``, NaN and inf in a
    dead row (row 1) included."""
    trees = [_tree(i) for i in range(ROWS)]
    stacked = None
    for i, t in enumerate(trees):
        stacked = simulate.stack_into(stacked, i, t, ROWS)
    want = simulate.stack_trees(trees)
    if mask:
        stacked = engine.zero_dead_rows_(stacked, _alive())
        want = engine.mask_dead_rows(want, _alive())
    assert trees_bit_equal(stacked, want)


def test_zero_dead_rows_zeroes_non_finite_rows():
    """A dead row holding NaN and inf becomes +0 in every leaf (codes, s and
    b too); live rows keep their bits."""
    trees = [_tree(i) for i in range(ROWS)]
    stacked = engine.zero_dead_rows_(simulate.stack_trees(trees), _alive())
    raw = simulate.stack_trees(trees)
    for i, ok in enumerate(ALIVE):
        for key in ("codes", "s", "b"):
            got = getattr(stacked["block"]["w"], key)[i]
            want = getattr(raw["block"]["w"], key)[i]
            assert torch.equal(got, want if ok else torch.zeros_like(want))
        row = stacked["block"]["w"].codes[i]
        assert bool((row == 0).all()) != ok
    dead = raw["block"]["w"][1]
    assert not torch.isfinite(ref.ref_dequantize(dead.codes, dead.fmt, dead.s, dead.b)).all()
    assert torch.equal(stacked["a"][1].view(torch.int32), torch.zeros(7, 3, dtype=torch.int32))


def test_mask_dead_rows_matches_reference_on_f32():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((ROWS, 4, 6)).astype(np.float32)
    x[1, 0, :2] = [np.nan, np.inf]
    got = engine.mask_dead_rows(dict(x=torch.from_numpy(x)), _alive())["x"]
    want = jengine.mask_dead_rows(dict(x=jnp.asarray(x)), jnp.asarray(ALIVE))["x"]
    np.testing.assert_array_equal(got.numpy().view(np.int32), np.asarray(want).view(np.int32))


@pytest.fixture(scope="module")
def setup():
    specs = cf.param_specs(CFG)
    params = cf.init(prng.PRNGKey(0), CFG, "cpu")
    with torch.no_grad():
        storage = compress_params(params, specs, OMC)
    return specs, storage


def _round_with_dead(spec):
    """A round index whose cohort has a dead client, and its ids and mask."""
    key = prng.PRNGKey(1)
    for r in range(20):
        alive = cohort.survival_mask(key, spec.plan, r)
        if not bool(alive.all()):
            return r, engine.sample_tiered_cohort(key, spec, r), alive
    raise AssertionError("no round with a dead client")


def _old_round(specs, storage, spec, ids_per_tier, alive, r, fused):
    """The round as a list of models, ``stack_trees`` and ``mask_dead_rows``
    (fused: the unselected leaves' dead rows only)."""
    one = simulate.make_client_fn(cf, CFG, specs, OMC, SIM)
    with torch.no_grad():
        server_f32 = decompress_tree(storage)
    models, losses = [], []
    for cid in ids_per_tier[0].tolist():
        m, loss = one(server_f32, simulate.client_batches(data, cid, r, SIM.local_steps), r, cid)
        models.append(m)
        losses.append(loss)
    with torch.no_grad():
        stacked = simulate.stack_trees(models)
        w = alive.to(torch.float32)
        if not fused:
            mean = cohort.aggregate_weighted(engine.mask_dead_rows(stacked, alive), w)
            return engine.apply_server_step(server_f32, mean, specs, OMC, SIM.server_lr), losses

        def encode(path, spec_t, srv, stack):
            if isinstance(srv, CompressedVariable):
                return CompressedVariable(*engine.transport_encode_stacked(
                    stack, srv.fmt, OMC.pvt, n_stack_axes(spec_t, srv.codes)), srv.fmt)
            return engine.mask_dead_rows(stack, alive)

        encoded = tree_map_with_path(encode, specs, storage, stacked)
        return engine.fused_server_step(storage, encoded, w, specs, OMC, SIM.server_lr), losses


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_engine_round_same_bits_as_stacked_models(setup, fused):
    specs, storage = setup
    spec = engine.CohortSpec(cohort.CohortPlan(8, 4, failure_rate=0.5))
    r, ids_per_tier, alive = _round_with_dead(spec)
    round_fn = engine.make_round_fn(cf, CFG, specs, OMC, SIM, spec, data, fused_agg=fused)
    got, loss, n_alive = round_fn(storage, ids_per_tier, alive, r)
    want, losses = _old_round(specs, storage, spec, ids_per_tier, alive, r, fused)
    assert int(n_alive) == int(alive.sum()) < alive.numel()
    assert trees_bit_equal(got, want)
    live = torch.stack(losses)[alive]
    assert float(loss) == float(live.sum() / alive.sum())


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_async_flush_same_bits_as_stacked_models(setup, fused, monkeypatch):
    """Each flush's storage equals the flush function applied to
    ``stack_trees`` of the buffered uploads (held aside before the flush
    drops them from its entries)."""
    specs, storage = setup
    params = decompress_tree(storage)
    runner = async_engine.AsyncRunner(
        cf, CFG, OMC, SIM, async_engine.AsyncConfig(buffer_goal=3, decay=0.5),
        traces.ParetoTrace(seed=0, latency=1.0, alpha=1.5), num_clients=6, data_fn=data,
        init_params=params, fused_agg=fused, device="cpu")
    flush, checked = runner._flush, []

    def checked_flush():
        k = runner.acfg.buffer_goal
        entries = runner.buffer[:k]
        models = [tree_map(lambda x: x, e.model) for e in entries]
        stale = np.asarray([runner.version - e.base_version for e in entries], np.float32)
        w = async_engine.flush_weights(stale, runner.acfg.decay, runner.acfg.decay_mode)
        want = runner._flush_fn(runner.storage, simulate.stack_trees(models), w)
        flush()
        assert all(e.model is None for e in entries)
        checked.append(trees_bit_equal(runner.storage, want))

    monkeypatch.setattr(runner, "_flush", checked_flush)
    runner.run_until(flushes=2)
    assert checked == [True, True]
