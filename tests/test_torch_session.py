"""PyTorch port vs the JAX reference: the FL sessions over the wire codec.

Both packages run ``FLSession`` / ``FLClient`` at the reference's test size
(transformer, 2 layers, d 32, vocab 128, ``CohortPlan(4, 2)``), each from
the reference's init, carried across with ``interop.params_from_numpy``.

Gates, on what is defined in bits:

  * with a bit-exact client update (the first leaf times 0.9, as
    tests/test_async_engine.py's session test trains), per round: cohort
    ids, whether a delta exists, ``issued_bytes`` and ``issued_delta``, every
    payload's length, the ``metrics`` dicts and the storage codes are equal;
    (s, b) within tests/test_torch_store.py's bounds (rtol 1e-4 on s, atol
    1e-5 on b), since each package solves its own;
  * payloads of a storage carried across bit for bit are the same bytes;
  * one SGD step per client on token batches drawn once with numpy: losses
    within 1e-3, decompressed trees within the engine's gates (max |d|
    6e-3, mean |d| 1e-3);
  * the async protocol (same update): ``server_version`` after each ingest,
    ``async_history``, ``took_delta`` and the kept version storages equal,
    and a delta download decodes to the full payload's tree in the same
    bits;
  * the reference's guards, one for one, with the same exception types; the
    client's delta choice by cache digest; serving from a payload;
  * the strategy uploads (``strategy=`` on both sides) under top-k with
    error feedback, ternary (EF) and the pipeline (EF): on the same received
    and trained trees (carried across from numpy) ``FLClient._strategy_upload``
    gives top-k's and the pipeline's payloads in the same bytes (the inputs
    hold no tie at a threshold, ROADMAP C17) and ternary's of the same length
    decoding to values within its scale's gate (ROADMAP C18: rtol 4e-6, atol
    1e-7, as tests/test_torch_feedback.py), two rounds, the residuals within
    1e-6 (a code flip would show as a gap of a whole scale); one session
    round a strategy, each side decoding its own downloads (which differ in
    the last bits: each package solves its own PVT) and adding a fixed numpy
    update (0.02·N(0, 1) a value, so no top-k threshold lies within those
    bits): the cohort and the upload lengths of the shape-determined
    strategies equal, ``close_round``'s storage within the gate above.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import codecs as jcodecs
from repro.api.session import FLClient as JClient
from repro.api.session import FLSession as JSession
from repro.core.omc import OMCConfig as JOMC
from repro.federated.cohort import CohortPlan as JPlan
from repro.models import transformer as jtr
from repro.models.common import IDENTITY_MAT as JIDENTITY
from repro_torch import interop
from repro_torch.api import codecs
from repro_torch.api.session import FLClient, FLSession, ServeSession
from repro_torch.compress import decode_tree
from repro_torch.core.omc import OMCConfig
from repro_torch.core.store import decompress_tree, is_compressed, trees_bit_equal
from repro_torch.core.tree import tree_items, tree_map, tree_map_with_path
from repro_torch.federated.cohort import CohortPlan
from repro_torch.federated.simulate import sgd_steps
from repro_torch.federated.state import compress_params
from repro_torch.models import transformer as tr

torch.set_num_threads(1)

JCFG = jtr.TransformerConfig(n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
                             vocab=128)
CFG = tr.TransformerConfig(n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64, vocab=128)
JOMC_, OMC = JOMC.parse("S1E3M7"), OMCConfig.parse("S1E3M7")
TREE_MAX, TREE_MEAN = 6e-3, 1e-3


@pytest.fixture(scope="module")
def jinit():
    # jit: one compiled program instead of many small eager ones (same math)
    return jax.jit(lambda k: jtr.init(k, JCFG))(jax.random.PRNGKey(0))


def _sessions(jinit, plan=(4, 2)):
    js = JSession(jtr, JCFG, JOMC_, plan=JPlan(*plan) if plan else None, init_params=jinit)
    ps = FLSession(tr, CFG, OMC, plan=CohortPlan(*plan) if plan else None,
                   init_params=interop.params_from_numpy(jinit, device="cpu"), device="cpu")
    return js, ps


def _jscale(params, factor=0.9):
    leaves, treedef = jax.tree_util.tree_flatten(params)
    return jax.tree_util.tree_unflatten(treedef, [leaves[0] * factor] + leaves[1:])


def _scale(params, factor=0.9):
    first = next(tree_items(params))[0]
    return tree_map_with_path(lambda path, x: x * factor if path == first else x, params)


def _jleaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: hasattr(x, "codes"))[0]
    return {tuple(k.key for k in p): v for p, v in flat}


def assert_storage_matches(storage, jstorage):
    """Codes and raw leaves equal; (s, b) within test_torch_store's bounds."""
    got, want = dict(tree_items(storage)), _jleaves(jstorage)
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        w = want[path]
        assert is_compressed(leaf) == hasattr(w, "codes"), path
        if is_compressed(leaf):
            np.testing.assert_array_equal(leaf.codes.numpy(), np.asarray(w.codes), err_msg=str(path))
            np.testing.assert_allclose(leaf.s.numpy(), np.asarray(w.s), rtol=1e-4)
            np.testing.assert_allclose(leaf.b.numpy(), np.asarray(w.b), atol=1e-5)
        else:
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(w), err_msg=str(path))


def assert_trees_within(storage, jstorage):
    got = dict(tree_items(decompress_tree(storage)))
    want = {p: np.asarray(v.dequantize() if hasattr(v, "codes") else v)
            for p, v in _jleaves(jstorage).items()}
    for path, x in got.items():
        d = np.abs(x.numpy() - want[path])
        assert d.max() <= TREE_MAX and d.mean() <= TREE_MEAN, (path, d.max(), d.mean())


@pytest.fixture(scope="module")
def sync_runs(jinit):
    """Two rounds of both packages with the bit-exact update; per round the
    tickets, uploads and metrics, and the reference session at the end."""
    js, ps = _sessions(jinit)
    jclients = {c: JClient(c, jtr, JCFG, JOMC_, lambda p, c, r: _jscale(p)) for c in range(4)}
    clients = {c: FLClient(c, tr, CFG, OMC, lambda p, c, r: _scale(p), device="cpu")
               for c in range(4)}
    rounds = []
    for _ in range(2):
        jt, pt = js.begin_round(), ps.begin_round()
        ups = []
        for cid in jt.client_ids:
            ju, pu = jclients[cid].run_round(jt), clients[cid].run_round(pt)
            ups.append((len(ju), len(pu)))
            js.ingest(cid, ju)
            ps.ingest(cid, pu)
        rounds.append(dict(tickets=(jt, pt), uploads=ups, metrics=(js.close_round(),
                                                                   ps.close_round()),
                           storage=ps.storage, jstorage=js.storage))
    return js, ps, rounds


def test_two_rounds_with_a_bit_exact_update_match_reference(sync_runs):
    _, _, rounds = sync_runs
    for r, rec in enumerate(rounds):
        jt, pt = rec["tickets"]
        assert pt.round_index == jt.round_index == r
        assert pt.client_ids == jt.client_ids and len(pt.client_ids) == 2
        assert (pt.delta_payload is None) == (jt.delta_payload is None) == (r == 0)
        assert len(pt.payload) == len(jt.payload)
        if r:
            assert len(pt.delta_payload) == len(jt.delta_payload) < len(pt.payload)
        assert pt.issued_bytes == jt.issued_bytes and pt.issued_delta == jt.issued_delta
        for jlen, plen in rec["uploads"]:
            assert plen == jlen
        jm, pm = rec["metrics"]
        assert pm == jm
        assert_storage_matches(rec["storage"], rec["jstorage"])


def test_server_payloads_of_a_carried_storage_are_byte_equal(sync_runs):
    js, ps, _ = sync_runs
    carried = FLSession(tr, CFG, OMC, plan=CohortPlan(4, 2), device="cpu")
    carried.storage = interop.storage_from_numpy(js.storage, device="cpu")
    carried._prev_storage = interop.storage_from_numpy(js._prev_storage, device="cpu")
    carried.round_index = js.round_index
    full, delta = carried.server_payload(), carried.server_payload(delta=True)
    assert full == js.server_payload()
    assert delta == js.server_payload(delta=True)
    assert codecs.header_base_digest(delta) == jcodecs.tree_digest(js._prev_storage)
    assert codecs.tree_digest(carried.storage) == jcodecs.tree_digest(js.storage)
    # and the port's own storage decodes from the reference's bytes as encoded
    tree, info = codecs.decode_payload(full, device="cpu")
    assert not info.is_delta and trees_bit_equal(tree, carried.storage)
    assert len(ps.server_payload()) == len(full)


ROUNDS = 1  # one round of the SGD case: the reference's grad compiles once


def test_one_sgd_step_per_client_matches_reference(jinit):
    rng = np.random.default_rng(7)
    toks = {(c, r): rng.integers(0, CFG.vocab, (2, 17), dtype=np.int32)
            for c in range(4) for r in range(2)}

    @jax.jit
    def jsgd(params, tokens):
        batch = dict(tokens=tokens[:, :-1], labels=tokens[:, 1:])
        loss, g = jax.value_and_grad(lambda p: jtr.loss(JCFG, p, batch, JIDENTITY))(params)
        return jax.tree_util.tree_map(lambda w, gg: w - 0.05 * gg, params, g), loss

    jlosses, losses = {}, {}

    def jtrain(params, cid, r):
        out, jlosses[cid, r] = jsgd(params, jnp.asarray(toks[cid, r]))
        return out

    def train(params, cid, r):
        t = torch.from_numpy(toks[cid, r]).long()
        out, step_losses = sgd_steps(tr, CFG, params, [dict(tokens=t[:, :-1], labels=t[:, 1:])],
                                     0.05)
        losses[cid, r] = float(step_losses.mean())
        return out

    js, ps = _sessions(jinit)
    jclients = {c: JClient(c, jtr, JCFG, JOMC_, jtrain) for c in range(4)}
    clients = {c: FLClient(c, tr, CFG, OMC, train, device="cpu") for c in range(4)}
    for _ in range(ROUNDS):
        jt, pt = js.begin_round(), ps.begin_round()
        assert pt.client_ids == jt.client_ids
        for cid in jt.client_ids:
            js.ingest(cid, jclients[cid].run_round(jt))
            ps.ingest(cid, clients[cid].run_round(pt))
        jm, pm = js.close_round(), ps.close_round()
        assert {k: pm[k] for k in ("round", "reports", "invited", "down_fp32_bytes",
                                   "up_fp32_bytes")} == \
            {k: jm[k] for k in ("round", "reports", "invited", "down_fp32_bytes",
                                "up_fp32_bytes")}
    assert sorted(losses) == sorted(jlosses)
    for k, v in losses.items():
        assert abs(v - float(jlosses[k])) <= 1e-3, (k, v, jlosses[k])
    assert_trees_within(ps.storage, js.storage)


def _async_protocol(sess, client_train, compress, encode, decode, digest, leaves_of):
    """tests/test_async_engine.py's protocol: three check-ins at v0, two
    uploads flush, a stale third upload, a returning client with a delta."""
    def upload_for(ticket, held=None):
        blob = ticket.payload_for(held_digest=digest(held) if held is not None else 0)
        tree, info = decode(blob, held)
        up = encode(compress(client_train(tree)), tree, ticket.server_version)
        return tree, up

    rec = dict(versions=[], took_delta=[])
    sess.enable_async(2, decay=1.0)
    t0, t1, t2 = sess.checkin(0), sess.checkin(1), sess.checkin(2)
    tree0, up0 = upload_for(t0)
    _, up1 = upload_for(t1)
    for cid, up in ((0, up0), (1, up1)):
        sess.ingest_async(cid, up)
        rec["versions"].append(sess.server_version)
    _, up2 = upload_for(t2)
    sess.ingest_async(2, up2)
    rec["versions"].append(sess.server_version)
    t0b = sess.checkin(0, held_version=0)
    tree, up = upload_for(t0b, held=tree0)
    rec["took_delta"] = [t0.took_delta, t1.took_delta, t2.took_delta, t0b.took_delta]
    rec["delta_bits"] = [leaves_of(tree), leaves_of(decode(t0b.payload, None)[0])]
    rec["lens"] = [len(t0b.payload), len(t0b.delta_payload), len(up)]
    sess.ingest_async(0, up)
    rec["versions"].append(sess.server_version)
    rec["kept"] = sorted(sess._version_storages)
    rec["history"] = sess.async_history
    return rec


def test_async_protocol_matches_reference(jinit):
    js, ps = _sessions(jinit, plan=(4, 3))
    jspecs, specs = jtr.param_specs(JCFG), tr.param_specs(CFG)
    from repro.core.store import decompress_tree as jdecompress
    from repro.federated.state import compress_params as jcompress

    def jleaves_of(tree):
        return [np.asarray(x.codes if hasattr(x, "codes") else x)
                for x in _jleaves(tree).values()]

    def leaves_of(tree):
        return [(x.codes if is_compressed(x) else x).numpy() for _, x in tree_items(tree)]

    want = _async_protocol(
        js, lambda t: _jscale(jdecompress(t)), lambda p: jcompress(p, jspecs, JOMC_),
        lambda t, base, v: jcodecs.encode_payload(t, base=base, round_index=v),
        lambda b, base: jcodecs.decode_payload(b, base=base), jcodecs.tree_digest, jleaves_of)
    got = _async_protocol(
        ps, lambda t: _scale(decompress_tree(t)), lambda p: compress_params(p, specs, OMC),
        lambda t, base, v: codecs.encode_payload(t, base=base, round_index=v),
        lambda b, base: codecs.decode_payload(b, base=base, device="cpu"), codecs.tree_digest,
        leaves_of)
    assert got["versions"] == want["versions"] == [0, 1, 1, 2]
    assert got["took_delta"] == want["took_delta"] == [False, False, False, True]
    assert got["kept"] == want["kept"]
    assert got["history"] == want["history"] and len(got["history"]) == 2
    assert got["history"][-1]["staleness_max"] == 1
    assert got["lens"] == want["lens"] and got["lens"][1] < got["lens"][0]
    for delta_tree, full_tree in zip(*got["delta_bits"]):
        np.testing.assert_array_equal(delta_tree, full_tree)
    assert_storage_matches(ps.storage, js.storage)


def test_fl_session_guards_match_reference(jinit):
    """tests/test_api_wire.py::test_fl_session_guards on the port."""
    _, sess = _sessions(jinit)
    with pytest.raises(RuntimeError):
        sess.ingest(0, b"")
    ticket = sess.begin_round()
    with pytest.raises(RuntimeError):
        sess.begin_round()
    outsider = [c for c in range(4) if c not in ticket.client_ids][0]
    with pytest.raises(KeyError):
        sess.ingest(outsider, b"")
    with pytest.raises(RuntimeError):
        sess.close_round()  # zero reports


def test_async_session_guards_match_reference(jinit):
    """tests/test_async_engine.py::test_async_session_guards on the port."""
    _, sess = _sessions(jinit)
    with pytest.raises(RuntimeError):
        sess.checkin(0)  # enable_async first
    with pytest.raises(ValueError):
        sess.enable_async(0)  # same gate as report_goal
    with pytest.raises(ValueError):
        sess.enable_async(3)  # > plan.cohort_size
    sess.enable_async(2)
    sess.checkin(0)
    with pytest.raises(RuntimeError):
        sess.checkin(0)  # one open ticket per client
    with pytest.raises(KeyError):
        sess.ingest_async(3, b"")  # never checked in


def test_unported_arguments_name_the_roadmap(tmp_path):
    """Since the population store came (ROADMAP A9) its arguments no longer
    raise: ``population=`` backs the runner's counters and the population
    checkpoints round-trip; ``strategy=`` and ``obs=`` on the sessions no
    longer raise."""
    from repro_torch.checkpoint import restore_population_state, save_population_state
    from repro_torch.core import prng
    from repro_torch.federated import async_engine, simulate
    from repro_torch.models import conformer
    from repro_torch.obs import Obs
    from repro_torch.scale import ArrayCounters, PopulationStore, ShardLayout

    ccfg = conformer.ConformerConfig(n_layers=1, d_model=16, n_heads=2, d_ff=32, n_classes=8,
                                     d_in=4)
    store = PopulationStore(ShardLayout(4, 2), device="cpu")
    runner = async_engine.AsyncRunner(conformer, ccfg, OMC, simulate.SimConfig(),
                                      async_engine.AsyncConfig(2), num_clients=4, data_fn=None,
                                      init_key=prng.PRNGKey(0), population=store, device="cpu")
    assert isinstance(runner.event_counters, ArrayCounters) and runner.population is store
    restore_population_state(save_population_state(str(tmp_path), 0, store),
                             PopulationStore(ShardLayout(4, 2), device="cpu"))
    obs = Obs("sessions", out_dir=str(tmp_path))
    sess = FLSession(tr, CFG, OMC, strategy="omc", obs=obs, device="cpu")
    assert sess.strategy.name == "omc" and sess.obs is obs
    client = FLClient(0, tr, CFG, OMC, lambda p, c, r: p, strategy="topk", obs=obs, device="cpu")
    assert client.strategy.name == "topk" and client.strategy.error_feedback
    assert ServeSession(tr, CFG, sess.storage, obs=obs).obs is obs
    with pytest.raises(ValueError, match="bfloat16"):
        ServeSession(tr, CFG, sess.storage, compute_dtype=torch.bfloat16)


def test_client_delta_choice_by_cache_digest():
    """tests/test_api_wire.py::test_client_delta_choice_by_cache_digest on the
    port: a client whose cache matches round r-1 takes the delta; a client
    that skipped a round falls back to the full payload."""
    sess = FLSession(tr, CFG, OMC, device="cpu")  # plan=None: client 0 every round
    fresh, stale = (FLClient(0, tr, CFG, OMC, lambda p, c, r: _scale(p), device="cpu")
                    for _ in range(2))

    ticket = sess.begin_round()
    sess.ingest(0, fresh.run_round(ticket))
    stale.run_round(ticket)  # participates, but only one report is ingested
    assert ticket.issued_bytes == [len(ticket.payload)] * 2
    sess.close_round()

    ticket = sess.begin_round()
    sess.ingest(0, fresh.run_round(ticket))
    assert ticket.issued_bytes == [len(ticket.delta_payload)]
    sess.close_round()

    ticket = sess.begin_round()
    sess.ingest(0, stale.run_round(ticket))
    assert ticket.issued_bytes == [len(ticket.payload)]
    sess.close_round()


def test_serve_session_from_payload_and_hot_swap_bit_transparent():
    sess = FLSession(tr, CFG, OMC, device="cpu")
    payload = sess.server_payload()
    serve = ServeSession.from_payload(tr, CFG, payload, device="cpu")
    assert trees_bit_equal(serve.storage, sess.storage)
    info = serve.hot_swap(payload)
    assert not info.is_delta and trees_bit_equal(serve.storage, sess.storage)
    cache = serve.init_cache(1, 16)
    with torch.no_grad():
        _, gen = serve.generate(dict(tokens=torch.zeros((1, 4), dtype=torch.long)), cache, 3)
    assert gen.shape == (1, 3)
    assert serve.serve_stats()["swaps"] == 1 and serve.serve_stats()["queries"] == 1


STRATEGIES = ["topk", "ternary", "pipeline"]
RESID = 1e-6


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _update(like, seed):
    """A fixed update drawn with numpy: 0.02 * N(0, 1) per value."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (0.02 * rng.standard_normal(x.shape)).astype(np.float32), like)


def _trained(received, r):
    return jax.tree_util.tree_map(np.add, received, _update(received, 100 + r))


@pytest.mark.parametrize("name", STRATEGIES)
def test_strategy_upload_matches_reference(jinit, name):
    jclient = JClient(0, jtr, JCFG, JOMC_, None, strategy=name)
    client = FLClient(0, tr, CFG, OMC, None, strategy=name, device="cpu")
    assert client.strategy.error_feedback and client.strategy.upload_only
    received = _np(jinit)
    for r in range(2):
        trained = _trained(received, r)
        jblob = jclient._strategy_upload(jax.tree_util.tree_map(jnp.asarray, received),
                                         jax.tree_util.tree_map(jnp.asarray, trained), r)
        blob = client._strategy_upload(interop.params_from_numpy(received, "cpu"),
                                       interop.params_from_numpy(trained, "cpu"), r)
        info = codecs.peek_payload(blob)
        assert info.strategy == name and len(blob) == len(jblob)
        if name == "ternary":  # the scale's f32 mean (C18): values within its gate
            got, want = (dict(tree_items(decode_tree(codecs.decode_payload(b, device="cpu")[0])))
                         for b in (blob, jblob))
            for path, x in got.items():
                np.testing.assert_allclose(x.numpy(), want[path].numpy(), rtol=4e-6,
                                           atol=1e-7, err_msg=str(path))
        else:
            assert blob == jblob, (name, r)
        jres = {p: np.asarray(v) for p, v in _jleaves(jclient._residual).items()}
        res = dict(tree_items(client._residual))
        assert sorted(res) == sorted(jres)
        for path, x in res.items():
            assert x.device.type == "cpu"
            d = np.abs(x.numpy() - jres[path])
            assert d.max() <= RESID, (name, r, path, d.max())
        received = trained  # the next round's download is this round's model


@pytest.mark.parametrize("name", STRATEGIES)
def test_one_session_round_under_a_strategy_matches_reference(jinit, name):
    js = JSession(jtr, JCFG, JOMC_, plan=JPlan(4, 2), init_params=jinit, strategy=name)
    ps = FLSession(tr, CFG, OMC, plan=CohortPlan(4, 2),
                   init_params=interop.params_from_numpy(jinit, device="cpu"), strategy=name,
                   device="cpu")
    assert ps.strategy.name == name
    ups = {c: _update(_np(jinit), c) for c in range(4)}
    jclients = {c: JClient(c, jtr, JCFG, JOMC_,
                           lambda p, c, r: jax.tree_util.tree_map(jnp.add, p, ups[c]),
                           strategy=name) for c in range(4)}
    clients = {c: FLClient(c, tr, CFG, OMC,
                           lambda p, c, r: tree_map(torch.add, p,
                                                    interop.params_from_numpy(ups[c], "cpu")),
                           strategy=name, device="cpu") for c in range(4)}
    jt, pt = js.begin_round(), ps.begin_round()
    assert pt.client_ids == jt.client_ids
    assert len(pt.payload) == len(jt.payload)  # downloads stay the OMC state
    for cid in jt.client_ids:
        jblob, blob = jclients[cid].run_round(jt), clients[cid].run_round(pt)
        assert codecs.peek_payload(blob).strategy == jcodecs.peek_payload(jblob).strategy
        if name != "pipeline":  # DEFLATE's length follows the data
            assert len(blob) == len(jblob)
        js.ingest(cid, jblob)
        ps.ingest(cid, blob)
        assert clients[cid]._residual is not None
    jm, pm = js.close_round(), ps.close_round()
    assert {k: pm[k] for k in ("round", "reports", "invited", "down_fp32_bytes")} == \
        {k: jm[k] for k in ("round", "reports", "invited", "down_fp32_bytes")}
    assert_trees_within(ps.storage, js.storage)


def test_dense_strategy_sends_the_whole_model():
    """``omc`` as a session strategy: the report is the decoded model itself
    (no base added), and the client keeps no residual."""
    sess = FLSession(tr, CFG, OMC, strategy="omc", device="cpu")
    client = FLClient(0, tr, CFG, OMC, lambda p, c, r: tree_map(lambda x: x * 0.5, p),
                      strategy="omc", device="cpu")
    ticket = sess.begin_round()
    blob = client.run_round(ticket)
    # a plain OMC frame (no tag), as the reference's client sends it
    assert codecs.peek_payload(blob).strategy is None and client._residual is None
    sess.ingest(0, blob)
    row = dict(tree_items(tree_map(lambda x: x[0], sess._report_stack)))
    sent = dict(tree_items(decode_tree(codecs.decode_payload(blob, device="cpu")[0])))
    for path, x in row.items():
        assert torch.equal(x, sent[path]), path
    sess.close_round()
    assert sess.round_index == 1 and decompress_tree(sess.storage) is not None
