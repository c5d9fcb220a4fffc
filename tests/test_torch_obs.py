"""PyTorch port vs the JAX reference: telemetry (``repro_torch.obs``) and
``benchmarks_torch/compress_pareto.py``.

At the reference's tests/test_obs.py configuration (1-layer conformer, d 16,
cohort 8 of 16, failure rate 0.25, 2 local steps, S1E3M7, 2 rounds or
flushes), on the CPU:

  * **bit identity**: with a live ``Obs`` the port's loop, engine (unfused,
    fused, and unfused under top-k with error feedback at server lr 0.7)
    and async runtime (unfused and fused) keep their storage in the same
    bits and their history rows (ledgers included) in the same bytes as
    with ``obs=None``, and each run records two rounds or flushes with a
    finite ``update_norm``; ``qerr_norm`` only where a cohort mean exists
    (the unfused paths);
  * **bundle parity**: ``server_round_bundle`` (with and without a mean, and
    with the old tree in f32) and ``ef_rows_norm`` against the reference's
    on the same old, new and mean trees (an EF engine round's own) carried
    across, each norm within relative 1e-5 (reductions run in
    another order, ROADMAP C19), and
    ``chunk_partial_bundle`` on fixed inputs; and on every run above, each
    recorded bundle against the reference's built from that round's own
    trees: the storage the round started from (the init's for the first),
    the storage it returned and the cohort mean where it was made, spied
    outside the telemetry, and the EF run's ``ef_norm`` against the
    reference's over the rows of the reference's own cohort draw; a cached
    engine round built with another ``collect_metrics`` than the handle's
    raises (ROADMAP C21);
  * **record schema**: the engine's ``round`` record has the reference's keys
    (its bundle's, ``qerr/*`` included, from the reference's own
    ``server_round_bundle``), and its byte fields equal the reference's
    ``round_wire_metrics`` on the reference's cohort and survival draws (no
    reference engine runs);
  * tracer nesting and both clocks under a ``FixedTrace``; the JSONL and
    Perfetto schema round trip; the port's report renders a JSONL the
    reference's ``Obs`` wrote, and the reference's report the port's;
  * ``compress_pareto.py --smoke --static``: every byte column equals the
    reference's ``WireTable`` ledger, computed from the configs' shapes.
"""

import contextlib
import inspect
import io
import json
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compress import default_zoo as jdefault_zoo
from repro.core import store as jstore
from repro.core.formats import FloatFormat as JFloatFormat
from repro.core.omc import OMCConfig as JOMC
from repro.federated import accounting as jaccounting
from repro.federated import cohort as jcohort
from repro.federated import engine as jengine
from repro.federated.cohort import CohortPlan as JPlan
from repro.models import conformer as jcf
from repro.models import transformer as jtr
from repro.obs import Obs as JObs
from repro.obs import metrics as jmetrics
from repro.obs import report as jreport
from repro_torch.core import prng
from repro_torch.core.omc import OMCConfig
from repro_torch.compress import get_strategy
from repro_torch.core.store import decompress_tree, is_compressed, trees_bit_equal
from repro_torch.data.synthetic import make_frame_task
from repro_torch.federated import async_engine, engine, simulate, traces
from repro_torch.federated import cohort as cohort_mod
from repro_torch.federated.cohort import CohortPlan
from repro_torch.models import conformer as cf
from repro_torch.obs import Obs, maybe_span, null_span
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import report
from repro_torch.obs.export import JSONL_KINDS, read_jsonl, span_record, to_perfetto
from repro_torch.obs.log import Logger
from repro_torch.obs.trace import VIRTUAL, WALL, Span, Tracer

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
JCFG = jcf.ConformerConfig(n_layers=1, d_model=16, n_heads=2, d_ff=32, n_classes=8, d_in=4)
CFG = cf.ConformerConfig(**JCFG.__dict__)
JOMC_, OMC = JOMC.parse("S1E3M7"), OMCConfig.parse("S1E3M7")
PLAN = CohortPlan(num_clients=16, cohort_size=8, failure_rate=0.25)
TASK = make_frame_task(d_in=CFG.d_in, n_classes=CFG.n_classes, seq_len=12,
                       num_clients=PLAN.num_clients, device="cpu")
DATA_FN = lambda c, r, s: TASK.batch(c, r, s, 4)  # noqa: E731
SIM = simulate.SimConfig(local_steps=2, client_lr=0.1)
KEY = prng.PRNGKey(0)
REL = 1e-5  # a bundle norm against the reference's, relative


def _loop(obs):
    return simulate.run_training(cf, CFG, OMC, SIM, PLAN, DATA_FN, KEY, num_rounds=2,
                                 eval_every=100, wire=True, obs=obs, device="cpu")


def _engine(obs, fused=False, sim=SIM, **kw):
    return engine.run_training_vectorized(cf, CFG, OMC, sim, engine.CohortSpec(PLAN), DATA_FN,
                                          KEY, num_rounds=2, eval_every=100, obs=obs,
                                          fused_agg=fused, device="cpu", **kw)


def _async(obs, fused=False):
    st, hist, _ = async_engine.run_async_training(
        cf, CFG, OMC, SIM, async_engine.AsyncConfig(buffer_goal=8), traces.ParetoTrace(seed=1),
        DATA_FN, KEY, num_clients=16, flushes=2, wire=True, fused_agg=fused, obs=obs,
        device="cpu")
    return st, hist


SIM_EF = simulate.SimConfig(local_steps=2, client_lr=0.1, server_lr=0.7)
PATHS = {"loop": _loop, "engine": _engine, "engine_fused": lambda o: _engine(o, True),
         "engine_topk_ef": lambda o: _engine(o, sim=SIM_EF,
                                             strategy=get_strategy("topk", density=0.25)),
         "async": _async, "async_fused": lambda o: _async(o, True)}
SERVER_LR = {p: SIM_EF.server_lr if p == "engine_topk_ef" else SIM.server_lr for p in PATHS}


@contextlib.contextmanager
def _spy_rounds():
    """Record each round or flush that runs inside: the storage it started
    from, the storage it returned, the cohort means made during it (at
    ``cohort.aggregate_weighted``, where the server's mean is formed) and
    the EF residuals after it.  All are taken where the round makes them,
    not where the telemetry reads them."""
    rounds = []
    agg = cohort_mod.aggregate_weighted
    loop_round, engine_round = simulate.run_round, engine.run_round_vectorized
    flush = async_engine.AsyncRunner._flush

    def spy_agg(*a, **k):
        out = agg(*a, **k)
        if rounds and rounds[-1]["new"] is None:
            rounds[-1]["means"].append(out)
        return out

    def around(fn):
        sig = inspect.signature(fn)

        def wrapped(*a, **k):
            args = sig.bind(*a, **k).arguments
            rounds.append(dict(old=args["server_params"], new=None, means=[]))
            new, metrics = fn(*a, **k)
            rounds[-1]["new"] = new
            if args.get("ef"):
                rounds[-1]["ef"] = {n: v.clone() for n, v in args["ef"].items()}
            return new, metrics
        return wrapped

    def spy_flush(self):
        rounds.append(dict(old=self.storage, new=None, means=[]))
        flush(self)
        rounds[-1]["new"] = self.storage

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cohort_mod, "aggregate_weighted", spy_agg)
        mp.setattr(simulate, "run_round", around(loop_round))
        mp.setattr(engine, "run_round_vectorized", around(engine_round))
        mp.setattr(async_engine.AsyncRunner, "_flush", spy_flush)
        yield rounds


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each path run with ``obs=None`` and with a live handle, once; the
    live run's rounds spied (``_spy_rounds``)."""
    out = tmp_path_factory.mktemp("obs")
    res = {}
    for name, run in PATHS.items():
        obs = Obs(run_name=name, out_dir=str(out))
        off = run(None)
        with _spy_rounds() as rounds:
            on = run(obs)
        res[name] = (off, on, obs, rounds)
    return res


@pytest.mark.parametrize("path", list(PATHS))
def test_metrics_on_is_bit_identical(runs, path):
    (s0, h0), (s1, h1), obs, _ = runs[path]
    assert trees_bit_equal(s0, s1)
    assert h0 == h1  # every history row, the ledger's bytes included
    kind = "flush" if path.startswith("async") else "round"
    recs = obs.sink.records(kind)
    assert len(recs) == 2 and all(math.isfinite(r["update_norm"]) for r in recs)
    unfused = not path.endswith("fused")
    assert all(("qerr_norm" in r) == unfused for r in recs)
    assert all(any(k.startswith("qerr/") for k in r) == unfused for r in recs)
    for r, h in zip(recs, h1):
        assert {k: r[k] for k in h if k in r} == {k: v for k, v in h.items() if k in r}
    if kind == "flush":
        assert [len(r["staleness"]) for r in recs] == [8, 8]
        assert len(obs.tracer.spans(VIRTUAL, "client_round")) >= 16
        assert len(obs.tracer.spans(WALL, "flush")) == 2 and obs.tracer.spans(WALL, "dispatch")
    else:
        assert len(obs.tracer.spans(WALL, "round")) == 2
        assert [r["alive"] for r in recs] == [r["cohort"] for r in recs]


def _to_ref(tree):
    """A port tree on the CPU -> the reference's (``CompressedVariable``
    leaves to the reference's, tensors to ``jnp`` arrays)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to_ref(v) for k, v in tree.items()}
    if is_compressed(tree):
        return jstore.CompressedVariable(jnp.asarray(tree.codes.numpy()),
                                         jnp.asarray(tree.s.numpy()),
                                         jnp.asarray(tree.b.numpy()),
                                         JFloatFormat.parse(tree.fmt.name))
    return jnp.asarray(tree.detach().numpy())


@pytest.mark.parametrize("path", list(PATHS))
def test_recorded_bundles_match_reference_on_the_rounds_trees(runs, path):
    """Each round's record against the reference's ``server_round_bundle``
    on the trees the round itself started from, returned and averaged:
    a bundle built from another tree, another mean or another server lr
    than the round's fails here."""
    _, (storage, _), obs, rounds = runs[path]
    recs = obs.sink.records("flush" if path.startswith("async") else "round")
    assert len(rounds) == len(recs) == 2
    init = simulate.init_storage(cf, CFG, OMC, cf.param_specs(CFG), KEY, None, "cpu")[1]
    assert trees_bit_equal(rounds[0]["old"], init)
    assert trees_bit_equal(rounds[1]["old"], rounds[0]["new"])
    assert trees_bit_equal(rounds[1]["new"], storage)
    jspecs = jcf.param_specs(JCFG)
    fused = path.endswith("fused")
    for r, (rnd, rec) in enumerate(zip(rounds, recs)):
        # the fused server step forms no f32 mean (its exact leaves' means
        # are per leaf); an unfused round forms exactly one
        assert fused or len(rnd["means"]) == 1, len(rnd["means"])
        mean = None if fused else rnd["means"][0]
        want = jmetrics.server_round_bundle(jspecs, _to_ref(rnd["old"]), _to_ref(rnd["new"]),
                                            _to_ref(mean), SERVER_LR[path])
        assert want["update_norm"] > 0 and (fused or want["qerr_norm"] > 0)
        _rel_close({k: rec[k] for k in want}, want)
        assert {k for k in rec if k.startswith("qerr")} == {k for k in want
                                                             if k.startswith("qerr")}
        if "ef" in rnd:
            spec = jengine.CohortSpec(JPlan(num_clients=16, cohort_size=8, failure_rate=0.25))
            rkey = jax.random.fold_in(jax.random.PRNGKey(0), 0xC047)
            ids = np.concatenate([np.asarray(i) for i in
                                  jengine.sample_tiered_cohort(rkey, spec, r)])
            want_ef = jmetrics.ef_rows_norm({k: jnp.asarray(v[torch.from_numpy(ids)].numpy())
                                             for k, v in rnd["ef"].items()})
            assert float(want_ef) > 0
            _rel_close({"ef_norm": rec["ef_norm"]}, {"ef_norm": want_ef})
        else:
            assert "ef_norm" not in rec
    assert ("ef" in rounds[0]) == (path == "engine_topk_ef")


def test_cached_round_fn_must_match_collect_metrics(tmp_path):
    """A cached round built without the cohort mean under a live ``Obs``
    (or with it, without one) raises before the round runs; the reference
    builds a bundle without ``qerr`` instead (ROADMAP C21)."""
    specs, spec = cf.param_specs(CFG), engine.CohortSpec(PLAN)
    storage = simulate.init_storage(cf, CFG, OMC, specs, KEY, None, "cpu")[1]
    for collect, obs in ((False, Obs(run_name="c", out_dir=str(tmp_path))), (True, None)):
        fn = engine.make_round_fn(cf, CFG, specs, OMC, SIM, spec, DATA_FN,
                                  collect_metrics=collect)
        assert fn.collect_metrics is collect
        with pytest.raises(ValueError, match="collect_metrics"):
            engine.run_round_vectorized(cf, CFG, specs, OMC, SIM, storage, DATA_FN, spec, 0,
                                        KEY, round_fn=fn, obs=obs)


@pytest.fixture(scope="module")
def trees(runs):
    """The first round of the engine's top-k + EF run (server lr 0.7): the
    storage it started from, the storage it returned and its cohort mean,
    as the round made them, on both sides (carried across by ``_to_ref``)."""
    rnd = runs["engine_topk_ef"][3][0]
    port = dict(old=rnd["old"], new=rnd["new"], mean=rnd["means"][0])
    return dict(jspecs=jcf.param_specs(JCFG), **port,
                **{"j" + k: _to_ref(v) for k, v in port.items()})


def _rel_close(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        w = float(w)
        assert abs(float(got[k]) - w) <= REL * abs(w), (k, float(got[k]), w)


def test_server_round_bundle_matches_reference(trees):
    t = trees
    for mean, jmean in ((t["mean"], t["jmean"]), (None, None)):
        got = obs_metrics.server_round_bundle(cf.param_specs(CFG), t["old"], t["new"], mean, 0.7)
        want = jmetrics.server_round_bundle(t["jspecs"], t["jold"], t["jnew"], jmean, 0.7)
        _rel_close(got, want)
    assert len([k for k in want if k.startswith("qerr/")]) == 0  # the degraded form
    # the old tree may be f32 (the loop passes its decoded server model)
    got = obs_metrics.server_round_bundle(None, decompress_tree(t["old"]), t["new"], t["mean"],
                                          0.7)
    want = jmetrics.server_round_bundle(t["jspecs"], t["jold"], t["jnew"], t["jmean"], 0.7)
    _rel_close(got, want)
    assert sum(k.startswith("qerr/") for k in got) == 10


def test_ef_rows_and_partials_match_reference():
    rng = np.random.default_rng(5)
    rows = {f"v{i}": (rng.standard_normal((3, 4 + i)) * 1e-2).astype(np.float32)
            for i in range(3)}
    got = obs_metrics.ef_rows_norm({k: torch.from_numpy(v) for k, v in rows.items()})
    want = jmetrics.ef_rows_norm({k: jnp.asarray(v) for k, v in rows.items()})
    _rel_close({"ef_norm": got}, {"ef_norm": want})
    assert float(obs_metrics.ef_rows_norm(None)) == 0.0 == float(jmetrics.ef_rows_norm({}))
    server = {"a": rng.standard_normal((4, 5)).astype(np.float32),
              "b": rng.standard_normal(3).astype(np.float32)}
    stack = {k: rng.standard_normal((3,) + v.shape).astype(np.float32) for k, v in server.items()}
    stack["a"][1] = 0.0  # a dead client's row, zeroed as the streamed path masks it
    w = np.asarray([1.0, 0.0, 0.5], np.float32)
    got = obs_metrics.chunk_partial_bundle({k: torch.from_numpy(v) for k, v in server.items()},
                                           {k: torch.from_numpy(v) for k, v in stack.items()},
                                           torch.from_numpy(w))
    want = jmetrics.chunk_partial_bundle({k: jnp.asarray(v) for k, v in server.items()},
                                         {k: jnp.asarray(v) for k, v in stack.items()},
                                         jnp.asarray(w))
    _rel_close(got, want)
    acc = obs_metrics.fold_partial_bundles(None, {"update_sq_wsum": torch.tensor(1.0)})
    acc = obs_metrics.fold_partial_bundles(acc, {"update_sq_wsum": torch.tensor(2.5)})
    assert float(acc["update_sq_wsum"]) == 3.5
    assert obs_metrics.finalize_bundle({"x": torch.tensor(0.1), "n": torch.tensor(3.0)}) == \
        {"x": float(np.float32(0.1)), "n": 3.0}


def test_round_record_schema_and_bytes_match_reference(runs, trees):
    _, _, obs, _ = runs["engine"]
    jbundle = jmetrics.server_round_bundle(trees["jspecs"], trees["jold"], trees["jnew"],
                                           trees["jmean"], 1.0)
    want_keys = {"kind", "round", "loss", "cohort", "dropped", "down_bytes", "up_bytes",
                 "alive"} | set(jbundle)
    jparams = jax.eval_shape(lambda: jcf.init(jax.random.PRNGKey(0), JCFG))
    table = jaccounting.build_wire_table(jparams, jcf.param_specs(JCFG), JOMC_)
    spec = jengine.CohortSpec(JPlan(num_clients=16, cohort_size=8, failure_rate=0.25))
    rkey = jax.random.fold_in(jax.random.PRNGKey(0), 0xC047)
    for r, rec in enumerate(obs.sink.records("round")):
        assert set(rec) == want_keys, set(rec) ^ want_keys
        alive = jcohort.survival_mask(rkey, spec.plan, r)
        want = jengine.round_wire_metrics(table, JOMC_, spec.tier_omcs(JOMC_),
                                          jengine.sample_tiered_cohort(rkey, spec, r), alive, r)
        assert (rec["down_bytes"], rec["up_bytes"]) == (want["down_bytes"], want["up_bytes"])
        assert rec["cohort"] == int(np.asarray(alive).sum()) == rec["alive"]
        assert rec["round"] == r


def test_tracer_wall_spans_nest_and_order():
    tr = Tracer()
    with tr.span("outer", idx=0) as args:
        with tr.span("inner"):
            pass
        args["bytes"] = 123
    inner, outer = tr.spans()
    assert (inner.name, outer.name) == ("inner", "outer")
    assert outer.args == {"idx": 0, "bytes": 123}
    assert outer.ts <= inner.ts and inner.end <= outer.end + 1e-9
    assert all(s.cat == WALL for s in tr.spans()) and len(tr) == 2
    with null_span(None, "anything", a=1) as a:
        a["b"] = 2  # accepts writes like a live span
    with maybe_span(None, "anything"):
        pass
    with maybe_span(tr, "live"):
        pass
    assert len(tr.spans()) == 3


def test_tracer_virtual_vs_wall_under_fixed_trace(tmp_path):
    """FixedTrace(latency=2): every client round is a virtual span of exactly
    2, in event order; flush spans live on the wall clock."""
    obs = Obs(run_name="fixed", out_dir=str(tmp_path))
    async_engine.run_async_training(
        cf, CFG, OMC, SIM, async_engine.AsyncConfig(buffer_goal=4),
        traces.FixedTrace(latency=2.0), DATA_FN, KEY, num_clients=4, flushes=2, wire=False,
        obs=obs, device="cpu")
    v = obs.tracer.spans(VIRTUAL, "client_round")
    assert len(v) >= 8 and all(s.dur == pytest.approx(2.0) for s in v)
    assert [s.ts for s in v] == sorted(s.ts for s in v)
    assert len(obs.tracer.spans(WALL, "flush")) == 2
    assert not obs.tracer.spans(WALL, "client_round")
    summary = obs.tracer.summary()
    assert summary["virtual:client_round"]["count"] == len(v)
    assert summary["virtual:client_round"]["mean_s"] == pytest.approx(2.0)


def test_export_roundtrip_schema(tmp_path):
    obs = Obs(run_name="export", out_dir=str(tmp_path))
    obs.record("round", {"loss": torch.tensor(1.5)}, round=0, up_bytes=10)
    with obs.span("encode_payload", bytes=42):
        pass
    obs.vspan("client_round", 1.0, 2.0, client=3)
    paths = obs.flush()
    records = read_jsonl(paths["jsonl"])
    assert all(r["kind"] in JSONL_KINDS for r in records)
    kinds = [r["kind"] for r in records]
    assert kinds == ["meta", "round", "span", "span"]
    meta = records[0]
    assert meta["run"] == "export" and isinstance(meta["dispatch_counts"], dict)
    assert records[1] == {"kind": "round", "loss": 1.5, "round": 0, "up_bytes": 10}
    doc = json.loads(Path(paths["perfetto"]).read_text())
    assert doc["displayTimeUnit"] == "ms"
    events = doc["traceEvents"]
    assert {e["args"]["name"] for e in events if e["ph"] == "M"} == {"wall clock",
                                                                     "virtual clock"}
    xs = [e for e in events if e["ph"] == "X"]
    virt = next(e for e in xs if e["name"] == "client_round")
    assert virt["pid"] == 2 and virt["ts"] == 1e6 and virt["dur"] == 2e6
    sp = Span("x", ts=0.5, dur=0.25, args={"n": 1})
    assert span_record(sp) == {"kind": "span", "name": "x", "cat": WALL, "ts": 0.5,
                               "dur": 0.25, "args": {"n": 1.0}}
    assert to_perfetto([sp])["traceEvents"][-1]["dur"] == 0.25e6
    # no tracer: the JSONL alone
    assert set(Obs("nt", out_dir=str(tmp_path), trace=False).flush()) == {"jsonl"}


def test_logger_quiet_and_structured(tmp_path):
    obs = Obs(run_name="log", out_dir=str(tmp_path), trace=False)
    err = io.StringIO()
    log = Logger(quiet=False, obs=obs, stream=err)
    log.info("hello", n=3)
    log.warn("careful")
    assert "[info] hello n=3" in err.getvalue() and "[warn] careful" in err.getvalue()
    quiet_err = io.StringIO()
    Logger(quiet=True, obs=obs, stream=quiet_err).info("silent", n=4)
    assert quiet_err.getvalue() == ""
    logs = obs.sink.records("log")
    assert [r["msg"] for r in logs] == ["hello", "careful", "silent"] and logs[-1]["n"] == 4


def test_each_report_renders_the_other_packages_jsonl(runs, tmp_path):
    # the port's engine run, rendered by the reference's CLI
    _, _, obs, _ = runs["engine"]
    obs.record("serve", queries=16, query_ms_p50=1.0, query_ms_p95=2.0, swap_ms_mean=3.0)
    port_jsonl = obs.flush()["jsonl"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert jreport.main([port_jsonl]) == 0
    for section in ("rounds", "serve", "spans", "dispatch", "qerr_norm", "wire_mb"):
        assert section in out.getvalue(), out.getvalue()
    # a run the reference's Obs wrote, rendered by the port's CLI
    jobs = JObs(run_name="ref", out_dir=str(tmp_path))
    jobs.record("round", {"loss": jnp.float32(2.0), "qerr_norm": jnp.float32(0.1)}, round=0,
                up_bytes=1000, down_bytes=2000)
    jobs.record("flush", None, staleness=[0.0, 1.0, 1.0], stale_fraction=0.5)
    with jobs.span("encode_payload", bytes=5):
        pass
    jobs.vspan("client_round", 0.0, 1.5, client=1)
    ref_jsonl = jobs.flush()["jsonl"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert report.main([ref_jsonl]) == 0
    for section in ("== run: ref", "rounds", "async flushes", "staleness histogram",
                    "virtual:client_round", "wall:encode_payload"):
        assert section in out.getvalue(), out.getvalue()
    with contextlib.redirect_stderr(io.StringIO()):
        assert report.main([str(tmp_path / "missing.obs.jsonl")]) != 0


def test_compress_pareto_static_smoke_bytes_match_reference_ledger():
    sys.path.insert(0, str(ROOT))
    from benchmarks_torch import compress_pareto

    with contextlib.redirect_stdout(io.StringIO()):
        res = compress_pareto.run_static(smoke=True)
    assert res["device"] == "cpu"
    jlm = jtr.TransformerConfig(**compress_pareto.LM_CFG.__dict__)
    jsmoke = jcf.ConformerConfig(**__import__(
        "repro_torch.configs.conformer_s", fromlist=["x"]).smoke_config().__dict__)
    zoo = {s.label: s for s in jdefault_zoo()}
    for name, family, cfg in (("conformer_s", jcf, jsmoke), ("transformer_lm", jtr, jlm)):
        shapes = jax.eval_shape(lambda: family.init(jax.random.PRNGKey(0), cfg))
        table = jaccounting.build_wire_table(shapes, family.param_specs(cfg), JOMC_)
        model = res["models"][name]
        assert model["fp32_bytes"] == table.fp32_total
        rows = {r["label"]: r for r in model["points"]}
        assert rows["omc-s1e3m7"]["wire_bytes"] == table.download_bytes(JOMC_)
        assert rows["omc-s1e3m7"]["wire_ratio"] <= 0.6
        planned = [lbl for lbl, r in rows.items() if r["planned"] and lbl != "fp32"]
        assert planned == ["omc-s1e3m7", "omc-s1e4m3", "topk-0.1", "ternary-tnt"]
        for lbl in planned:
            assert rows[lbl]["wire_bytes"] == table.download_bytes_strategy(zoo[lbl]), lbl
        assert all(r["reconciled"] for r in rows.values())
        assert rows["pipe-s1e3m7-0.1"]["wire_bytes"] < rows["topk-0.1"]["wire_bytes"]
