"""PyTorch port vs the JAX reference: the federated round (``make_round_fn``),
its eval, ``init_state`` and the training materializer.

Both packages start from the reference's ``init_state`` (carried across with
``interop.state_from_numpy``) and run 3 rounds on the same batches, made
with numpy from a seed: a 2-layer conformer (d 32) on frames and a 2-layer
transformer (d 32, vocab 64) on tokens, under ``fedavg(1.0)`` and
``fedadam(5e-3)``, S1E3M7 with PVT.  Gates: losses and
grad norms within rtol 1e-4; the decoded server trees within chip_smoke
phase 7's gate (max |d| 6e-3: one S1E3M7 step on a boundary element after
reassociated f32 arithmetic; mean |d| 1e-3); ``round`` and ``rng`` equal.
``init_state`` from the same key: codes equal, (s, b) within
tests/test_torch_store.py's bounds, ``state_bytes_report`` equal.

With PVT off the reference's round cannot run a stacked model (its
``compress_variable`` returns 0-d (s, b) for a stacked leaf, which its layer
scan cannot slice; ROADMAP C11); the port keeps one (1, 0) pair per entry,
and its PVT-off round is checked on its own.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # benchmarks, benchmarks_torch

from benchmarks.memory_measured import CFG as JMEM_CFG  # noqa: E402
from benchmarks_torch import common as tcommon  # noqa: E402
from benchmarks_torch import memory_measured  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.core.omc import OMCConfig as JOMC  # noqa: E402
from repro.core.store import decompress_tree as jdecompress  # noqa: E402
from repro.core.store import is_compressed as jis_compressed  # noqa: E402
from repro.federated import round as jround  # noqa: E402
from repro.federated import state as jstate  # noqa: E402
from repro.models import conformer as jcf  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch import interop, optim  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.omc import OMCConfig  # noqa: E402
from repro_torch.core.store import CompressedVariable, decompress_tree, is_compressed  # noqa: E402
from repro_torch.core.tree import tree_items  # noqa: E402
from repro_torch.federated import materialize, state  # noqa: E402
from repro_torch.federated.round import make_eval_fn, make_round_fn  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import conformer as cf  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402

torch.set_num_threads(1)

JCFGS = dict(
    conformer=jcf.ConformerConfig(n_layers=2, d_model=32, n_heads=4, d_ff=64, n_classes=16,
                                  d_in=8),
    transformer=jtr.TransformerConfig(n_layers=2, d_model=32, n_heads=2, n_kv_heads=1,
                                      d_ff=64, vocab=64),
)
FAMILIES = dict(conformer=(jcf, cf, cf.ConformerConfig),
                transformer=(jtr, tr, tr.TransformerConfig))
OPTS = dict(fedavg=(1.0,), fedadam=(5e-3,))
ROUNDS = 3
TREE_MAX, TREE_MEAN = 6e-3, 1e-3


def _cfg(name):
    cls = FAMILIES[name][2]
    return cls(**{k: getattr(JCFGS[name], k) for k in cls.__dataclass_fields__})


def _batches(name, seed=0):
    """numpy batches: frames [4, 16, 8] and labels, or tokens [4, 16] and the
    next tokens as labels."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(ROUNDS):
        if name == "conformer":
            out.append(dict(frames=rng.standard_normal((4, 16, 8)).astype(np.float32),
                            labels=rng.integers(0, 16, (4, 16)).astype(np.int32)))
        else:
            t = rng.integers(0, 64, (4, 17)).astype(np.int32)
            out.append(dict(tokens=t[:, :-1], labels=t[:, 1:]))
    return out


def _torch_batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


_JFNS = {}


def _jround(name, opt):
    """One compiled reference round per configuration, shared across tests."""
    key = (name, opt)
    if key not in _JFNS:
        _JFNS[key] = jax.jit(jround.make_round_fn(
            FAMILIES[name][0], JCFGS[name], JOMC.parse("S1E3M7"),
            getattr(joptim, opt)(*OPTS[opt]), client_lr=0.05))
    return _JFNS[key]


def _decoded(jparams, params):
    want = {"/".join(k.key for k in p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(jdecompress(jparams))[0]}
    got = {"/".join(p): v.numpy() for p, v in tree_items(decompress_tree(params))}
    assert sorted(got) == sorted(want)
    return got, want


@pytest.mark.parametrize("opt", list(OPTS))
@pytest.mark.parametrize("name", list(JCFGS))
def test_round_matches_reference(name, opt):
    jfam, fam, _ = FAMILIES[name]
    omc = OMCConfig.parse("S1E3M7")
    js = jstate.init_state(jax.random.PRNGKey(0), jfam, JCFGS[name], JOMC.parse("S1E3M7"),
                           getattr(joptim, opt)(*OPTS[opt]))
    st = interop.state_from_numpy(jax.device_get(js), device="cpu")
    fn = make_round_fn(fam, _cfg(name), omc, getattr(optim, opt)(*OPTS[opt]), client_lr=0.05)
    jfn = _jround(name, opt)
    ops.reset_launch_counts()
    for b in _batches(name):
        js, jm = jfn(js, _jax_batch(b))
        st, m = fn(st, _torch_batch(b))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)
    counts = ops.launch_counts()
    n_comp = sum(is_compressed(v) for _, v in tree_items(st.params))
    assert counts["quantize_stats.ref"] == ROUNDS * n_comp
    assert not any(k.endswith(".cuda") for k in counts)
    assert st.round == int(js.round) == ROUNDS
    assert st.rng == tuple(int(w) for w in np.asarray(js.rng))
    assert st.opt_state.count == int(js.opt_state.count)
    got, want = _decoded(js.params, st.params)
    for k, v in got.items():
        d = np.abs(v - want[k])
        assert d.max() <= TREE_MAX and d.mean() <= TREE_MEAN, (k, d.max(), d.mean())


def test_round_with_pvt_off_requantizes_with_quantize():
    """PVT off: the updated leaves are encoded by ``quantize`` alone, with one
    (s, b) = (1, 0) per stacked entry; the loss and the tree stay finite."""
    omc = OMCConfig.parse("S1E3M7", pvt=False)
    st = state.init_state(prng.PRNGKey(0), cf, _cfg("conformer"), omc, optim.fedavg(1.0),
                          device="cpu")
    fn = make_round_fn(cf, _cfg("conformer"), omc, optim.fedavg(1.0), client_lr=0.05)
    ops.reset_launch_counts()
    for b in _batches("conformer"):
        st, m = fn(st, _torch_batch(b))
        assert np.isfinite(m["loss"].item()) and np.isfinite(m["grad_norm"].item())
    n_comp = sum(is_compressed(v) for _, v in tree_items(st.params))
    assert ops.launch_counts().get("quantize.ref") == ROUNDS * n_comp
    assert "quantize_stats.ref" not in ops.launch_counts()
    for path, leaf in tree_items(st.params):
        if is_compressed(leaf):
            stacked = path[0] == "blocks"  # one (s, b) per layer, else one in all
            want = (leaf.codes.shape[0],) + (1,) * (leaf.codes.ndim - 1) if stacked else ()
            assert leaf.s.shape == leaf.b.shape == want, path
            assert bool((leaf.s == 1).all() and (leaf.b == 0).all()), path
    for _, v in tree_items(decompress_tree(st.params)):
        assert bool(torch.isfinite(v).all())


@pytest.mark.parametrize("name", list(JCFGS))
def test_init_state_matches_reference(name):
    jfam, fam, _ = FAMILIES[name]
    js = jstate.init_state(jax.random.PRNGKey(0), jfam, JCFGS[name], JOMC.parse("S1E3M7"),
                           joptim.fedadam(5e-3))
    st = state.init_state(prng.PRNGKey(0), fam, _cfg(name), OMCConfig.parse("S1E3M7"),
                          optim.fedadam(5e-3), device="cpu")
    assert st.round == 0 and st.rng == tuple(int(w) for w in np.asarray(js.rng))
    assert state.state_bytes_report(st.params) == jstate.state_bytes_report(js.params)
    jleaves = {"/".join(k.key for k in p): v for p, v in
               jax.tree_util.tree_flatten_with_path(js.params, is_leaf=jis_compressed)[0]}
    for path, leaf in tree_items(st.params):
        jleaf = jleaves["/".join(path)]
        if is_compressed(leaf):
            assert np.array_equal(leaf.codes.numpy(), np.asarray(jleaf.codes)), path
            np.testing.assert_allclose(leaf.s.numpy(), np.asarray(jleaf.s), rtol=1e-4)
            np.testing.assert_allclose(leaf.b.numpy(), np.asarray(jleaf.b), atol=1e-5)
    # the server optimizer's moments over zeros shaped like the codes
    assert st.opt_state._fields == js.opt_state._fields and st.opt_state.count == 0
    for (path, m), (_, leaf) in zip(tree_items(st.opt_state.mu), tree_items(st.params)):
        shape = leaf.codes.shape if is_compressed(leaf) else leaf.shape
        assert m.shape == shape and m.dtype == torch.float32 and not m.any(), path


@pytest.mark.parametrize("name", list(JCFGS))
def test_eval_fn_matches_reference(name):
    jfam, fam, _ = FAMILIES[name]
    js = jstate.init_state(jax.random.PRNGKey(1), jfam, JCFGS[name], JOMC.parse("S1E3M7"),
                           joptim.fedavg(1.0))
    st = interop.state_from_numpy(jax.device_get(js), device="cpu")
    b = _batches(name, seed=5)[0]
    want = float(jax.jit(jround.make_eval_fn(jfam, JCFGS[name]))(js.params, _jax_batch(b)))
    got = make_eval_fn(fam, _cfg(name))(st.params, _torch_batch(b))
    assert not got.requires_grad
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)


def test_qparam_always_comes_back_decoded_and_grafted():
    """A QParam named as a matmul operand is still decoded (dequant_matmul
    has no backward), and its gradient lands in the sink, not the codes."""
    fmt = OMCConfig.parse("S1E3M7").fmt
    codes = torch.arange(12).to(torch.uint16).reshape(3, 4)
    cv = CompressedVariable(codes, torch.tensor(2.0), torch.tensor(0.5), fmt)
    sink = torch.zeros((3, 4), requires_grad=True)
    mat = materialize.OMCMaterializer()
    w = mat({"wq": materialize.QParam(cv, sink)}, operands=("wq",))["wq"]
    assert isinstance(w, torch.Tensor) and torch.equal(w.detach(), cv.dequantize())
    (w * torch.arange(12.0).reshape(3, 4)).sum().backward()
    assert torch.equal(sink.grad, torch.arange(12.0).reshape(3, 4))
    assert is_compressed(mat({"wq": cv}, operands=("wq",))["wq"])  # serving keeps codes
    # a stacked QParam unbinds codes, (s, b) and sink together
    stacked = CompressedVariable(codes.reshape(3, 1, 4), torch.ones(3, 1, 1),
                                 torch.zeros(3, 1, 1), fmt)
    layers = materialize.QParam(stacked, torch.zeros((3, 1, 4), requires_grad=True)).unbind(0)
    assert len(layers) == 3 and layers[1].value.codes.shape == (1, 4)
    assert layers[1].sink.shape == (1, 4) and layers[1].value.s.shape == (1, 1)


def test_prefix_embeds_raise_naming_the_roadmap():
    """The VLM prefix (``prefix_embeds``, ``batch["patches"]``): the eval's
    loss, prefix positions masked out, equals the reference's."""
    jcfg = jtr.TransformerConfig(n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
                                 vocab=64, prefix_embeds=3)
    cfg = tr.TransformerConfig(**{k: getattr(jcfg, k) for k in tr.TransformerConfig.__dataclass_fields__})
    js = jax.jit(lambda k: jstate.init_state(k, jtr, jcfg, JOMC.parse("S1E3M7"),
                                             joptim.fedavg(1.0)))(jax.random.PRNGKey(0))
    st = interop.state_from_numpy(jax.device_get(js), device="cpu")
    b = _batches("transformer", seed=9)[0]
    b["patches"] = np.random.default_rng(9).standard_normal((4, 3, 32)).astype(np.float32)
    want = float(jax.jit(jround.make_eval_fn(jtr, jcfg))(js.params, _jax_batch(b)))
    got = make_eval_fn(tr, cfg)(st.params, _torch_batch(b))
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)
    b.pop("patches")
    with pytest.raises(KeyError, match="patches"):
        make_eval_fn(tr, cfg)(st.params, _torch_batch(b))


def test_memory_measured_byte_columns_equal_the_reference(monkeypatch, tmp_path):
    """``benchmarks_torch/memory_measured.py``'s configuration and rows: the
    state's byte report equals the reference's ``init_state`` report for
    each format, key for key."""
    monkeypatch.setattr(tcommon, "OUT_DIR", tmp_path)
    assert {k: getattr(JMEM_CFG, k) for k in tr.TransformerConfig.__dataclass_fields__} == \
        memory_measured.CFG.__dict__
    rows = memory_measured.run(device="cpu")
    assert [r["fmt"] for r in rows] == ["S1E8M23", "S1E5M10", "S1E3M7"]
    for r in rows:
        js = jax.jit(lambda k, f=r["fmt"]: jstate.init_state(
            k, jtr, JMEM_CFG, JOMC.parse(f), joptim.fedavg(1.0)))(jax.random.PRNGKey(0))
        st = state.init_state(prng.PRNGKey(0), tr, memory_measured.CFG,
                              OMCConfig.parse(r["fmt"]), optim.fedavg(1.0), device="cpu")
        want = jstate.state_bytes_report(js.params)
        assert state.state_bytes_report(st.params) == want
        assert r["container_pct"] == round(100 * want["container_ratio"])
        assert r["packed_pct"] == round(100 * want["packed_ratio"])
        assert r["arg_mb"] is None and r["temp_mb"] is None  # device columns: card only
    assert (tmp_path / "memory_measured.json").exists()
