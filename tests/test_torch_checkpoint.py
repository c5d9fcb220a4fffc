"""Checkpoints of the port, against the JAX reference's, and the training
driver's restart.

Mirrors tests/test_checkpoint.py (roundtrip, keep-K GC, stale ``tmp.``
directories, bit-exact resume, structure mismatch) on the port, on a
2-layer transformer (d 32, vocab 64) with numpy-made tokens.  Across the
packages, in both directions: a checkpoint one package writes restores in
the other to the same bits (codes, (s, b), f32 leaves, the optimizer's
moments and count, ``round`` and ``rng``), and ``encode_payload`` of the
restored storage is the same bytes on both sides.  The driver
(``launch/train``, ``--smoke --device cpu``): 4 rounds straight and 2 rounds
then a resumed run to 4 end in bit-equal checkpoints; on qwen2.5-3b's smoke
config it trains on the IID LM task.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jck
from repro import optim as joptim
from repro.api import codecs as jcodecs
from repro.core.omc import OMCConfig as JOMC
from repro.core.store import is_compressed as jis_compressed
from repro.federated import round as jround
from repro.federated import state as jstate
from repro.models import transformer as jtr
from repro_torch import checkpoint as ck
from repro_torch import interop, optim
from repro_torch.api import codecs
from repro_torch.core import prng
from repro_torch.core.omc import OMCConfig
from repro_torch.core.store import is_compressed
from repro_torch.core.tree import tree_items
from repro_torch.federated.round import make_round_fn
from repro_torch.federated.state import init_state
from repro_torch.launch import train
from repro_torch.models import transformer as tr

torch.set_num_threads(1)

JCFG = jtr.TransformerConfig(n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64, vocab=64)
CFG = tr.TransformerConfig(n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64, vocab=64)
OMC = OMCConfig.parse("S1E3M7")


def _state(opt=None, cfg=CFG):
    return init_state(prng.PRNGKey(0), tr, cfg, OMC, opt or optim.fedavg(1.0), device="cpu")


def _batch(r):
    t = np.random.default_rng(r).integers(0, 64, (4, 17)).astype(np.int32)
    return dict(tokens=t[:, :-1], labels=t[:, 1:])


def _tb(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _compressed(leaf):
    return is_compressed(leaf) or jis_compressed(leaf)


def _arrays(leaf):
    """A leaf's arrays as numpy, as a checkpoint holds them (a compressed
    leaf: codes, s, b; an int count or round: int32)."""
    if _compressed(leaf):
        return [np.asarray(x) for x in (leaf.codes, leaf.s, leaf.b)]
    if isinstance(leaf, torch.Tensor):
        return [leaf.numpy()]
    if isinstance(leaf, int):
        return [np.asarray(leaf, np.int32)]
    return [np.asarray(leaf)]


def _assert_same_bits(leaves, jleaves):
    assert len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves):
        assert _compressed(a) == _compressed(b)
        for x, y in zip(_arrays(a), _arrays(b)):
            assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()


def _jleaves(jstate_):
    return jax.tree_util.tree_leaves(jstate_, is_leaf=jis_compressed)


def _assert_states_equal(a, b):
    _assert_same_bits(ck.ckpt._leaves(a), ck.ckpt._leaves(b))
    assert a.round == b.round and a.rng == b.rng
    assert type(a.opt_state) is type(b.opt_state)


def test_roundtrip_compressed_state(tmp_path):
    st = _state(optim.fedadam(5e-3))
    ck.save_state(str(tmp_path), 3, st)
    found = ck.latest_checkpoint(str(tmp_path))
    assert found and found[1] == 3
    st2, manifest = ck.restore_state(found[0], st)
    assert manifest["step"] == 3 and manifest["process_index"] == 0
    _assert_states_equal(st, st2)
    assert isinstance(st2.round, int) and isinstance(st2.opt_state.count, int)


def test_gc_keeps_k_latest(tmp_path):
    st = _state()
    for step in (1, 2, 3, 4, 5):
        ck.save_state(str(tmp_path), step, st, keep=2)
    names = sorted(n for n in os.listdir(tmp_path) if n.startswith("ckpt_"))
    assert names == ["ckpt_4", "ckpt_5"]


def test_stale_tmp_dirs_cleaned(tmp_path):
    os.makedirs(tmp_path / "tmp.99.garbage")
    ck.save_state(str(tmp_path), 1, _state())
    assert not any(n.startswith("tmp.") for n in os.listdir(tmp_path))


def test_resume_replays_bit_exact(tmp_path):
    """Train 3 rounds, checkpoint, train 2 more; restore + 2 == same state."""
    fn = make_round_fn(tr, CFG, OMC, optim.fedavg(1.0), client_lr=0.05)
    st = _state()
    for r in range(3):
        st, _ = fn(st, _tb(_batch(r)))
    ck.save_state(str(tmp_path), 3, st)
    cont = st
    for r in (3, 4):
        cont, _ = fn(cont, _tb(_batch(r)))
    restored, _ = ck.restore_state(ck.latest_checkpoint(str(tmp_path))[0], _state())
    for r in (3, 4):
        restored, _ = fn(restored, _tb(_batch(r)))
    _assert_states_equal(cont, restored)


def test_structure_mismatch_raises(tmp_path):
    ck.save_state(str(tmp_path), 1, _state())
    path = ck.latest_checkpoint(str(tmp_path))[0]
    deeper = tr.TransformerConfig(n_layers=3, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
                                  vocab=64)
    with pytest.raises(ValueError, match="wrong config"):
        ck.restore_state(path, _state(cfg=deeper))
    with pytest.raises(ValueError, match="structure mismatch"):
        ck.restore_state(path, _state(optim.fedadam(5e-3)))


def test_async_and_population_checkpoints_name_the_roadmap(tmp_path):
    """The population snapshots wait for ``scale.store`` (ROADMAP A9); the
    async ones are ported (tests/test_torch_async.py holds them to the
    reference) and refuse a checkpoint that is not an async runner's."""
    for fn in (ck.save_population_state, ck.restore_population_state):
        with pytest.raises(NotImplementedError, match="ROADMAP A9"):
            fn("unused", None)
    ck.save_state(str(tmp_path), 1, _state())
    with pytest.raises(ValueError, match="not an async-runner checkpoint"):
        ck.restore_async_state(ck.latest_checkpoint(str(tmp_path))[0], None)


@pytest.fixture(scope="module")
def jtrained():
    """The reference's state after 2 fedadam rounds (moments and count set)."""
    jopt = joptim.fedadam(5e-3)
    js = jstate.init_state(jax.random.PRNGKey(0), jtr, JCFG, JOMC.parse("S1E3M7"), jopt)
    fn = jax.jit(jround.make_round_fn(jtr, JCFG, JOMC.parse("S1E3M7"), jopt, client_lr=0.05))
    for r in range(2):
        js, _ = fn(js, {k: jnp.asarray(v) for k, v in _batch(r).items()})
    return js


def test_port_restores_the_reference_checkpoint(tmp_path, jtrained):
    jck.save_state(str(tmp_path), 2, jtrained)
    st, manifest = ck.restore_state(ck.latest_checkpoint(str(tmp_path))[0],
                                    _state(optim.fedadam(5e-3)))
    assert manifest["step"] == 2
    _assert_same_bits(ck.ckpt._leaves(st), _jleaves(jtrained))
    assert st.round == 2 and st.opt_state.count == 2
    assert st.rng == tuple(int(w) for w in np.asarray(jtrained.rng))
    assert codecs.encode_payload(st.params) == jcodecs.encode_payload(jtrained.params)


def test_reference_restores_the_port_checkpoint(tmp_path, jtrained):
    st = interop.state_from_numpy(jax.device_get(jtrained), device="cpu")
    fn = make_round_fn(tr, CFG, OMC, optim.fedadam(5e-3), client_lr=0.05)
    st, _ = fn(st, _tb(_batch(2)))  # a port-computed state, round 3
    ck.save_state(str(tmp_path), 3, st)
    jtemplate = jstate.init_state(jax.random.PRNGKey(0), jtr, JCFG, JOMC.parse("S1E3M7"),
                                  joptim.fedadam(5e-3))
    js, manifest = jck.restore_state(jck.latest_checkpoint(str(tmp_path))[0], jtemplate)
    assert manifest["step"] == 3
    _assert_same_bits(ck.ckpt._leaves(st), _jleaves(js))
    assert int(js.round) == 3 and int(js.opt_state.count) == 3
    assert jcodecs.encode_payload(js.params) == codecs.encode_payload(st.params)


def _driver(ckpt_dir, rounds):
    return train.run(train.parse_args(["--smoke", "--device", "cpu", "--quiet",
                                       "--rounds", str(rounds), "--ckpt-every", "2",
                                       "--batch", "4", "--seq", "16",
                                       "--ckpt-dir", str(ckpt_dir)]))


def test_driver_resume_ends_bit_equal(tmp_path):
    straight = _driver(tmp_path / "a", 4)
    assert straight["start_round"] == 0 and len(straight["losses"]) == 4
    first = _driver(tmp_path / "b", 2)
    assert [os.path.basename(c) for c in first["checkpoints"]] == ["ckpt_2"]
    resumed = _driver(tmp_path / "b", 4)  # the killed run, rerun: resumes at round 2
    assert resumed["start_round"] == 2 and resumed["losses"] == straight["losses"][2:]
    # per round: one encode per compressed leaf; one decode per compressed
    # leaf for the server update, and one per layer and stacked leaf in the
    # forward pass and again in its recompute (2 layers)
    comp = [p for p, v in tree_items(resumed["state"].params) if is_compressed(v)]
    stacked = sum(p[0] == "blocks" for p in comp)
    assert resumed["round_launches"] == [{"quantize_stats.ref": len(comp),
                                          "dequantize.ref": len(comp) + (len(comp) - stacked)
                                          + 2 * 2 * stacked}] * 2
    with np.load(tmp_path / "a" / "ckpt_4" / "arrays.npz") as a, \
            np.load(tmp_path / "b" / "ckpt_4" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    _assert_states_equal(straight["state"], resumed["state"])
    shutil.rmtree(tmp_path)


def test_driver_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.run(train.parse_args(["--smoke", "--rounds", "1"]))


def test_driver_lm_families_wait_for_the_lm_task():
    """The transformer family trains on the LM task (qwen2.5-3b's smoke
    config), IID and, with ``--non-iid``, on Dirichlet-skewed clients, whose
    losses differ from the IID run's; griffin still waits for its
    forward/loss (ROADMAP A10)."""
    argv = ["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu", "--rounds", "2", "--batch",
            "2", "--seq", "16", "--quiet"]
    report = train.run(train.parse_args(argv))
    assert report["arch"] == "qwen2.5-3b" and len(report["losses"]) == 2
    assert all(np.isfinite(report["losses"])) and report["losses"][0] > 0
    assert report["round_launches"][0].get("quantize_stats.ref", 0) > 0
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        train.run(train.parse_args(["--arch", "recurrentgemma-2b", "--smoke", "--device", "cpu"]))
    skewed = train.run(train.parse_args(argv + ["--non-iid"]))
    assert len(skewed["losses"]) == 2 and all(np.isfinite(skewed["losses"]))
    assert skewed["round_launches"][0].get("quantize_stats.ref", 0) > 0
    assert skewed["losses"] != report["losses"]
