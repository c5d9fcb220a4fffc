"""PyTorch port vs the JAX reference: the training driver on the recurrent
families, griffin (recurrentgemma-2b) and xlstm (xlstm-350m), at their
smoke configs on the CPU.

``launch.train --arch ... --smoke --device cpu`` trains on the LM task over
``min(vocab, 4096)`` tokens, as the reference's driver does.  One round's
loss and gradient norm against the reference's ``make_round_fn`` from the
same state (the port's ``init_state`` carried to the reference) on the same
batch, within 1e-4, as for mixtral (tests/test_torch_moe.py); the round's
launches as the storage tree predicts; a killed run, rerun, resumes from
its checkpoint and ends bit-equal to the run that was not killed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.formats import FloatFormat as JFloatFormat
from repro.core.omc import OMCConfig as JOMC
from repro.core.store import CompressedVariable as JCV
from repro.core.store import is_compressed as jis_compressed
from repro.federated import round as jround
from repro.federated import state as jstate
from repro.models import griffin as jgr
from repro.models import xlstm as jx
from repro.optim import fedavg as jfedavg
from repro_torch.configs.registry import get_arch
from repro_torch.core import prng
from repro_torch.core.omc import OMCConfig
from repro_torch.core.store import is_compressed
from repro_torch.core.tree import tree_items
from repro_torch.federated.state import init_state
from repro_torch.launch import train
from repro_torch.models.registry import get_family
from repro_torch.optim import fedavg

torch.set_num_threads(1)

REFERENCE = {"recurrentgemma-2b": jgr, "xlstm-350m": jx}
ARGS = ["--smoke", "--device", "cpu", "--quiet", "--batch", "2", "--seq", "16"]


def _to_reference(tree):
    def conv(v):
        if is_compressed(v):
            return JCV(codes=jnp.asarray(v.codes.numpy()), s=jnp.asarray(v.s.numpy()),
                       b=jnp.asarray(v.b.numpy()), fmt=JFloatFormat.parse(v.fmt.name))
        return jnp.asarray(v.numpy())

    return {k: _to_reference(v) if isinstance(v, dict) else conv(v) for k, v in tree.items()}


@pytest.mark.parametrize("arch_id", list(REFERENCE))
def test_train_driver_round_matches_the_reference_round(arch_id):
    args = train.parse_args(["--arch", arch_id, "--rounds", "1"] + ARGS)
    report = train.run(args)
    arch = get_arch(arch_id)
    cfg, family = arch.smoke_config(), get_family(arch.FAMILY)
    st = init_state(prng.PRNGKey(0), family, cfg, OMCConfig.parse(args.fmt), fedavg(1.0),
                    device="cpu")
    comp = [p for p, v in tree_items(st.params) if is_compressed(v)]
    # one encode and one decode per compressed leaf at the update; in the
    # forward pass and again in its recompute one decode per stacked entry
    # (a layer's leaf; one (s, b) an entry); the embedding's rows and the
    # tied head once each, outside the checkpoints
    entries = sum(v.s.numel() for p, v in tree_items(st.params)
                  if is_compressed(v) and p[0] != "embed")
    assert report["round_launches"] == [{"quantize_stats.ref": len(comp),
                                         "dequantize.ref": len(comp) + 2 * entries + 2}]
    data_fn = train.make_task(arch, cfg, args.seq, args.clients, True, args.seed, "cpu")
    batch = data_fn(0, 0, 0, args.batch)
    assert int(batch["tokens"].max()) < 4096 <= cfg.vocab or cfg.vocab < 4096
    jstorage = _to_reference(st.params)
    zeros = jax.tree_util.tree_map(
        lambda v: jnp.zeros(v.codes.shape, jnp.float32) if jis_compressed(v) else v,
        jstorage, is_leaf=jis_compressed)
    jst = jstate.TrainState(params=jstorage, opt_state=jfedavg(1.0).init(zeros),
                            round=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0))
    jfn = jax.jit(jround.make_round_fn(REFERENCE[arch_id], cfg, JOMC.parse(args.fmt),
                                       jfedavg(1.0), client_lr=args.client_lr))
    _, jm = jfn(jst, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    np.testing.assert_allclose(report["losses"][0], float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(report["grad_norms"][0], float(jm["grad_norm"]), rtol=1e-4)


@pytest.mark.parametrize("arch_id", list(REFERENCE))
def test_train_driver_resume_ends_bit_equal(arch_id, tmp_path):
    def driver(d, rounds):
        return train.run(train.parse_args(["--arch", arch_id, "--rounds", str(rounds),
                                           "--ckpt-every", "1", "--ckpt-dir", str(d)] + ARGS))

    straight = driver(tmp_path / "a", 2)
    driver(tmp_path / "b", 1)
    resumed = driver(tmp_path / "b", 2)  # the killed run, rerun: resumes at round 1
    assert resumed["start_round"] == 1 and resumed["losses"] == straight["losses"][1:]
    with np.load(tmp_path / "a" / "ckpt_2" / "arrays.npz") as a, \
            np.load(tmp_path / "b" / "ckpt_2" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
