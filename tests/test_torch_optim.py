"""PyTorch port vs the JAX reference: optimizers and learning-rate schedules.

Each optimizer runs 4 steps on the same random trees (numpy, seeded) in both
packages, with a constant rate and with a schedule.  Tolerances: a schedule's
value within one ulp of its f32 ``cos`` (XLA's f32 ``cos`` on the CPU and
PyTorch's differ by 1 ulp on about 5% of arguments, and ``1 + cos`` near
``cos = -1`` magnifies that, so the bound is ``lr·2**-24`` plus 1 ulp of the
value; most steps are bit-equal); updates and states within rtol 2e-6 and
atol 1e-9 (the same f32 operations; XLA contracts ``beta·m + g`` into one
fused multiply-add on the CPU, one rounding fewer).  The states' names and
field orders are the reference's (a checkpoint's leaf order depends on
them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.optim import optimizers as joptimizers
from repro_torch import optim
from repro_torch.core.tree import tree_items, tree_map

torch.set_num_threads(1)

SHAPES = {"a": (3, 5), "b": {"c": (7,), "d": (2, 2, 4)}, "e": ()}


def _trees(seed):
    rng = np.random.default_rng(seed)

    def build(shapes):
        if isinstance(shapes, dict):
            return {k: build(v) for k, v in shapes.items()}
        return rng.standard_normal(shapes).astype(np.float32)

    return build(SHAPES)


def _ulps(a, b):
    a = np.asarray(a, np.float32).reshape(-1)
    b = np.asarray(b, np.float32).reshape(-1)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


SCHEDULES = [
    ("constant", (0.3,)),
    ("cosine_decay", (0.1, 20)),
    ("cosine_decay", (0.05, 7, 0.1)),
    ("warmup_cosine", (0.2, 5, 30)),
    ("warmup_cosine", (1e-3, 3, 17, 0.25)),
]


@pytest.mark.parametrize("name,args", SCHEDULES, ids=[f"{n}{a}" for n, a in SCHEDULES])
def test_schedule_within_one_ulp_of_reference(name, args):
    jf, f = getattr(joptim, name)(*args), getattr(optim, name)(*args)
    steps = list(range(0, 40))
    want = np.array([np.float32(jf(jnp.int32(s))) for s in steps])
    got = np.array([f(s).item() for s in steps], np.float32)
    assert all(f(s).dtype == torch.float32 for s in (0, 9))
    one_ulp = np.spacing(np.abs(want)).astype(np.float32)
    assert (np.abs(got - want) <= args[0] * 2.0 ** -24 + one_ulp).all(), (got, want)
    print(f"{name}{args}: {int((got != want).sum())} of {len(steps)} steps not bit-equal, "
          f"at most {int(_ulps(got, want).max())} ulp")


OPTIMIZERS = [
    ("sgd", (0.1,), {}),
    ("momentum", (0.05,), dict(beta=0.8)),
    ("momentum", (0.05,), dict(beta=0.9, nesterov=True)),
    ("adamw", (1e-2,), dict(weight_decay=0.01)),
    ("fedavg", (1.0,), {}),
    ("fedavg", (0.7,), dict(server_momentum=0.9)),
    ("fedadam", (5e-3,), {}),
    ("fedadagrad", (1e-2,), {}),
]


def _assert_close(got_tree, want_tree):
    want = dict(jax.tree_util.tree_flatten_with_path(want_tree)[0])
    want = {"/".join(k.key for k in p): np.asarray(v) for p, v in want.items()}
    got = {"/".join(p): v.numpy() for p, v in tree_items(got_tree)}
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], rtol=2e-6, atol=1e-9, err_msg=k)


@pytest.mark.parametrize("schedule", [False, True], ids=["constant_lr", "schedule"])
@pytest.mark.parametrize("name,args,kw", OPTIMIZERS,
                         ids=[f"{n}{a}{sorted(k.items())}" for n, a, k in OPTIMIZERS])
def test_optimizer_matches_reference(name, args, kw, schedule):
    if schedule:  # the rate as a schedule of the step count
        lr = args[0]
        jopt = getattr(joptim, name)(joptim.warmup_cosine(lr, 2, 6), *args[1:], **kw)
        opt = getattr(optim, name)(optim.warmup_cosine(lr, 2, 6), *args[1:], **kw)
    else:
        jopt, opt = getattr(joptim, name)(*args, **kw), getattr(optim, name)(*args, **kw)
    params = _trees(0)
    jstate = jopt.init(jax.tree_util.tree_map(jnp.asarray, params))
    state = opt.init(tree_map(torch.from_numpy, params))
    assert type(state).__name__ == type(jstate).__name__
    assert state._fields == jstate._fields
    for step in range(4):
        grads = _trees(step + 1)
        p = params if name == "adamw" else None
        jupd, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), jstate,
                                   None if p is None else jax.tree_util.tree_map(jnp.asarray, p))
        upd, state = opt.update(tree_map(torch.from_numpy, grads), state,
                                None if p is None else tree_map(torch.from_numpy, p))
        _assert_close(upd, jupd)
        assert state.count == int(jstate.count) == step + 1
        for field in state._fields[1:]:
            _assert_close(getattr(state, field), getattr(jstate, field))


def test_state_classes_are_the_reference_names():
    for cls in ("_CountState", "_MomentumState", "_AdamState"):
        assert getattr(optim.optimizers, cls)._fields == getattr(joptimizers, cls)._fields
    jstate = joptim.fedadagrad().init({"w": jnp.zeros(3)})
    assert type(jstate).__name__ == optim.optimizers._State.__name__
    assert jstate._fields == optim.optimizers._State._fields
