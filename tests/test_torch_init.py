"""PyTorch port vs the JAX reference: random init and prompt draws (ROADMAP C10).

Each family's ``init(key, cfg)`` follows the reference's key tree key for
key (``split`` per block, one key a layer, the keys the reference draws
twice drawn twice), and ``prng.randint`` is ``jax.random.randint``.
Tolerances: every init value within 4 ulp of the reference's (the bound
``prng.normal`` holds against ``jax.random.normal``; the f32 scale is applied
exactly as the reference applies it), the same paths and shapes; ``randint``
and the serve CLI's prompt tokens bit-exact.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from repro_torch.core import prng
from repro_torch.core.tree import tree_items
from repro_torch.launch import serve

torch.set_num_threads(1)

FAMILIES = [("conformer", "conformer_s"), ("transformer", "qwen2_5_3b"),
            ("griffin", "recurrentgemma_2b")]
ULP = 4


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in units in the last place between f32 arrays of one sign
    pattern (the int32 views of same-signed floats are ordered)."""
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("family,arch", FAMILIES, ids=[a for _, a in FAMILIES])
@pytest.mark.parametrize("seed", [0, 5])
def test_init_matches_reference_within_4_ulp(family, arch, seed):
    jfam = importlib.import_module(f"repro.models.{family}")
    jcfg = importlib.import_module(f"repro.configs.{arch}").smoke_config()
    fam = importlib.import_module(f"repro_torch.models.{family}")
    cfg = importlib.import_module(f"repro_torch.configs.{arch}").smoke_config()
    jp = jax.jit(lambda k: jfam.init(k, jcfg))(jax.random.PRNGKey(seed))
    want = {tuple(k.key for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = {p: v.numpy() for p, v in tree_items(fam.init(prng.PRNGKey(seed), cfg))}
    assert sorted(got) == sorted(want)
    differ = total = 0
    for path, x in got.items():
        assert x.shape == want[path].shape and x.dtype == want[path].dtype, path
        assert np.array_equal(np.signbit(x), np.signbit(want[path])), path
        d = _ulps(x, want[path])
        assert d.max() <= ULP, (path, d.max())
        differ += int((d > 0).sum())
        total += d.size
    print(f"{arch} seed {seed}: {differ} of {total} values not bit-equal (all within {ULP} ulp)")


@pytest.mark.parametrize("shape,minval,maxval", [
    ((4, 32), 0, 151_936),  # qwen2.5-3b's vocab
    ((4, 32), 0, 256_000),  # recurrentgemma-2b's vocab
    ((3, 7), 0, 512),
    ((1000,), 0, 65_536),
    ((1000,), 0, 65_537),
    ((257,), -5, 1_234_567),  # a span that is not a power of two, below zero
    ((33,), 0, 2**31 - 1),
    ((9, 2), -2**31, 2**31 - 1),
    ((5,), 7, 7),  # empty span: minval
])
@pytest.mark.parametrize("seed", [0, 1729])
def test_randint_is_bit_exact(shape, minval, maxval, seed):
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, minval, maxval))
    got = prng.randint(prng.PRNGKey(seed), shape, minval, maxval)
    assert got.dtype == torch.int64 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_randint_rejects_bounds_outside_int32():
    with pytest.raises(ValueError, match="int32"):
        prng.randint(prng.PRNGKey(0), (2,), 0, 2**31)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "recurrentgemma-2b"])
def test_serve_smoke_prompts_equal_the_reference(arch, monkeypatch):
    """``launch/serve.py --smoke``'s prompts: the reference draws
    ``randint(fold_in(PRNGKey(seed), 1), (batch, prompt_len), 0, vocab)``."""
    drawn = []

    def spy(*args):
        drawn.append(prompt_tokens(*args))
        return drawn[-1]

    prompt_tokens = serve.prompt_tokens
    monkeypatch.setattr(serve, "prompt_tokens", spy)
    report = serve.run(serve.parse_args(["--arch", arch, "--smoke", "--device", "cpu",
                                         "--seed", "3", "--gen", "1", "--quiet"]))
    vocab = report["session"].cfg.vocab
    assert len(drawn) == 1 and tuple(drawn[0].shape) == (4, 32)
    want = jax.random.randint(jax.random.fold_in(jax.random.PRNGKey(3), 1), (4, 32), 0, vocab)
    np.testing.assert_array_equal(drawn[0].numpy(), np.asarray(want))
