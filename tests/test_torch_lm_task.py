"""PyTorch port vs the JAX reference: ``prng.gumbel`` / ``prng.categorical``,
the IID and non-IID LM task, and the entry points built on it (the loopback
demo, the ``api_wire`` benchmark).

``categorical`` is ``argmax(gumbel + logits)``.  The uniform under the
Gumbel noise is bit-exact; its two f32 logs are PyTorch's, which differ from
XLA's by an ulp on some arguments (ROADMAP C3), so a gumbel value is held
within 4 ulp of ``max(|g|, 1)`` and a draw can flip only where two
candidates lie within that.  The draws are counted against
``jax.random.categorical`` itself on fixed keys and numpy logits: the gate
is 0 flips on these samples (ROADMAP C3 records the count), and likewise
for ``lm_batch``'s tokens, where a flip would also send the row's chain its
own way.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.api import demo  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.data import synthetic as syn  # noqa: E402

torch.set_num_threads(1)

ROWS, VOCAB = 8192, 128


def _logits(seed):
    return np.random.default_rng(seed).standard_normal((ROWS, VOCAB)).astype(np.float32) * \
        np.float32(1.5)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_categorical_matches_jax_random(seed):
    logits = _logits(seed)
    want = np.asarray(jax.random.categorical(jax.random.PRNGKey(seed), jnp.asarray(logits)))
    got = prng.categorical(prng.PRNGKey(seed), torch.from_numpy(logits))
    assert got.shape == (ROWS,) and got.dtype == torch.int64
    flips = int((got.numpy() != want).sum())
    assert flips == 0, f"{flips} of {ROWS} draws flipped"


def test_gumbel_within_4_ulp_of_jax_random():
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(5), (ROWS, VOCAB)))
    got = prng.gumbel(prng.PRNGKey(5), (ROWS, VOCAB)).numpy()
    ulp = np.spacing(np.maximum(np.abs(want), np.float32(1)))
    assert np.all(np.abs(got.astype(np.float64) - want) <= 4 * ulp)
    assert np.isfinite(got).all() and got.dtype == np.float32


def test_lm_batch_tokens_match_reference():
    jtask = jsyn.make_lm_task(vocab=VOCAB, seq_len=16, num_clients=4)
    task = syn.make_lm_task(vocab=VOCAB, seq_len=16, num_clients=4, device="cpu")
    flips = total = 0
    for cid, r, step in [(0, 0, 0), (1, 0, 1), (3, 2, 0), (2, 7, 1)]:
        jb, b = jtask.batch(cid, r, step, 2), task.batch(cid, r, step, 2)
        for k in ("tokens", "labels"):
            assert b[k].shape == (2, 16) and b[k].dtype == torch.int32
        flips += int((b["tokens"].numpy() != np.asarray(jb["tokens"])).sum())
        flips += int((b["labels"].numpy() != np.asarray(jb["labels"])).sum())
        total += 2 * b["tokens"].numel()
        np.testing.assert_array_equal(b["tokens"][:, 1:].numpy(), b["labels"][:, :-1].numpy())
    assert flips == 0, f"{flips} of {total} tokens differ"
    # the transition logits: normals (|z| < 8, so 4 ulp <= 4·2**-20) times 1.5
    np.testing.assert_allclose(task._logits().numpy(), np.asarray(jtask._logits()), rtol=0,
                               atol=1.5 * 4 * 2.0 ** -20)


def test_non_iid_lm_task_names_the_roadmap():
    """The non-IID task (ROADMAP A3, ported): each client's bias is
    ``log(dirichlet + 1e-8)``, held within the dirichlet gate of
    tests/test_torch_partition.py carried through the log (16 eps at the
    scale of the client's largest |loggamma|, plus 2 ulp of the log); the
    logits add the base's 4 ulp; tokens and labels: 0 flips on the sample."""
    jtask = jsyn.make_lm_task(vocab=VOCAB, seq_len=16, num_clients=4, iid=False, alpha=0.3)
    task = syn.make_lm_task(vocab=VOCAB, seq_len=16, num_clients=4, iid=False, alpha=0.3,
                            device="cpu")
    eps = float(np.finfo(np.float32).eps)
    for cid in range(4):
        kc = jax.random.fold_in(jax.random.PRNGKey(1), cid)
        alpha = jnp.full((VOCAB,), 0.3)
        lg = np.asarray(jax.random.loggamma(kc, alpha)).astype(np.float64)
        want_bias = np.asarray(jnp.log(jax.random.dirichlet(kc, alpha) + 1e-8)).astype(np.float64)
        bias = task.client_bias(cid).numpy()
        atol = 16 * eps * max(np.abs(lg).max(), 1.0) + 2 * np.spacing(
            np.abs(want_bias).astype(np.float32))
        assert np.all(np.abs(bias - want_bias) <= atol)
        got, want = task.client_logits(cid).numpy(), np.asarray(jtask.client_logits(cid))
        assert got.shape == (VOCAB, VOCAB) and got.dtype == np.float32
        assert np.all(np.abs(got - want) <= atol[None, :] + 1.5 * 4 * 2.0 ** -20
                      + np.spacing(np.abs(want)))
    iid = syn.make_lm_task(vocab=VOCAB, seq_len=16, num_clients=4, device="cpu")
    assert not torch.equal(task.client_logits(1), iid.client_logits(1))
    flips = total = 0
    for cid, r, step in [(0, 0, 0), (1, 0, 1), (3, 2, 0), (2, 7, 1)]:
        jb, b = jtask.batch(cid, r, step, 2), task.batch(cid, r, step, 2)
        for k in ("tokens", "labels"):
            assert b[k].shape == (2, 16) and b[k].dtype == torch.int32
            flips += int((b[k].numpy() != np.asarray(jb[k])).sum())
        total += 2 * b["tokens"].numel()
    assert flips == 0, f"{flips} of {total} tokens differ"


def test_demo_smoke_writes_its_record_under_bench_torch():
    path = ROOT / "experiments" / "bench_torch" / "api_demo_smoke.json"
    path.unlink(missing_ok=True)
    assert demo.main(["--smoke", "--device", "cpu", "--quiet"]) == 0
    rec = json.loads(path.read_text())
    assert rec["fmt"] == "S1E3M7" and rec["rounds"] == 2
    assert rec["down_ratio"] <= 0.60 and rec["down_bytes"] <= 0.60 * rec["down_fp32_bytes"]
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        demo.main(["--smoke", "--device", "cpu", "--obs"])


def test_api_wire_smoke_reconciles():
    from benchmarks_torch import api_wire

    rows = api_wire.run(smoke=True)
    assert [r["fmt"] for r in rows] == ["S1E5M10", "S1E4M8", "S1E3M7"]
    for r in rows:
        assert r["reconciled"] and r["device"] == "cpu"
        assert r["delta_bytes"] <= r["full_bytes"] < r["fp32_bytes"]
    s1e3m7 = rows[-1]
    assert s1e3m7["delta_bytes"] < s1e3m7["full_bytes"]
    assert (ROOT / "experiments" / "bench_torch" / "api_wire_smoke.json").exists()
