"""PyTorch port vs the JAX reference: ``dequant_matmul``, the serve path's
weight-stream matmul ``A @ (s·dec(W) + b)``.

The plain version (``repro_torch.kernels.ref.ref_dequant_matmul``, the CPU
path of ``ops.dequant_matmul``) decodes the weight with its affine and
multiplies once.  It is held against ``repro.kernels.ref.ref_dequant_matmul``
and against the Pallas kernel run in interpret mode, which adds the bias as
the rank-1 term ``b·rowsum(A)``: at the reference test's shapes and formats
(tests/test_kernels.py:58-68, :236) within its own rtol = atol = 2e-5, the
f32 sums being taken in another order.

The tests marked ``cuda`` hold the CUDA kernel against the plain version on
the card, elementwise within ``2e-5 · (|A| @ |s·dec(W) + b|)``: the kernel
sums in another order and adds the bias as the rank-1 term.  Their shapes
reach both of its paths: the weight stream (M <= 8 with N a whole number of
16-byte code vectors; split K, a chunk of 512 rows at most) and the tiled
kernel (everything else).  Without a card
they skip; they need no JAX (``pytest tests/test_torch_dequant_matmul.py -m
cuda`` on a machine with the card).
"""

import numpy as np
import pytest
import torch

try:  # the reference; a machine with the card has no JAX, and runs `-m cuda` only
    import jax.numpy as jnp
    from repro.core.formats import FloatFormat as JFormat
    from repro.kernels import dequant_matmul as jdm
    from repro.kernels import ref as jref
except ImportError:
    jnp = None

from repro_torch.core.formats import FloatFormat
from repro_torch.core.store import compress_variable, is_compressed
from repro_torch.federated.materialize import OMCMaterializer
from repro_torch.kernels import dequant_matmul as dm
from repro_torch.kernels import ops, ref
from repro_torch.models.common import linear

torch.set_num_threads(1)

RTOL = ATOL = 2e-5  # tests/test_kernels.py's tolerance for the Pallas kernel


def _case(m, k, n, seed, w_scale=0.1):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * w_scale).astype(np.float32)
    return a, w


def _codes(w, name):
    return torch.from_numpy(np.array(jref.ref_quantize(jnp.asarray(w), JFormat.parse(name))))


@pytest.mark.parametrize("name", ["S1E3M7", "S1E5M10"])
@pytest.mark.parametrize("mnk", [(48, 80, 96), (32, 32, 32), (100, 60, 70)], ids=str)
def test_plain_matches_reference_and_pallas_interpret(name, mnk):
    m, n, k = mnk
    fmt, jfmt = FloatFormat.parse(name), JFormat.parse(name)
    a, w = _case(m, k, n, seed=m + n + k)
    codes = _codes(w, name)
    s, b = np.float32(0.98), np.float32(0.004)
    got = ref.ref_dequant_matmul(torch.from_numpy(a), codes, fmt, torch.tensor(s),
                                 torch.tensor(b)).numpy()
    jargs = (jnp.asarray(a), jnp.asarray(codes.numpy()), jfmt, jnp.float32(s), jnp.float32(b))
    np.testing.assert_allclose(got, np.asarray(jref.ref_dequant_matmul(*jargs)),
                               rtol=RTOL, atol=ATOL)
    want = jdm.dequant_matmul(*jargs, bm=32, bn=32, bk=32, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_bias_enters_as_the_rank1_term():
    """tests/test_kernels.py:236's case: A @ (s·dec + b) == s·(A @ dec) +
    b·rowsum(A), the Pallas kernel's epilogue, within 2e-5."""
    fmt, jfmt = FloatFormat.parse("S1E3M7"), JFormat.parse("S1E3M7")
    a, w = _case(16, 24, 8, seed=4, w_scale=0.2)
    codes = _codes(w, "S1E3M7")
    s, b = np.float32(1.1), np.float32(0.05)
    got = ref.ref_dequant_matmul(torch.from_numpy(a), codes, fmt, torch.tensor(s),
                                 torch.tensor(b)).numpy()
    dec = ref.ref_dequantize(codes, fmt).numpy()
    np.testing.assert_allclose(got, a @ (s * dec + b), rtol=RTOL, atol=RTOL)
    rank1 = s * (a.astype(np.float64) @ dec) + b * a.sum(1, keepdims=True, dtype=np.float64)
    np.testing.assert_allclose(got, rank1, rtol=RTOL, atol=ATOL)
    want = jdm.dequant_matmul(jnp.asarray(a), jnp.asarray(codes.numpy()), jfmt, jnp.float32(s),
                              jnp.float32(b), bm=8, bn=8, bk=8, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("lead", [(3,), (2, 2)], ids=str)
def test_per_entry_scalars_of_a_stacked_leaf(lead):
    """Each entry ``v[i]`` (``v[g][j]`` for griffin's doubly stacked leaves)
    carries its own (s, b), shaped [1, 1]; the product with it equals the
    reference's with that entry's scalars."""
    fmt, jfmt = FloatFormat.parse("S1E3M7"), JFormat.parse("S1E3M7")
    rng = np.random.default_rng(len(lead))
    w = (rng.standard_normal(lead + (24, 40)) * (1 + np.arange(np.prod(lead))).reshape(
        lead + (1, 1)) * 0.05).astype(np.float32)
    a = rng.standard_normal((5, 24)).astype(np.float32)
    v = compress_variable(torch.from_numpy(w), fmt, batch_axes=len(lead))
    assert v.s.shape == lead + (1, 1)
    for idx in np.ndindex(*lead):
        e = v
        for i in idx:
            e = e[i]
        assert e.codes.shape == (24, 40) and e.s.shape == (1, 1)
        got = ops.dequant_matmul(torch.from_numpy(a), e.codes, fmt, e.s, e.b).numpy()
        want = jref.ref_dequant_matmul(jnp.asarray(a), jnp.asarray(e.codes.numpy()), jfmt,
                                       jnp.float32(e.s.item()), jnp.float32(e.b.item()))
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    # the entries' scalars differ, so a wrong pairing would show
    assert len({float(x) for x in v.s.reshape(-1)}) == int(np.prod(lead))


def _args(m=4, k=24, n=16, name="S1E3M7"):
    fmt = FloatFormat.parse(name)
    a, w = _case(m, k, n, seed=9)
    v = compress_variable(torch.from_numpy(w), fmt)
    return torch.from_numpy(a), v.codes, fmt, v.s, v.b


def test_unsupported_inputs_raise_value_error():
    a, codes, fmt, s, b = _args()
    bad = {
        "a not f32": (a.double(), codes, fmt, s, b),
        "a not 2-D": (a[None], codes, fmt, s, b),
        "a non-contiguous": (torch.from_numpy(_case(24, 4, 1, 0)[0]).T, codes, fmt, s, b),
        "codes non-contiguous": (a, codes[:, ::2], fmt, s, b),
        "codes 3-D": (a, codes[None], fmt, s, b),
        "codes not the container": (a, codes.view(torch.int16), fmt, s, b),
        "K mismatch": (a[:, :20].contiguous(), codes, fmt, s, b),
        "two scales": (a, codes, fmt, torch.ones(2), b),
        "f64 bias": (a, codes, fmt, s, b.double()),
    }
    for what, args in bad.items():
        with pytest.raises(ValueError, match="dequant_matmul"):
            ops.dequant_matmul(*args)


def test_dispatch_counts_and_no_fallback():
    """CPU tensors run the plain version and count as ``.ref``; the kernel
    wrapper refuses CPU tensors; mixed devices raise."""
    a, codes, fmt, s, b = _args()
    ops.reset_launch_counts()
    out = ops.dequant_matmul(a, codes, fmt, s, b)
    assert out.shape == (4, 16) and out.dtype == torch.float32
    assert ops.launch_counts() == {"dequant_matmul.ref": 1}
    with pytest.raises(ValueError, match="CUDA"):
        dm.dequant_matmul(a, codes, fmt, s, b)
    with pytest.raises(ValueError, match="expected all on CUDA or all on the CPU"):
        ops.dequant_matmul(a, codes, fmt, torch.ones((), device="meta"), b)


def test_linear_streams_code_form_weights_and_materializer_keeps_operands():
    """``linear`` flattens a (non-contiguous) [B, S, K] activation for the
    kernel; the serve materializer leaves only the named 2-D operands in
    code form and decodes the rest."""
    fmt = FloatFormat.parse("S1E3M7")
    rng = np.random.default_rng(3)
    w = torch.from_numpy((rng.standard_normal((3, 24, 16)) * 0.1).astype(np.float32))
    v = compress_variable(w, fmt, batch_axes=1)
    x = torch.from_numpy(rng.standard_normal((2, 5, 24)).astype(np.float32))[:, -1:]
    assert not x.is_contiguous()
    layer = OMCMaterializer()(dict(wq=v[1], conv_w=v[2]), operands=("wq",))
    assert is_compressed(layer["wq"]) and layer["wq"].codes.shape == (24, 16)
    assert isinstance(layer["conv_w"], torch.Tensor)
    ops.reset_launch_counts()
    got = linear(x, layer["wq"])
    assert got.shape == (2, 1, 16) and ops.launch_counts() == {"dequant_matmul.ref": 1}
    w1 = ref.ref_dequantize(v.codes[1], fmt, v.s[1], v.b[1])
    want = (x.reshape(2, 24) @ w1).reshape(2, 1, 16)  # the same 2-D product
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert torch.equal(linear(x, w1), x @ w1)  # an f32 weight: a plain matmul


def test_moved_bytes_and_flops():
    fmt = FloatFormat.parse("S1E3M7")
    assert dm.dequant_matmul_moved_bytes(4, 2048, 11008, fmt) == (
        4 * 4 * 2048 + 2 * 2048 * 11008 + 4 * 4 * 11008 + 8)
    assert dm.dequant_matmul_flops(4, 2048, 11008) == 2 * 4 * 2048 * 11008


# ---------------------------------------------------------------------------
# On the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built with nvcc and run on the card")
    return torch.device("cuda")


def _assert_within_rank1_tolerance(got, want, a, codes, fmt, s, b):
    w_eff = ref.ref_dequantize(codes, fmt, s, b)
    bound = 2e-5 * (a.abs() @ w_eff.abs())
    assert bool(((got - want).abs() <= bound).all()), float(((got - want).abs() - bound).max())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["S1E2M3", "S1E3M7", "S1E4M14"])
@pytest.mark.parametrize("mkn", [
    (4, 256, 384), (8, 1000, 256), (5, 513, 64), (2, 140000, 8),  # weight stream (M <= 8)
    (3, 37, 53), (1, 64, 7), (128, 96, 200), (130, 33, 64), (9, 300, 17),  # tiled
], ids=str)
def test_cuda_dequant_matmul_matches_plain(cuda, name, mkn):
    m, k, n = mkn
    fmt = FloatFormat.parse(name)
    a, w = _case(m, k, n, seed=m * k + n)
    v = compress_variable(torch.from_numpy(w).to(cuda), fmt)
    a = torch.from_numpy(a).to(cuda)
    b = v.b + 0.01  # a bias well away from zero
    got = dm.dequant_matmul(a, v.codes, fmt, v.s, b)
    want = ref.ref_dequant_matmul(a, v.codes, fmt, v.s, b)
    torch.cuda.synchronize()
    _assert_within_rank1_tolerance(got, want, a, v.codes, fmt, v.s, b)


@pytest.mark.cuda
def test_cuda_dequant_matmul_per_entry_scalars(cuda):
    fmt = FloatFormat.parse("S1E3M7")
    rng = np.random.default_rng(0)
    w = torch.from_numpy((rng.standard_normal((2, 2, 64, 96)) * 0.05).astype(np.float32))
    v = compress_variable(w.to(cuda), fmt, batch_axes=2)
    a = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32)).to(cuda)
    for g in range(2):
        for j in range(2):
            e = v[g][j]
            got = dm.dequant_matmul(a, e.codes, fmt, e.s, e.b)
            want = ref.ref_dequant_matmul(a, e.codes, fmt, e.s, e.b)
            _assert_within_rank1_tolerance(got, want, a, e.codes, fmt, e.s, e.b)
