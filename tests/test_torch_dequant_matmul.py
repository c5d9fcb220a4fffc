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
code vectors; K split over warps and a cluster) and the tile on the tensor
cores (everything else; 2xTF32, or 3xTF32 for S1E4M14).  Two more hold
every finite code of five formats, decoded inside each path, to the plain
decode bit for bit, and two launches to the same bits.  Without a card
they skip; they need no JAX (``pytest tests/test_torch_dequant_matmul.py -m
cuda`` on a machine with the card).
"""

import numpy as np
import pytest
import torch

try:  # the reference; a machine with the card has no JAX, and runs `-m cuda` only
    import jax.numpy as jnp
    from repro.core import formats as jformats
    from repro.core.formats import FloatFormat as JFormat
    from repro.kernels import dequant_matmul as jdm
    from repro.kernels import ref as jref
except ImportError:
    jnp = None

from repro_torch.core.formats import FloatFormat, decode, narrow
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


def _finite_codes(fmt):
    """Every code of ``fmt`` whose exponent field is not the top (inf/NaN) one."""
    c = np.arange(1 << fmt.bits, dtype=np.int64)
    top = (1 << fmt.exp_bits) - 1
    return c[((c >> fmt.mant_bits) & top) != top]


@pytest.mark.parametrize("name,exact", [("S1E2M3", True), ("S1E3M7", True), ("S1E4M3", True),
                                        ("S1E5M10", True), ("S1E4M14", False)])
def test_decoded_values_exact_in_tf32(name, exact):
    """The tile path's two passes rest on this: every finite decoded value
    of a format with <= 10 mantissa bits has the low 13 bits of its f32
    pattern zero (exact in TF32), and equals the reference's decode; a
    format with more mantissa bits is not exact, and takes three passes."""
    fmt = FloatFormat.parse(name)
    codes = narrow(torch.from_numpy(_finite_codes(fmt)), fmt.container_dtype)
    got = decode(codes, fmt)
    want = np.asarray(jformats.decode(jnp.asarray(codes.numpy()), JFormat.parse(name)))
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    low13 = got.numpy().view(np.int32) & 0x1FFF
    assert bool((low13 == 0).all()) == exact == dm.tf32_exact(fmt)


@pytest.mark.parametrize("name,variant", [
    ("S1E3M7", (dm.CODEC_S1E3M7, 2)), ("S1E5M10", (dm.CODEC_RUNTIME, 2)),
    ("S1E2M3", (dm.CODEC_RUNTIME, 2)), ("S1E4M3", (dm.CODEC_RUNTIME, 2)),
    ("S1E2M13", (dm.CODEC_RUNTIME, 3)), ("S1E4M14", (dm.CODEC_RUNTIME, 3)),
    ("S1E8M23", (dm.CODEC_RUNTIME, 3)),
])
def test_kernel_variant_picks_codec_and_passes(name, variant):
    """The host's choice: S1E3M7 (u16) is the compile-time format, every
    other one is read at run time; two TF32 passes where the decoded weight
    is exact in TF32, three where it is not."""
    fmt = FloatFormat.parse(name)
    assert dm.kernel_variant(fmt) == variant
    if fmt.bits <= 16:  # small enough to check the passes against every code
        vals = decode(narrow(torch.from_numpy(_finite_codes(fmt)), fmt.container_dtype), fmt)
        assert bool(((vals.view(torch.int32) & 0x1FFF) == 0).all()) == (variant[1] == 2)


def _tf32_rn(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: round f32 to 10 mantissa bits, ties away from zero."""
    b = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((b + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def _trunc_f32(x: np.ndarray) -> np.ndarray:
    """float64 -> f32, rounded toward zero (the tensor cores' accumulation)."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    return np.where(over, np.nextafter(f, np.float32(0)), f)


def _emulate_tile(a, dec, s, b, split_a):
    """The tile path's arithmetic in numpy: A split into TF32 halves (or
    only rounded), products exact, each k = 8 step of each pass summed and
    added to an f32 accumulator rounded toward zero; then s·acc + b·rowsum."""
    a_hi = _tf32_rn(a)
    a_lo = _tf32_rn(a - a_hi)
    passes = (a_lo, a_hi) if split_a else (a_hi,)
    acc = np.zeros((a.shape[0], dec.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        for ap in passes:
            step = ap[:, k0:k0 + 8].astype(np.float64) @ dec[k0:k0 + 8].astype(np.float64)
            acc = _trunc_f32(acc.astype(np.float64) + step)
    rowsum = a.sum(1, keepdims=True, dtype=np.float32)
    return (np.float32(s) * acc + np.float32(b) * rowsum).astype(np.float32)


def test_two_tf32_passes_stay_within_the_f32_bound():
    """At K = 2048 (decode w1's depth) the 2xTF32 product of the tile path,
    emulated with the tensor cores' rounding, stays well inside
    2e-5·(|A| @ |W_eff|) of the f32 plain version; one TF32 pass does not."""
    fmt = FloatFormat.parse("S1E3M7")
    a, w = _case(8, 2048, 64, seed=11, w_scale=0.02)
    v = compress_variable(torch.from_numpy(w), fmt)
    s, b = v.s, v.b + 0.003
    want = ref.ref_dequant_matmul(torch.from_numpy(a), v.codes, fmt, s, b).numpy()
    dec = decode(v.codes, fmt).numpy()
    w_eff = ref.ref_dequantize(v.codes, fmt, s, b).numpy()
    bound = 2e-5 * (np.abs(a) @ np.abs(w_eff))
    two = np.abs(_emulate_tile(a, dec, s.item(), b.item(), True) - want) / bound
    one = np.abs(_emulate_tile(a, dec, s.item(), b.item(), False) - want) / bound
    assert two.max() <= 0.25, two.max()
    assert one.max() > 1.0, one.max()


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


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["S1E3M7", "S1E5M10", "S1E2M3", "S1E4M3", "S1E2M13",
                                  "S1E4M14", "S1E8M23"])
def test_cuda_kernel_takes_the_stated_variant(cuda, name):
    """The C entry picks its decode and the tile path's passes from the
    format; they are the ones ``kernel_variant`` states."""
    fmt = FloatFormat.parse(name)
    a = torch.zeros((128, 64), device=cuda)
    codes = torch.zeros((64, 64), dtype=fmt.container_dtype, device=cuda)
    got = dm.plan(a, codes, fmt)
    assert got["path"] == "tile"
    assert (got["codec"], got["passes"]) == dm.kernel_variant(fmt)


def _one_hot_case(cuda, name, rows):
    """Every finite code of ``name`` laid out as ``rows`` rows of a whole
    number of 16 codes (zeros after the last code), with A the
    identity: the product with s = 1, b = 0 is the decoded codes themselves."""
    fmt = FloatFormat.parse(name)
    flat = _finite_codes(fmt)
    cols = -(-flat.size // (rows * 16)) * 16
    flat = np.concatenate([flat, np.zeros(rows * cols - flat.size, np.int64)])
    codes = narrow(torch.from_numpy(flat.reshape(rows, cols)), fmt.container_dtype).to(cuda)
    a = torch.eye(rows, dtype=torch.float32, device=cuda)
    one, zero = torch.ones((), device=cuda), torch.zeros((), device=cuda)
    return fmt, a, codes, one, zero


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["S1E2M3", "S1E3M7", "S1E4M3", "S1E5M10", "S1E4M14"])
@pytest.mark.parametrize("path,rows", [("stream", 8), ("tile", 128)])
def test_cuda_decodes_every_code_exactly(cuda, name, path, rows):
    """Each path decodes every finite code of the format inside the kernel
    exactly as the plain decode: one-hot rows of A pick single codes, and
    a one-hot TF32 split is exact (A_lo = 0; dec_lo carries the bits TF32
    drops for S1E4M14)."""
    fmt, a, codes, one, zero = _one_hot_case(cuda, name, rows)
    assert dm.plan(a, codes, fmt)["path"] == path
    want = decode(codes, fmt)
    got = dm.dequant_matmul(a, codes, fmt, one, zero)
    torch.cuda.synchronize()
    assert torch.equal(got, want)  # -0.0 comes out as +0.0 (0 + -0), equal as values


@pytest.mark.cuda
@pytest.mark.parametrize("mkn", [(4, 2048, 1024), (8, 8192, 64), (128, 512, 704),
                                 (128, 4096, 256), (130, 33, 64)], ids=str)
def test_cuda_same_bits_from_launch_to_launch(cuda, mkn):
    """No float atomics: two launches give the same bits, on both paths and
    with K split over a cluster (the fixed-order sums), also with a launch
    on an all-NaN A between them (no stale shared memory is read)."""
    m, k, n = mkn
    fmt = FloatFormat.parse("S1E3M7")
    a, w = _case(m, k, n, seed=m + k + n)
    v = compress_variable(torch.from_numpy(w).to(cuda), fmt)
    a = torch.from_numpy(a).to(cuda)
    first = dm.dequant_matmul(a, v.codes, fmt, v.s, v.b)
    for _ in range(3):
        dm.dequant_matmul(torch.full_like(a, float("nan")), v.codes, fmt, v.s, v.b)
        again = dm.dequant_matmul(a, v.codes, fmt, v.s, v.b)
        assert torch.equal(first.view(torch.int32), again.view(torch.int32))
    _assert_within_rank1_tolerance(first, ref.ref_dequant_matmul(a, v.codes, fmt, v.s, v.b),
                                   a, v.codes, fmt, v.s, v.b)
