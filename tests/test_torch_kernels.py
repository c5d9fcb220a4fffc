"""PyTorch port vs the JAX reference: the plain versions of the six kernels.

Each plain version (``repro_torch.kernels.ref``, the CPU path of
``repro_torch.kernels.ops``) is held against ``repro.kernels.ref`` and
against the Pallas kernel body itself, run in interpret mode through
``repro.kernels.ops.<op>(..., force_interpret=True)`` as tests/test_kernels.py
does.  The CUDA kernels compute the same functions; ``chip_smoke.py`` holds
them against these plain versions on the card.

Tolerances: codes, bitstreams and decodes bit-exact; PVT sums within
rtol=atol=1e-4 (test_kernels.py's bound: f32 sums taken in another order);
the affine ``decode·s + b`` within the fused-vs-unfused multiply-add bound
(XLA may contract it into an FMA, ROADMAP C5; see _assert_affine_close).
``fused_aggregate``'s codes equal the reference's except on a
round-to-nearest-even tie fringe of at most 0.5%, where they differ by one
code (test_kernels.py:129-133's gate: f32 sums over clients taken in
another order), and its (s, b) within rtol=2e-5, atol=2e-6; so also with
the async runtime's flush weights (fractional, and underflowed to exactly 0
for live stale entries), on which the CUDA kernel must equal the plain
version bit for bit as on 0/1 weights.

The kernels' host-side rules are stated in Python and tested here:
``fused_aggregate``'s variant for a format and cohort
(``agg.kernel_variant``) and ``pack``'s tiling (``bitpack.pack_plan``).

The tests marked ``cuda`` hold each CUDA kernel against its plain version
on the card (bit-exact codes, streams and decodes; sums within rtol=1e-4),
and the C entries to the rules above; without a card they skip.  They need no JAX:
``pytest tests/test_torch_kernels.py -m cuda`` runs them on a machine with
the card.
"""

import math

import numpy as np
import pytest
import torch

try:  # the reference; a machine with the card has no JAX, and runs `-m cuda` only
    import jax.numpy as jnp
    from repro.core import packing as jpacking
    from repro.core.formats import FloatFormat as JFormat
    from repro.kernels import agg as jagg
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
except ImportError:
    jnp = None

from repro_torch.core import packing
from repro_torch.core.formats import FloatFormat, narrow, widen
from repro_torch.core.store import bit_equal
from repro_torch.federated import async_engine
from repro_torch.kernels import agg
from repro_torch.kernels import bitpack as bk
from repro_torch.kernels import ops
from repro_torch.kernels import quantize as qk
from repro_torch.kernels import ref

torch.set_num_threads(1)

FMTS = ["S1E2M3", "S1E3M7", "S1E4M14"]


def _x(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    x.reshape(-1)[:4] = [0.0, -0.0, 7e3, -1e-40]  # a zero, saturation, an f32 subnormal
    return x


@pytest.mark.parametrize("name", FMTS)
@pytest.mark.parametrize("shape", [(1000,), (37, 53)], ids=str)
def test_quantize_stats_plain_matches_reference(name, shape):
    fmt, jfmt = FloatFormat.parse(name), JFormat.parse(name)
    x = _x(shape, seed=len(shape))
    codes, sums = ref.ref_quantize_stats(torch.from_numpy(x), fmt)
    want_codes, want_sums = jref.ref_quantize_stats(jnp.asarray(x), jfmt)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))
    np.testing.assert_allclose(sums.numpy(), np.asarray(want_sums), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", FMTS)
def test_quantize_stats_plain_matches_pallas_interpret(name):
    fmt, jfmt = FloatFormat.parse(name), JFormat.parse(name)
    x = _x((37, 53), seed=3)
    codes, sums = ref.ref_quantize_stats(torch.from_numpy(x), fmt)
    want_codes, want_sums = jops.quantize_stats(jnp.asarray(x), jfmt, force_interpret=True)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))
    np.testing.assert_allclose(sums.numpy(), np.asarray(want_sums), rtol=1e-4, atol=1e-4)


def test_quantize_stats_plain_batch_axes_per_entry():
    """batch_axes=1: one row of sums per stacked entry, each the reference's
    whole-tensor sums of that entry."""
    fmt, jfmt = FloatFormat.parse("S1E3M7"), JFormat.parse("S1E3M7")
    x = _x((3, 40, 17), seed=5)
    codes, sums = ref.ref_quantize_stats(torch.from_numpy(x), fmt, batch_axes=1)
    assert sums.shape == (3, 4)
    for e in range(3):
        want_codes, want_sums = jref.ref_quantize_stats(jnp.asarray(x[e]), jfmt)
        np.testing.assert_array_equal(codes[e].numpy(), np.asarray(want_codes))
        np.testing.assert_allclose(sums[e].numpy(), np.asarray(want_sums), rtol=1e-4, atol=1e-4)


def _assert_affine_close(got, want, dec, s):
    """Fused (FMA) and unfused multiply-add differ by at most the rounding of
    the product plus that of the sum: one ulp of |dec·s| plus one ulp of the
    result.  Away from cancellation that is about one ulp of the result."""
    prod = np.abs(dec * s)
    bound = np.spacing(prod) + np.spacing(np.abs(want))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert (np.abs(got[fin] - want[fin]) <= bound[fin]).all()


@pytest.mark.parametrize("name", FMTS)
@pytest.mark.parametrize("shape", [(33, 40)], ids=str)
def test_dequantize_plain_matches_reference(name, shape):
    fmt, jfmt = FloatFormat.parse(name), JFormat.parse(name)
    codes = np.asarray(jref.ref_quantize(jnp.asarray(_x(shape, seed=7)), jfmt))
    tcodes = torch.from_numpy(codes.copy())
    # decode alone: bit-exact
    dec = ref.ref_dequantize(tcodes, fmt).numpy()
    np.testing.assert_array_equal(
        dec.view(np.uint32),
        np.asarray(jref.ref_dequantize(jnp.asarray(codes), jfmt)).view(np.uint32))
    # fused affine: the plain version multiplies, then adds (the CUDA kernel's
    # __fmul_rn/__fadd_rn), bit-exact with numpy's f32 arithmetic
    s, b = np.float32(1.05), np.float32(-0.01)
    got = ref.ref_dequantize(tcodes, fmt, torch.tensor(s), torch.tensor(b)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), (dec * s + b).view(np.uint32))
    want = jref.ref_dequantize(jnp.asarray(codes), jfmt, jnp.float32(s), jnp.float32(b))
    _assert_affine_close(got, np.asarray(want), dec, s)


@pytest.mark.parametrize("name", FMTS)
def test_dequantize_plain_matches_pallas_interpret(name):
    fmt, jfmt = FloatFormat.parse(name), JFormat.parse(name)
    codes = np.asarray(jref.ref_quantize(jnp.asarray(_x((33, 40), seed=8)), jfmt))
    tcodes = torch.from_numpy(codes.copy())
    dec = ref.ref_dequantize(tcodes, fmt).numpy()
    np.testing.assert_array_equal(
        dec.view(np.uint32),
        np.asarray(jops.dequantize(jnp.asarray(codes), jfmt, force_interpret=True))
        .view(np.uint32))
    s, b = np.float32(0.98), np.float32(0.004)
    got = ref.ref_dequantize(tcodes, fmt, torch.tensor(s), torch.tensor(b)).numpy()
    want = jops.dequantize(jnp.asarray(codes), jfmt, jnp.float32(s), jnp.float32(b),
                           force_interpret=True)
    _assert_affine_close(got, np.asarray(want), dec, s)


def _codes(n, width, seed):
    rng = np.random.default_rng(seed)
    dtype = np.uint8 if width <= 8 else np.uint16 if width <= 16 else np.uint32
    return rng.integers(0, 1 << width, n, dtype=np.uint64).astype(dtype)


@pytest.mark.parametrize("width", [2, 6, 11, 16, 19, 32])
@pytest.mark.parametrize("n", [1, 1001], ids=lambda n: f"n{n}")
def test_pack_unpack_plain_matches_reference(width, n):
    codes = _codes(n, width, seed=width * 1000 + n)
    words = ref.ref_pack(torch.from_numpy(codes), width)
    assert words.dtype == torch.uint32 and words.numel() == packing.packed_words(n, width)
    want = np.asarray(jpacking._pack_jnp(jnp.asarray(codes), width))
    np.testing.assert_array_equal(words.numpy(), want)
    back = ref.ref_unpack(words, width, n, torch.from_numpy(codes).dtype)
    np.testing.assert_array_equal(back.numpy(), codes)
    np.testing.assert_array_equal(
        ref.ref_unpack(words, width, n).numpy(),
        np.asarray(jpacking._unpack_jnp(jnp.asarray(want), width, n)))


@pytest.mark.parametrize("width", [2, 6, 11, 16, 19, 32])
def test_pack_unpack_plain_matches_pallas_interpret(width):
    n = 1001  # an odd tail for every width
    codes = _codes(n, width, seed=width)
    words = ref.ref_pack(torch.from_numpy(codes), width)
    np.testing.assert_array_equal(
        words.numpy(), np.asarray(jops.pack_bits(jnp.asarray(codes), width,
                                                 force_interpret=True)))
    np.testing.assert_array_equal(
        ref.ref_unpack(words, width, n).numpy(),
        np.asarray(jops.unpack_bits(jnp.asarray(words.numpy()), width, n,
                                    force_interpret=True)))


def test_bit_offsets_are_64_bit():
    """qwen2.5-3b's stacked w1 holds 36·2048·11008 codes; at 11 bits its last
    field starts at bit 8,927,576,053 > 2**32.  The port's offsets are exact
    there; the reference oracle's uint32 offsets (packing.py:44/:60) wrap."""
    n, width = 36 * 2048 * 11008, 11
    last = n - 1
    word, sh = packing.bit_offsets(torch.tensor([last]), width)
    assert last * width > 2**32
    assert int(word) == (last * width) >> 5 and int(sh) == (last * width) & 31
    assert ((last * width) % 2**32) >> 5 != int(word)  # what a uint32 offset gives


def test_dispatch_counts_and_no_fallback():
    """CPU tensors run the plain versions and are counted as such; the kernel
    wrappers refuse anything that is not on a CUDA device; mixed devices raise."""
    fmt = FloatFormat.parse("S1E3M7")
    x = torch.from_numpy(_x((8, 16), seed=9))
    ops.reset_launch_counts()
    codes, _ = ops.quantize_stats(x, fmt)
    words = ops.pack(codes.reshape(-1), fmt.bits)
    back = ops.unpack(words, fmt.bits, codes.numel(), fmt.container_dtype)
    ops.dequantize(back, fmt)
    assert ops.launch_counts() == {"quantize_stats.ref": 1, "pack.ref": 1,
                                   "unpack.ref": 1, "dequantize.ref": 1}
    for call in (lambda: qk.quantize_stats(x, fmt), lambda: qk.dequantize(codes, fmt),
                 lambda: bk.pack(codes, fmt.bits), lambda: bk.unpack(words, fmt.bits, 3)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="expected all on CUDA or all on the CPU"):
        ops.dequantize(codes, fmt, torch.ones((), device="meta"))


@pytest.mark.parametrize("name", FMTS)
@pytest.mark.parametrize("shape", [(1001,), (37, 53), (2, 3, 65)], ids=str)
def test_quantize_plain_matches_reference_and_quantize_stats(name, shape):
    fmt, jfmt = FloatFormat.parse(name), JFormat.parse(name)
    x = _x(shape, seed=sum(shape))
    x.reshape(-1)[4:6] = [np.nan, -np.inf]
    codes = ref.ref_quantize(torch.from_numpy(x), fmt)
    assert codes.dtype == fmt.container_dtype
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(jref.ref_quantize(jnp.asarray(x), jfmt)))
    np.testing.assert_array_equal(
        codes.numpy(), np.asarray(jops.quantize(jnp.asarray(x), jfmt, force_interpret=True)))
    assert bit_equal(codes, ref.ref_quantize_stats(torch.from_numpy(x), fmt)[0])


def _fused_case(name, shape, batch_axes, cohort=5, seed=0, dead=(1,), weights=None):
    """Server and client variables in storage form from a numpy seed, and a
    survival mask (or, with ``weights``, those client weights).  Dead clients
    carry a genuine NaN code, so the where-guard is what keeps them out of
    the mean."""
    fmt = FloatFormat.parse(name)
    rng = np.random.default_rng(seed)
    srv = ref.ref_quantize(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)), fmt)
    cl = ref.ref_quantize(torch.from_numpy(
        (rng.standard_normal((cohort,) + shape) * 0.7).astype(np.float32)), fmt)
    w = np.ones((cohort,), np.float32) if weights is None else np.array(weights, np.float32)
    nan_code = (((1 << fmt.exp_bits) - 1) << fmt.mant_bits) | (1 << (fmt.mant_bits - 1))
    for c in dead:
        w[c] = 0.0
        cl[c] = nan_code
    lead = tuple(shape[:batch_axes])
    arrays = [srv.numpy(), rng.normal(1.0, 0.05, lead).astype(np.float32),
              rng.normal(0.0, 0.01, lead).astype(np.float32), cl.numpy(),
              rng.normal(1.0, 0.05, (cohort,) + lead).astype(np.float32),
              rng.normal(0.0, 0.01, (cohort,) + lead).astype(np.float32), w]
    return ([torch.from_numpy(np.array(a)) for a in arrays],
            None if jnp is None else [jnp.asarray(a) for a in arrays], fmt,
            None if jnp is None else JFormat.parse(name))


def _assert_codes_close(got, want):
    g, w = got.astype(np.int64), want.astype(np.int64)
    diff = g != w
    assert diff.mean() <= 5e-3, f"{diff.sum()}/{diff.size} codes differ"
    assert np.abs(g - w)[diff].max(initial=0) <= 1, "non-adjacent code drift"


@pytest.mark.parametrize("name", FMTS)
@pytest.mark.parametrize("shape,batch_axes", [((37, 19), 0), ((3, 40, 17), 1), ((5,), 0),
                                              ((2, 3, 130), 2), ((1001,), 0)],
                         ids=["flat2d", "stacked1", "tiny", "stacked2", "odd_tail"])
def test_fused_aggregate_plain_matches_reference(name, shape, batch_axes):
    """Against the reference's oracle everywhere, and against its Pallas body
    in interpret mode in S1E3M7 and for the stacked leaf in every container
    (interpret mode takes seconds a case)."""
    case, jcase, fmt, jfmt = _fused_case(name, shape, batch_axes)
    codes, s, b = ops.fused_aggregate(*case, 0.5, fmt, batch_axes=batch_axes)
    wants = [jref.ref_fused_aggregate(*jcase, 0.5, jfmt, batch_axes=batch_axes)]
    if name == "S1E3M7" or shape == (3, 40, 17):
        wants.append(jagg.fused_aggregate(*jcase, 0.5, jfmt, batch_axes=batch_axes,
                                          interpret=True))
    for want in wants:
        assert codes.shape == shape and codes.dtype == fmt.container_dtype
        _assert_codes_close(codes.numpy(), np.asarray(want[0]))
        assert s.shape == want[1].shape and b.shape == want[2].shape
        assert torch.isfinite(s).all() and torch.isfinite(b).all()
        np.testing.assert_allclose(s.numpy(), np.asarray(want[1]), rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(b.numpy(), np.asarray(want[2]), rtol=2e-5, atol=2e-6)


# a buffer flush's staleness weights (async_engine.flush_weights), K = 5:
# fractional weights, and at decay 200 weights that underflow to exactly 0
# for live, stale entries (their planes are skipped like dead ones)
STALENESS = {"poly0.5": ([0, 1, 1, 2, 3], 0.5, "poly"), "exp2": ([0, 2, 5, 1, 0], 2.0, "exp"),
             "poly200": ([0, 1, 3, 0, 2], 200.0, "poly")}


def _staleness_case(name, shape, batch_axes, which):
    s, decay, mode = STALENESS[which]
    w = async_engine.flush_weights(np.asarray(s, np.float32), decay, mode).numpy()
    assert np.all(w <= 1) and w.max() > 0 and (which != "poly200" or (w == 0).sum() == 3)
    return _fused_case(name, shape, batch_axes, dead=(), weights=w)


@pytest.mark.parametrize("which", sorted(STALENESS))
@pytest.mark.parametrize("name", FMTS)
@pytest.mark.parametrize("shape,batch_axes", [((37, 19), 0), ((3, 40, 17), 1)],
                         ids=["flat2d", "stacked1"])
def test_fused_aggregate_plain_matches_reference_with_staleness_weights(name, shape,
                                                                       batch_axes, which):
    """The async flush's fractional weights: the plain version against the
    reference's oracle, and in S1E3M7 against its Pallas body in interpret
    mode, at the gate of the 0/1-weight cases."""
    case, jcase, fmt, jfmt = _staleness_case(name, shape, batch_axes, which)
    codes, s, b = ops.fused_aggregate(*case, 0.5, fmt, batch_axes=batch_axes)
    wants = [jref.ref_fused_aggregate(*jcase, 0.5, jfmt, batch_axes=batch_axes)]
    if name == "S1E3M7":
        wants.append(jagg.fused_aggregate(*jcase, 0.5, jfmt, batch_axes=batch_axes,
                                          interpret=True))
    for want in wants:
        _assert_codes_close(codes.numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(s.numpy(), np.asarray(want[1]), rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(b.numpy(), np.asarray(want[2]), rtol=2e-5, atol=2e-6)


def test_fused_aggregate_all_dead_is_pure_server_decay():
    """Every client dead (all-NaN rows): the mean is 0 and the round is
    old + lr·(0 − old); the reference's own bound, 6e-3."""
    case, jcase, fmt, jfmt = _fused_case("S1E3M7", (64,), 0, cohort=4, dead=(0, 1, 2, 3))
    codes, s, b = ops.fused_aggregate(*case, 0.25, fmt)
    old = ref.ref_dequantize(case[0], fmt, case[1], case[2]).numpy()
    got = ref.ref_dequantize(codes, fmt, s, b).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, 0.75 * old, atol=6e-3)
    want = jops.fused_aggregate(*jcase, 0.25, jfmt)
    _assert_codes_close(codes.numpy(), np.asarray(want[0]))


def test_fused_aggregate_pvt_off_returns_identity_affine():
    case, jcase, fmt, jfmt = _fused_case("S1E3M7", (33,), 0)
    codes, s, b = ops.fused_aggregate(*case, 0.5, fmt, pvt=False)
    assert s.shape == () and b.shape == () and float(s) == 1.0 and float(b) == 0.0
    want = jops.fused_aggregate(*jcase, 0.5, jfmt, pvt=False)
    _assert_codes_close(codes.numpy(), np.asarray(want[0]))


def test_fused_aggregate_moved_bytes_has_no_tile_padding():
    """conformer_s' [17, 512, 2048] leaf at cohort 8 in u16: (8 + 2) planes of
    17,825,792 codes, plus 2·17 + 2·8·17 + 8 + 1 scalars and 17 sums of 4."""
    fmt = FloatFormat.parse("S1E3M7")
    n = 17 * 512 * 2048
    got = agg.fused_aggregate_moved_bytes(8, n, fmt, stack_entries=17)
    assert got == 10 * n * 2 + 4 * (2 * 17 + 2 * 8 * 17 + 8 + 1) + 4 * 17 * 4
    assert jagg.fused_aggregate_moved_bytes(8, n, JFormat.parse("S1E3M7"),
                                            stack_entries=17) >= got


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built with nvcc and run on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", FMTS)
@pytest.mark.parametrize("shape,batch_axes", [((1001,), 0), ((3, 1001), 1), ((2, 3, 65), 2)],
                         ids=str)
def test_cuda_codec_kernels_match_plain(cuda, name, shape, batch_axes):
    fmt = FloatFormat.parse(name)
    x = torch.from_numpy(_x(shape, seed=sum(shape))).to(cuda)
    codes, sums = qk.quantize_stats(x, fmt, batch_axes)
    rcodes, rsums = ref.ref_quantize_stats(x, fmt, batch_axes)
    assert bit_equal(codes, rcodes)
    torch.testing.assert_close(sums, rsums, rtol=1e-4, atol=1e-4)
    assert bit_equal(qk.quantize(x, fmt), rcodes)
    # one (s, b) pair per stacked entry, shaped [*stack, 1, ...] as storage holds them
    lead = shape[:batch_axes]
    bshape = lead + (1,) * (len(shape) - batch_axes)
    s = torch.linspace(0.9, 1.1, max(1, math.prod(lead)), device=cuda).reshape(bshape)
    b = torch.linspace(-0.01, 0.01, max(1, math.prod(lead)), device=cuda).reshape(bshape)
    assert bit_equal(qk.dequantize(codes, fmt, s, b), ref.ref_dequantize(codes, fmt, s, b))
    words = bk.pack(codes.reshape(-1), fmt.bits)
    assert bit_equal(words, ref.ref_pack(codes.reshape(-1), fmt.bits))
    assert bit_equal(bk.unpack(words, fmt.bits, codes.numel(), codes.dtype), codes.reshape(-1))


@pytest.mark.cuda
@pytest.mark.parametrize("name", FMTS)
@pytest.mark.parametrize("shape,batch_axes", [((37, 19), 0), ((3, 40, 17), 1),
                                              ((2, 3, 130), 2)], ids=str)
def test_cuda_fused_aggregate_matches_plain(cuda, name, shape, batch_axes):
    case, _, fmt, _ = _fused_case(name, shape, batch_axes)
    case = [t.to(cuda) for t in case]
    codes, sums = agg.fused_aggregate(*case, 0.7, fmt, batch_axes=batch_axes)
    rcodes, rsums = ref.ref_fused_aggregate(*case, 0.7, fmt, batch_axes=batch_axes)
    assert bit_equal(codes, rcodes)
    torch.testing.assert_close(sums, rsums, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("which", sorted(STALENESS))
@pytest.mark.parametrize("name", FMTS)
@pytest.mark.parametrize("shape,batch_axes", [((37, 19), 0), ((3, 40, 17), 1),
                                              ((17, 4096), 1)], ids=str)
def test_cuda_fused_aggregate_matches_plain_with_staleness_weights(cuda, name, shape,
                                                                  batch_axes, which):
    """Fractional flush weights (and weights underflowed to 0): the kernel's
    codes bit for bit the plain version's, sums within rtol = atol = 1e-4."""
    case, _, fmt, _ = _staleness_case(name, shape, batch_axes, which)
    case = [t.to(cuda) for t in case]
    codes, sums = agg.fused_aggregate(*case, 0.7, fmt, batch_axes=batch_axes)
    rcodes, rsums = ref.ref_fused_aggregate(*case, 0.7, fmt, batch_axes=batch_axes)
    assert bit_equal(codes, rcodes)
    torch.testing.assert_close(sums, rsums, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# The kernels' host-side rules (stated in Python, decided by the C entries)
# ---------------------------------------------------------------------------

ZOO = ["S1E2M1", "S1E2M3", "S1E3M7", "S1E4M3", "S1E4M14", "S1E5M10", "S1E8M7", "S1E8M23"]
# the variant fused_aggregate takes at cohorts 1, 8, 33 and 4096: S1E3M7 compiled
# in; tables of 4-byte entries while C << bits of them fit in 96 KB; else the
# run-time decode
_VARIANTS = {
    "S1E2M1": (agg.TABLE,) * 3 + (agg.DECODE_RUNTIME,),  # 16 codes: 4096 x 64 B > 96 KB
    "S1E2M3": (agg.TABLE,) * 3 + (agg.DECODE_RUNTIME,),
    "S1E3M7": (agg.DECODE_S1E3M7,) * 4,
    "S1E4M3": (agg.TABLE,) * 3 + (agg.DECODE_RUNTIME,),  # 33 x 1 KB fits
    "S1E4M14": (agg.DECODE_RUNTIME,) * 4,
    "S1E5M10": (agg.DECODE_RUNTIME,) * 4,  # 16 bits: no tables
    "S1E8M7": (agg.DECODE_RUNTIME,) * 4,
    "S1E8M23": (agg.DECODE_RUNTIME,) * 4,
}


@pytest.mark.parametrize("name", ZOO)
@pytest.mark.parametrize("clients", [1, 8, 33, 4096])
def test_fused_aggregate_kernel_variant_rule(name, clients):
    fmt = FloatFormat.parse(name)
    want = _VARIANTS[name][[1, 8, 33, 4096].index(clients)]
    assert agg.kernel_variant(fmt, clients) == want
    if want == agg.TABLE:
        assert fmt.bits <= agg.TABLE_MAX_BITS
        assert (clients << fmt.bits) * 4 <= agg.TABLE_BYTES


@pytest.mark.parametrize("clients", [0, -1, 4097])
def test_fused_aggregate_kernel_variant_rejects_cohorts(clients):
    with pytest.raises(ValueError, match="clients"):
        agg.kernel_variant(FloatFormat.parse("S1E3M7"), clients)


# the decode dequantize takes: the served and trained S1E3M7 and the
# driver's S1E4M14 compiled in, every other format read at run time
_DQ_VARIANTS = {name: qk.DECODE_RUNTIME for name in ZOO}
_DQ_VARIANTS.update(S1E3M7=qk.DECODE_S1E3M7, S1E4M14=qk.DECODE_S1E4M14)


@pytest.mark.parametrize("name", ZOO)
def test_dequantize_kernel_variant_rule(name):
    assert qk.kernel_variant(FloatFormat.parse(name)) == _DQ_VARIANTS[name]


@pytest.mark.parametrize("width,dtype", [(1, torch.uint8), (6, torch.uint8), (8, torch.uint8),
                                         (11, torch.uint16), (16, torch.uint16),
                                         (3, torch.uint32), (19, torch.uint32),
                                         (32, torch.uint32)], ids=str)
@pytest.mark.parametrize("n", [0, 1, 8191, 8192, 8193, 811_597_824])
def test_pack_plan_tiles_superblocks(width, dtype, n):
    """A tile is 256 superblocks of 32 fields, one a thread; its output,
    1024 * width bytes, starts on a 16-byte boundary; the kernel is the one
    compiled for (container bits, width)."""
    p = bk.pack_plan(n, width, dtype)
    assert p["kernel"] == (8 * dtype.itemsize, width)
    assert p["tile_fields"] == bk.TILE_FIELDS == 128 * 64
    assert p["tile_words"] == 256 * width and (4 * p["tile_words"]) % 16 == 0
    assert p["tiles"] == -(-n // bk.TILE_FIELDS)
    # the tiles' words cover the stream, the last tile's only in part
    assert p["tiles"] * p["tile_words"] >= packing.packed_words(n, width)
    assert (p["tiles"] - 1) * p["tile_words"] < max(packing.packed_words(n, width), 1)


@pytest.mark.parametrize("width,dtype,err", [(0, torch.uint8, ValueError),
                                             (33, torch.uint32, ValueError),
                                             (9, torch.uint8, ValueError),
                                             (17, torch.uint16, ValueError),
                                             (8, torch.int32, TypeError)], ids=str)
def test_pack_plan_rejects_widths_and_containers(width, dtype, err):
    with pytest.raises(err):
        bk.pack_plan(100, width, dtype)


def test_pack_plan_rejects_more_tiles_than_a_grid_holds():
    with pytest.raises(ValueError, match="codes"):
        bk.pack_plan((2**31) * bk.TILE_FIELDS, 11, torch.uint16)
    with pytest.raises(ValueError, match="codes"):
        bk.pack_plan(-1, 11, torch.uint16)


# ---------------------------------------------------------------------------
# On the card: the redesigned pack and fused_aggregate at their edges
# ---------------------------------------------------------------------------

_WIDTHS = [(w, d) for d in (torch.uint8, torch.uint16, torch.uint32)
           for w in range(1, 8 * d.itemsize + 1)]
# tile edges (8192 fields), superblock edges (32), and odd tails
_PACK_NS = [1, 31, 32, 33, 8191, 8192, 8193, 3 * 8192 - 1, 3 * 8192 + 1, 100_003]


def _cuda_codes(n, width, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    vals = torch.randint(0, min(1 << width, 1 << 31), (n,), generator=g, device=device)
    if width == 32:
        vals = vals * 2 + (vals & 1)  # reach the top bit too
    return narrow(vals, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("width,dtype", _WIDTHS, ids=str)
def test_cuda_pack_matches_plain_at_tile_edges(cuda, width, dtype):
    """Every width in every container it fits, at tile and superblock edges,
    and from a codes pointer off the 16-byte grid: the plain version's words,
    and unpack(pack(x)) == x.  The C entry's tiling is pack_plan's."""
    for n in _PACK_NS:
        codes = _cuda_codes(n + 1, width, dtype, cuda, seed=n * 64 + width)
        for flat in (codes[:n], codes[1:]):  # aligned, and one element off
            words = bk.pack(flat, width)
            assert bit_equal(words, ref.ref_pack(flat, width)), (width, n)
            assert bit_equal(bk.unpack(words, width, n, dtype), flat), (width, n)
        assert bk.kernel_pack_plan(n, width, dtype) == bk.pack_plan(n, width, dtype)


def _cuda_fused_case(name, entries, m, clients, device, seed=0, live_nan=True):
    """Random codes and scalars for a stacked leaf [entries, m]; clients 1
    and 5 (where they exist) dead with NaN codes; with ``live_nan`` one
    element of live client 0 NaN too."""
    fmt = FloatFormat.parse(name)
    g = torch.Generator(device=device).manual_seed(seed)
    shape = (entries, m)
    srv = qk.quantize(torch.randn(shape, generator=g, device=device) * 0.05, fmt)
    cl = qk.quantize(torch.randn((clients,) + shape, generator=g, device=device) * 0.05, fmt)
    nan_code = (((1 << fmt.exp_bits) - 1) << fmt.mant_bits) | (1 << (fmt.mant_bits - 1))
    w = torch.ones(clients, device=device)
    wide = widen(cl)
    for c in (1, 5):
        if c < clients:
            w[c] = 0.0
            wide[c] = nan_code
    if live_nan:
        wide[0, entries - 1, m // 2] = nan_code
    cl = narrow(wide, fmt.container_dtype)
    args = (srv, 1 + 0.05 * torch.randn(entries, generator=g, device=device),
            0.01 * torch.randn(entries, generator=g, device=device), cl,
            1 + 0.05 * torch.randn((clients, entries), generator=g, device=device),
            0.01 * torch.randn((clients, entries), generator=g, device=device), w)
    return args, fmt


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["S1E3M7", "S1E2M3", "S1E4M3", "S1E4M14"])
@pytest.mark.parametrize("entries", [1, 17])
@pytest.mark.parametrize("clients", [1, 8, 33])
@pytest.mark.parametrize("m", [4096, 1001], ids=lambda m: f"m{m}")
def test_cuda_fused_aggregate_each_variant(cuda, name, entries, clients, m):
    """Each variant (S1E3M7 compiled in; tables for S1E2M3 and S1E4M3; the
    run-time decode for S1E4M14), on 16-byte vectors (m = 4096) and scalars
    (m = 1001), with NaN codes in live and dead rows: codes bit-equal to the
    plain version's, sums within rtol = atol = 1e-4 (NaN where it is), the
    variant kernel_variant's, and the same bits from two launches with a
    launch on all-NaN client codes between them."""
    args, fmt = _cuda_fused_case(name, entries, m, clients, cuda, seed=entries + clients + m)
    lay = agg.layout(*args, batch_axes=1)
    assert agg.plan(lay, fmt)["variant"] == agg.kernel_variant(fmt, clients)
    codes, sums = agg.fused_aggregate(*args, 0.7, fmt, batch_axes=1)
    rcodes, rsums = ref.ref_fused_aggregate(*args, 0.7, fmt, batch_axes=1)
    assert bit_equal(codes, rcodes)
    torch.testing.assert_close(sums, rsums, rtol=1e-4, atol=1e-4, equal_nan=True)
    nan_code = (((1 << fmt.exp_bits) - 1) << fmt.mant_bits) | (1 << (fmt.mant_bits - 1))
    all_nan = narrow(torch.full(args[3].shape, nan_code, device=cuda),
                             fmt.container_dtype)
    agg.fused_aggregate(*args[:3], all_nan, *args[4:], 0.7, fmt, batch_axes=1)
    again = agg.fused_aggregate(*args, 0.7, fmt, batch_axes=1)
    assert bit_equal(codes, again[0]) and bit_equal(sums, again[1])


def _every_code(fmt: FloatFormat, device, multiple: int = 1) -> torch.Tensor:
    """Every code of ``fmt`` (inf and NaN included), zero-padded to a
    multiple of ``multiple``, in its container."""
    c = torch.arange(1 << fmt.bits, device=device)
    pad = -c.numel() % multiple
    return narrow(torch.cat([c, torch.zeros(pad, dtype=c.dtype, device=device)]),
                  fmt.container_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["S1E2M3", "S1E3M7", "S1E4M3", "S1E5M10", "S1E4M14"])
@pytest.mark.parametrize("entries", [1, 16])
def test_cuda_dequantize_every_code_each_variant(cuda, name, entries):
    """Every code of the format, inf and NaN included, decoded by the
    kernel's variant (kernel_variant's) on 16-byte vectors, with one (s, b)
    or one pair per stacked entry, b != 0: the plain version's bits; and the
    same bits from two launches with one on all-NaN codes between them."""
    fmt = FloatFormat.parse(name)
    codes = _every_code(fmt, cuda, multiple=16 * entries).reshape(entries, -1)
    g = torch.Generator(device=cuda).manual_seed(entries)
    s = (1 + 0.05 * torch.randn(entries, generator=g, device=cuda)).reshape(entries, 1)
    b = (0.01 * torch.randn(entries, generator=g, device=cuda)).reshape(entries, 1)
    if entries == 1:
        codes, s, b = codes.reshape(-1), s.reshape(()), b.reshape(())
    plan = qk.dequantize_plan(codes, fmt, s)
    assert plan["variant"] == qk.kernel_variant(fmt) and plan["vec"]
    got = qk.dequantize(codes, fmt, s, b)
    nan_code = (((1 << fmt.exp_bits) - 1) << fmt.mant_bits) | (1 << (fmt.mant_bits - 1))
    qk.dequantize(narrow(torch.full(codes.shape, nan_code, device=cuda), fmt.container_dtype),
                  fmt, s, b)
    again = qk.dequantize(codes, fmt, s, b)
    assert bit_equal(got, ref.ref_dequantize(codes, fmt, s, b))
    assert bit_equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["S1E2M3", "S1E3M7", "S1E4M14"])
@pytest.mark.parametrize("shape,batch_axes,offset", [((1001,), 0, 0), ((1001,), 0, 1),
                                                     ((3, 65), 1, 0), ((2, 3, 17), 2, 0),
                                                     ((5, 32), 1, 1)], ids=str)
def test_cuda_dequantize_unaligned_odd_tails(cuda, name, shape, batch_axes, offset):
    """Odd tails in u8, u16 and u32: a single entry past its last whole
    vector, stacks whose entries are no multiple of 16 codes, and codes one
    element off the 16-byte grid (the scalar pass): the plain version's
    bits."""
    fmt = FloatFormat.parse(name)
    n = math.prod(shape)
    every = torch.arange(offset + n, device=cuda) % (1 << fmt.bits)
    codes = narrow(every, fmt.container_dtype)[offset:].reshape(shape)
    lead = shape[:batch_axes]
    bshape = lead + (1,) * (len(shape) - batch_axes)
    s = torch.linspace(0.9, 1.1, max(1, math.prod(lead)), device=cuda).reshape(bshape)
    b = torch.linspace(-0.01, 0.01, max(1, math.prod(lead)), device=cuda).reshape(bshape)
    aligned = codes.data_ptr() % 16 == 0 and (batch_axes == 0 or n // math.prod(lead) % 16 == 0)
    assert qk.dequantize_plan(codes, fmt, s)["vec"] == aligned
    assert bit_equal(qk.dequantize(codes, fmt, s, b), ref.ref_dequantize(codes, fmt, s, b))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["S1E3M7", "S1E4M3", "S1E4M14"])
def test_cuda_fused_aggregate_all_clients_dead(cuda, name):
    args, fmt = _cuda_fused_case(name, 3, 2048, 8, cuda, live_nan=False)
    w = torch.zeros_like(args[6])
    cl = narrow(torch.full(args[3].shape, 1 << (fmt.bits - 1), device=cuda) - 1,
                        fmt.container_dtype)  # the largest positive codes: NaN in most formats
    args = args[:3] + (cl,) + args[4:6] + (w,)
    codes, sums = agg.fused_aggregate(*args, 0.25, fmt, batch_axes=1)
    rcodes, rsums = ref.ref_fused_aggregate(*args, 0.25, fmt, batch_axes=1)
    assert bit_equal(codes, rcodes)
    assert bool(torch.isfinite(sums).all())
    torch.testing.assert_close(sums, rsums, rtol=1e-4, atol=1e-4)


def test_fused_aggregate_moved_bytes_counts_live_planes():
    """A dead client's plane is never read: with 6 of 8 clients live the
    codes moved are (6 + 2) planes, the scalars those of all 8."""
    fmt = FloatFormat.parse("S1E3M7")
    n = 17 * 512 * 2048
    full = agg.fused_aggregate_moved_bytes(8, n, fmt, stack_entries=17)
    assert agg.fused_aggregate_moved_bytes(8, n, fmt, stack_entries=17, live=8) == full
    assert full - agg.fused_aggregate_moved_bytes(8, n, fmt, stack_entries=17, live=6) == 2 * n * 2
