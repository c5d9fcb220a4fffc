"""PyTorch port vs the JAX reference: the plain versions of the four kernels.

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
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jpacking
from repro.core.formats import FloatFormat as JFormat
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import packing
from repro_torch.core.formats import FloatFormat
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
