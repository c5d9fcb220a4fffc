"""PyTorch port vs the JAX reference: minifloat value_quantize / encode / decode.

Same inputs (made with numpy) through ``repro.core.formats`` and
``repro_torch.core.formats``; every comparison is on the raw bits, with no
tolerance: both sides are defined in bits (RNE on the mantissa bits, exact
power-of-two scaling, bit assembly on decode).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jf
from repro_torch.core import formats as tf

torch.set_num_threads(1)

FMTS = ["S1E2M3", "S1E3M7", "S1E4M3", "S1E4M14", "S1E5M10", "S1E8M23"]
_NP_CONTAINER = {1: np.uint8, 2: np.uint16, 4: np.uint32}


def _np_codes(codes: np.ndarray, fmt: tf.FloatFormat) -> np.ndarray:
    return codes.astype(_NP_CONTAINER[fmt.container_bytes_per_value])


def _inputs(fmt: tf.FloatFormat, seed: int = 0) -> np.ndarray:
    """Normals at several scales, exact RNE ties, ±max_normal and beyond,
    ±0, ±inf and NaNs with payloads.  No f32 subnormals (own test below)."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(1500).astype(np.float32) * s for s in (1e-3, 0.02, 1.0, 30.0, 1e4)]
    ties = []
    for e in range(-4, 5):  # midpoints between neighbouring normals: exact ties
        ulp = 2.0 ** e * 2.0 ** -fmt.mant_bits
        ties += [2.0 ** e + (k + 0.5) * ulp for k in range(6)]
    ties += [(k + 0.5) * fmt.subnormal_step for k in range(6)]  # subnormal ties
    mx = fmt.max_normal
    with np.errstate(over="ignore"):
        special = np.array(ties + [-t for t in ties] + [
            mx, -mx, mx * 1.5, -mx * 1.5, np.inf, -np.inf, 0.0, -0.0, np.nan,
            fmt.min_normal, -fmt.min_normal, fmt.min_normal * 0.999], np.float32)
    nans = np.array([0x7F800001, 0xFFC00001, 0x7FFFFFFF], np.uint32).view(np.float32)
    return np.concatenate(xs + [special, nans])


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("name", FMTS)
def test_value_quantize_bit_exact(name):
    fmt, jfmt = tf.FloatFormat.parse(name), jf.FloatFormat.parse(name)
    x = _inputs(fmt)
    want = _bits(jf.value_quantize(jnp.asarray(x), jfmt))
    got = _bits(tf.value_quantize(torch.from_numpy(x), fmt).numpy())
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", FMTS)
def test_encode_bit_exact(name):
    fmt, jfmt = tf.FloatFormat.parse(name), jf.FloatFormat.parse(name)
    x = _inputs(fmt, seed=1)
    want = np.asarray(jf.encode(jnp.asarray(x), jfmt))
    got = tf.encode(torch.from_numpy(x), fmt)
    assert got.dtype == fmt.container_dtype
    np.testing.assert_array_equal(got.numpy(), want)
    # the repack of representable values (quantize=False) too
    vq = np.array(jf.value_quantize(jnp.asarray(x), jfmt))
    np.testing.assert_array_equal(
        tf.encode(torch.from_numpy(vq), fmt, quantize=False).numpy(),
        np.asarray(jf.encode(jnp.asarray(vq), jfmt, quantize=False)))


@pytest.mark.parametrize("name", FMTS)
def test_decode_bit_exact(name):
    """Every code of formats up to 19 bits; random codes plus specials for 32."""
    fmt, jfmt = tf.FloatFormat.parse(name), jf.FloatFormat.parse(name)
    if fmt.bits <= 19:
        codes = np.arange(1 << fmt.bits, dtype=np.uint64)
    else:
        rng = np.random.default_rng(2)
        codes = np.concatenate([rng.integers(0, 1 << 32, 100_000, dtype=np.uint64),
                                np.array([0, 1, 0x7F800000, 0x7F800001, 0xFF800000,
                                          0x80000001, 0x807FFFFF, 0xFFFFFFFF], np.uint64)])
    codes = _np_codes(codes, fmt)
    want = _bits(jf.decode(jnp.asarray(codes), jfmt))
    got = _bits(tf.decode(torch.from_numpy(codes), fmt).numpy())
    np.testing.assert_array_equal(got, want)


_F32_SUBNORMALS = np.array([1e-40, -1e-40, 1e-45, -1e-45, -3e-39, 5e-39, 1.1754942e-38],
                           np.float32)


@pytest.mark.parametrize("name", FMTS)
def test_f32_subnormal_inputs_bit_exact(name):
    """f32-subnormal inputs (ROADMAP C1): XLA on the CPU flushes them in float
    arithmetic.  For every format in the zoo both sides still agree bit for
    bit: E<=7 formats round them to ±0 either way, and the identity format
    passes them through untouched."""
    fmt, jfmt = tf.FloatFormat.parse(name), jf.FloatFormat.parse(name)
    x = _F32_SUBNORMALS
    np.testing.assert_array_equal(
        _bits(tf.value_quantize(torch.from_numpy(x), fmt).numpy()),
        _bits(jf.value_quantize(jnp.asarray(x), jfmt)))
    np.testing.assert_array_equal(tf.encode(torch.from_numpy(x), fmt).numpy(),
                                  np.asarray(jf.encode(jnp.asarray(x), jfmt)))


def test_f32_subnormal_inputs_declared_divergent_for_e8():
    """Declared divergence (ROADMAP C1), proven here: for an E8 format that is
    not the identity (S1E8M7, bf16's layout) the reference's float clip
    flushes f32-subnormal inputs to ±0 on XLA CPU before its add-half trick,
    while the port rounds them on the bits as the reference's own docstring
    intends.  The port matches a numpy bit-level RNE; the reference does not."""
    fmt, jfmt = tf.FloatFormat(8, 7), jf.FloatFormat(8, 7)
    x = _F32_SUBNORMALS
    b = x.view(np.uint32).astype(np.uint64)
    sh = 23 - fmt.mant_bits
    rne = ((b + (1 << (sh - 1)) - 1 + ((b >> sh) & 1)) & ~np.uint64((1 << sh) - 1))
    port = _bits(tf.value_quantize(torch.from_numpy(x), fmt).numpy())
    np.testing.assert_array_equal(port, rne.astype(np.uint32))
    reference = _bits(jf.value_quantize(jnp.asarray(x), jfmt))
    assert (reference != port).any()


@pytest.mark.parametrize("name", FMTS + ["S1E8M7", "S1E2M1"])
def test_format_descriptor_matches(name):
    fmt, jfmt = tf.FloatFormat.parse(name), jf.FloatFormat.parse(name)
    for attr in ("bits", "name", "bias", "max_exp_field", "max_normal", "min_normal",
                 "subnormal_step", "container_bytes_per_value", "is_identity"):
        assert getattr(fmt, attr) == getattr(jfmt, attr), attr
    with pytest.raises(ValueError):
        tf.FloatFormat.parse("E3M7")


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16, torch.uint32])
def test_widen_narrow_roundtrip(dtype):
    """The int64 boundary casts (ROADMAP C2) keep every value, top bit included."""
    top = (1 << (8 * dtype.itemsize)) - 1
    vals = torch.tensor([0, 1, top // 2, top // 2 + 1, top - 1, top], dtype=torch.int64)
    codes = tf.narrow(vals, dtype)
    assert codes.dtype == dtype
    assert torch.equal(tf.widen(codes), vals)
