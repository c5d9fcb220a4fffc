"""SxEyMz minifloat formats and the bitfield codec (port of ``repro.core.formats``).

The paper stores parameters as reduced-bitwidth floating point (sign /
exponent / mantissa), e.g. S1E3M7 (11 bits) or S1E4M14 (19 bits).  This module
holds:

  * ``FloatFormat`` — the format descriptor (parse/format "S1E3M7" strings).
  * ``value_quantize`` — round a float32 tensor to the nearest representable
    value of the format (round-to-nearest-even, subnormal-aware, *saturating*
    at max normal, NaN kept).
  * ``encode`` / ``decode`` — exact conversion between representable float32
    values and the integer bitfield in the smallest uint container.

These functions are also the plain versions behind the CUDA kernels in
``repro_torch.kernels`` (``kernels/ref.py``), so they run on any device.

Integer arithmetic is done in int64 and cast to the container dtype only at
the boundary: PyTorch has no shifts or additions on uint16/uint32, and an
int32 right shift is arithmetic (it would smear the sign bit of a float's
bit pattern).  There is no ``reduce_precision`` either, so round-to-nearest-
even on the mantissa is done on the raw bits (the add-half-and-truncate
trick), which reproduces ``jax.lax.reduce_precision`` on the format's normal
range; the subnormal range uses an exact power-of-two scaled ``round``.
"""

from __future__ import annotations

import dataclasses
import re

import torch

_FMT_RE = re.compile(r"^S1E(\d+)M(\d+)$")
_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class FloatFormat:
    """A 1-sign / `exp_bits`-exponent / `mant_bits`-mantissa float format."""

    exp_bits: int
    mant_bits: int

    def __post_init__(self):
        if not (2 <= self.exp_bits <= 8):
            raise ValueError(f"exp_bits must be in [2, 8], got {self.exp_bits}")
        if not (1 <= self.mant_bits <= 23):
            raise ValueError(f"mant_bits must be in [1, 23], got {self.mant_bits}")

    @property
    def bits(self) -> int:
        return 1 + self.exp_bits + self.mant_bits

    @property
    def name(self) -> str:
        return f"S1E{self.exp_bits}M{self.mant_bits}"

    @classmethod
    def parse(cls, s: str) -> "FloatFormat":
        m = _FMT_RE.match(s.strip().upper())
        if not m:
            raise ValueError(f"bad float format {s!r}; expected e.g. 'S1E3M7'")
        return cls(int(m.group(1)), int(m.group(2)))

    @property
    def bias(self) -> int:
        return (1 << (self.exp_bits - 1)) - 1

    @property
    def max_exp_field(self) -> int:
        """Largest exponent field for a *normal* value (top field = inf/NaN)."""
        return (1 << self.exp_bits) - 2

    @property
    def max_normal(self) -> float:
        return float(
            (2.0 - 2.0 ** (-self.mant_bits)) * 2.0 ** (self.max_exp_field - self.bias)
        )

    @property
    def min_normal(self) -> float:
        return float(2.0 ** (1 - self.bias))

    @property
    def subnormal_step(self) -> float:
        """Spacing of subnormals — the smallest positive representable value."""
        return float(2.0 ** (1 - self.bias - self.mant_bits))

    @property
    def container_dtype(self) -> torch.dtype:
        if self.bits <= 8:
            return torch.uint8
        if self.bits <= 16:
            return torch.uint16
        return torch.uint32

    @property
    def container_bytes_per_value(self) -> int:
        return self.container_dtype.itemsize

    @property
    def is_identity(self) -> bool:
        return self.exp_bits == 8 and self.mant_bits == 23


# Signed twins of the wide unsigned containers: same width, full op support.
SIGNED_TWIN = {torch.uint16: torch.int16, torch.uint32: torch.int32}


def widen(codes: torch.Tensor) -> torch.Tensor:
    """Unsigned integer codes (any container) -> int64 with the same value."""
    if codes.dtype in (torch.uint8, torch.int64):
        return codes.to(torch.int64)
    if codes.dtype not in (torch.uint16, torch.uint32):
        raise TypeError(f"expected unsigned integer codes, got {codes.dtype}")
    mask = (1 << (8 * codes.dtype.itemsize)) - 1
    return codes.view(SIGNED_TWIN[codes.dtype]).to(torch.int64) & mask


def narrow(c: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int64 values in [0, 2**bits) -> the unsigned container ``dtype``."""
    if dtype == torch.uint8:
        return c.to(torch.uint8)
    if dtype not in (torch.uint16, torch.uint32):
        raise TypeError(f"expected an unsigned container dtype, got {dtype}")
    half = 1 << (8 * dtype.itemsize - 1)
    return torch.where(c >= half, c - 2 * half, c).to(SIGNED_TWIN[dtype]).view(dtype)


def _bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> its 32 raw bits as int64 in [0, 2**32)."""
    return x.contiguous().view(torch.int32).to(torch.int64) & _M32


def _from_bits(b: torch.Tensor) -> torch.Tensor:
    """int64 bit patterns in [0, 2**32) -> float32."""
    return torch.where(b >= 1 << 31, b - (1 << 32), b).to(torch.int32).view(torch.float32)


def _rne_mantissa(x: torch.Tensor, mant_bits: int) -> torch.Tensor:
    """Round finite f32 to ``mant_bits`` mantissa bits, ties to even.

    Add-half-and-truncate on the raw bits: uniform over normals and f32
    subnormals.  Callers clip to max_normal first, whose low bits are zero, so
    the carry never reaches the inf exponent.
    """
    sh = 23 - mant_bits
    if sh == 0:
        return x
    b = _bits(x)
    lsb = (b >> sh) & 1
    rb = (b + ((1 << (sh - 1)) - 1) + lsb) & (~((1 << sh) - 1) & _M32)
    return _from_bits(rb)


def value_quantize(x: torch.Tensor, fmt: FloatFormat) -> torch.Tensor:
    """Nearest representable value: RNE, subnormal-aware, saturating. f32->f32."""
    x = x.to(torch.float32)
    if fmt.is_identity:
        return x
    xc = torch.clamp(x, -fmt.max_normal, fmt.max_normal)
    out = _rne_mantissa(xc, fmt.mant_bits)
    if fmt.exp_bits < 8:
        # Target-subnormal range: a multiple of the step, rounded half-to-even.
        # The step is a normal f32 power of two, so the scaling is exact.
        step = fmt.subnormal_step
        sub = torch.round(xc / step) * step
        out = torch.where(xc.abs() < fmt.min_normal, sub, out)
    return torch.where(torch.isnan(x), x, out)


def encode(x: torch.Tensor, fmt: FloatFormat, *, quantize: bool = True) -> torch.Tensor:
    """float32 -> bitfield in the format's container dtype.

    With ``quantize=True`` (default) the input is first rounded with
    ``value_quantize``; with ``quantize=False`` the caller asserts the values
    are already exactly representable (the repack is then exact).
    """
    if quantize:
        x = value_quantize(x, fmt)
    x = x.to(torch.float32)
    y, z = fmt.exp_bits, fmt.mant_bits
    b32 = _bits(x)
    sign = b32 >> 31
    mag = b32 & 0x7FFFFFFF
    e32 = mag >> 23
    ef = e32 - 127 + fmt.bias  # target exponent field (normals: 1..max_exp_field)
    sign_sh = sign << (y + z)
    normal = sign_sh | (ef << z) | ((mag & 0x7FFFFF) >> (23 - z))
    # Subnormal range (ef <= 0): mantissa field = |v| / subnormal_step.
    #   * normal f32 input: exact division (only reached for exp_bits <= 7,
    #     whose step is a normal f32);
    #   * f32-subnormal input (e32 == 0): the field is m32 >> (150-bias-z).
    absx = _from_bits(mag)
    m_sub = torch.round(absx / fmt.subnormal_step)
    m_sub = torch.nan_to_num(m_sub, nan=0.0, posinf=0.0).to(torch.int64)
    m_sub = torch.clamp(m_sub, max=(1 << z) - 1)
    sub_shift = 150 - fmt.bias - z  # >= 0 for every supported format
    m_sub_tiny = mag >> sub_shift if sub_shift < 32 else torch.zeros_like(mag)
    m_sub = torch.where(e32 == 0, m_sub_tiny, m_sub)
    subnormal = sign_sh | m_sub
    max_code = sign_sh | ((fmt.max_exp_field << z) | ((1 << z) - 1))
    nan_code = sign_sh | ((((1 << y) - 1) << z) | (1 << max(z - 1, 0)))

    out = torch.where(ef <= 0, subnormal, normal)
    out = torch.where(ef > fmt.max_exp_field, max_code, out)
    out = torch.where(mag == 0, sign_sh, out)
    out = torch.where(mag > 0x7F800000, nan_code, out)
    return narrow(out, fmt.container_dtype)


def decode(code: torch.Tensor, fmt: FloatFormat) -> torch.Tensor:
    """bitfield -> float32 (exact for every code the format can hold)."""
    y, z = fmt.exp_bits, fmt.mant_bits
    c = widen(code)
    sign = (c >> (y + z)) & 1
    ef = (c >> z) & ((1 << y) - 1)
    m = c & ((1 << z) - 1)
    sign31 = sign << 31
    # Normal path: rebias the exponent, shift the mantissa up — bit assembly.
    nrm = _from_bits((sign31 | ((ef + (127 - fmt.bias)) << 23) | (m << (23 - z))) & _M32)
    if y == 8:
        # E8 subnormals ARE f32 subnormals — assemble the bits directly.
        sub = _from_bits(sign31 | (m << (23 - z)))
    else:
        # The step 2**(1-bias-z) >= 2**-85 is a normal f32: the product is exact.
        sub = m.to(torch.float32) * fmt.subnormal_step
        sub = torch.where(sign == 1, -sub, sub)
    special = _from_bits(torch.where(m == 0, sign31 | 0x7F800000, sign31 | 0x7FC00000))
    signed_zero = _from_bits(sign31)

    out = torch.where(ef == 0, torch.where(m == 0, signed_zero, sub), nrm)
    return torch.where(ef == (1 << y) - 1, special, out)
