// Minifloat codec on the device: the arithmetic of repro_torch/core/formats.py
// (value_quantize, encode, decode) for one f32 value or one code.
//
// Bit-exactness rules (the kernels must agree with the plain versions bit for
// bit): no fast-math (flush-to-zero would drop f32 subnormals), every
// power-of-two scaling is exact, rounding is done on the raw bits or with
// rintf (round half to even), and the PVT affine is written with __fmul_rn /
// __fadd_rn so that it is never contracted into an FMA.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace omc {

// One S1E{y}M{z} format, with the constants the codec needs precomputed on
// the host (see make_format).
struct Format {
  int y;              // exponent bits
  int z;              // mantissa bits
  int bias;           // 2^(y-1) - 1
  int max_exp_field;  // 2^y - 2 (top field = inf/NaN)
  bool identity;      // S1E8M23: value_quantize is the identity
  float max_normal;
  float min_normal;
  float step;      // subnormal step 2^(1-bias-z); a normal f32 when y <= 7
  float inv_step;  // 1/step, exact power of two when y <= 7
};

__host__ __device__ constexpr Format make_format(int exp_bits, int mant_bits) {
  Format f{};
  f.y = exp_bits;
  f.z = mant_bits;
  f.bias = (1 << (exp_bits - 1)) - 1;
  f.max_exp_field = (1 << exp_bits) - 2;
  f.identity = exp_bits == 8 && mant_bits == 23;
  double mx = 2.0 - 1.0 / double(1ull << mant_bits);
  int e = f.max_exp_field - f.bias;
  for (int i = 0; i < e; ++i) mx *= 2.0;
  f.max_normal = float(mx);
  double mn = 1.0, st = 1.0;
  for (int i = 0; i < f.bias - 1; ++i) mn *= 0.5;  // 2^(1-bias)
  st = mn;
  for (int i = 0; i < mant_bits; ++i) st *= 0.5;  // 2^(1-bias-z)
  f.min_normal = float(mn);
  f.step = float(st);
  f.inv_step = exp_bits < 8 ? float(1.0 / st) : 0.0f;
  return f;
}

// Round finite f32 bits to z mantissa bits, ties to even (add half, truncate).
__device__ __forceinline__ uint32_t rne_bits(uint32_t b, int z) {
  const int sh = 23 - z;
  if (sh == 0) return b;
  const uint32_t lsb = (b >> sh) & 1u;
  return (b + ((1u << (sh - 1)) - 1u) + lsb) & ~((1u << sh) - 1u);
}

// Nearest representable value: RNE, subnormal-aware, saturating, NaN kept.
__device__ __forceinline__ float value_quantize(float x, const Format& f) {
  if (f.identity || isnan(x)) return x;
  const float xc = fminf(fmaxf(x, -f.max_normal), f.max_normal);
  if (f.y < 8 && fabsf(xc) < f.min_normal) {
    return rintf(xc * f.inv_step) * f.step;
  }
  return __uint_as_float(rne_bits(__float_as_uint(xc), f.z));
}

// Representable f32 -> bitfield (formats.encode with quantize=False).
__device__ __forceinline__ uint32_t encode_bits(float v, const Format& f) {
  const uint32_t b32 = __float_as_uint(v);
  const uint32_t mag = b32 & 0x7FFFFFFFu;
  const uint32_t sign_sh = (b32 >> 31) << (f.y + f.z);
  const uint32_t mant_mask = (1u << f.z) - 1u;
  if (mag > 0x7F800000u) {  // NaN
    return sign_sh | (((1u << f.y) - 1u) << f.z) | (1u << (f.z - 1));
  }
  if (mag == 0u) return sign_sh;
  const int e32 = int(mag >> 23);
  const int ef = e32 - 127 + f.bias;
  if (ef > f.max_exp_field) {  // saturate (inf included)
    return sign_sh | (uint32_t(f.max_exp_field) << f.z) | mant_mask;
  }
  if (ef <= 0) {  // target subnormal
    uint32_t m_sub;
    if (e32 == 0) {  // f32-subnormal input: shift the mantissa field down
      const int sub_shift = 150 - f.bias - f.z;
      m_sub = sub_shift < 32 ? (mag >> sub_shift) : 0u;
    } else {  // only for y <= 7, where the scaling is exact
      m_sub = min(uint32_t(rintf(__uint_as_float(mag) * f.inv_step)), mant_mask);
    }
    return sign_sh | m_sub;
  }
  return sign_sh | (uint32_t(ef) << f.z) | ((mag & 0x7FFFFFu) >> (23 - f.z));
}

// Bitfield -> f32 (formats.decode), exact for every code.
__device__ __forceinline__ float decode_bits(uint32_t c, const Format& f) {
  const uint32_t sign31 = ((c >> (f.y + f.z)) & 1u) << 31;
  const uint32_t top = (1u << f.y) - 1u;
  const uint32_t ef = (c >> f.z) & top;
  const uint32_t m = c & ((1u << f.z) - 1u);
  if (ef == top) return __uint_as_float(sign31 | (m == 0u ? 0x7F800000u : 0x7FC00000u));
  if (ef == 0u) {
    if (m == 0u) return __uint_as_float(sign31);
    if (f.y == 8) return __uint_as_float(sign31 | (m << (23 - f.z)));
    const float sub = float(m) * f.step;
    return sign31 ? -sub : sub;
  }
  return __uint_as_float(sign31 | ((ef + uint32_t(127 - f.bias)) << 23) | (m << (23 - f.z)));
}

// Most blocks a grid-stride loop launches: 4224, 32 per SM of an H100.
constexpr long long kMaxGrid = 8 * 132 * 4;

// Grid size for a grid-stride loop over `items` work items.
inline unsigned grid_for(long long items, int threads) {
  long long blocks = (items + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxGrid) blocks = kMaxGrid;
  return unsigned(blocks);
}

}  // namespace omc
