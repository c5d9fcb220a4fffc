// Branch-free minifloat decode shared by the kernels that read codes in a
// hot loop (dequant_matmul.cu's weight stream and tile, agg.cu's cohort sum).
//
// decode_fast: the code's sign and magnitude bits are placed into an f32 bit
// pattern, sign<<31 | mag<<(23-z), whose value is the minifloat's times
// 2^(bias-127); one exact multiply by 2^(127-bias) gives the value (a
// minifloat subnormal lands on an f32 subnormal first; the build has no
// flush-to-zero, so that is exact too), and a select gives inf/NaN for the
// top exponent field.  Equal to omc::decode_bits for every code.  With Y != 0
// the format S1E{Y}M{Z} is compiled in, so its masks and shifts fold into
// constants, and decode_vec decodes u16 codes two at a time from 32-bit words
// (decode_pair, inf/NaN checked once per 16-byte vector).
#pragma once

#include "minifloat.cuh"

namespace omc {

// Y == 0: the format is read from f at run time; else S1E{Y}M{Z} is fixed.
template <int Y, int Z>
__device__ __forceinline__ float decode_fast(uint32_t c, const omc::Format& f) {
  const int y = Y ? Y : f.y, z = Y ? Z : f.z;
  const int bias = (1 << (y - 1)) - 1;
  const uint32_t mag_mask = (1u << (y + z)) - 1u;
  const uint32_t top = ((1u << y) - 1u) << z;  // first inf/NaN magnitude
  const float scale = __uint_as_float(uint32_t(254 - bias) << 23);  // 2^(127-bias)
  const uint32_t sign = (c << (31 - y - z)) & 0x80000000u;
  const uint32_t mag = c & mag_mask;
  const float v = __fmul_rn(__uint_as_float(sign | (mag << (23 - z))), scale);
  const uint32_t special = sign | (mag == top ? 0x7F800000u : 0x7FC00000u);
  return mag >= top ? __uint_as_float(special) : v;
}

// x << S for S >= 0, x >> -S for S < 0.
template <int S>
__device__ __forceinline__ uint32_t shift(uint32_t x) {
  if constexpr (S >= 0) {
    return x << S;
  } else {
    return x >> -S;
  }
}

// The two u16 codes of a 32-bit word of a compile-time format, decoded as
// decode_fast does, but with the fields moved in place for both codes at once
// (the high code's magnitude is already near its f32 place).  Inf/NaN codes
// are left to the caller (special_pairs).
template <int Y, int Z>
__device__ __forceinline__ void decode_pair(uint32_t w, float& lo, float& hi) {
  constexpr int kBias = (1 << (Y - 1)) - 1;
  constexpr uint32_t kMag = (1u << (Y + Z)) - 1u;
  const float scale = __uint_as_float(uint32_t(254 - kBias) << 23);
  const uint32_t b0 = (shift<31 - Y - Z>(w) & 0x80000000u) | ((w & kMag) << (23 - Z));
  const uint32_t b1 = (shift<15 - Y - Z>(w) & 0x80000000u) | shift<7 - Z>(w & (kMag << 16));
  lo = __fmul_rn(__uint_as_float(b0), scale);
  hi = __fmul_rn(__uint_as_float(b1), scale);
}

// Nonzero where a u16 code of the word has the top (inf/NaN) exponent field:
// the field plus one carries into the sign bit's place, in both halves.
template <int Y, int Z>
__device__ __forceinline__ uint32_t special_pairs(uint32_t w) {
  constexpr uint32_t kTop = ((1u << Y) - 1u) << Z;
  const uint32_t t = w & (kTop | kTop << 16);
  return (t + ((1u << Z) | (1u << (Z + 16)))) & ((1u << (Y + Z)) | (1u << (Y + Z + 16)));
}

// The first V codes of a 16-byte vector, decoded (all of them, or 8 u8 codes).
template <typename T, int V, int Y, int Z>
__device__ __forceinline__ void decode_vec(float (&wv)[V], const uint4& raw,
                                           const omc::Format& f) {
  const T* c = reinterpret_cast<const T*>(&raw);
  if constexpr (Y != 0 && sizeof(T) == 2) {  // a compile-time u16 format
    const uint32_t* w = reinterpret_cast<const uint32_t*>(&raw);
#pragma unroll
    for (int q = 0; q < V / 2; ++q) decode_pair<Y, Z>(w[q], wv[2 * q], wv[2 * q + 1]);
    if (special_pairs<Y, Z>(w[0]) | special_pairs<Y, Z>(w[1]) | special_pairs<Y, Z>(w[2]) |
        special_pairs<Y, Z>(w[3])) {
#pragma unroll
      for (int j = 0; j < V; ++j) wv[j] = decode_fast<Y, Z>(uint32_t(c[j]), f);
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) wv[j] = decode_fast<Y, Z>(uint32_t(c[j]), f);
  }
}

}  // namespace omc
