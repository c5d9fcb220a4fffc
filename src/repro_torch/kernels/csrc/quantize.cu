// OMC quantize, dequantize and quantize_stats for Hopper (sm_90a).
//
// quantize replaces src/repro/kernels/quantize.py::quantize (the Pallas
// kernel of quantize.py:77): f32 -> minifloat codes, nothing else.
//   Bound: bytes, n*(4 + container_bytes).  Design: a grid-stride
//   elementwise pass; each thread loads a float4 and stores its four codes
//   in one store.  Its codes are quantize_stats' codes, bit for bit: the
//   same value_quantize and encode_bits from minifloat.cuh.
//
// dequantize replaces src/repro/kernels/quantize.py::dequantize (the Pallas
// kernel of quantize.py:93): codes -> f32 with the PVT affine s*x + b fused.
//   Bound: bytes.  It reads n container codes and writes n f32, nothing else,
//   so the least time is n*(container_bytes + 4) / 3.35 TB/s.  Design: a
//   grid-stride elementwise pass over each stacked entry (grid y = entry);
//   each thread loads 16 bytes of codes at once and stores them as float4s;
//   the entry's s and b are read from device memory (one pair for a single
//   variable, one per entry for a stacked [L,1,1] leaf), so no host sync is
//   needed per weight.
//
// quantize_stats replaces src/repro/kernels/quantize.py::quantize_stats (the
// Pallas kernel of quantize.py:116): f32 -> codes plus the four PVT sums
// [sum v, sum q, sum v*q, sum q*q] per stacked entry, in one pass.
//   Bound: bytes, n*(4 + container_bytes).  The TPU kernel carries the sums
//   across a sequential grid; blocks run in no order here, so each block
//   writes its partial sums to a [entries, blocks, 4] scratch and a second
//   small launch reduces each entry's partials in a fixed order.  No float
//   atomics: (s, b) are the same from run to run.
#include "minifloat.cuh"
#include "reduce.cuh"

namespace {

constexpr int kThreads = omc::kReduceThreads;  // block_sum4 assumes this size
constexpr int kStatsItems = 16;  // elements per thread: 4096 per block

__device__ __forceinline__ float affine(float v, float s, float b) {
  return __fadd_rn(__fmul_rn(v, s), b);  // never an FMA: matches v*s + b
}

template <typename T, bool kVec>
__global__ void dequantize_kernel(const T* __restrict__ codes, const float* __restrict__ s_ptr,
                                  const float* __restrict__ b_ptr, float* __restrict__ out,
                                  long long n, omc::Format f) {
  // grid = (blocks, entries); n is the entry's count, codes and out its base
  codes += (long long)blockIdx.y * n;
  out += (long long)blockIdx.y * n;
  const float s = s_ptr[blockIdx.y];
  const float b = b_ptr[blockIdx.y];
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (kVec) {
    constexpr int V = 16 / sizeof(T);  // codes per 16-byte load
    const long long nvec = n / V;
    for (long long i = start; i < nvec; i += stride) {
      const uint4 raw = reinterpret_cast<const uint4*>(codes)[i];
      const T* c = reinterpret_cast<const T*>(&raw);
      float4* o = reinterpret_cast<float4*>(out + i * V);
#pragma unroll
      for (int k = 0; k < V / 4; ++k) {
        float4 r;
        r.x = affine(omc::decode_bits(c[4 * k + 0], f), s, b);
        r.y = affine(omc::decode_bits(c[4 * k + 1], f), s, b);
        r.z = affine(omc::decode_bits(c[4 * k + 2], f), s, b);
        r.w = affine(omc::decode_bits(c[4 * k + 3], f), s, b);
        o[k] = r;
      }
    }
    done = nvec * V;
  }
  for (long long i = done + start; i < n; i += stride) {
    out[i] = affine(omc::decode_bits(codes[i], f), s, b);
  }
}

// Four codes, stored with one instruction.
template <typename T>
struct alignas(4 * sizeof(T)) Codes4 {
  T v[4];
};

template <typename T, bool kVec>
__global__ void quantize_kernel(const float* __restrict__ x, T* __restrict__ codes, long long n,
                                omc::Format f) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (kVec) {
    const long long nvec = n / 4;
    for (long long i = start; i < nvec; i += stride) {
      const float4 v = reinterpret_cast<const float4*>(x)[i];
      Codes4<T> c;
      c.v[0] = T(omc::encode_bits(omc::value_quantize(v.x, f), f));
      c.v[1] = T(omc::encode_bits(omc::value_quantize(v.y, f), f));
      c.v[2] = T(omc::encode_bits(omc::value_quantize(v.z, f), f));
      c.v[3] = T(omc::encode_bits(omc::value_quantize(v.w, f), f));
      reinterpret_cast<Codes4<T>*>(codes)[i] = c;
    }
    done = nvec * 4;
  }
  for (long long i = done + start; i < n; i += stride) {
    codes[i] = T(omc::encode_bits(omc::value_quantize(x[i], f), f));
  }
}

// grid = (blocks per entry, entries); partials is [entries, blocks, 4].
template <typename T>
__global__ void quantize_stats_kernel(const float* __restrict__ x, T* __restrict__ codes,
                                      float* __restrict__ partials, long long n_per_entry,
                                      omc::Format f) {
  const long long base = (long long)blockIdx.y * n_per_entry;
  const long long first = (long long)blockIdx.x * kThreads * kStatsItems + threadIdx.x;
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
  for (int k = 0; k < kStatsItems; ++k) {
    const long long i = first + (long long)k * kThreads;
    if (i < n_per_entry) {
      const float v = x[base + i];
      const float q = omc::value_quantize(v, f);
      codes[base + i] = T(omc::encode_bits(q, f));
      a[0] += v;
      a[1] += q;
      a[2] += v * q;
      a[3] += q * q;
    }
  }
  omc::block_sum4(a);
  if (threadIdx.x == 0) {
    float* p = partials + ((long long)blockIdx.y * gridDim.x + blockIdx.x) * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) p[j] = a[j];
  }
}

template <typename T>
void launch_dequantize(const void* codes, const float* s, const float* b, float* out,
                       long long n, int entries, const omc::Format& f, cudaStream_t stream) {
  // every entry's base stays 16-byte aligned when n is a multiple of 16
  const bool vec = reinterpret_cast<uintptr_t>(codes) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 && (entries == 1 || n % 16 == 0);
  const T* c = static_cast<const T*>(codes);
  const unsigned cap = unsigned((omc::kMaxGrid + entries - 1) / entries);  // per entry
  const unsigned blocks = vec ? omc::grid_for(n / (16 / sizeof(T)), kThreads)
                              : omc::grid_for(n, kThreads);
  const dim3 grid{blocks < cap ? blocks : cap, unsigned(entries)};
  if (vec) {
    dequantize_kernel<T, true><<<grid, kThreads, 0, stream>>>(c, s, b, out, n, f);
  } else {
    dequantize_kernel<T, false><<<grid, kThreads, 0, stream>>>(c, s, b, out, n, f);
  }
}

template <typename T>
void launch_quantize(const float* x, void* codes, long long n, const omc::Format& f,
                     cudaStream_t stream) {
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(codes) % (4 * sizeof(T)) == 0;
  T* c = static_cast<T*>(codes);
  if (vec) {
    quantize_kernel<T, true><<<omc::grid_for(n / 4, kThreads), kThreads, 0, stream>>>(x, c, n, f);
  } else {
    quantize_kernel<T, false><<<omc::grid_for(n, kThreads), kThreads, 0, stream>>>(x, c, n, f);
  }
}

template <typename T>
void launch_quantize_stats(const float* x, void* codes, float* partials, float* sums,
                           long long n_per_entry, int entries, const omc::Format& f,
                           cudaStream_t stream) {
  const long long blocks = (n_per_entry + kThreads * kStatsItems - 1) / (kThreads * kStatsItems);
  const dim3 grid{unsigned(blocks), unsigned(entries)};
  quantize_stats_kernel<T><<<grid, kThreads, 0, stream>>>(x, static_cast<T*>(codes), partials,
                                                          n_per_entry, f);
  omc::reduce_partials_kernel<<<entries, omc::kReduceThreads, 0, stream>>>(partials, sums, blocks);
}

}  // namespace

extern "C" {

const char* omc_error_string(int code) { return cudaGetErrorString(cudaError_t(code)); }

// Number of per-block partial-sum slots quantize_stats needs per entry.
long long omc_quantize_stats_blocks(long long n_per_entry) {
  return (n_per_entry + kThreads * kStatsItems - 1) / (kThreads * kStatsItems);
}

// n values per entry, entries (s, b) pairs.
int omc_dequantize(const void* codes, int container_bytes, const void* s, const void* b,
                   void* out, long long n, int entries, int exp_bits, int mant_bits,
                   void* stream) {
  const omc::Format f = omc::make_format(exp_bits, mant_bits);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(s);
  const float* bp = static_cast<const float*>(b);
  float* o = static_cast<float*>(out);
  if (entries <= 0 || entries > 65535) return int(cudaErrorInvalidValue);
  if (n <= 0) return int(cudaGetLastError());
  switch (container_bytes) {
    case 1: launch_dequantize<uint8_t>(codes, sp, bp, o, n, entries, f, st); break;
    case 2: launch_dequantize<uint16_t>(codes, sp, bp, o, n, entries, f, st); break;
    case 4: launch_dequantize<uint32_t>(codes, sp, bp, o, n, entries, f, st); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

int omc_quantize(const void* x, void* codes, int container_bytes, long long n, int exp_bits,
                 int mant_bits, void* stream) {
  const omc::Format f = omc::make_format(exp_bits, mant_bits);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  if (n <= 0) return int(cudaGetLastError());
  switch (container_bytes) {
    case 1: launch_quantize<uint8_t>(xp, codes, n, f, st); break;
    case 2: launch_quantize<uint16_t>(xp, codes, n, f, st); break;
    case 4: launch_quantize<uint32_t>(xp, codes, n, f, st); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

int omc_quantize_stats(const void* x, void* codes, int container_bytes, void* partials,
                       void* sums, long long n_per_entry, int entries, int exp_bits,
                       int mant_bits, void* stream) {
  const omc::Format f = omc::make_format(exp_bits, mant_bits);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  float* pp = static_cast<float*>(partials);
  float* sp = static_cast<float*>(sums);
  if (n_per_entry <= 0 || entries <= 0 || entries > 65535) return int(cudaErrorInvalidValue);
  switch (container_bytes) {
    case 1: launch_quantize_stats<uint8_t>(xp, codes, pp, sp, n_per_entry, entries, f, st); break;
    case 2: launch_quantize_stats<uint16_t>(xp, codes, pp, sp, n_per_entry, entries, f, st); break;
    case 4: launch_quantize_stats<uint32_t>(xp, codes, pp, sp, n_per_entry, entries, f, st); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

}  // extern "C"
