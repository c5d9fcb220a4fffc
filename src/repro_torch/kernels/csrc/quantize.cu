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
//   so the least time is n*(container_bytes + 4) / 3.35 TB/s: for u16 codes
//   about 558 G codes/s, some 2 codes per SM clock, which leaves each code a
//   few dozen thread-instructions, index math and affine included.
//   Design: one flat index space over entries x n, cut into 16-byte vectors
//   of codes (a stacked leaf has n a multiple of 16, so no vector straddles
//   two entries, and a vector's entry is one division; 32-bit indices where
//   the count allows).  The grid is sized to the work, one vector a thread
//   (kVecsInFlight), so a 17-entry leaf and a flat one fill the card alike
//   and blocks, issued in order, walk the codes front to back: on an H100
//   this reached 83-89% of the byte bound where a grid sized by the
//   occupancy API to fill the SMs once, each thread striding, reached
//   65-71%, and 2 or 4 vectors a thread, streaming loads (ld.global.cs) and
//   evict-first stores (st.global.cs) gained nothing
//   (benchmarks_torch/bench_dequantize.py).  The decode is decode.cuh's,
//   branch-free: S1E3M7 (u16; serve, engine, async) compiled in, two codes a
//   32-bit word, inf/NaN checked once a vector; S1E4M14 (u32; the training
//   driver) compiled in; any other format read at run time (variant below;
//   quantize.kernel_variant states the same rule).  (s, b) are read from
//   device memory, one pair per entry, so no host sync is needed per weight.
//   Unaligned or odd-sized stacks take a scalar grid-stride pass.
//
// quantize_stats replaces src/repro/kernels/quantize.py::quantize_stats (the
// Pallas kernel of quantize.py:116): f32 -> codes plus the four PVT sums
// [sum v, sum q, sum v*q, sum q*q] per stacked entry, in one pass.
//   Bound: bytes, n*(4 + container_bytes).  The TPU kernel carries the sums
//   across a sequential grid; blocks run in no order here, so each block
//   writes its partial sums to a [entries, blocks, 4] scratch and a second
//   small launch reduces each entry's partials in a fixed order.  No float
//   atomics: (s, b) are the same from run to run.
#include "decode.cuh"
#include "minifloat.cuh"
#include "reduce.cuh"

namespace {

constexpr int kThreads = omc::kReduceThreads;  // block_sum4 assumes this size
constexpr int kStatsItems = 16;  // elements per thread: 4096 per block

__device__ __forceinline__ float affine(float v, float s, float b) {
  return __fadd_rn(__fmul_rn(v, s), b);  // never an FMA: matches v*s + b
}

constexpr int kDecodeRuntime = 0, kDecodeS1E3M7 = 1, kDecodeS1E4M14 = 2;
constexpr int kDqThreads = 256;  // dequantize's block
constexpr int kVecsInFlight = 1;  // 16-byte code vectors a thread loads before it decodes
constexpr long long kMaxBlocks = (1LL << 31) - 1;  // grid x; beyond it, threads stride

// The decode a format gets; quantize.kernel_variant states the same rule.
int dequantize_variant(int container_bytes, int exp_bits, int mant_bits) {
  if (container_bytes == 2 && exp_bits == 3 && mant_bits == 7) return kDecodeS1E3M7;
  if (container_bytes == 4 && exp_bits == 4 && mant_bits == 14) return kDecodeS1E4M14;
  return kDecodeRuntime;
}

// nvec 16-byte vectors over all entries, vpe of them an entry (entries > 1),
// then `tail` codes of a single entry past its last whole vector.  A block
// takes kVecsInFlight * kDqThreads consecutive vectors, each thread one in
// kDqThreads, all loaded before any is decoded.
template <typename T, int Y, int Z, typename I>
__global__ void __launch_bounds__(kDqThreads)
    dequantize_vec_kernel(const uint4* __restrict__ codes, const float* __restrict__ s_ptr,
                          const float* __restrict__ b_ptr, float* __restrict__ out, I nvec,
                          I vpe, int entries, int tail, omc::Format f) {
  constexpr int V = 16 / sizeof(T);  // codes a vector
  constexpr I kChunk = I(kDqThreads) * kVecsInFlight;
  const I step = I(gridDim.x) * kChunk;
  float4* const out4 = reinterpret_cast<float4*>(out);
  for (I base = I(blockIdx.x) * kChunk + threadIdx.x; base < nvec; base += step) {
    uint4 raw[kVecsInFlight];
#pragma unroll
    for (int k = 0; k < kVecsInFlight; ++k) {
      const I i = base + I(k) * kDqThreads;
      if (i < nvec) raw[k] = __ldg(codes + i);
    }
#pragma unroll
    for (int k = 0; k < kVecsInFlight; ++k) {
      const I i = base + I(k) * kDqThreads;
      if (i < nvec) {
        const I e = entries == 1 ? I(0) : i / vpe;
        const float s = __ldg(s_ptr + e), b = __ldg(b_ptr + e);
        float v[V];
        omc::decode_vec<T, V, Y, Z>(v, raw[k], f);
        float4* o = out4 + size_t(i) * (V / 4);
#pragma unroll
        for (int q = 0; q < V / 4; ++q) {
          o[q] = make_float4(affine(v[4 * q], s, b), affine(v[4 * q + 1], s, b),
                             affine(v[4 * q + 2], s, b), affine(v[4 * q + 3], s, b));
        }
      }
    }
  }
  if (blockIdx.x == 0 && int(threadIdx.x) < tail) {
    const size_t j = size_t(nvec) * V + threadIdx.x;
    out[j] = affine(omc::decode_fast<Y, Z>(uint32_t(reinterpret_cast<const T*>(codes)[j]), f),
                    s_ptr[0], b_ptr[0]);
  }
}

// One code a thread and step: total codes, n of them an entry.
template <typename T, int Y, int Z, typename I>
__global__ void __launch_bounds__(kDqThreads)
    dequantize_scalar_kernel(const T* __restrict__ codes, const float* __restrict__ s_ptr,
                             const float* __restrict__ b_ptr, float* __restrict__ out, I total,
                             I n, int entries, omc::Format f) {
  const I step = I(gridDim.x) * kDqThreads;
  for (I j = I(blockIdx.x) * kDqThreads + threadIdx.x; j < total; j += step) {
    const I e = entries == 1 ? I(0) : j / n;
    out[j] = affine(omc::decode_fast<Y, Z>(uint32_t(codes[j]), f), __ldg(s_ptr + e),
                    __ldg(b_ptr + e));
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

// A dequantize launch: plan[4] = {variant, 16-byte vectors (1) or scalars
// (0), 32-bit indices (1), blocks}.
struct DequantizePlan {
  int variant;
  bool vec;
  bool idx32;
  long long blocks;
};

template <typename T, int Y, int Z>
DequantizePlan plan_dequantize(const void* codes, const void* out, long long n, int entries,
                               int variant) {
  DequantizePlan p{};
  p.variant = variant;
  const long long total = n * entries;
  // every entry's base stays 16-byte aligned when n is a multiple of 16
  p.vec = reinterpret_cast<uintptr_t>(codes) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(out) % 16 == 0 && (entries == 1 || n % 16 == 0);
  const long long items = p.vec ? total / (16 / sizeof(T)) : total;
  // one chunk a thread: blocks in launch order walk the codes front to back
  const long long per_block = p.vec ? (long long)kDqThreads * kVecsInFlight : kDqThreads;
  const long long need = (items + per_block - 1) / per_block;
  p.blocks = need < 1 ? 1 : (need < kMaxBlocks ? need : kMaxBlocks);
  // with the whole grid, indices (and one stride past them) stay below
  // 2 * (items + per_block): 32 bits hold them
  p.idx32 = items + per_block < (1LL << 31) && need <= kMaxBlocks;
  return p;
}

template <typename T, int Y, int Z, typename I>
void launch_dequantize_as(const void* codes, const float* s, const float* b, float* out,
                          long long n, int entries, const omc::Format& f,
                          const DequantizePlan& p, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const long long total = n * entries;
  const unsigned grid = unsigned(p.blocks);
  if (p.vec) {
    dequantize_vec_kernel<T, Y, Z, I><<<grid, kDqThreads, 0, stream>>>(
        static_cast<const uint4*>(codes), s, b, out, I(total / V), I(n / V), entries,
        int(total % V), f);
  } else {
    dequantize_scalar_kernel<T, Y, Z, I><<<grid, kDqThreads, 0, stream>>>(
        static_cast<const T*>(codes), s, b, out, I(total), I(n), entries, f);
  }
}

// Plans (plan != nullptr: fills it, launches nothing) or launches.
template <typename T, int Y, int Z>
void run_dequantize(const void* codes, const float* s, const float* b, float* out, long long n,
                    int entries, const omc::Format& f, int variant, long long* plan,
                    cudaStream_t stream) {
  const DequantizePlan p = plan_dequantize<T, Y, Z>(codes, out, n, entries, variant);
  if (plan != nullptr) {
    plan[0] = p.variant;
    plan[1] = p.vec;
    plan[2] = p.idx32;
    plan[3] = p.blocks;
  } else if (p.idx32) {
    launch_dequantize_as<T, Y, Z, uint32_t>(codes, s, b, out, n, entries, f, p, stream);
  } else {
    launch_dequantize_as<T, Y, Z, unsigned long long>(codes, s, b, out, n, entries, f, p,
                                                      stream);
  }
}

int dispatch_dequantize(const void* codes, int container_bytes, const float* s, const float* b,
                        float* out, long long n, int entries, int exp_bits, int mant_bits,
                        long long* plan, cudaStream_t stream) {
  if (n <= 0 || entries <= 0 || entries > 65535 || exp_bits < 2 || exp_bits > 8 ||
      mant_bits < 1 || mant_bits > 23 || 1 + exp_bits + mant_bits > 8 * container_bytes) {
    return int(cudaErrorInvalidValue);
  }
  const omc::Format f = omc::make_format(exp_bits, mant_bits);
  const int v = dequantize_variant(container_bytes, exp_bits, mant_bits);
  if (v == kDecodeS1E3M7) {
    run_dequantize<uint16_t, 3, 7>(codes, s, b, out, n, entries, f, v, plan, stream);
  } else if (v == kDecodeS1E4M14) {
    run_dequantize<uint32_t, 4, 14>(codes, s, b, out, n, entries, f, v, plan, stream);
  } else {
    switch (container_bytes) {
      case 1: run_dequantize<uint8_t, 0, 0>(codes, s, b, out, n, entries, f, v, plan, stream); break;
      case 2: run_dequantize<uint16_t, 0, 0>(codes, s, b, out, n, entries, f, v, plan, stream); break;
      case 4: run_dequantize<uint32_t, 0, 0>(codes, s, b, out, n, entries, f, v, plan, stream); break;
      default: return int(cudaErrorInvalidValue);
    }
  }
  return plan != nullptr ? 0 : int(cudaGetLastError());
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
  if (n == 0 && entries > 0 && entries <= 65535) return int(cudaGetLastError());
  return dispatch_dequantize(codes, container_bytes, static_cast<const float*>(s),
                             static_cast<const float*>(b), static_cast<float*>(out), n, entries,
                             exp_bits, mant_bits, nullptr, static_cast<cudaStream_t>(stream));
}

// The launch omc_dequantize would make for these pointers and sizes (see
// DequantizePlan), in plan[4]; launches nothing.
int omc_dequantize_plan(const void* codes, void* out, long long n, int entries,
                        int container_bytes, int exp_bits, int mant_bits, long long* plan) {
  return dispatch_dequantize(codes, container_bytes, nullptr, nullptr, static_cast<float*>(out),
                             n, entries, exp_bits, mant_bits, plan, nullptr);
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
