// Fused compressed-domain cohort aggregation for Hopper (sm_90a).
//
// fused_aggregate replaces src/repro/kernels/agg.py::fused_aggregate (the
// Pallas kernel of agg.py:114).  For one variable of `entries` stacked
// entries of m elements, with C client uploads in transport form:
//
//   x_c  = decode(cl_c) * s_c + b_c          per client, unfused affine
//   x_c  = w_c > 0 ? x_c : 0                 dead rows zeroed BEFORE the mean
//   mean = (sum_c x_c * w_c) / max(sum_c w_c, 1e-9)
//   new  = old + lr * (mean - old)           old = decode(srv) * s + b
//   out  = encode(value_quantize(new))       round to nearest even
//   sums[e] = [sum new, sum q, sum new*q, sum q*q] over entry e
//
// (s, b) are solved from the [entries, 4] sums on the host side in torch
// (core.pvt.pvt_from_sums), the closed form the reference solves outside
// its kernel too (agg.py:86-95).
//
// Bound: bytes.  It reads C + 1 code planes and writes one, plus a few
// scalars: (C + 2) * n * container_bytes; for conformer_s' [17, 512, 2048]
// leaves at C = 8 in u16, 356.5 MB, 0.106 ms at 3.35 TB/s.  A dead client's
// plane is never read (its contribution is the constant 0 * w_c), so a
// cohort with dead clients needs fewer bytes.  The f32 intermediates never
// leave registers.
//
// Design.  The TPU kernel tiles each entry in 1024-lane blocks and carries
// the sums across a sequential grid.  Here the grid is (blocks per entry,
// entries), grid-stride within the entry: each thread takes 16 bytes of
// codes at a time (8 u16 elements) from each live client plane, in client
// order, keeps the running sums in registers and writes 16 bytes of new
// codes; a scalar path takes entries whose size or alignment does not allow
// that.  The per-client (w_c, s_c, b_c) of the block's entry are copied from
// device memory into shared memory once per block: no host sync.  What an
// (element, client) pair costs is cut by one of three variants, chosen by
// the C entry from (format, C) alone (variant):
//   * kDecodeS1E3M7: the trained format compiled in.  The client codes go
//     through decode.cuh's branch-free pair decode (two u16 codes a 32-bit
//     word) and the server half (decode, value_quantize, encode) folds its
//     format into constants;
//   * kTable: formats of at most kTableMaxBits bits whose C tables fit in
//     kTableBytes: each block first builds, in shared memory, one table a
//     client, t_c[code] = (w_c > 0 ? decode(code) * s_c + b_c : 0) * w_c,
//     with the same rounded operations, so the inner loop is one shared
//     load and one add.  Blocks are sized so that the build is at most a
//     twentieth of a block's work (plan_for);
//   * kDecodeRuntime: every other format, decode.cuh's branch-free decode
//     with the format read at run time.
// Every operation that reaches a code is written with __fmul_rn / __fadd_rn
// / __fsub_rn / __fdiv_rn, in the plain version's order (kernels/ref.py), so
// the codes are the plain version's bit for bit in every variant.
//
// One launch: each block writes its [4] partial sums, and the last block of
// an entry to finish (a fenced atomicInc ticket, which wraps back to 0 for
// the next launch) sums the entry's partials in index order, as
// reduce.cuh's reduce_partials_kernel does.  No float atomics: the sums are
// the same bits from launch to launch, whichever block finishes last.
#include <type_traits>

#include "decode.cuh"
#include "minifloat.cuh"
#include "reduce.cuh"

namespace {

constexpr int kThreads = omc::kReduceThreads;  // block_sum4 assumes this size
constexpr int kMaxClients = 4096;              // 3 floats each in shared memory: 48 KB
constexpr int kClientBatch = 4;                // client planes loaded before they are used
constexpr int kMinIters = 4;                   // items a thread takes, where m allows
constexpr int kFillBlocks = 132 * 8;           // blocks a launch has at least, where m allows
constexpr int kTableMaxBits = 12;
constexpr int kTableBytes = 96 * 1024;  // all of a block's tables: two blocks an SM
constexpr int kBuildShare = 20;         // a block's work >= 20x its table build
constexpr int kMaxSmem = 3 * kMaxClients * 4 + kTableBytes;

constexpr int kDecodeRuntime = 0, kDecodeS1E3M7 = 1, kTable = 2;

// The variant for a format and a cohort of `clients`; agg.kernel_variant
// states the same rule.
int variant(int container_bytes, int exp_bits, int mant_bits, int clients) {
  if (container_bytes == 2 && exp_bits == 3 && mant_bits == 7) return kDecodeS1E3M7;
  const int bits = 1 + exp_bits + mant_bits;
  if (bits <= kTableMaxBits && (long long)(clients << bits) * 4 <= kTableBytes) return kTable;
  return kDecodeRuntime;
}

// The format as the kernel sees it: folded into constants when compiled in.
template <int Y, int Z>
__device__ __forceinline__ omc::Format format_of(const omc::Format& f) {
  if constexpr (Y != 0) {
    constexpr omc::Format kF = omc::make_format(Y, Z);
    return kF;
  } else {
    return f;
  }
}

__device__ __forceinline__ float affine(float v, float s, float b) {
  return __fadd_rn(__fmul_rn(v, s), b);  // never an FMA: matches v*s + b
}

// V codes: one 16-byte vector, or one code.
template <typename T, int V>
using Raw = std::conditional_t<V == 1, T, uint4>;

template <typename T, int V>
__device__ __forceinline__ uint32_t code_at(const Raw<T, V>& raw, int k) {
  if constexpr (V == 1) {
    return uint32_t(raw);
  } else {
    return uint32_t(reinterpret_cast<const T*>(&raw)[k]);
  }
}

template <typename T, int V, int Y, int Z>
__device__ __forceinline__ void decode_codes(float (&x)[V], const Raw<T, V>& raw,
                                             const omc::Format& f) {
  if constexpr (V == 1) {
    x[0] = omc::decode_fast<Y, Z>(uint32_t(raw), f);
  } else {
    omc::decode_vec<T, V, Y, Z>(x, raw, f);
  }
}

// The server half of one element: new value, its code, and the PVT sums.
template <typename T>
__device__ __forceinline__ T finish(float acc, float wsum, float old, float lr,
                                    const omc::Format& f, float a[4]) {
  const float mean = __fdiv_rn(acc, wsum);
  const float v = __fadd_rn(old, __fmul_rn(lr, __fsub_rn(mean, old)));
  const float q = omc::value_quantize(v, f);
  a[0] += v;
  a[1] += q;
  a[2] += v * q;
  a[3] += q * q;
  return T(omc::encode_bits(q, f));
}

// grid = (blocks per entry, entries), block = kThreads, dynamic shared memory
// 3 * clients floats (+ clients << bits for kTab).  srv, out: [entries, m];
// cl: [clients, entries, m]; srv_s, srv_b: [entries]; cl_s, cl_b: [clients,
// entries]; w: [clients]; partials: [entries, blocks, 4]; sums: [entries, 4];
// tickets: [entries], zero between launches.  V > 1: 16 bytes of codes a
// load, which the caller allows only for 16-byte aligned planes and m a
// multiple of V.  Y != 0: S1E{Y}M{Z} compiled in.
template <typename T, int V, int Y, int Z, bool kTab>
__global__ void __launch_bounds__(kThreads) fused_aggregate_kernel(
    const T* __restrict__ srv, const float* __restrict__ srv_s, const float* __restrict__ srv_b,
    const T* __restrict__ cl, const float* __restrict__ cl_s, const float* __restrict__ cl_b,
    const float* __restrict__ w, int clients, float lr, T* __restrict__ out,
    float* __restrict__ partials, float* __restrict__ sums, unsigned* __restrict__ tickets,
    long long m, omc::Format fr) {
  extern __shared__ float smem[];
  float* sw = smem;  // w[C], s[C], b[C] of this entry, then the tables
  float* ss = smem + clients;
  float* sb = smem + 2 * clients;
  float* tab = smem + 3 * clients;
  __shared__ float s_wsum;
  __shared__ bool s_last;
  const omc::Format f = format_of<Y, Z>(fr);
  const int e = blockIdx.y;
  const int entries = gridDim.y;
  for (int c = threadIdx.x; c < clients; c += kThreads) {
    sw[c] = w[c];
    ss[c] = cl_s[(long long)c * entries + e];
    sb[c] = cl_b[(long long)c * entries + e];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ws = 0.0f;
    for (int c = 0; c < clients; ++c) ws = __fadd_rn(ws, sw[c]);
    s_wsum = fmaxf(ws, 1e-9f);
  }
  if constexpr (kTab) {
    const int bits = 1 + f.y + f.z;
    const int size = clients << bits;
    for (int i = threadIdx.x; i < size; i += kThreads) {
      const int c = i >> bits;
      const float wc = sw[c];
      const float x = wc > 0.0f ? affine(omc::decode_bits(uint32_t(i) & ((1u << bits) - 1u), f),
                                         ss[c], sb[c])
                                : 0.0f;  // where, not a multiply: NaN in a dead row stays out
      tab[i] = __fmul_rn(x, wc);
    }
  }
  __syncthreads();
  const float wsum = s_wsum;
  const float s_old = srv_s[e];
  const float b_old = srv_b[e];

  const long long plane = (long long)entries * m;  // one client's codes
  const T* cl_e = cl + (long long)e * m;
  const T* srv_e = srv + (long long)e * m;
  T* out_e = out + (long long)e * m;
  const long long items = m / V;
  const long long stride = (long long)gridDim.x * kThreads;
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (long long j = (long long)blockIdx.x * kThreads + threadIdx.x; j < items; j += stride) {
    const Raw<T, V> sraw = *reinterpret_cast<const Raw<T, V>*>(srv_e + j * V);
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.0f;
    const T* p = cl_e + j * V;
    for (int c0 = 0; c0 < clients; c0 += kClientBatch) {
      Raw<T, V> raw[kClientBatch];
#pragma unroll
      for (int i = 0; i < kClientBatch; ++i) {
        const int c = c0 + i;
        if (c < clients && sw[c] > 0.0f) {
          raw[i] = *reinterpret_cast<const Raw<T, V>*>(p + c * plane);
        }
      }
#pragma unroll
      for (int i = 0; i < kClientBatch; ++i) {
        const int c = c0 + i;
        if (c >= clients) break;
        const float wc = sw[c];
        if (!(wc > 0.0f)) {  // dead: the plain version adds 0 * w_c
          const float z = __fmul_rn(0.0f, wc);
#pragma unroll
          for (int k = 0; k < V; ++k) acc[k] = __fadd_rn(acc[k], z);
        } else if constexpr (kTab) {
          const float* t = tab + (c << (1 + f.y + f.z));
#pragma unroll
          for (int k = 0; k < V; ++k) acc[k] = __fadd_rn(acc[k], t[code_at<T, V>(raw[i], k)]);
        } else {
          float x[V];
          decode_codes<T, V, Y, Z>(x, raw[i], f);
          const float s = ss[c], b = sb[c];
#pragma unroll
          for (int k = 0; k < V; ++k) {
            acc[k] = __fadd_rn(acc[k], __fmul_rn(affine(x[k], s, b), wc));
          }
        }
      }
    }
    float old[V];
    decode_codes<T, V, Y, Z>(old, sraw, f);
    Raw<T, V> oraw;
    if constexpr (V == 1) {
      oraw = finish<T>(acc[0], wsum, affine(old[0], s_old, b_old), lr, f, a);
    } else {
      T* ocode = reinterpret_cast<T*>(&oraw);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        ocode[k] = finish<T>(acc[k], wsum, affine(old[k], s_old, b_old), lr, f, a);
      }
    }
    *reinterpret_cast<Raw<T, V>*>(out_e + j * V) = oraw;
  }

  // this block's partial sums; the entry's last block sums them all
  omc::block_sum4(a);
  float* mine = partials + ((long long)e * gridDim.x + blockIdx.x) * 4;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) mine[i] = a[i];
    __threadfence();
    s_last = atomicInc(&tickets[e], gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float* pe = partials + (long long)e * gridDim.x * 4;
  float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (unsigned i = threadIdx.x; i < gridDim.x; i += kThreads) {
#pragma unroll
    for (int k = 0; k < 4; ++k) t[k] += __ldcg(pe + i * 4 + k);
  }
  omc::block_sum4(t);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) sums[e * 4 + k] = t[k];
  }
}

struct Plan {
  long long blocks;  // per entry
  int variant;
  bool vec;
  int smem;  // dynamic shared memory, bytes
};

// Blocks per entry: kMinIters items a thread where m allows, at least
// kFillBlocks in all, at least one item a thread; with tables, few enough
// that each block's elements amortise its build (kBuildShare).
Plan plan_for(const void* srv, const void* cl, const void* out, long long m, int entries,
              int clients, int container_bytes, int exp_bits, int mant_bits) {
  Plan p;
  p.variant = variant(container_bytes, exp_bits, mant_bits, clients);
  const int v = 16 / container_bytes;
  const auto aligned = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  p.vec = m % v == 0 && aligned(srv) && aligned(cl) && aligned(out);
  const long long items = p.vec ? m / v : m;
  long long want = (items + kThreads * kMinIters - 1) / (kThreads * kMinIters);
  const long long fill = (kFillBlocks + entries - 1) / entries;
  const long long most = (items + kThreads - 1) / kThreads;
  want = want > fill ? want : fill;
  want = want < most ? want : most;
  const int bits = 1 + exp_bits + mant_bits;
  p.smem = 3 * clients * 4;
  if (p.variant == kTable) {
    // build: about 15 operations a table entry; use: about 3 a client and
    // 40 for the server half, an element
    const long long build = 15LL * (clients << bits);
    const long long min_elems = kBuildShare * build / (3LL * clients + 40);
    const long long cap = m / (min_elems > 1 ? min_elems : 1);
    want = want < cap ? want : cap;
    p.smem += (clients << bits) * 4;
  }
  p.blocks = want < 1 ? 1 : want;
  return p;
}

template <typename T, int V, int Y, int Z, bool kTab>
cudaError_t launch_one(const T* srv, const float* srv_s, const float* srv_b, const T* cl,
                       const float* cl_s, const float* cl_b, const float* w, int clients,
                       float lr, T* out, float* partials, float* sums, unsigned* tickets,
                       long long m, int entries, const omc::Format& f, const Plan& p,
                       cudaStream_t stream) {
  static bool raised[64] = {};
  const auto kernel = fused_aggregate_kernel<T, V, Y, Z, kTab>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !raised[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    if (dev < 64) raised[dev] = true;
  }
  const dim3 grid{unsigned(p.blocks), unsigned(entries)};
  kernel<<<grid, kThreads, size_t(p.smem), stream>>>(srv, srv_s, srv_b, cl, cl_s, cl_b, w,
                                                     clients, lr, out, partials, sums, tickets,
                                                     m, f);
  return cudaGetLastError();
}

template <typename T, int Y, int Z>
cudaError_t launch(const void* srv, const float* srv_s, const float* srv_b, const void* cl,
                   const float* cl_s, const float* cl_b, const float* w, int clients, float lr,
                   void* out, float* partials, float* sums, unsigned* tickets, long long m,
                   int entries, const omc::Format& f, const Plan& p, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const T* s = static_cast<const T*>(srv);
  const T* c = static_cast<const T*>(cl);
  T* o = static_cast<T*>(out);
#define OMC_AGG_LAUNCH(VV, TAB)                                                                \
  launch_one<T, VV, Y, Z, TAB>(s, srv_s, srv_b, c, cl_s, cl_b, w, clients, lr, o, partials, \
                               sums, tickets, m, entries, f, p, stream)
  if constexpr (Y == 0 && sizeof(T) <= 2) {
    if (p.variant == kTable) return p.vec ? OMC_AGG_LAUNCH(V, true) : OMC_AGG_LAUNCH(1, true);
  }
  return p.vec ? OMC_AGG_LAUNCH(V, false) : OMC_AGG_LAUNCH(1, false);
#undef OMC_AGG_LAUNCH
}

}  // namespace

extern "C" {

// The launch's plan: plan[4] = {blocks per entry, variant (0 decode at run
// time, 1 S1E3M7 compiled in, 2 tables), 16-byte vectors (1) or scalars (0),
// dynamic shared memory in bytes}.
int omc_fused_aggregate_plan(const void* srv, const void* cl, const void* out, long long m,
                             int entries, int clients, int container_bytes, int exp_bits,
                             int mant_bits, long long* plan) {
  if (m <= 0 || entries <= 0 || entries > 65535 || clients < 1 || clients > kMaxClients ||
      (container_bytes != 1 && container_bytes != 2 && container_bytes != 4)) {
    return int(cudaErrorInvalidValue);
  }
  const Plan p = plan_for(srv, cl, out, m, entries, clients, container_bytes, exp_bits,
                          mant_bits);
  plan[0] = p.blocks;
  plan[1] = p.variant;
  plan[2] = p.vec;
  plan[3] = p.smem;
  return 0;
}

// partials: [entries, blocks per entry (the plan's), 4] scratch; tickets:
// [entries] zeros, left zero by the launch.
int omc_fused_aggregate(const void* srv, const void* srv_s, const void* srv_b, const void* cl,
                        const void* cl_s, const void* cl_b, const void* w, int clients,
                        float lr, void* out, int container_bytes, void* partials, void* sums,
                        void* tickets, long long m, int entries, int exp_bits, int mant_bits,
                        void* stream) {
  if (m <= 0 || entries <= 0 || entries > 65535 || clients < 1 || clients > kMaxClients ||
      exp_bits < 2 || exp_bits > 8 || mant_bits < 1 || mant_bits > 23 ||
      1 + exp_bits + mant_bits > 8 * container_bytes) {
    return int(cudaErrorInvalidValue);
  }
  const omc::Format f = omc::make_format(exp_bits, mant_bits);
  const Plan p = plan_for(srv, cl, out, m, entries, clients, container_bytes, exp_bits,
                          mant_bits);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto F = [](const void* q) { return static_cast<const float*>(q); };
  float* pp = static_cast<float*>(partials);
  float* sp = static_cast<float*>(sums);
  unsigned* tp = static_cast<unsigned*>(tickets);
  cudaError_t err = cudaErrorInvalidValue;
  if (p.variant == kDecodeS1E3M7) {
    err = launch<uint16_t, 3, 7>(srv, F(srv_s), F(srv_b), cl, F(cl_s), F(cl_b), F(w), clients,
                                 lr, out, pp, sp, tp, m, entries, f, p, st);
  } else {
    switch (container_bytes) {
      case 1:
        err = launch<uint8_t, 0, 0>(srv, F(srv_s), F(srv_b), cl, F(cl_s), F(cl_b), F(w),
                                    clients, lr, out, pp, sp, tp, m, entries, f, p, st);
        break;
      case 2:
        err = launch<uint16_t, 0, 0>(srv, F(srv_s), F(srv_b), cl, F(cl_s), F(cl_b), F(w),
                                     clients, lr, out, pp, sp, tp, m, entries, f, p, st);
        break;
      case 4:
        err = launch<uint32_t, 0, 0>(srv, F(srv_s), F(srv_b), cl, F(cl_s), F(cl_b), F(w),
                                     clients, lr, out, pp, sp, tp, m, entries, f, p, st);
        break;
      default:
        break;
    }
  }
  return int(err);
}

}  // extern "C"
