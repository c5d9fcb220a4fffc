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
//   partials[e, block] = [sum new, sum q, sum new*q, sum q*q] over the
//                        block's true elements
//
// and a second launch reduces each entry's partials in a fixed order
// (reduce.cuh).  (s, b) are solved from the [entries, 4] sums on the host
// side in torch (core.pvt.pvt_from_sums), the closed form the reference
// solves outside its kernel too (agg.py:86-95).
//
// Bound: bytes.  It reads C + 1 code planes and writes one, plus a few
// scalars: (C + 2) * n * container_bytes; for conformer_s' [17, 512, 2048]
// leaves at C = 8 in u16, 356.5 MB, 0.106 ms at 3.35 TB/s.  The f32
// intermediates never leave registers.
//
// Design.  The TPU kernel tiles each entry in 1024-lane blocks padded to the
// tile and carries the sums across a sequential grid.  Here the grid is
// (blocks per entry, entries) with no padding, grid-stride within the
// entry: each thread takes 16 bytes of codes at a time (8 u16 elements)
// from each of the C client planes in order c = 0..C-1, keeps the 8 running
// sums in registers, and writes 16 bytes of new codes; a scalar variant
// takes entries whose size or alignment does not allow that.  The
// per-client (w_c, s_c, b_c) of the block's entry are copied from device
// memory into shared memory once per block: no host sync.  Every operation
// that reaches a code is written with __fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn, so nothing is contracted into an FMA and the codes equal the
// plain version's (kernels/ref.py), which runs the same operations in the
// same client order, bit for bit.
#include "minifloat.cuh"
#include "reduce.cuh"

namespace {

constexpr int kThreads = omc::kReduceThreads;  // block_sum4 assumes this size
constexpr int kItemsPerThread = 8;             // sizes the grid: 2048 elements per block
constexpr int kMaxClients = 4096;              // 3 floats each in shared memory: 48 KB

__device__ __forceinline__ float affine(float v, float s, float b) {
  return __fadd_rn(__fmul_rn(v, s), b);  // never an FMA: matches v*s + b
}

// Client c's contribution to one element's weighted sum.
__device__ __forceinline__ float weighted(uint32_t code, float s, float b, float w,
                                          const omc::Format& f) {
  float x = affine(omc::decode_bits(code, f), s, b);
  x = w > 0.0f ? x : 0.0f;  // where, not a multiply: NaN in a dead row stays out
  return __fmul_rn(x, w);
}

// The server half of one element: new value, its code, and the PVT sums.
template <typename T>
__device__ __forceinline__ T finish(float acc, float wsum, T srv_code, float s_old, float b_old,
                                    float lr, const omc::Format& f, float a[4]) {
  const float mean = __fdiv_rn(acc, wsum);
  const float old = affine(omc::decode_bits(srv_code, f), s_old, b_old);
  const float v = __fadd_rn(old, __fmul_rn(lr, __fsub_rn(mean, old)));
  const float q = omc::value_quantize(v, f);
  a[0] += v;
  a[1] += q;
  a[2] += v * q;
  a[3] += q * q;
  return T(omc::encode_bits(q, f));
}

// grid = (blocks per entry, entries), block = kThreads, dynamic shared memory
// 3 * clients floats.  srv, out: [entries, m]; cl: [clients, entries, m];
// srv_s, srv_b: [entries]; cl_s, cl_b: [clients, entries]; w: [clients];
// partials: [entries, blocks, 4].  With kVec every thread takes 16 bytes of
// codes at a time (V elements) from each client plane: the caller checks
// that the planes are 16-byte aligned and m is a multiple of V.
template <typename T, bool kVec>
__global__ void fused_aggregate_kernel(const T* __restrict__ srv, const float* __restrict__ srv_s,
                                       const float* __restrict__ srv_b, const T* __restrict__ cl,
                                       const float* __restrict__ cl_s,
                                       const float* __restrict__ cl_b,
                                       const float* __restrict__ w, int clients, float lr,
                                       T* __restrict__ out, float* __restrict__ partials,
                                       long long m, omc::Format f) {
  extern __shared__ float client_scalars[];  // w[C], s[C], b[C] of this entry
  float* sw = client_scalars;
  float* ss = client_scalars + clients;
  float* sb = client_scalars + 2 * clients;
  const int e = blockIdx.y;
  const int entries = gridDim.y;
  for (int c = threadIdx.x; c < clients; c += blockDim.x) {
    sw[c] = w[c];
    ss[c] = cl_s[(long long)c * entries + e];
    sb[c] = cl_b[(long long)c * entries + e];
  }
  __syncthreads();
  float wsum = 0.0f;
  for (int c = 0; c < clients; ++c) wsum = __fadd_rn(wsum, sw[c]);
  wsum = fmaxf(wsum, 1e-9f);
  const float s_old = srv_s[e];
  const float b_old = srv_b[e];

  constexpr int V = kVec ? 16 / int(sizeof(T)) : 1;
  const long long plane = (long long)entries * m;  // one client's codes
  const T* cl_e = cl + (long long)e * m;
  const T* srv_e = srv + (long long)e * m;
  T* out_e = out + (long long)e * m;
  const long long stride = (long long)gridDim.x * blockDim.x;
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < m / V; j += stride) {
    if (kVec) {
      float acc[V];
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = 0.0f;
      const T* p = cl_e + j * V;
#pragma unroll 4
      for (int c = 0; c < clients; ++c) {
        const uint4 raw = *reinterpret_cast<const uint4*>(p + c * plane);
        const T* code = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          acc[k] = __fadd_rn(acc[k], weighted(code[k], ss[c], sb[c], sw[c], f));
        }
      }
      const uint4 sraw = *reinterpret_cast<const uint4*>(srv_e + j * V);
      const T* scode = reinterpret_cast<const T*>(&sraw);
      uint4 oraw;
      T* ocode = reinterpret_cast<T*>(&oraw);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        ocode[k] = finish<T>(acc[k], wsum, scode[k], s_old, b_old, lr, f, a);
      }
      *reinterpret_cast<uint4*>(out_e + j * V) = oraw;
    } else {
      float acc = 0.0f;
      const T* p = cl_e + j;
      for (int c = 0; c < clients; ++c) {
        acc = __fadd_rn(acc, weighted(p[c * plane], ss[c], sb[c], sw[c], f));
      }
      out_e[j] = finish<T>(acc, wsum, srv_e[j], s_old, b_old, lr, f, a);
    }
  }
  omc::block_sum4(a);
  if (threadIdx.x == 0) {
    float* dst = partials + ((long long)blockIdx.y * gridDim.x + blockIdx.x) * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[j] = a[j];
  }
}

// Blocks per entry: enough for kItemsPerThread elements a thread, at most
// kMaxGrid blocks in all (each thread then loops over more).
long long blocks_for(long long m, int entries) {
  const long long want = (m + kThreads * kItemsPerThread - 1) / (kThreads * kItemsPerThread);
  const long long cap = (omc::kMaxGrid + entries - 1) / entries;
  return want < 1 ? 1 : want < cap ? want : cap;
}

template <typename T>
void launch(const void* srv, const float* srv_s, const float* srv_b, const void* cl,
            const float* cl_s, const float* cl_b, const float* w, int clients, float lr,
            void* out, float* partials, float* sums, long long m, int entries,
            const omc::Format& f, cudaStream_t stream) {
  const long long blocks = blocks_for(m, entries);
  const dim3 grid{unsigned(blocks), unsigned(entries)};
  const size_t shared = 3 * size_t(clients) * sizeof(float);
  constexpr int V = 16 / sizeof(T);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = m % V == 0 && aligned(srv) && aligned(cl) && aligned(out);
  const T* s = static_cast<const T*>(srv);
  const T* c = static_cast<const T*>(cl);
  T* o = static_cast<T*>(out);
  if (vec) {
    fused_aggregate_kernel<T, true><<<grid, kThreads, shared, stream>>>(
        s, srv_s, srv_b, c, cl_s, cl_b, w, clients, lr, o, partials, m, f);
  } else {
    fused_aggregate_kernel<T, false><<<grid, kThreads, shared, stream>>>(
        s, srv_s, srv_b, c, cl_s, cl_b, w, clients, lr, o, partials, m, f);
  }
  omc::reduce_partials_kernel<<<entries, omc::kReduceThreads, 0, stream>>>(partials, sums,
                                                                            blocks);
}

}  // namespace

extern "C" {

// Number of per-block partial-sum slots fused_aggregate needs per entry.
long long omc_fused_aggregate_blocks(long long m, int entries) { return blocks_for(m, entries); }

int omc_fused_aggregate(const void* srv, const void* srv_s, const void* srv_b, const void* cl,
                        const void* cl_s, const void* cl_b, const void* w, int clients,
                        float lr, void* out, int container_bytes, void* partials, void* sums,
                        long long m, int entries, int exp_bits, int mant_bits, void* stream) {
  const omc::Format f = omc::make_format(exp_bits, mant_bits);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto F = [](const void* p) { return static_cast<const float*>(p); };
  float* pp = static_cast<float*>(partials);
  float* sp = static_cast<float*>(sums);
  if (m <= 0 || entries <= 0 || entries > 65535 || clients < 1 || clients > kMaxClients) {
    return int(cudaErrorInvalidValue);
  }
  switch (container_bytes) {
    case 1:
      launch<uint8_t>(srv, F(srv_s), F(srv_b), cl, F(cl_s), F(cl_b), F(w), clients, lr, out, pp,
                      sp, m, entries, f, st);
      break;
    case 2:
      launch<uint16_t>(srv, F(srv_s), F(srv_b), cl, F(cl_s), F(cl_b), F(w), clients, lr, out, pp,
                       sp, m, entries, f, st);
      break;
    case 4:
      launch<uint32_t>(srv, F(srv_s), F(srv_b), cl, F(cl_s), F(cl_b), F(w), clients, lr, out, pp,
                       sp, m, entries, f, st);
      break;
    default:
      return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

}  // extern "C"
