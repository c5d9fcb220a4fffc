// dequant_matmul for Hopper (sm_90a): out[M,N] = A[M,K] @ (s*dec(W[K,N]) + b).
//
// Replaces src/repro/kernels/dequant_matmul.py::dequant_matmul (the Pallas
// kernel of dequant_matmul.py:58, pallas_call at :87): the serve path's
// weight-stream matmul.  The weights stay minifloat codes in device memory;
// each tile of codes is decoded in shared memory, so the f32 weights never
// exist in device memory.
//
// What it computes: out = s*(A @ dec(W)) + b*rowsum(A), f32 throughout, as the
// Pallas kernel's epilogue (dequant_matmul.py:50-55).  The decode is
// omc::decode_bits from minifloat.cuh, the one the dequantize kernel uses, so
// every weight decodes bit for bit as in the plain version; the sums are
// taken in another order than the plain version's a @ (s*dec(W) + b), and the
// bias enters as the rank-1 term, so the two agree within a tolerance.
//
// Bound on an H100 SXM, the larger of two times: the bytes (A read once, the
// codes read once, out written once: 4MK + cKN + 4MN, c the container's
// bytes) over 3.35 TB/s, and the f32 operations (2MKN) over 67 TFLOP/s, the
// f32 rate outside the tensor cores (the oracle is full f32: no TF32, no
// tensor cores).  At decode (M = 4) the codes bound it; at prefill (M = 128)
// the operations do.
//
// Design (SIMT, right first; TMA and wgmma are later work).  Two paths:
//
// Weight stream, for M <= 8 (decode) when N is a whole number of 16-byte code
// vectors: the codes dominate the bytes, so the design is about keeping
// enough loads in flight.  Each thread owns the V columns of one 16-byte
// code vector (V = 16, 8, 4 for u8, u16, u32) and walks a chunk of K rows,
// issuing several row loads before it decodes them, and keeps an M x V
// register tile of f32 FMAs; the chunk of A sits in shared memory.  K is
// split over the grid's y axis so that about four blocks run on each SM even
// when N is narrow (wk, wv: N = 256).  Each split writes its partial tile,
// and its row sums of A, to a scratch; a second launch adds the splits in a
// fixed order and applies s and b.  No float atomics: the result is the
// same from run to run.  Every code is read from device memory once.
//
// Tiled, for everything else (prefill M = 128, odd N): each block owns one
// BM x BN output tile and loops over K in slabs of BK; it stages the A slab
// in shared memory, transposed, and loads the codes slab in its container
// type, 16 bytes a thread where every row allows it, decoding each code once
// into shared memory as f32; each thread keeps a TM x 4 register tile of f32
// FMAs and its TM row sums of A, accumulated in the same loop; the epilogue
// applies s and b.  BM = 128: when M <= 128 every code is read from device
// memory once per launch.
//
// Both read s and b from device memory (no host sync), decode with
// omc::decode_bits, and mask ragged M, K and N edges.
#include "minifloat.cuh"

namespace {

// ---------------------------------------------------------------------------
// tiled (prefill, odd shapes)
// ---------------------------------------------------------------------------

constexpr int kTN = 4;  // columns per thread: one float4 of shared memory

template <typename T, int BM, int BN, int BK, int TM, bool kVec>
__global__ void __launch_bounds__((BM / TM) * (BN / kTN))
    dequant_matmul_kernel(const float* __restrict__ a, const T* __restrict__ w,
                          const float* __restrict__ s_ptr, const float* __restrict__ b_ptr,
                          float* __restrict__ out, int m_total, int k_total, int n_total,
                          omc::Format f) {
  constexpr int kTX = BN / kTN;  // threads along N
  constexpr int kThreads = (BM / TM) * kTX;
  static_assert(TM % 4 == 0, "a thread reads its rows of A as float4s");
  __shared__ __align__(16) float as[BK][BM + 4];  // A slab, transposed; rows 16-byte aligned
  __shared__ __align__(16) float ws[BK][BN];  // decoded weights of the slab
  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[TM][kTN];
  float rowsum[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    rowsum[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < k_total; k0 += BK) {
    // A slab: consecutive threads read consecutive k of one row
    for (int i = tid; i < BM * BK; i += kThreads) {
      const int m = i / BK, k = i % BK;
      const int gm = m0 + m, gk = k0 + k;
      as[k][m] = (gm < m_total && gk < k_total) ? a[(long long)gm * k_total + gk] : 0.0f;
    }
    // codes slab -> f32 in shared memory, each code decoded once
    if (kVec) {
      constexpr int V = 16 / sizeof(T);  // codes per 16-byte load
      constexpr int kPerRow = BN / V;
      constexpr int kVecs = BK * kPerRow;
      constexpr int kLoads = (kVecs + kThreads - 1) / kThreads;
      uint4 raw[kLoads];
      bool live[kLoads];
#pragma unroll
      for (int r = 0; r < kLoads; ++r) {
        const int i = tid + r * kThreads;
        const int gk = k0 + i / kPerRow, gn = n0 + (i % kPerRow) * V;
        // N % V == 0 here, so a vector is wholly inside N or wholly outside
        live[r] = i < kVecs && gk < k_total && gn < n_total;
        raw[r] = live[r] ? *reinterpret_cast<const uint4*>(w + (long long)gk * n_total + gn)
                         : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int r = 0; r < kLoads; ++r) {
        const int i = tid + r * kThreads;
        if (i < kVecs) {
          const int k = i / kPerRow, n = (i % kPerRow) * V;
          const T* c = reinterpret_cast<const T*>(&raw[r]);
#pragma unroll
          for (int j = 0; j < V; j += 4) {
            float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (live[r]) {
              v.x = omc::decode_bits(c[j + 0], f);
              v.y = omc::decode_bits(c[j + 1], f);
              v.z = omc::decode_bits(c[j + 2], f);
              v.w = omc::decode_bits(c[j + 3], f);
            }
            *reinterpret_cast<float4*>(&ws[k][n + j]) = v;
          }
        }
      }
    } else {
      for (int i = tid; i < BK * BN; i += kThreads) {
        const int k = i / BN, n = i % BN;
        const int gk = k0 + k, gn = n0 + n;
        ws[k][n] = (gk < k_total && gn < n_total)
                       ? omc::decode_bits(w[(long long)gk * n_total + gn], f)
                       : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      const float4 wv = *reinterpret_cast<const float4*>(&ws[k][tx * kTN]);
      float av_k[TM];
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        const float4 q = *reinterpret_cast<const float4*>(&as[k][ty * TM + i]);
        av_k[i] = q.x;
        av_k[i + 1] = q.y;
        av_k[i + 2] = q.z;
        av_k[i + 3] = q.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float av = av_k[i];
        rowsum[i] += av;
        acc[i][0] = fmaf(av, wv.x, acc[i][0]);
        acc[i][1] = fmaf(av, wv.y, acc[i][1]);
        acc[i][2] = fmaf(av, wv.z, acc[i][2]);
        acc[i][3] = fmaf(av, wv.w, acc[i][3]);
      }
    }
    __syncthreads();
  }

  // A @ (s*W + b*1) = s*(A @ W) + b*rowsum(A)*1^T
  const float s = *s_ptr, b = *b_ptr;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= m_total) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + tx * kTN + j;
      if (gn < n_total) out[(long long)gm * n_total + gn] = s * acc[i][j] + b * rowsum[i];
    }
  }
}

template <typename T>
void launch_tiled(const float* a, const void* codes, const float* s, const float* b, float* out,
                  int m, int k, int n, const omc::Format& f, cudaStream_t stream) {
  constexpr int BM = 128, BN = 64, BK = 32, TM = 8;  // 256 threads
  const T* w = static_cast<const T*>(codes);
  const dim3 grid{unsigned((n + BN - 1) / BN), unsigned((m + BM - 1) / BM)};
  const int threads = (BM / TM) * (BN / kTN);
  if (n % (16 / sizeof(T)) == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0) {
    dequant_matmul_kernel<T, BM, BN, BK, TM, true>
        <<<grid, threads, 0, stream>>>(a, w, s, b, out, m, k, n, f);
  } else {
    dequant_matmul_kernel<T, BM, BN, BK, TM, false>
        <<<grid, threads, 0, stream>>>(a, w, s, b, out, m, k, n, f);
  }
}

// ---------------------------------------------------------------------------
// weight stream (M <= 8): split-K partial tiles, then a fixed-order sum
// ---------------------------------------------------------------------------

constexpr int kStreamThreads = 128;  // most threads a block of this path has
constexpr int kStreamBlocks = 4 * 132;  // blocks to aim for: four per SM of an H100
constexpr int kMinChunk = 32;  // fewest rows of K a split takes (but the last)
constexpr int kMaxChunk = 512;  // most rows of K a split takes (A's chunk in shared memory)
constexpr int kMaxRows = 8;  // most rows of A this path takes

struct StreamPlan {
  int threads;  // per block: one 16-byte code vector (V columns) each
  int col_blocks;  // grid x
  int chunk;  // rows of K per split
  int splits;  // grid y
};

// The weight-stream plan for this product, or false where the tiled path runs.
bool stream_plan(const void* codes, int container_bytes, int m, int k, int n, StreamPlan* p) {
  if (container_bytes != 1 && container_bytes != 2 && container_bytes != 4) return false;
  const int v = 16 / container_bytes;
  if (m < 1 || m > kMaxRows || k < 1 || n < 1 || n % v != 0) return false;
  if (reinterpret_cast<uintptr_t>(codes) % 16 != 0) return false;
  const long long vecs = n / v;
  p->threads = int(vecs < kStreamThreads ? (vecs + 31) / 32 * 32 : kStreamThreads);
  const long long col_blocks = (vecs + p->threads - 1) / p->threads;
  const long long want = (kStreamBlocks + col_blocks - 1) / col_blocks;  // splits wanted
  long long chunk = (k + want - 1) / want;
  chunk = chunk < kMinChunk ? kMinChunk : chunk > kMaxChunk ? kMaxChunk : chunk;
  p->col_blocks = int(col_blocks);
  p->chunk = int(chunk);
  p->splits = int((k + chunk - 1) / chunk);
  return col_blocks <= 0x7FFFFFFF && p->splits <= 65535;
}

// acc[m][j] += as[m][k] * dec(code j of the vector), for every row m < MR.
template <typename T, int MR, int V>
__device__ __forceinline__ void accumulate_row(float (&acc)[MR][V], const uint4& raw,
                                               const float (*as)[kMaxChunk], int k,
                                               const omc::Format& f) {
  const T* c = reinterpret_cast<const T*>(&raw);
  float wv[V];
#pragma unroll
  for (int j = 0; j < V; ++j) wv[j] = omc::decode_bits(c[j], f);
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    const float av = as[m][k];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[m][j] = fmaf(av, wv[j], acc[m][j]);
  }
}

// grid = (col_blocks, splits).  partial is [splits, M, N], rowpart [splits, M].
template <typename T, int MR>
__global__ void __launch_bounds__(kStreamThreads)
    stream_partial_kernel(const float* __restrict__ a, const T* __restrict__ w,
                          float* __restrict__ partial, float* __restrict__ rowpart,
                          int m_total, int k_total, int n_total, int chunk, omc::Format f) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kUnroll = sizeof(T) == 1 ? 4 : 8;  // row loads in flight per thread
  __shared__ float as[MR][kMaxChunk];
  const int split = blockIdx.y;
  const int k0 = split * chunk;
  const int rows = min(chunk, k_total - k0);  // >= 1 by the plan
  for (int i = threadIdx.x; i < MR * rows; i += blockDim.x) {
    const int m = i / rows, k = i % rows;
    as[m][k] = m < m_total ? a[(long long)m * k_total + k0 + k] : 0.0f;
  }
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x < m_total) {  // this split's row sums of A, in order
    float r = 0.0f;
    for (int k = 0; k < rows; ++k) r += as[threadIdx.x][k];
    rowpart[(long long)split * m_total + threadIdx.x] = r;
  }
  const long long n = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (n >= n_total) return;
  float acc[MR][V];
#pragma unroll
  for (int m = 0; m < MR; ++m) {
#pragma unroll
    for (int j = 0; j < V; ++j) acc[m][j] = 0.0f;
  }
  const T* wp = w + (long long)k0 * n_total + n;
  int k = 0;
  for (; k + kUnroll <= rows; k += kUnroll) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      raw[u] = *reinterpret_cast<const uint4*>(wp + (long long)(k + u) * n_total);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) accumulate_row<T, MR, V>(acc, raw[u], as, k + u, f);
  }
  for (; k < rows; ++k) {
    const uint4 raw = *reinterpret_cast<const uint4*>(wp + (long long)k * n_total);
    accumulate_row<T, MR, V>(acc, raw, as, k, f);
  }
  float* p = partial + (long long)split * m_total * n_total + n;
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    if (m >= m_total) break;
#pragma unroll
    for (int j = 0; j < V; j += 4) {
      *reinterpret_cast<float4*>(p + (long long)m * n_total + j) =
          make_float4(acc[m][j], acc[m][j + 1], acc[m][j + 2], acc[m][j + 3]);
    }
  }
}

// out = s * (sum of the splits' tiles) + b * (sum of their row sums).  A block
// takes kFinalCols outputs; kFinalLanes threads share each, every one adding
// every kFinalLanes-th split in order, and the first adds their sums in lane
// order: a fixed order, with loads in flight across the splits.
constexpr int kFinalCols = 32, kFinalLanes = 8;

__global__ void __launch_bounds__(kFinalCols * kFinalLanes)
    stream_finalize_kernel(const float* __restrict__ partial, const float* __restrict__ rowpart,
                           const float* __restrict__ s_ptr, const float* __restrict__ b_ptr,
                           float* __restrict__ out, int m_total, int n_total, int splits) {
  __shared__ float sums[kFinalLanes][kFinalCols][2];
  const int x = threadIdx.x % kFinalCols, lane = threadIdx.x / kFinalCols;
  const long long total = (long long)m_total * n_total;
  const long long i = (long long)blockIdx.x * kFinalCols + x;
  float acc = 0.0f, r = 0.0f;
  if (i < total) {
    const int m = int(i / n_total);
#pragma unroll 4
    for (int sp = lane; sp < splits; sp += kFinalLanes) {
      acc += partial[(long long)sp * total + i];
      r += rowpart[(long long)sp * m_total + m];
    }
  }
  sums[lane][x][0] = acc;
  sums[lane][x][1] = r;
  __syncthreads();
  if (lane == 0 && i < total) {
#pragma unroll
    for (int l = 1; l < kFinalLanes; ++l) {
      acc += sums[l][x][0];
      r += sums[l][x][1];
    }
    out[i] = *s_ptr * acc + *b_ptr * r;
  }
}

template <typename T>
void launch_stream(const float* a, const T* w, const float* s, const float* b, float* out,
                   float* partial, float* rowpart, int m, int k, int n, const StreamPlan& p,
                   const omc::Format& f, cudaStream_t stream) {
  const dim3 grid{unsigned(p.col_blocks), unsigned(p.splits)};
  if (m <= 4) {
    stream_partial_kernel<T, 4><<<grid, p.threads, 0, stream>>>(a, w, partial, rowpart, m, k, n,
                                                                p.chunk, f);
  } else {
    stream_partial_kernel<T, kMaxRows><<<grid, p.threads, 0, stream>>>(a, w, partial, rowpart,
                                                                       m, k, n, p.chunk, f);
  }
  const unsigned blocks = unsigned(((long long)m * n + kFinalCols - 1) / kFinalCols);
  stream_finalize_kernel<<<blocks, kFinalCols * kFinalLanes, 0, stream>>>(
      partial, rowpart, s, b, out, m, n, p.splits);
}

}  // namespace

extern "C" {

// Splits of K the weight-stream path takes for this product (the scratch the
// caller allocates: partial [splits, m, n] f32, rowpart [splits, m] f32), or
// 0 where the tiled path runs and needs no scratch.
long long omc_dequant_matmul_splits(const void* codes, int container_bytes, int m, int k,
                                    int n) {
  StreamPlan p;
  return stream_plan(codes, container_bytes, m, k, n, &p) ? p.splits : 0;
}

// a [m, k] f32, codes [k, n] in a container of container_bytes, one (s, b)
// pair as device f32 scalars, out [m, n] f32; all contiguous.  partial and
// rowpart: the scratch of omc_dequant_matmul_splits (null when it is 0).
int omc_dequant_matmul(const void* a, const void* codes, int container_bytes, const void* s,
                       const void* b, void* out, void* partial, void* rowpart, long long splits,
                       int m, int k, int n, int exp_bits, int mant_bits, void* stream) {
  const omc::Format f = omc::make_format(exp_bits, mant_bits);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ap = static_cast<const float*>(a);
  const float* sp = static_cast<const float*>(s);
  const float* bp = static_cast<const float*>(b);
  float* o = static_cast<float*>(out);
  float* pp = static_cast<float*>(partial);
  float* rp = static_cast<float*>(rowpart);
  if (m < 0 || k < 0 || n < 0) return int(cudaErrorInvalidValue);
  if (m == 0 || n == 0) return int(cudaGetLastError());
  StreamPlan plan;
  const bool streamed = stream_plan(codes, container_bytes, m, k, n, &plan);
  if (splits != (streamed ? plan.splits : 0) || (streamed && (!pp || !rp))) {
    return int(cudaErrorInvalidValue);
  }
  switch (container_bytes) {
    case 1:
      if (streamed) {
        launch_stream(ap, static_cast<const uint8_t*>(codes), sp, bp, o, pp, rp, m, k, n, plan,
                      f, st);
      } else {
        launch_tiled<uint8_t>(ap, codes, sp, bp, o, m, k, n, f, st);
      }
      break;
    case 2:
      if (streamed) {
        launch_stream(ap, static_cast<const uint16_t*>(codes), sp, bp, o, pp, rp, m, k, n, plan,
                      f, st);
      } else {
        launch_tiled<uint16_t>(ap, codes, sp, bp, o, m, k, n, f, st);
      }
      break;
    case 4:
      if (streamed) {
        launch_stream(ap, static_cast<const uint32_t*>(codes), sp, bp, o, pp, rp, m, k, n, plan,
                      f, st);
      } else {
        launch_tiled<uint32_t>(ap, codes, sp, bp, o, m, k, n, f, st);
      }
      break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

}  // extern "C"
