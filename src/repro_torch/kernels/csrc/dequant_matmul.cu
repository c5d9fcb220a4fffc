// dequant_matmul for Hopper (sm_90a): out[M,N] = A[M,K] @ (s*dec(W[K,N]) + b).
//
// Replaces src/repro/kernels/dequant_matmul.py::dequant_matmul (the Pallas
// kernel of dequant_matmul.py:58, pallas_call at :87): the serve path's
// weight-stream matmul.  The weights stay minifloat codes in device memory;
// each code is read from device memory once per launch and decoded on chip,
// so the f32 weights never exist in device memory.
//
// What it computes: out = s*(A @ dec(W)) + b*rowsum(A), as the Pallas
// kernel's epilogue (dequant_matmul.py:50-55).  Every code decodes bit for
// bit as omc::decode_bits (minifloat.cuh, the dequantize kernel's decode);
// the sums are taken in another order than the plain version's
// a @ (s*dec(W) + b), and the bias enters as the rank-1 term, so the two
// agree within 2e-5*(|A| @ |s*dec(W) + b|) elementwise.  Every sum is taken
// in a fixed order (no float atomics): the same bits from launch to launch.
//
// Decode (decode_fast, decode.cuh): branch-free.  The code's sign and magnitude bits are
// placed into an f32 bit pattern, sign<<31 | mag<<(23-z), whose value is the
// minifloat's times 2^(bias-127); one exact multiply by 2^(127-bias) gives
// the value (a minifloat subnormal lands on an f32 subnormal first; the build
// has no flush-to-zero, so that is exact too), and a select gives inf/NaN for
// the top exponent field.  S1E3M7, the serve format, is a compile-time
// format, so its masks and shifts fold into constants, and the weight stream
// decodes its u16 codes two at a time from 32-bit words (decode_pair: about
// 2.5 instructions a code, inf/NaN checked once per 16-byte vector); every
// other format runs the same kernels with the format's fields read at run
// time.
//
// Two paths, chosen on the host from the shape (stream_plan, tile_plan):
//
// Weight stream, for M <= 8 (decode) when N is a whole number of 8- or
// 16-byte code vectors.  Bound on an H100 SXM by the bytes (A, the codes
// and out once: 4MK + cKN + 4MN) over 3.35 TB/s: at 3.35 TB/s an SM must
// retire about 6.4 u16 codes a cycle, about 20 instructions a code.  The
// design keeps loads in flight all the time and the decode cheap:
//   * each thread owns one code vector (8 codes; 4 for u32) of a column
//     tile and walks a contiguous run of K rows through a private ring of
//     six 16-byte slots in shared memory, filled by cp.async: the next five
//     rows are in flight while it decodes one (20 KB a block, two or three
//     blocks an SM), with A's values for the next row prefetched into
//     registers (A is a few KB and stays in L1);
//   * K is split twice, over the block's 8 warps (each warp 1-4 row runs,
//     by the width of the column tile) and over a thread-block cluster of
//     1-8 blocks along the grid's y axis, so that 30-400 blocks run even
//     for N = 256;
//   * the splits are summed inside the same launch: each block sums its
//     row runs in shared memory in run order, then the cluster's blocks sum
//     the blocks' tiles in rank order through distributed shared memory;
//     no scratch in device memory, no second launch, no atomics.
//
// Tile, for everything else (prefill M = 128, odd shapes).  Bound by the
// tensor cores: passes*2MKN over 494.7 TFLOP/s of TF32 (the bytes bound is
// lower at M = 128).  TF32 keeps 10 mantissa bits, so one pass is not f32
// accurate; two are ("2xTF32"):
//   * dec(W) is exact in TF32 for every format with <= 10 mantissa bits
//     (the low 13 bits of its f32 pattern are zero), and A = A_hi + A_lo
//     with A_hi = tf32(A), A_lo = tf32(A - A_hi) leaves out only about
//     2^-22 of |A|; each product of TF32 values is exact in f32, so
//     A_hi@dec + A_lo@dec is the f32 product up to the order of the sums
//     and the tensor cores' f32 accumulation.  Formats with more mantissa
//     bits (S1E4M14, S1E8M23) split the decoded weight too and add
//     A_hi@dec_lo: three passes ("3xTF32"), picked from the format
//     (variant).
//   * each block owns a 128 x 88 output tile (126 tiles for N = 11008, one
//     wave on 132 SMs) and walks K in slabs of 32: the codes and A of the
//     next three slabs are in flight by cp.async into a ring while one slab
//     is converted: its codes decoded once into a K-major operand tile (in
//     the 128-byte swizzle wgmma reads without bank conflicts), A split into
//     A_hi and A_lo, rowsum(A) accumulated beside them;
//     two warpgroups then issue wgmma m64n88k8 (f32 += tf32 x tf32) from
//     shared memory, asynchronously, while the next slab is converted into
//     the other operand buffer.  Narrow N (few tiles) splits K over a
//     cluster of up to 8 blocks, summed in rank order through distributed
//     shared memory, as the stream does.
//   * BM = 128: at M <= 128 every code is read and decoded once per launch.
//
// Both read s and b from device memory (no host sync) and mask ragged M, K
// and N edges (zero-filled in shared memory).
#include <cooperative_groups.h>

#include "decode.cuh"
#include "minifloat.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // both paths: 8 warps, two warpgroups
constexpr int kClusterMax = 8;  // portable cluster size

// ---------------------------------------------------------------------------
// asynchronous copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy kBytes (8 or 16) from global to shared memory, or zero-fill them.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool copy) {
  const int n = copy ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(kBytes), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Launch `kernel` on a grid whose y axis is one cluster of `cluster` blocks,
// with `smem` bytes of dynamic shared memory.  Above 48 KB the kernel's limit
// is raised, to the most it ever takes (`max_smem`), once per device:
// raised[device], the kernel's own flags.
template <typename... KArgs, typename... Args>
cudaError_t launch_clustered(void (*kernel)(KArgs...), bool (&raised)[64], size_t max_smem,
                             dim3 grid, int cluster, size_t smem, cudaStream_t stream,
                             Args... args) {
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 64 || !raised[dev]) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 int(max_smem));
      if (err != cudaSuccess) return err;
      if (dev < 64) raised[dev] = true;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = unsigned(cluster);
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// ---------------------------------------------------------------------------
// weight stream (M <= 8)
// ---------------------------------------------------------------------------

constexpr int kStages = 6;  // ring slots per thread: kStages-1 rows in flight
constexpr int kMaxRows = 8;  // most rows of A this path takes

// Codes a thread copies per row: 8 (u8: 8 bytes; u16: 16 bytes) or 4 (u32).
template <typename T>
__host__ __device__ constexpr int stream_vec() {
  return sizeof(T) == 4 ? 4 : 8;
}

struct StreamPlan {
  int cw_log2;  // code vectors per warp row: 32, 16 or 8 (then 1, 2 or 4 row runs a warp)
  int col_tiles;  // grid x: column tiles of 2^cw_log2 vectors
  int cluster;  // grid y: blocks of one cluster, splitting K
};

// The weight-stream plan for this product, or false where the tile path runs.
bool stream_plan(const void* codes, int container_bytes, int m, int k, int n, StreamPlan* p) {
  if (container_bytes != 1 && container_bytes != 2 && container_bytes != 4) return false;
  const int v = container_bytes == 4 ? 4 : 8;
  const int vec_bytes = v * container_bytes;
  if (m < 1 || m > kMaxRows || k < 1 || n < 1 || n % v != 0) return false;
  if (reinterpret_cast<uintptr_t>(codes) % vec_bytes != 0) return false;
  const long long vecs = n / v;
  const int slots = 132 * (m <= 4 ? 3 : 2);  // resident blocks on an H100
  // the widest column tile that still gives the grid half its slots, then
  // the largest cluster that keeps the grid in one wave and >= 8 rows a run
  int cw_log2 = 5;
  for (; cw_log2 > 3; --cw_log2) {
    if (((vecs + (1 << cw_log2) - 1) >> cw_log2) * kClusterMax >= slots / 2) break;
  }
  const long long tiles = (vecs + (1 << cw_log2) - 1) >> cw_log2;
  const int runs = kThreads >> cw_log2;  // row runs of one block
  int cluster = kClusterMax;
  while (cluster > 1 && (tiles * cluster > slots || k < cluster * runs * 8)) cluster /= 2;
  if (tiles > 0x7FFFFFFF) return false;
  p->cw_log2 = cw_log2;
  p->col_tiles = int(tiles);
  p->cluster = cluster;
  return true;
}

// Shared memory of the weight stream: the ring, then reused for the sums.
template <typename T, int MR>
constexpr size_t stream_smem() {
  constexpr int V = stream_vec<T>();
  const size_t ring = size_t(kStages) * kThreads * 16;
  // row runs' tiles [runs][MR][cw*V] (runs*cw = kThreads), their row sums
  // [runs][MR] (runs <= 32) and the block's row sums [MR]
  const size_t red = (size_t(kThreads) * MR * V + 33 * MR) * 4;
  return ring > red ? ring : red;
}

// grid = (col_tiles, cluster); the cluster spans grid y and splits K.
template <typename T, int MR, int Y, int Z>
__global__ void __launch_bounds__(kThreads, MR <= 4 ? 3 : 2)
    stream_kernel(const float* __restrict__ a, const T* __restrict__ w,
                  const float* __restrict__ s_ptr, const float* __restrict__ b_ptr,
                  float* __restrict__ out, int m_total, int k_total, int n_total, int cw_log2,
                  omc::Format f) {
  constexpr int V = stream_vec<T>();
  constexpr int kBytes = V * int(sizeof(T));
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int cw = 1 << cw_log2;
  const int col = tid & (cw - 1);  // adjacent threads on adjacent vectors
  const int runs = kThreads >> cw_log2;
  const int run = tid >> cw_log2;
  const int rank = blockIdx.y, ranks = gridDim.y;

  uint4* ring = reinterpret_cast<uint4*>(smem);

  // this thread's code vector, and its run of K rows: the block's share of
  // K (by cluster rank), then the run's share of the block's
  const long long n0 = ((long long)blockIdx.x * cw + col) * V;
  const bool live = n0 < n_total;
  const int kb = (k_total + ranks - 1) / ranks;
  const int kb0 = min(k_total, rank * kb), kb1 = min(k_total, kb0 + kb);
  const int kr = (kb1 - kb0 + runs - 1) / runs;
  const int k0 = min(kb1, kb0 + run * kr), k1 = min(kb1, k0 + kr);
  const int rows = live ? k1 - k0 : 0;

  const T* src = w + (long long)k0 * n_total + (live ? n0 : 0);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < rows) cp_async<kBytes>(&ring[s * kThreads + tid], src + (long long)s * n_total, true);
    cp_async_commit();
  }
  float acc[MR][V];
  float rs[MR], an[MR];
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    rs[m] = 0.0f;
    an[m] = (rows > 0 && m < m_total) ? __ldg(a + (long long)m * k_total + k0) : 0.0f;
#pragma unroll
    for (int j = 0; j < V; ++j) acc[m][j] = 0.0f;
  }
  int slot = 0, fill = kStages - 1;  // ring slots of row i and of row i + kStages - 1
  for (int i = 0; i < rows; ++i) {
    // the slot being filled held row i-1, which is already in registers
    const int next = i + kStages - 1;
    if (next < rows) {
      cp_async<kBytes>(&ring[fill * kThreads + tid], src + (long long)next * n_total, true);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // row i has landed
    const uint4 raw = ring[slot * kThreads + tid];
    slot = slot == kStages - 1 ? 0 : slot + 1;
    fill = fill == kStages - 1 ? 0 : fill + 1;
    float av[MR];
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      av[m] = an[m];
      an[m] = (i + 1 < rows && m < m_total) ? __ldg(a + (long long)m * k_total + k0 + i + 1)
                                            : 0.0f;
    }
    float wv[V];
    omc::decode_vec<T, V, Y, Z>(wv, raw, f);
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      rs[m] += av[m];
#pragma unroll
      for (int j = 0; j < V; ++j) acc[m][j] = fmaf(av[m], wv[j], acc[m][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the sums

  // the block's tile: its row runs summed in run order
  const int tw = cw * V;  // columns of the tile
  float* red = reinterpret_cast<float*>(smem);  // [runs][MR][tw]
  float* rs_runs = red + kThreads * MR * V;  // [runs][MR]
  float* rs_block = rs_runs + 32 * MR;  // [MR]
#pragma unroll
  for (int m = 0; m < MR; ++m) {
#pragma unroll
    for (int j = 0; j < V; ++j) red[(run * MR + m) * tw + col * V + j] = acc[m][j];
    if (col == 0) rs_runs[run * MR + m] = rs[m];
  }
  __syncthreads();
  for (int o = tid; o < MR * tw; o += kThreads) {
    float v = red[o];  // run 0's, at the same place
    for (int r = 1; r < runs; ++r) v += red[r * MR * tw + o];
    red[o] = v;
  }
  if (tid < MR) {
    float v = 0.0f;
    for (int r = 0; r < runs; ++r) v += rs_runs[r * MR + tid];
    rs_block[tid] = v;
  }
  cluster.sync();  // every block's tile is ready to be read by its peers

  // the cluster's blocks summed in rank order; each block writes a share
  const float s = *s_ptr, b = *b_ptr;
  for (int o = rank * kThreads + tid; o < MR * tw; o += ranks * kThreads) {
    const int m = o / tw, c = o % tw;
    const long long n = (long long)blockIdx.x * tw + c;
    if (m >= m_total || n >= n_total) continue;
    float v = 0.0f, r = 0.0f;
    for (int q = 0; q < ranks; ++q) {
      v += cluster.map_shared_rank(red, q)[o];
      r += cluster.map_shared_rank(rs_block, q)[m];
    }
    out[(long long)m * n_total + n] = fmaf(s, v, b * r);
  }
  cluster.sync();  // keep this block's shared memory until its peers are done
}

template <typename T, int MR, int Y, int Z>
cudaError_t launch_stream_mr(const float* a, const T* w, const float* s, const float* b,
                             float* out, int m, int k, int n, const StreamPlan& p,
                             const omc::Format& f, cudaStream_t stream) {
  const dim3 grid{unsigned(p.col_tiles), unsigned(p.cluster)};
  static bool raised[64] = {};
  return launch_clustered(stream_kernel<T, MR, Y, Z>, raised, stream_smem<T, MR>(), grid,
                          p.cluster, stream_smem<T, MR>(), stream, a, w, s, b, out, m, k, n,
                          p.cw_log2, f);
}

template <typename T, int Y, int Z>
cudaError_t launch_stream(const float* a, const T* w, const float* s, const float* b, float* out,
                          int m, int k, int n, const StreamPlan& p, const omc::Format& f,
                          cudaStream_t stream) {
  if (m <= 4) return launch_stream_mr<T, 4, Y, Z>(a, w, s, b, out, m, k, n, p, f, stream);
  return launch_stream_mr<T, kMaxRows, Y, Z>(a, w, s, b, out, m, k, n, p, f, stream);
}

// ---------------------------------------------------------------------------
// tile (M > 8, odd shapes): 2xTF32 (or 3xTF32) on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kBM = 128;  // rows of A a block takes: two warpgroups of 64
constexpr int kBN = 88;  // columns: 126 tiles for N = 11008, one wave on 132 SMs
constexpr int kBK = 32;  // rows of K a slab takes: 4 wgmma k-steps of 8
constexpr int kAStride = kBK + 4;  // floats a raw A row takes (spreads the banks)
constexpr int kLdc = kBN + 4;  // floats an output row takes in the epilogue
constexpr int kTileStagesMax = 4;  // slabs of raw codes and A in the cp.async ring

// Codes of one cp.async chunk of the tile's code rows: 8 (u8: 8 bytes;
// u16: 16 bytes) or 4 (u32: 16 bytes).
template <typename T>
__host__ __device__ constexpr int tile_chunk() {
  return sizeof(T) == 4 ? 4 : 8;
}

struct TilePlan {
  int n_tiles;  // grid x
  int cluster;  // grid y: blocks of one cluster, splitting K
  int m_tiles;  // grid z
  bool vec;  // codes and A are loaded by cp.async (else plain loads)
};

TilePlan tile_plan(const void* a, const void* codes, int container_bytes, int m, int k, int n) {
  TilePlan p;
  p.n_tiles = (n + kBN - 1) / kBN;
  p.m_tiles = (m + kBM - 1) / kBM;
  const long long tiles = (long long)p.n_tiles * p.m_tiles;
  const int slabs = (k + kBK - 1) / kBK;
  p.cluster = kClusterMax;  // split K only while the grid stays one wave, 4+ slabs a block
  while (p.cluster > 1 && (tiles * p.cluster > 132 || slabs < p.cluster * 4)) p.cluster /= 2;
  const int chunk = container_bytes == 4 ? 4 : 8;
  const int chunk_bytes = chunk * container_bytes;
  p.vec = n % chunk == 0 && k % 4 == 0 &&
          reinterpret_cast<uintptr_t>(codes) % chunk_bytes == 0 &&
          reinterpret_cast<uintptr_t>(a) % 16 == 0;
  return p;
}

// Shared memory of the tile kernel: the raw ring, two operand buffers (A_hi,
// A_lo, dec(W) and for three passes dec(W)_lo), the row sums.  The
// epilogue's output tile reuses the raw ring.
template <typename T>
__host__ __device__ constexpr size_t tile_raw_bytes() {
  return size_t(kBK) * kBN * sizeof(T) + size_t(kBM) * kAStride * 4;
}
template <int PASSES>
__host__ __device__ constexpr size_t tile_op_bytes() {
  return size_t(2) * kBM * kBK * 4 + size_t(PASSES == 3 ? 2 : 1) * kBN * kBK * 4;
}
constexpr size_t kTileRowSums = size_t(kThreads + kBM) * 4;

// Slabs of raw codes and A in the cp.async ring: as many as fit beside the
// operand buffers, up to kTileStagesMax.
template <typename T, int PASSES>
__host__ __device__ constexpr int tile_stages() {
  const size_t fit =
      (232448 - 1024 - 2 * tile_op_bytes<PASSES>() - kTileRowSums) / tile_raw_bytes<T>();
  return fit < kTileStagesMax ? int(fit) : kTileStagesMax;
}
template <typename T, int PASSES>
__host__ __device__ constexpr size_t tile_smem() {
  return tile_stages<T, PASSES>() * tile_raw_bytes<T>() + 1024 + 2 * tile_op_bytes<PASSES>() +
         kTileRowSums;
}
static_assert(size_t(kBM) * kLdc * 4 <= 3 * tile_raw_bytes<uint8_t>(),
              "the epilogue's tile must fit in the raw ring");

// Float offset of element (row r, k = 4*kq + i) in an operand tile, K-major
// with the 128-byte swizzle: each row is 32 TF32 = 128 bytes, and its
// 16-byte chunk kq sits at chunk kq ^ (r % 8), so the 8 rows of a core matrix
// (8 rows x 16 bytes) fall on 8 different bank groups; 8 rows make a 1 KB
// atom.  (Without the swizzle, row groups 1 KB apart share their banks, and
// the prefill tile measured slower on the H100: PERF.md.)
__device__ __forceinline__ int op_off(int r, int kq) { return r * kBK + ((kq ^ (r & 7)) << 2); }

// wgmma shared-memory descriptor of an operand tile laid out by op_off, its
// atoms 1 KB aligned: start address (a k-step of 8 TF32 moves it 32 bytes
// along the unswizzled row), stride byte offset 1024 (the next 8-row
// group), 128-byte swizzle.
__device__ __forceinline__ uint64_t tile_desc(const float* p) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

__device__ __forceinline__ float tf32_rn(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(x));
  return __uint_as_float(u);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait(float (&d)[44]) {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
#pragma unroll
  for (int i = 0; i < 44; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 88] += A[64 x 8] @ B[8 x 88], both operands in shared memory,
// K-major, no swizzle (tile_desc); f32 accumulator, TF32 operands.
__device__ __forceinline__ void wgmma_m64n88k8(float (&d)[44], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %46, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n88k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43}, "
      "%44, %45, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43])
      : "l"(da), "l"(db), "r"(1));
}

// grid = (n_tiles, cluster, m_tiles); the cluster spans grid y and splits K.
template <typename T, int PASSES, int Y, int Z>
__global__ void __launch_bounds__(kThreads, 1)
    tile_kernel(const float* __restrict__ a, const T* __restrict__ w,
                const float* __restrict__ s_ptr, const float* __restrict__ b_ptr,
                float* __restrict__ out, int m_total, int k_total, int n_total, bool vec,
                omc::Format f) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, wg = tid >> 7;
  const long long n0 = (long long)blockIdx.x * kBN, m0 = (long long)blockIdx.z * kBM;
  const int rank = blockIdx.y, ranks = gridDim.y;
  const int slabs = (k_total + kBK - 1) / kBK;
  const int per = (slabs + ranks - 1) / ranks;
  const int slab0 = min(slabs, rank * per), nslabs = min(slabs, slab0 + per) - slab0;

  constexpr size_t kRaw = tile_raw_bytes<T>();
  constexpr int kRawStages = tile_stages<T, PASSES>();
  static_assert(kRawStages >= 3, "the ring needs three slabs");
  constexpr size_t kCodeBytes = size_t(kBK) * kBN * sizeof(T);
  // the operand buffers, 1 KB aligned (the swizzle's atoms)
  const uint32_t ring_end = smem_addr(smem) + kRawStages * kRaw;
  unsigned char* ops = smem + kRawStages * kRaw + (((ring_end + 1023) & ~1023u) - ring_end);
  float* rs_part = reinterpret_cast<float*>(ops + 2 * tile_op_bytes<PASSES>());  // [2][kBM]
  float* rs_fin = rs_part + kThreads;  // [kBM]

  // slab `i` of this block's into raw stage `stage`, zero-filled past the edges
  auto load = [&](int i, int stage) {
    T* rc = reinterpret_cast<T*>(smem + stage * kRaw);  // [kBK][kBN] codes
    float* ra = reinterpret_cast<float*>(smem + stage * kRaw + kCodeBytes);  // [kBM][kAStride]
    const int kbase = (slab0 + i) * kBK;
    if (vec) {
      constexpr int kChunk = tile_chunk<T>();
      constexpr int kRowChunks = kBN / kChunk;
      for (int c = tid; c < kBK * kRowChunks; c += kThreads) {
        const int r = c / kRowChunks, q = c % kRowChunks;
        const long long gk = kbase + r, gn = n0 + q * kChunk;
        const bool ok = gk < k_total && gn < n_total;
        cp_async<kChunk * int(sizeof(T))>(rc + r * kBN + q * kChunk,
                                          ok ? w + gk * n_total + gn : w, ok);
      }
      for (int c = tid; c < kBM * (kBK / 4); c += kThreads) {
        const int r = c >> 3, q = c & 7;
        const long long gm = m0 + r, gk = kbase + q * 4;
        const bool ok = gm < m_total && gk < k_total;
        cp_async<16>(ra + r * kAStride + q * 4, ok ? a + gm * k_total + gk : a, ok);
      }
    } else {
      for (int c = tid; c < kBK * kBN; c += kThreads) {
        const int r = c / kBN, q = c % kBN;
        const long long gk = kbase + r, gn = n0 + q;
        rc[c] = (gk < k_total && gn < n_total) ? w[gk * n_total + gn] : T(0);
      }
      for (int c = tid; c < kBM * kBK; c += kThreads) {
        const int r = c / kBK, q = c % kBK;
        const long long gm = m0 + r, gk = kbase + q;
        ra[r * kAStride + q] = (gm < m_total && gk < k_total) ? a[gm * k_total + gk] : 0.0f;
      }
    }
  };

  float acc[44];
#pragma unroll
  for (int i = 0; i < 44; ++i) acc[i] = 0.0f;
  float rs = 0.0f;  // row tid % kBM of A, over the k quads this thread converts

#pragma unroll
  for (int st = 0; st < kRawStages - 1; ++st) {
    if (st < nslabs) load(st, st);
    cp_async_commit();
  }
  for (int i = 0; i < nslabs; ++i) {
    cp_async_wait<kRawStages - 2>();  // slab i has landed (this thread's copies)
    __syncthreads();  // ... and everyone's; slab i-1's raw stage is free again
    if (i + kRawStages - 1 < nslabs) load(i + kRawStages - 1, (i + kRawStages - 1) % kRawStages);
    cp_async_commit();

    // convert slab i into operand buffer i % 2 (its wgmmas of slab i-2 are done)
    const unsigned char* raw = smem + (i % kRawStages) * kRaw;
    const T* rc = reinterpret_cast<const T*>(raw);
    const float* ra = reinterpret_cast<const float*>(raw + kCodeBytes);
    float* a_hi = reinterpret_cast<float*>(ops + (i & 1) * tile_op_bytes<PASSES>());
    float* a_lo = a_hi + kBM * kBK;
    float* w_hi = a_lo + kBM * kBK;
    float* w_lo = w_hi + kBN * kBK;  // three passes only
#pragma unroll
    for (int j = 0; j < kBM * (kBK / 4) / kThreads; ++j) {
      const int c = tid + j * kThreads, r = c % kBM, kq = c / kBM;
      const float4 x = *reinterpret_cast<const float4*>(ra + r * kAStride + kq * 4);
      rs += x.x;
      rs += x.y;
      rs += x.z;
      rs += x.w;
      const float4 hi = make_float4(tf32_rn(x.x), tf32_rn(x.y), tf32_rn(x.z), tf32_rn(x.w));
      const float4 lo = make_float4(tf32_rn(x.x - hi.x), tf32_rn(x.y - hi.y),
                                    tf32_rn(x.z - hi.z), tf32_rn(x.w - hi.w));
      *reinterpret_cast<float4*>(a_hi + op_off(r, kq)) = hi;
      *reinterpret_cast<float4*>(a_lo + op_off(r, kq)) = lo;
    }
    for (int c = tid; c < kBN * (kBK / 4); c += kThreads) {
      const int n = c % kBN, kq = c / kBN;
      float v[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        v[kk] = omc::decode_fast<Y, Z>(rc[(kq * 4 + kk) * kBN + n], f);
      }
      if (PASSES == 3) {
        const float4 hi = make_float4(tf32_rn(v[0]), tf32_rn(v[1]), tf32_rn(v[2]), tf32_rn(v[3]));
        *reinterpret_cast<float4*>(w_hi + op_off(n, kq)) = hi;
        *reinterpret_cast<float4*>(w_lo + op_off(n, kq)) =
            make_float4(tf32_rn(v[0] - hi.x), tf32_rn(v[1] - hi.y), tf32_rn(v[2] - hi.z),
                        tf32_rn(v[3] - hi.w));
      } else {  // dec(W) is exact in TF32
        *reinterpret_cast<float4*>(w_hi + op_off(n, kq)) = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    __syncthreads();

    // this warpgroup's 64 rows: A_lo@dec + A_hi@dec (+ A_hi@dec_lo), 4 k-steps
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 8; ++ks) {
      const int off = wg * 64 * kBK + ks * 8;  // row 64*wg, k-step ks
      const uint64_t dw = tile_desc(w_hi + ks * 8);
      wgmma_m64n88k8(acc, tile_desc(a_lo + off), dw);
      wgmma_m64n88k8(acc, tile_desc(a_hi + off), dw);
      if (PASSES == 3) {
        wgmma_m64n88k8(acc, tile_desc(a_hi + off), tile_desc(w_lo + ks * 8));
      }
    }
    wgmma_commit();
    wgmma_wait<1>(acc);  // slab i-1's products are done: its buffer is free
  }
  wgmma_wait<0>(acc);
  cp_async_wait<0>();
  __syncthreads();  // the raw ring is free: reuse it for the output tile

  // the accumulator fragments into the block's tile [kBM][kLdc]
  float* tile = reinterpret_cast<float*>(smem);
  const int lane = tid & 31;
  const int r0 = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int c0 = 8 * j + 2 * (lane & 3);
    tile[r0 * kLdc + c0] = acc[4 * j];
    tile[r0 * kLdc + c0 + 1] = acc[4 * j + 1];
    tile[(r0 + 8) * kLdc + c0] = acc[4 * j + 2];
    tile[(r0 + 8) * kLdc + c0 + 1] = acc[4 * j + 3];
  }
  rs_part[tid] = rs;  // [tid / kBM][tid % kBM]
  __syncthreads();
  if (tid < kBM) rs_fin[tid] = rs_part[tid] + rs_part[tid + kBM];
  cluster.sync();  // every block's tile is ready to be read by its peers

  // the cluster's blocks summed in rank order; each block writes a share of rows
  const float s = *s_ptr, b = *b_ptr;
  const int rows = kBM / ranks, rbase = rank * rows;
  for (int o = tid; o < rows * kBN; o += kThreads) {
    const int r = rbase + o / kBN, c = o % kBN;
    const long long gm = m0 + r, gn = n0 + c;
    if (gm >= m_total || gn >= n_total) continue;
    float v = 0.0f, rsum = 0.0f;
    for (int q = 0; q < ranks; ++q) {
      v += cluster.map_shared_rank(tile, q)[r * kLdc + c];
      rsum += cluster.map_shared_rank(rs_fin, q)[r];
    }
    out[gm * n_total + gn] = fmaf(s, v, b * rsum);
  }
  cluster.sync();  // keep this block's shared memory until its peers are done
}

template <typename T, int PASSES, int Y, int Z>
cudaError_t launch_tile(const float* a, const T* w, const float* s, const float* b, float* out,
                        int m, int k, int n, const TilePlan& p, const omc::Format& f,
                        cudaStream_t stream) {
  const dim3 grid{unsigned(p.n_tiles), unsigned(p.cluster), unsigned(p.m_tiles)};
  static bool raised[64] = {};
  return launch_clustered(tile_kernel<T, PASSES, Y, Z>, raised, tile_smem<T, PASSES>(), grid,
                          p.cluster, tile_smem<T, PASSES>(), stream, a, w, s, b, out, m, k, n,
                          p.vec, f);
}

// ---------------------------------------------------------------------------
// dispatch
// ---------------------------------------------------------------------------

// The kernel's variant for a format: its decode (kCodecS1E3M7, the serve
// format compiled in, for S1E3M7 in u16; else kCodecRuntime, the format's
// fields read at run time) and the tile path's TF32 passes (2 where every
// decoded value is exact in TF32, <= 10 mantissa bits; else 3).
constexpr int kCodecRuntime = 0, kCodecS1E3M7 = 1;
void variant(int container_bytes, int exp_bits, int mant_bits, int* codec, int* passes) {
  *codec = container_bytes == 2 && exp_bits == 3 && mant_bits == 7 ? kCodecS1E3M7
                                                                    : kCodecRuntime;
  *passes = mant_bits <= 10 ? 2 : 3;
}

template <typename T, int Y, int Z>
cudaError_t run(const float* a, const void* codes, const float* s, const float* b, float* out,
                int m, int k, int n, const omc::Format& f, int passes, cudaStream_t stream) {
  const T* w = static_cast<const T*>(codes);
  StreamPlan sp;
  if (stream_plan(codes, sizeof(T), m, k, n, &sp)) {
    return launch_stream<T, Y, Z>(a, w, s, b, out, m, k, n, sp, f, stream);
  }
  const TilePlan tp = tile_plan(a, codes, sizeof(T), m, k, n);
  if constexpr (sizeof(T) >= 2 && Y == 0) {
    if (passes == 3) return launch_tile<T, 3, Y, Z>(a, w, s, b, out, m, k, n, tp, f, stream);
  }
  return launch_tile<T, 2, Y, Z>(a, w, s, b, out, m, k, n, tp, f, stream);
}

}  // namespace

extern "C" {

// The path this product takes: 1 (weight stream) or 2 (tile), its grid and
// the kernel's variant in plan[5]: (column tiles, cluster, code vectors per
// warp row) for the stream, (column tiles, cluster, row tiles) for the tile,
// then the codec (0 run time, 1 S1E3M7) and the tile path's TF32 passes.
int omc_dequant_matmul_plan(const void* a, const void* codes, int container_bytes, int exp_bits,
                            int mant_bits, int m, int k, int n, int* plan) {
  variant(container_bytes, exp_bits, mant_bits, &plan[3], &plan[4]);
  StreamPlan sp;
  if (stream_plan(codes, container_bytes, m, k, n, &sp)) {
    plan[0] = sp.col_tiles;
    plan[1] = sp.cluster;
    plan[2] = 1 << sp.cw_log2;
    return 1;
  }
  const TilePlan tp = tile_plan(a, codes, container_bytes, m, k, n);
  plan[0] = tp.n_tiles;
  plan[1] = tp.cluster;
  plan[2] = tp.m_tiles;
  return 2;
}

// a [m, k] f32, codes [k, n] in a container of container_bytes, one (s, b)
// pair as device f32 scalars, out [m, n] f32; all contiguous.  The decode
// and the tile path's passes follow from the format (variant).
int omc_dequant_matmul(const void* a, const void* codes, int container_bytes, const void* s,
                       const void* b, void* out, int m, int k, int n, int exp_bits, int mant_bits,
                       void* stream) {
  if (m < 0 || k < 0 || n < 0 || exp_bits < 2 || exp_bits > 8 || mant_bits < 1 ||
      mant_bits > 23 || 1 + exp_bits + mant_bits > 8 * container_bytes) {
    return int(cudaErrorInvalidValue);
  }
  if (m == 0 || n == 0) return int(cudaGetLastError());
  int codec = 0, passes = 0;
  variant(container_bytes, exp_bits, mant_bits, &codec, &passes);
  const omc::Format f = omc::make_format(exp_bits, mant_bits);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ap = static_cast<const float*>(a);
  const float* sp = static_cast<const float*>(s);
  const float* bp = static_cast<const float*>(b);
  float* o = static_cast<float*>(out);
  cudaError_t err = cudaErrorInvalidValue;
  if (codec == kCodecS1E3M7) {
    err = run<uint16_t, 3, 7>(ap, codes, sp, bp, o, m, k, n, f, passes, st);
  } else {
    switch (container_bytes) {
      case 1: err = run<uint8_t, 0, 0>(ap, codes, sp, bp, o, m, k, n, f, passes, st); break;
      case 2: err = run<uint16_t, 0, 0>(ap, codes, sp, bp, o, m, k, n, f, passes, st); break;
      case 4: err = run<uint32_t, 0, 0>(ap, codes, sp, bp, o, m, k, n, f, passes, st); break;
      default: break;
    }
  }
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

}  // extern "C"
