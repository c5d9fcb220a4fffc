// Exact-width wire bitstream pack / unpack for Hopper (sm_90a).
//
// pack replaces src/repro/kernels/bitpack.py::pack (the Pallas kernel of
// bitpack.py:96) and unpack replaces bitpack.py::unpack (bitpack.py:120).
// The stream is the canonical one of repro_torch/core/packing.py: field i of
// width w starts at bit i*w, little-endian within uint32 words, zero tail.
//
//   Bound: bytes.  pack reads n container codes and writes ceil(n*w/32)
//   words; unpack the reverse: n*container_bytes + 4*ceil(n*w/32) bytes.
//
// pack.  32 fields of w bits fill exactly w words (a superblock), so a
// superblock's field -> (word, shift) map is fixed by w alone.  The width is
// a template parameter (u8: 1-8, u16: 1-16, u32: 1-32; the C entry picks the
// kernel from a table), so that map unrolls into constant shifts and ORs:
// no division, no data-dependent loop.  A block of 256 threads packs a tile
// of 256 superblocks (8192 fields), whose output, 1024*w bytes, starts on a
// 16-byte boundary:
//   1. the tile's codes come in with coalesced 16-byte cp.async copies into
//      shared memory (no registers on the way; as fast as plain 16-byte
//      loads for u8 and u16 codes, faster for u32: bench_pack_agg.py), each
//      chunk in a slot XOR-swizzled by its superblock, so that step 2 reads
//      without bank conflicts;
//   2. each thread takes one superblock's 32 codes from shared memory (16
//      bytes at a time) and ORs them into its w words in registers;
//   3. the words go back into shared memory (index p + p/32: no two lanes of
//      a warp on one bank for most w), and the block writes the tile's
//      words with 16-byte stores.
// Offsets inside a tile are 32-bit; only the tile's base is 64-bit (the
// stacked w1 leaf of qwen2.5-3b passes bit 2**32).  The last tile is the
// same kernel with bounds: fields past n read as zero, words past the
// stream's end are not written.  Unaligned codes or words take scalar loads
// or stores in the same kernel.
//
// unpack runs one thread per field, reading its word and the next one.
#include <array>
#include <utility>

#include "minifloat.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileSuper = kThreads;         // pack: one superblock a thread
constexpr int kTileFields = 32 * kTileSuper;  // 8192 fields a tile

// The slot of chunk q of superblock sb: K = 2 * sizeof(T) chunks of 16 bytes
// a superblock.  A quarter-warp reads 8 superblocks' chunk q at once; the XOR
// spreads them over the 8 four-bank groups of a 128-byte row.
template <int K>
__device__ __forceinline__ int chunk_slot(int sb, int q) {
  return sb * K + (q ^ ((sb / (8 / K)) % K));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared memory of one tile, in words: the codes (8192 * sizeof(T) bytes),
// then, in the same buffer, the padded words (256 * W + 8 * W).
template <typename T, int W>
__host__ __device__ constexpr int pack_smem_words() {
  constexpr int in = kTileFields * int(sizeof(T)) / 4, out = kTileSuper * W + 8 * W;
  return in > out ? in : out;
}

template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
    pack_kernel(const T* __restrict__ codes, uint32_t* __restrict__ words, long long n,
                long long nwords, bool vec_in, bool vec_out) {
  constexpr int K = 2 * int(sizeof(T));      // 16-byte chunks of a superblock
  constexpr int PER = 16 / int(sizeof(T));   // codes of a chunk
  __shared__ __align__(16) uint32_t smem[pack_smem_words<T, W>()];
  uint4* chunks = reinterpret_cast<uint4*>(smem);
  const long long field0 = (long long)blockIdx.x * kTileFields;
  const long long word0 = (long long)blockIdx.x * (kTileSuper * W);
  const long long left = n - field0;
  const int fields = left < kTileFields ? int(left) : kTileFields;
  const T* src = codes + field0;

  // 1. codes -> shared memory, coalesced
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int g = threadIdx.x + i * kThreads;  // chunk of the tile
    const int f0 = g * PER;
    uint4* slot = chunks + chunk_slot<K>(g / K, g % K);
    if (vec_in && f0 + PER <= fields) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(slot)),
                   "l"(src + f0));
    } else {
      union {
        uint4 v;
        T e[PER];
      } u;
#pragma unroll
      for (int k = 0; k < PER; ++k) u.e[k] = f0 + k < fields ? src[f0 + k] : T(0);
      *slot = u.v;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // 2. one superblock a thread: 32 codes -> W words
  const int sb = threadIdx.x;
  uint4 mine[K];
#pragma unroll
  for (int q = 0; q < K; ++q) mine[q] = chunks[chunk_slot<K>(sb, q)];
  __syncthreads();  // the words reuse the buffer
  const T* c = reinterpret_cast<const T*>(mine);
  uint32_t acc[W];
#pragma unroll
  for (int r = 0; r < W; ++r) acc[r] = 0u;
#pragma unroll
  for (int f = 0; f < 32; ++f) {
    const uint32_t v = uint32_t(c[f]);
    const int bit = f * W, wi = bit >> 5, sh = bit & 31;
    acc[wi] |= v << sh;
    if (sh + W > 32) acc[wi + 1] |= v >> (32 - sh);  // wi + 1 < W: the last field ends word W-1
  }
#pragma unroll
  for (int r = 0; r < W; ++r) {
    const int p = sb * W + r;
    smem[p + (p >> 5)] = acc[r];
  }
  __syncthreads();

  // 3. the tile's words -> device memory, 16 bytes a store
  const long long wleft = nwords - word0;
  const int tw = wleft < kTileSuper * W ? int(wleft) : kTileSuper * W;
  uint32_t* dst = words + word0;
  for (int v4 = threadIdx.x; 4 * v4 < tw; v4 += kThreads) {
    uint32_t o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = 4 * v4 + k;
      o[k] = smem[p + (p >> 5)];
    }
    if (vec_out && 4 * v4 + 4 <= tw) {
      *reinterpret_cast<uint4*>(dst + 4 * v4) = make_uint4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (4 * v4 + k < tw) dst[4 * v4 + k] = o[k];
      }
    }
  }
}

template <typename T>
using PackKernel = void (*)(const T*, uint32_t*, long long, long long, bool, bool);

// pack_kernel<T, 1> .. pack_kernel<T, 8 * sizeof(T)>, indexed by width - 1.
template <typename T, int... I>
std::array<PackKernel<T>, sizeof...(I)> pack_kernels(std::integer_sequence<int, I...>) {
  return {&pack_kernel<T, I + 1>...};
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
void launch_pack(const void* codes, uint32_t* words, long long n, long long nwords, int width,
                 cudaStream_t stream) {
  static const auto kernels =
      pack_kernels<T>(std::make_integer_sequence<int, 8 * int(sizeof(T))>{});
  const long long tiles = (n + kTileFields - 1) / kTileFields;
  kernels[width - 1]<<<unsigned(tiles), kThreads, 0, stream>>>(
      static_cast<const T*>(codes), words, n, nwords, aligned16(codes), aligned16(words));
}

template <typename T>
__global__ void unpack_kernel(const uint32_t* __restrict__ words, long long nwords,
                              T* __restrict__ out, long long n, int w) {
  const uint32_t mask = w < 32 ? ((1u << w) - 1u) : 0xFFFFFFFFu;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const long long off = i * w;
    const long long word = off >> 5;
    const int sh = int(off & 31);
    const uint32_t lo = words[word] >> sh;
    const uint32_t next = word + 1 < nwords ? words[word + 1] : 0u;
    const uint32_t hi = (next << (31 - sh)) << 1;
    out[i] = T((lo | hi) & mask);
  }
}

}  // namespace

extern "C" {

// pack's tiling for n fields: {fields a tile, words a full tile, tiles}.
int omc_pack_plan(long long n, int width, int container_bytes, long long* plan) {
  if (width < 1 || width > 32 || width > 8 * container_bytes || n < 0) {
    return int(cudaErrorInvalidValue);
  }
  plan[0] = kTileFields;
  plan[1] = (long long)kTileSuper * width;
  plan[2] = (n + kTileFields - 1) / kTileFields;
  return 0;
}

int omc_pack(const void* codes, int container_bytes, void* words, long long n,
             long long nwords, int width, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint32_t* wp = static_cast<uint32_t*>(words);
  if (width < 1 || width > 32 || width > 8 * container_bytes) return int(cudaErrorInvalidValue);
  if (nwords != (n * width + 31) / 32 || (n + kTileFields - 1) / kTileFields > 0x7FFFFFFFLL) {
    return int(cudaErrorInvalidValue);
  }
  if (nwords <= 0) return int(cudaGetLastError());
  switch (container_bytes) {
    case 1: launch_pack<uint8_t>(codes, wp, n, nwords, width, st); break;
    case 2: launch_pack<uint16_t>(codes, wp, n, nwords, width, st); break;
    case 4: launch_pack<uint32_t>(codes, wp, n, nwords, width, st); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

int omc_unpack(const void* words, long long nwords, void* out, int container_bytes, long long n,
               int width, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* wp = static_cast<const uint32_t*>(words);
  if (width < 1 || width > 32 || width > 8 * container_bytes) return int(cudaErrorInvalidValue);
  if (n <= 0) return int(cudaGetLastError());
  const unsigned grid = omc::grid_for(n, kThreads);
  switch (container_bytes) {
    case 1:
      unpack_kernel<uint8_t><<<grid, kThreads, 0, st>>>(wp, nwords, static_cast<uint8_t*>(out), n,
                                                         width);
      break;
    case 2:
      unpack_kernel<uint16_t><<<grid, kThreads, 0, st>>>(wp, nwords,
                                                          static_cast<uint16_t*>(out), n, width);
      break;
    case 4:
      unpack_kernel<uint32_t><<<grid, kThreads, 0, st>>>(wp, nwords,
                                                          static_cast<uint32_t*>(out), n, width);
      break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

}  // extern "C"
