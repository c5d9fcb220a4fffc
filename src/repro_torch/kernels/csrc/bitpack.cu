// Exact-width wire bitstream pack / unpack for Hopper (sm_90a).
//
// pack replaces src/repro/kernels/bitpack.py::pack (the Pallas kernel of
// bitpack.py:96) and unpack replaces bitpack.py::unpack (bitpack.py:120).
// The stream is the canonical one of repro_torch/core/packing.py: field i of
// width w starts at bit i*w, little-endian within uint32 words, zero tail.
//
//   Bound: bytes.  pack reads n container codes and writes ceil(n*w/32)
//   words; unpack the reverse: n*container_bytes + 4*ceil(n*w/32) bytes.
//   Design: the TPU kernel unrolls a static field->(word, shift) map over
//   lcm(32, w)-bit superblocks.  Here the work is gather-only: pack runs one
//   thread per output word, which ORs in the fields
//   i in [floor(32j/w), floor((32j+31)/w)] (no scatter, no atomics);
//   unpack runs one thread per field, reading its word and the next one.
//   Bit offsets are 64-bit: n*w reaches 8.9e9 for qwen2.5-3b's stacked MLP
//   weights, past what a uint32 offset can hold.
#include "minifloat.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void pack_kernel(const T* __restrict__ codes, uint32_t* __restrict__ words,
                            long long n, long long nwords, int w) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < nwords; j += stride) {
    const long long first = (j * 32) / w;
    long long last = (j * 32 + 31) / w;
    if (last > n - 1) last = n - 1;
    uint32_t acc = 0u;
    for (long long i = first; i <= last; ++i) {
      const uint32_t field = uint32_t(codes[i]);
      const long long off = i * w;
      const int sh = int(off & 31);
      if ((off >> 5) == j) {
        acc |= field << sh;                // low part: starts in word j
      } else {
        acc |= (field >> (31 - sh)) >> 1;  // high part: started in word j-1
      }
    }
    words[j] = acc;
  }
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

int omc_pack(const void* codes, int container_bytes, void* words, long long n,
             long long nwords, int width, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint32_t* wp = static_cast<uint32_t*>(words);
  if (width < 1 || width > 32 || width > 8 * container_bytes) return int(cudaErrorInvalidValue);
  if (nwords <= 0) return int(cudaGetLastError());
  const unsigned grid = omc::grid_for(nwords, kThreads);
  switch (container_bytes) {
    case 1:
      pack_kernel<uint8_t><<<grid, kThreads, 0, st>>>(static_cast<const uint8_t*>(codes), wp, n,
                                                       nwords, width);
      break;
    case 2:
      pack_kernel<uint16_t><<<grid, kThreads, 0, st>>>(static_cast<const uint16_t*>(codes), wp,
                                                        n, nwords, width);
      break;
    case 4:
      pack_kernel<uint32_t><<<grid, kThreads, 0, st>>>(static_cast<const uint32_t*>(codes), wp,
                                                        n, nwords, width);
      break;
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
