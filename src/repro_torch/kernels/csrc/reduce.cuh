// Deterministic block reductions shared by the kernels that return PVT sums
// (quantize_stats in quantize.cu, fused_aggregate in agg.cu).
//
// A kernel writes one [4] partial per block into a [entries, blocks, 4]
// scratch; each entry's partials are then summed in a fixed order, by
// reduce_partials_kernel in a second launch (quantize_stats) or by the
// entry's last block in the same order (fused_aggregate).  No float
// atomics, so the sums, and the (s, b) solved from them, are the same from
// run to run.
#pragma once

#include <cuda_runtime.h>

namespace omc {

constexpr int kReduceThreads = 256;

// Sum of four values over a block of kReduceThreads threads; the result is
// valid in thread 0.  The order is fixed by the block shape alone.
__device__ __forceinline__ void block_sum4(float a[4]) {
  __shared__ float warp_sums[kReduceThreads / 32][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    for (int off = 16; off > 0; off >>= 1) a[j] += __shfl_down_sync(0xFFFFFFFFu, a[j], off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) warp_sums[warp][j] = a[j];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a[j] = lane < kReduceThreads / 32 ? warp_sums[lane][j] : 0.0f;
      for (int off = 16; off > 0; off >>= 1) a[j] += __shfl_down_sync(0xFFFFFFFFu, a[j], off);
    }
  }
}

// grid = entries, block = kReduceThreads; partials [entries, blocks, 4] ->
// sums [entries, 4].  static: each source that includes this header gets
// its own copy, so the library links without duplicate symbols.
static __global__ void reduce_partials_kernel(const float* __restrict__ partials,
                                       float* __restrict__ sums, long long blocks) {
  const float* p = partials + (long long)blockIdx.x * blocks * 4;
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (long long i = threadIdx.x; i < blocks; i += kReduceThreads) {
#pragma unroll
    for (int j = 0; j < 4; ++j) a[j] += p[i * 4 + j];
  }
  block_sum4(a);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) sums[blockIdx.x * 4 + j] = a[j];
  }
}

}  // namespace omc
