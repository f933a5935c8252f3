// Shared helpers of the SIFT kernels (built for sm_90a, plain C interface).
#pragma once

#include <cuda_runtime.h>

// Octaves a multi-octave launch takes; the per-octave tables travel by
// value in the kernel's parameter block.
#define SIFT_MAX_OCT 32

// Exclusive prefix sum of `v` over the block; *total receives the block's
// sum.  blockDim.x must be a multiple of 32 and at most 1024, and every
// thread of the block must call it (it synchronises).
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < nwarps) warp_sums[lane] = w;
  }
  __syncthreads();
  const int before = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[nwarps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return before + x - v;
}
