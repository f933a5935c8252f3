// Shared helpers of the SIFT kernels (built for sm_90a, plain C interface).
#pragma once

#include <cuda_runtime.h>

// Entries (octaves, over every frame of a batch) a multi-octave launch
// takes; the per-entry tables travel by value in the kernel's parameter
// block, which holds at most 4 KB: at 64 the largest (K8's MaskMeta) is
// about 2.3 KB.  A batch of 8 frames at 1080x1920 (56 entries) is one
// launch; the wrappers split a longer entry list into launches of at most
// this many entries (ops/_build.py::entry_chunks, MAX_ENTRIES).
#define SIFT_MAX_OCT 64

// The strong DoG extremum test of oracle.local_maxmin, run by the extrema
// mask tile body (extrema_tile.cuh) that K8, K1m and K2m share.
// n[p][y][x] holds DoG planes s-1..s+1, rows r-1..r+1 and columns c-1..c+1
// around the tested value v = n[1][1][1].  True iff |v| >
// strong_thresh (0.8 peak_thresh), v is strictly greater (or strictly
// smaller) than all 26 neighbours, and the 2x2 spatial Hessian of plane s
// passes det > 0 and det >= (eth*tr)*tr.  Every sum follows the plain
// PyTorch stencil (ops/kernels/maskk.py) operation by operation; the library
// is built with --fmad=false, so the two agree bit for bit.
__device__ __forceinline__ bool sift_is_extremum(const float (&n)[3][3][3],
                                                 float strong_thresh, float eth) {
  const float v = n[1][1][1];
  bool is_max = true, is_min = true;
#pragma unroll
  for (int p = 0; p < 3; ++p) {
#pragma unroll
    for (int y = 0; y < 3; ++y) {
#pragma unroll
      for (int x = 0; x < 3; ++x) {
        if (p == 1 && y == 1 && x == 1) continue;
        is_max = is_max && v > n[p][y][x];
        is_min = is_min && v < n[p][y][x];
      }
    }
  }
  const bool strong = fabsf(v) > strong_thresh;
  const float (&m)[3][3] = n[1];
  const float hxx = (m[1][0] + m[1][2]) - 2.0f * v;
  const float hyy = (m[0][1] + m[2][1]) - 2.0f * v;
  const float hxy = 0.25f * (((m[2][2] - m[2][0]) - m[0][2]) + m[0][0]);
  const float det = hxx * hyy - hxy * hxy;
  const float tr = hxx + hyy;
  const bool not_edge = det > 0.0f && det >= (eth * tr) * tr;
  return strong && (is_max || is_min) && not_edge;
}

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
