// K7: best-2 squared-L2 descriptor matching.
//
// Replaces sift_pyocl_tpu/ops/pallas/matchk.py::best2_l2_pallas.  For each
// query row a of desc1 (u8, 128 bytes) over the columns b of desc2 (u8):
//   dist = |a|^2 + |b|^2 - 2 a.b   (+inf for a column with valid2 false)
//   d1 = min dist, i1 = the LOWEST column holding d1,
//   d2 = min over every column but i1 (so a tie at the minimum gives d2 == d1).
// With u8 operands a.b <= 128*255^2 = 8,323,200 and |a|^2 + |b|^2 < 2^24, so
// the int32 sums below are exact and convert to f32 exactly: the results are
// bit-identical to the plain f32 version.  A row whose valid1 is false
// returns (0, 0, 0) without being computed (every caller masks it).  There
// is no cap on N2 (the TPU's MAX_N2 = 8192 is a VMEM bound).
//
// What bounds it on the card: integer operations, 128 byte products per
// (query, column) pair -- 4.4 G for 8320 x 2048 -- which the int8 tensor
// cores would do in a few microseconds; its bytes (about 1.3 MB) matter
// less.  This first version uses __dp4a on packed bytes (4 products per
// instruction), not the tensor cores.
//
// Design: a block of 8 warps owns 8 query rows, one row per warp, held in
// registers (32 packed words, the same in every lane).  It walks desc2 in
// tiles of CT columns staged in shared memory (one 33-word row per column,
// so the 32 lanes read 32 banks), with each column's |b|^2 (or -1 for an
// invalid column) beside it.  Lane l takes columns l, l+32, ... of the tile
// in ascending order and keeps a running (best, index, second).  The 32
// lanes' partials are then merged with shuffles by the rule
//   other best lower, or equal at a lower index -> other wins and
//     second = min(own best, other second);
//   else second = min(own second, other best),
// which keeps "second excludes only the argmin column" exact.  With few
// query rows (the VO step's 256 spawn rows) the grid is small: every block
// walks all of desc2.
//
// K7f, the f32-operand form of the same TPU kernel (matchk.py:73-78,
// 136-141): the same function with f32 descriptors (or mixed u8/f32, which
// the wrapper casts to f32, as the JAX wrapper does), distances
// max((|a|^2 + |b|^2) - 2 a.b, 0) in f32.  Plain CUDA-core f32, no tensor
// cores (so no TF32), each sum over k = 0..127 in ascending order with one
// rounding per operation: the results differ from the plain version's
// matmul only by its summation order.  Bound by f32 operations (2 x 128 a
// pair: 0.01 ms for 1390 valid rows x 2048 columns at 67 TFLOP/s).  Design
// as the u8 kernel: 8 query rows a block, one a warp, skipped when valid1
// is false; the rows sit in shared memory and every lane reads the same
// word (a broadcast); desc2 is staged in tiles of CTF columns with a
// 129-float row pitch, so lane l reads bank (l + k) % 32; lane l takes
// columns l and l + 32 of each tile, and the lanes merge as above.
#include "common.cuh"

#include <math_constants.h>

namespace {

constexpr int ROWS = 8;     // query rows (warps) per block
constexpr int CT = 256;     // desc2 columns per shared-memory tile
constexpr int WORDS = 32;   // 128 bytes = 32 packed words
constexpr int LD = WORDS + 1;

struct Best2 {
  float best;
  int idx;
  float second;
};

__device__ __forceinline__ void merge(Best2& a, float ob, int oi, float os) {
  if (ob < a.best || (ob == a.best && oi < a.idx)) {
    a.second = fminf(a.best, os);
    a.best = ob;
    a.idx = oi;
  } else {
    a.second = fminf(a.second, ob);
  }
}

__global__ void __launch_bounds__(ROWS * 32)
best2_l2_kernel(const unsigned* __restrict__ d1w, const unsigned* __restrict__ d2w,
                const unsigned char* __restrict__ valid1,
                const unsigned char* __restrict__ valid2, int n1, int n2,
                float* __restrict__ out_d1, float* __restrict__ out_d2,
                int* __restrict__ out_i1) {
  __shared__ unsigned tile[CT * LD];
  __shared__ int tnorm[CT];
  __shared__ int any_active;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * ROWS + warp;
  const bool active = row < n1 && (valid1 == nullptr || valid1[row] != 0);
  if (threadIdx.x == 0) any_active = 0;
  __syncthreads();
  if (active && lane == 0) any_active = 1;
  __syncthreads();
  if (!active) {
    if (row < n1 && lane == 0) {
      out_d1[row] = 0.0f;
      out_d2[row] = 0.0f;
      out_i1[row] = 0;
    }
    if (!any_active) return;
  }
  unsigned a[WORDS];
  unsigned na = 0u;
#pragma unroll
  for (int w = 0; w < WORDS; ++w) {
    a[w] = active ? __ldg(d1w + static_cast<size_t>(row) * WORDS + w) : 0u;
    na = __dp4a(a[w], a[w], na);
  }
  Best2 st = {CUDART_INF_F, 0x7fffffff, CUDART_INF_F};
  for (int t0 = 0; t0 < n2; t0 += CT) {
    const int nt = min(CT, n2 - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < nt * WORDS; i += ROWS * 32) {
      const int col = i / WORDS, w = i % WORDS;
      tile[col * LD + w] = __ldg(d2w + static_cast<size_t>(t0 + col) * WORDS + w);
    }
    __syncthreads();
    for (int col = threadIdx.x; col < nt; col += ROWS * 32) {
      unsigned nb = 0u;
#pragma unroll
      for (int w = 0; w < WORDS; ++w) nb = __dp4a(tile[col * LD + w], tile[col * LD + w], nb);
      tnorm[col] = valid2[t0 + col] ? static_cast<int>(nb) : -1;
    }
    __syncthreads();
    if (!active) continue;
    for (int col = lane; col < nt; col += 32) {
      const unsigned* b = tile + col * LD;
      unsigned ab = 0u;
#pragma unroll
      for (int w = 0; w < WORDS; ++w) ab = __dp4a(a[w], b[w], ab);
      const int nb = tnorm[col];
      const float v = nb < 0 ? CUDART_INF_F
                             : static_cast<float>(na + static_cast<unsigned>(nb) - 2u * ab);
      merge(st, v, t0 + col, CUDART_INF_F);
    }
  }
  if (!active) return;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, st.best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, st.idx, off);
    const float os = __shfl_xor_sync(0xffffffffu, st.second, off);
    merge(st, ob, oi, os);
  }
  if (lane == 0) {
    out_d1[row] = st.best;
    out_d2[row] = st.second;
    out_i1[row] = st.idx;
  }
}

constexpr int CTF = 64;     // desc2 columns per f32 tile
constexpr int DIM = 128;
constexpr int LDF = DIM + 1;

__global__ void __launch_bounds__(ROWS * 32)
best2_l2_f32_kernel(const float* __restrict__ d1f, const float* __restrict__ d2f,
                    const unsigned char* __restrict__ valid1,
                    const unsigned char* __restrict__ valid2, int n1, int n2,
                    float* __restrict__ out_d1, float* __restrict__ out_d2,
                    int* __restrict__ out_i1) {
  __shared__ float tile[CTF * LDF];
  __shared__ float arow[ROWS][DIM];
  __shared__ float tnorm[CTF];
  __shared__ int any_active;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * ROWS + warp;
  const bool active = row < n1 && (valid1 == nullptr || valid1[row] != 0);
  if (threadIdx.x == 0) any_active = 0;
  __syncthreads();
  if (active && lane == 0) any_active = 1;
  __syncthreads();
  if (!active) {
    if (row < n1 && lane == 0) {
      out_d1[row] = 0.0f;
      out_d2[row] = 0.0f;
      out_i1[row] = 0;
    }
    if (!any_active) return;
  }
  for (int k = lane; k < DIM; k += 32)
    arow[warp][k] = active ? __ldg(d1f + static_cast<size_t>(row) * DIM + k) : 0.0f;
  __syncwarp();
  float na = 0.0f;
  for (int k = 0; k < DIM; ++k) na += arow[warp][k] * arow[warp][k];
  Best2 st = {CUDART_INF_F, 0x7fffffff, CUDART_INF_F};
  for (int t0 = 0; t0 < n2; t0 += CTF) {
    const int nt = min(CTF, n2 - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < nt * DIM; i += ROWS * 32) {
      const int col = i / DIM, k = i % DIM;
      tile[col * LDF + k] = __ldg(d2f + static_cast<size_t>(t0 + col) * DIM + k);
    }
    __syncthreads();
    for (int col = threadIdx.x; col < nt; col += ROWS * 32) {
      const float* b = tile + col * LDF;
      float nb = 0.0f;
      for (int k = 0; k < DIM; ++k) nb += b[k] * b[k];
      tnorm[col] = valid2[t0 + col] ? nb : -1.0f;
    }
    __syncthreads();
    if (!active) continue;
    for (int col = lane; col < nt; col += 32) {
      const float* b = tile + col * LDF;
      const float* a = arow[warp];
      float ab = 0.0f;
#pragma unroll 8
      for (int k = 0; k < DIM; ++k) ab += a[k] * b[k];
      const float nb = tnorm[col];
      const float v = nb < 0.0f ? CUDART_INF_F : fmaxf((na + nb) - 2.0f * ab, 0.0f);
      merge(st, v, t0 + col, CUDART_INF_F);
    }
  }
  if (!active) return;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, st.best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, st.idx, off);
    const float os = __shfl_xor_sync(0xffffffffu, st.second, off);
    merge(st, ob, oi, os);
  }
  if (lane == 0) {
    out_d1[row] = st.best;
    out_d2[row] = st.second;
    out_i1[row] = st.idx;
  }
}

}  // namespace

// desc1: (n1, 128) u8, desc2: (n2, 128) u8, both 16-byte aligned rows;
// valid1: (n1,) u8 or null (every row computed); valid2: (n2,) u8.
// Outputs (n1,) f32 d1, f32 d2, int32 i1.
extern "C" int sift_best2_l2(const void* desc1, const void* desc2, const void* valid1,
                             const void* valid2, int n1, int n2, void* d1, void* d2, void* i1,
                             void* stream) {
  if (n1 < 0 || n2 < 1) return cudaErrorInvalidValue;
  if (n1 == 0) return cudaSuccess;
  best2_l2_kernel<<<(n1 + ROWS - 1) / ROWS, ROWS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(desc1), static_cast<const unsigned*>(desc2),
      static_cast<const unsigned char*>(valid1), static_cast<const unsigned char*>(valid2), n1,
      n2, static_cast<float*>(d1), static_cast<float*>(d2), static_cast<int*>(i1));
  return static_cast<int>(cudaGetLastError());
}

// K7f.  desc1: (n1, 128) f32, desc2: (n2, 128) f32, contiguous; the rest as
// sift_best2_l2.
extern "C" int sift_best2_l2_f32(const void* desc1, const void* desc2, const void* valid1,
                                 const void* valid2, int n1, int n2, void* d1, void* d2,
                                 void* i1, void* stream) {
  if (n1 < 0 || n2 < 1) return cudaErrorInvalidValue;
  if (n1 == 0) return cudaSuccess;
  best2_l2_f32_kernel<<<(n1 + ROWS - 1) / ROWS, ROWS * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(desc1), static_cast<const float*>(desc2),
      static_cast<const unsigned char*>(valid1), static_cast<const unsigned char*>(valid2), n1,
      n2, static_cast<float*>(d1), static_cast<float*>(d2), static_cast<int*>(i1));
  return static_cast<int>(cudaGetLastError());
}
