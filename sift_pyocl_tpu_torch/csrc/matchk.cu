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
// What bounds it on the card: neither bytes (about 1.3 MB a VO call, 0.4
// us) nor operations (2 x 128 a valid pair: 0.73 G for 1390 valid rows x
// 2048 columns, 0.4 us on the int8 tensor cores) -- at these sizes a call
// is latency: one wave of small blocks and their epilogues.  The earlier
// design (one query row a warp, every block walking all of desc2 with
// __dp4a fed by one shared-memory load a word, |b|^2 recomputed in every
// block, synchronous staging) took 0.07 ms on an H100; the VO step's
// keyframe call (256 rows) ran on 32 blocks.
//
// Design (one launch a call):
//   * Grid: (row tile of MT = 64 query rows) x (column split of split_cols
//     columns).  A row tile with no valid row is written as zeros by its
//     split-0 block, and every block of it exits; a split with no valid
//     column loads nothing.  With split_cols = 128 the VO step's keyframe
//     call (256 rows x 8320 slots, 1390 valid) runs 4 x 65 blocks and its
//     map call (8320 slots, 1390 valid, x 2048) 130 x 16, of which only
//     the tiles holding valid rows work (256-column splits were slower on
//     the map call, 64-column ones on both).
//   * Tensor cores: a warp owns 16 query rows, held in registers as the A
//     fragments of mma.sync.m16n8k32.row.col.s32.u8.u8.s32 for all four
//     32-byte k steps (16 words a thread); each 8-column tile of desc2 is
//     two 16-byte shared-memory loads a thread, four MMAs into int32.  The
//     bytes of the k axis are assigned to the fragments' k slots in the
//     same permuted order for A and B (an exact integer dot product does
//     not depend on the order), so a thread's B fragments are two
//     contiguous 16-byte chunks of its column.
//   * Staging: desc2 in tiles of CT = 64 columns, by cp.async (16 bytes a
//     thread, out-of-range columns zero-filled), every tile of the split
//     (at most MAX_TILES) in flight at once, one commit group a tile: the
//     block multiplies tile t as soon as it lands while the later tiles
//     load.  A column's 16-byte chunk c lies at slot c ^ 4 (odd columns) or
//     c (even), so the eight lanes of each quarter warp read eight
//     different bank groups.  Each column's |b|^2 is summed once a tile, by
//     the four lanes whose B fragments hold its bytes, and shuffled to the
//     lanes whose accumulators need it.
//   * Epilogue: a thread's four accumulators are (row g | g + 8) x (columns
//     2t, 2t + 1) of the 8-column tile; each becomes the exact integer
//     distance and updates that row's running (best, index, second), the
//     thread's columns taken in ascending order.  The four threads of a
//     row then merge by the rule
//       other best lower, or equal at a lower column -> other wins and
//         second = min(own best, other second);
//       else second = min(own second, other best),
//     which keeps "second excludes only the argmin column" exact.  A
//     split's state starts at (inf, its first column, inf): the state an
//     invalid column leaves, so skipped columns change nothing.
//   * Splits: with one split a block writes the outputs.  Otherwise each
//     block writes its rows' partial (best, index, second) to scratch,
//     publishes them (__threadfence) and takes a ticket from its row
//     tile's counter; the block that draws the last ticket resets the
//     counter to 0 on the device (ready for the next call, and for each
//     replay of a CUDA graph) and merges the splits by the same rule, two
//     threads a row, each over half of them in ascending split order, the
//     lower half's state then taking the upper's
//     (ops/kernels/matchk.py::best2_split_merge states the rule and is
//     held to the plain version on the CPU).  The rule gives the lowest
//     column among equal minima whatever the order of merging, so the
//     result does not depend on block order.
//
// K7f, the f32-operand form of the same TPU kernel (matchk.py:73-78,
// 136-141): the same function with f32 descriptors (or mixed u8/f32, which
// the wrapper casts to f32, as the JAX wrapper does), distances
// max((|a|^2 + |b|^2) - 2 a.b, 0) in f32.  Plain CUDA-core f32, no tensor
// cores (so no TF32), each sum over k = 0..127 in ascending order with one
// rounding per operation: the results differ from the plain version's
// matmul only by its summation order.  Bound by f32 operations (2 x 128 a
// pair: 0.01 ms for 1390 valid rows x 2048 columns at 67 TFLOP/s).  Design
// as the earlier u8 kernel: 8 query rows a block, one a warp, skipped when
// valid1 is false; the rows sit in shared memory and every lane reads the same
// word (a broadcast); desc2 is staged in tiles of CTF columns with a
// 129-float row pitch, so lane l reads bank (l + k) % 32; lane l takes
// columns l and l + 32 of each tile, and the lanes merge as above.
#include "common.cuh"

#include <cuda_pipeline.h>
#include <math_constants.h>

namespace {

constexpr int MT = 64;          // query rows per block: 4 warps x 16
constexpr int NTHR = 128;
constexpr int CT = 64;          // desc2 columns per staged tile
constexpr int MAX_TILES = 2;    // tiles a split may hold: split_cols <= 128

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

// One column after every lower column of this thread: a strictly lower
// distance wins, an equal one becomes the second.
__device__ __forceinline__ void visit(Best2& a, float v, int col) {
  if (v < a.best) {
    a.second = a.best;
    a.best = v;
    a.idx = col;
  } else {
    a.second = fminf(a.second, v);
  }
}

__device__ __forceinline__ void merge_quad(Best2& st) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, st.best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, st.idx, off);
    const float os = __shfl_xor_sync(0xffffffffu, st.second, off);
    merge(st, ob, oi, os);
  }
}

__device__ __forceinline__ void mma_u8(int (&d)[4], unsigned a0, unsigned a1, unsigned a2,
                                       unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Word h of k step kc in a thread's pair of 16-byte chunks (chunk kc / 2).
__device__ __forceinline__ unsigned kword(const uint4 (&c)[2], int kc, int h) {
  const uint4 q = c[kc >> 1];
  const int w = 2 * (kc & 1) + h;
  return w == 0 ? q.x : w == 1 ? q.y : w == 2 ? q.z : q.w;
}

__device__ __forceinline__ unsigned sq_norm(const uint4& q, unsigned acc) {
  acc = __dp4a(q.x, q.x, acc);
  acc = __dp4a(q.y, q.y, acc);
  acc = __dp4a(q.z, q.z, acc);
  return __dp4a(q.w, q.w, acc);
}

// (128, 1): the compiler's register choice under it was the faster
__global__ void __launch_bounds__(NTHR, 1)
best2_l2_kernel(const uint4* __restrict__ d1q, const uint4* __restrict__ d2q,
                const unsigned char* __restrict__ valid1,
                const unsigned char* __restrict__ valid2, int n1, int n2, int split_cols,
                float* __restrict__ out_d1, float* __restrict__ out_d2,
                int* __restrict__ out_i1, int* __restrict__ part,
                int* __restrict__ counters) {
  __shared__ __align__(16) uint4 ring[MAX_TILES][CT * 8];
  __shared__ unsigned char sval[MAX_TILES * CT];
  __shared__ int s_last;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = blockIdx.x * MT;
  const int split = blockIdx.y, n_splits = gridDim.y;
  const int c_lo = split * split_cols;
  const int c_hi = min(n2, c_lo + split_cols);

  // rows: any valid row in the tile?
  const int my_row = r0 + tid;
  const bool row_ok = tid < MT && my_row < n1 && (valid1 == nullptr || valid1[my_row] != 0);
  if (!__syncthreads_or(row_ok)) {
    if (split == 0 && tid < MT && my_row < n1) {
      out_d1[my_row] = 0.0f;
      out_d2[my_row] = 0.0f;
      out_i1[my_row] = 0;
    }
    return;
  }
  // columns: the split's valid2 bytes (0 past n2), and any valid one?
  bool col_ok = false;
  for (int i = tid; i < MAX_TILES * CT; i += NTHR) {
    const unsigned char v = c_lo + i < c_hi ? valid2[c_lo + i] : 0;
    sval[i] = v;
    col_ok = col_ok || v != 0;
  }
  const bool any_col = __syncthreads_or(col_ok);

  // this thread's rows g and g + 8 of its warp, chunks t4 and t4 + 4
  const int ra = r0 + warp * 16 + g, rb = ra + 8;
  uint4 A[2][2];
  unsigned qa = 0u, qb = 0u;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    A[0][p] = ra < n1 ? __ldg(d1q + static_cast<size_t>(ra) * 8 + 4 * p + t4) : z;
    A[1][p] = rb < n1 ? __ldg(d1q + static_cast<size_t>(rb) * 8 + 4 * p + t4) : z;
    qa = sq_norm(A[0][p], qa);
    qb = sq_norm(A[1][p], qb);
  }
  qa += __shfl_xor_sync(0xffffffffu, qa, 1);
  qa += __shfl_xor_sync(0xffffffffu, qa, 2);
  qb += __shfl_xor_sync(0xffffffffu, qb, 1);
  qb += __shfl_xor_sync(0xffffffffu, qb, 2);
  const int na = static_cast<int>(qa), na8 = static_cast<int>(qb);  // |a|^2 of rows ra, rb
  Best2 st[2] = {{CUDART_INF_F, c_lo, CUDART_INF_F}, {CUDART_INF_F, c_lo, CUDART_INF_F}};

  if (any_col) {
    // every tile of the split in flight at once, one commit group a tile
    const int n_tiles = (c_hi - c_lo + CT - 1) / CT;
    for (int t = 0; t < n_tiles; ++t) {
#pragma unroll
      for (int k = 0; k < CT * 8 / NTHR; ++k) {
        const int i = tid + k * NTHR;
        const int col = i >> 3, c = i & 7;
        const int gc = c_lo + t * CT + col;
        const bool in = gc < c_hi;
        const uint4* src = d2q + (in ? static_cast<size_t>(gc) * 8 + c : 0);
        __pipeline_memcpy_async(&ring[t][col * 8 + (c ^ ((col & 1) << 2))], src, 16,
                                in ? 0 : 16);
      }
      __pipeline_commit();
    }
    for (int t = 0; t < n_tiles; ++t) {
      if (t + 1 < n_tiles) {  // the later tile may still be in flight
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      __syncthreads();
      const uint4* buf = ring[t];
      const int col0 = c_lo + t * CT;
#pragma unroll 2
      for (int j = 0; j < CT / 8; ++j) {
        const int col = j * 8 + g;
        const int sw = (col & 1) << 2;
        uint4 B[2];
        B[0] = buf[col * 8 + (t4 ^ sw)];
        B[1] = buf[col * 8 + ((t4 + 4) ^ sw)];
        int acc[4] = {0, 0, 0, 0};
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)
          mma_u8(acc, kword(A[0], kc, 0), kword(A[1], kc, 0), kword(A[0], kc, 1),
                 kword(A[1], kc, 1), kword(B, kc, 0), kword(B, kc, 1));
        // |b|^2 of column col from the quad's four 32-byte parts, then the
        // norms of this thread's accumulator columns 2 t4 and 2 t4 + 1
        unsigned pn = sq_norm(B[1], sq_norm(B[0], 0u));
        pn += __shfl_xor_sync(0xffffffffu, pn, 1);
        pn += __shfl_xor_sync(0xffffffffu, pn, 2);
        const int nb0 = static_cast<int>(__shfl_sync(0xffffffffu, pn, 8 * t4));
        const int nb1 = static_cast<int>(__shfl_sync(0xffffffffu, pn, 8 * t4 + 4));
        const int c0 = j * 8 + 2 * t4;
        const bool ok0 = sval[t * CT + c0] != 0, ok1 = sval[t * CT + c0 + 1] != 0;
        const int gc0 = col0 + c0;
        visit(st[0], ok0 ? static_cast<float>(na + nb0 - 2 * acc[0]) : CUDART_INF_F, gc0);
        visit(st[0], ok1 ? static_cast<float>(na + nb1 - 2 * acc[1]) : CUDART_INF_F, gc0 + 1);
        visit(st[1], ok0 ? static_cast<float>(na8 + nb0 - 2 * acc[2]) : CUDART_INF_F, gc0);
        visit(st[1], ok1 ? static_cast<float>(na8 + nb1 - 2 * acc[3]) : CUDART_INF_F, gc0 + 1);
      }
    }
  }
  merge_quad(st[0]);
  merge_quad(st[1]);

  const bool va = ra < n1 && (valid1 == nullptr || valid1[ra] != 0);
  const bool vb = rb < n1 && (valid1 == nullptr || valid1[rb] != 0);
  if (n_splits == 1) {
    if (t4 == 0) {
      if (ra < n1) {
        out_d1[ra] = va ? st[0].best : 0.0f;
        out_d2[ra] = va ? st[0].second : 0.0f;
        out_i1[ra] = va ? st[0].idx : 0;
      }
      if (rb < n1) {
        out_d1[rb] = vb ? st[1].best : 0.0f;
        out_d2[rb] = vb ? st[1].second : 0.0f;
        out_i1[rb] = vb ? st[1].idx : 0;
      }
    }
    return;
  }
  // partials: part[(split * 3 + f) * n1 + row], f = best, index, second
  const size_t plane = static_cast<size_t>(n1);
  int* pb = part + static_cast<size_t>(split) * 3 * plane;
  if (t4 == 0) {
    if (ra < n1) {
      pb[ra] = __float_as_int(st[0].best);
      pb[plane + ra] = st[0].idx;
      pb[2 * plane + ra] = __float_as_int(st[0].second);
    }
    if (rb < n1) {
      pb[rb] = __float_as_int(st[1].best);
      pb[plane + rb] = st[1].idx;
      pb[2 * plane + rb] = __float_as_int(st[1].second);
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int ticket = atomicAdd(counters + blockIdx.x, 1);
    s_last = ticket == n_splits - 1;
    if (s_last) atomicExch(counters + blockIdx.x, 0);
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // two threads a row: thread h merges splits [h * half, (h + 1) * half) in
  // ascending order, then the lower half's state takes the upper half's
  const int row = r0 + (tid >> 1), h = tid & 1;
  const int half = (n_splits + 1) / 2;
  const int s_end = min(n_splits, (h + 1) * half);
  Best2 m = {CUDART_INF_F, 0x7fffffff, CUDART_INF_F};
  if (row < n1) {
#pragma unroll 4
    for (int s = h * half; s < s_end; ++s) {
      const int* q = part + static_cast<size_t>(s) * 3 * plane;
      merge(m, __int_as_float(__ldcg(q + row)), __ldcg(q + plane + row),
            __int_as_float(__ldcg(q + 2 * plane + row)));
    }
  }
  const float ob = __shfl_down_sync(0xffffffffu, m.best, 1);
  const int oi = __shfl_down_sync(0xffffffffu, m.idx, 1);
  const float os = __shfl_down_sync(0xffffffffu, m.second, 1);
  if (h == 0 && row < n1) {
    merge(m, ob, oi, os);
    const bool ok = valid1 == nullptr || valid1[row] != 0;
    out_d1[row] = ok ? m.best : 0.0f;
    out_d2[row] = ok ? m.second : 0.0f;
    out_i1[row] = ok ? m.idx : 0;
  }
}

constexpr int ROWS = 8;     // K7f: query rows (warps) per block
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
// Outputs (n1,) f32 d1, f32 d2, int32 i1.  split_cols: desc2 columns a
// block, a multiple of 64 up to 256.  With more than one split (n2 > split_cols),
// part: 3 * n_splits * n1 int32 of scratch (any contents), and counters:
// ceil(n1 / 64) int32, zero before the first call and left zero by every
// call; with one split both may be null.
extern "C" int sift_best2_l2(const void* desc1, const void* desc2, const void* valid1,
                             const void* valid2, int n1, int n2, int split_cols, void* d1,
                             void* d2, void* i1, void* part, void* counters, void* stream) {
  if (n1 < 0 || n2 < 1 || split_cols < CT || split_cols % CT || split_cols > MAX_TILES * CT)
    return cudaErrorInvalidValue;
  if (n1 == 0) return cudaSuccess;
  const int n_splits = (n2 + split_cols - 1) / split_cols;
  if (n_splits > 65535 || (n_splits > 1 && (part == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  const dim3 grid((n1 + MT - 1) / MT, n_splits);
  best2_l2_kernel<<<grid, NTHR, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(desc1), static_cast<const uint4*>(desc2),
      static_cast<const unsigned char*>(valid1), static_cast<const unsigned char*>(valid2), n1,
      n2, split_cols, static_cast<float*>(d1), static_cast<float*>(d2), static_cast<int*>(i1),
      static_cast<int*>(part), static_cast<int*>(counters));
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
