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
// K7f, the f32-operand form of the same TPU kernel (matchk.py:131-141):
// the same function with f32 descriptors (or mixed u8/f32, which the
// wrapper casts to f32, as the JAX wrapper does), distances
// max((|a|^2 + |b|^2) - 2 a.b, 0) in f32.
//
// What bounds it: f32 operations on the CUDA cores, 2 x 128 a valid
// (row, column) pair (0.0056 ms for 1213 valid rows x 1201 valid columns
// at 67 TFLOP/s; an invalid column is +inf and needs none); its bytes (5.3
// MB at the VO map call's shapes, 1.6 us) come second.  No tensor cores: TF32 (and its 3xTF32 split) would change the
// rounding that the f32 tolerance is written for.  The earlier design (8
// query rows a block, one a warp, every block restaging all of desc2 by
// synchronous loads, |b|^2 recomputed in every block by a quarter of its
// threads, two shared-memory loads a multiply-add) took 0.32 ms of device
// time at the VO map call's shapes, this one 0.045, 8.2x the bound
// (tools/ab_best2_f32.py; NVIDIA H100 80GB HBM3, 700 W).  What keeps it
// above the bound: the blocks that compute hold 39 % valid (row, column)
// pairs there (2.6x), and over the launch they issue their FMAs at ~31 %
// of the card's f32 rate, 2 resident blocks an SM (96 registers a thread)
// in ~1.7 waves.
//
// Design (one launch a call):
//   * Grid and merge: K7's.  (Row tile of FM = 64 query rows) x (column
//     split of FN = 128 columns); a row tile with no valid row is written
//     as zeros by its split-0 block, a split with no valid column loads
//     nothing, and the splits' partial (best, index, second) are merged on
//     the card by the last block of the row tile (merge_splits, shared
//     with K7).
//   * Register tile: 256 threads, each owning 8 rows (ty + 8 i) x 4
//     columns (tx + 32 j) of the 64 x 128 block tile, 32 accumulators: a
//     4-k step is 8 row and 4 column 16-byte shared-memory loads for 128
//     FMAs (the earlier design: two loads an FMA).  A warp covers 4 row
//     groups x 8 column groups, so a warp's load reads 4 (rows) or 8
//     (columns) distinct 16-byte chunks.  (An 8 x 8 tile in 128 threads,
//     3 blocks an SM, was no faster.)
//   * Staging: desc1's row tile and desc2's column tile in k chunks of
//     FK = 16, row-major with an FP = 20-float pitch (80 bytes: rows or
//     columns that differ mod 8 fall in different 16-byte bank groups, so
//     the float4 loads are free of conflicts), by cp.async 16 bytes a
//     thread (past n1 / n2 zero-filled), in a ring of 3 stages: two chunks
//     in flight while one is multiplied.  46 KB of static shared memory,
//     no attribute to set.
//   * Arithmetic: every dot product and every norm is summed in ascending
//     k with __fmaf_rn (one rounding a step; the library's --fmad=false
//     stays for the other kernels).  The 64 row norms and 128 column norms
//     are summed once a block, by threads 0-191, from the chunks as they
//     land.  Where every partial sum is exact (integers, or integers times
//     a power of two, below 2^24) the result is K7's, bit for bit.
//   * Epilogue: each thread visits its 4 columns in ascending order
//     (visit); the 8 lanes sharing a row merge by shuffles and the 4 warps
//     sharing it through shared memory (merge), so the second best
//     excludes only the argmin column.
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

// Whether the row tile at r0 holds a valid row (every thread calls it); a
// tile with none is written as zeros by its split-0 block.
__device__ __forceinline__ bool tile_has_rows(int tid, int r0, int n1, int split,
                                              const unsigned char* __restrict__ valid1,
                                              float* __restrict__ out_d1,
                                              float* __restrict__ out_d2,
                                              int* __restrict__ out_i1) {
  const int my_row = r0 + tid;
  const bool row_ok = tid < MT && my_row < n1 && (valid1 == nullptr || valid1[my_row] != 0);
  if (__syncthreads_or(row_ok)) return true;
  if (split == 0 && tid < MT && my_row < n1) {
    out_d1[my_row] = 0.0f;
    out_d2[my_row] = 0.0f;
    out_i1[my_row] = 0;
  }
  return false;
}

// The split's n valid2 bytes into sval (0 past c_hi); whether any is set
// (every thread calls it).
template <int NT>
__device__ __forceinline__ bool load_split_valid(int tid, int c_lo, int c_hi, int n,
                                                 const unsigned char* __restrict__ valid2,
                                                 unsigned char* sval) {
  bool col_ok = false;
  for (int i = tid; i < n; i += NT) {
    const unsigned char v = c_lo + i < c_hi ? valid2[c_lo + i] : 0;
    sval[i] = v;
    col_ok = col_ok || v != 0;
  }
  return __syncthreads_or(col_ok);
}

// With more than one split: after every thread has written its rows'
// partials to part[(split * 3 + f) * n1 + row] (f = best, index, second),
// the block publishes them (__threadfence) and takes a ticket from its row
// tile's counter; the block that draws the last ticket resets the counter
// to 0 on the device (ready for the next call, and for each replay of a
// CUDA graph) and merges the splits, NT / MT threads a row, each over its
// share of them in ascending split order, the lower shares' states then
// taking the upper ones'.  Every thread calls it.
template <int NT>
__device__ __forceinline__ void merge_splits(int tid, int r0, int n1, int n_splits,
                                             const int* __restrict__ part,
                                             int* __restrict__ counters, int& s_last,
                                             const unsigned char* __restrict__ valid1,
                                             float* __restrict__ out_d1,
                                             float* __restrict__ out_d2,
                                             int* __restrict__ out_i1) {
  constexpr int TPR = NT / MT;
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
  const size_t plane = static_cast<size_t>(n1);
  const int row = r0 + tid / TPR, h = tid % TPR;
  const int share = (n_splits + TPR - 1) / TPR;
  const int s_end = min(n_splits, (h + 1) * share);
  Best2 m = {CUDART_INF_F, 0x7fffffff, CUDART_INF_F};
  if (row < n1) {
#pragma unroll 4
    for (int s = h * share; s < s_end; ++s) {
      const int* q = part + static_cast<size_t>(s) * 3 * plane;
      merge(m, __int_as_float(__ldcg(q + row)), __ldcg(q + plane + row),
            __int_as_float(__ldcg(q + 2 * plane + row)));
    }
  }
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1) {
    const float ob = __shfl_down_sync(0xffffffffu, m.best, off);
    const int oi = __shfl_down_sync(0xffffffffu, m.idx, off);
    const float os = __shfl_down_sync(0xffffffffu, m.second, off);
    if ((h & (2 * off - 1)) == 0) merge(m, ob, oi, os);
  }
  if (h == 0 && row < n1) {
    const bool ok = valid1 == nullptr || valid1[row] != 0;
    out_d1[row] = ok ? m.best : 0.0f;
    out_d2[row] = ok ? m.second : 0.0f;
    out_i1[row] = ok ? m.idx : 0;
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

  if (!tile_has_rows(tid, r0, n1, split, valid1, out_d1, out_d2, out_i1)) return;
  const bool any_col = load_split_valid<NTHR>(tid, c_lo, c_hi, MAX_TILES * CT, valid2, sval);

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
  merge_splits<NTHR>(tid, r0, n1, n_splits, part, counters, s_last, valid1, out_d1, out_d2,
                     out_i1);
}

constexpr int DIM = 128;
constexpr int FM = MT;          // K7f: query rows a block (K7's row tile)
constexpr int FN = 128;         // K7f: desc2 columns a block, its column split
constexpr int FK = 16;          // k a staged chunk
constexpr int FP = FK + 4;      // staged row pitch in floats (80 bytes)
constexpr int FSTAGES = 3;
constexpr int FCHUNKS = DIM / FK;
constexpr int FTHR = 256;       // 8 warps: 2 (row halves) x 4 (column quarters)

// One k chunk of the row tile (FM x FK) and of the column tile (FN x FK)
// into sa and sb, 16 bytes a copy, rows past n1 and columns past c_hi
// zero-filled; one commit group.
__device__ __forceinline__ void stage_f32(const float* __restrict__ d1f,
                                          const float* __restrict__ d2f, int n1, int r0,
                                          int c_lo, int c_hi, int chunk, int tid,
                                          float* sa, float* sb) {
  const int k0 = chunk * FK;
#pragma unroll
  for (int m = 0; m < FM * (FK / 4) / FTHR; ++m) {
    const int i = tid + m * FTHR;
    const int r = i >> 2, q = i & 3;
    const bool in = r0 + r < n1;
    const float* src = d1f + (in ? static_cast<size_t>(r0 + r) * DIM + k0 + 4 * q : 0);
    __pipeline_memcpy_async(sa + r * FP + 4 * q, src, 16, in ? 0 : 16);
  }
#pragma unroll
  for (int m = 0; m < FN * (FK / 4) / FTHR; ++m) {
    const int i = tid + m * FTHR;
    const int c = i >> 2, q = i & 3;
    const bool in = c_lo + c < c_hi;
    const float* src = d2f + (in ? static_cast<size_t>(c_lo + c) * DIM + k0 + 4 * q : 0);
    __pipeline_memcpy_async(sb + c * FP + 4 * q, src, 16, in ? 0 : 16);
  }
  __pipeline_commit();
}

// x . x over a staged row's FK floats, added in ascending k to acc.
__device__ __forceinline__ float sq_norm_f32(const float* p, float acc) {
#pragma unroll
  for (int q = 0; q < FK / 4; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(p + 4 * q);
    acc = __fmaf_rn(v.x, v.x, acc);
    acc = __fmaf_rn(v.y, v.y, acc);
    acc = __fmaf_rn(v.z, v.z, acc);
    acc = __fmaf_rn(v.w, v.w, acc);
  }
  return acc;
}

__global__ void __launch_bounds__(FTHR, 2)
best2_l2_f32_kernel(const float* __restrict__ d1f, const float* __restrict__ d2f,
                    const unsigned char* __restrict__ valid1,
                    const unsigned char* __restrict__ valid2, int n1, int n2,
                    float* __restrict__ out_d1, float* __restrict__ out_d2,
                    int* __restrict__ out_i1, int* __restrict__ part,
                    int* __restrict__ counters) {
  __shared__ __align__(16) float sa[FSTAGES][FM * FP];
  __shared__ __align__(16) float sb[FSTAGES][FN * FP];
  __shared__ float s_na[FM], s_nb[FN];
  __shared__ unsigned char sval[FN];
  __shared__ int s_last;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  // this thread's rows ty + 8 i (i < 8) and columns tx + 32 j (j < 4)
  const int ty = (warp >> 2) * 4 + (lane >> 3), tx = (warp & 3) * 8 + (lane & 7);
  const int r0 = blockIdx.x * FM;
  const int split = blockIdx.y, n_splits = gridDim.y;
  const int c_lo = split * FN;
  const int c_hi = min(n2, c_lo + FN);

  if (!tile_has_rows(tid, r0, n1, split, valid1, out_d1, out_d2, out_i1)) return;
  const bool any_col = load_split_valid<FTHR>(tid, c_lo, c_hi, FN, valid2, sval);

  // the final state of row r0 + tid (tid < FM): the split's first column
  // and no distance where the split has no valid column
  Best2 m = {CUDART_INF_F, c_lo, CUDART_INF_F};
  if (any_col) {
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    float nrm = 0.0f;  // |a|^2 of row tid (tid < FM), |b|^2 of column tid - FM (< FM + FN)
    stage_f32(d1f, d2f, n1, r0, c_lo, c_hi, 0, tid, sa[0], sb[0]);
    stage_f32(d1f, d2f, n1, r0, c_lo, c_hi, 1, tid, sa[1], sb[1]);
    for (int c = 0; c < FCHUNKS; ++c) {
      __pipeline_wait_prior(1);  // chunk c has landed; c + 1 may be in flight
      __syncthreads();           // ... for every thread, and chunk c - 1 is done with
      if (c + 2 < FCHUNKS) {
        const int s2 = (c + 2) % FSTAGES;
        stage_f32(d1f, d2f, n1, r0, c_lo, c_hi, c + 2, tid, sa[s2], sb[s2]);
      } else {
        __pipeline_commit();     // an empty group keeps wait_prior's count
      }
      const float* A = sa[c % FSTAGES];
      const float* B = sb[c % FSTAGES];
      if (tid < FM) {
        nrm = sq_norm_f32(A + tid * FP, nrm);
      } else if (tid < FM + FN) {
        nrm = sq_norm_f32(B + (tid - FM) * FP, nrm);
      }
#pragma unroll
      for (int kq = 0; kq < FK / 4; ++kq) {
        float4 av[8], bv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          av[i] = *reinterpret_cast<const float4*>(A + (ty + 8 * i) * FP + 4 * kq);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bv[j] = *reinterpret_cast<const float4*>(B + (tx + 32 * j) * FP + 4 * kq);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float s = acc[i][j];
            s = __fmaf_rn(av[i].x, bv[j].x, s);
            s = __fmaf_rn(av[i].y, bv[j].y, s);
            s = __fmaf_rn(av[i].z, bv[j].z, s);
            acc[i][j] = __fmaf_rn(av[i].w, bv[j].w, s);
          }
      }
    }
    if (tid < FM) {
      s_na[tid] = nrm;
    } else if (tid < FM + FN) {
      s_nb[tid - FM] = nrm;
    }
    __syncthreads();  // the norms are in; the stages are free
    // red: the 4 column quarters' states of each row, over stage 0
    float* red_best = sb[0];
    float* red_second = red_best + 4 * FM;
    int* red_idx = reinterpret_cast<int*>(red_second + 4 * FM);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 8 * i;
      const float na = s_na[r];
      Best2 st = {CUDART_INF_F, c_lo, CUDART_INF_F};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 32 * j;
        const float v = sval[col] != 0 ? fmaxf((na + s_nb[col]) - 2.0f * acc[i][j], 0.0f)
                                       : CUDART_INF_F;
        visit(st, v, c_lo + col);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, st.best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, st.idx, off);
        const float os = __shfl_xor_sync(0xffffffffu, st.second, off);
        merge(st, ob, oi, os);
      }
      if ((lane & 7) == 0) {
        const int slot = (warp & 3) * FM + r;
        red_best[slot] = st.best;
        red_second[slot] = st.second;
        red_idx[slot] = st.idx;
      }
    }
    __syncthreads();
    if (tid < FM) {
      m = Best2{red_best[tid], red_idx[tid], red_second[tid]};
#pragma unroll
      for (int q = 1; q < 4; ++q)
        merge(m, red_best[q * FM + tid], red_idx[q * FM + tid], red_second[q * FM + tid]);
    }
  }

  const int row = r0 + tid;
  if (n_splits == 1) {
    if (tid < FM && row < n1) {
      const bool ok = valid1 == nullptr || valid1[row] != 0;
      out_d1[row] = ok ? m.best : 0.0f;
      out_d2[row] = ok ? m.second : 0.0f;
      out_i1[row] = ok ? m.idx : 0;
    }
    return;
  }
  if (tid < FM && row < n1) {
    const size_t plane = static_cast<size_t>(n1);
    int* pb = part + static_cast<size_t>(split) * 3 * plane;
    pb[row] = __float_as_int(m.best);
    pb[plane + row] = m.idx;
    pb[2 * plane + row] = __float_as_int(m.second);
  }
  merge_splits<FTHR>(tid, r0, n1, n_splits, part, counters, s_last, valid1, out_d1, out_d2,
                     out_i1);
}

}  // namespace

// desc1: (n1, 128) u8, desc2: (n2, 128) u8, both 16-byte aligned rows;
// valid1: (n1,) u8 or null (every row computed); valid2: (n2,) u8.
// Outputs (n1,) f32 d1, f32 d2, int32 i1.  split_cols: desc2 columns a
// block, 64 or 128.  With more than one split (n2 > split_cols),
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

// K7f.  desc1: (n1, 128) f32, desc2: (n2, 128) f32, both 16-byte aligned
// rows; the rest as sift_best2_l2, with split_cols = 128 (FN) only: the
// wrapper passes its one SPLIT_COLS to both entries.
extern "C" int sift_best2_l2_f32(const void* desc1, const void* desc2, const void* valid1,
                                 const void* valid2, int n1, int n2, int split_cols, void* d1,
                                 void* d2, void* i1, void* part, void* counters, void* stream) {
  if (n1 < 0 || n2 < 1 || split_cols != FN) return cudaErrorInvalidValue;
  if (n1 == 0) return cudaSuccess;
  const int n_splits = (n2 + FN - 1) / FN;
  if (n_splits > 65535 || (n_splits > 1 && (part == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  const dim3 grid((n1 + FM - 1) / FM, n_splits);
  best2_l2_f32_kernel<<<grid, FTHR, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(desc1), static_cast<const float*>(desc2),
      static_cast<const unsigned char*>(valid1), static_cast<const unsigned char*>(valid2), n1,
      n2, static_cast<float*>(d1), static_cast<float*>(d2), static_cast<int*>(i1),
      static_cast<int*>(part), static_cast<int*>(counters));
  return static_cast<int>(cudaGetLastError());
}
