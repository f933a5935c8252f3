// K1, K2 and K9: the Gaussian blurs of the scale-space pyramid.
//
// Replaces sift_pyocl_tpu/ops/pallas/ladder0.py::octave0_ladder (K1, octave
// 0: pre-blur to init_sigma, then scales+2 incremental blurs and the DoGs),
// sift_pyocl_tpu/ops/pallas/ladder.py::small_octaves_ladder (K2, every
// octave >= 1: the same ladder on each octave, and the next octave's base
// by shrink or 2x2 bin of level `scales`, ceil-sized) and
// sift_pyocl_tpu/ops/pallas/conv.py::separable_blur_pallas (K9, one plane
// blurred by one sigma: the per-level octave 0 of configs whose taps the
// TPU's K1 strips cannot hold, e.g. SiftConfig(scales=2)).
//
// K1, K9: ONE launch per blur level (K1 6 a call at the default config,
// K9 one).  Octave 0 at 1080x1920 reads the 8.3 MB image and writes 11
// planes of 8.3 MB (6 blurs, 5 DoGs): 0.0297 ms at 3.35 TB/s.  What bounded
// the earlier level body (blur_level_tile) was issue, not bytes: each
// output took one global load and one clamp a horizontal tap and two
// shared-memory loads a vertical tap, in tap loops of runtime length
// (~2 200 issued instructions a pixel over the 106 taps of the default
// ladder), where --fmad=false leaves 2 x 2 x 106 = 424 float operations
// a pixel.  The level body now (blur_level_kernel<K>):
//   - stage, then sum: a block's LW x LH = 64 x 64 output tile stages its
//     (LH + 2h) x (LW + 2h) input window in shared memory once, every
//     element by an asynchronous 4-byte cp.async, the row and column
//     clamps applied to the staged address (the clamp-to-edge of the level
//     being blurred), so neither pass makes a global load or a clamp a tap;
//   - register blocking: in the horizontal pass a thread sums 8 adjacent
//     columns of one row (lanes on rows, window row stride odd: no bank
//     conflicts), in the vertical pass 8 consecutive rows of one column
//     (lanes on columns); each value loaded from shared memory serves 8
//     outputs, and each tap (a broadcast load) 8;
//   - the tap loops unrolled, one instance for each odd K of 3-39 (the
//     default config's 11-27, scales=2's up to 39); any other K launches
//     blur_level_any_kernel, the earlier body, so no size raises;
//   - 64-column tiles: the halo is (64 + 2h) / 64 of the columns, against
//     (32 + 2h) / 32 a warp wide; at K = 27, 56 KB of shared memory, 4
//     blocks (32 warps) an SM, and the 510 tiles of a 1080p level in one
//     wave of 528; -Xptxas -v: 32-34 registers, no spills;
//   - the DoG from the level's own staged centre sample, not a second read
//     of the previous level; the device's shared-memory limit is queried
//     once a device, each instance's attribute set once.
// Each output still sums its taps in ascending order from 0.0f, one
// rounding per operation (the library is built with --fmad=false), and K9
// is one launch of the same kernel without the DoG, bit-equal to K1's
// levels.  What bounds it now: within a level all blocks stage,
// then sum, then write at about the same time (one wave), so a level's
// bytes and its issue overlap little.  Taps come from the caller's device
// buffer; the pyramid still routes octave 0 per level wherever the JAX
// package does (ops/pyramid.py).
//
// K2, the small octaves (1..n_oct-1: 540x960 down to 17x30 at 1080x1920),
// in ONE launch.  What the TPU kernel kept out of device memory: its launch
// overhead -- one Pallas launch computes every level of every small octave
// (sift_pyocl_tpu/ops/pallas/ladder.py:7-11).  What bounds it on this card:
// not bytes (its planes are a third of octave 0's: 0.0097 ms at 3.35 TB/s)
// but latency.  As one launch per level (the earlier design: 30 level and 5
// downsamples, a grid of 32x64 tiles each, so octave 3 ran on 24 blocks and
// octave 6 on one, each thread summing ~11 rows x 27 taps in order) every
// level cost a launch gap plus one tile's serial tap loop on a nearly empty
// card.  Design: a cooperative launch sized to the card (at most two blocks
// an SM, all resident), whose blocks walk a work list that
// ops/kernels/ladder.py::small_octaves_schedule builds in Python and hands
// over as a small device table: per (octave, level) item, its geometry,
// tile height, tile range and taps.  Items are grouped in steps; an item
// depends only on items of earlier steps (level l+1 of an octave on level
// l, an octave's base on the previous octave's level `scales`), so an
// octave starts while the one before still blurs its last levels (20 steps
// for 6 octaves of 5 levels, not 30), and cooperative_groups' grid.sync()
// between steps takes the place of the kernel boundary.  The tile height is
// chosen per octave (64 down to 8 rows) so that small octaves spread over
// many blocks.  The pass that writes level `scales` also writes the next
// octave's base (shrink or 2x2 bin from the tile, staged in shared memory),
// and the first level's pass writes level 0 from base1, so neither a
// downsample nor a copy is launched.  Levels written in this launch are read
// through L2 (__ldcg: the read-only cache is not coherent with writes made
// during a kernel), each tile's input window staged in shared memory by
// independent loads, so that a tile waits on L2 once rather than once a row.
// Each pixel's arithmetic is the level kernel's, operation by operation
// (the plain ladder's order of sums).  The other way to the barrier, a
// thread-block cluster holding an octave's plane pair in distributed shared
// memory (octave 2 is 518 KB a plane, octave 3 130 KB) with cluster.sync(),
// fits only from octave 2 or 3 on and would still need a grid-wide step for
// octave 1 (2 MB a plane), i.e. two launch forms, where one grid barrier
// serves every octave.  What remains on the card is the steps' latency: on an H100
// (chip_smoke.py's K2 floor, 20 steps of one tile each) about 4 us a step,
// a barrier plus one tile's chain of L2 loads and tap loops.
//
// K1m and K2m, the mask forms (mask_cfg of the TPU kernels,
// ladder0.py:113-167 and ladder.py:225-311, SiftConfig(mask_backend=
// "fused")): the same ladders, plus each octave's border-stripped
// (n_levels-2, H-2bd, W-2bd) uint8 0/1 extrema mask, in K8's layout.  Both
// run K8's tile body (extrema_tile.cuh), so the masks equal K8's and the plain
// stencil's bit for bit, and both run K1's and K2's own blur code, so the
// stacks equal K1's and K2's by construction.
//   - K1m: K1's level launches, then one launch of K8's kernel over octave
//     0's DoG stack on the same stream (7 launches at the default config).
//     What it saves over K1 + K8 is one wrapper call: the mask launch
//     takes what K8 takes on octave 0 (0.034 device ms at 1080x1920 on an
//     H100, chip_smoke.py).  Folding the mask into K1's last level launches
//     would need the DoG halos of neighbouring blocks, i.e. the lagged
//     design this form replaced.
//   - K2m: K2's one cooperative launch (small_octaves_kernel_masks, K2's
//     body with kMask set), whose work list also holds one mask item an
//     octave, on K8's 32 x 64 mask tiles, all in one step after the last
//     blur pass (21 steps for 6 octaves of 5 levels, K2's 20 and one).  A
//     step lasts as long as its slowest tile, and a mask tile outlasts a
//     small octave's blur tile: each octave's item at the first step after
//     its own last pass lengthened six steps (0.202 device ms against 0.182
//     on an H100 at 1080x1920, tools/ab_fused_ladders.py).  A mask tile
//     reads DoGs written by other blocks in earlier steps, so it reads them
//     through L2 (extrema_tile.cuh's kL2 form), in the shared memory after the
//     taps: the launch takes the larger of the blur tile's and the mask
//     tile's shared memory (50 KB at the default config: the whole 5-plane
//     stack, as K8), and the kernel is held to 128 registers, which keeps
//     K2's two blocks an SM.  What bounds it is K2's: the steps' latency,
//     and the mask step's two rounds of tiles on 264 blocks (349 tiles).
// The TPU kernels fused the mask to keep the DoG ring out of HBM; here the
// DoGs are written to device memory either way (the detector reads them),
// so what the fusion saves is launches and, for K2m, the mask's own pass
// over the small octaves' DoGs, which it reads while they sit in L2.
#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include "common.cuh"
#include "extrema_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int TW = 32;   // tile columns (one warp across)
constexpr int TH = 64;   // tile rows
constexpr int TY = 8;    // warps per block

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The earlier level body: one blur level on the TW x TH tile of this block,
// for the tap counts blur_level_kernel<K> has no instance of.
__global__ void __launch_bounds__(TW * TY)
blur_level_any_kernel(const float* __restrict__ src, float* __restrict__ dst,
                      float* __restrict__ dog, int H, int W,
                      const float* __restrict__ taps, int K) {
  extern __shared__ float smem[];
  float* st = smem;                         // K taps
  float* hb = smem + ((K + 3) & ~3);        // (TH + 2*half) x TW
  const int half = (K - 1) / 2;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int i = ty * TW + tx; i < K; i += TW * TY) st[i] = taps[i];
  __syncthreads();
  const int c0 = blockIdx.x * TW, r0 = blockIdx.y * TH;
  const int c = c0 + tx;
  const int cc = min(c, W - 1);             // columns past W: computed, not stored
  const int rows = TH + 2 * half;
  for (int i = ty; i < rows; i += TY) {
    const float* row = src + static_cast<size_t>(clampi(r0 - half + i, 0, H - 1)) * W;
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) acc += st[k] * __ldg(row + clampi(cc + k - half, 0, W - 1));
    hb[i * TW + tx] = acc;
  }
  __syncthreads();
  if (c >= W) return;
  for (int i = ty; i < TH; i += TY) {
    const int r = r0 + i;
    if (r >= H) break;
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) acc += st[k] * hb[(i + k) * TW + tx];
    const size_t at = static_cast<size_t>(r) * W + c;
    dst[at] = acc;
    if (dog != nullptr) dog[at] = acc - src[at];
  }
}

// K1's and K9's level body (see the note at the top): an LW x LH output
// tile, its (LH + 2h) x (LW + 2h) input window staged once by cp.async
// with the clamp applied to each staged address, then two passes over
// shared memory with the tap loops unrolled (K taps, compile-time).
constexpr int LW = 64;          // tile columns
constexpr int LH = 64;          // tile rows
constexpr int LNT = 256;        // threads a block (8 warps)
constexpr int LCB = 8;          // horizontal outputs a thread: adjacent columns
constexpr int LRB = 8;          // vertical outputs a thread: consecutive rows
constexpr int LHS = LW + 1;     // row stride of the horizontal sums (odd)
constexpr int LK_MAX = 39;      // the largest K with an instance (scales=2's taps)
static_assert(LW == (LNT / 32) * LCB, "one warp per LCB-column block in the horizontal pass");

// Shared memory of blur_level_kernel<K>: the taps, the staged window
// (row stride odd, so that lanes on consecutive rows hit distinct banks),
// the horizontal sums.
constexpr size_t level_tile_smem(int K) {
  return sizeof(float) * (((K + 3) & ~3) + (LH + K - 1) * (LW + K) + (LH + K - 1) * LHS);
}

template <int K>
__global__ void __launch_bounds__(LNT) blur_level_kernel(const float* __restrict__ src,
                                                         float* __restrict__ dst,
                                                         float* __restrict__ dog, int H, int W,
                                                         const float* __restrict__ taps) {
  constexpr int h = (K - 1) / 2;
  constexpr int rows = LH + 2 * h, cols = LW + 2 * h;
  constexpr int ws = cols + 1;              // odd window row stride
  extern __shared__ float smem[];
  float* st = smem;
  float* win = smem + ((K + 3) & ~3);       // rows x ws
  float* hb = win + rows * ws;              // rows x LHS
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * LW, r0 = blockIdx.y * LH;
  if (tid < K) st[tid] = taps[tid];
  // stage: one asynchronous 4-byte copy an element, all in flight at once;
  // row and column clamps applied here, once per staged element
  for (int i = warp; i < rows; i += LNT / 32) {
    const float* srow = src + static_cast<size_t>(clampi(r0 - h + i, 0, H - 1)) * W;
    float* wrow = win + i * ws;
    for (int j = lane; j < cols; j += 32)
      __pipeline_memcpy_async(wrow + j, srow + clampi(c0 - h + j, 0, W - 1), sizeof(float));
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  // horizontal: warp w owns columns [LCB w, LCB w + LCB), lanes own rows;
  // each window value loaded once serves LCB outputs; each output sums its
  // taps in ascending order from 0.0f, one rounding per operation
  const int jb = warp * LCB;
  for (int i = lane; i < rows; i += 32) {
    const float* wr = win + i * ws + jb;
    float acc[LCB], x[LCB];
#pragma unroll
    for (int u = 0; u < LCB; ++u) acc[u] = 0.0f;
#pragma unroll
    for (int u = 0; u < LCB - 1; ++u) x[u] = wr[u];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      x[(k + LCB - 1) % LCB] = wr[k + LCB - 1];
      const float t = st[k];
#pragma unroll
      for (int u = 0; u < LCB; ++u) acc[u] += t * x[(k + u) % LCB];
    }
#pragma unroll
    for (int u = 0; u < LCB; ++u) hb[i * LHS + jb + u] = acc[u];
  }
  __syncthreads();
  // vertical: a thread sums LRB consecutive rows of one column, lanes on
  // consecutive columns; the DoG takes the level's own staged sample
  for (int q = warp; q < (LW / 32) * (LH / LRB); q += LNT / 32) {
    const int cl = (q % (LW / 32)) * 32 + lane, i0 = (q / (LW / 32)) * LRB;
    const float* hc = hb + i0 * LHS + cl;
    float acc[LRB], x[LRB];
#pragma unroll
    for (int u = 0; u < LRB; ++u) acc[u] = 0.0f;
#pragma unroll
    for (int u = 0; u < LRB - 1; ++u) x[u] = hc[u * LHS];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      x[(k + LRB - 1) % LRB] = hc[(k + LRB - 1) * LHS];
      const float t = st[k];
#pragma unroll
      for (int u = 0; u < LRB; ++u) acc[u] += t * x[(k + u) % LRB];
    }
    const int c = c0 + cl;
    if (c >= W) continue;
#pragma unroll
    for (int u = 0; u < LRB; ++u) {
      const int r = r0 + i0 + u;
      if (r >= H) break;
      const size_t at = static_cast<size_t>(r) * W + c;
      dst[at] = acc[u];
      if (dog != nullptr) dog[at] = acc[u] - win[(i0 + u + h) * ws + cl + h];
    }
  }
}

// K2's work list, as ops/kernels/ladder.py::schedule_table lays it out
// (int32): n_steps, then the first item of each step (n_steps + 1 entries),
// then ITEM_INTS per item.  Item fields: octave, level (the pass writes
// level + 1 from level), H, W, tile height, tiles per row, the item's tile
// range [tile_start, tile_end) within its step, tap offset, tap count, ds
// (1: write the next octave's base from the level written, 2: from the
// level read -- scales == 0), mask.  Octave 0's first pass reads base1 and
// writes it as level 0.  A mask item (mask = 1, K2m only) is the extrema
// mask of the octave's whole DoG stack on extrema_tile.cuh's tiles: tile height
// sift_mask::TH, tiles_x mask tiles across the border-stripped width, no
// taps.
constexpr int ITEM_INTS = 12;
constexpr int MAX_TH = 64;   // the tallest tile the schedule picks

struct SmallOctaves {
  int bin;
  int n_taps;
  int max_half;                     // largest tap half-width (shared-memory layout)
  const float* base1;
  const float* taps;                // every increment's taps back to back
  const int* table;
  float* blurs[SIFT_MAX_OCT];
  float* dogs[SIFT_MAX_OCT];
  // K2m: each octave's (n_dogs - 2, H - 2bd, W - 2bd) mask and edge threshold
  unsigned char* masks[SIFT_MAX_OCT];
  float eths[SIFT_MAX_OCT];
  int n_dogs;
  int bd;
  float strong_thresh;
};

// Shared memory of small_octaves_kernel: the taps, then either a blur
// tile's input window ((MAX_TH + 2*max_half) x (TW + 2*max_half), clamped
// to the plane's edges), the horizontal pass's (MAX_TH + 2*max_half) x TW
// sums and the MAX_TH x TW output tile a downsample reads, or (K2m,
// n_dogs > 0) a mask tile's plane slots and mask tiles, whichever is larger.
size_t small_octaves_smem(int n_taps, int max_half, int n_dogs) {
  const size_t rows = MAX_TH + 2 * static_cast<size_t>(max_half);
  const size_t blur = sizeof(float) * (rows * (TW + 2 * static_cast<size_t>(max_half)) +
                                       rows * TW + static_cast<size_t>(MAX_TH) * TW);
  const size_t mask = n_dogs > 0 ? sift_mask::smem_bytes(sift_mask::slots(n_dogs)) : 0;
  return sizeof(float) * ((n_taps + 3) & ~3) + (blur > mask ? blur : mask);
}

// One tile (`lt`-th of its item) of one blur pass of K2, with the
// arithmetic of blur_level_any_kernel.  The block first stages the tile's whole
// input window in shared memory through L2 (levels written in this launch
// are not read through the non-coherent read-only cache), a batch of
// independent loads a thread, so that the tile waits on L2 once and not
// once a row; each warp then sums two rows at a time (two independent
// chains of adds).
__device__ __forceinline__ void small_octave_tile(const SmallOctaves& a, const int* it, int lt,
                                                  const float* st, float* win, float* hb,
                                                  float* otile) {
  const int o = it[0], l = it[1], H = it[2], W = it[3], th = it[4], tiles_x = it[5];
  const int K = it[9], ds = it[10];
  const float* tp = st + it[8];
  const int half = (K - 1) / 2;
  const size_t plane = static_cast<size_t>(H) * W;
  const bool copy = o == 0 && l == 0;       // level 0 is base1: read it, and store it
  const float* src = copy ? a.base1 : a.blurs[o] + l * plane;
  float* dst = a.blurs[o] + (l + 1) * plane;
  float* dog = a.dogs[o] + l * plane;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c0 = (lt % tiles_x) * TW, r0 = (lt / tiles_x) * th;
  const int c = c0 + tx;
  const int b = min(c, W - 1) - c0;         // columns past W: computed, not stored
  const int rows = th + 2 * half, span = TW + 2 * half;
  const int ws = TW + 2 * a.max_half;       // window row stride
  constexpr int RB = 4, CB = 3;             // rows and columns of a load batch
  for (int i0 = ty; i0 < rows; i0 += RB * TY) {
    float v[RB][CB];
#pragma unroll
    for (int u = 0; u < RB; ++u) {
      const int i = i0 + u * TY;
      const float* row = src + static_cast<size_t>(clampi(r0 - half + i, 0, H - 1)) * W;
#pragma unroll
      for (int n = 0; n < CB; ++n) {
        const int j = tx + n * TW;
        v[u][n] = (i < rows && j < span) ? __ldcg(row + clampi(c0 - half + j, 0, W - 1)) : 0.0f;
      }
      for (int j = tx + CB * TW; i < rows && j < span; j += TW)   // half-widths over TW
        win[i * ws + j] = __ldcg(row + clampi(c0 - half + j, 0, W - 1));
    }
#pragma unroll
    for (int u = 0; u < RB; ++u) {
#pragma unroll
      for (int n = 0; n < CB; ++n) {
        const int i = i0 + u * TY, j = tx + n * TW;
        if (i < rows && j < span) win[i * ws + j] = v[u][n];
      }
    }
  }
  __syncthreads();
  for (int i = ty; i < rows; i += 2 * TY) {
    const int i2 = min(i + TY, rows - 1);   // the second row (a copy of the last when past it)
    const float* w0 = win + i * ws + b;
    const float* w1 = win + i2 * ws + b;
    float acc0 = 0.0f, acc1 = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float t = tp[k];
      acc0 += t * w0[k];
      acc1 += t * w1[k];
    }
    hb[i * TW + tx] = acc0;
    if (i + TY < rows) hb[(i + TY) * TW + tx] = acc1;
  }
  __syncthreads();
  if (c < W) {
    const int nr = min(th, H - r0);          // output rows of this tile
    for (int i = ty; i < nr; i += 2 * TY) {
      const int i2 = min(i + TY, nr - 1);
      float acc0 = 0.0f, acc1 = 0.0f;
      for (int k = 0; k < K; ++k) {
        const float t = tp[k];
        acc0 += t * hb[(i + k) * TW + tx];
        acc1 += t * hb[(i2 + k) * TW + tx];
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int ii = u == 0 ? i : i + TY;
        if (ii >= nr) break;
        const float acc = u == 0 ? acc0 : acc1;
        const size_t at = static_cast<size_t>(r0 + ii) * W + c;
        const float x = win[(ii + half) * ws + tx + half];   // level l at (r, c)
        dst[at] = acc;
        dog[at] = acc - x;
        if (copy) a.blurs[0][at] = x;
        if (ds) otile[ii * TW + tx] = ds == 2 ? x : acc;
      }
    }
  }
  if (ds) {
    // the next octave's base over this tile's area (th and c0 even, so each
    // 2x2 block, edge pairs included, lies inside the tile): shrink, or the
    // 2x2 mean (rows paired first, then columns, each pair 0.5*a + 0.5*b; on
    // an odd edge the last row or column pairs with itself), as the plain
    // ladder's downsample_octave
    __syncthreads();
    const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
    float* next = a.blurs[o + 1];
    for (int q = ty * TW + tx; q < (th / 2) * (TW / 2); q += TW * TY) {
      const int i = r0 / 2 + q / (TW / 2), j = c0 / 2 + q % (TW / 2);
      if (i >= Ho || j >= Wo) continue;
      const int lr = 2 * i - r0, lc = 2 * j - c0;
      float v;
      if (!a.bin) {
        v = otile[lr * TW + lc];
      } else {
        const int lr1 = min(2 * i + 1, H - 1) - r0, lc1 = min(2 * j + 1, W - 1) - c0;
        const float y0 = 0.5f * otile[lr * TW + lc] + 0.5f * otile[lr1 * TW + lc];
        const float y1 = 0.5f * otile[lr * TW + lc1] + 0.5f * otile[lr1 * TW + lc1];
        v = 0.5f * y0 + 0.5f * y1;
      }
      next[static_cast<size_t>(i) * Wo + j] = v;
    }
  }
  __syncthreads();                          // shared memory is reused by the next tile
}

// One tile (`lt`-th) of a mask item of K2m: extrema_tile.cuh's body on the
// octave's DoG stack, read through L2 (other blocks wrote it in earlier
// steps), in the shared memory `ring` after the taps.
__device__ __forceinline__ void small_octave_extrema_tile(const SmallOctaves& a, const int* it,
                                                       int lt, float* ring) {
  const int o = it[0], tiles_x = it[5];
  sift_mask::extrema_tile<true>(a.dogs[o], a.n_dogs, sift_mask::slots(a.n_dogs), it[2], it[3],
                                a.bd, a.strong_thresh, a.eths[o], a.masks[o],
                                (lt / tiles_x) * sift_mask::TH, (lt % tiles_x) * sift_mask::TW,
                                ring, threadIdx.y * TW + threadIdx.x);
  __syncthreads();                          // shared memory is reused by the next tile
}

// The body of K2 (kMask = false) and K2m (kMask = true: the work list also
// holds mask items).
template <bool kMask>
__device__ __forceinline__ void small_octaves_body(const SmallOctaves& a) {
  extern __shared__ __align__(16) float smem16[];
  const int rows = MAX_TH + 2 * a.max_half;
  float* st = smem16;
  float* win = st + ((a.n_taps + 3) & ~3);  // 16-byte aligned: a mask tile's ring
  float* hb = win + rows * (TW + 2 * a.max_half);
  float* otile = hb + rows * TW;
  const int tid = threadIdx.y * TW + threadIdx.x;
  for (int i = tid; i < a.n_taps; i += TW * TY) st[i] = a.taps[i];
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  const int n_steps = a.table[0];
  const int* items = a.table + n_steps + 2;
  for (int s = 0; s < n_steps; ++s) {
    const int i0 = a.table[1 + s], i1 = a.table[2 + s];
    const int tiles = items[(i1 - 1) * ITEM_INTS + 7];
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int i = i0;
      while (t >= items[i * ITEM_INTS + 7]) ++i;
      const int* it = items + i * ITEM_INTS;
      if constexpr (kMask) {
        if (it[11]) {
          small_octave_extrema_tile(a, it, t - it[6], win);
          continue;
        }
      }
      small_octave_tile(a, it, t - it[6], st, win, hb, otile);
    }
    if (s + 1 < n_steps) grid.sync();
  }
}

__global__ void __launch_bounds__(TW * TY) small_octaves_kernel(SmallOctaves a) {
  small_octaves_body<false>(a);
}

// K2m, held to 128 registers so that two blocks an SM stay resident, as
// K2's (left free, ptxas gave it 167).
__global__ void __launch_bounds__(TW * TY, 2) small_octaves_kernel_masks(SmallOctaves a) {
  small_octaves_body<true>(a);
}

// K2's kernel, or K2m's.
template <bool kMask>
constexpr auto small_octaves_fn() {
  if constexpr (kMask) return small_octaves_kernel_masks;
  else return small_octaves_kernel;
}

size_t level_smem(int K) {
  const int half = (K - 1) / 2;
  return sizeof(float) * (((K + 3) & ~3) + static_cast<size_t>(TH + 2 * half) * TW);
}

// The largest dynamic shared memory a block may opt into on the current
// device, queried once a device.
cudaError_t max_block_smem(size_t* out) {
  constexpr int kDevs = 64;
  static int cached[kDevs] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kDevs) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int v = 0;
    e = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return e;
    cached[dev] = v;
  }
  *out = static_cast<size_t>(cached[dev]);
  return cudaSuccess;
}

// Sets `kernel`'s dynamic shared memory limit to `smem` once a device
// (`done` is the caller's per-kernel table).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, bool* done) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e == cudaSuccess) done[dev] = true;
  return e;
}

// One launch of blur_level_kernel<K> (K odd, 3 <= K <= LK_MAX), or of
// blur_level_any_kernel for any other K.
template <int K>
cudaError_t launch_level(const float* src, float* dst, float* dog, int H, int W,
                         const float* taps, int k, cudaStream_t s, size_t max_smem) {
  if constexpr (K <= LK_MAX) {
    if (k != K) return launch_level<K + 2>(src, dst, dog, H, W, taps, k, s, max_smem);
    constexpr size_t smem = level_tile_smem(K);
    static bool done[64] = {};
    if (smem > max_smem) return cudaErrorInvalidValue;
    cudaError_t e = allow_smem(blur_level_kernel<K>, smem, done);
    if (e != cudaSuccess) return e;
    const dim3 grid((W + LW - 1) / LW, (H + LH - 1) / LH);
    blur_level_kernel<K><<<grid, LNT, smem, s>>>(src, dst, dog, H, W, taps);
    return cudaGetLastError();
  } else {
    const size_t smem = level_smem(k);
    static bool done[64] = {};
    if (smem > max_smem) return cudaErrorInvalidValue;
    cudaError_t e = allow_smem(blur_level_any_kernel, smem, done);
    if (e != cudaSuccess) return e;
    const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
    blur_level_any_kernel<<<grid, dim3(TW, TY), smem, s>>>(src, dst, dog, H, W, taps, k);
    return cudaGetLastError();
  }
}

// One level launch of K1's and K9's kernel.
cudaError_t blur_level(const float* src, float* dst, float* dog, int H, int W,
                       const float* taps, int K, cudaStream_t s) {
  if (K < 1 || (K & 1) == 0 || H < 1 || W < 1) return cudaErrorInvalidValue;
  size_t max_smem = 0;
  cudaError_t e = max_block_smem(&max_smem);
  if (e != cudaSuccess) return e;
  return launch_level<3>(src, dst, dog, H, W, taps, K, s, max_smem);
}

// K1: level 0 the pre-blur of img, then levels 1..n_levels and their DoGs.
cudaError_t octave0(const float* img, float* blurs, float* dogs, int H, int W,
                    const float* taps, const int* offsets, const int* sizes, int n_levels,
                    cudaStream_t s) {
  cudaError_t e = blur_level(img, blurs, nullptr, H, W, taps + offsets[0], sizes[0], s);
  const size_t plane = static_cast<size_t>(H) * W;
  for (int l = 0; l < n_levels && e == cudaSuccess; ++l)
    e = blur_level(blurs + l * plane, blurs + (l + 1) * plane, dogs + l * plane, H, W,
                   taps + offsets[1 + l], sizes[1 + l], s);
  return e;
}

// The arguments of K2 and K2m's cooperative launch.
cudaError_t small_octaves_args(int n_oct, const void* const* blurs, const void* const* dogs,
                               const void* base1, const void* taps, int n_taps, int max_half,
                               const void* table, int bin, SmallOctaves* a) {
  if (n_oct < 1 || n_oct > SIFT_MAX_OCT || n_taps < 1 || max_half < 0)
    return cudaErrorInvalidValue;
  *a = SmallOctaves{};
  a->bin = bin;
  a->n_taps = n_taps;
  a->max_half = max_half;
  a->base1 = static_cast<const float*>(base1);
  a->taps = static_cast<const float*>(taps);
  a->table = static_cast<const int*>(table);
  for (int o = 0; o < n_oct; ++o) {
    a->blurs[o] = static_cast<float*>(const_cast<void*>(blurs[o]));
    a->dogs[o] = static_cast<float*>(const_cast<void*>(dogs[o]));
  }
  return cudaSuccess;
}

// One cooperative launch of K2's kernel (kMask = false) or K2m's on
// `blocks` blocks.
template <bool kMask>
cudaError_t launch_small_octaves(SmallOctaves& a, int blocks, cudaStream_t s) {
  if (blocks < 1) return cudaErrorInvalidValue;
  const size_t smem = small_octaves_smem(a.n_taps, a.max_half, kMask ? a.n_dogs : 0);
  cudaError_t e = cudaFuncSetAttribute(small_octaves_fn<kMask>(),
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(small_octaves_fn<kMask>()),
                                  dim3(blocks), dim3(TW, TY), args, smem, s);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Blocks of K2's (kMask = false) or K2m's cooperative launch: as many as
// fit on the card at once, at most two an SM.
template <bool kMask>
cudaError_t small_octaves_grid(size_t smem, int* blocks) {
  int dev = 0, sms = 0, max_smem = 0, per_sm = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  if (smem > static_cast<size_t>(max_smem)) return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(small_octaves_fn<kMask>(),
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, small_octaves_fn<kMask>(),
                                                      TW * TY, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = sms * min(per_sm, 2);
  return cudaSuccess;
}

}  // namespace

// K1.  img: (H, W) f32, the normalized (and doubled, if asked) image.
// blurs: (n_levels + 1, H, W) f32; dogs: (n_levels, H, W) f32.
// taps: device f32, every level's taps back to back, entry l at offsets[l]
// with sizes[l] taps: entry 0 the pre-blur (level 0 = blur of img), entries
// 1..n_levels the increments.
extern "C" int sift_octave0_ladder(const void* img, void* blurs, void* dogs, int H, int W,
                                   const void* taps, const int* offsets, const int* sizes,
                                   int n_levels, void* stream) {
  return octave0(static_cast<const float*>(img), static_cast<float*>(blurs),
                 static_cast<float*>(dogs), H, W, static_cast<const float*>(taps), offsets,
                 sizes, n_levels, static_cast<cudaStream_t>(stream));
}

// K1m.  K1, plus mask: (n_levels - 2, H - 2bd, W - 2bd) uint8, the extrema
// mask of octave 0 at strong_thresh (0.8 peak_thresh) and edge threshold
// eth: K1's launches, then one launch of K8's kernel on the DoG stack.
// Needs n_levels >= 3, bd >= 1 and H, W > 2bd.
extern "C" int sift_octave0_ladder_mask(const void* img, void* blurs, void* dogs, void* mask,
                                        int H, int W, const void* taps, const int* offsets,
                                        const int* sizes, int n_levels, int bd,
                                        float strong_thresh, float eth, void* stream) {
  if (mask == nullptr || n_levels < 3 || bd < 1 || H <= 2 * bd || W <= 2 * bd)
    return cudaErrorInvalidValue;
  const int e = sift_octave0_ladder(img, blurs, dogs, H, W, taps, offsets, sizes, n_levels,
                                    stream);
  if (e != cudaSuccess) return e;
  const void* d = dogs;
  const long long at = 0;
  return sift_extrema_masks(1, &d, &H, &W, &eth, &at, n_levels, bd, strong_thresh, mask,
                            stream);
}

// K9.  src, dst: (H, W) f32; taps: device f32, K of them (odd).  dst is src
// correlated with the taps along rows, then along columns, each pass
// clamping its reads to the plane's edges.
extern "C" int sift_separable_blur(const void* src, void* dst, int H, int W, const void* taps,
                                   int K, void* stream) {
  return blur_level(static_cast<const float*>(src), static_cast<float*>(dst), nullptr, H, W,
                    static_cast<const float*>(taps), K, static_cast<cudaStream_t>(stream));
}

// Blocks of K2's cooperative launch (n_dogs = 0), or of K2m's for octaves
// of n_dogs DoG planes: as many as fit on the card at once, at most two an
// SM, for taps of n_taps floats and half-width max_half.
extern "C" int sift_small_octaves_ladder_grid(int n_taps, int max_half, int n_dogs,
                                              int* blocks) {
  if (n_taps < 1 || max_half < 0 || n_dogs < 0 || blocks == nullptr)
    return cudaErrorInvalidValue;
  const size_t smem = small_octaves_smem(n_taps, max_half, n_dogs);
  return n_dogs > 0 ? small_octaves_grid<true>(smem, blocks)
                    : small_octaves_grid<false>(smem, blocks);
}

// K2.  n_oct octaves with sizes ceil-halved from base1's (H, W); blurs[o]:
// (n_levels + 1, h_o, w_o) f32, dogs[o]: (n_levels, h_o, w_o) f32, all
// written here (level 0 of the first from base1, of the others from the
// octave before's level `scales`: bin != 0, its 2x2 mean, else shrink).
// taps: the n_levels increments' n_taps taps back to back, max_half their
// largest half-width; table: the work list of small_octaves_schedule on the
// device; blocks: sift_small_octaves_ladder_grid's count (or fewer).  One
// cooperative launch; a refused launch returns its error.
extern "C" int sift_small_octaves_ladder(int n_oct, const void* const* blurs,
                                         const void* const* dogs, const void* base1,
                                         const void* taps, int n_taps, int max_half,
                                         const void* table, int bin, int blocks,
                                         void* stream) {
  SmallOctaves a;
  cudaError_t e = small_octaves_args(n_oct, blurs, dogs, base1, taps, n_taps, max_half, table,
                                     bin, &a);
  if (e != cudaSuccess) return e;
  return launch_small_octaves<false>(a, blocks, static_cast<cudaStream_t>(stream));
}

// K2m.  K2, plus masks[o]: (n_dogs - 2, h_o - 2bd, w_o - 2bd) uint8, octave
// o's extrema mask at strong_thresh and its edge threshold eths[o]; n_dogs
// is n_levels, table holds the mask items (small_octaves_schedule with
// mask_bd = bd) and blocks is the grid entry's count for n_dogs.  One
// cooperative launch.
extern "C" int sift_small_octaves_ladder_mask(int n_oct, const void* const* blurs,
                                              const void* const* dogs, void* const* masks,
                                              const void* base1, const void* taps, int n_taps,
                                              int max_half, const void* table, int bin,
                                              int n_dogs, int bd, float strong_thresh,
                                              const float* eths, int blocks, void* stream) {
  if (masks == nullptr || eths == nullptr || n_dogs < 3 || bd < 1) return cudaErrorInvalidValue;
  SmallOctaves a;
  cudaError_t e = small_octaves_args(n_oct, blurs, dogs, base1, taps, n_taps, max_half, table,
                                     bin, &a);
  if (e != cudaSuccess) return e;
  for (int o = 0; o < n_oct; ++o) {
    a.masks[o] = static_cast<unsigned char*>(masks[o]);
    a.eths[o] = eths[o];
  }
  a.n_dogs = n_dogs;
  a.bd = bd;
  a.strong_thresh = strong_thresh;
  return launch_small_octaves<true>(a, blocks, static_cast<cudaStream_t>(stream));
}
