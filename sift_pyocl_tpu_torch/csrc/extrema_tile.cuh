// The extrema-mask body on one tile, shared by K8 (maskk.cu's mask_kernel,
// which K1m also launches on octave 0) and K2m (ladder.cu's
// small_octaves_kernel_masks, inside its one cooperative launch), so that
// the three masks are one code.
//
// A block of NT threads owns a TH x TW tile of one octave's border-stripped
// (S-2, H-2bd, W-2bd) mask and walks the scale planes over a ring of R
// staged DoG planes (each with a one-pixel halo, read at clamped indices):
//   * register sliding window: a thread owns a strip of STRIP = 8 rows of
//     one column; for each of the three planes it keeps the 3 x 3
//     neighbourhood in registers and slides it down the strip, so a row
//     step reads 3 new values a plane (9 in all, not 27);
//   * the 26-neighbour comparison and the Hessian run only where
//     |v| > strong_thresh, the same boolean sift_is_extremum starts from,
//     so the mask bits cannot change and most pixels skip them;
//   * asynchronous staging: the tile's whole DoG stack (up to RMAX = 6
//     planes, scales <= 4; with R >= 4 slots a deeper stack refills the
//     slot of plane p - 1) is put in flight at once by cp.async, one commit
//     group a plane, and planes p..p+2 are compared as soon as they land
//     while the later ones load: 16 bytes a copy where the window lies
//     inside the plane and its rows are 16-byte aligned, else 4 bytes an
//     element at the clamped address;
//   * stores: a plane's mask tile is staged in shared memory and written a
//     32-bit word at a time wherever four of a row's bytes share a word,
//     bytes at the row's two ends; plane p's tile is written while plane
//     p + 1 is compared.
// kL2 (K2m): the DoG planes were written by other blocks earlier in the
// same launch, and the read-only and L1 paths are not coherent with such
// writes, so every read goes through L2: 16-byte cp.async.cg, and __ldcg
// (batched into registers, then stored to shared memory) where K8 makes
// 4-byte cp.async copies, whose only form (.ca) may be served by L1.
#pragma once

#include <cstdint>
#include <cuda_pipeline.h>

#include "common.cuh"

namespace sift_mask {

constexpr int TH = 32;              // mask rows per tile
constexpr int TW = 64;              // mask cols per tile
constexpr int NT = 256;             // threads per block
constexpr int SH = TH + 2;          // tile rows with the halo
constexpr int SW = TW + 2;          // tile cols with the halo
constexpr int SP = TW + 4;          // shared-memory row pitch (16-byte rows)
constexpr int STRIP = TH * TW / NT; // rows of one thread's column: 8
constexpr int RMAX = 6;             // DoG plane slots at most (a tile's whole stack up to scales = 4)
constexpr int PLANE_FLOATS = SH * SP;  // one staged plane
constexpr int WPR = TW / 4 + 1;     // 32-bit words a tile row can touch

// Dynamic shared memory of one tile: R plane slots, then the two mask tiles.
__host__ __device__ constexpr size_t smem_bytes(int R) {
  return sizeof(float) * static_cast<size_t>(R) * PLANE_FLOATS + 2 * TH * TW;
}

// Plane slots a tile of an S-plane stack uses: the whole stack up to RMAX.
__host__ __device__ constexpr int slots(int S) { return S < RMAX ? S : RMAX; }

// 16 bytes global -> shared, asynchronously; kL2: through L2 only.
template <bool kL2>
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  if constexpr (kL2) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  } else {
    __pipeline_memcpy_async(dst, src, 16);
  }
}

// dst[i * SP + j] = plane[clamp(r0 - 1 + i)][clamp(c0 - 1 + j)] for the SH x SW
// window, as one commit group.  `fast` (the window lies inside the plane, its
// first column and row pitch are 16-byte aligned): each row as 16 copies
// of 16 bytes and 2 of 4, no clamps; else element by element, clamped.
template <bool kL2>
__device__ __forceinline__ void stage_plane(float* dst, const float* __restrict__ plane, int H,
                                            int W, int r0, int c0, bool fast, int tid) {
  const float* src = plane + static_cast<long long>(r0 - 1) * W + (c0 - 1);
  if (fast) {
    for (int k = tid; k < SH * (TW / 4 + 2); k += NT) {
      if (k < SH * (TW / 4)) {
        const int i = k / (TW / 4), q = k - (k / (TW / 4)) * (TW / 4);
        copy16<kL2>(dst + i * SP + 4 * q, src + static_cast<long long>(i) * W + 4 * q);
      } else {
        const int e = k - SH * (TW / 4), i = e >> 1, j = TW + (e & 1);
        if constexpr (kL2)
          dst[i * SP + j] = __ldcg(src + static_cast<long long>(i) * W + j);
        else
          __pipeline_memcpy_async(dst + i * SP + j, src + static_cast<long long>(i) * W + j,
                                  sizeof(float));
      }
    }
  } else if constexpr (kL2) {
    constexpr int PER = (SH * SW + NT - 1) / NT;   // elements a thread
    float v[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int k = tid + u * NT;
      if (k < SH * SW) {
        const int i = k / SW, j = k - (k / SW) * SW;
        const int r = min(max(r0 - 1 + i, 0), H - 1);
        const int c = min(max(c0 - 1 + j, 0), W - 1);
        v[u] = __ldcg(plane + static_cast<long long>(r) * W + c);
      }
    }
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int k = tid + u * NT;
      if (k < SH * SW) dst[(k / SW) * SP + k - (k / SW) * SW] = v[u];
    }
  } else {
    for (int k = tid; k < SH * SW; k += NT) {
      const int i = k / SW, j = k - (k / SW) * SW;
      const int r = min(max(r0 - 1 + i, 0), H - 1);
      const int c = min(max(c0 - 1 + j, 0), W - 1);
      __pipeline_memcpy_async(dst + i * SP + j, plane + static_cast<long long>(r) * W + c,
                              sizeof(float));
    }
  }
  __pipeline_commit();
}

// The staged (rows x cols) mask tile to the rows of `out` (row pitch Wm)
// starting at `first`: a 32-bit store wherever four of a row's bytes share
// an aligned word, single bytes at the ends.
__device__ __forceinline__ void store_tile(const unsigned char* mt, unsigned char* first,
                                           int rows, int cols, int Wm, int tid) {
  for (int it = tid; it < TH * WPR; it += NT) {
    const int r = it / WPR, w = it - (it / WPR) * WPR;
    if (r >= rows) continue;
    unsigned char* base = first + static_cast<long long>(r) * Wm;
    const int c = 4 * w - static_cast<int>(reinterpret_cast<uintptr_t>(base) & 3u);
    if (c >= cols || c + 3 < 0) continue;
    if (c >= 0 && c + 3 < cols) {
      const unsigned char* m = mt + r * TW + c;
      *reinterpret_cast<unsigned*>(base + c) =
          static_cast<unsigned>(m[0]) | static_cast<unsigned>(m[1]) << 8 |
          static_cast<unsigned>(m[2]) << 16 | static_cast<unsigned>(m[3]) << 24;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (c + k >= 0 && c + k < cols) base[c + k] = mt[r * TW + c + k];
    }
  }
}

// The mask tile whose first mask row and column are (i0, j0), of the octave
// whose (S, H, W) DoG stack is `d` and whose (S-2, H-2bd, W-2bd) mask is
// `mask`, at thresholds strong_thresh and eth.  `smem` holds smem_bytes(R)
// (16-byte aligned); R = slots(S), or any R >= 4.  Every thread of the
// block calls it (tid = its index, 0..NT-1); it synchronises, and the
// caller synchronises again before reusing `smem`.
template <bool kL2>
__device__ __forceinline__ void extrema_tile(const float* __restrict__ d, int S, int R, int H,
                                             int W, int bd, float strong_thresh, float eth,
                                             unsigned char* __restrict__ mask, int i0, int j0,
                                             float* smem, int tid) {
  float* ring = smem;                                   // plane q in slot q % R
  unsigned char(*mt)[TH][TW] = reinterpret_cast<unsigned char(*)[TH][TW]>(smem + R * PLANE_FLOATS);
  const int Hm = H - 2 * bd, Wm = W - 2 * bd;
  const int rows = min(TH, Hm - i0), cols = min(TW, Wm - j0);
  const long long plane = static_cast<long long>(H) * W;
  unsigned char* mo = mask + static_cast<long long>(i0) * Wm + j0;
  const long long mplane = static_cast<long long>(Hm) * Wm;

  const int r0 = bd + i0, c0 = bd + j0;       // the tile's first DoG row and column
  const bool fast = W % 4 == 0 && (c0 - 1) % 4 == 0 && c0 - 1 + SW <= W && r0 - 1 + SH <= H &&
                    (reinterpret_cast<uintptr_t>(d) & 15u) == 0;
  // every slot's plane in flight at once (the whole stack when S <= RMAX)
  for (int q = 0; q < R; ++q)
    stage_plane<kL2>(ring + q * PLANE_FLOATS, d + q * plane, H, W, r0, c0, fast, tid);
  int issued = R;
  const int x = tid % TW;             // the thread's column in the tile
  const int y0 = (tid / TW) * STRIP;  // its first row
  for (int p = 0; p < S - 2; ++p) {
    // planes p..p+2 have landed (this thread's copies); the later ones may
    // still be in flight
    switch (min(issued - (p + 3), 3)) {
      case 0: __pipeline_wait_prior(0); break;
      case 1: __pipeline_wait_prior(1); break;
      case 2: __pipeline_wait_prior(2); break;
      default: __pipeline_wait_prior(3); break;
    }
    __syncthreads();  // ... everyone's; plane p - 1's slot and mt[p & 1] are free
    if (p > 0) store_tile(&mt[(p - 1) & 1][0][0], mo + (p - 1) * mplane, rows, cols, Wm, tid);
    if (p > 0 && issued < S) {  // a stack deeper than R: refill plane p - 1's slot
      stage_plane<kL2>(ring + ((p - 1) % R) * PLANE_FLOATS, d + issued * plane, H, W, r0, c0,
                       fast, tid);
      ++issued;
    }
    if (x < cols) {
      const float* pl[3] = {ring + (p % R) * PLANE_FLOATS, ring + ((p + 1) % R) * PLANE_FLOATS,
                            ring + ((p + 2) % R) * PLANE_FLOATS};
      float n[3][3][3];
#pragma unroll
      for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int dy = 0; dy < 2; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) n[q][dy][dx] = pl[q][(y0 + dy) * SP + x + dx];
#pragma unroll
      for (int k = 0; k < STRIP; ++k) {
#pragma unroll
        for (int q = 0; q < 3; ++q)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) n[q][2][dx] = pl[q][(y0 + k + 2) * SP + x + dx];
        bool hit = false;
        if (fabsf(n[1][1][1]) > strong_thresh) hit = sift_is_extremum(n, strong_thresh, eth);
        mt[p & 1][y0 + k][x] = hit ? 1 : 0;
#pragma unroll
        for (int q = 0; q < 3; ++q)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            n[q][0][dx] = n[q][1][dx];
            n[q][1][dx] = n[q][2][dx];
          }
      }
    }
  }
  __syncthreads();
  store_tile(&mt[(S - 3) & 1][0][0], mo + (S - 3) * mplane, rows, cols, Wm, tid);
}

}  // namespace sift_mask

// K8's launcher (maskk.cu), which K1m (ladder.cu) also calls for octave 0.
extern "C" int sift_extrema_masks(int n_oct, const void* const* dogs, const int* hs,
                                  const int* ws, const float* eths,
                                  const long long* outoff, int n_dogs, int bd,
                                  float strong_thresh, void* out, void* stream);
