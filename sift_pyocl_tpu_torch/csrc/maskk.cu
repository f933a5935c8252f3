// K8: the DoG extrema masks of every octave in one call.
//
// Replaces sift_pyocl_tpu/ops/pallas/maskk.py::extrema_masks_atlas_pallas.
// For octave o, scale plane s = 1..S-2 and pixel (r, c) inside the border
// (bd <= r < H-bd, bd <= c < W-bd) the mask is 1 iff |v| > strong_thresh,
// v is strictly greater (or strictly smaller) than all 26 neighbours in
// planes s-1..s+1, and the 2x2 spatial Hessian passes det > 0 and
// det >= (eth*tr)*tr.  Octave o's border-stripped (S-2, H-2bd, W-2bd) mask
// is written as uint8 0/1 at out + outoff[o].  The per-pixel test is
// common.cuh's sift_is_extremum, which the in-ladder masks of K1/K2
// (ladder.cu) run too; it follows the plain PyTorch stencil
// (ops/kernels/maskk.py::extrema_mask) operation by operation, and the
// library is built with --fmad=false, so the masks are equal bit for bit.
//
// What bounds it on the card: bytes.  Every DoG value is read once (about
// 55 MB at 1080x1920 over 7 octaves) and every mask byte written once
// (about 8 MB): 0.019 ms at 3.35 TB/s.  The TPU kernel DMAs 56-row strips
// of a padded DoG atlas holding all scale planes and zeroes what lies
// outside each octave's border window.  Here a block owns a TH x TW tile
// of one octave's mask and walks the scale planes over a ring of DoG planes
// (with a one-pixel halo, read at clamped indices) in shared memory, so
// each plane is loaded once per tile and neither the atlas nor its padding
// exists.  The earlier body staged each plane synchronously and read a
// pixel's 27 neighbours from shared memory before the comparison (about
// 216 M shared loads over the 1080p pyramid): 0.080 ms on an H100.  This one:
//   * register sliding window: a thread owns a strip of STRIP = 8 rows of
//     one column; for each of the three planes it keeps the 3 x 3
//     neighbourhood in registers and slides it down the strip, so a row
//     step reads 3 new values a plane (9 in all, not 27);
//   * the 26-neighbour comparison and the Hessian run only where
//     |v| > strong_thresh, the same boolean sift_is_extremum starts from,
//     so the mask bits cannot change and most pixels skip them;
//   * asynchronous staging: the tile's whole DoG stack (up to RMAX = 6
//     planes, scales <= 4; a deeper stack refills the slot of plane p - 1)
//     is put in flight at once by cp.async, one commit group a plane, and
//     planes p..p+2 are compared as soon as they land while the later ones
//     load: 16 bytes a copy where the window lies inside the plane and its
//     rows are 16-byte aligned (94 % of octave 0's tiles at 1080x1920),
//     else 4 bytes an element at the clamped address.  (A ring of four
//     slots, plane p + 3 alone loading while p..p+2 were compared, kept a
//     single plane in flight a block, and its loads were latency-bound.)
//   * stores: a plane's mask tile is staged in shared memory and written a
//     32-bit word at a time wherever four of a row's bytes share a word,
//     bytes at the row's two ends; plane p's tile is written while plane
//     p + 1 is compared.
// What still holds it back: the four blocks an SM (50 KB of shared memory
// each) start together and stay in step, so a wave's loads and its
// comparisons add up more than they overlap, and 1369 tiles make 2.6 waves
// of 528 at 1080x1920.  A persistent variant (4 blocks an SM, each
// streaming its next tile's planes into freed slots during the comparison)
// was slower.
#include "common.cuh"

#include <cstdint>
#include <cuda_pipeline.h>

namespace {

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

struct MaskMeta {
  int n_oct;
  const float* dogs[SIFT_MAX_OCT];  // (S, H, W) DoG stack of each octave
  int H[SIFT_MAX_OCT];
  int W[SIFT_MAX_OCT];
  int tiles_x[SIFT_MAX_OCT];        // tiles across each octave's mask
  int tile0[SIFT_MAX_OCT + 1];      // first tile of each octave
  float eth[SIFT_MAX_OCT];          // edge threshold of each octave
  long long outoff[SIFT_MAX_OCT];   // first mask byte of each octave
};

// dst[i * SP + j] = plane[clamp(r0 - 1 + i)][clamp(c0 - 1 + j)] for the SH x SW
// window, by cp.async.  `fast` (the window lies inside the plane, its
// first column and row pitch are 16-byte aligned): each row as 16 copies
// of 16 bytes and 2 of 4, no clamps; else element by element, clamped.
__device__ __forceinline__ void stage_plane(float* dst, const float* __restrict__ plane, int H,
                                            int W, int r0, int c0, bool fast) {
  const float* src = plane + static_cast<long long>(r0 - 1) * W + (c0 - 1);
  if (fast) {
    for (int k = threadIdx.x; k < SH * (TW / 4 + 2); k += NT) {
      if (k < SH * (TW / 4)) {
        const int i = k / (TW / 4), q = k - (k / (TW / 4)) * (TW / 4);
        __pipeline_memcpy_async(dst + i * SP + 4 * q, src + static_cast<long long>(i) * W + 4 * q,
                                16);
      } else {
        const int e = k - SH * (TW / 4), i = e >> 1, j = TW + (e & 1);
        __pipeline_memcpy_async(dst + i * SP + j, src + static_cast<long long>(i) * W + j,
                                sizeof(float));
      }
    }
  } else {
    for (int k = threadIdx.x; k < SH * SW; k += NT) {
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
                                           int rows, int cols, int Wm) {
  for (int it = threadIdx.x; it < TH * WPR; it += NT) {
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

// Dynamic shared memory: R plane slots, then the two mask tiles.
constexpr size_t smem_bytes(int R) {
  return sizeof(float) * static_cast<size_t>(R) * PLANE_FLOATS + 2 * TH * TW;
}

// 4 blocks an SM (50 KB of shared memory each at R = 5): 64 registers
__global__ void __launch_bounds__(NT, 4) mask_kernel(MaskMeta m, int S, int R, int bd,
                                                     float strong_thresh,
                                                     unsigned char* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                                   // plane q in slot q % R
  unsigned char(*mt)[TH][TW] = reinterpret_cast<unsigned char(*)[TH][TW]>(smem + R * PLANE_FLOATS);
  const int t = blockIdx.x;
  int o = 0;
  while (o + 1 < m.n_oct && t >= m.tile0[o + 1]) ++o;
  const int H = m.H[o], W = m.W[o];
  const int Hm = H - 2 * bd, Wm = W - 2 * bd;
  const int lt = t - m.tile0[o];
  const int i0 = (lt / m.tiles_x[o]) * TH;  // first mask row of the tile
  const int j0 = (lt % m.tiles_x[o]) * TW;  // first mask col of the tile
  const int rows = min(TH, Hm - i0), cols = min(TW, Wm - j0);
  const long long plane = static_cast<long long>(H) * W;
  const float* d = m.dogs[o];
  const float eth = m.eth[o];
  unsigned char* mo = out + m.outoff[o] + static_cast<long long>(i0) * Wm + j0;
  const long long mplane = static_cast<long long>(Hm) * Wm;

  const int r0 = bd + i0, c0 = bd + j0;       // the tile's first DoG row and column
  const bool fast = W % 4 == 0 && (c0 - 1) % 4 == 0 && c0 - 1 + SW <= W && r0 - 1 + SH <= H &&
                    (reinterpret_cast<uintptr_t>(d) & 15u) == 0;
  // every slot's plane in flight at once (the whole stack when S <= RMAX)
  for (int q = 0; q < R; ++q)
    stage_plane(ring + q * PLANE_FLOATS, d + q * plane, H, W, r0, c0, fast);
  int issued = R;
  const int x = threadIdx.x % TW;             // the thread's column in the tile
  const int y0 = (threadIdx.x / TW) * STRIP;  // its first row
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
    if (p > 0) store_tile(&mt[(p - 1) & 1][0][0], mo + (p - 1) * mplane, rows, cols, Wm);
    if (p > 0 && issued < S) {  // a stack deeper than RMAX: refill plane p - 1's slot
      stage_plane(ring + ((p - 1) % R) * PLANE_FLOATS, d + issued * plane, H, W, r0, c0, fast);
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
  store_tile(&mt[(S - 3) & 1][0][0], mo + (S - 3) * mplane, rows, cols, Wm);
}

}  // namespace

// dogs: n_oct device pointers to contiguous (n_dogs, H[o], W[o]) f32 stacks;
// eths: each octave's edge threshold; outoff: each octave's first byte in
// `out`, which receives the (n_dogs-2, H[o]-2bd, W[o]-2bd) uint8 masks.
// Needs bd >= 1, n_dogs >= 3 and H[o], W[o] > 2bd.
extern "C" int sift_extrema_masks(int n_oct, const void* const* dogs, const int* hs,
                                  const int* ws, const float* eths,
                                  const long long* outoff, int n_dogs, int bd,
                                  float strong_thresh, void* out, void* stream) {
  if (n_oct < 1 || n_oct > SIFT_MAX_OCT || n_dogs < 3 || bd < 1) return cudaErrorInvalidValue;
  MaskMeta m = {};
  m.n_oct = n_oct;
  int tiles = 0;
  for (int o = 0; o < n_oct; ++o) {
    const int hm = hs[o] - 2 * bd, wm = ws[o] - 2 * bd;
    if (hm < 1 || wm < 1) return cudaErrorInvalidValue;
    m.dogs[o] = static_cast<const float*>(dogs[o]);
    m.H[o] = hs[o];
    m.W[o] = ws[o];
    m.tiles_x[o] = (wm + TW - 1) / TW;
    m.tile0[o] = tiles;
    tiles += m.tiles_x[o] * ((hm + TH - 1) / TH);
    m.eth[o] = eths[o];
    m.outoff[o] = outoff[o];
  }
  m.tile0[n_oct] = tiles;
  // the largest ring's shared memory, allowed once a device
  static bool allowed[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    e = cudaFuncSetAttribute(mask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes(RMAX)));
    if (e != cudaSuccess) return e;
    allowed[dev] = true;
  }
  const int R = n_dogs < RMAX ? n_dogs : RMAX;
  mask_kernel<<<tiles, NT, smem_bytes(R), static_cast<cudaStream_t>(stream)>>>(
      m, n_dogs, R, bd, strong_thresh, static_cast<unsigned char*>(out));
  return static_cast<int>(cudaGetLastError());
}
