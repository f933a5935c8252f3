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
// (about 8 MB); the compare tree (about 70 operations a pixel and plane) is
// far below the f32 rate.  The TPU kernel DMAs 56-row strips of a padded
// DoG atlas holding all scale planes and zeroes what lies outside each
// octave's border window.  Here a block owns a TH x TW tile of one octave's
// mask and walks the scale planes with a rolling window of three DoG planes
// (with a one-pixel halo, read at clamped indices) in shared memory, so
// each plane is loaded once per tile and neither the atlas nor its padding
// exists.
#include "common.cuh"

namespace {

constexpr int TH = 32;            // mask rows per tile
constexpr int TW = 64;            // mask cols per tile
constexpr int NT = 256;           // threads per block
constexpr int SH = TH + 2;        // tile rows with the halo
constexpr int SW = TW + 2;        // tile cols with the halo
constexpr int ROW_STEP = NT / TW; // rows apart of one thread's pixels

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

// dst[i][j] = plane[clamp(r0 - 1 + i)][clamp(c0 - 1 + j)]
__device__ __forceinline__ void load_plane(float (*dst)[SW], const float* __restrict__ plane,
                                           int H, int W, int r0, int c0) {
  for (int k = threadIdx.x; k < SH * SW; k += NT) {
    const int i = k / SW, j = k - (k / SW) * SW;
    const int r = min(max(r0 - 1 + i, 0), H - 1);
    const int c = min(max(c0 - 1 + j, 0), W - 1);
    dst[i][j] = __ldg(plane + static_cast<long long>(r) * W + c);
  }
}

__global__ void __launch_bounds__(NT) mask_kernel(MaskMeta m, int S, int bd,
                                                  float strong_thresh,
                                                  unsigned char* __restrict__ out) {
  __shared__ float ring[3][SH][SW];
  const int t = blockIdx.x;
  int o = 0;
  while (o + 1 < m.n_oct && t >= m.tile0[o + 1]) ++o;
  const int H = m.H[o], W = m.W[o];
  const int Hm = H - 2 * bd, Wm = W - 2 * bd;
  const int lt = t - m.tile0[o];
  const int i0 = (lt / m.tiles_x[o]) * TH;  // first mask row of the tile
  const int j0 = (lt % m.tiles_x[o]) * TW;  // first mask col of the tile
  const long long plane = static_cast<long long>(H) * W;
  const float* d = m.dogs[o];
  const float eth = m.eth[o];
  unsigned char* mo = out + m.outoff[o];

  for (int q = 0; q < 3; ++q) load_plane(ring[q], d + q * plane, H, W, bd + i0, bd + j0);
  __syncthreads();
  const int x = threadIdx.x % TW + 1;  // column in the ring (halo at 0)
  const int j = j0 + x - 1;
  for (int p = 0; p < S - 2; ++p) {
    // ring slot p % 3 holds DoG plane p, the next two planes p+1 and p+2
    const float (*lo)[SW] = ring[p % 3];
    const float (*mid)[SW] = ring[(p + 1) % 3];
    const float (*hi)[SW] = ring[(p + 2) % 3];
    for (int y = threadIdx.x / TW + 1; y <= TH; y += ROW_STEP) {
      const int i = i0 + y - 1;
      if (i >= Hm || j >= Wm) continue;
      float n[3][3][3];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          n[0][dy][dx] = lo[y + dy - 1][x + dx - 1];
          n[1][dy][dx] = mid[y + dy - 1][x + dx - 1];
          n[2][dy][dx] = hi[y + dy - 1][x + dx - 1];
        }
      }
      mo[(static_cast<long long>(p) * Hm + i) * Wm + j] =
          sift_is_extremum(n, strong_thresh, eth) ? 1 : 0;
    }
    __syncthreads();  // every thread is done with slot p % 3
    if (p + 3 < S) {
      load_plane(ring[p % 3], d + (p + 3) * plane, H, W, bd + i0, bd + j0);
      __syncthreads();
    }
  }
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
  mask_kernel<<<tiles, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      m, n_dogs, bd, strong_thresh, static_cast<unsigned char*>(out));
  return static_cast<int>(cudaGetLastError());
}
