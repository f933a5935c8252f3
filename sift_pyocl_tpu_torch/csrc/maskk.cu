// K8: the DoG extrema masks of every octave in one call.
//
// Replaces sift_pyocl_tpu/ops/pallas/maskk.py::extrema_masks_atlas_pallas.
// For octave o, scale plane s = 1..S-2 and pixel (r, c) inside the border
// (bd <= r < H-bd, bd <= c < W-bd) the mask is 1 iff |v| > strong_thresh,
// v is strictly greater (or strictly smaller) than all 26 neighbours in
// planes s-1..s+1, and the 2x2 spatial Hessian passes det > 0 and
// det >= (eth*tr)*tr.  Octave o's border-stripped (S-2, H-2bd, W-2bd) mask
// is written as uint8 0/1 at out + outoff[o].  The per-pixel test is
// common.cuh's sift_is_extremum; it follows the plain PyTorch stencil
// (ops/kernels/maskk.py::extrema_mask) operation by operation, and the
// library is built with --fmad=false, so the masks are equal bit for bit.
// The per-tile body is extrema_tile.cuh's extrema_tile, which the in-ladder
// masks run too: K1m launches this kernel on octave 0 after K1's levels,
// and K2m runs the body inside its cooperative launch (ladder.cu).
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
// 216 M shared loads over the 1080p pyramid): 0.080 ms on an H100.  This one
// (extrema_tile.cuh): a register sliding window down each thread's 8-row strip,
// the comparison gated by |v| > strong_thresh, the tile's whole DoG stack in
// flight by cp.async (16-byte copies where the window is aligned: 94 % of
// octave 0's tiles at 1080x1920), 32-bit mask stores.  (A ring of four
// slots, plane p + 3 alone loading while p..p+2 were compared, kept a single
// plane in flight a block, and its loads were latency-bound.)
// What still holds it back: the four blocks an SM (50 KB of shared memory
// each) start together and stay in step, so a wave's loads and its
// comparisons add up more than they overlap, and 1369 tiles make 2.6 waves
// of 528 at 1080x1920.  A persistent variant (4 blocks an SM, each
// streaming its next tile's planes into freed slots during the comparison)
// was slower.
#include "extrema_tile.cuh"

using namespace sift_mask;

namespace {

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

// One tile a block (extrema_tile.cuh's body); 4 blocks an SM (50 KB of shared
// memory each at R = 5): 64 registers
__global__ void __launch_bounds__(NT, 4) mask_kernel(MaskMeta m, int S, int R, int bd,
                                                     float strong_thresh,
                                                     unsigned char* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int t = blockIdx.x;
  int o = 0;
  while (o + 1 < m.n_oct && t >= m.tile0[o + 1]) ++o;
  const int lt = t - m.tile0[o];
  extrema_tile<false>(m.dogs[o], S, R, m.H[o], m.W[o], bd, strong_thresh, m.eth[o],
                      out + m.outoff[o], (lt / m.tiles_x[o]) * TH, (lt % m.tiles_x[o]) * TW,
                      smem, threadIdx.x);
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
  const int R = slots(n_dogs);
  mask_kernel<<<tiles, NT, smem_bytes(R), static_cast<cudaStream_t>(stream)>>>(
      m, n_dogs, R, bd, strong_thresh, static_cast<unsigned char*>(out));
  return static_cast<int>(cudaGetLastError());
}
