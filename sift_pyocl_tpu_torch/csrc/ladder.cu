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
// What bounds them on the card: bytes.  Octave 0 at 1080x1920 reads the
// 8.3 MB image and writes 11 planes of 8.3 MB (6 blurs, 5 DoGs); its
// arithmetic (about 106 taps a pixel, two passes) is far below the card's
// float rate.  The small octaves hold a third of those bytes in planes too
// small to fill the card, so K2 is bound by launch latency.
//
// Design (simple first): ONE launch per blur level.  A block owns a tile of
// TW x TH output pixels.  Its horizontal pass reads the previous level
// through the read-only cache at clamped row and column indices -- which is
// exactly the clamp-to-edge of that level (the clamp belongs to the level
// being blurred, not to a padded earlier one) -- for the TH + 2*half rows
// the vertical pass needs, into shared memory.  The vertical pass sums
// those rows, writes the blur level, and writes the DoG (this level minus
// the previous one).  Taps come from the caller's device buffer, any
// length: no strip margins, so K1 takes any sigma; the pyramid still routes
// octave 0 per level wherever the JAX package does (ops/pyramid.py), and
// K9 is then one launch of the same level kernel with no DoG, so its levels
// are bit-equal to K1's.  Each sum runs over the taps in ascending order,
// one rounding per operation (the library is built with --fmad=false).
// One C call runs a whole ladder: 6 launches for K1, and for K2 5 per octave
// plus one downsample between octaves; K9 is one launch a call.
#include "common.cuh"

namespace {

constexpr int TW = 32;   // tile columns (one warp across)
constexpr int TH = 64;   // tile rows
constexpr int TY = 8;    // warps per block

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(TW * TY)
blur_level_kernel(const float* __restrict__ src, float* __restrict__ dst,
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

// Next octave's base from level `scales`: shrink (every other pixel) or
// the 2x2 mean (rows paired first, then columns, each pair 0.5*a + 0.5*b;
// on an odd edge the last row or column pairs with itself), ceil-sized.
__global__ void downsample_kernel(const float* __restrict__ src, float* __restrict__ dst,
                                  int H, int W, int bin) {
  const int Wo = (W + 1) / 2, Ho = (H + 1) / 2;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= Ho || j >= Wo) return;
  const int r = 2 * i, c = 2 * j;
  float v;
  if (!bin) {
    v = src[static_cast<size_t>(r) * W + c];
  } else {
    const int r1 = min(r + 1, H - 1), c1 = min(c + 1, W - 1);
    const float* a = src + static_cast<size_t>(r) * W;
    const float* b = src + static_cast<size_t>(r1) * W;
    const float y0 = 0.5f * a[c] + 0.5f * b[c];
    const float y1 = 0.5f * a[c1] + 0.5f * b[c1];
    v = 0.5f * y0 + 0.5f * y1;
  }
  dst[static_cast<size_t>(i) * Wo + j] = v;
}

size_t level_smem(int K) {
  const int half = (K - 1) / 2;
  return sizeof(float) * (((K + 3) & ~3) + static_cast<size_t>(TH + 2 * half) * TW);
}

cudaError_t blur_level(const float* src, float* dst, float* dog, int H, int W,
                       const float* taps, int K, cudaStream_t s) {
  if (K < 1 || (K & 1) == 0 || H < 1 || W < 1) return cudaErrorInvalidValue;
  const size_t smem = level_smem(K);
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > static_cast<size_t>(max_smem)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(blur_level_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
  blur_level_kernel<<<grid, dim3(TW, TY), smem, s>>>(src, dst, dog, H, W, taps, K);
  return cudaGetLastError();
}

// levels 1..n_levels of one octave; blurs[0] already holds the base.
cudaError_t octave_levels(float* blurs, float* dogs, int H, int W, const float* taps,
                          const int* offsets, const int* sizes, int tap0, int n_levels,
                          cudaStream_t s) {
  const size_t plane = static_cast<size_t>(H) * W;
  for (int l = 0; l < n_levels; ++l) {
    cudaError_t e = blur_level(blurs + l * plane, blurs + (l + 1) * plane,
                               dogs + l * plane, H, W, taps + offsets[tap0 + l],
                               sizes[tap0 + l], s);
    if (e != cudaSuccess) return e;
  }
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* tp = static_cast<const float*>(taps);
  float* b = static_cast<float*>(blurs);
  cudaError_t e = blur_level(static_cast<const float*>(img), b, nullptr, H, W,
                             tp + offsets[0], sizes[0], s);
  if (e != cudaSuccess) return e;
  return octave_levels(b, static_cast<float*>(dogs), H, W, tp, offsets, sizes, 1, n_levels, s);
}

// K9.  src, dst: (H, W) f32; taps: device f32, K of them (odd).  dst is src
// correlated with the taps along rows, then along columns, each pass
// clamping its reads to the plane's edges.
extern "C" int sift_separable_blur(const void* src, void* dst, int H, int W, const void* taps,
                                   int K, void* stream) {
  return blur_level(static_cast<const float*>(src), static_cast<float*>(dst), nullptr, H, W,
                    static_cast<const float*>(taps), K, static_cast<cudaStream_t>(stream));
}

// K2.  n_oct octaves with sizes hs[o] x ws[o] (each ceil-half of the one
// before); blurs[o]: (n_levels + 1, hs[o], ws[o]) f32, blurs[0][0] already
// holds the first small octave's base; dogs[o]: (n_levels, hs[o], ws[o]).
// taps/offsets/sizes: the n_levels increments.  Level `scales` of octave o
// is downsampled (bin != 0: 2x2 mean, else shrink) into blurs[o + 1][0].
extern "C" int sift_small_octaves_ladder(int n_oct, const void* const* blurs,
                                         const void* const* dogs, const int* hs,
                                         const int* ws, const void* taps,
                                         const int* offsets, const int* sizes,
                                         int n_levels, int scales, int bin, void* stream) {
  if (n_oct < 1 || scales < 0 || scales > n_levels) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* tp = static_cast<const float*>(taps);
  for (int o = 0; o < n_oct; ++o) {
    float* b = static_cast<float*>(const_cast<void*>(blurs[o]));
    cudaError_t e = octave_levels(b, static_cast<float*>(const_cast<void*>(dogs[o])),
                                  hs[o], ws[o], tp, offsets, sizes, 0, n_levels, s);
    if (e != cudaSuccess) return e;
    if (o + 1 < n_oct) {
      if (hs[o + 1] != (hs[o] + 1) / 2 || ws[o + 1] != (ws[o] + 1) / 2)
        return cudaErrorInvalidValue;
      const dim3 blk(32, 8);
      const dim3 grid((ws[o + 1] + 31) / 32, (hs[o + 1] + 7) / 8);
      downsample_kernel<<<grid, blk, 0, s>>>(
          b + static_cast<size_t>(scales) * hs[o] * ws[o],
          static_cast<float*>(const_cast<void*>(blurs[o + 1])), hs[o], ws[o], bin);
      e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
  }
  return cudaSuccess;
}
