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
//
// K1m and K2m, the mask forms (mask_cfg of the TPU kernels,
// ladder0.py:113-167 and ladder.py:225-311, SiftConfig(mask_backend=
// "fused")): the same ladders, plus each octave's border-stripped
// (n_levels-2, H-2bd, W-2bd) uint8 0/1 extrema mask, in K8's layout
// (maskk.cu), from common.cuh's sift_is_extremum, so the masks equal K8's
// and the plain stencil's bit for bit.  Mask plane p is centred on DoG p+1
// and needs DoGs p..p+2 with a one-pixel halo; in the launch that writes
// DoG l, that halo belongs to neighbouring blocks.  Design: lag by one
// level.  The launch that writes DoG l also tests plane l-3 (DoGs l-3..l-1,
// all written by earlier launches on the stream), so planes 0..n_levels-4
// ride on the blur launches and one tail launch per octave (mask_kernel)
// tests the last plane.  Recomputing the DoG halo inside each block was the
// other choice; it would widen the horizontal pass past the warp's 32
// columns and change the blur kernel, where the lag leaves the blur and DoG
// arithmetic exactly as in K1/K2 (bit-equal by construction).  The mask
// forms launch their own instance of the level body (blur_level_mask_kernel),
// so the kernel of K1, K2 and K9 carries no mask argument or branch.  The mask
// reads its 27 neighbours through the read-only cache from planes written
// one to three launches before, which at 1080x1920 (three 8.3 MB planes)
// still sit in the 50 MB L2; the TPU kernels' reason to fuse, keeping the
// DoG ring out of HBM, holds here only as far as L2 holds it.  Each mask
// byte is written once: K1m moves K1's bytes plus 6.2 MB of mask at
// 1080x1920.
#include "common.cuh"

namespace {

constexpr int TW = 32;   // tile columns (one warp across)
constexpr int TH = 64;   // tile rows
constexpr int TY = 8;    // warps per block

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The plane a mask-form launch tests: DoGs p..p+2 of one (n, H, W) stack
// (d points at DoG p) into its border-stripped mask plane m.
struct MaskPlane {
  const float* d;
  unsigned char* m;
  int bd;
  float strong_thresh;
  float eth;
};

// Mask plane `mp` at this thread's pixels of the TW x TH tile at (r0, c):
// rows r0 + threadIdx.y, r0 + threadIdx.y + TY, ... of column c, those
// inside the border window.
__device__ __forceinline__ void mask_tile(const MaskPlane& mp, int H, int W, int r0, int c) {
  const int bd = mp.bd;
  if (c < bd || c >= W - bd) return;
  const size_t plane = static_cast<size_t>(H) * W;
  const int Wm = W - 2 * bd;
  for (int i = threadIdx.y; i < TH; i += TY) {
    const int r = r0 + i;
    if (r >= H - bd) break;
    if (r < bd) continue;
    float n[3][3][3];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const float* row = mp.d + p * plane + static_cast<size_t>(r + dy - 1) * W + (c - 1);
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) n[p][dy][dx] = __ldg(row + dx);
      }
    }
    mp.m[static_cast<size_t>(r - bd) * Wm + (c - bd)] =
        sift_is_extremum(n, mp.strong_thresh, mp.eth) ? 1 : 0;
  }
}

// The tail launch of a mask-form octave: the last mask plane alone, on the
// level kernel's tile grid.
__global__ void __launch_bounds__(TW * TY) mask_kernel(MaskPlane mp, int H, int W) {
  mask_tile(mp, H, W, blockIdx.y * TH, blockIdx.x * TW + threadIdx.x);
}

// One blur level on the TW x TH tile of this block, and with kMask the
// lagged mask plane `mp` on the same tile.  The K1, K2 and K9 kernel is the
// kMask = false instance, so the mask forms leave its code as it was.
template <bool kMask>
__device__ __forceinline__ void blur_level_tile(const float* __restrict__ src,
                                                float* __restrict__ dst,
                                                float* __restrict__ dog, int H, int W,
                                                const float* __restrict__ taps, int K,
                                                const MaskPlane& mp) {
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
  if constexpr (kMask) mask_tile(mp, H, W, r0, c);
}

constexpr MaskPlane NO_MASK = {nullptr, nullptr, 0, 0.0f, 0.0f};

__global__ void __launch_bounds__(TW * TY)
blur_level_kernel(const float* __restrict__ src, float* __restrict__ dst,
                  float* __restrict__ dog, int H, int W,
                  const float* __restrict__ taps, int K) {
  blur_level_tile<false>(src, dst, dog, H, W, taps, K, MaskPlane{});
}

// K1m/K2m's level launch: the blur level and the lagged mask plane `mp`.
__global__ void __launch_bounds__(TW * TY)
blur_level_mask_kernel(const float* __restrict__ src, float* __restrict__ dst,
                       float* __restrict__ dog, int H, int W,
                       const float* __restrict__ taps, int K, MaskPlane mp) {
  blur_level_tile<true>(src, dst, dog, H, W, taps, K, mp);
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

// One level launch; with mp.m set, the mask form's (blur_level_mask_kernel).
cudaError_t blur_level(const float* src, float* dst, float* dog, int H, int W,
                       const float* taps, int K, cudaStream_t s,
                       const MaskPlane& mp = NO_MASK) {
  if (K < 1 || (K & 1) == 0 || H < 1 || W < 1) return cudaErrorInvalidValue;
  const size_t smem = level_smem(K);
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > static_cast<size_t>(max_smem)) return cudaErrorInvalidValue;
  const bool masked = mp.m != nullptr;
  if (smem > 48 * 1024) {
    const int n = static_cast<int>(smem);
    cudaError_t e = masked
        ? cudaFuncSetAttribute(blur_level_mask_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, n)
        : cudaFuncSetAttribute(blur_level_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, n);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
  if (masked)
    blur_level_mask_kernel<<<grid, dim3(TW, TY), smem, s>>>(src, dst, dog, H, W, taps, K, mp);
  else
    blur_level_kernel<<<grid, dim3(TW, TY), smem, s>>>(src, dst, dog, H, W, taps, K);
  return cudaGetLastError();
}

// Mask form of an octave: where its (n_levels-2, H-2bd, W-2bd) mask goes,
// and the octave's thresholds.  mask == nullptr: no mask (K1, K2, K9).
struct OctaveMask {
  unsigned char* mask;
  int bd;
  float strong_thresh;
  float eth;
};

// levels 1..n_levels of one octave; blurs[0] already holds the base.  With
// om.mask, the launch that writes DoG l >= 3 also tests mask plane l-3, and
// a tail launch tests plane n_levels-3 (the lag by one level, see above).
cudaError_t octave_levels(float* blurs, float* dogs, int H, int W, const float* taps,
                          const int* offsets, const int* sizes, int tap0, int n_levels,
                          cudaStream_t s, const OctaveMask& om) {
  const size_t plane = static_cast<size_t>(H) * W;
  if (om.mask != nullptr && (n_levels < 3 || om.bd < 1 || H <= 2 * om.bd || W <= 2 * om.bd))
    return cudaErrorInvalidValue;
  const size_t mplane = om.mask == nullptr ? 0
      : static_cast<size_t>(H - 2 * om.bd) * (W - 2 * om.bd);
  auto plane_of = [&](int p) {
    return MaskPlane{dogs + p * plane, om.mask + p * mplane, om.bd, om.strong_thresh, om.eth};
  };
  for (int l = 0; l < n_levels; ++l) {
    const MaskPlane mp = (om.mask != nullptr && l >= 3) ? plane_of(l - 3) : NO_MASK;
    cudaError_t e = blur_level(blurs + l * plane, blurs + (l + 1) * plane,
                               dogs + l * plane, H, W, taps + offsets[tap0 + l],
                               sizes[tap0 + l], s, mp);
    if (e != cudaSuccess) return e;
  }
  if (om.mask != nullptr) {
    const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
    mask_kernel<<<grid, dim3(TW, TY), 0, s>>>(plane_of(n_levels - 3), H, W);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

cudaError_t octave0(const float* img, float* blurs, float* dogs, int H, int W,
                    const float* taps, const int* offsets, const int* sizes, int n_levels,
                    cudaStream_t s, const OctaveMask& om) {
  cudaError_t e = blur_level(img, blurs, nullptr, H, W, taps + offsets[0], sizes[0], s);
  if (e != cudaSuccess) return e;
  return octave_levels(blurs, dogs, H, W, taps, offsets, sizes, 1, n_levels, s, om);
}

cudaError_t small_octaves(int n_oct, const void* const* blurs, const void* const* dogs,
                          void* const* masks, const int* hs, const int* ws, const float* taps,
                          const int* offsets, const int* sizes, int n_levels, int scales,
                          int bin, int bd, float strong_thresh, const float* eths,
                          cudaStream_t s) {
  if (n_oct < 1 || scales < 0 || scales > n_levels) return cudaErrorInvalidValue;
  for (int o = 0; o < n_oct; ++o) {
    float* b = static_cast<float*>(const_cast<void*>(blurs[o]));
    const OctaveMask om = masks == nullptr
        ? OctaveMask{nullptr, 0, 0.0f, 0.0f}
        : OctaveMask{static_cast<unsigned char*>(masks[o]), bd, strong_thresh, eths[o]};
    cudaError_t e = octave_levels(b, static_cast<float*>(const_cast<void*>(dogs[o])),
                                  hs[o], ws[o], taps, offsets, sizes, 0, n_levels, s, om);
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
                 sizes, n_levels, static_cast<cudaStream_t>(stream),
                 OctaveMask{nullptr, 0, 0.0f, 0.0f});
}

// K1m.  K1, plus mask: (n_levels - 2, H - 2bd, W - 2bd) uint8, the extrema
// mask of octave 0 at strong_thresh (0.8 peak_thresh) and edge threshold
// eth.  Needs n_levels >= 3, bd >= 1 and H, W > 2bd.
extern "C" int sift_octave0_ladder_mask(const void* img, void* blurs, void* dogs, void* mask,
                                        int H, int W, const void* taps, const int* offsets,
                                        const int* sizes, int n_levels, int bd,
                                        float strong_thresh, float eth, void* stream) {
  if (mask == nullptr) return cudaErrorInvalidValue;
  return octave0(static_cast<const float*>(img), static_cast<float*>(blurs),
                 static_cast<float*>(dogs), H, W, static_cast<const float*>(taps), offsets,
                 sizes, n_levels, static_cast<cudaStream_t>(stream),
                 OctaveMask{static_cast<unsigned char*>(mask), bd, strong_thresh, eth});
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
  return small_octaves(n_oct, blurs, dogs, nullptr, hs, ws, static_cast<const float*>(taps),
                       offsets, sizes, n_levels, scales, bin, 0, 0.0f, nullptr,
                       static_cast<cudaStream_t>(stream));
}

// K2m.  K2, plus masks[o]: (n_levels - 2, hs[o] - 2bd, ws[o] - 2bd) uint8,
// octave o's extrema mask at strong_thresh and its edge threshold eths[o].
extern "C" int sift_small_octaves_ladder_mask(int n_oct, const void* const* blurs,
                                              const void* const* dogs, void* const* masks,
                                              const int* hs, const int* ws, const void* taps,
                                              const int* offsets, const int* sizes,
                                              int n_levels, int scales, int bin, int bd,
                                              float strong_thresh, const float* eths,
                                              void* stream) {
  if (masks == nullptr || eths == nullptr) return cudaErrorInvalidValue;
  return small_octaves(n_oct, blurs, dogs, masks, hs, ws, static_cast<const float*>(taps),
                       offsets, sizes, n_levels, scales, bin, bd, strong_thresh, eths,
                       static_cast<cudaStream_t>(stream));
}
