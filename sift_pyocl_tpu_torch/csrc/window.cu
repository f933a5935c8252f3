// K6: fused orientation assignment + raw 128-bin descriptors per keypoint.
//
// Replaces sift_pyocl_tpu/ops/pallas/window.py::orient_desc_fused_pallas.
// One block per keypoint slot, over a static win x win window of its
// gradient planes with origin (rs, cs) = (round(fr) - win/2, round(fc) -
// win/2) and subpixel offsets fro = fr - rs, fco = fc - cs (the Pallas
// kernel's window arithmetic, so the per-sample coordinates are the same
// f32 values):
//   A. 36-bin orientation histogram: weight exp(-d2 / (2 sw^2)) * mag with
//      sw = 1.5 sigma, inside d2 < floor(3 sw)^2 + 0.5;
//   B. six rounds of the circular 3-tap box ((h[k-1] + h[k]) + h[k+1]) / 3
//      (the XLA form; the TPU kernel's S6 circulant matmul is an MXU
//      device), then up to max_ori peaks >= 0.8 max, strictly above both
//      neighbours, ties to the lowest bin, parabolic interpolation, angle
//      wrapped into (-pi, pi];
//   C. for each ok angle, the 4x4x8 descriptor in the R(+angle) frame with
//      trilinear weights and a Gaussian of sigma = DESC_GRID / 2.
// Samples outside the keypoint's octave contribute 0 (the TPU kernel reads
// zero padding there).
//
// What bounds it on the card: per-sample arithmetic and shared-memory
// accumulation (about 11k window samples per keypoint at the default
// config, each read from L2/HBM once per pass).  Each thread accumulates
// into its own column of a (bins x threads) table in shared memory, so
// there are no atomics; a warp per bin then sums the column table in a
// fixed order (lane-strided loads, shuffle tree), so the result is the
// same on every run.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int NT = 128;        // threads per keypoint block
constexpr int NB = 128;        // descriptor bins (DESC_GRID^2 * DESC_ORI)
constexpr int NORI = 36;       // orientation bins
constexpr int MAX_ORI = 8;
constexpr float PI_F = 3.141592653589793f;        // float32(pi)
constexpr float TWO_PI_F = 6.283185307179586f;    // float32(2 pi)
constexpr float ORI_SCALE = 1.2732395447351628f;  // float32(8 / (2 pi))
static_assert(NB == NT, "one thread per descriptor bin in the final write");

// out[b] = sum over threads of part[b * NT + thread], fixed summation order.
__device__ __forceinline__ void reduce_bins(const float* part, int nbins, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int b = warp; b < nbins; b += NT / 32) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < NT / 32; ++q) s += part[b * NT + q * 32 + lane];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(0xffffffffu, s, d);
    if (lane == 0) out[b] = s;
  }
}

__global__ void __launch_bounds__(NT) orient_desc_kernel(
    const float* __restrict__ mag, const float* __restrict__ ori, int rows, int wmax,
    const int* __restrict__ s_idx, const int* __restrict__ rs_in,
    const int* __restrict__ cs_in, const unsigned char* __restrict__ valid,
    const float* __restrict__ fro_in, const float* __restrict__ fco_in,
    const float* __restrict__ sigma_in, const int* __restrict__ row_off,
    const int* __restrict__ oct_h, const int* __restrict__ oct_w, int win,
    int max_ori, float* ang_out, unsigned char* ok_out, float* desc_out) {
  extern __shared__ float part[];  // NB * NT per-thread partial sums
  __shared__ float hist[NB];
  __shared__ float ang_s[MAX_ORI];
  __shared__ int ok_s[MAX_ORI];
  const int k = blockIdx.x, tid = threadIdx.x;
  float* dk = desc_out + static_cast<long long>(k) * max_ori * NB;
  if (!valid[k]) {
    for (int i = tid; i < max_ori * NB; i += NT) dk[i] = 0.f;
    if (tid < max_ori) {
      ang_out[k * max_ori + tid] = 0.f;
      ok_out[k * max_ori + tid] = 0;
    }
    return;
  }
  const long long plane0 = (static_cast<long long>(s_idx[k]) * rows + row_off[k]) * wmax;
  const float* magp = mag + plane0;
  const float* orip = ori + plane0;
  const int rs = rs_in[k], cs = cs_in[k], H = oct_h[k], W = oct_w[k];
  const float fro = fro_in[k], fco = fco_in[k], sig = sigma_in[k];
  const int n = win * win;

  // A. orientation histogram
  for (int i = tid; i < NORI * NT; i += NT) part[i] = 0.f;
  __syncthreads();
  const float sig_w = 1.5f * sig;
  const float radius = floorf(3.0f * sig_w);
  const float rad2 = radius * radius + 0.5f;
  const float den = 2.0f * sig_w * sig_w;
  for (int idx = tid; idx < n; idx += NT) {
    const int i = idx / win, j = idx - (idx / win) * win;
    const float rr = static_cast<float>(i) - fro;
    const float cc = static_cast<float>(j) - fco;
    const float d2 = rr * rr + cc * cc;
    if (!(d2 < rad2)) continue;
    const int r = rs + i, c = cs + j;
    if (r < 0 || r >= H || c < 0 || c >= W) continue;
    const long long off = static_cast<long long>(r) * wmax + c;
    const float w = expf(-d2 / den) * magp[off];
    int b = static_cast<int>(floorf(36.0f * (orip[off] + PI_F) / TWO_PI_F));
    b = min(max(b, 0), NORI - 1);
    part[b * NT + tid] += w;
  }
  __syncthreads();
  reduce_bins(part, NORI, hist);
  __syncthreads();

  // B. smoothing, peaks, parabolic interpolation (one thread; 36 bins)
  if (tid == 0) {
    float h[NORI], t[NORI], score[NORI];
    for (int b = 0; b < NORI; ++b) h[b] = hist[b];
    for (int round = 0; round < 6; ++round) {
      for (int b = 0; b < NORI; ++b)
        t[b] = ((h[(b + NORI - 1) % NORI] + h[b]) + h[(b + 1) % NORI]) / 3.0f;
      for (int b = 0; b < NORI; ++b) h[b] = t[b];
    }
    float hmax = -INFINITY;
    for (int b = 0; b < NORI; ++b) hmax = fmaxf(hmax, h[b]);
    for (int b = 0; b < NORI; ++b) {
      const float l = h[(b + NORI - 1) % NORI], rg = h[(b + 1) % NORI];
      const bool peak = h[b] >= 0.8f * hmax && h[b] > l && h[b] > rg && hmax > 0.f;
      score[b] = peak ? h[b] : -INFINITY;
    }
    for (int o = 0; o < max_ori; ++o) {
      float m = -INFINITY;
      int bsel = 0;
      for (int b = 0; b < NORI; ++b)
        if (score[b] > m) { m = score[b]; bsel = b; }  // ties: lowest bin
      const bool okk = isfinite(m);
      const float l = h[(bsel + NORI - 1) % NORI], rg = h[(bsel + 1) % NORI];
      const float hh = h[bsel];
      const float denom = (l - 2.0f * hh) + rg;
      const float off = denom != 0.f ? 0.5f * (l - rg) / denom : 0.f;
      float ang = TWO_PI_F * ((static_cast<float>(bsel) + 0.5f) + off) / 36.0f - PI_F;
      if (ang > PI_F) ang -= TWO_PI_F;
      if (ang <= -PI_F) ang += TWO_PI_F;
      ang_s[o] = ang;
      ok_s[o] = okk;
      ang_out[k * max_ori + o] = ang;
      ok_out[k * max_ori + o] = okk ? 1 : 0;
      score[bsel] = -INFINITY;
    }
  }
  __syncthreads();

  // C. one descriptor per ok orientation
  for (int o = 0; o < max_ori; ++o) {
    float* dst = dk + o * NB;
    if (!ok_s[o]) {  // block-uniform
      dst[tid] = 0.f;
      continue;
    }
    for (int i = tid; i < NB * NT; i += NT) part[i] = 0.f;
    __syncthreads();
    const float angle = ang_s[o];
    const float cos_t = cosf(angle), sin_t = sinf(angle);
    const float spacing = 3.0f * sig;
    for (int idx = tid; idx < n; idx += NT) {
      const int i = idx / win, j = idx - (idx / win) * win;
      const float rr = static_cast<float>(i) - fro;
      const float cc = static_cast<float>(j) - fco;
      const float rrot = (cos_t * rr - sin_t * cc) / spacing;
      const float crot = (sin_t * rr + cos_t * cc) / spacing;
      const float rbin = rrot + 1.5f, cbin = crot + 1.5f;
      if (!(rbin > -1.f && rbin < 4.f && cbin > -1.f && cbin < 4.f)) continue;
      const int r = rs + i, c = cs + j;
      if (r < 0 || r >= H || c < 0 || c >= W) continue;
      const long long off = static_cast<long long>(r) * wmax + c;
      const float gw = expf(-(rrot * rrot + crot * crot) / 8.0f);
      const float m = gw * magp[off];
      float ob = (orip[off] - angle) * ORI_SCALE;
      ob = ob - floorf(ob / 8.0f) * 8.0f;  // in [0, 8]
      const int r0 = static_cast<int>(floorf(rbin));
      const int c0 = static_cast<int>(floorf(cbin));
      const int o0 = static_cast<int>(floorf(ob));
      int oo[2];
      float mo[2];
      for (int q = 0; q < 2; ++q) {
        oo[q] = (o0 + q) & 7;
        float dd = fabsf(ob - static_cast<float>(oo[q]));
        dd = fminf(dd, 8.0f - dd);
        mo[q] = m * fmaxf(0.f, 1.f - dd);
      }
      for (int a = 0; a < 2; ++a) {
        const int ri = r0 + a;
        if (ri < 0 || ri > 3) continue;
        const float wr = fmaxf(0.f, 1.f - fabsf(rbin - static_cast<float>(ri)));
        for (int bb = 0; bb < 2; ++bb) {
          const int cj = c0 + bb;
          if (cj < 0 || cj > 3) continue;
          const float wrc = wr * fmaxf(0.f, 1.f - fabsf(cbin - static_cast<float>(cj)));
          const int cell = (ri * 4 + cj) * 8;
          part[(cell + oo[0]) * NT + tid] += wrc * mo[0];
          part[(cell + oo[1]) * NT + tid] += wrc * mo[1];
        }
      }
    }
    __syncthreads();
    reduce_bins(part, NB, hist);
    __syncthreads();
    dst[tid] = hist[tid];
    __syncthreads();
  }
}

}  // namespace

// mag, ori: (S, rows, wmax) f32 gradient atlas; per keypoint slot (n of
// them): s_idx (plane, int32), rs/cs (window origin, octave-local int32),
// valid (uint8), fro/fco/sigma (f32), row_off/oct_h/oct_w (int32: the
// octave's first atlas row and its size).  Outputs: ang (n, max_ori) f32,
// ok (n, max_ori) uint8, desc (n, max_ori, 128) f32.
extern "C" int sift_orient_desc(const void* mag, const void* ori, int rows, int wmax,
                                int n, const void* s_idx, const void* rs,
                                const void* cs, const void* valid, const void* fro,
                                const void* fco, const void* sigma,
                                const void* row_off, const void* oct_h,
                                const void* oct_w, int win, int max_ori, void* ang,
                                void* ok, void* desc, void* stream) {
  if (max_ori < 1 || max_ori > MAX_ORI || win < 1) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * NB * NT;
  cudaError_t e = cudaFuncSetAttribute(
      orient_desc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n > 0) {
    orient_desc_kernel<<<n, NT, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(mag), static_cast<const float*>(ori), rows, wmax,
        static_cast<const int*>(s_idx), static_cast<const int*>(rs),
        static_cast<const int*>(cs), static_cast<const unsigned char*>(valid),
        static_cast<const float*>(fro), static_cast<const float*>(fco),
        static_cast<const float*>(sigma), static_cast<const int*>(row_off),
        static_cast<const int*>(oct_h), static_cast<const int*>(oct_w), win, max_ori,
        static_cast<float*>(ang), static_cast<unsigned char*>(ok),
        static_cast<float*>(desc));
  }
  return static_cast<int>(cudaGetLastError());
}
