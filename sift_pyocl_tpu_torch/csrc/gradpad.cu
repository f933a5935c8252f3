// K5: gradient magnitude/orientation atlas of every octave in one call.
//
// Replaces sift_pyocl_tpu/ops/pallas/gradpad.py::grad_atlas_pallas.
// For scale planes s = 1..S of every octave's blur stack: central
// differences with clamped edges, mag = 0.5 * sqrt(dx^2 + dy^2),
// ori = atan2(dy, dx).  Output layout (the port's own): mag and ori of shape
// (S, sum_o H_o, Wmax), octave o in rows [row0[o], row0[o] + H_o), columns
// past W_o written as 0.  No zero padding around octaves: the window kernel
// (window.cu) checks bounds instead.  A call writes the rows of the octaves
// it is given, from row_base on in planes of rows_total rows: a batch's
// entry list longer than SIFT_MAX_OCT is written by several calls into one
// atlas.  Offsets into the atlas are 64-bit (a batch of 12 1080x1920
// frames is 3 x 25.7k x 1920 = 1.5e8 floats a tensor).
//
// What bounds it on the card: memory bandwidth.  Each output pixel reads
// five blur samples (neighbouring threads share them through L1) and writes
// two floats; at 1080x1920 that is about 33 MB read and 66 MB written for
// three planes over all octaves.  One thread per output pixel, rows of 32
// consecutive columns per warp for coalesced loads and stores.  atan2f
// replaces the TPU kernel's polynomial (_atan2), which existed only
// because Mosaic has no atan2.
#include "common.cuh"

namespace {

struct GradMeta {
  int n_oct;
  const float* blur[SIFT_MAX_OCT];  // (S+3, H, W) blur stack of each octave
  int H[SIFT_MAX_OCT];
  int W[SIFT_MAX_OCT];
  int row0[SIFT_MAX_OCT + 1];
};

__global__ void __launch_bounds__(256) grad_kernel(GradMeta m, int rows, int rows_total,
                                                   int row_base, int wmax, float* mag,
                                                   float* ori) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int g = blockIdx.y * blockDim.y + threadIdx.y;
  const int s = blockIdx.z;  // output plane; reads blur level s + 1
  if (x >= wmax || g >= rows) return;
  int o = 0;
  while (o + 1 < m.n_oct && g >= m.row0[o + 1]) ++o;
  const int H = m.H[o], W = m.W[o], y = g - m.row0[o];
  const long long out = (static_cast<long long>(s) * rows_total + row_base + g) * wmax + x;
  if (x >= W) {
    mag[out] = 0.f;
    ori[out] = 0.f;
    return;
  }
  const float* p = m.blur[o] + static_cast<long long>(s + 1) * H * W;
  const float* row = p + static_cast<long long>(y) * W;
  const float dx = row[min(x + 1, W - 1)] - row[max(x - 1, 0)];
  const float dy = p[static_cast<long long>(min(y + 1, H - 1)) * W + x] -
                   p[static_cast<long long>(max(y - 1, 0)) * W + x];
  mag[out] = 0.5f * sqrtf(dx * dx + dy * dy);
  ori[out] = atan2f(dy, dx);
}

}  // namespace

// blurs: n_oct device pointers to contiguous (S+3, H[o], W[o]) f32 stacks;
// mag, ori: (scales, rows_total, wmax) f32, of which this call writes rows
// [row_base, row_base + sum(H)) of each plane.
extern "C" int sift_grad_atlas(int n_oct, const void* const* blurs, const int* hs,
                               const int* ws, int scales, int wmax, int rows_total,
                               int row_base, void* mag, void* ori, void* stream) {
  if (n_oct < 1 || n_oct > SIFT_MAX_OCT || row_base < 0) return cudaErrorInvalidValue;
  GradMeta m = {};
  m.n_oct = n_oct;
  int rows = 0;
  for (int o = 0; o < n_oct; ++o) {
    m.blur[o] = static_cast<const float*>(blurs[o]);
    m.H[o] = hs[o];
    m.W[o] = ws[o];
    m.row0[o] = rows;
    rows += hs[o];
  }
  m.row0[n_oct] = rows;
  if (row_base + rows > rows_total) return cudaErrorInvalidValue;
  const dim3 block(32, 8);
  const dim3 grid((wmax + 31) / 32, (rows + 7) / 8, scales);
  grad_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      m, rows, rows_total, row_base, wmax, static_cast<float*>(mag), static_cast<float*>(ori));
  return static_cast<int>(cudaGetLastError());
}
