// K4: iterative subpixel refinement of every octave's candidates in one call.
//
// Replaces sift_pyocl_tpu/ops/pallas/refine.py::refine_atlas_pallas and,
// called with one octave, refine_pallas (K10b), which took the octave's
// pad_dogs copy.
// Per candidate (s, r, c): up to max_moves re-centring moves while an
// in-plane offset exceeds 0.6 (moves clamped to [bd, H-bd) x [bd, W-bd)),
// then a 3x3 adjugate solve of the DoG Hessian at the final position.
// Accept iff |det| > 1e-30, |peak| > peak_thresh and every |offset| <= 1.5.
// The arithmetic follows the Pallas kernel's formulas operation by
// operation (the library is built with --fmad=false), so the plain PyTorch
// version in ops/kernels/refine.py gives the same bits.
//
// What bounds it on the card: latency.  A few thousand candidates, each a
// serial chain of at most six 19-sample gathers and solves; the DoG bytes
// touched are a few KB per candidate.  One thread per candidate reads its
// samples straight from the octave's own DoG stack (they sit in L2 after
// the extrema mask read them), so none of the TPU kernel's atlas padding
// and aligned 24x256 window DMAs are needed; the early exit on convergence
// ends most chains after one solve.
#include "common.cuh"

namespace {

constexpr int NT = 128;

struct RefineMeta {
  int n_oct;
  const float* dogs[SIFT_MAX_OCT];  // (S+2, H, W) DoG stack of each octave
  int H[SIFT_MAX_OCT];
  int W[SIFT_MAX_OCT];
  int capoff[SIFT_MAX_OCT + 1];     // first candidate slot of each octave
};

struct Solve {
  float os, orr, oc, peak;
  bool ok;
};

// Gradient, Hessian and offset at scale plane s (1 <= s <= S), pixel (r, c).
__device__ Solve solve_at(const float* d, int H, int W, int s, int r, int c) {
  const long long plane = static_cast<long long>(H) * W;
  const float* w0 = d + (s - 1) * plane + static_cast<long long>(r) * W + c;
  const float* w1 = w0 + plane;
  const float* w2 = w1 + plane;
  const float c0 = w0[0], c1 = w1[0], c2 = w2[0];
  const float gs = 0.5f * (c2 - c0);
  const float gr = 0.5f * (w1[W] - w1[-W]);
  const float gc = 0.5f * (w1[1] - w1[-1]);
  const float hss = (c2 + c0) - 2.0f * c1;
  const float hrr = (w1[W] + w1[-W]) - 2.0f * c1;
  const float hcc = (w1[1] + w1[-1]) - 2.0f * c1;
  const float hsr = 0.25f * ((w2[W] - w2[-W]) - (w0[W] - w0[-W]));
  const float hsc = 0.25f * ((w2[1] - w2[-1]) - (w0[1] - w0[-1]));
  const float hrc = 0.25f * (((w1[W + 1] - w1[W - 1]) - w1[-W + 1]) + w1[-W - 1]);
  const float a = hss, b = hsr, cc = hsc, dd = hrr, e = hrc, f = hcc;
  const float det = (a * (dd * f - e * e) - b * (b * f - e * cc)) + cc * (b * e - dd * cc);
  Solve out;
  out.ok = fabsf(det) > 1e-30f;
  const float inv = out.ok ? 1.0f / det : 0.0f;
  out.os = -(((dd * f - e * e) * gs + (cc * e - b * f) * gr) + (b * e - cc * dd) * gc) * inv;
  out.orr = -(((e * cc - b * f) * gs + (a * f - cc * cc) * gr) + (b * cc - a * e) * gc) * inv;
  out.oc = -(((b * e - dd * cc) * gs + (cc * b - a * e) * gr) + (a * dd - b * b) * gc) * inv;
  out.peak = c1 + 0.5f * ((gs * out.os + gr * out.orr) + gc * out.oc);
  return out;
}

__global__ void __launch_bounds__(NT) refine_kernel(
    RefineMeta m, int n, const int* __restrict__ s_in, const int* __restrict__ r_in,
    const int* __restrict__ c_in, const unsigned char* __restrict__ valid, int bd,
    float peak_thresh, int max_moves, float* fs, float* fr, float* fc,
    float* peak, int* accept) {
  const int k = blockIdx.x * NT + threadIdx.x;
  if (k >= n) return;
  if (!valid[k]) {
    fs[k] = 0.f; fr[k] = 0.f; fc[k] = 0.f; peak[k] = 0.f; accept[k] = 0;
    return;
  }
  int o = 0;
  while (o + 1 < m.n_oct && k >= m.capoff[o + 1]) ++o;
  const int H = m.H[o], W = m.W[o];
  const int s = s_in[k];
  int r = r_in[k], c = c_in[k];
  // A converged candidate would re-solve the same pixel on every remaining
  // move, so leaving the loop early gives the same result as running all.
  for (int it = 0; it < max_moves; ++it) {
    const Solve q = solve_at(m.dogs[o], H, W, s, r, c);
    if (fabsf(q.orr) <= 0.6f && fabsf(q.oc) <= 0.6f) break;
    int dr = q.orr > 0.6f ? 1 : (q.orr < -0.6f ? -1 : 0);
    int dc = q.oc > 0.6f ? 1 : (q.oc < -0.6f ? -1 : 0);
    if (dr > 0 && r + 1 >= H - bd) dr = 0;
    if (dr < 0 && r - 1 < bd) dr = 0;
    if (dc > 0 && c + 1 >= W - bd) dc = 0;
    if (dc < 0 && c - 1 < bd) dc = 0;
    r += dr;
    c += dc;
  }
  const Solve q = solve_at(m.dogs[o], H, W, s, r, c);
  const bool acc = q.ok && fabsf(q.peak) > peak_thresh && fabsf(q.os) <= 1.5f &&
                   fabsf(q.orr) <= 1.5f && fabsf(q.oc) <= 1.5f;
  fs[k] = static_cast<float>(s) + q.os;
  fr[k] = static_cast<float>(r) + q.orr;
  fc[k] = static_cast<float>(c) + q.oc;
  peak[k] = q.peak;
  accept[k] = acc ? 1 : 0;
}

}  // namespace

// dogs: n_oct device pointers to contiguous (S+2, H[o], W[o]) f32 stacks;
// caps: candidate slots per octave (octave o owns slots
// [sum(caps[:o]), sum(caps[:o+1]))); s, r, c int32 and valid uint8 per slot,
// r and c octave-local.  Outputs: fs, fr, fc, peak f32 and accept int32.
extern "C" int sift_refine_multi(int n_oct, const void* const* dogs, const int* hs,
                                 const int* ws, const int* caps, const void* s,
                                 const void* r, const void* c, const void* valid,
                                 int bd, float peak_thresh, int max_moves,
                                 void* fs, void* fr, void* fc, void* peak,
                                 void* accept, void* stream) {
  if (n_oct < 1 || n_oct > SIFT_MAX_OCT) return cudaErrorInvalidValue;
  RefineMeta m = {};
  m.n_oct = n_oct;
  int n = 0;
  for (int o = 0; o < n_oct; ++o) {
    m.dogs[o] = static_cast<const float*>(dogs[o]);
    m.H[o] = hs[o];
    m.W[o] = ws[o];
    m.capoff[o] = n;
    n += caps[o];
  }
  m.capoff[n_oct] = n;
  if (n > 0) {
    refine_kernel<<<(n + NT - 1) / NT, NT, 0, static_cast<cudaStream_t>(stream)>>>(
        m, n, static_cast<const int*>(s), static_cast<const int*>(r),
        static_cast<const int*>(c), static_cast<const unsigned char*>(valid), bd,
        peak_thresh, max_moves, static_cast<float*>(fs), static_cast<float*>(fr),
        static_cast<float*>(fc), static_cast<float*>(peak), static_cast<int*>(accept));
  }
  return static_cast<int>(cudaGetLastError());
}
