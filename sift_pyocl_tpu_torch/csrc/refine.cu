// K4: iterative subpixel refinement of every octave's candidates in one call,
// straight from the compaction's output.
//
// Replaces sift_pyocl_tpu/ops/pallas/refine.py::refine_atlas_pallas and,
// called with one octave, refine_pallas (K10b), which took the octave's
// pad_dogs copy.
// Each slot decodes its own candidate from K3's (or K10a's) flat mask index,
// as ops/kernels/refine.py::decode_compacted does: octave o owns slots
// [capoff[o], capoff[o+1]), the first written[o] of them valid, and a valid
// slot's index into the octave's (S-2, H-2bd, W-2bd) mask gives (s, r, c).
// Per candidate: up to max_moves re-centring moves while an in-plane offset
// exceeds 0.6 (moves clamped to [bd, H-bd) x [bd, W-bd)), then the 3x3
// adjugate solve of the DoG Hessian at the final position.  Accept iff
// |det| > 1e-30, |peak| > peak_thresh and every |offset| <= 1.5.  The
// arithmetic follows the Pallas kernel's formulas operation by operation
// (the library is built with --fmad=false), so the plain PyTorch version in
// ops/kernels/refine.py gives the same bits.
//
// What bounds it on the card: latency.  A few thousand slots, each a serial
// chain of 19-sample gathers and solves; the DoG bytes touched are a few KB a
// candidate, some 120 operations a solve.  Tensor cores, TMA and wgmma have
// no role.  The design shortens the chain: one round trip for the slot's
// index and its octave's count (issued together), one for a solve's 19
// samples (all issued before the first is used), and no solve twice -- the
// last solve of the move loop is the result, and a move that the border
// clamps to nothing ends the loop, since every later solve would repeat it.
// Samples are read straight from each octave's own DoG stack (L2 holds them
// after the extrema mask read them), with none of the TPU kernel's atlas
// padding and aligned window DMAs.
#include "common.cuh"

namespace {

constexpr int MAX_NT = 256;

struct RefineMeta {
  int n_oct;
  const float* dogs[SIFT_MAX_OCT];  // (S+2, H, W) DoG stack of each octave
  int H[SIFT_MAX_OCT];
  int W[SIFT_MAX_OCT];
  int capoff[SIFT_MAX_OCT + 1];     // first slot of each octave
};

struct Solve {
  float os, orr, oc, peak;
  bool ok;
};

// Gradient, Hessian and offset at scale plane s (1 <= s <= S), pixel (r, c).
__device__ __forceinline__ Solve solve_at(const float* __restrict__ d, int H, int W, int s,
                                          int r, int c) {
  const long long plane = static_cast<long long>(H) * W;
  const float* w1 = d + s * plane + static_cast<long long>(r) * W + c;
  const float* w0 = w1 - plane;
  const float* w2 = w1 + plane;
  // the 19 samples, all loaded before the first is used
  const float c0 = __ldg(w0), c1 = __ldg(w1), c2 = __ldg(w2);
  const float up = __ldg(w1 - W), dn = __ldg(w1 + W), lf = __ldg(w1 - 1), rt = __ldg(w1 + 1);
  const float ul = __ldg(w1 - W - 1), ur = __ldg(w1 - W + 1);
  const float dl = __ldg(w1 + W - 1), dr = __ldg(w1 + W + 1);
  const float up0 = __ldg(w0 - W), dn0 = __ldg(w0 + W), lf0 = __ldg(w0 - 1), rt0 = __ldg(w0 + 1);
  const float up2 = __ldg(w2 - W), dn2 = __ldg(w2 + W), lf2 = __ldg(w2 - 1), rt2 = __ldg(w2 + 1);
  const float gs = 0.5f * (c2 - c0);
  const float gr = 0.5f * (dn - up);
  const float gc = 0.5f * (rt - lf);
  const float hss = (c2 + c0) - 2.0f * c1;
  const float hrr = (dn + up) - 2.0f * c1;
  const float hcc = (rt + lf) - 2.0f * c1;
  const float hsr = 0.25f * ((dn2 - up2) - (dn0 - up0));
  const float hsc = 0.25f * ((rt2 - lf2) - (rt0 - lf0));
  const float hrc = 0.25f * (((dr - dl) - ur) + ul);
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

__global__ void __launch_bounds__(MAX_NT) refine_kernel(
    RefineMeta m, int n, const int* __restrict__ idx, const int* __restrict__ written, int bd,
    float peak_thresh, int max_moves, int* __restrict__ s_out, float* __restrict__ fs,
    float* __restrict__ fr, float* __restrict__ fc, float* __restrict__ peak,
    unsigned char* __restrict__ keep) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  int o = 0;
  while (o + 1 < m.n_oct && k >= m.capoff[o + 1]) ++o;
  const int id = __ldg(idx + k);
  const int n_written = __ldg(written + o);
  const int H = m.H[o], W = m.W[o];
  if (k - m.capoff[o] >= n_written) {
    // the plain decode's invalid slot: index 0, so scale 1; zeros elsewhere
    s_out[k] = 1;
    fs[k] = 0.f; fr[k] = 0.f; fc[k] = 0.f; peak[k] = 0.f; keep[k] = 0;
    return;
  }
  const int Wm = W - 2 * bd;
  const int Pm = (H - 2 * bd) * Wm;
  const int s = id / Pm + 1;
  const int rem = id % Pm;
  int r = rem / Wm + bd;
  int c = rem % Wm + bd;
  Solve q = solve_at(m.dogs[o], H, W, s, r, c);
  for (int it = 0; it < max_moves; ++it) {
    if (fabsf(q.orr) <= 0.6f && fabsf(q.oc) <= 0.6f) break;
    int dr = q.orr > 0.6f ? 1 : (q.orr < -0.6f ? -1 : 0);
    int dc = q.oc > 0.6f ? 1 : (q.oc < -0.6f ? -1 : 0);
    if (dr > 0 && r + 1 >= H - bd) dr = 0;
    if (dr < 0 && r - 1 < bd) dr = 0;
    if (dc > 0 && c + 1 >= W - bd) dc = 0;
    if (dc < 0 && c - 1 < bd) dc = 0;
    if (dr == 0 && dc == 0) break;  // clamped: every later solve is this one
    r += dr;
    c += dc;
    q = solve_at(m.dogs[o], H, W, s, r, c);
  }
  const bool acc = q.ok && fabsf(q.peak) > peak_thresh && fabsf(q.os) <= 1.5f &&
                   fabsf(q.orr) <= 1.5f && fabsf(q.oc) <= 1.5f;
  s_out[k] = s;
  fs[k] = static_cast<float>(s) + q.os;
  fr[k] = static_cast<float>(r) + q.orr;
  fc[k] = static_cast<float>(c) + q.oc;
  peak[k] = q.peak;
  keep[k] = acc ? 1 : 0;
}

}  // namespace

// dogs: n_oct device pointers to contiguous (S+2, H[o], W[o]) f32 stacks;
// caps: slots per octave (octave o owns slots [sum(caps[:o]),
// sum(caps[:o+1])) of this call); idx: int32 flat indices into each
// octave's (S-2, H-2bd, W-2bd) mask, octave o's first written[o] slots valid
// (written: int32 per octave), as the compaction leaves them on the device.
// out: one buffer for n_all slots: s_int int32, then fs, fr, fc, peak f32,
// each n_all values, then one keep byte a slot (21 bytes a slot); this call
// writes its sum(caps) slots from slot slot0 on, so that a batch's entry
// list longer than SIFT_MAX_OCT is refined by several calls into one buffer
// (idx and written then point at the call's first slot and octave).
// threads: block size, a multiple of 32 up to 256.
extern "C" int sift_refine_multi(int n_oct, const void* const* dogs, const int* hs,
                                 const int* ws, const int* caps, const void* idx,
                                 const void* written, int bd, float peak_thresh, int max_moves,
                                 int threads, void* out, long long n_all, long long slot0,
                                 void* stream) {
  if (n_oct < 1 || n_oct > SIFT_MAX_OCT || threads < 32 || threads > MAX_NT || threads % 32 ||
      slot0 < 0)
    return cudaErrorInvalidValue;
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
  if (slot0 + n > n_all) return cudaErrorInvalidValue;
  if (n > 0) {
    int* s_out = static_cast<int*>(out) + slot0;
    float* f = static_cast<float*>(out) + slot0;
    unsigned char* keep = static_cast<unsigned char*>(out) + 20LL * n_all + slot0;
    refine_kernel<<<(n + threads - 1) / threads, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        m, n, static_cast<const int*>(idx), static_cast<const int*>(written), bd, peak_thresh,
        max_moves, s_out, f + n_all, f + 2LL * n_all, f + 3LL * n_all, f + 4LL * n_all, keep);
  }
  return static_cast<int>(cudaGetLastError());
}
