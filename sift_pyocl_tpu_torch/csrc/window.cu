// K6: fused orientation assignment + raw 128-bin descriptors per keypoint;
// K11a / K11b: the same histograms split in two launches.
//
// Replaces sift_pyocl_tpu/ops/pallas/window.py::orient_desc_fused_pallas
// (K6), ::orientation_hist_pallas (K11a: step A alone, on the orientation
// window) and ::descriptor_hist_pallas (K11b: step C alone, one given angle
// per slot, on the descriptor window).  Each keypoint has a static win x
// win window of its gradient planes with origin (rs, cs) = (round(fr) -
// win/2, round(fc) - win/2) and subpixel offsets fro = fr - rs, fco = fc -
// cs (the Pallas kernel's window arithmetic, so the per-sample coordinates
// are the same f32 values):
//   A. 36-bin orientation histogram: weight exp(-d2 / (2 sw^2)) * mag with
//      sw = 1.5 sigma, inside d2 < floor(3 sw)^2 + 0.5;
//   B. six rounds of the circular 3-tap box ((h[k-1] + h[k]) + h[k+1]) / 3
//      (the XLA form; the TPU kernel's S6 circulant matmul is an MXU
//      device), then up to max_ori peaks >= 0.8 max, strictly above both
//      neighbours, ties to the lowest bin, parabolic interpolation, angle
//      wrapped into (-pi, pi];
//   C. for each ok angle, the 4x4x8 descriptor in the R(+angle) frame with
//      trilinear weights and a Gaussian of sigma = DESC_GRID / 2.
// Samples outside the window or the keypoint's octave contribute 0 (the
// TPU kernels read zero padding there), so any window size is taken (the
// TPU's win <= 128 was a lane limit).
//
// K6 (orient_desc_kernel).  What bounded the static-window design (one
// pass over the whole window per histogram) on this card was not bytes
// (0.0055 ms at 3.35 TB/s) but issued work and latency: each
// valid keypoint walked the whole static window (104 x 104 at the default
// config) once for A and once a descriptor, ~25 000 sample iterations of
// which ~4 500 can contribute, into a 128 x 128-thread table of partial
// sums (64 KB, 3 blocks an SM) zeroed and reduced every pass, with step B
// on one thread, and its wrapper launched 12 element-wise kernels a call.
// The design now:
//   - Each keypoint walks its own support: for A the box of the circle
//     (|offset| <= floor(4.5 sigma) + 1), for C the boxes of the 25 quads
//     (qr, qc) = (floor(rbin), floor(cbin)) in -1..3 at the angle, each a
//     square of side 3 sigma rotated by the angle (half-extent 1.5 sigma
//     (|cos| + |sin|) + 1: angle-dependent), all clipped to the window
//     and the octave; ops/kernels/window.py::support_boxes is the same
//     rule, and the CPU tests show that it holds every sample the plain
//     arithmetic counts.  ~5 400 sample iterations a keypoint (1080p
//     frame).  A sample is tested exactly as before, so only the order of
//     the sums changes.
//   - Deterministic without a large table: in A each thread sums into its
//     own 36-bin column (36 x 256 floats) and a warp per bin sums the
//     columns in a fixed order; in C thread (quad, sub) takes only samples
//     of its quad, whose 4 cells are fixed, so its private column is 4
//     corners x 8 orientations (32 floats), and thread b then sums bin b
//     over the 4 quads x 10 subs that reach it in a fixed order.  No
//     atomics: the same bits on every run.  37 KB of static shared memory
//     and 256 threads a block; -Xptxas -v: 51 registers, no spills (4
//     blocks an SM by registers).
//   - Step B on warp 0: smoothing across lanes through shared memory (the
//     same per-bin arithmetic), the max and the argmax (ties to the lowest
//     bin) by shuffles.
//   - The samples are not staged in shared memory: a keypoint's support at
//     the default config is ~10-50 KB of mag + ori, too large to stage for
//     several blocks an SM; A and C read them through the read-only path
//     (__ldg), and C's passes reread what A and the other quads brought
//     into L1/L2.
//   - One launch a call: the kernel computes (rs, cs, fro, fco) from fr/fc
//     as slot_window does and subtracts 1 from s_int itself, and reads the
//     bool valid mask as bytes; one block a slot, and an invalid slot's
//     block writes its zeros and exits.
// K11a (orientation_hist_kernel) and K11b (descriptor_hist_kernel) are K6's
// step A alone and its step C alone at the slot's given angle, one block a
// slot of one octave's padded planes (ops/orient_desc.py::pad_grad_planes,
// read through a view of the octave: the padding is never read).  Bytes
// bound them too (the circle's and the square's samples).  Their
// static-window blocks (every slot walking the whole 48 x 48 or 104 x 104
// window, 2304 or 10816 sample iterations, into a 36- or 128-bin x
// 128-thread table; K11b's 64 KB of dynamic shared memory, 3 blocks an SM)
// issued several times the work that can count.  They now call K6's own
// device functions: the orientation box (k6_orientation) and the 25 quad
// boxes at the given angle (k6_descriptor), 256 threads, the same
// fixed-order sums without atomics, static shared memory only (37 KB and
// 32 KB), so K11b at K6's angles gives K6's raw descriptors bit for bit,
// and a call is one launch.  A K11a variant that first staged the box's
// circle samples in shared memory by cp.async (all of a slot's loads in
// flight at once) gave the same bits ~12 % slower on the card, so the
// samples are read through the read-only path as in K6.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int NB = 128;        // descriptor bins (DESC_GRID^2 * DESC_ORI)
constexpr int NORI = 36;       // orientation bins
constexpr int MAX_ORI = 8;
constexpr float PI_F = 3.141592653589793f;        // float32(pi)
constexpr float TWO_PI_F = 6.283185307179586f;    // float32(2 pi)
constexpr float ORI_SCALE = 1.2732395447351628f;  // float32(8 / (2 pi))

// out[b] = sum over the block's NTH threads of part[b * NTH + thread],
// fixed summation order.
template <int NTH>
__device__ __forceinline__ void reduce_bins(const float* part, int nbins, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int b = warp; b < nbins; b += NTH / 32) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < NTH / 32; ++q) s += part[b * NTH + q * 32 + lane];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(0xffffffffu, s, d);
    if (lane == 0) out[b] = s;
  }
}

// One keypoint's window over its octave's gradient planes: the octave's
// (0, 0) sample of the mag and ori planes, their row stride, the octave's
// size, the window origin (rs, cs) in the octave and the keypoint's
// subpixel offsets from that origin (fro, fco).
struct Window {
  const float* mag;
  const float* ori;
  long long stride;
  int H, W, rs, cs, win;
  float fro, fco;
};

// K6's support boxes (see the note at the top), in window coordinates:
// rows [r0, r1) and columns [c0, c1), empty where r1 <= r0 or c1 <= c0.
// ops/kernels/window.py::support_boxes computes the same boxes with the
// same f32 operations.
struct Box {
  int r0, r1, c0, c1;
};

// The samples i (rows) or j (columns) of the window whose offset i - fro
// lies in [centre - half, centre + half], inside the window [0, win) and
// the octave [-origin, extent - origin).
__device__ __forceinline__ void box_span(float f, float centre, float half, int win, int origin,
                                         int extent, int* lo, int* hi) {
  *lo = max(max(static_cast<int>(ceilf((f + centre) - half)), 0), -origin);
  *hi = min(min(static_cast<int>(floorf((f + centre) + half)) + 1, win), extent - origin);
}

__device__ __forceinline__ Box support_box(const Window& w, float cr, float cc, float half) {
  Box b;
  box_span(w.fro, cr, half, w.win, w.rs, w.H, &b.r0, &b.r1);
  box_span(w.fco, cc, half, w.win, w.cs, w.W, &b.c0, &b.c1);
  return b;
}

// The orientation circle's box: |offset| <= floor(4.5 sigma) + 1.
__device__ __forceinline__ Box orientation_box(const Window& w, float sig) {
  const float radius = floorf(3.0f * (1.5f * sig));
  return support_box(w, 0.0f, 0.0f, radius + 1.0f);
}

// The box of descriptor quad (qr, qc) (qr, qc in -1..3): the samples whose
// (floor(rbin), floor(cbin)) is (qr, qc) at this angle, a rotated square
// of side 3 sigma centred at bin offset (qr - 1, qc - 1), plus one sample.
__device__ __forceinline__ Box quad_box(const Window& w, float sig, float cos_t, float sin_t,
                                        int qr, int qc) {
  const float sp = 3.0f * sig;
  const float ur = static_cast<float>(qr - 1), uc = static_cast<float>(qc - 1);
  const float cr = sp * (cos_t * ur + sin_t * uc);
  const float cc = sp * (cos_t * uc - sin_t * ur);
  const float half = (0.5f * sp) * (fabsf(cos_t) + fabsf(sin_t)) + 1.0f;
  return support_box(w, cr, cc, half);
}

constexpr int K6_NT = 256;      // threads a K6 block
constexpr int NQ = 25;          // descriptor quads (5 x 5)
constexpr int QSUB = 10;        // threads a quad
static_assert(NQ * QSUB <= K6_NT && NB <= K6_NT, "one thread per (quad, sub) and per bin");
constexpr int K6_PART = NORI > 32 ? NORI : 32;   // private floats a thread

// A. The orientation histogram over the circle's box into hist[0, 36):
// each thread sums its samples (box index tid, tid + K6_NT, ...) into its own
// column of part (NORI x K6_NT), then a warp per bin sums the columns in a
// fixed order.
__device__ void k6_orientation(const Window& w, float sig, float* part, float* hist) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int b = 0; b < NORI; ++b) part[b * K6_NT + tid] = 0.f;
  const float sig_w = 1.5f * sig;
  const float radius = floorf(3.0f * sig_w);
  const float rad2 = radius * radius + 0.5f;
  const float den = 2.0f * sig_w * sig_w;
  const Box bx = orientation_box(w, sig);
  const int bw = bx.c1 - bx.c0, n = bw > 0 && bx.r1 > bx.r0 ? (bx.r1 - bx.r0) * bw : 0;
  for (int idx = tid; idx < n; idx += K6_NT) {
    const int i = bx.r0 + idx / bw, j = bx.c0 + idx % bw;
    const float rr = static_cast<float>(i) - w.fro;
    const float cc = static_cast<float>(j) - w.fco;
    const float d2 = rr * rr + cc * cc;
    if (!(d2 < rad2)) continue;
    const long long off = static_cast<long long>(w.rs + i) * w.stride + (w.cs + j);
    const float wt = expf(-d2 / den) * __ldg(w.mag + off);
    int b = static_cast<int>(floorf(36.0f * (__ldg(w.ori + off) + PI_F) / TWO_PI_F));
    b = min(max(b, 0), NORI - 1);
    part[b * K6_NT + tid] += wt;
  }
  __syncthreads();
  reduce_bins<K6_NT>(part, NORI, hist);
  __syncthreads();
}

// B. On warp 0: six rounds of the circular 3-tap box over hist (lane l
// holds bins l and, for l < 4, l + 32; neighbours through shared memory),
// the max, then up to max_ori peaks >= 0.8 max, strictly above both
// neighbours, strongest first, ties to the lowest bin (an argmax by
// shuffles), each with its parabolic fit.  Writes ang_s / ok_s and the
// slot's outputs.
__device__ void k6_peaks(float* hist, int max_ori, float* ang_s, int* ok_s, float* ang_out,
                         unsigned char* ok_out) {
  const int lane = threadIdx.x & 31;
  const bool two = lane < NORI - 32;
  for (int round = 0; round < 6; ++round) {
    const float t0 = ((hist[(lane + NORI - 1) % NORI] + hist[lane]) + hist[lane + 1]) / 3.0f;
    const float t1 = two ? ((hist[lane + 31] + hist[lane + 32]) + hist[(lane + 33) % NORI]) / 3.0f
                         : 0.0f;
    __syncwarp();
    hist[lane] = t0;
    if (two) hist[lane + 32] = t1;
    __syncwarp();
  }
  const float h0 = hist[lane], h1 = two ? hist[lane + 32] : -INFINITY;
  float hmax = fmaxf(h0, h1);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) hmax = fmaxf(hmax, __shfl_xor_sync(0xffffffffu, hmax, d));
  auto score_of = [&](int b, float hb) {
    const float l = hist[(b + NORI - 1) % NORI], rg = hist[(b + 1) % NORI];
    const bool peak = hb >= 0.8f * hmax && hb > l && hb > rg && hmax > 0.f;
    return peak ? hb : -INFINITY;
  };
  float s0 = score_of(lane, h0);
  float s1 = two ? score_of(lane + 32, h1) : -INFINITY;
  for (int o = 0; o < max_ori; ++o) {
    float m = s0;
    int bsel = lane;
    if (s1 > m) { m = s1; bsel = lane + 32; }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, d);
      const int b2 = __shfl_xor_sync(0xffffffffu, bsel, d);
      if (m2 > m || (m2 == m && b2 < bsel)) { m = m2; bsel = b2; }
    }
    if (lane == 0) {
      const bool okk = isfinite(m);
      const float l = hist[(bsel + NORI - 1) % NORI], rg = hist[(bsel + 1) % NORI];
      const float hh = hist[bsel];
      const float denom = (l - 2.0f * hh) + rg;
      const float off = denom != 0.f ? 0.5f * (l - rg) / denom : 0.f;
      float ang = TWO_PI_F * ((static_cast<float>(bsel) + 0.5f) + off) / 36.0f - PI_F;
      if (ang > PI_F) ang -= TWO_PI_F;
      if (ang <= -PI_F) ang += TWO_PI_F;
      ang_s[o] = ang;
      ok_s[o] = okk;
      ang_out[o] = ang;
      ok_out[o] = okk ? 1 : 0;
    }
    if (bsel == lane) s0 = -INFINITY;
    if (bsel == lane + 32) s1 = -INFINITY;
  }
}

// C. The raw 4x4x8 descriptor at `angle` into dst[0, 128).  Thread
// (quad, sub) walks quad's box (box index sub, sub + QSUB, ...) and adds
// each sample of that quad to its 4 cells x 2 orientations, in its own
// column of part (32 x K6_NT: corner slot (a, b) x 8 orientations); thread t
// then sums bin t over the (corner, quad, sub) columns that reach it in a
// fixed order.  The per-sample arithmetic is that of the plain version
// (ops/kernels/window.py::_descriptor_hists).
__device__ void k6_descriptor(const Window& w, float sig, float angle, float* part, float* dst) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int b = 0; b < 32; ++b) part[b * K6_NT + tid] = 0.f;
  const float cos_t = cosf(angle), sin_t = sinf(angle);
  const float spacing = 3.0f * sig;
  if (tid < NQ * QSUB) {
    const int q = tid / QSUB, sub = tid - q * QSUB;
    const int qr = q / 5 - 1, qc = q % 5 - 1;
    const Box bx = quad_box(w, sig, cos_t, sin_t, qr, qc);
    const int bw = bx.c1 - bx.c0;
    int i = bx.r0, j = bx.c0 + sub;
    if (bw > 0) {
      while (j >= bx.c1) { j -= bw; ++i; }
    } else {
      i = bx.r1;
    }
    for (; i < bx.r1;) {
      const float rr = static_cast<float>(i) - w.fro;
      const float cc = static_cast<float>(j) - w.fco;
      const int ii = i, jj = j;
      j += QSUB;
      while (j >= bx.c1) { j -= bw; ++i; }
      const float rrot = (cos_t * rr - sin_t * cc) / spacing;
      const float crot = (sin_t * rr + cos_t * cc) / spacing;
      const float rbin = rrot + 1.5f, cbin = crot + 1.5f;
      if (!(rbin > -1.f && rbin < 4.f && cbin > -1.f && cbin < 4.f)) continue;
      const int r0 = static_cast<int>(floorf(rbin));
      const int c0 = static_cast<int>(floorf(cbin));
      if (r0 != qr || c0 != qc) continue;
      const long long off = static_cast<long long>(w.rs + ii) * w.stride + (w.cs + jj);
      const float gw = expf(-(rrot * rrot + crot * crot) / 8.0f);
      const float m = gw * __ldg(w.mag + off);
      float ob = (__ldg(w.ori + off) - angle) * ORI_SCALE;
      ob = ob - floorf(ob / 8.0f) * 8.0f;  // in [0, 8]
      const int o0 = static_cast<int>(floorf(ob));
      int oo[2];
      float mo[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        oo[k] = (o0 + k) & 7;
        float dd = fabsf(ob - static_cast<float>(oo[k]));
        dd = fminf(dd, 8.0f - dd);
        mo[k] = m * fmaxf(0.f, 1.f - dd);
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int ri = r0 + a;
        if (ri < 0 || ri > 3) continue;
        const float wr = fmaxf(0.f, 1.f - fabsf(rbin - static_cast<float>(ri)));
#pragma unroll
        for (int bb = 0; bb < 2; ++bb) {
          const int cj = c0 + bb;
          if (cj < 0 || cj > 3) continue;
          const float wrc = wr * fmaxf(0.f, 1.f - fabsf(cbin - static_cast<float>(cj)));
          float* col = part + ((a * 2 + bb) * 8) * K6_NT + tid;
          col[oo[0] * K6_NT] += wrc * mo[0];
          col[oo[1] * K6_NT] += wrc * mo[1];
        }
      }
    }
  }
  __syncthreads();
  // bin tid = (cell (ri, cj), orientation o): quad (ri - a, cj - bb) at
  // corner slot (a, bb)
  if (tid < NB) {
    const int cell = tid >> 3, o = tid & 7, ri = cell >> 2, cj = cell & 3;
    float sum = 0.f;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int bb = 0; bb < 2; ++bb) {
        const int q = (ri - a + 1) * 5 + (cj - bb + 1);
        const float* col = part + ((a * 2 + bb) * 8 + o) * K6_NT + q * QSUB;
#pragma unroll
        for (int u = 0; u < QSUB; ++u) sum += col[u];
      }
    }
    dst[tid] = sum;
  }
  __syncthreads();  // part is reused by the next pass
}

// K6: one block per keypoint slot of the atlas; an invalid slot's block
// writes its zeros and exits.  The window origin, its subpixel offsets and
// the plane index come from the slot's own fr, fc and s_int, as
// slot_window computes them.
__global__ void __launch_bounds__(K6_NT, 1024 / K6_NT) orient_desc_kernel(
    const float* __restrict__ mag, const float* __restrict__ ori, int rows, int wmax,
    const int* __restrict__ s_int, const float* __restrict__ fr_in,
    const float* __restrict__ fc_in, const unsigned char* __restrict__ valid,
    const float* __restrict__ sigma_in, const int* __restrict__ row_off,
    const int* __restrict__ oct_h, const int* __restrict__ oct_w, int win, int max_ori,
    float* ang_out, unsigned char* ok_out, float* desc_out) {
  __shared__ float part[K6_PART * K6_NT];   // per-thread private columns
  __shared__ float hist[NORI];
  __shared__ float ang_s[MAX_ORI];
  __shared__ int ok_s[MAX_ORI];
  const int k = blockIdx.x, tid = threadIdx.x;
  float* dk = desc_out + static_cast<long long>(k) * max_ori * NB;
  if (!valid[k]) {
    for (int i = tid; i < max_ori * NB; i += K6_NT) dk[i] = 0.f;
    if (tid < max_ori) {
      ang_out[k * max_ori + tid] = 0.f;
      ok_out[k * max_ori + tid] = 0;
    }
    return;
  }
  const float fr = fr_in[k], fc = fc_in[k];
  const int rs = static_cast<int>(rintf(fr)) - win / 2;
  const int cs = static_cast<int>(rintf(fc)) - win / 2;
  const long long plane0 = (static_cast<long long>(s_int[k] - 1) * rows + row_off[k]) * wmax;
  const Window w{mag + plane0, ori + plane0, wmax, oct_h[k], oct_w[k], rs, cs,
                 win, fr - static_cast<float>(rs), fc - static_cast<float>(cs)};
  const float sig = sigma_in[k];

  k6_orientation(w, sig, part, hist);
  if (tid < 32)
    k6_peaks(hist, max_ori, ang_s, ok_s, ang_out + k * max_ori, ok_out + k * max_ori);
  __syncthreads();
  for (int o = 0; o < max_ori; ++o) {
    float* dst = dk + o * NB;
    if (!ok_s[o]) {  // block-uniform
      if (tid < NB) dst[tid] = 0.f;
      continue;
    }
    k6_descriptor(w, sig, ang_s[o], part, dst);
  }
}

// The window of keypoint slot k of one octave (K11a, K11b): origin
// (rint(fr) - win/2, rint(fc) - win/2), rint rounding half to even as
// torch.round and jnp.round do, and the subpixel offsets from it (exact in
// f32), as window_origin computes them for K6.
__device__ __forceinline__ Window slot_window(const float* mag, const float* ori,
                                              long long plane_stride, long long row_stride,
                                              int H, int W, int s_int, float fr, float fc,
                                              int win) {
  const long long plane0 = static_cast<long long>(s_int - 1) * plane_stride;
  const int rs = static_cast<int>(rintf(fr)) - win / 2;
  const int cs = static_cast<int>(rintf(fc)) - win / 2;
  return Window{mag + plane0, ori + plane0, row_stride, H, W, rs, cs, win,
                fr - static_cast<float>(rs), fc - static_cast<float>(cs)};
}

// K11a: one block per keypoint slot of one octave's gradient planes (`mag`
// / `ori` point at the octave's (0, 0) sample of plane 0): its raw 36-bin
// orientation histogram by K6's step A over the orientation box, zeros for
// an invalid slot.
__global__ void __launch_bounds__(K6_NT, 1024 / K6_NT) orientation_hist_kernel(
    const float* __restrict__ mag, const float* __restrict__ ori, long long plane_stride,
    long long row_stride, int H, int W, const int* __restrict__ s_int,
    const float* __restrict__ fr, const float* __restrict__ fc,
    const float* __restrict__ sigma, const unsigned char* __restrict__ valid, int win,
    float* out) {
  __shared__ float part[NORI * K6_NT];   // per-thread private columns
  __shared__ float hist[NORI];
  const int k = blockIdx.x, tid = threadIdx.x;
  float* dst = out + static_cast<long long>(k) * NORI;
  if (!valid[k]) {
    if (tid < NORI) dst[tid] = 0.f;
    return;
  }
  const Window w = slot_window(mag, ori, plane_stride, row_stride, H, W, s_int[k], fr[k], fc[k],
                               win);
  k6_orientation(w, sigma[k], part, hist);
  if (tid < NORI) dst[tid] = hist[tid];
}

// K11b: as K11a, the raw 128-bin descriptor of each slot at its angle, by
// K6's step C over the 25 quad boxes (k6_descriptor writes the row).
__global__ void __launch_bounds__(K6_NT, 1024 / K6_NT) descriptor_hist_kernel(
    const float* __restrict__ mag, const float* __restrict__ ori, long long plane_stride,
    long long row_stride, int H, int W, const int* __restrict__ s_int,
    const float* __restrict__ fr, const float* __restrict__ fc,
    const float* __restrict__ sigma, const float* __restrict__ angle,
    const unsigned char* __restrict__ valid, int win, float* out) {
  __shared__ float part[32 * K6_NT];     // per-thread private columns
  const int k = blockIdx.x, tid = threadIdx.x;
  float* dst = out + static_cast<long long>(k) * NB;
  if (!valid[k]) {
    if (tid < NB) dst[tid] = 0.f;
    return;
  }
  const Window w = slot_window(mag, ori, plane_stride, row_stride, H, W, s_int[k], fr[k], fc[k],
                               win);
  k6_descriptor(w, sigma[k], angle[k], part, dst);
}

}  // namespace

// mag, ori: (S, rows, wmax) f32 gradient atlas; per keypoint slot (n of
// them): s_int (1-based plane index, int32), fr/fc (octave-local f32),
// valid (uint8), sigma (f32), row_off/oct_h/oct_w (int32: the octave's
// first atlas row and its size).  Outputs: ang (n, max_ori) f32, ok (n,
// max_ori) uint8, desc (n, max_ori, 128) f32.  One launch.
extern "C" int sift_orient_desc(const void* mag, const void* ori, int rows, int wmax,
                                int n, const void* s_int, const void* fr, const void* fc,
                                const void* valid, const void* sigma,
                                const void* row_off, const void* oct_h,
                                const void* oct_w, int win, int max_ori, void* ang,
                                void* ok, void* desc, void* stream) {
  if (max_ori < 1 || max_ori > MAX_ORI || win < 1) return cudaErrorInvalidValue;
  if (n > 0) {
    orient_desc_kernel<<<n, K6_NT, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(mag), static_cast<const float*>(ori), rows, wmax,
        static_cast<const int*>(s_int), static_cast<const float*>(fr),
        static_cast<const float*>(fc), static_cast<const unsigned char*>(valid),
        static_cast<const float*>(sigma), static_cast<const int*>(row_off),
        static_cast<const int*>(oct_h), static_cast<const int*>(oct_w), win, max_ori,
        static_cast<float*>(ang), static_cast<unsigned char*>(ok),
        static_cast<float*>(desc));
  }
  return static_cast<int>(cudaGetLastError());
}

// K11a and K11b.  mag, ori: the (0, 0) sample of one octave in plane 0 of
// its (S, rows, cols) f32 gradient planes, with plane and row strides in
// elements; the octave is H x W.  Per keypoint slot (n of them): s_int
// (1-based scale index, int32), fr/fc (octave-local), sigma and, for K11b,
// angle (f32), valid (uint8).  out: (n, 36) f32 histograms (K11a) or
// (n, 128) f32 raw descriptors (K11b).  One launch each.
extern "C" int sift_orientation_hist(const void* mag, const void* ori, long long plane_stride,
                                     long long row_stride, int H, int W, int n,
                                     const void* s_int, const void* fr, const void* fc,
                                     const void* sigma, const void* valid, int win, void* out,
                                     void* stream) {
  if (win < 1 || H < 1 || W < 1) return cudaErrorInvalidValue;
  if (n > 0) {
    orientation_hist_kernel<<<n, K6_NT, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(mag), static_cast<const float*>(ori), plane_stride,
        row_stride, H, W, static_cast<const int*>(s_int), static_cast<const float*>(fr),
        static_cast<const float*>(fc), static_cast<const float*>(sigma),
        static_cast<const unsigned char*>(valid), win, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sift_descriptor_hist(const void* mag, const void* ori, long long plane_stride,
                                    long long row_stride, int H, int W, int n,
                                    const void* s_int, const void* fr, const void* fc,
                                    const void* sigma, const void* angle, const void* valid,
                                    int win, void* out, void* stream) {
  if (win < 1 || H < 1 || W < 1) return cudaErrorInvalidValue;
  if (n > 0) {
    descriptor_hist_kernel<<<n, K6_NT, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(mag), static_cast<const float*>(ori), plane_stride,
        row_stride, H, W, static_cast<const int*>(s_int), static_cast<const float*>(fr),
        static_cast<const float*>(fc), static_cast<const float*>(sigma),
        static_cast<const float*>(angle), static_cast<const unsigned char*>(valid), win,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
