// K3: stream compaction of every octave's extrema mask in one call.
//
// Replaces sift_pyocl_tpu/ops/pallas/compact.py::compact_masks_multi and,
// called with one mask, compact_mask_pallas (K10a).
// Output: for octave o, the flat row-major indices of its set mask bytes in
// exactly np.nonzero order, at idx[outoff[o] ...], at most MAX_PER_TILE
// kept per 64x512-element tile (bits past that are dropped but counted in
// total[o]), cut at cap[o].  written[o] = min(sum_t min(cnt_t, 128), cap[o]).
//
// What bounds it on the card: reading the masks (one byte per DoG sample
// inside the border: about 8 MB at 1080x1920) and, in tiles that hold set
// bits, reading them a second time to rank.  The TPU kernel carries a write
// cursor in SMEM from one sequential grid step to the next; blocks here run
// in any order, so the cursor becomes three passes:
//   1. count_kernel: one block per tile counts its set bytes;
//   2. scan_kernel: one block per octave takes the exclusive scan over that
//      octave's tiles of min(cnt, 128) -> each tile's first output slot;
//   3. extract_kernel: one block per non-empty tile ranks its bytes in
//      row-major order (warp shuffles plus a block prefix) and writes each
//      index whose in-tile rank is < 128 and whose slot is < cap.
// No atomics, so the output is deterministic and in np.nonzero order.
#include "common.cuh"

namespace {

constexpr int TILE = 64 * 512;      // elements per tile (the JAX kernel's)
constexpr int MAX_PER_TILE = 128;   // kept set bits per tile
constexpr int NT = 256;             // threads per block

struct CompactMeta {
  int n_oct;
  const unsigned char* mask[SIFT_MAX_OCT];
  long long n[SIFT_MAX_OCT];        // elements of each octave's mask
  int tile0[SIFT_MAX_OCT + 1];      // first tile of each octave
  int cap[SIFT_MAX_OCT];
  int outoff[SIFT_MAX_OCT];         // first output slot of each octave
};

__device__ __forceinline__ int octave_of_tile(const CompactMeta& m, int t) {
  int o = 0;
  while (o + 1 < m.n_oct && t >= m.tile0[o + 1]) ++o;
  return o;
}

// Four mask bytes from flat index g (bytes at or past n read as 0).
__device__ __forceinline__ unsigned load4(const unsigned char* p, long long g,
                                          long long n) {
  if (g + 4 <= n) return *reinterpret_cast<const unsigned*>(p + g);
  unsigned v = 0;
  for (int k = 0; k < 4; ++k)
    if (g + k < n) v |= static_cast<unsigned>(p[g + k]) << (8 * k);
  return v;
}

__device__ __forceinline__ int byte_set(unsigned v, int k) {
  return ((v >> (8 * k)) & 0xffu) != 0u;
}

__global__ void __launch_bounds__(NT) count_kernel(CompactMeta m, int* tile_cnt) {
  const int t = blockIdx.x;
  const int o = octave_of_tile(m, t);
  const long long base = static_cast<long long>(t - m.tile0[o]) * TILE;
  int c = 0;
  for (int i = threadIdx.x * 4; i < TILE; i += NT * 4) {
    const unsigned v = load4(m.mask[o], base + i, m.n[o]);
    c += byte_set(v, 0) + byte_set(v, 1) + byte_set(v, 2) + byte_set(v, 3);
  }
  int total;
  block_exclusive_scan(c, &total);
  if (threadIdx.x == 0) tile_cnt[t] = total;
}

__global__ void __launch_bounds__(NT) scan_kernel(CompactMeta m, const int* tile_cnt,
                                                  int* tile_off, int* written,
                                                  int* total) {
  const int o = blockIdx.x;
  const int t0 = m.tile0[o], t1 = m.tile0[o + 1];
  int kept_run = 0, cnt_run = 0;
  for (int c0 = t0; c0 < t1; c0 += NT) {
    const int t = c0 + threadIdx.x;
    const int cnt = t < t1 ? tile_cnt[t] : 0;
    int kept_sum, cnt_sum;
    const int excl = block_exclusive_scan(min(cnt, MAX_PER_TILE), &kept_sum);
    block_exclusive_scan(cnt, &cnt_sum);
    if (t < t1) tile_off[t] = kept_run + excl;
    kept_run += kept_sum;
    cnt_run += cnt_sum;
  }
  if (threadIdx.x == 0) {
    written[o] = min(kept_run, m.cap[o]);
    total[o] = cnt_run;
  }
}

__global__ void __launch_bounds__(NT) extract_kernel(CompactMeta m, const int* tile_cnt,
                                                     const int* tile_off, int* idx) {
  const int t = blockIdx.x;
  const int cnt = tile_cnt[t];
  if (cnt == 0) return;
  const int o = octave_of_tile(m, t);
  const int first = tile_off[t];
  const int limit = min(min(cnt, MAX_PER_TILE), m.cap[o] - first);
  if (limit <= 0) return;
  int* out = idx + m.outoff[o] + first;
  const long long base = static_cast<long long>(t - m.tile0[o]) * TILE;
  int found = 0;  // set bytes seen so far in this tile (block-uniform)
  for (int i0 = 0; i0 < TILE && found < limit; i0 += NT * 4) {
    const int i = i0 + threadIdx.x * 4;
    const unsigned v = load4(m.mask[o], base + i, m.n[o]);
    const int c = byte_set(v, 0) + byte_set(v, 1) + byte_set(v, 2) + byte_set(v, 3);
    int step;
    int r = found + block_exclusive_scan(c, &step);
    for (int k = 0; k < 4; ++k) {
      if (byte_set(v, k)) {
        if (r < limit) out[r] = static_cast<int>(base + i + k);
        ++r;
      }
    }
    found += step;
  }
}

}  // namespace

// masks: n_oct device pointers to uint8 (0/1) masks of lens[o] elements;
// idx: sum(caps) int32 (zero-filled by the caller); written, total: n_oct
// int32; tile_cnt, tile_off: one int32 per tile of TILE elements.
extern "C" int sift_compact_masks_multi(int n_oct, const void* const* masks,
                                        const long long* lens, const int* caps,
                                        void* idx, void* written, void* total,
                                        void* tile_cnt, void* tile_off,
                                        void* stream) {
  if (n_oct < 1 || n_oct > SIFT_MAX_OCT) return cudaErrorInvalidValue;
  CompactMeta m = {};
  m.n_oct = n_oct;
  int tiles = 0, outoff = 0;
  for (int o = 0; o < n_oct; ++o) {
    m.mask[o] = static_cast<const unsigned char*>(masks[o]);
    m.n[o] = lens[o];
    m.tile0[o] = tiles;
    tiles += static_cast<int>((lens[o] + TILE - 1) / TILE);
    m.cap[o] = caps[o];
    m.outoff[o] = outoff;
    outoff += caps[o];
  }
  m.tile0[n_oct] = tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* cnt = static_cast<int*>(tile_cnt);
  int* off = static_cast<int*>(tile_off);
  if (tiles > 0) count_kernel<<<tiles, NT, 0, s>>>(m, cnt);
  scan_kernel<<<n_oct, NT, 0, s>>>(m, cnt, off, static_cast<int*>(written),
                                   static_cast<int*>(total));
  if (tiles > 0) extract_kernel<<<tiles, NT, 0, s>>>(m, cnt, off, static_cast<int*>(idx));
  return static_cast<int>(cudaGetLastError());
}
