// K3 and K10a: stream compaction of extrema masks, one launch a call.
//
// Replaces sift_pyocl_tpu/ops/pallas/compact.py::compact_masks_multi (K3,
// every octave's mask) and, called with one mask, compact_mask_pallas (K10a).
// Output: for octave o, the flat row-major indices of its set mask bytes in
// exactly np.nonzero order, at idx[outoff[o] ...], at most MAX_PER_TILE
// kept per 64x512-element tile (bits past that are dropped but counted in
// total[o]), cut at cap[o].  written[o] = min(sum_t min(cnt_t, 128), cap[o]),
// and idx is 0 from written[o] to cap[o].
//
// What the TPU kernel kept out of device memory: its write cursor.  Its grid
// runs the tiles in order on one core, carrying the cursor in SMEM from one
// grid step to the next, and each tile is read into VMEM once.
//
// What bounds it on this card: reading the masks once (one byte per DoG
// sample inside the border: 6.1 MB for octave 0 at 1080x1920, 1.8 us at
// 3.35 TB/s).  Blocks run in any order, so a cursor needs a scan across
// blocks; done in separate kernels (count, scan, extract) it costs three
// launch gaps and a second read of every non-empty tile, which is what the
// earlier three-kernel design paid.
//
// Design: a single-pass scan with decoupled look-back (Merrill & Garland),
// one block a tile, one launch a call.
//   * Tile order.  A block takes its tile from an atomic ticket, so every
//     tile before it belongs to a block that has already started: the
//     look-back only ever waits on running blocks and cannot deadlock.
//   * Load once.  The block loads its 32 KB tile with 16-byte loads into
//     registers (coalesced: thread j holds chunks j, j + 256, ...), counts
//     it, and, when the tile has set bytes, stages it in shared memory
//     (XOR-swizzled 16-byte slots, conflict-free both ways) so that each
//     thread can then read 128 contiguous bytes in row-major order.
//   * Publish and look back.  Thread 0 publishes the tile's aggregate
//     (kept, total); warp 0 then reads up to 32 predecessors at a time,
//     back to the first tile of its octave, summing aggregates until it
//     meets an inclusive prefix, and publishes its own inclusive prefix.
//   * Extract from shared memory: a block scan of the per-thread counts
//     gives each thread its rank, and each set byte whose rank is below the
//     tile's limit writes its index.  No atomics touch the data, so the
//     output is deterministic: every offset is an exact integer sum.
//   * The last tile of each octave writes written[o] and total[o] and
//     zero-fills idx[written, cap), so the caller allocates idx uninitialised.
//
// Scratch (one per device and stream, zeroed once by the caller at first use
// and never cleared again), 64-bit words:
//   [0]               ticket word: ticket in bits 0-23, epoch in bits 24-63;
//   [1, 1+M)          flag of tile t: (epoch << 2) | state (0 none,
//                     1 aggregate, 2 inclusive prefix);
//   [1+M, 1+2M)       aggregate of tile t:  (kept << 32) | total;
//   [1+2M, 1+3M)      inclusive prefix of tile t within its octave, packed so;
// with M = MAX_TILES = 2^16.  The block that draws the last ticket
// swaps the ticket word to (epoch + 1, 0), on the device, so the next call
// draws tickets from 0 under a new epoch and ignores every flag of this
// call: nothing is cleared between calls, and a CUDA graph replays the same
// launch with the epoch advancing on each replay.  A stale flag can match
// only after 2^40 calls.  Packing limits: at most M = 2^16 tiles a call (2^31
// mask bytes, the int32 range of the indices; a doubled 4K frame's octave 0
// is 3052 tiles), so kept (< 2^23) and total (< 2^31) never carry across
// their 32-bit fields; the caller refuses larger masks.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int TILE = 64 * 512;                // elements per tile (the JAX kernel's)
constexpr int MAX_PER_TILE = 128;             // kept set bytes per tile
constexpr int NT = 256;                       // threads per block
constexpr int CHUNKS = TILE / 16 / NT;        // 16-byte chunks a thread: 8
constexpr int TICKET_BITS = 24;
constexpr unsigned long long TICKET_MASK = (1ull << TICKET_BITS) - 1;
constexpr int MAX_TILES = 1 << 16;
constexpr unsigned long long ST_AGG = 1, ST_INCL = 2;

struct CompactMeta {
  int n_oct;
  int n_tiles;
  const unsigned char* mask[SIFT_MAX_OCT];
  long long n[SIFT_MAX_OCT];        // elements of each octave's mask
  int tile0[SIFT_MAX_OCT + 1];      // first tile of each octave
  int cap[SIFT_MAX_OCT];
  int outoff[SIFT_MAX_OCT];         // first output slot of each octave
};

__device__ __forceinline__ void st_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ int octave_of_tile(const CompactMeta& m, int t) {
  int o = 0;
  while (o + 1 < m.n_oct && t >= m.tile0[o + 1]) ++o;
  return o;
}

// Bit 8k+7 set iff byte k of w is nonzero.
__device__ __forceinline__ unsigned nonzero_bytes(unsigned w) {
  return (((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) & 0x80808080u;
}

__device__ __forceinline__ int count16(const uint4& v) {
  return __popc(nonzero_bytes(v.x)) + __popc(nonzero_bytes(v.y)) +
         __popc(nonzero_bytes(v.z)) + __popc(nonzero_bytes(v.w));
}

// Sixteen mask bytes at offset `off` of a tile holding `rem` valid bytes
// (bytes at or past rem read as 0).  The mask is 16-byte aligned.
__device__ __forceinline__ uint4 load16(const unsigned char* p, int off, long long rem) {
  if (off + 16 <= rem) return __ldg(reinterpret_cast<const uint4*>(p + off));
  unsigned w[4] = {0u, 0u, 0u, 0u};
  for (int b = 0; b < 16; ++b)
    if (off + b < rem) w[b >> 2] |= static_cast<unsigned>(p[off + b]) << (8 * (b & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Shared-memory slot of 16-byte chunk g: the low three bits XORed with bits
// 3-5, so that eight threads storing consecutive chunks, and eight threads
// each reading the k-th of its own eight consecutive chunks, hit distinct banks.
__device__ __forceinline__ int swz(int g) { return g ^ ((g >> 3) & 7); }

// Warp 0: the exclusive prefix (kept << 32 | total) of tile t over tiles
// t0..t-1 of its octave, from their published aggregates and prefixes.
__device__ unsigned long long look_back(const unsigned long long* flags,
                                        const unsigned long long* aggs,
                                        const unsigned long long* incls, int t, int t0,
                                        unsigned long long epoch) {
  const int lane = threadIdx.x & 31;
  unsigned long long excl = 0;
  int hi = t - 1;  // nearest predecessor not yet summed
  unsigned spins = 0;
  while (true) {
    const int p = hi - lane;
    unsigned long long st = ST_INCL;  // before the octave's first tile: an inclusive 0
    if (p >= t0) {
      const unsigned long long f = ld_acquire(flags + p);
      st = (f >> 2) == epoch ? (f & 3ull) : 0ull;
    }
    const unsigned incl = __ballot_sync(0xffffffffu, st == ST_INCL);
    const unsigned none = __ballot_sync(0xffffffffu, st == 0);
    // lanes up to the nearest inclusive prefix (all 32 if there is none)
    const unsigned upto = incl ? (incl & (0u - incl)) * 2u - 1u : 0xffffffffu;
    if (none & upto) {
      // a predecessor has not published yet: read again.  Every predecessor
      // is running, so this ends; if it ever did not (seconds), abort the
      // kernel with an error rather than hang the card.
      if (++spins > (1u << 26)) __trap();
      __nanosleep(20);
      continue;
    }
    unsigned long long v = 0;
    if (((upto >> lane) & 1u) && p >= t0) v = ld_relaxed((st == ST_INCL ? incls : aggs) + p);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
    excl += v;
    if (incl) return excl;
    hi -= 32;
  }
}

__global__ void __launch_bounds__(NT) compact_kernel(CompactMeta m,
                                                     unsigned long long* __restrict__ scratch,
                                                     int* __restrict__ idx,
                                                     int* __restrict__ written,
                                                     int* __restrict__ total) {
  __shared__ uint4 tile[NT * CHUNKS];       // 32 KB
  __shared__ unsigned long long s_ticket, s_excl;
  unsigned long long* flags = scratch + 1;
  unsigned long long* aggs = flags + MAX_TILES;
  unsigned long long* incls = aggs + MAX_TILES;
  const int tid = threadIdx.x;

  if (tid == 0) {
    const unsigned long long tk = atomicAdd(scratch, 1ull);
    // the last ticket: every block has drawn one, so start the next epoch
    if (static_cast<int>(tk & TICKET_MASK) == static_cast<int>(gridDim.x) - 1)
      atomicExch(scratch, ((tk >> TICKET_BITS) + 1) << TICKET_BITS);
    s_ticket = tk;
  }
  __syncthreads();
  const int t = static_cast<int>(s_ticket & TICKET_MASK);
  const unsigned long long epoch = s_ticket >> TICKET_BITS;

  if (t == 0) {  // octaves with no tiles (empty masks) get their outputs here
    for (int o = 0; o < m.n_oct; ++o) {
      if (m.tile0[o] != m.tile0[o + 1]) continue;
      if (tid == 0) written[o] = total[o] = 0;
      for (int i = tid; i < m.cap[o]; i += NT) idx[m.outoff[o] + i] = 0;
    }
  }
  if (t >= m.n_tiles) return;

  const int o = octave_of_tile(m, t);
  const int t0 = m.tile0[o];
  const long long base = static_cast<long long>(t - t0) * TILE;
  const unsigned char* p = m.mask[o] + base;
  const long long rem = m.n[o] - base;

  uint4 v[CHUNKS];
  int c = 0;
#pragma unroll
  for (int k = 0; k < CHUNKS; ++k) {
    v[k] = load16(p, 16 * (tid + NT * k), rem);
    c += count16(v[k]);
  }
  int cnt;
  block_exclusive_scan(c, &cnt);
  const int kept = min(cnt, MAX_PER_TILE);
  const unsigned long long agg =
      (static_cast<unsigned long long>(kept) << 32) | static_cast<unsigned>(cnt);
  if (tid == 0) {
    if (t == t0) {
      incls[t] = agg;
      st_release(flags + t, (epoch << 2) | ST_INCL);
    } else {
      aggs[t] = agg;
      st_release(flags + t, (epoch << 2) | ST_AGG);
    }
  }
  if (cnt > 0) {
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) tile[swz(tid + NT * k)] = v[k];
  }
  if (tid < 32) {
    const unsigned long long excl = t > t0 ? look_back(flags, aggs, incls, t, t0, epoch) : 0ull;
    if (tid == 0) {
      if (t > t0) {
        incls[t] = excl + agg;
        st_release(flags + t, (epoch << 2) | ST_INCL);
      }
      s_excl = excl;
    }
  }
  __syncthreads();
  const int first = static_cast<int>(s_excl >> 32);
  const int cap = m.cap[o];
  int* out = idx + m.outoff[o];
  if (t == m.tile0[o + 1] - 1) {  // the octave's last tile: its outputs
    const int w = min(first + kept, cap);
    if (tid == 0) {
      written[o] = w;
      total[o] = static_cast<int>(static_cast<unsigned>(s_excl) + static_cast<unsigned>(cnt));
    }
    for (int i = w + tid; i < cap; i += NT) out[i] = 0;
  }
  const int limit = min(kept, cap - first);
  if (cnt == 0 || limit <= 0) return;  // block-uniform

  // thread j ranks bytes [128 j, 128 j + 128) of the tile, in row-major order
  int cj = 0;
#pragma unroll
  for (int k = 0; k < CHUNKS; ++k) {
    v[k] = tile[swz(CHUNKS * tid + k)];
    cj += count16(v[k]);
  }
  int sum;
  int r = block_exclusive_scan(cj, &sum);
  if (cj == 0 || r >= limit) return;
  out += first;
  const int e0 = static_cast<int>(base) + 16 * CHUNKS * tid;
#pragma unroll
  for (int k = 0; k < CHUNKS; ++k) {
    const unsigned w[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      unsigned bits = nonzero_bytes(w[q]);
      while (bits != 0u && r < limit) {
        const int b = (__ffs(bits) - 1) >> 3;
        out[r++] = e0 + 16 * k + 4 * q + b;
        bits &= bits - 1u;
      }
    }
  }
}

}  // namespace

// masks: n_oct device pointers to 16-byte-aligned uint8 (0/1) masks of
// lens[o] elements; idx: sum(caps) int32 (need not be initialised); written,
// total: n_oct int32; scratch: sift_compact_scratch_words() 64-bit words,
// zeroed before the first call on this stream and left as the last call left
// them (see the design note).
extern "C" int sift_compact_masks_multi(int n_oct, const void* const* masks,
                                        const long long* lens, const int* caps,
                                        void* idx, void* written, void* total,
                                        void* scratch, void* stream) {
  if (n_oct < 1 || n_oct > SIFT_MAX_OCT || scratch == nullptr) return cudaErrorInvalidValue;
  CompactMeta m = {};
  m.n_oct = n_oct;
  long long tiles = 0;
  int outoff = 0;
  for (int o = 0; o < n_oct; ++o) {
    if (lens[o] < 0 || lens[o] > INT32_MAX || caps[o] < 0) return cudaErrorInvalidValue;
    if (reinterpret_cast<std::uintptr_t>(masks[o]) % 16 != 0) return cudaErrorMisalignedAddress;
    m.mask[o] = static_cast<const unsigned char*>(masks[o]);
    m.n[o] = lens[o];
    m.tile0[o] = static_cast<int>(tiles);
    tiles += (lens[o] + TILE - 1) / TILE;
    if (tiles > MAX_TILES) return cudaErrorInvalidValue;
    m.cap[o] = caps[o];
    m.outoff[o] = outoff;
    outoff += caps[o];
  }
  m.tile0[n_oct] = static_cast<int>(tiles);
  m.n_tiles = static_cast<int>(tiles);
  const int grid = tiles > 0 ? static_cast<int>(tiles) : 1;
  compact_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      m, static_cast<unsigned long long*>(scratch), static_cast<int*>(idx),
      static_cast<int*>(written), static_cast<int*>(total));
  return static_cast<int>(cudaGetLastError());
}

// The scratch words a call needs (1 + 3 * MAX_TILES).
extern "C" int sift_compact_scratch_words() { return 1 + 3 * MAX_TILES; }
