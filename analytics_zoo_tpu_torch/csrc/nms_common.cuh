// The greedy-suppression engine shared by K1 (csrc/nms_sweep.cu) and K2's
// select launch (csrc/detection_output.cu).
//
// Input: one block's n candidates, already in sweep order (score
// descending), as float4 corner boxes in shared memory, and a bit array
// `alive` (one bit a candidate, 1 = may be kept; bits at and past n are 0).
// Output: `alive` holds exactly the kept candidates: a candidate is kept
// iff it was alive on entry and no earlier kept candidate has an IoU >=
// thr with it — the greedy sweep of the reference, with the kept box as
// the `b*` operand of the IoU (`sweep_iou`, ops/pallas_nms.py).
//
// Why a bit matrix: the sweep is a chain of up to n dependent steps.  Done
// as "step i, then every thread tests the lanes after i", each step ends in
// a block barrier with at most a few IoU tests a thread between barriers.
// Here the block instead tests every pair (i < j) of a tile of T
// candidates in one parallel pass, writing bit j of row i when j would be
// suppressed by a kept i; then ONE warp walks the tile with no barrier,
// 32 candidates a word: lane l holds the removed bits of word l, a word's
// 32 decisions are settled in rounds of two ballots (lane b keeps b once
// no earlier candidate of the word that suppresses it is kept or
// undecided), and the lanes of later words OR in the kept rows.  After a
// tile, every thread tests the still-alive
// later candidates against the tile's kept boxes, so a row of any length
// runs in ceil(n / T) tiles with shared memory for one T x T mask.
//
// The IoU repeats the reference's float operations one for one (+off on
// widths and heights, a union floor of 1e-12f, then the quotient's >=
// compare, decided by a true division wherever an approximate quotient
// could not prove the answer: `Threshold`; no rewrite as
// inter >= thr * uni); the build passes -fmad=false so nothing is
// contracted into a fused multiply-add.

#pragma once

#include <cuda_runtime.h>

namespace nms {

constexpr unsigned kFull = 0xffffffffu;

// Words of a tile's mask row: T / 32 rounded up to odd, so that neither
// the build's column writes nor the walk's row reads conflict on banks.
__host__ __device__ __forceinline__ int mask_stride(int tile) {
  return (tile / 32) | 1;
}

// Words of a bit array of n candidates, one bit a candidate.
__host__ __device__ __forceinline__ size_t words(int n) {
  return static_cast<size_t>((n + 31) / 32);
}

// Candidates a tile holds for n candidates in tiles of `tile` (a multiple
// of 32, at most 1024): never more than n rounded up to 32.
__host__ __device__ __forceinline__ int tile_rows(int n, int tile) {
  int t = ((n + 31) / 32) * 32;
  if (t > tile) t = tile;
  return t < 32 ? 32 : t;
}

// Bytes of the engine's work area: the tile's bit mask, its candidates'
// areas, and each candidate's suppressors within its own word.
__host__ __device__ __forceinline__ size_t work_bytes(int n, int tile) {
  const int t = tile_rows(n, tile);
  return static_cast<size_t>(t) * (mask_stride(t) + 2) * sizeof(unsigned);
}

// The threshold test `inter / uni >= thr`, decided first from the
// approximate quotient a = __fdividef(inter, uni) (rcp.approx and a
// product, at most 2 ulp from inter / uni for 2^-126 <= uni <= 2^126).
// Where a lies 2^-16 of thr or more above thr (below it), inter / uni is
// above thr (below thr by more than an ulp of thr), so the correctly
// rounded quotient is >= thr (< thr): the same answer the true division
// gives.  Anywhere else — a within 2^-16 of thr, NaN, uni past 2^125
// (the mask build instead checks once a tile that every coordinate and
// `off` is within 2^30, which bounds uni by 2^64), thr not a normal
// positive number — the true division decides.  The result is the
// reference's test bit for bit; only the cost differs.
struct Threshold {
  float thr, lo, hi;
  bool fast;
  __device__ explicit Threshold(float t)
      : thr(t), lo(t - t * 0x1p-16f), hi(t + t * 0x1p-16f),
        fast(t >= 0x1p-60f && t <= 0x1p60f) {}
  __device__ __forceinline__ bool at_least(float inter, float uni) const {
    if (fast && uni <= 0x1p125f) {
      const float a = __fdividef(inter, uni);
      if (a >= hi) return true;
      if (a <= lo) return false;
    }
    return inter / uni >= thr;
  }
};

// torch.maximum / torch.minimum: a NaN operand gives NaN (fmaxf and
// fminf return the other operand); the same result on numbers.
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : b != b ? b : fmaxf(a, b);
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : b != b ? b : fminf(a, b);
}

// The reference's intersection and union of the lane box q (area_q) and
// the kept box b (area_b), op for op; a NaN coordinate makes both NaN,
// so that the box neither suppresses nor is suppressed.
__device__ __forceinline__ void overlap(const float4 q, float area_q,
                                        const float4 b, float area_b,
                                        float off, float& inter, float& uni) {
  const float ix1 = nan_max(q.x, b.x), iy1 = nan_max(q.y, b.y);
  const float ix2 = nan_min(q.z, b.z), iy2 = nan_min(q.w, b.w);
  inter = nan_max(ix2 - ix1 + off, 0.f) * nan_max(iy2 - iy1 + off, 0.f);
  uni = nan_max(area_q + area_b - inter, 1e-12f);
}

__device__ __forceinline__ float box_area(const float4 b, float off) {
  return (b.z - b.x + off) * (b.w - b.y + off);
}

// True iff the kept box b suppresses the lane box q.
__device__ __forceinline__ bool suppresses(const float4 q, const float4 b,
                                           const Threshold& t, float off) {
  float inter, uni;
  overlap(q, box_area(q, off), b, box_area(b, off), off, inter, uni);
  return t.at_least(inter, uni);
}

__device__ __forceinline__ bool bit(const unsigned* bits, int i) {
  return (bits[i >> 5] >> (i & 31)) & 1u;
}

// -- phase stamps --------------------------------------------------------
// Thread 0 of block 0 writes %globaltimer (ns) to stamps[slot] right after
// a block barrier, so a slot marks when the whole block finished the phase
// before it.  `stamps` is null unless the caller asks for the split.
constexpr int kStampSlots = 16;

__device__ __forceinline__ void stamp(unsigned long long* stamps, int slot) {
  if (stamps != nullptr && blockIdx.x == 0 && blockIdx.y == 0 &&
      threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    stamps[slot] = t;
  }
}

// Run the greedy sweep over box[0, n) in tiles of `tile` candidates.
// `work` has work_bytes(n, tile) bytes, and box[] may be read (not used)
// up to n rounded up to 32.  Every thread of the block calls
// it; it begins and ends with a block barrier.  Stamps (when `stamps` is
// not null): slot+0 the first tile's mask built, slot+1 its walk done,
// slot+2 every tile done.
template <int THREADS>
__device__ void suppress(const float4* box, unsigned* alive, unsigned* work,
                         int n, int tile, float thr, float off,
                         unsigned long long* stamps, int slot) {
  static_assert(THREADS % 32 == 0 && THREADS >= 64, "whole warps");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Threshold test(thr);
  const int rows = tile_rows(n, tile);
  unsigned* mask = work;
  float* tarea = reinterpret_cast<float*>(work + rows * mask_stride(rows));
  unsigned* within = work + rows * (mask_stride(rows) + 1);
  __syncthreads();
  for (int s0 = 0; s0 < n; s0 += tile) {
    const int L = min(tile, n - s0);
    const int nw = (L + 31) >> 5;
    const int stride = mask_stride(nw * 32);
    const unsigned* tile_alive = alive + (s0 >> 5);
    bool small = fabsf(off) <= 0x1p30f;
    for (int j = threadIdx.x; j < L; j += THREADS) {
      const float4 bj = box[s0 + j];
      tarea[j] = box_area(bj, off);
      small = small && fabsf(bj.x) <= 0x1p30f && fabsf(bj.y) <= 0x1p30f &&
              fabsf(bj.z) <= 0x1p30f && fabsf(bj.w) <= 0x1p30f;
    }
    // every coordinate within 2^30: the approximate quotient may decide
    const bool fast = __syncthreads_and(small) && test.fast;

    // 1. the tile's mask: bit j of row i (j > i) where a kept i suppresses
    //    j.  A warp takes a pair of words (v, w), v <= w: lane l tests row
    //    i = 32v + l against the 32 candidates of word w, all lanes reading
    //    the same box.  The 32 tests run without a branch (the approximate
    //    quotient only); the few it cannot decide take the true division
    //    after.  A row's part in its own word goes, transposed by
    //    ballots, to `within`: bit k of within[j] when k < j suppresses j
    //    in j's word.  Rows of candidates dead on entry and words at or
    //    left of a row's own are never read, so never written.
    {
      const int npairs = nw * (nw + 1) / 2;
      int v = warp, w = 0;  // pairs run w-major: (0,0), (0,1), (1,1), ...
      while (v > w) { v -= w + 1; ++w; }
      for (int pidx = warp; pidx < npairs; pidx += THREADS / 32) {
        const int i = 32 * v + lane;
        unsigned row = 0;
        if (i < L && bit(tile_alive, i)) {
          const float4 bi = box[s0 + i];
          const float area_i = tarea[i];
          unsigned live = tile_alive[w];
          if (v == w) live &= lane == 31 ? 0u : (kFull << (lane + 1));
          const float4* bw = box + s0 + 32 * w;
          const float* aw = tarea + 32 * w;
          unsigned below = 0;
#pragma unroll 8
          for (int b = 0; b < 32; ++b) {
            float inter, uni;
            overlap(bw[b], aw[b], bi, area_i, off, inter, uni);
            const float a = __fdividef(inter, uni);
            if (a >= test.hi) row |= 1u << b;
            if (a <= test.lo) below |= 1u << b;
          }
          unsigned unsure = ~(row | below);
          if (!fast) { row = 0; unsure = kFull; }
          row &= live;
          for (unsigned u = unsure & live; u; u &= u - 1) {
            const int b = __ffs(u) - 1;
            float inter, uni;
            overlap(bw[b], aw[b], bi, area_i, off, inter, uni);
            if (inter / uni >= test.thr) row |= 1u << b;
          }
          if (v != w) mask[i * stride + w] = row;
        }
        if (v == w) {  // warp-uniform
          unsigned col = 0;
#pragma unroll
          for (int b = 0; b < 32; ++b) {
            const unsigned c = __ballot_sync(kFull, (row >> b) & 1u);
            if (lane == b) col = c;
          }
          within[32 * w + lane] = col;
        }
        v += THREADS / 32;
        while (v > w) { v -= w + 1; ++w; }
      }
    }
    __syncthreads();
    if (s0 == 0) stamp(stamps, slot);

    // 2. one warp walks the tile, word by word, with no block barrier.
    //    Inside a word, lane b decides candidate b: kept once none of its
    //    suppressors in the word is kept or undecided, removed once one is
    //    kept; each round settles at least the first undecided candidate
    //    (its suppressors are all earlier), most rounds many.
    if (warp == 0) {
      unsigned rem = lane < nw ? ~tile_alive[lane] : kFull;
      for (int w = 0; w < nw; ++w) {
        const unsigned sup = within[32 * w + lane];
        unsigned undecided = ~__shfl_sync(kFull, rem, w), kept = 0;
        while (undecided) {
          const bool mine = (undecided >> lane) & 1u;
          const unsigned keep_now =
              __ballot_sync(kFull, mine && !(sup & (kept | undecided)));
          const unsigned drop_now =
              __ballot_sync(kFull, mine && (sup & kept));
          kept |= keep_now;
          undecided &= ~(keep_now | drop_now);
        }
        if (lane == w) {
          rem = ~kept;
        } else if (lane > w && lane < nw) {
          // all 32 rows' words at once (independent loads), kept ones
          // OR-ed in: rows of candidates not kept may hold stale words
#pragma unroll
          for (int b = 0; b < 32; ++b) {
            const unsigned v = mask[(32 * w + b) * stride + lane];
            if ((kept >> b) & 1u) rem |= v;
          }
        }
      }
      if (lane < nw) alive[(s0 >> 5) + lane] = ~rem;
    }
    __syncthreads();
    if (s0 == 0) stamp(stamps, slot + 1);

    // 3. the later candidates against the tile's kept boxes: a warp owns
    //    whole words of `alive`, a lane one candidate
    const int first = s0 + L;
    if (first < n) {
      const int w_lo = first >> 5, w_hi = (n + 31) >> 5;
      for (int w = w_lo + warp; w < w_hi; w += THREADS / 32) {
        const unsigned live = alive[w];
        if (!live) continue;
        const int j = 32 * w + lane;
        bool dead = false;
        if ((live >> lane) & 1u) {
          const float4 bj = box[j];
          for (int tw = 0; tw < nw && !dead; ++tw)
            for (unsigned k = tile_alive[tw]; k && !dead; k &= k - 1)
              dead = suppresses(bj, box[s0 + 32 * tw + __ffs(k) - 1], test,
                                off);
        }
        const unsigned gone = __ballot_sync(kFull, dead);
        if (lane == 0 && gone) alive[w] = live & ~gone;
      }
      __syncthreads();
    }
  }
  stamp(stamps, slot + 2);
}

}  // namespace nms
