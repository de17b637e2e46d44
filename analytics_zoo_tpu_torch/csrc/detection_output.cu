// Kernel K2: the whole SSD DetectionOutput — decode, per-class confidence
// filter + top-nms_topk selection + greedy suppression, global keep_topk
// merge — for a batch.
//
// Replaces: analytics_zoo_tpu/ops/pallas_detout.py, fused_detection_output
// (pallas_call at :285, body _fused_kernel at :91), every stage.  Output
// rows (class_id, score, x1, y1, x2, y2), empty rows (-1, 0, 0, 0, 0, 0).
//
// The reference's profile stages ("decode", "select") write a probe into
// every entry of an image's (keep_topk, 6) block: the sum over ALL priors
// of the decoded (and, under clip, clipped) x1 and y2, plus, for
// "select", the sum of every kept score of the image's foreground rows
// (its `allkeep` plane; here the kept lists the select launch writes).
// The select launch decodes only the candidates, so the probe is a launch
// of its own (3 below): one block an image decodes every prior with the
// same decode() and reduces in double in a fixed order, so a run repeats
// bit for bit.  "decode" is that launch alone, "select" the select launch
// then it, "full" select + merge.
//
// What bounds it on the H100: the dependency chain, not bytes.  It reads
// loc, conf, priors and variances once (7.3 MB for SSD300 at batch 8) and
// writes 38 KB, about 2 us of HBM time; but the greedy suppression of each
// (image, class) row is a chain of up to nms_topk = 400 dependent
// decisions.  The design keeps every other part of the work off chains:
//
//  1. select: one block per (image, foreground class), all rows resident
//     at once.  The class's score row is staged in shared memory as
//     order-preserving uint32 keys (invalid lanes, <= conf_thresh, hold 0).
//     Where more than nms_topk are valid, a radix select (at most 4
//     passes of 8-bit digits, a shared histogram with warp-aggregated
//     counts) finds the nms_topk-th largest key; a block prefix sum then
//     compacts, in prior order, every key above it and the lowest-prior
//     nms_topk - n_greater keys equal to it — the reference's stable
//     top_k, whose boundary falls inside runs of equal scores when
//     confidences are quantized.
//     Each survivor's rank in (score desc, prior asc) order is counted
//     against the others (<= nms_topk compares a thread), it decodes its
//     own box (no decode launch: only the candidates are ever decoded) and
//     lands at its rank; then the suppression engine of nms_common.cuh
//     (one parallel pass of IoU tests into a bit matrix, one warp walking
//     it) leaves the kept bits, and the kept candidates with score > 0 go,
//     in order, to the row's slice of a (B, C_fg, nms_topk) scratch;
//  2. merge: one block per (foreground class, image).  Each row's kept
//     list is already in (score desc, prior asc) order, so an entry's
//     final rank needs no pops: its place in its own list plus, in every
//     other list, the count of entries >= its score (rows before it: their
//     flat index is lower) or > its score (rows after it), each a binary
//     search over the lists staged in shared memory.  An entry whose rank
//     is below keep_topk writes that output row directly.
//
// The decode and IoU arithmetic repeat the reference op for op (the IoU
// threshold test as nms_common.cuh's `Threshold` states); the build passes
// -fmad=false so nothing is contracted into a fused multiply-add.

#include <cuda_runtime.h>

#include "nms_common.cuh"

namespace {

constexpr int kSelectThreads = 512;
constexpr int kSelectWarps = kSelectThreads / 32;
constexpr int kMergeThreads = 256;
constexpr int kProbeThreads = 256;
constexpr int kMergeWindow = 4096;  // scores of the kept lists staged at once
constexpr int kBlockSmem = 232448;  // shared memory one block may use
constexpr int kHistWords = 128;     // 256 bins of 16-bit counts, two a word

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// Region Y: the key row (P words), then the sorted candidates' boxes and
// scores.  Region X: the compacted (score, prior) pairs, the radix
// histogram, then the engine's alive bits and work area.
__host__ __device__ __forceinline__ size_t region_y_bytes(int P, int m) {
  const size_t keys = static_cast<size_t>(P) * sizeof(unsigned);
  const size_t sorted = static_cast<size_t>(m) * (sizeof(float4) +
                                                   sizeof(float));
  return align16(keys > sorted ? keys : sorted);
}

__host__ __device__ __forceinline__ size_t region_x_bytes(int m, int tile) {
  size_t x = static_cast<size_t>(m) * (sizeof(float) + sizeof(int));
  const size_t engine =
      nms::words(m) * sizeof(unsigned) + nms::work_bytes(m, tile);
  if (engine > x) x = engine;
  if (kHistWords * sizeof(unsigned) > x) x = kHistWords * sizeof(unsigned);
  return x;
}

// Order-preserving key of a valid score (never 0); -0 counts as +0, as
// the reference's float compares have it.
__device__ __forceinline__ unsigned score_key(float v) {
  if (v == 0.f) v = 0.f;
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_score(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ float4 decode(const float4 d, const float4 pr,
                                         const float4 v, int clip) {
  const float pw = pr.z - pr.x, ph = pr.w - pr.y;
  const float pcx = pr.x + pw * 0.5f, pcy = pr.y + ph * 0.5f;
  const float cx = v.x * d.x * pw + pcx;
  const float cy = v.y * d.y * ph + pcy;
  const float w = expf(v.z * d.z) * pw;
  const float h = expf(v.w * d.w) * ph;
  float4 o = make_float4(cx - w * 0.5f, cy - h * 0.5f, cx + w * 0.5f,
                         cy + h * 0.5f);
  if (clip) {
    o.x = nms::nan_min(nms::nan_max(o.x, 0.f), 1.f);
    o.y = nms::nan_min(nms::nan_max(o.y, 0.f), 1.f);
    o.z = nms::nan_min(nms::nan_max(o.z, 0.f), 1.f);
    o.w = nms::nan_min(nms::nan_max(o.w, 0.f), 1.f);
  }
  return o;
}

// Exclusive prefix sum of every thread's v in thread order; `total` gets
// the block's sum.  `sums` holds THREADS / 32 words.  Begins and ends
// with a barrier.
template <int THREADS>
__device__ __forceinline__ unsigned block_exclusive_scan(unsigned v,
                                                         unsigned* sums,
                                                         unsigned& total) {
  constexpr int kWarps = THREADS / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned y = __shfl_up_sync(nms::kFull, x, off);
    if (lane >= off) x += y;
  }
  __syncthreads();
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    unsigned s = lane < kWarps ? sums[lane] : 0u;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned y = __shfl_up_sync(nms::kFull, s, off);
      if (lane >= off) s += y;
    }
    if (lane < kWarps) sums[lane] = s;
  }
  __syncthreads();
  const unsigned before = (warp ? sums[warp - 1] : 0u) + x - v;
  total = sums[kWarps - 1];
  __syncthreads();
  return before;
}

// two blocks a SM (<= 64 registers): 160 rows of SSD300 at batch 8 on 132
// SMs put two on some
__global__ void __launch_bounds__(kSelectThreads, 2)
select_kernel(const float4* __restrict__ loc, const float* __restrict__ conf,
              const float4* __restrict__ priors,
              const float4* __restrict__ var, float* __restrict__ kscore,
              float4* __restrict__ kbox, int* __restrict__ kcount, int P,
              int C, int n_fg, int bg, float conf_thresh, float nms_thresh,
              int nms_topk, int clip, int tile, unsigned long long* stamps) {
  extern __shared__ float4 smem4[];
  const int m_cap = min(P, nms_topk);
  char* y_region = reinterpret_cast<char*>(smem4);
  char* x_region = y_region + region_y_bytes(P, m_cap);
  unsigned* keys = reinterpret_cast<unsigned*>(y_region);
  float4* sbox = reinterpret_cast<float4*>(y_region);
  float* sscore = reinterpret_cast<float*>(sbox + m_cap);
  float* cscore = reinterpret_cast<float*>(x_region);
  int* cprior = reinterpret_cast<int*>(cscore + m_cap);
  unsigned* hist = reinterpret_cast<unsigned*>(x_region);
  unsigned* alive = reinterpret_cast<unsigned*>(x_region);
  unsigned* work = alive + nms::words(m_cap);
  __shared__ unsigned sums[kSelectWarps];
  __shared__ int s_valid, s_kept, s_need, s_all;
  __shared__ unsigned s_digit;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x;  // image * n_fg + foreground row
  const int b = row / n_fg, f = row - b * n_fg;
  const int cls = f + ((bg >= 0 && f >= bg) ? 1 : 0);
  const float* cb = conf + static_cast<size_t>(b) * P * C + cls;

  // 1. the row's keys
  if (threadIdx.x == 0) { s_valid = 0; s_kept = 0; }
  __syncthreads();
  nms::stamp(stamps, 0);
  int count = 0;
#pragma unroll 4
  for (int p = threadIdx.x; p < P; p += kSelectThreads) {
    const float v = cb[static_cast<size_t>(p) * C];
    const bool ok = v > conf_thresh;
    keys[p] = ok ? score_key(v) : 0u;
    count += ok;
  }
  count = __reduce_add_sync(nms::kFull, count);
  if (lane == 0) atomicAdd(&s_valid, count);
  __syncthreads();
  nms::stamp(stamps, 1);
  const int n_valid = s_valid;
  const int m = min(n_valid, nms_topk);

  // 2. radix select of the nms_topk-th largest key: select every key
  //    whose top bits (kmask) are above thr_key's, and the first `need` (in
  //    prior order) whose top bits equal them.  The passes stop early once
  //    the boundary digit's whole bin is taken.
  unsigned thr_key = 0u, kmask = nms::kFull;
  int need = 0;
  if (n_valid > nms_topk) {
    unsigned prefix = 0u, pmask = 0u;
    int kk = nms_topk;
    for (int shift = 24; shift >= 0; shift -= 8) {
      for (int i = threadIdx.x; i < kHistWords; i += kSelectThreads)
        hist[i] = 0u;
      __syncthreads();
      for (int p0 = 0; p0 < P; p0 += kSelectThreads) {  // uniform trips
        const int p = p0 + threadIdx.x;
        const unsigned key = p < P ? keys[p] : 0u;
        const bool in = key != 0u && (key & pmask) == prefix;
        if (!__any_sync(nms::kFull, in)) continue;
        const unsigned d = in ? (key >> shift) & 255u : 256u;
        const unsigned peers = __match_any_sync(nms::kFull, d);
        if (in && lane == __ffs(peers) - 1)
          atomicAdd(&hist[d >> 1], static_cast<unsigned>(__popc(peers))
                                       << ((d & 1u) * 16));
      }
      __syncthreads();
      if (warp == 0) {  // lane l: digits 255-8l down to 248-8l
        unsigned c[8], sum = 0;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const unsigned d = 255u - 8u * lane - q;
          c[q] = (hist[d >> 1] >> ((d & 1u) * 16)) & 0xffffu;
          sum += c[q];
        }
        unsigned incl = sum;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const unsigned y = __shfl_up_sync(nms::kFull, incl, off);
          if (lane >= off) incl += y;
        }
        unsigned run = incl - sum;
        if (run < static_cast<unsigned>(kk) &&
            static_cast<unsigned>(kk) <= incl) {
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            if (run + c[q] >= static_cast<unsigned>(kk)) {
              s_digit = 255u - 8u * lane - q;
              s_need = kk - static_cast<int>(run);
              s_all = run + c[q] == static_cast<unsigned>(kk);
              break;
            }
            run += c[q];
          }
        }
      }
      __syncthreads();
      prefix |= s_digit << shift;
      pmask |= 255u << shift;
      kk = s_need;
      if (s_all) break;  // the bin is taken whole: no tie to resolve
    }
    thr_key = prefix;
    kmask = pmask;
    need = kk;
  }
  __syncthreads();
  nms::stamp(stamps, 2);

  // 3. compact the selected keys in prior order: a thread owns a
  //    contiguous chunk; one scan of (above, equal) counts packed in 16-bit
  //    halves (P < 65536: the shared-memory limit caps it)
  {
    const int chunk = (P + kSelectThreads - 1) / kSelectThreads;
    const int lo = min(P, threadIdx.x * chunk), hi = min(P, lo + chunk);
    unsigned gt = 0, eq = 0;
    for (int p = lo; p < hi; ++p) {
      const unsigned key = keys[p];
      gt += (key & kmask) > thr_key;
      eq += key != 0u && (key & kmask) == thr_key;
    }
    unsigned total;
    const unsigned before = block_exclusive_scan<kSelectThreads>(
        (gt << 16) | eq, sums, total);
    int gt_pre = static_cast<int>(before >> 16);
    int eq_pre = static_cast<int>(before & 0xffffu);
    for (int p = lo; p < hi; ++p) {
      const unsigned key = keys[p];
      int pos = -1;
      if ((key & kmask) > thr_key) {
        pos = gt_pre + min(eq_pre, need);
        ++gt_pre;
      } else if (key != 0u && (key & kmask) == thr_key) {
        if (eq_pre < need) pos = gt_pre + eq_pre;
        ++eq_pre;
      }
      if (pos >= 0) {
        cscore[pos] = key_score(key);
        cprior[pos] = p;
      }
    }
  }
  __syncthreads();
  nms::stamp(stamps, 3);

  // 4. each survivor's rank in (score desc, prior asc) order, its box
  //    decoded, both written at the rank (over the dead key row)
  const size_t img = static_cast<size_t>(b) * P;
  for (int c = threadIdx.x; c < m; c += kSelectThreads) {
    // rank = #{j: s_j > s} + #{j < c: s_j == s}; cscore is in prior
    // order, so below the warp's first c that is s_j >= s, past its last
    // s_j > s, and only the warp's own 32 need the tie rule
    const float s = cscore[c];
    const int lo = c - (threadIdx.x & 31), hi = min(m, lo + 32);
    const float4* c4 = reinterpret_cast<const float4*>(cscore);
    int rank = 0;
#pragma unroll 4
    for (int j4 = 0; j4 < lo / 4; ++j4) {  // every lane reads the same 16 B
      const float4 q = c4[j4];
      rank += (q.x >= s) + (q.y >= s) + (q.z >= s) + (q.w >= s);
    }
    for (int j = lo; j < hi; ++j) {
      const float sj = cscore[j];
      rank += (sj > s) || (sj == s && j < c);
    }
#pragma unroll 4
    for (int j4 = hi / 4; j4 < m / 4; ++j4) {
      const float4 q = c4[j4];
      rank += (q.x > s) + (q.y > s) + (q.z > s) + (q.w > s);
    }
    for (int j = max(hi, m & ~3); j < m; ++j) rank += cscore[j] > s;
    const int p = cprior[c];
    sbox[rank] = decode(loc[img + p], priors[p], var[p], clip);
    sscore[rank] = s;
  }
  __syncthreads();
  for (int w = threadIdx.x; w < static_cast<int>(nms::words(m));
       w += kSelectThreads) {
    const int left = m - 32 * w;
    alive[w] = left >= 32 ? nms::kFull : ((1u << left) - 1u);
  }

  // 5. greedy suppression (begins and ends with a barrier)
  __syncthreads();
  nms::stamp(stamps, 4);
  // (sbox may be read up to m rounded up to 32: sscore and region X follow)
  nms::suppress<kSelectThreads>(sbox, alive, work, m, tile, nms_thresh, 0.f,
                                stamps, 5);

  // 6. kept candidates with score > 0, in order (they lead the kept list)
  float* ks = kscore + static_cast<size_t>(row) * nms_topk;
  float4* kb = kbox + static_cast<size_t>(row) * nms_topk;
  for (int c = threadIdx.x; c < m; c += kSelectThreads) {
    if (!nms::bit(alive, c) || !(sscore[c] > 0.f)) continue;
    int pos = __popc(alive[c >> 5] & ((1u << (c & 31)) - 1u));
    for (int w = 0; w < (c >> 5); ++w) pos += __popc(alive[w]);
    ks[pos] = sscore[c];
    kb[pos] = sbox[c];
    atomicAdd(&s_kept, 1);
  }
  __syncthreads();
  nms::stamp(stamps, 8);
  if (threadIdx.x == 0) kcount[row] = s_kept;
}

__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const float* __restrict__ kscore,
             const float4* __restrict__ kbox, const int* __restrict__ kcount,
             float* __restrict__ out, int n_fg, int bg, int nms_topk,
             int keep_topk, int window, unsigned long long* stamps) {
  // where each list starts when the lists, capped at keep_topk (only
  // their first keep_topk entries can place, or count), are laid end to
  // end (n_fg + 1 offsets); then a window of their scores
  extern __shared__ int off[];
  float* win = reinterpret_cast<float*>(off + n_fg + 1);
  __shared__ unsigned sums[kMergeThreads / 32];
  __shared__ int s_total;
  const int r = blockIdx.x, b = blockIdx.y;
  const size_t rows = static_cast<size_t>(b) * n_fg;
  const float* ks = kscore + rows * nms_topk;
  float* ob = out + static_cast<size_t>(b) * keep_topk * 6;

  if (threadIdx.x == 0) s_total = 0;
  __syncthreads();
  nms::stamp(stamps, 9);
  unsigned carry = 0;
  int total = 0;
  for (int q0 = 0; q0 < n_fg; q0 += kMergeThreads) {  // uniform trips
    const int q = q0 + threadIdx.x;
    const int c = q < n_fg ? kcount[rows + q] : 0;
    total += c;
    unsigned sum;
    const unsigned before = block_exclusive_scan<kMergeThreads>(
        static_cast<unsigned>(min(c, keep_topk)), sums, sum);
    if (q < n_fg) off[q] = static_cast<int>(carry + before);
    carry += sum;
  }
  if (threadIdx.x == 0) off[n_fg] = static_cast<int>(carry);
  atomicAdd(&s_total, total);
  __syncthreads();
  nms::stamp(stamps, 10);
  const int flat = off[n_fg];

  const int r0 = off[r], len_r = off[r + 1] - r0;
  for (int h0 = 0; h0 < len_r; h0 += kMergeThreads) {
    const int h = h0 + threadIdx.x;
    const bool has = h < len_r;
    const float s = has ? ks[static_cast<size_t>(r) * nms_topk + h] : 0.f;
    int rank = h;
    for (int w0 = 0; w0 < flat; w0 += window) {
      const int w1 = min(flat, w0 + window);
      __syncthreads();
      // stage the window: a thread's entries rise by kMergeThreads at a
      // time, so the list holding the next one is found by walking on
      // from the last; the loads do not wait on each other
      for (int i = w0 + threadIdx.x, q = 0; i < w1; i += kMergeThreads) {
        while (off[q + 1] <= i) ++q;
        win[i - w0] = ks[static_cast<size_t>(q) * nms_topk + (i - off[q])];
      }
      __syncthreads();
      if (h0 == 0 && w0 == 0) nms::stamp(stamps, 11);
      if (has) {
        // in each other list, the entries ahead of this one: >= s in a
        // lower class row, > s in a higher one.  Binary searches of a
        // fixed number of halvings (the longest list's), four lists
        // interleaved, no branch on the data
        int top = 1;
        while (2 * top <= min(keep_topk, w1 - w0)) top *= 2;
        for (int q0 = 0; q0 < n_fg; q0 += 4) {
          int base[4], len[4], at[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int q = q0 + k;
            const bool use = q < n_fg && q != r;
            const int a = use ? max(off[q], w0) : w0;
            const int e = use ? min(off[q + 1], w1) : w0;
            base[k] = a - w0;
            len[k] = max(a, e) - a;
            at[k] = 0;
          }
          for (int step = top; step > 0; step >>= 1) {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int next = at[k] + step;
              if (next <= len[k]) {
                const float v = win[base[k] + next - 1];
                if (v > s || (v == s && q0 + k < r)) at[k] = next;
              }
            }
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) rank += at[k];
        }
      }
    }
    if (stamps != nullptr && h0 == 0) {
      __syncthreads();
      nms::stamp(stamps, 12);
    }
    if (has && rank < keep_topk) {
      const float4 bb = kbox[(rows + r) * nms_topk + h];
      float* o = ob + static_cast<size_t>(rank) * 6;
      o[0] = static_cast<float>(r + ((bg >= 0 && r >= bg) ? 1 : 0));
      o[1] = s;
      o[2] = bb.x;
      o[3] = bb.y;
      o[4] = bb.z;
      o[5] = bb.w;
    }
  }
  if (r == 0) {
    for (int t = min(s_total, keep_topk) * 6 + threadIdx.x;
         t < keep_topk * 6; t += kMergeThreads)
      ob[t] = (t % 6 == 0) ? -1.f : 0.f;
  }
  if (stamps != nullptr) {
    __syncthreads();
    nms::stamp(stamps, 13);
  }
}

// 3. the profile stages' probe: one block an image.  A thread sums its
//    priors' decoded x1 + y2 (and, with kcount, its share of the image's
//    kept scores) in double; the block reduces in a fixed tree.
__global__ void __launch_bounds__(kProbeThreads)
probe_kernel(const float4* __restrict__ loc,
             const float4* __restrict__ priors,
             const float4* __restrict__ var,
             const float* __restrict__ kscore,
             const int* __restrict__ kcount, float* __restrict__ out, int P,
             int n_fg, int nms_topk, int keep_topk, int clip) {
  __shared__ double part[2][kProbeThreads];
  const int b = blockIdx.x, t = threadIdx.x;
  const size_t img = static_cast<size_t>(b) * P;
  double boxes = 0.0, kept = 0.0;
  for (int p = t; p < P; p += kProbeThreads) {
    const float4 o = decode(loc[img + p], priors[p], var[p], clip);
    boxes += static_cast<double>(o.x);
    boxes += static_cast<double>(o.w);
  }
  if (kcount != nullptr) {
    const size_t rows = static_cast<size_t>(b) * n_fg;
    for (int i = t; i < n_fg * nms_topk; i += kProbeThreads) {
      const int f = i / nms_topk, j = i - f * nms_topk;
      if (j < kcount[rows + f])
        kept += static_cast<double>(kscore[(rows + f) * nms_topk + j]);
    }
  }
  part[0][t] = boxes;
  part[1][t] = kept;
  __syncthreads();
  for (int h = kProbeThreads / 2; h > 0; h >>= 1) {
    if (t < h) {
      part[0][t] += part[0][t + h];
      part[1][t] += part[1][t + h];
    }
    __syncthreads();
  }
  const float probe = static_cast<float>(part[0][0] + part[1][0]);
  float* ob = out + static_cast<size_t>(b) * keep_topk * 6;
  for (int i = t; i < keep_topk * 6; i += kProbeThreads) ob[i] = probe;
}

}  // namespace

extern "C" {

const char* az_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory of one select block for P priors, nms_topk and
// the engine's tile (ops/pallas_detout.py::select_smem_bytes is the same
// formula).
size_t az_detection_output_smem(int P, int nms_topk, int tile) {
  const int m = P < nms_topk ? P : nms_topk;
  return region_y_bytes(P, m) + region_x_bytes(m, tile);
}

// Launch K2 on `stream`: `stage` 2 ("full") select, then merge; 1
// ("select") select, then the probe over the kept lists; 0 ("decode") the
// probe alone.  Every buffer is allocated by the caller: kscore
// (B,n_fg,nms_topk), kbox (B,n_fg,nms_topk,4), kcount (B,n_fg) (null for
// stage 0), out (B,keep_topk,6).  `stamps` (null, or
// nms::kStampSlots words) takes block 0's phase stamps: the select's
// start, keys, radix select, compaction, ranks and boxes, the engine's
// three (nms_common.cuh), kept lists written (slots 0-8); the merge's
// start, offsets, window staged, ranks, rows written (slots 9-13).
// Returns the cudaError_t of the launches (0 = launched).
int az_detection_output(const float* loc, const float* conf,
                        const float* priors, const float* var, float* kscore,
                        float* kbox, int* kcount, float* out, int B, int P,
                        int C, int n_fg, int bg, float conf_thresh,
                        float nms_thresh, int nms_topk, int keep_topk,
                        int clip, int tile, int stage,
                        unsigned long long* stamps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* loc4 = reinterpret_cast<const float4*>(loc);
  const float4* pr4 = reinterpret_cast<const float4*>(priors);
  const float4* var4 = reinterpret_cast<const float4*>(var);
  if (stage == 0) {
    probe_kernel<<<B, kProbeThreads, 0, st>>>(loc4, pr4, var4, nullptr,
                                              nullptr, out, P, n_fg,
                                              nms_topk, keep_topk, clip);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = az_detection_output_smem(P, nms_topk, tile);
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(select_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  select_kernel<<<B * n_fg, kSelectThreads, smem, st>>>(
      loc4, conf, pr4, var4, kscore, reinterpret_cast<float4*>(kbox), kcount,
      P, C, n_fg, bg, conf_thresh, nms_thresh, nms_topk, clip, tile, stamps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (stage == 1) {
    probe_kernel<<<B, kProbeThreads, 0, st>>>(loc4, pr4, var4, kscore,
                                              kcount, out, P, n_fg,
                                              nms_topk, keep_topk, clip);
    return static_cast<int>(cudaGetLastError());
  }

  // the window shrinks only where n_fg + 1 offsets leave less room
  const int room = (kBlockSmem - 64) / 4 - (n_fg + 1);
  const int window = room < kMergeWindow ? (room > 1 ? room : 1)
                                         : kMergeWindow;
  const size_t merge_smem = (static_cast<size_t>(n_fg) + 1 + window) * 4;
  if (merge_smem > 48 * 1024) {
    e = cudaFuncSetAttribute(merge_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(merge_smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  merge_kernel<<<dim3(n_fg, B), kMergeThreads, merge_smem, st>>>(
      kscore, reinterpret_cast<const float4*>(kbox), kcount, out, n_fg, bg,
      nms_topk, keep_topk, window, stamps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
