// Kernel K2: the whole SSD DetectionOutput — decode, per-class confidence
// filter + top-nms_topk selection + greedy suppression, global keep_topk
// merge — for a batch.
//
// Replaces: analytics_zoo_tpu/ops/pallas_detout.py, fused_detection_output
// (pallas_call at :285, body _fused_kernel at :91), stage="full".  Output
// rows (class_id, score, x1, y1, x2, y2), empty rows (-1, 0, 0, 0, 0, 0).
//
// What bounds it on the H100: the dependency chain, not bytes.  It reads
// loc, conf, priors and variances once (7.3 MB for SSD300 at batch 8) and
// writes 38 KB, about 2 us of HBM time; but each (image, class) row pops
// up to nms_topk = 400 candidates one after another, each pop a block-wide
// argmax, and the greedy suppression is a chain of dependent steps too.
//
// The TPU program kept decoded boxes and a (C_fg, P) keep plane resident
// in VMEM across a sequential class grid (~1.8 MiB at SSD300, ~5 MiB at
// SSD512).  That fits no Hopper block (<= 227 KB of shared memory), and
// Hopper blocks run in parallel with nothing carried between them, so the
// work is split into three launches on one stream:
//
//  1. decode: one thread per (image, prior) writes corner boxes (B,P,4) to
//     device memory (they stay in the 50 MB L2 for the next launch);
//  2. select: one block per (image, foreground class).  The class's score
//     row is staged in shared memory (P floats; invalid and popped lanes
//     hold -inf): 34 KB at P = 8732, 96 KB at P = 24564.  Each thread owns
//     the lanes t, t+T, …, and keeps its own best (score, prior); a pop is
//     one block reduction over those bests (ties to the lowest prior),
//     after which only the popped lane's owner rescans its lanes.  The pop
//     order does not depend on suppression, so the block first pops the
//     row's min(#valid, nms_topk) candidates into a shared list with their
//     boxes (25 bytes each), then sweeps that list greedily as K1 does:
//     the suppression only ever reads the <= nms_topk candidates, in shared
//     memory, never the row's other priors.  Kept candidates go, in pop
//     order, to the row's slice of a (B, C_fg, nms_topk) scratch;
//  3. merge: one block per image pops keep_topk times over the C_fg kept
//     lists.  Each list is already in (score desc, prior asc) order, so a
//     pop is a reduction over the list heads, ties to the lowest class row
//     — the reference's lowest flat (row, prior) index.
//
// The decode and IoU arithmetic repeat the reference op for op; the build
// passes -fmad=false so nothing is contracted into a fused multiply-add.

#include <cuda_runtime.h>
#include <climits>
#include <cmath>

namespace {

constexpr int kDecodeThreads = 256;
constexpr int kSelectThreads = 512;
constexpr int kMergeThreads = 128;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// Block-wide (max value, lowest index) over every thread's (v, i).  All
// threads get the result.  Contains two barriers.
template <int THREADS>
__device__ __forceinline__ void block_argmax(float v, int i, float* wv,
                                             int* wi, float& out_v,
                                             int& out_i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) { wv[warp] = v; wi[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    constexpr int kWarps = THREADS / 32;
    v = lane < kWarps ? wv[lane] : -INFINITY;
    i = lane < kWarps ? wi[lane] : INT_MAX;
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, v, off);
      const int oi = __shfl_down_sync(0xffffffffu, i, off);
      if (better(ov, oi, v, i)) { v = ov; i = oi; }
    }
    if (lane == 0) { wv[32] = v; wi[32] = i; }
  }
  __syncthreads();
  out_v = wv[32];
  out_i = wi[32];
}

__global__ void __launch_bounds__(kDecodeThreads)
decode_kernel(const float4* __restrict__ loc, const float4* __restrict__ priors,
              const float4* __restrict__ var, float4* __restrict__ boxes,
              int B, int P, int clip) {
  const int t = blockIdx.x * kDecodeThreads + threadIdx.x;
  if (t >= B * P) return;
  const int p = t % P;
  const float4 d = loc[t], pr = priors[p], v = var[p];
  const float pw = pr.z - pr.x, ph = pr.w - pr.y;
  const float pcx = pr.x + pw * 0.5f, pcy = pr.y + ph * 0.5f;
  const float cx = v.x * d.x * pw + pcx;
  const float cy = v.y * d.y * ph + pcy;
  const float w = expf(v.z * d.z) * pw;
  const float h = expf(v.w * d.w) * ph;
  float4 o = make_float4(cx - w * 0.5f, cy - h * 0.5f, cx + w * 0.5f,
                         cy + h * 0.5f);
  if (clip) {
    o.x = fminf(fmaxf(o.x, 0.f), 1.f);
    o.y = fminf(fmaxf(o.y, 0.f), 1.f);
    o.z = fminf(fmaxf(o.z, 0.f), 1.f);
    o.w = fminf(fmaxf(o.w, 0.f), 1.f);
  }
  boxes[t] = o;
}

__global__ void __launch_bounds__(kSelectThreads)
select_kernel(const float* __restrict__ conf, const float4* __restrict__ boxes,
              float* __restrict__ kscore, int* __restrict__ kidx,
              int* __restrict__ kcount, int P, int C, int n_fg, int bg,
              float conf_thresh, float nms_thresh, int nms_topk) {
  // shared: P scores | nms_topk candidate boxes, scores, priors, flags
  extern __shared__ float4 smem4[];
  float4* cbox = smem4;
  float* cscore = reinterpret_cast<float*>(cbox + nms_topk);
  int* cidx = reinterpret_cast<int*>(cscore + nms_topk);
  float* s = reinterpret_cast<float*>(cidx + nms_topk);
  unsigned char* cact = reinterpret_cast<unsigned char*>(s + P);
  __shared__ float wv[33];
  __shared__ int wi[33];
  __shared__ int n_valid;

  const int row = blockIdx.x;  // image * n_fg + foreground row
  const int b = row / n_fg, f = row - b * n_fg;
  const int cls = f + ((bg >= 0 && f >= bg) ? 1 : 0);
  const float* cb = conf + static_cast<size_t>(b) * P * C + cls;
  const float4* bx = boxes + static_cast<size_t>(b) * P;

  if (threadIdx.x == 0) n_valid = 0;
  __syncthreads();
  float best_v = -INFINITY;
  int best_i = INT_MAX, count = 0;
  for (int p = threadIdx.x; p < P; p += kSelectThreads) {
    const float v = cb[static_cast<size_t>(p) * C];
    const bool ok = v > conf_thresh;
    s[p] = ok ? v : -INFINITY;
    count += ok;
    if (ok && better(v, p, best_v, best_i)) { best_v = v; best_i = p; }
  }
  atomicAdd(&n_valid, count);
  __syncthreads();

  // 1. pop the candidates: the pop index is the sorted rank, so stopping
  //    after nms_topk pops is the reference's topk pre-filter
  const int bound = min(n_valid, nms_topk);
  for (int it = 0; it < bound; ++it) {
    float m;
    int p;
    block_argmax<kSelectThreads>(best_v, best_i, wv, wi, m, p);
    if (threadIdx.x == 0) { cscore[it] = m; cidx[it] = p; }
    // lane p belongs to thread p % T alone: it pops it and rescans
    if (threadIdx.x == p % kSelectThreads) {
      s[p] = -INFINITY;
      best_v = -INFINITY;
      best_i = INT_MAX;
      for (int q = threadIdx.x; q < P; q += kSelectThreads)
        if (better(s[q], q, best_v, best_i)) { best_v = s[q]; best_i = q; }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < bound; j += kSelectThreads) {
    cbox[j] = bx[cidx[j]];
    cact[j] = 1;
  }
  __syncthreads();

  // 2. greedy suppression over the popped list, in pop order
  float* ks = kscore + static_cast<size_t>(row) * nms_topk;
  int* ki = kidx + static_cast<size_t>(row) * nms_topk;
  int kept = 0;
  for (int i = 0; i < bound; ++i) {
    if (cact[i]) {  // same flag for every thread: set before the last barrier
      const float m = cscore[i];
      if (m > 0.f) {  // the merge only ranks positive keep scores
        if (threadIdx.x == 0) { ks[kept] = m; ki[kept] = cidx[i]; }
        ++kept;
      }
      const float4 bp = cbox[i];
      const float area_p = (bp.z - bp.x) * (bp.w - bp.y);
      for (int q = i + 1 + threadIdx.x; q < bound; q += kSelectThreads) {
        if (!cact[q]) continue;
        const float4 bq = cbox[q];
        const float ix1 = fmaxf(bq.x, bp.x), iy1 = fmaxf(bq.y, bp.y);
        const float ix2 = fminf(bq.z, bp.z), iy2 = fminf(bq.w, bp.w);
        const float inter = fmaxf(ix2 - ix1, 0.f) * fmaxf(iy2 - iy1, 0.f);
        const float area = (bq.z - bq.x) * (bq.w - bq.y);
        const float uni = fmaxf(area + area_p - inter, 1e-12f);
        if (inter / uni >= nms_thresh) cact[q] = 0;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) kcount[row] = kept;
}

__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const float4* __restrict__ boxes, const float* __restrict__ kscore,
             const int* __restrict__ kidx, const int* __restrict__ kcount,
             float* __restrict__ out, int P, int n_fg, int bg, int nms_topk,
             int keep_topk) {
  extern __shared__ int head[];  // next unread entry of each row's list
  __shared__ float wv[33];
  __shared__ int wi[33];
  __shared__ int n_total;

  const int b = blockIdx.x;
  const float* ks = kscore + static_cast<size_t>(b) * n_fg * nms_topk;
  const int* ki = kidx + static_cast<size_t>(b) * n_fg * nms_topk;
  const int* kc = kcount + b * n_fg;
  const float4* bx = boxes + static_cast<size_t>(b) * P;
  float* ob = out + static_cast<size_t>(b) * keep_topk * 6;

  if (threadIdx.x == 0) n_total = 0;
  __syncthreads();
  float best_v = -INFINITY;
  int best_r = INT_MAX, count = 0;
  for (int r = threadIdx.x; r < n_fg; r += kMergeThreads) {
    head[r] = 0;
    count += kc[r];
    if (kc[r] > 0 && better(ks[static_cast<size_t>(r) * nms_topk], r, best_v,
                            best_r)) {
      best_v = ks[static_cast<size_t>(r) * nms_topk];
      best_r = r;
    }
  }
  atomicAdd(&n_total, count);
  __syncthreads();

  const int npop = min(n_total, keep_topk);
  for (int j = 0; j < npop; ++j) {
    float m;
    int r;
    block_argmax<kMergeThreads>(best_v, best_r, wv, wi, m, r);
    if (threadIdx.x == r % kMergeThreads) {  // the row's owner advances it
      const int h = head[r];
      const float4 bb = bx[ki[static_cast<size_t>(r) * nms_topk + h]];
      float* o = ob + static_cast<size_t>(j) * 6;
      o[0] = static_cast<float>(r + ((bg >= 0 && r >= bg) ? 1 : 0));
      o[1] = m;
      o[2] = bb.x;
      o[3] = bb.y;
      o[4] = bb.z;
      o[5] = bb.w;
      head[r] = h + 1;
      best_v = -INFINITY;
      best_r = INT_MAX;
      for (int q = threadIdx.x; q < n_fg; q += kMergeThreads) {
        if (head[q] < kc[q]) {
          const float v = ks[static_cast<size_t>(q) * nms_topk + head[q]];
          if (better(v, q, best_v, best_r)) { best_v = v; best_r = q; }
        }
      }
    }
  }
  for (int t = npop * 6 + threadIdx.x; t < keep_topk * 6; t += kMergeThreads)
    ob[t] = (t % 6 == 0) ? -1.f : 0.f;
}

}  // namespace

extern "C" {

const char* az_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Shared memory the select launch needs for P priors.
size_t az_detection_output_smem(int P, int nms_topk) {
  return static_cast<size_t>(nms_topk) * (sizeof(float4) + sizeof(float) +
                                          sizeof(int)) +
         static_cast<size_t>(P) * sizeof(float) + nms_topk;
}

// Launch K2 (three kernels) on `stream`.  Every buffer is allocated by the
// caller: boxes (B,P,4), kscore (B,n_fg,nms_topk), kidx (B,n_fg,nms_topk),
// kcount (B,n_fg), out (B,keep_topk,6).  Returns the cudaError_t of the
// launches (0 = launched).
int az_detection_output(const float* loc, const float* conf,
                        const float* priors, const float* var, float* boxes,
                        float* kscore, int* kidx, int* kcount, float* out,
                        int B, int P, int C, int n_fg, int bg,
                        float conf_thresh, float nms_thresh, int nms_topk,
                        int keep_topk, int clip, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = B * P;
  decode_kernel<<<(n + kDecodeThreads - 1) / kDecodeThreads, kDecodeThreads,
                  0, st>>>(reinterpret_cast<const float4*>(loc),
                           reinterpret_cast<const float4*>(priors),
                           reinterpret_cast<const float4*>(var),
                           reinterpret_cast<float4*>(boxes), B, P, clip);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  const size_t smem = az_detection_output_smem(P, nms_topk);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(select_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  select_kernel<<<B * n_fg, kSelectThreads, smem, st>>>(
      conf, reinterpret_cast<const float4*>(boxes), kscore, kidx, kcount, P,
      C, n_fg, bg, conf_thresh, nms_thresh, nms_topk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  merge_kernel<<<B, kMergeThreads, n_fg * sizeof(int), st>>>(
      reinterpret_cast<const float4*>(boxes), kscore, kidx, kcount, out, P,
      n_fg, bg, nms_topk, keep_topk);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
