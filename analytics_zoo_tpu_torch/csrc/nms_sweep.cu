// Kernel K1: greedy NMS suppression sweep over score-sorted candidates.
//
// Replaces: analytics_zoo_tpu/ops/pallas_nms.py, nms_sweep (pallas_call at
// :101, body _nms_kernel at :33).  Same contract: (C, K) planes x1/y1/x2/y2
// and a validity mask in, the (C, K) float keep mask out.  Row by row: sweep
// i = 0 .. last valid lane; a candidate still active is kept and deactivates
// every later candidate whose IoU with it is >= the threshold.
//
// What bounds it on the H100: neither bytes nor arithmetic.  A row moves
// 6·K·4 bytes and needs at most K²/2 IoU tests, but the greedy sweep is a
// chain of dependent decisions.  The TPU kernel ran one row per sequential
// grid step with masked full-row vector ops (VMEM has no scalar stores);
// here every row is its own block and the rows run side by side on the
// 132 SMs.
//
// Design: one block per row.  The row's boxes (as float4) and its validity
// bits live in shared memory, the last valid lane is reduced once, and the
// suppression engine of nms_common.cuh runs over lanes [0, last valid]:
// every IoU test of a tile in one parallel pass into a bit matrix, then
// one warp walks it with no block barrier.  An invalid lane is never kept
// and suppresses nothing; lanes past the last valid one are never kept.
// `keep` is written once per lane at the end.

#include <cuda_runtime.h>

#include "nms_common.cuh"

namespace {

constexpr int kThreads = 512;

// Boxes staged: K rounded up to 32, as the engine may read a whole word.
__host__ __device__ __forceinline__ size_t padded(int K) {
  return nms::words(K) * 32;
}

// two blocks a SM (<= 64 registers): 160 rows of SSD300 at batch 8 on 132
// SMs put two on some
__global__ void __launch_bounds__(kThreads, 2)
nms_sweep_kernel(const float* __restrict__ x1, const float* __restrict__ y1,
                 const float* __restrict__ x2, const float* __restrict__ y2,
                 const float* __restrict__ valid, float* __restrict__ keep,
                 int K, float thr, float off, int tile,
                 unsigned long long* stamps) {
  // shared: K boxes (padded to 32) | ceil(K/32) alive words | the
  // engine's work area
  extern __shared__ float4 smem4[];
  float4* box = smem4;
  unsigned* alive = reinterpret_cast<unsigned*>(box + padded(K));
  unsigned* work = alive + nms::words(K);
  __shared__ int n_valid;

  const size_t base = static_cast<size_t>(blockIdx.x) * K;
  if (threadIdx.x == 0) n_valid = 0;
  __syncthreads();
  nms::stamp(stamps, 0);

  int last = 0;
  for (int j0 = 0; j0 < K; j0 += kThreads) {   // uniform trip count
    const int j = j0 + threadIdx.x;
    bool v = false;
    if (j < K) {
      box[j] = make_float4(x1[base + j], y1[base + j], x2[base + j],
                           y2[base + j]);
      v = valid[base + j] > 0.f;
      if (v) last = j + 1;
    }
    const unsigned b = __ballot_sync(nms::kFull, v);
    if ((threadIdx.x & 31) == 0 && j < K) alive[j >> 5] = b;
  }
  atomicMax(&n_valid, last);
  __syncthreads();
  nms::stamp(stamps, 1);

  nms::suppress<kThreads>(box, alive, work, n_valid, tile, thr, off, stamps,
                          2);

  for (int j = threadIdx.x; j < K; j += kThreads)
    keep[base + j] = nms::bit(alive, j) ? 1.f : 0.f;
  __syncthreads();
  nms::stamp(stamps, 5);
}

}  // namespace

extern "C" {

const char* az_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory of one block for rows of K candidates in tiles of
// `tile` (ops/pallas_nms.py::sweep_smem_bytes is the same formula).
size_t az_nms_sweep_smem(int K, int tile) {
  return padded(K) * sizeof(float4) + nms::words(K) * sizeof(unsigned) +
         nms::work_bytes(K, tile);
}

// Launch K1 on `stream` over C rows of K candidates.  `stamps` (null, or
// nms::kStampSlots words) takes block 0's phase stamps: start, rows
// loaded, then the engine's three (nms_common.cuh), keep written.
// Returns the cudaError_t of the launch (0 = launched).
int az_nms_sweep(const float* x1, const float* y1, const float* x2,
                 const float* y2, const float* valid, float* keep, int C,
                 int K, float thr, float off, int tile,
                 unsigned long long* stamps, void* stream) {
  const size_t smem = az_nms_sweep_smem(K, tile);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        nms_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  nms_sweep_kernel<<<C, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x1, y1, x2, y2, valid, keep, K, thr, off, tile, stamps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
