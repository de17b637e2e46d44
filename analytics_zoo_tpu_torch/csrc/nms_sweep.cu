// Kernel K1: greedy NMS suppression sweep over score-sorted candidates.
//
// Replaces: analytics_zoo_tpu/ops/pallas_nms.py, nms_sweep (pallas_call at
// :101, body _nms_kernel at :33).  Same contract: (C, K) planes x1/y1/x2/y2
// and a validity mask in, the (C, K) float keep mask out.  Row by row: sweep
// i = 0 .. last valid lane; a candidate still active is kept and deactivates
// every later candidate whose IoU with it is >= the threshold.
//
// What bounds it on the H100: neither bytes nor arithmetic.  A row moves
// 6·K·4 bytes and does at most K²/2 IoU evaluations, but the sweep is a
// chain of up to K dependent steps, each ending in a block barrier.  The
// TPU kernel ran one row per sequential grid step with masked full-row
// vector ops (VMEM has no scalar stores); here every row is its own block
// and the rows run side by side on the 132 SMs.
//
// Design: one block per row.  The row's four coordinate planes and its
// active flags live in shared memory (17 bytes a candidate, 8.5 KiB at the
// SSD shape K = 512), so the sweep never touches device memory after the
// first load.  The last valid lane is reduced once; step i reads one flag
// (the same for every thread), and only if it is set do the threads
// deactivate lanes j in (i, n_valid) — lanes at or before i are never read
// again, lanes past the last valid one are never kept.  The IoU repeats the
// reference's float operations one for one (+off on widths and heights, a
// union floor of 1e-12, then inter/union); the build passes -fmad=false so
// nothing is contracted into a fused multiply-add.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
nms_sweep_kernel(const float* __restrict__ x1, const float* __restrict__ y1,
                 const float* __restrict__ x2, const float* __restrict__ y2,
                 const float* __restrict__ valid, float* __restrict__ keep,
                 int K, float thr, float off) {
  extern __shared__ float smem[];
  float* sx1 = smem;
  float* sy1 = smem + K;
  float* sx2 = smem + 2 * K;
  float* sy2 = smem + 3 * K;
  unsigned char* act = reinterpret_cast<unsigned char*>(smem + 4 * K);
  __shared__ int n_valid;

  const size_t base = static_cast<size_t>(blockIdx.x) * K;
  if (threadIdx.x == 0) n_valid = 0;
  __syncthreads();

  int last = 0;
  for (int j = threadIdx.x; j < K; j += kThreads) {
    sx1[j] = x1[base + j];
    sy1[j] = y1[base + j];
    sx2[j] = x2[base + j];
    sy2[j] = y2[base + j];
    const bool v = valid[base + j] > 0.f;
    act[j] = v;
    keep[base + j] = 0.f;
    if (v) last = j + 1;
  }
  atomicMax(&n_valid, last);
  __syncthreads();

  const int n = n_valid;
  for (int i = 0; i < n; ++i) {
    if (act[i]) {  // same flag for every thread: set before the last barrier
      const float bx1 = sx1[i], by1 = sy1[i], bx2 = sx2[i], by2 = sy2[i];
      const float area_i = (bx2 - bx1 + off) * (by2 - by1 + off);
      for (int j = i + 1 + threadIdx.x; j < n; j += kThreads) {
        if (!act[j]) continue;
        const float ix1 = fmaxf(sx1[j], bx1);
        const float iy1 = fmaxf(sy1[j], by1);
        const float ix2 = fminf(sx2[j], bx2);
        const float iy2 = fminf(sy2[j], by2);
        const float inter =
            fmaxf(ix2 - ix1 + off, 0.f) * fmaxf(iy2 - iy1 + off, 0.f);
        const float area = (sx2[j] - sx1[j] + off) * (sy2[j] - sy1[j] + off);
        const float uni = fmaxf(area + area_i - inter, 1e-12f);
        if (inter / uni >= thr) act[j] = 0;
      }
      if (threadIdx.x == 0) keep[base + i] = 1.f;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

const char* az_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launch K1 on `stream` over C rows of K candidates.  Returns the
// cudaError_t of the launch (0 = launched).
int az_nms_sweep(const float* x1, const float* y1, const float* x2,
                 const float* y2, const float* valid, float* keep, int C,
                 int K, float thr, float off, void* stream) {
  const size_t smem = static_cast<size_t>(K) * (4 * sizeof(float) + 1);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        nms_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  nms_sweep_kernel<<<C, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x1, y1, x2, y2, valid, keep, K, thr, off);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
