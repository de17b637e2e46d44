// Helpers shared by the persistent-RNN kernels K3 (persistent_rnn.cu) and
// K4 (persistent_rnn_bwd.cu): the grid-wide barrier of their cooperative
// launches, the weight-type conversions and the sigmoid.  Each .cu file
// compiles on its own; utils/cuda_build.py hashes this header into both
// libraries' names, so an edit here rebuilds both.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// a barrier that waits this long means a block never arrived: abort the
// kernel (a CUDA error) instead of hanging the device
constexpr unsigned long long kBarrierTimeoutNs = 10ull * 1000 * 1000 * 1000;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// h as the product sees it: rounded to the weight type
template <typename T> __device__ __forceinline__ float as_weight_type(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Grid-wide barrier: every block of the cooperative launch is resident, so
// spinning cannot starve a block that has not arrived.  The generation is
// read BEFORE arriving, so the last arrival cannot bump it unseen.
__device__ void grid_barrier(unsigned int* bar, unsigned int nblocks) {
  __threadfence();  // this thread's stores, before the arrival
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == nblocks - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      const unsigned long long t0 = global_ns();
      while (*gen == g) {
        if (global_ns() - t0 > kBarrierTimeoutNs) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

}  // namespace
