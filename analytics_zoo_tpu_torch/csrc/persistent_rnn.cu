// Kernel K3: persistent RNN forward (one direction, whole sequence).
//
// Replaces: analytics_zoo_tpu/ops/pallas_rnn.py, _run_kernel (pallas_call at
// :309, body _rnn_kernel at :208).  Same contract: the hoisted input
// projections pre [B,T,k*H] (gate-stacked r,z,n or i,f,g,o), the h2h kernel
// w [H,k*H] (fp32 or bf16), its bias b [k*H], the initial carry h0 [C,B,H]
// and the valid lengths n [B] in; ys [B,T,H] and the final carry [C,B,H]
// out.  Each step computes hh = h.w + b in fp32 (h rounded to w's type
// first, as the TPU kernel's h.astype(w.dtype)), then the vanilla / GRU /
// LSTM gate math; a row with t >= n freezes its carry and emits 0.  Given a
// residual buffer (the forward of a training step), it also writes the fp32
// carry at the start of every U-th step, cs [ceil(T/U), C, B, H] (the TPU
// kernel's save_residuals output, :230-231 and :303-308): the backward K4
// recomputes each block of U steps from it.
//
// What bounds it on the H100: the operations, 2*B*H*k*H per valid step
// (74 GFLOP for one DS2 direction at B=8, T=1500, H=1760: ~1.1 ms at 67
// TFLOP/s of fp32), far above its bytes (pre, ys and w once: ~0.05 ms).
// But the steps form a chain of T dependent products, and this first
// design pays a grid-wide barrier and a reload of h on every step, so it
// runs well above that bound.
//
// Design: the TPU kernel walks a sequential time grid on one core with W
// resident in VMEM.  Hopper blocks run in parallel and carry nothing from
// one to the next, so here ONE cooperative launch keeps G <= #SM blocks
// resident for the whole T loop.  Block g owns hidden columns
// [g*cols, (g+1)*cols) of every gate: it computes hh[:, gate*H + j] for all
// batch rows, so the cell math (GRU's r*h_n, LSTM's c) stays inside the
// block.  Its slice of W is copied into shared memory once when it fits
// (DS2: 1760 x 14 fp32 = 96 KiB), else read from global memory (L2) every
// step.  The new h columns go to a ping-pong buffer in global memory; one
// grid barrier per step (an arrival counter and a generation word, the
// launch guaranteeing co-residency) publishes them, and every block then
// reads all of h (transposed into shared memory, 8 rows at a time) for the
// next product.  The K sum is split over the block's threads and reduced
// in a fixed order, so a run is deterministic.  The next step's pre values
// are fetched with cp.async while the product runs.  Steps past every
// row's length are skipped: their outputs are zeros and the carry is
// frozen.  The dot products use explicit fmaf (the build's -fmad=false
// only stops the compiler from contracting on its own).

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rnn_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;  // batch rows per pass: the register tile
// float4 loads of h a thread keeps in flight before its stores (16, one
// L2 round trip for DS2's 14 a thread, measured slower: PERF.md)
constexpr int kLoads = 4;
enum Cell { kVanilla = 0, kGru = 1, kLstm = 2 };
enum Act { kRelu = 0, kClippedRelu = 1, kTanh = 2 };

struct Args {
  const float* pre;
  const void* w;
  const float* b;
  const float* h0;
  const int* n;
  float* ys;
  float* cf;
  float* hbuf;          // [2, B, ldh] ping-pong carry h
  unsigned int* bar;    // [2] arrivals, generation (zeroed by the caller)
  float* cs;            // [ceil(T/U), C, B, H] block-start carries, or null
  int B, T, H, k, C, cell, act;
  int U;                // steps between two saved carries
  int ldh;              // row stride of hbuf: H rounded up to 4 (float4 rows)
  int cols;             // hidden columns a block owns (the last may own fewer)
  int nc;               // k * cols: product columns of a block
  int slices;           // K-split of the product over the block's threads
  int w_smem;           // 1: the block's W slice lives in shared memory
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
persistent_rnn_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H = a.H, kH = a.k * a.H, cols = a.cols, nc = a.nc;
  float* hT = reinterpret_cast<float*>(smem_raw);            // [H][kRows]
  float* red = hT + static_cast<size_t>(H) * kRows;           // [S][kRows][nc]
  float* preS = red + static_cast<size_t>(a.slices) * kRows * nc;  // [2][kRows][nc]
  T* wS = reinterpret_cast<T*>(preS + 2 * kRows * nc);        // [H][nc]
  __shared__ int s_tmax;

  const int tid = threadIdx.x;
  const unsigned int nblocks = gridDim.x;
  const int j0 = blockIdx.x * cols;
  const int ncols = min(cols, H - j0);  // >= 1: the grid has no empty block
  const T* w = static_cast<const T*>(a.w);

  // this thread's product column c (gate g, local column jj) and K slice s
  const int c = tid % nc, s = tid / nc;
  const int g = c / cols, jj = c % cols;
  const bool mm = s < a.slices && jj < ncols;
  const int klen = (H + a.slices - 1) / a.slices;
  const int i0 = s * klen, i1 = min(H, i0 + klen);

  const T* wp;
  size_t ldw;
  if (a.w_smem) {
    for (int idx = tid; idx < H * nc; idx += kThreads) {
      const int i = idx / nc, cc = idx % nc;
      const int gg = cc / cols, jl = cc % cols;
      wS[idx] = jl < ncols ? w[static_cast<size_t>(i) * kH + gg * H + j0 + jl]
                           : from_f<T>(0.f);
    }
    wp = wS + c;
    ldw = nc;
  } else {
    wp = w + (g * H + j0 + jj);  // dereferenced only when mm
    ldw = kH;
  }

  if (tid == 0) {
    int m = 0;
    for (int r = 0; r < a.B; ++r) m = max(m, a.n[r]);  // n clamped to [0, T]
    s_tmax = m;
  }
  // the carry's own columns: h into the ping-pong buffer, LSTM's c into
  // the output carry slot 0, where it lives for the whole run
  for (int idx = tid; idx < a.B * ncols; idx += kThreads) {
    const int r = idx / ncols, j = j0 + idx % ncols;
    a.hbuf[static_cast<size_t>(r) * a.ldh + j] =
        a.h0[(static_cast<size_t>(a.C - 1) * a.B + r) * H + j];
    if (a.cell == kLstm)
      a.cf[static_cast<size_t>(r) * H + j] =
          a.h0[static_cast<size_t>(r) * H + j];
  }
  grid_barrier(a.bar, nblocks);
  const int tmax = s_tmax;
  const size_t plane = static_cast<size_t>(a.B) * a.ldh;
  const int row4 = a.ldh / 4;  // float4 a row of hbuf
  const int n4 = kRows * row4;
  const int passes = (a.B + kRows - 1) / kRows;

  // cp.async of the pre values one pass needs: [kRows][k][ncols] of step t
  auto fetch_pre = [&](int t, int r0, float* dst) {
    const int rows = min(kRows, a.B - r0);
    for (int idx = tid; idx < rows * a.k * ncols; idx += kThreads) {
      const int rr = idx / (a.k * ncols), rem = idx % (a.k * ncols);
      const int gg = rem / ncols, jl = rem % ncols;
      __pipeline_memcpy_async(
          dst + rr * nc + gg * cols + jl,
          a.pre + (static_cast<size_t>(r0 + rr) * a.T + t) * kH + gg * H + j0 +
              jl,
          sizeof(float));
    }
    __pipeline_commit();
  };

  int buf = 0;
  if (tmax > 0) fetch_pre(0, 0, preS);
  for (int t = 0; t < tmax; ++t) {
    const float* hcur = a.hbuf + static_cast<size_t>(t & 1) * plane;
    float* hnxt = a.hbuf + static_cast<size_t>((t + 1) & 1) * plane;
    for (int p = 0; p < passes; ++p) {
      const int r0 = p * kRows, rows = min(kRows, a.B - r0);
      if (p) __syncthreads();  // the previous pass is done with hT and red
      // prefetch the next (pass, step)'s pre while this one computes
      const int nt = p + 1 < passes ? t : t + 1;
      const int np = p + 1 < passes ? p + 1 : 0;
      if (nt < tmax) fetch_pre(nt, np * kRows, preS + (buf ^ 1) * kRows * nc);

      // h rows r0.. transposed into hT (rows past the batch as zeros),
      // rounded as the product sees them; kLoads float4 loads in flight a
      // thread before any store.  Neighbouring threads take neighbouring
      // rows of one float4 column, so their transposed stores fall in
      // different banks.
      for (int base = tid; base < n4; base += kLoads * kThreads) {
        float4 v[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int idx = base + u * kThreads, rr = idx % kRows;
          v[u] = idx < n4 && rr < rows
                     ? __ldcg(reinterpret_cast<const float4*>(
                                  hcur + static_cast<size_t>(r0 + rr) * a.ldh) +
                              idx / kRows)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int idx = base + u * kThreads;
          if (idx < n4) {
            const int rr = idx % kRows, i = 4 * (idx / kRows);
            const float q[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (i + e < H) hT[(i + e) * kRows + rr] = as_weight_type<T>(q[e]);
          }
        }
      }
      __syncthreads();
      if (mm) {
        float acc[kRows];
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) acc[rr] = 0.f;
        const float4* h4 = reinterpret_cast<const float4*>(hT);
#pragma unroll 4
        for (int i = i0; i < i1; ++i) {
          const float wv = to_f(wp[i * ldw]);
          const float4 x = h4[2 * i], y = h4[2 * i + 1];
          acc[0] = fmaf(x.x, wv, acc[0]);
          acc[1] = fmaf(x.y, wv, acc[1]);
          acc[2] = fmaf(x.z, wv, acc[2]);
          acc[3] = fmaf(x.w, wv, acc[3]);
          acc[4] = fmaf(y.x, wv, acc[4]);
          acc[5] = fmaf(y.y, wv, acc[5]);
          acc[6] = fmaf(y.z, wv, acc[6]);
          acc[7] = fmaf(y.w, wv, acc[7]);
        }
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr)
          red[(s * kRows + rr) * nc + c] = acc[rr];
      }
      // this pass's pre has landed (the next one may still be in flight)
      if (nt < tmax) __pipeline_wait_prior(1); else __pipeline_wait_prior(0);
      __syncthreads();

      // cell math: one thread per (row, column)
      const float* pS = preS + buf * kRows * nc;
      for (int idx = tid; idx < rows * ncols; idx += kThreads) {
        const int rr = idx / ncols, jl = idx % ncols;
        const int r = r0 + rr, j = j0 + jl;
        float hh[4], pv[4];
        for (int gg = 0; gg < a.k; ++gg) {
          const int cc = gg * cols + jl;
          float sum = 0.f;
          for (int ss = 0; ss < a.slices; ++ss)
            sum += red[(ss * kRows + rr) * nc + cc];
          hh[gg] = sum + a.b[gg * H + j];
          pv[gg] = pS[rr * nc + cc];
        }
        const size_t rj = static_cast<size_t>(r) * H + j;
        const size_t rh = static_cast<size_t>(r) * a.ldh + j;
        const float hold = __ldcg(hcur + rh);
        const bool keep = t < a.n[r];
        const bool save = a.cs != nullptr && t % a.U == 0;
        float* csb = save ? a.cs + static_cast<size_t>(t / a.U) * a.C * a.B * H
                          : nullptr;
        if (save) csb[static_cast<size_t>(a.C - 1) * a.B * H + rj] = hold;
        float hnew;
        if (a.cell == kVanilla) {
          const float z = pv[0] + hh[0];
          hnew = a.act == kRelu          ? fmaxf(z, 0.f)
                 : a.act == kClippedRelu ? fminf(fmaxf(z, 0.f), 20.f)
                                         : tanhf(z);
        } else if (a.cell == kGru) {
          const float rg = sigmoidf(pv[0] + hh[0]);
          const float zg = sigmoidf(pv[1] + hh[1]);
          const float ng = tanhf(pv[2] + rg * hh[2]);
          hnew = (1.f - zg) * ng + zg * hold;
        } else {
          const float ig = sigmoidf(pv[0] + hh[0]);
          const float fg = sigmoidf(pv[1] + hh[1]);
          const float gg = tanhf(pv[2] + hh[2]);
          const float og = sigmoidf(pv[3] + hh[3]);
          const float cold = a.cf[rj];
          if (save) csb[rj] = cold;
          const float cnew = fg * cold + ig * gg;
          hnew = og * tanhf(cnew);
          if (keep) a.cf[rj] = cnew;
        }
        hnxt[rh] = keep ? hnew : hold;
        a.ys[(static_cast<size_t>(r) * a.T + t) * H + j] = keep ? hnew : 0.f;
      }
      buf ^= 1;
    }
    grid_barrier(a.bar, nblocks);
  }

  // final h of the own columns (and, from the first block start past every
  // row's length on, the saved carries: the carry is frozen there); outputs
  // of steps past every row's length
  const float* hfin = a.hbuf + static_cast<size_t>(tmax & 1) * plane;
  const int nb = (a.T + a.U - 1) / a.U;
  for (int idx = tid; idx < a.B * ncols; idx += kThreads) {
    const int r = idx / ncols, j = j0 + idx % ncols;
    const size_t rj = static_cast<size_t>(r) * H + j;
    const float hf = __ldcg(hfin + static_cast<size_t>(r) * a.ldh + j);
    a.cf[static_cast<size_t>(a.C - 1) * a.B * H + rj] = hf;
    if (a.cs == nullptr) continue;
    for (int blk = (tmax + a.U - 1) / a.U; blk < nb; ++blk) {
      float* csb = a.cs + static_cast<size_t>(blk) * a.C * a.B * H;
      csb[static_cast<size_t>(a.C - 1) * a.B * H + rj] = hf;
      if (a.cell == kLstm) csb[rj] = a.cf[rj];
    }
  }
  const size_t tail = static_cast<size_t>(a.T - tmax) * a.B * ncols;
  for (size_t idx = tid; idx < tail; idx += kThreads) {
    const int jl = static_cast<int>(idx % ncols);
    const size_t rt = idx / ncols;
    const int r = static_cast<int>(rt % a.B);
    const int t = tmax + static_cast<int>(rt / a.B);
    a.ys[(static_cast<size_t>(r) * a.T + t) * H + j0 + jl] = 0.f;
  }
}

int gates_of(int cell) { return cell == kVanilla ? 1 : cell == kGru ? 3 : 4; }

// Shared memory one block needs besides its W slice (bytes), for `sms`
// resident blocks; ops/pallas_rnn.py::hopper_smem_bytes repeats it.
long long base_smem_bytes(int H, int cell, int sms) {
  const int cols = (H + sms - 1) / sms;
  const int nc = gates_of(cell) * cols;
  const int slices = kThreads / nc;
  return 4ll * (static_cast<long long>(H) * kRows +
                static_cast<long long>(slices) * kRows * nc + 2ll * kRows * nc);
}

}  // namespace

extern "C" {

const char* az_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launch K3 on `stream`.  pre, b, h0 fp32; w fp32 (w_bf16 = 0) or bf16;
// n int32 clamped to [0, T]; ys [B,T,H], cf [C,B,H] and hbuf
// [2,B,round_up(H,4)] fp32; bar two zeroed words; cs null (inference) or
// [ceil(T/U),C,B,H] fp32 for the carries at every U-th step.  Returns the
// cudaError_t of the launch (0 = launched); a geometry whose blocks cannot
// all be resident is refused.
int az_persistent_rnn(const float* pre, const void* w, int w_bf16,
                      const float* b, const float* h0, const int* n, float* ys,
                      float* cf, float* hbuf, unsigned int* bar, float* cs,
                      int B, int T, int H, int cell, int act, int U,
                      void* stream) {
  int dev = 0, sms = 0, coop = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);

  const int k = gates_of(cell);
  const int cols = (H + sms - 1) / sms;
  const int grid = (H + cols - 1) / cols;
  const int nc = k * cols;
  if (nc > kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const int slices = kThreads / nc;

  const void* fn = w_bf16
      ? reinterpret_cast<const void*>(&persistent_rnn_kernel<__nv_bfloat16>)
      : reinterpret_cast<const void*>(&persistent_rnn_kernel<float>);
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long limit = optin - static_cast<long long>(attr.sharedSizeBytes);
  const long long base = base_smem_bytes(H, cell, sms);
  if (base > limit) return static_cast<int>(cudaErrorInvalidValue);
  const long long wbytes =
      static_cast<long long>(H) * nc * (w_bf16 ? 2 : 4);
  const int w_smem = base + wbytes <= limit;
  const size_t smem = static_cast<size_t>(base + (w_smem ? wbytes : 0));

  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                    smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm * sms < grid)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);

  if (U < 1) return static_cast<int>(cudaErrorInvalidValue);
  Args a{pre, w, b, h0, n, ys, cf, hbuf, bar, cs, B, T, H, k,
         cell == kLstm ? 2 : 1, cell, act, U, (H + 3) / 4 * 4, cols, nc,
         slices, w_smem};
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), params, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
