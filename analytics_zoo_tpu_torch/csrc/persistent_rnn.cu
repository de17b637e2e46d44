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
// But the steps form a chain of T dependent products, each a grid-wide
// dependency, so what a step costs beside its 0.74 us of FMAs is the chain
// around it: the barrier, the delivery of h to every block, and the
// shared-memory loads that feed the FMAs.
//
// Design: the TPU kernel walks a sequential time grid on one core with W
// resident in VMEM.  Hopper blocks run in parallel and carry nothing from
// one to the next, so ONE cooperative launch keeps G <= #SM blocks resident
// for the whole T loop; block g owns hidden columns [g*cols, (g+1)*cols) of
// every gate, so the cell math stays inside the block.  A step runs on the
// engine of rnn_common.cuh: the block's column slice of W sits in
// registers (DS2: 98 a thread), else shared memory, else L2; h arrives in
// shared memory as one bulk copy of the [H][8] layout its producers wrote,
// on an mbarrier, multicast to a cluster of two blocks where the grid
// divides; each thread multiplies 8 rows by 2 columns over
// its K-slice; the partial sums are reduced in a fixed order, so a run is
// deterministic; the new h columns are written rounded to w's type into
// the next ping-pong buffer, and one counter barrier a step publishes them.
// The fp32 carry of the own columns lives in the output carry itself.  The
// next step's pre values are fetched with cp.async while the product runs.
// Steps past every row's length are skipped: their outputs are zeros and
// the carry is frozen.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rnn_common.cuh"

namespace {

struct Args {
  const float* pre;
  const void* w;
  const float* b;
  const float* h0;
  const int* n;
  float* ys;
  float* cf;            // [C, B, H]: the running carry, the final one at the end
  float* hg;            // [2, passes, H, kRows] delivered h (rows >= B zero)
  unsigned int* bar;    // arrival counter (zeroed by the caller)
  float* cs;            // [ceil(T/U), C, B, H] block-start carries, or null
  unsigned long long* stamps;  // step-phase stamps, or null
  int B, T, C, cell, act;
  int U;                // steps between two saved carries
  Geom g;
};

// Shared memory (floats) besides the W slice: the delivered h, the split-K
// partial sums, two stages of pre and the block's bias.
// ops/pallas_rnn.py::hopper_smem_bytes repeats it.
__host__ __device__ inline size_t base_floats(const Geom& g) {
  return round4(static_cast<size_t>(g.H) * kRows) +
         round4(static_cast<size_t>(g.S) * kRows * 2 * g.CP) +
         round4(2ull * kRows * g.nc) + round4(g.nc);
}

template <typename T, int kSrc, int kCl>
__global__ void __launch_bounds__(kThreads, 1)
persistent_rnn_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t s_bar;
  __shared__ int s_tmax;
  const Geom g = a.g;
  const int H = g.H, kH = g.kH, cols = g.cols, nc = g.nc;
  float* xT = reinterpret_cast<float*>(smem_raw);                // [H][kRows]
  float* red = xT + round4(static_cast<size_t>(H) * kRows);
  float* preS = red + round4(static_cast<size_t>(g.S) * kRows * 2 * g.CP);
  float* bS = preS + round4(2ull * kRows * nc);                   // [k][cols]
  T* wS = reinterpret_cast<T*>(xT + base_floats(g));             // kWSmem

  const int tid = threadIdx.x;
  const unsigned int G = gridDim.x;
  const int j0 = blockIdx.x * cols;
  const int ncols = min(cols, H - j0);  // >= 1: the grid has no empty block
  const size_t BH = static_cast<size_t>(a.B) * H;
  float* hcar = a.cf + (a.C - 1) * BH;  // the running h of the own columns

  Delivery dlv;
  delivery_init(dlv, &s_bar);
  ColSlice<T, kSrc> w;
  col_slice_load(w, static_cast<const T*>(a.w), wS, g, j0, ncols);
  if (tid == 0) {
    int m = 0;
    for (int r = 0; r < a.B; ++r) m = max(m, a.n[r]);  // n clamped to [0, T]
    s_tmax = m;
  }
  for (int c = tid; c < nc; c += kThreads)
    bS[c] = c % cols < ncols ? a.b[(c / cols) * H + j0 + c % cols] : 0.f;
  // the carry's own columns: h into the running carry and, rounded, into
  // the first delivery buffer; LSTM's c into the carry's slot 0
  for (int idx = tid; idx < a.B * ncols; idx += kThreads) {
    const int r = idx / ncols, j = j0 + idx % ncols;
    const size_t rj = static_cast<size_t>(r) * H + j;
    const float h = a.h0[(a.C - 1) * BH + rj];
    hcar[rj] = h;
    if (a.cell == kLstm) a.cf[rj] = a.h0[rj];
    a.hg[vec_index(r, j, H)] = as_weight_type<T>(h);
  }
  unsigned int epoch = 0;
  grid_sync(a.bar, ++epoch * G);
  const int tmax = s_tmax;
  const size_t vplane = static_cast<size_t>(g.passes) * H * kRows;

  // cp.async of the pre values one pass needs: [kRows][k][ncols] of step t
  auto fetch_pre = [&](int t, int r0, float* dst) {
    const int rows = min(kRows, a.B - r0);
    for (int idx = tid; idx < rows * g.k * ncols; idx += kThreads) {
      const int rr = idx / (g.k * ncols), rem = idx % (g.k * ncols);
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
    const float* hcur = a.hg + static_cast<size_t>(t & 1) * vplane;
    float* hnxt = a.hg + static_cast<size_t>((t + 1) & 1) * vplane;
    const bool save = a.cs != nullptr && t % a.U == 0;
    float* csb = save ? a.cs + static_cast<size_t>(t / a.U) * a.C * BH
                      : nullptr;
    stamp(a.stamps, 0, t, 0);
    for (int p = 0; p < g.passes; ++p) {
      const int r0 = p * kRows, rows = min(kRows, a.B - r0);
      // the previous pass is done with red and preS, and (cluster) every
      // block of the cluster with xT
      if (p) {
        if constexpr (kCl > 1) cluster_sync();
        else __syncthreads();
      }
      const int nt = p + 1 < g.passes ? t : t + 1;
      const int np = p + 1 < g.passes ? p + 1 : 0;
      const float* pS = preS + buf * kRows * nc;
      forward_step<false, kCl>(
          g, w, dlv, hcur + static_cast<size_t>(p) * H * kRows, xT, red, bS,
          ncols, rows, a.cell, a.act,
          StampAt{p == 0 ? a.stamps : nullptr, 0, t},
          [&] {
            // prefetch the next (pass, step)'s pre while this one computes
            if (nt < tmax)
              fetch_pre(nt, np * kRows, preS + (buf ^ 1) * kRows * nc);
          },
          [&] {
            // this pass's pre has landed (the next may still be in flight)
            if (nt < tmax) __pipeline_wait_prior(1);
            else __pipeline_wait_prior(0);
          },
          [&](int rr, int gg, int jl) { return pS[rr * nc + gg * cols + jl]; },
          [&](int rr, int jl, float* hold, float* cold) {
            const size_t rj = static_cast<size_t>(r0 + rr) * H + j0 + jl;
            *hold = hcar[rj];
            if (a.cell == kLstm) *cold = a.cf[rj];
          },
          [&](int rr, int jl, float hnew, float hold, float cnew, float cold,
              const float*) {
            const int r = r0 + rr, j = j0 + jl;
            const size_t rj = static_cast<size_t>(r) * H + j;
            const bool keep = t < __ldg(a.n + r);
            if (save) {
              csb[(a.C - 1) * BH + rj] = hold;
              if (a.cell == kLstm) csb[rj] = cold;
            }
            const float hk = keep ? hnew : hold;
            hcar[rj] = hk;
            if (a.cell == kLstm && keep) a.cf[rj] = cnew;
            hnxt[vec_index(r, j, H)] = as_weight_type<T>(hk);
            a.ys[(static_cast<size_t>(r) * a.T + t) * H + j] =
                keep ? hnew : 0.f;
          });
      buf ^= 1;
    }
    stamp(a.stamps, 0, t, 3);
    grid_sync(a.bar, ++epoch * G);
    stamp(a.stamps, 0, t, 4);
  }

  // from the first block start past every row's length on, the saved
  // carries are the frozen final carry; outputs of steps past every row's
  // length are zeros
  const int nb = (a.T + a.U - 1) / a.U;
  if (a.cs != nullptr) {
    for (int idx = tid; idx < a.B * ncols; idx += kThreads) {
      const size_t rj =
          static_cast<size_t>(idx / ncols) * H + j0 + idx % ncols;
      for (int blk = (tmax + a.U - 1) / a.U; blk < nb; ++blk) {
        float* csb = a.cs + static_cast<size_t>(blk) * a.C * BH;
        csb[(a.C - 1) * BH + rj] = hcar[rj];
        if (a.cell == kLstm) csb[rj] = a.cf[rj];
      }
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

template <typename T, int kCl>
const void* kernel_for(int src) {
  return src == kWReg ? reinterpret_cast<const void*>(
                            &persistent_rnn_kernel<T, kWReg, kCl>)
         : src == kWSmem ? reinterpret_cast<const void*>(
                               &persistent_rnn_kernel<T, kWSmem, kCl>)
                         : reinterpret_cast<const void*>(
                               &persistent_rnn_kernel<T, kWGlobal, kCl>);
}

const void* kernel_for(int w_bf16, int src, int cl) {
  return w_bf16 ? (cl == 2 ? kernel_for<__nv_bfloat16, 2>(src)
                           : kernel_for<__nv_bfloat16, 1>(src))
                : (cl == 2 ? kernel_for<float, 2>(src)
                           : kernel_for<float, 1>(src));
}

}  // namespace

extern "C" {

const char* az_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launch K3 on `stream`.  pre, b, h0 fp32; w fp32 (w_bf16 = 0) or bf16;
// n int32 clamped to [0, T]; ys [B,T,H] and cf [C,B,H] fp32; hg
// [2,ceil(B/8),H,8] fp32 zeros; bar one zeroed word; cs null (inference)
// or [ceil(T/U),C,B,H] fp32 for the carries at every U-th step; stamps
// null or the step-phase stamp buffer.  w_source (if not null) gets where
// the W slice lives (0 registers, 1 shared memory, 2 L2).  Returns the
// cudaError_t of the launch (0 = launched); a geometry whose blocks cannot
// all be resident is refused.
int az_persistent_rnn(const float* pre, const void* w, int w_bf16,
                      const float* b, const float* h0, const int* n, float* ys,
                      float* cf, float* hg, unsigned int* bar, float* cs,
                      int B, int T, int H, int cell, int act, int U,
                      unsigned long long* stamps, int* w_source,
                      void* stream) {
  int dev = 0, sms = 0, coop = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  if (U < 1) return static_cast<int>(cudaErrorInvalidValue);

  const Geom g = make_geom(H, cell, B, sms);
  if (g.nc > kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const size_t base = 4 * base_floats(g);
  const size_t wbytes = static_cast<size_t>(H) * 2 * g.CP * (w_bf16 ? 2 : 4);
  // registers when a thread's K-slice fits kRegK rows, else shared memory
  // when the slice fits beside the rest, else L2
  const int cl = cluster_for(g.G);
  int src = g.klen <= kRegK ? kWReg : kWSmem;
  const void* fn = kernel_for(w_bf16, src, cl);
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t limit = optin - attr.sharedSizeBytes;
  if (base > limit) return static_cast<int>(cudaErrorInvalidValue);
  if (src == kWSmem && base + wbytes > limit) {
    src = kWGlobal;
    fn = kernel_for(w_bf16, src, cl);
  }
  const size_t smem = base + (src == kWSmem ? wbytes : 0);
  e = check_resident(fn, smem, g.G, sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (w_source) *w_source = src;

  Args a{pre, w, b, h0, n, ys, cf, hg, bar, cs, stamps,
         B, T, cell == kLstm ? 2 : 1, cell, act, U, g};
  void* params[] = {&a};
  e = launch_persistent(fn, g.G, smem, params,
                        static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
