// The persistent-RNN step engine shared by K3 (persistent_rnn.cu, the
// forward) and K4 (persistent_rnn_bwd.cu, the backward).  Each .cu file
// compiles on its own; utils/cuda_build.py hashes this header into both
// libraries' names, so an edit here rebuilds both.
//
// A step of either kernel is a grid-wide dependency: block g owns hidden
// columns [g*cols, (g+1)*cols) of every gate and needs all of the previous
// step's vector (h for the forward, d_hh for K4's dh chain) before its
// product.  At DS2's shape (B=8, H=1760, 126 blocks of 14 columns) the
// product of one block is 197K FMAs, under a microsecond on one SM, so
// what bounds a step is the chain around it: the barrier, the delivery of
// the 56 KB vector to every block, and how many shared-memory loads feed
// each FMA.  The engine's answers:
//
// - The barrier is a monotone arrival counter: one red.release.gpu a block
//   and a poll with ld.acquire.gpu until the count reaches (phase + 1) * G.
//   No reset, no generation word, one fence's worth of ordering each way.
//   A poll that waits 10 s traps (a block never arrived) instead of hanging
//   the card.
// - The vector is delivered, not pulled.  The producing block writes its
//   new columns straight into the layout the product reads, [width][8 rows]
//   (the transpose the consumer used to do moves to the writer), rounded to
//   the weight type.  After the barrier one thread of each consumer brings
//   the whole vector into shared memory with one cp.async.bulk that
//   completes on an mbarrier.  Where the grid is even, blocks run in
//   clusters of two and the copy is read once from L2 and multicast to
//   both (126 blocks reading the same 56 KB a step is what bounds the
//   delivery); either way the launch is cooperative.
// - The product gives every thread a tile of 8 rows x 2 columns over a
//   K-slice: two 16-byte loads of the vector feed 16 FMAs, which leaves
//   the product bound by shared-memory bandwidth, not by the FMAs.  K3
//   keeps the block's column slice of W in REGISTERS when a thread's slice
//   fits kRegK rows (DS2: 49 rows x 2 columns, 98 registers); K4, which
//   also holds its row slice and the dh chain's state, keeps the first
//   kSplitK rows in registers and the rest in shared memory.  Where that
//   does not fit, K3 keeps the slice in shared memory, else both read it
//   from L2.  The choice is made before launch from the geometry, and all
//   give the same sums in the same order.
// - Sums are taken in a fixed order (each K-slice in order, then the slices
//   four ways), with explicit fmaf under -fmad=false, so every run is
//   bit-equal, and K4's recompute, which calls forward_step as K3 does with
//   the same partition, rebuilds K3's carries bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;     // batch rows per pass: the register tile's rows
constexpr int kRegK = 52;    // K rows of W a thread may hold in registers
// K4 holds the first kSplitK rows of each thread's slice in registers and
// the rest in shared memory: its row slice and the dh chain's state leave
// no room for a whole column slice in registers
constexpr int kSplitK = 24;
enum Cell { kVanilla = 0, kGru = 1, kLstm = 2 };
enum Act { kRelu = 0, kClippedRelu = 1, kTanh = 2 };
// where the forward product reads the block's column slice of W
enum WSource { kWReg = 0, kWSmem = 1, kWGlobal = 2, kWSplit = 3 };

// a barrier or a delivery that waits this long means a block never
// arrived: abort the kernel (a CUDA error) instead of hanging the device
constexpr unsigned long long kTimeoutNs = 10ull * 1000 * 1000 * 1000;

__host__ __device__ inline int gates_of(int cell) {
  return cell == kVanilla ? 1 : cell == kGru ? 3 : 4;
}
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline size_t round4(size_t x) { return (x + 3) / 4 * 4; }

// The partition of the work, computed the same way on the host and in
// both kernels.  The forward product: column pairs cp < CP over the block's
// nc = k*cols product columns, K-slices s < S of klen rows of the H inputs;
// thread tid takes pair tid % CP and slice tid / CP.  K4's dh product: pairs
// of the block's own cols over the k*H inputs, the same way.
struct Geom {
  int H, k, kH, cols, G, nc;
  int CP, S, klen;     // forward product
  int CPr, Sr, klenr;  // K4's dh product
  int passes;          // ceil(B / kRows)
};

inline Geom make_geom(int H, int cell, int B, int sms) {
  Geom g;
  g.H = H;
  g.k = gates_of(cell);
  g.kH = g.k * H;
  g.cols = cdiv(H, sms);
  g.G = cdiv(H, g.cols);
  g.nc = g.k * g.cols;
  g.CP = cdiv(g.nc, 2);
  g.S = kThreads / g.CP < H ? kThreads / g.CP : H;
  if (g.S < 1) g.S = 1;
  g.klen = cdiv(H, g.S);
  g.S = cdiv(H, g.klen);  // no empty slice
  g.CPr = cdiv(g.cols, 2);
  g.Sr = kThreads / g.CPr < g.kH ? kThreads / g.CPr : g.kH;
  if (g.Sr < 1) g.Sr = 1;
  g.klenr = cdiv(g.kH, g.Sr);
  g.Sr = cdiv(g.kH, g.klenr);
  g.passes = cdiv(B, kRows);
  return g;
}

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

// -- step-phase stamps --------------------------------------------------
// Block 0's thread 0 writes %globaltimer at the phase boundaries of the
// steps [kStampFirst, kStampFirst + kStampSteps) of each chain into
// stamps[((chain * kStampSteps) + step) * kStampPhases + phase].  Slots:
// 0 step start, 1 the vector landed (as thread 0 sees it), 2
// every product done, 3 cell math done, 4 barrier passed; inside the cell
// math of thread 0's first (row, column) of a forward step, 5 partial sums
// reduced and pre read, 6 gates applied, 7 results stored; for the first
// thread of the last K-slice of a forward step, 8 the vector landed,
// 9 its product done.  The buffer is null on the main path.
constexpr int kStampFirst = 16, kStampSteps = 64, kStampPhases = 10;
__device__ __forceinline__ void stamp(unsigned long long* s, int chain,
                                      int step, int phase,
                                      int thread = 0) {
  if (s != nullptr && blockIdx.x == 0 && threadIdx.x == thread) {
    const int q = step - kStampFirst;
    if (q >= 0 && q < kStampSteps)
      s[(chain * kStampSteps + q) * kStampPhases + phase] = global_ns();
  }
}

// where forward_step stamps: a chain's step (ptr null: not stamped)
struct StampAt {
  unsigned long long* ptr;
  int chain, step;
  __device__ __forceinline__ void at(int phase, int thread = 0) const {
    stamp(ptr, chain, step, phase, thread);
  }
};

// -- the grid barrier ---------------------------------------------------
// Every block of the launch is resident (a cooperative launch, of blocks
// or of clusters), so spinning cannot starve a block that has not
// arrived.  *ctr counts arrivals for the whole launch; the n-th barrier of
// a block waits for n * G of them.  The block's stores are ordered before
// thread 0's release by __syncthreads; the acquire orders the next reads.
__device__ __forceinline__ void grid_sync(unsigned int* ctr,
                                          unsigned int target) {
  // what this thread published, before the other blocks' bulk copies
  // (the async proxy) read it
  asm volatile("fence.proxy.async.global;" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(ctr),
                 "r"(1u)
                 : "memory");
    unsigned int v;
    unsigned long long t0 = 0;
    for (int spin = 0;; ++spin) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(v)
                   : "l"(ctr)
                   : "memory");
      if (static_cast<int>(v - target) >= 0) break;
      if ((spin & 255) == 0) {
        const unsigned long long now = global_ns();
        if (t0 == 0) t0 = now;
        else if (now - t0 > kTimeoutNs) __trap();
      }
    }
  }
  __syncthreads();
}

// -- delivery: a bulk copy into shared memory on an mbarrier ---------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// this block's rank in its thread-block cluster
__device__ __forceinline__ unsigned int cluster_rank() {
  unsigned int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// every thread of every block of the cluster arrives and waits: what the
// blocks wrote before is seen by all of them after
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// One mbarrier; `uses` counts the deliveries so far (the same in every
// thread), whose parity is the phase to wait for.
struct Delivery {
  uint64_t* bar;  // in shared memory
  unsigned int uses;
};

__device__ __forceinline__ void delivery_init(Delivery& d, uint64_t* bar) {
  d.bar = bar;
  d.uses = 0;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                     smem_u32(bar)),
                 "r"(1u)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// Thread 0: copy src [width][kRows] fp32 (global, written this launch by
// other blocks before the barrier) into dst in shared memory, one bulk
// copy that completes on the block's mbarrier.  In a cluster of kCl
// blocks, rank 0 reads it once from L2 and multicasts it into every block
// of the cluster (the same offset, each block's own mbarrier); every block
// expects the bytes.  A block may take the copy before its own expect: the
// phase cannot complete before its own arrival.  The caller makes sure
// that no peer is still reading dst (a barrier or a cluster sync before
// every delivery).  One piece, not several that threads wait for apart:
// on an H100, threads spinning on the later pieces' mbarriers slowed the
// products of those that had theirs by more than the early start gained.
template <int kCl>
__device__ __forceinline__ void deliver(Delivery& d, float* dst,
                                        const float* src, int width) {
  if (threadIdx.x == 0) {
    // the generic-proxy stores published by the barrier, before the
    // async-proxy reads of the copy
    asm volatile("fence.proxy.async.global;" ::: "memory");
    const unsigned int bytes =
        static_cast<unsigned int>(width) * kRows * sizeof(float);
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
            smem_u32(d.bar)),
        "r"(bytes)
        : "memory");
    if constexpr (kCl == 1) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
          "bytes [%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
          "l"(src), "r"(bytes), "r"(smem_u32(d.bar))
          : "memory");
    } else if (cluster_rank() == 0) {
      const unsigned short mask = (1u << kCl) - 1u;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
          "bytes.multicast::cluster [%0], [%1], %2, [%3], %4;" ::"r"(
              smem_u32(dst)),
          "l"(src), "r"(bytes), "r"(smem_u32(d.bar)), "h"(mask)
          : "memory");
    }
  }
}

// Wait until the delivered vector has landed.
__device__ __forceinline__ void delivery_wait(const Delivery& d) {
  const uint32_t bar = smem_u32(d.bar), parity = d.uses & 1u;
  unsigned long long t0 = 0;
  for (int spin = 0;; ++spin) {
    uint32_t ok;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(ok)
        : "r"(bar), "r"(parity)
        : "memory");
    if (ok) break;
    if ((spin & 255) == 0) {
      const unsigned long long now = global_ns();
      if (t0 == 0) t0 = now;
      else if (now - t0 > kTimeoutNs) __trap();
    }
  }
}

// Every thread, after a delivery's last use (all threads past their wait):
// the next delivery waits for the other parity.
__device__ __forceinline__ void delivery_done(Delivery& d) { ++d.uses; }

// Producer side: the value of row r of column i of a delivered vector
// [passes][width][kRows] (buffer base: its pass 0).
__device__ __forceinline__ size_t vec_index(int r, int i, int width) {
  return (static_cast<size_t>(r / kRows) * width + i) * kRows + r % kRows;
}

// -- the product: 8 rows x 2 columns a thread ---------------------------
__device__ __forceinline__ void fma_tile(float (&acc)[kRows][2],
                                         const float4& x, const float4& y,
                                         float w0, float w1) {
  const float h[kRows] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    acc[r][0] = fmaf(h[r], w0, acc[r][0]);
    acc[r][1] = fmaf(h[r], w1, acc[r][1]);
  }
}

// The block's column slice of W as the forward product reads it: columns
// c0 = 2*cp and c1 = 2*cp + 1 of the nc product columns (gate c / cols,
// own column c % cols), over K rows [i0, i1).  kWReg: in registers;
// kWSmem: in shared memory as [H][CP][2]; kWGlobal: W itself, through L2;
// kWSplit: rows i0 .. i0 + kSplitK - 1 in registers, the rest of each
// slice in shared memory as [S][klen - kSplitK][CP][2].
template <typename T, int kSrc>
struct ColSlice {
  float r[kSrc == kWReg ? kRegK : kSrc == kWSplit ? kSplitK : 1][2];
  const T* p;      // kWSmem, kWSplit: the shared part; kWGlobal: W
  int o0, o1;      // kWGlobal: the two columns of W, -1 for none
  int i0, i1;      // this thread's K rows
  bool active;     // this thread has a pair and a slice
};

// Fill the slice of thread tid (block j0.. of width ncols) from W [H, kH].
// kWSmem: every thread helps to fill the shared copy wS (caller syncs).
template <typename T, int kSrc>
__device__ __forceinline__ void col_slice_load(ColSlice<T, kSrc>& w,
                                               const T* W, T* wS,
                                               const Geom& g, int j0,
                                               int ncols) {
  const int tid = threadIdx.x;
  const int cp = tid % g.CP, s = tid / g.CP;
  w.active = s < g.S;
  w.i0 = min(g.H, s * g.klen);
  w.i1 = min(g.H, w.i0 + g.klen);
  int o[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int c = 2 * cp + q;
    o[q] = c < g.nc && c % g.cols < ncols
               ? (c / g.cols) * g.H + j0 + c % g.cols : -1;
  }
  w.o0 = o[0];
  w.o1 = o[1];
  if constexpr (kSrc == kWReg || kSrc == kWSplit) {
    constexpr int kK = kSrc == kWReg ? kRegK : kSplitK;
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      const int i = w.i0 + kk;
#pragma unroll
      for (int q = 0; q < 2; ++q)
        w.r[kk][q] = w.active && i < w.i1 && o[q] >= 0
                         ? to_f(W[static_cast<size_t>(i) * g.kH + o[q]])
                         : 0.f;
    }
  }
  if constexpr (kSrc == kWSplit) {
    const int tail = max(0, g.klen - kSplitK), ld = g.CP * 2;
    for (int idx = tid; idx < g.S * tail * ld; idx += kThreads) {
      const int c = idx % ld, q = idx / ld;
      const int ss = q / tail, i = ss * g.klen + kSplitK + q % tail;
      const int ok = c < g.nc && c % g.cols < ncols &&
                     i < min(g.H, (ss + 1) * g.klen);
      wS[idx] = ok ? W[static_cast<size_t>(i) * g.kH + (c / g.cols) * g.H +
                       j0 + c % g.cols]
                   : from_f<T>(0.f);
    }
    w.p = wS + static_cast<size_t>(s) * tail * ld + 2 * cp;
  } else if constexpr (kSrc == kWSmem) {
    for (int idx = tid; idx < g.H * g.CP * 2; idx += kThreads) {
      const int i = idx / (g.CP * 2), c = idx % (g.CP * 2);
      const int ok = c < g.nc && c % g.cols < ncols;
      wS[idx] = ok ? W[static_cast<size_t>(i) * g.kH + (c / g.cols) * g.H +
                       j0 + c % g.cols]
                   : from_f<T>(0.f);
    }
    w.p = wS + 2 * cp;
  } else if constexpr (kSrc == kWGlobal) {
    w.p = W;
  }
}

__device__ __forceinline__ float2 pair_f(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair_f(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// acc[r][q] = sum over i in [i0, i1) of xT[i][r] * W[i][column q], in order
template <typename T, int kSrc>
__device__ __forceinline__ void col_product(float (&acc)[kRows][2],
                                            const ColSlice<T, kSrc>& w,
                                            const float* xT, const Geom& g) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r][0] = acc[r][1] = 0.f;
  const float4* x4 = reinterpret_cast<const float4*>(xT);
  if constexpr (kSrc == kWReg || kSrc == kWSplit) {
    constexpr int kK = kSrc == kWReg ? kRegK : kSplitK;
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      const int i = w.i0 + kk;
      if (i < w.i1)
        fma_tile(acc, x4[2 * i], x4[2 * i + 1], w.r[kk][0], w.r[kk][1]);
    }
  }
  if constexpr (kSrc == kWSplit) {
    const int ld = 2 * g.CP;
#pragma unroll 4
    for (int i = w.i0 + kSplitK; i < w.i1; ++i) {
      const float2 wv =
          pair_f(w.p + static_cast<size_t>(i - w.i0 - kSplitK) * ld);
      fma_tile(acc, x4[2 * i], x4[2 * i + 1], wv.x, wv.y);
    }
  } else if constexpr (kSrc == kWSmem) {
    const int ld = 2 * g.CP;
#pragma unroll 4
    for (int i = w.i0; i < w.i1; ++i) {
      const float2 wv = pair_f(w.p + static_cast<size_t>(i) * ld);
      fma_tile(acc, x4[2 * i], x4[2 * i + 1], wv.x, wv.y);
    }
  } else if constexpr (kSrc == kWGlobal) {
#pragma unroll 4
    for (int i = w.i0; i < w.i1; ++i) {
      const T* row = w.p + static_cast<size_t>(i) * g.kH;
      const float w0 = w.o0 >= 0 ? to_f(row[w.o0]) : 0.f;
      const float w1 = w.o1 >= 0 ? to_f(row[w.o1]) : 0.f;
      fma_tile(acc, x4[2 * i], x4[2 * i + 1], w0, w1);
    }
  }
}

// Split-K partial sums live as red[(s * kRows + r) * width + c]: thread
// (pair cp, slice s) of a product over `width` = 2 * pairs columns stores
// its 8 rows x 2 columns as float2s.
__device__ __forceinline__ void store_partials(float* red,
                                               const float (&acc)[kRows][2],
                                               int width, int S, int cp,
                                               int s) {
  float* o = red + static_cast<size_t>(s) * kRows * width + 2 * cp;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    *reinterpret_cast<float2*>(o + r * width) =
        make_float2(acc[r][0], acc[r][1]);
}

// The sum of the S partials of output (row rr, column c) in a fixed order:
// four running sums over the slices by index mod 4 (their loads in flight
// together), the rest into the first, then (s0 + s1) + (s2 + s3).
__device__ __forceinline__ float sum_partials(const float* red, int rr, int c,
                                              int width, int S) {
  const float* p = red + rr * width + c;
  const size_t ld = static_cast<size_t>(kRows) * width;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  int ss = 0;
  for (; ss + 4 <= S; ss += 4) {
    const float v0 = p[ss * ld], v1 = p[(ss + 1) * ld];
    const float v2 = p[(ss + 2) * ld], v3 = p[(ss + 3) * ld];
    s0 += v0;
    s1 += v1;
    s2 += v2;
    s3 += v3;
  }
  for (; ss < S; ++ss) s0 += p[ss * ld];
  return (s0 + s1) + (s2 + s3);
}

// -- the cell ---------------------------------------------------------------
// The gate math of one (row, column) from the pre values pv and the
// recurrent projections hh (both gate-stacked), the carry's h and (LSTM) c:
// the new h, and for LSTM the new c in *cnew.
__device__ __forceinline__ float cell_forward(int cell, int act,
                                              const float* pv,
                                              const float* hh, float hold,
                                              float cold, float* cnew) {
  if (cell == kVanilla) {
    const float z = pv[0] + hh[0];
    // torch.clamp propagates a NaN z; fmaxf would map it to 0
    if (z != z) return z;
    return act == kRelu          ? fmaxf(z, 0.f)
           : act == kClippedRelu ? fminf(fmaxf(z, 0.f), 20.f)
                                 : tanhf(z);
  }
  if (cell == kGru) {
    const float rg = sigmoidf(pv[0] + hh[0]);
    const float zg = sigmoidf(pv[1] + hh[1]);
    const float ng = tanhf(pv[2] + rg * hh[2]);
    return (1.f - zg) * ng + zg * hold;
  }
  const float ig = sigmoidf(pv[0] + hh[0]);
  const float fg = sigmoidf(pv[1] + hh[1]);
  const float gg = tanhf(pv[2] + hh[2]);
  const float og = sigmoidf(pv[3] + hh[3]);
  *cnew = fg * cold + ig * gg;
  return og * tanhf(*cnew);
}

// -- one forward step ---------------------------------------------------
// One step of the recurrence for one pass of rows, as K3 runs it and K4's
// recompute re-runs it: deliver h (hsrc, the pass's [H][kRows] in global
// memory) into xT, multiply by the column slice, reduce the partial sums
// (red, see store_partials) in a fixed order, add b (bS, the block's
// [k][cols] in shared memory), apply the cell, and hand each (row, own
// column) to out.  pre(rr, gate, jl) and carry(rr, jl, &hold, &cold) give
// the inputs and out(rr, jl, hnew, hold, cnew, cold, hh) takes the
// results; issue() runs right after the delivery is issued (K3 prefetches
// its next pre there) and ready() in every thread before the block syncs
// for the cell math (K3 waits for that pre).  A thread's first (row,
// column) has its carry, and with kPreEarly its pre values, loaded while
// the vector is on its way, so that their latency hides behind the
// product (carry reads only what this thread wrote a step before, or the
// saved carries; kPreEarly: pre reads an input of the launch).
template <bool kPreEarly, int kCl, typename T, int kSrc, typename Issue,
          typename Ready, typename Pre, typename Carry, typename Out>
__device__ __forceinline__ void forward_step(
    const Geom& g, const ColSlice<T, kSrc>& w, Delivery& dlv,
    const float* hsrc, float* xT, float* red, const float* bS, int ncols,
    int rows, int cell, int act, const StampAt& st, Issue issue, Ready ready,
    Pre pre, Carry carry, Out out) {
  const int tid = threadIdx.x;
  const int cp = tid % g.CP, s = tid / g.CP;
  deliver<kCl>(dlv, xT, hsrc, g.H);
  issue();
  float hold0 = 0.f, cold0 = 0.f, pv0[4];
  if (tid < rows * ncols) {
    carry(tid / ncols, tid % ncols, &hold0, &cold0);
    // per-gate arrays are indexed only by unrolled constants, so they stay
    // in registers (an index the compiler cannot fold puts them in local
    // memory, and its store would wait here for the load)
#pragma unroll
    for (int gg = 0; gg < 4; ++gg)
      pv0[gg] = kPreEarly && gg < g.k ? pre(tid / ncols, gg, tid % ncols)
                                      : 0.f;
  }
  if (w.active) delivery_wait(dlv);
  const int last = (g.S - 1) * g.CP;  // the first thread of the last slice
  st.at(1);
  st.at(8, last);
  float acc[kRows][2];
  col_product(acc, w, xT, g);  // an empty range for a thread with no slice
  if (w.active) store_partials(red, acc, 2 * g.CP, g.S, cp, s);
  st.at(9, last);
  ready();
  __syncthreads();
  st.at(2);
  delivery_done(dlv);
  for (int idx = tid; idx < rows * ncols; idx += kThreads) {
    const int rr = idx / ncols, jl = idx % ncols;
    float hh[4], pv[4];
#pragma unroll
    for (int gg = 0; gg < 4; ++gg) {
      hh[gg] = pv[gg] = 0.f;
      if (gg >= g.k) continue;
      const int c = gg * g.cols + jl;
      hh[gg] = sum_partials(red, rr, c, 2 * g.CP, g.S) + bS[c];
      pv[gg] = kPreEarly && idx == tid ? pv0[gg] : pre(rr, gg, jl);
    }
    float hold = hold0, cold = cold0, cnew = 0.f;
    if (idx != tid) carry(rr, jl, &hold, &cold);
    if (idx == tid) st.at(5);
    const float hnew = cell_forward(cell, act, pv, hh, hold, cold, &cnew);
    if (idx == tid) st.at(6);
    out(rr, jl, hnew, hold, cnew, cold, hh);
    if (idx == tid) st.at(7);
  }
}

// -- launch helpers (host) --------------------------------------------------
// The cluster size a launch of G blocks takes: 2 where G is even, else 1.
inline int cluster_for(int G) { return G % 2 == 0 ? 2 : 1; }

// Launch fn (instantiated for cluster_for(G)) over G blocks of kThreads,
// cooperatively: the runtime refuses the launch unless every block is
// resident at once, which the grid barrier needs.  In clusters of two the
// cooperative attribute goes with the cluster dimension in one
// cudaLaunchKernelExC, after checking that G / 2 clusters fit.  Returns
// cudaErrorCooperativeLaunchTooLarge when they cannot.
inline cudaError_t launch_persistent(const void* fn, int G, size_t smem,
                                     void** params, cudaStream_t st) {
  const int cl = cluster_for(G);
  if (cl == 1)
    return cudaLaunchCooperativeKernel(fn, dim3(G), dim3(kThreads), params,
                                       smem, st);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cl;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  at[1].id = cudaLaunchAttributeCooperative;
  at[1].val.cooperative = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;  // the occupancy query takes the cluster alone
  int clusters = 0;
  cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
  if (e != cudaSuccess) return e;
  if (clusters * cl < G) return cudaErrorCooperativeLaunchTooLarge;
  cfg.numAttrs = 2;
  return cudaLaunchKernelExC(&cfg, fn, params);
}
// Whether `fn` with `smem` dynamic bytes can keep `grid` blocks of kThreads
// resident, as a cooperative launch requires.
inline cudaError_t check_resident(const void* fn, size_t smem, int grid,
                                  int sms) {
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                    smem);
  if (e != cudaSuccess) return e;
  return per_sm * sms < grid ? cudaErrorCooperativeLaunchTooLarge
                             : cudaSuccess;
}

}  // namespace
