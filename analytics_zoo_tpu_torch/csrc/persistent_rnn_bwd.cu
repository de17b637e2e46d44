// Kernel K4: persistent RNN backward (one direction, whole sequence).
//
// Replaces: analytics_zoo_tpu/ops/pallas_rnn.py, _run_bwd_kernel (pallas_call
// at :463, body _rnn_bwd_kernel at :341).  Same contract: the forward's
// inputs pre [B,T,k*H], w [H,k*H] (fp32 or bf16), b [k*H] and n [B], its
// block-start carries cs [ceil(T/U),C,B,H] (K3's residuals), and the
// cotangents g_ys [B,T,H] and g_cf [C,B,H] in; d_pre [B,T,k*H],
// dW [H,k*H] with db [k*H] appended as row H, and d_h0 [C,B,H] out, all
// fp32.  Walking the time blocks in reverse, each block of U steps is
// recomputed forward from its saved carry (hh = h.w + b, h rounded to w's
// type), then swept in reverse: the cell math's VJP, dh += d_hh.W^T in fp32,
// dW += h_in^T.d_hh (h_in rounded to w's type), db += sum_rows d_hh.  A step
// with t >= n passes the carry's cotangent through unchanged and contributes
// nothing.
//
// What bounds it on the H100: the operations, three products of 2*B*H*k*H
// a valid step (recompute, the dh chain, dW): 223 GFLOP for one DS2
// direction at B=8, T=1500, H=1760, ~3.3 ms at 67 TFLOP/s of fp32.  The
// recompute and the dh chain are chains of T dependent products, each step a
// grid-wide dependency; this first design pays two grid barriers and two
// reloads of a 56 KB vector a step, so it runs well above that bound.
//
// Design: ONE cooperative launch keeps G <= #SM blocks resident for the
// whole sweep, as K3 does (the barrier with its timeout trap of
// rnn_common.cuh, an occupancy check before launch).
// Block g owns hidden columns [g*cols, (g+1)*cols) of every gate, so the
// cell math and its VJP stay inside the block.  Shared memory is the trap:
// the recompute needs the block's COLUMN slice of W (W[:, own columns],
// 96 KiB fp32 at DS2), the dh chain its ROW slice (W[own columns, :],
// another 96 KiB), and either product a 56 KB transposed vector beside it:
// both slices at once exceed the 227 KB a block may have.  So the time
// block runs in two phases over ONE slice buffer: the column slice is
// loaded and the U steps are recomputed forward (each step's new h
// published through global memory, L2, behind a grid barrier, its hh kept
// in a small global scratch); then the row slice replaces it and the U
// steps are swept in reverse (each step's d_hh published the same way, then
// every block forms dh for its own columns).  The two 96 KiB slice loads a
// block of U steps are cheap beside its 2U barriers.  The product partition
// of the recompute is K3's, so the recomputed carries equal the forward's
// bit for bit.
//
// dW/db are a reduction over all B*T (row, step) pairs.  The sweep saves
// h_in (the carry each step reads) and d_hh; a second launch reduces them
// in a fixed order, a tiled fp32 product [H+1, B*T] x [B*T, k*H] whose extra
// row of ones gives db.  No atomics: every output is summed by one thread,
// so a run is deterministic.  Products use explicit fmaf (the build's
// -fmad=false only stops the compiler from contracting on its own).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rnn_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;  // batch rows per pass: the register tile
constexpr int kLoads = 4;  // float4 loads a thread keeps in flight (as K3)
enum Cell { kVanilla = 0, kGru = 1, kLstm = 2 };
enum Act { kRelu = 0, kClippedRelu = 1, kTanh = 2 };
// the dW/db launch: 64 x 64 output tiles, 16 (row, step) pairs a stage,
// 4 x 4 outputs a thread
constexpr int kTile = 64, kDepth = 16;

struct Args {
  const float* pre;     // [B, T, kH]
  const float* gys;     // [B, T, H]
  const float* cs;      // [nb, C, B, H] block-start carries
  const void* w;        // [H, kH]
  const float* b;       // [kH]
  const float* gcf;     // [C, B, H]
  const int* n;         // [B] clamped to [0, T]
  float* dpre;          // [B, T, kH]
  float* dh0;           // [C, B, H]
  float* dhh;           // [B, T, kH] d_hh for the dW launch (GRU only; else
                        // it is d_pre itself)
  float* hin;           // [B, T, ldh] the h each step reads
  float* hhs;           // [U, B, kH] hh of the time block's steps
  float* cin;           // [U, B, H] LSTM: the c each step of the block reads
  float* dpub;          // [2, B, ldk] ping-pong: one step's d_hh, all columns
  float* dst;           // [C, B, H] the carry's running cotangent
  unsigned int* bar;    // [2] arrivals, generation (zeroed by the caller)
  int B, T, H, k, C, cell, act, U;
  int ldh, ldk;         // H and kH rounded up to 4 (float4 rows)
  int cols;             // hidden columns a block owns (the last may own fewer)
  int nc;               // k * cols: product columns of the recompute
  int slices_f;         // K-split of the recompute over the threads (as K3)
  int slices_r;         // K-split of the dh chain
};

// `rows` rows of `width` fp32 values (row rr at src + rr * rs, written this
// launch by other blocks: read through L2) transposed into xT[width][kRows],
// rows past `rows` as zeros, rounded to the weight type when kRound.
// Neighbouring threads take neighbouring rows of one float4 column, so
// their transposed stores fall in different banks.  vec: rs and src allow
// float4 loads (rows padded to a multiple of 4).
template <typename T, bool kRound>
__device__ void load_transposed(float* xT, const float* src, size_t rs,
                                int rows, int width, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    const int n4 = kRows * ((width + 3) / 4);
    for (int base = tid; base < n4; base += kLoads * kThreads) {
      float4 v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int idx = base + u * kThreads, rr = idx % kRows;
        v[u] = idx < n4 && rr < rows
                   ? __ldcg(reinterpret_cast<const float4*>(src + rr * rs) +
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
            if (i + e < width)
              xT[(i + e) * kRows + rr] = kRound ? as_weight_type<T>(q[e]) : q[e];
        }
      }
    }
  } else {
    for (int idx = tid; idx < kRows * width; idx += kThreads) {
      const int rr = idx % kRows, i = idx / kRows;
      const float x = rr < rows ? __ldcg(src + rr * rs + i) : 0.f;
      xT[i * kRows + rr] = kRound ? as_weight_type<T>(x) : x;
    }
  }
}

// acc[rr] = sum over i in [i0, i1) of xT[i][rr] * w[i * ldw], in order
template <typename T>
__device__ __forceinline__ void dot_rows(float (&acc)[kRows], const float* xT,
                                         const T* w, int ldw, int i0, int i1) {
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) acc[rr] = 0.f;
  const float4* x4 = reinterpret_cast<const float4*>(xT);
#pragma unroll 4
  for (int i = i0; i < i1; ++i) {
    const float wv = to_f(w[i * ldw]);
    const float4 x = x4[2 * i], y = x4[2 * i + 1];
    acc[0] = fmaf(x.x, wv, acc[0]);
    acc[1] = fmaf(x.y, wv, acc[1]);
    acc[2] = fmaf(x.z, wv, acc[2]);
    acc[3] = fmaf(x.w, wv, acc[3]);
    acc[4] = fmaf(y.x, wv, acc[4]);
    acc[5] = fmaf(y.y, wv, acc[5]);
    acc[6] = fmaf(y.z, wv, acc[6]);
    acc[7] = fmaf(y.w, wv, acc[7]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
persistent_rnn_bwd_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H = a.H, kH = a.k * a.H, cols = a.cols, nc = a.nc;
  float* xT = reinterpret_cast<float*>(smem_raw);        // [kH][kRows]
  float* red = xT + static_cast<size_t>(kH) * kRows;      // [kThreads][kRows]
  T* wS = reinterpret_cast<T*>(red + kThreads * kRows);   // H*nc == kH*cols
  __shared__ int s_tmax;

  const int tid = threadIdx.x;
  const unsigned int nblocks = gridDim.x;
  const int j0 = blockIdx.x * cols;
  const int ncols = min(cols, H - j0);  // >= 1: the grid has no empty block
  const T* w = static_cast<const T*>(a.w);
  const size_t BH = static_cast<size_t>(a.B) * H;
  const size_t hrow = static_cast<size_t>(a.T) * a.ldh;  // hin row stride

  // recompute roles (K3's): product column c (gate g, local column jj),
  // K slice s over the H inputs
  const int fc = tid % nc, fs = tid / nc;
  const bool fmm = fs < a.slices_f && fc % cols < ncols;
  const int fk = (H + a.slices_f - 1) / a.slices_f;
  const int fi0 = fs * fk, fi1 = min(H, fi0 + fk);
  // dh-chain roles: own hidden column rj, K slice s over the kH products
  const int rj = tid % cols, rs = tid / cols;
  const bool rmm = rs < a.slices_r && rj < ncols;
  const int rk = (kH + a.slices_r - 1) / a.slices_r;
  const int rc0 = rs * rk, rc1 = min(kH, rc0 + rk);

  if (tid == 0) {
    int m = 0;
    for (int r = 0; r < a.B; ++r) m = max(m, a.n[r]);
    s_tmax = m;
  }
  // the carry's cotangent starts at g_cf; steps past every row's length
  // pass it through, so the sweep starts at tmax - 1
  for (int idx = tid; idx < a.B * ncols; idx += kThreads) {
    const size_t rjx = static_cast<size_t>(idx / ncols) * H + j0 + idx % ncols;
    for (int ci = 0; ci < a.C; ++ci) a.dst[ci * BH + rjx] = a.gcf[ci * BH + rjx];
  }
  __syncthreads();
  const int tmax = s_tmax;
  const int passes = (a.B + kRows - 1) / kRows;
  {  // d_pre of the steps past every row's length are zeros
    const size_t tail = static_cast<size_t>(a.T - tmax) * a.B * a.k * ncols;
    for (size_t idx = tid; idx < tail; idx += kThreads) {
      const int jl = static_cast<int>(idx % ncols);
      size_t q = idx / ncols;
      const int g = static_cast<int>(q % a.k);
      q /= a.k;
      const int r = static_cast<int>(q % a.B);
      const int t = tmax + static_cast<int>(q / a.B);
      const size_t o = (static_cast<size_t>(r) * a.T + t) * kH + g * H + j0 + jl;
      a.dpre[o] = 0.f;
      if (a.cell == kGru) a.dhh[o] = 0.f;
    }
  }

  int par = 0;  // dpub buffer of the next reverse step
  for (int blk = (tmax + a.U - 1) / a.U - 1; blk >= 0; --blk) {
    const int t0 = blk * a.U, ueff = min(a.U, tmax - t0);
    const float* csb = a.cs + static_cast<size_t>(blk) * a.C * BH;

    // -- phase 1: recompute the block forward with the column slice -------
    __syncthreads();  // every thread is done with wS
    for (int idx = tid; idx < H * nc; idx += kThreads) {
      const int i = idx / nc, cc = idx % nc;
      const int gg = cc / cols, jl = cc % cols;
      wS[idx] = jl < ncols ? w[static_cast<size_t>(i) * kH + gg * H + j0 + jl]
                           : from_f<T>(0.f);
    }
    for (int u = 0; u < ueff; ++u) {
      const int t = t0 + u;
      for (int p = 0; p < passes; ++p) {
        const int r0 = p * kRows, rows = min(kRows, a.B - r0);
        __syncthreads();  // wS loaded; the previous pass is done with xT, red
        // the h this step reads: the saved carry at the block start, else
        // what the previous step published
        if (u == 0)
          load_transposed<T, true>(xT, csb + (a.C - 1) * BH + r0 * H, H, rows,
                                   H, H % 4 == 0);
        else
          load_transposed<T, true>(xT, a.hin + r0 * hrow + t * a.ldh, hrow,
                                   rows, H, true);
        __syncthreads();
        if (fmm) {
          float acc[kRows];
          dot_rows(acc, xT, wS + fc, nc, fi0, fi1);
#pragma unroll
          for (int rr = 0; rr < kRows; ++rr)
            red[(fs * kRows + rr) * nc + fc] = acc[rr];
        }
        __syncthreads();
        // cell math: one thread per (row, column), as K3 computes it
        for (int idx = tid; idx < rows * ncols; idx += kThreads) {
          const int rr = idx / ncols, jl = idx % ncols;
          const int r = r0 + rr, j = j0 + jl;
          const size_t rt = static_cast<size_t>(r) * a.T + t;
          float hh[4], pv[4];
          for (int gg = 0; gg < a.k; ++gg) {
            const int cc = gg * cols + jl;
            float sum = 0.f;
            for (int ss = 0; ss < a.slices_f; ++ss)
              sum += red[(ss * kRows + rr) * nc + cc];
            hh[gg] = sum + a.b[gg * H + j];
            pv[gg] = a.pre[rt * kH + gg * H + j];
            a.hhs[(static_cast<size_t>(u) * a.B + r) * kH + gg * H + j] = hh[gg];
          }
          const size_t rjx = static_cast<size_t>(r) * H + j;
          const float hold = u == 0 ? csb[(a.C - 1) * BH + rjx]
                                    : __ldcg(a.hin + r * hrow + t * a.ldh + j);
          if (u == 0) a.hin[r * hrow + t * a.ldh + j] = hold;
          const bool keep = t < a.n[r];
          float hnew, cold = 0.f, cnew = 0.f;
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
            cold = u == 0 ? csb[rjx] : a.cin[u * BH + rjx];
            if (u == 0) a.cin[rjx] = cold;
            cnew = fg * cold + ig * gg;
            hnew = og * tanhf(cnew);
          }
          if (u + 1 < ueff) {
            a.hin[r * hrow + (t + 1) * a.ldh + j] = keep ? hnew : hold;
            if (a.cell == kLstm) a.cin[(u + 1) * BH + rjx] = keep ? cnew : cold;
          }
        }
      }
      if (u + 1 < ueff) grid_barrier(a.bar, nblocks);
    }

    // -- phase 2: sweep the block in reverse with the row slice -----------
    __syncthreads();  // every thread is done with wS
    for (int idx = tid; idx < cols * kH; idx += kThreads) {
      const int jl = idx / kH, c = idx % kH;
      wS[c * cols + jl] =
          jl < ncols ? w[static_cast<size_t>(j0 + jl) * kH + c] : from_f<T>(0.f);
    }
    for (int u = ueff - 1; u >= 0; --u) {
      const int t = t0 + u;
      float* pub = a.dpub + static_cast<size_t>(par) * a.B * a.ldk;
      __syncthreads();  // the previous step's chain is done with dst
      // the cell math's VJP for every row of the own columns
      for (int idx = tid; idx < a.B * ncols; idx += kThreads) {
        const int r = idx / ncols, jl = idx % ncols, j = j0 + jl;
        const size_t rt = static_cast<size_t>(r) * a.T + t;
        const size_t rjx = static_cast<size_t>(r) * H + j;
        float* dh = a.dst + (a.C - 1) * BH + rjx;
        float dp[4] = {0.f, 0.f, 0.f, 0.f}, dq[4] = {0.f, 0.f, 0.f, 0.f};
        if (t < a.n[r]) {
          float hh[4], pv[4];
          for (int gg = 0; gg < a.k; ++gg) {
            hh[gg] = a.hhs[(static_cast<size_t>(u) * a.B + r) * kH + gg * H + j];
            pv[gg] = a.pre[rt * kH + gg * H + j];
          }
          // the step's output is its new h: both cotangents reach it
          const float gh = *dh + a.gys[rt * H + j];
          if (a.cell == kVanilla) {
            const float z = pv[0] + hh[0];
            float d;
            if (a.act == kRelu) {
              d = z > 0.f ? gh : 0.f;
            } else if (a.act == kClippedRelu) {
              d = z > 0.f && z < 20.f ? gh : 0.f;
            } else {
              const float y = tanhf(z);
              d = gh * (1.f - y * y);
            }
            dp[0] = dq[0] = d;
            *dh = 0.f;  // h feeds the next step only through hh
          } else if (a.cell == kGru) {
            const float hold = a.hin[r * hrow + t * a.ldh + j];
            const float rg = sigmoidf(pv[0] + hh[0]);
            const float zg = sigmoidf(pv[1] + hh[1]);
            const float ng = tanhf(pv[2] + rg * hh[2]);
            const float dn = gh * (1.f - zg);
            const float dz = gh * (hold - ng);
            const float dan = dn * (1.f - ng * ng);
            const float dar = dan * hh[2] * rg * (1.f - rg);
            dp[0] = dq[0] = dar;
            dp[1] = dq[1] = dz * zg * (1.f - zg);
            dp[2] = dan;
            dq[2] = dan * rg;
            *dh = gh * zg;
          } else {
            float* dc = a.dst + rjx;  // LSTM carry slot 0: c
            const float cold = a.cin[u * BH + rjx];
            const float ig = sigmoidf(pv[0] + hh[0]);
            const float fg = sigmoidf(pv[1] + hh[1]);
            const float gg = tanhf(pv[2] + hh[2]);
            const float og = sigmoidf(pv[3] + hh[3]);
            const float tc = tanhf(fg * cold + ig * gg);
            const float dcn = *dc + gh * og * (1.f - tc * tc);
            dp[0] = dq[0] = dcn * gg * ig * (1.f - ig);
            dp[1] = dq[1] = dcn * cold * fg * (1.f - fg);
            dp[2] = dq[2] = dcn * ig * (1.f - gg * gg);
            dp[3] = dq[3] = gh * tc * og * (1.f - og);
            *dc = dcn * fg;
            *dh = 0.f;
          }
        }  // else: a masked step passes the carry's cotangent through
        for (int gg = 0; gg < a.k; ++gg) {
          const size_t o = rt * kH + gg * H + j;
          a.dpre[o] = dp[gg];
          if (a.cell == kGru) a.dhh[o] = dq[gg];
          pub[static_cast<size_t>(r) * a.ldk + gg * H + j] = dq[gg];
        }
      }
      grid_barrier(a.bar, nblocks);
      // dh += d_hh . W^T over all k*H products, for the own columns
      for (int p = 0; p < passes; ++p) {
        const int r0 = p * kRows, rows = min(kRows, a.B - r0);
        if (p) __syncthreads();  // the previous pass is done with xT, red
        load_transposed<T, false>(xT, pub + static_cast<size_t>(r0) * a.ldk,
                                  a.ldk, rows, kH, true);
        __syncthreads();
        if (rmm) {
          float acc[kRows];
          dot_rows(acc, xT, wS + rj, cols, rc0, rc1);
#pragma unroll
          for (int rr = 0; rr < kRows; ++rr)
            red[(rs * kRows + rr) * cols + rj] = acc[rr];
        }
        __syncthreads();
        for (int idx = tid; idx < rows * ncols; idx += kThreads) {
          const int rr = idx / ncols, jl = idx % ncols;
          float sum = 0.f;
          for (int ss = 0; ss < a.slices_r; ++ss)
            sum += red[(ss * kRows + rr) * cols + jl];
          a.dst[(a.C - 1) * BH + static_cast<size_t>(r0 + rr) * H + j0 + jl] += sum;
        }
      }
      par ^= 1;
    }
  }

  __syncthreads();
  for (int idx = tid; idx < a.B * ncols; idx += kThreads) {
    const size_t rjx = static_cast<size_t>(idx / ncols) * H + j0 + idx % ncols;
    for (int ci = 0; ci < a.C; ++ci) a.dh0[ci * BH + rjx] = a.dst[ci * BH + rjx];
  }
}

// dwb[i][c] = sum over rows r < B and steps t < max(n) of A[i][(r,t)] *
// dhh[r,t,c], with A = h_in rounded to the weight type for i < H and 1 for
// i == H (db).  One thread sums 4 x 4 outputs, each over the (r, t) pairs in
// order; the masked steps' d_hh are zeros.
template <typename W>
__global__ void __launch_bounds__(kThreads)
rnn_bwd_dw_kernel(const float* hin, const float* dhh, const int* n,
                  float* dwb, int B, int T, int H, int kH, int ldh) {
  __shared__ __align__(16) float As[kDepth][kTile];
  __shared__ __align__(16) float Bs[kDepth][kTile];
  __shared__ int s_tmax;
  const int tid = threadIdx.x;
  if (tid == 0) {
    int m = 0;
    for (int r = 0; r < B; ++r) m = max(m, n[r]);
    s_tmax = m;
  }
  __syncthreads();
  const int tmax = s_tmax;
  const int K = B * tmax;
  const int i0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) acc[x][y] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kDepth) {
#pragma unroll
    for (int q = 0; q < kDepth * kTile / kThreads; ++q) {
      const int idx = tid + q * kThreads, kk = idx / kTile, ii = idx % kTile;
      const int kx = k0 + kk;
      float av = 0.f, bv = 0.f;
      if (kx < K) {
        const size_t rt =
            static_cast<size_t>(kx / tmax) * T + kx % tmax;  // (r, t)
        const int i = i0 + ii, c = c0 + ii;
        if (i < H) av = as_weight_type<W>(hin[rt * ldh + i]);
        else if (i == H) av = 1.f;
        if (c < kH) bv = dhh[rt * kH + c];
      }
      As[kk][ii] = av;
      Bs[kk][ii] = bv;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ax[4] = {av.x, av.y, av.z, av.w};
      const float bx[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(ax[x], bx[y], acc[x][y]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int i = i0 + ty * 4 + x;
    if (i > H) continue;
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int c = c0 + tx * 4 + y;
      if (c < kH) dwb[static_cast<size_t>(i) * kH + c] = acc[x][y];
    }
  }
}

int gates_of(int cell) { return cell == kVanilla ? 1 : cell == kGru ? 3 : 4; }

// Shared memory one sweep block needs (bytes), for `sms` resident blocks:
// the transposed vector (kH x 8), the split-K partials and the W slice;
// ops/pallas_rnn.py::hopper_bwd_smem_bytes repeats it.
long long bwd_smem_bytes(int H, int cell, int sms, int wbytes) {
  const long long cols = (H + sms - 1) / sms;
  const long long kH = static_cast<long long>(gates_of(cell)) * H;
  return 4ll * (kH * kRows + kThreads * kRows) + kH * cols * wbytes;
}

}  // namespace

extern "C" {

const char* az_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launch K4 on `stream`: the cooperative sweep, then the dW/db reduction.
// pre, gys, cs, b, gcf fp32; w fp32 (w_bf16 = 0) or bf16; n int32 clamped
// to [0, T].  Outputs dpre [B,T,kH], dwb [H+1,kH] (dW, then db) and dh0
// [C,B,H] fp32.  Scratch: dhh [B,T,kH] (GRU; else pass dpre), hin
// [B,T,round_up(H,4)], hhs [U,B,kH], cin [U,B,H], dpub [2,B,round_up(kH,4)],
// dst [C,B,H]; bar two zeroed words.  Returns the cudaError_t of the
// launches (0 = launched); a geometry whose blocks cannot all be resident,
// or whose W slice does not fit in shared memory, is refused.
int az_persistent_rnn_bwd(const float* pre, const float* gys, const float* cs,
                          const void* w, int w_bf16, const float* b,
                          const float* gcf, const int* n, float* dpre,
                          float* dwb, float* dh0, float* dhh, float* hin,
                          float* hhs, float* cin, float* dpub, float* dst,
                          unsigned int* bar, int B, int T, int H, int cell,
                          int act, int U, void* stream) {
  int dev = 0, sms = 0, coop = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  if (U < 1) return static_cast<int>(cudaErrorInvalidValue);

  const int k = gates_of(cell), kH = k * H;
  const int cols = (H + sms - 1) / sms;
  const int grid = (H + cols - 1) / cols;
  const int nc = k * cols;
  if (nc > kThreads) return static_cast<int>(cudaErrorInvalidValue);

  const void* fn = w_bf16
      ? reinterpret_cast<const void*>(&persistent_rnn_bwd_kernel<__nv_bfloat16>)
      : reinterpret_cast<const void*>(&persistent_rnn_bwd_kernel<float>);
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long need = bwd_smem_bytes(H, cell, sms, w_bf16 ? 2 : 4);
  if (need > optin - static_cast<long long>(attr.sharedSizeBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(need);
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                    smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm * sms < grid)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);

  Args a{pre, gys, cs, w, b, gcf, n, dpre, dh0, dhh, hin, hhs, cin, dpub,
         dst, bar, B, T, H, k, cell == kLstm ? 2 : 1, cell, act, U,
         (H + 3) / 4 * 4, (kH + 3) / 4 * 4, cols, nc, kThreads / nc,
         kThreads / cols};
  void* params[] = {&a};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), params, smem,
                                  st);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  const dim3 tiles((kH + kTile - 1) / kTile, (H + 1 + kTile - 1) / kTile);
  const float* dhh_in = cell == kGru ? dhh : dpre;
  const int ldh = (H + 3) / 4 * 4;
  if (w_bf16)
    rnn_bwd_dw_kernel<__nv_bfloat16><<<tiles, kThreads, 0, st>>>(
        hin, dhh_in, n, dwb, B, T, H, kH, ldh);
  else
    rnn_bwd_dw_kernel<float><<<tiles, kThreads, 0, st>>>(hin, dhh_in, n, dwb,
                                                          B, T, H, kH, ldh);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
