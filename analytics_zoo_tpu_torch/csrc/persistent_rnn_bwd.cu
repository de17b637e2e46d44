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
// recompute and the dh chain are chains of T dependent products, each step
// a grid-wide dependency, so what a step costs is its barrier and the
// delivery of its 56 KB vector, as in K3; dW, a reduction over all B*T
// (row, step) pairs, is a plain fp32 product bound by its FMAs.
//
// Design: ONE cooperative launch keeps G <= #SM blocks resident for the
// whole sweep, as K3 does, on the same step engine (rnn_common.cuh).  Block
// g owns hidden columns [g*cols, (g+1)*cols) of every gate, so the cell
// math and its VJP stay inside the block.  Both slices of W stay resident
// for the whole launch: the recompute's COLUMN slice (W[:, own columns])
// split between registers and shared memory (read from L2 where the
// shared part does not fit), the dh chain's ROW slice
// (W[own columns, :], 96 KiB fp32 at DS2) in shared memory beside one
// delivery buffer that the two chains take in turns.  So a time block costs
// no slice loads, and time_block only sets the size of the scratch.  The
// recompute calls K3's forward_step with K3's partition, so the carries it
// rebuilds equal the forward's bit for bit; each step's new h goes out
// through the ping-pong delivery buffer and one barrier.  The dh chain
// publishes each step's d_hh the same way, in the [k*H][8] layout its
// product reads: one barrier, one bulk delivery, and a product of 8 rows x 2
// own columns a thread over a K-slice of the k*H products.  The carry's
// running cotangent lives in d_h0 itself.
//
// dW/db: the sweep saves h_in (the carry each step reads) and d_hh; a
// second launch reduces them in a fixed order, a tiled fp32 product
// [H+1, B*T] x [B*T, k*H] whose extra row of ones gives db: 128 x 64 tiles,
// 8 x 8 outputs a thread, the next depth stage loaded into registers while
// the current one is multiplied.  No atomics: every output is summed by one
// thread, so a run is deterministic.  Products use explicit fmaf (the
// build's -fmad=false only stops the compiler from contracting on its own).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rnn_common.cuh"

namespace {

// the dW/db launch: 128 x 64 output tiles, 16 (row, step) pairs a stage,
// 8 x 8 outputs a thread
constexpr int kTI = 128, kTC = 64, kTK = 16, kDwThreads = 128;

struct Args {
  const float* pre;     // [B, T, kH]
  const float* gys;     // [B, T, H]
  const float* cs;      // [nb, C, B, H] block-start carries
  const void* w;        // [H, kH]
  const float* b;       // [kH]
  const float* gcf;     // [C, B, H]
  const int* n;         // [B] clamped to [0, T]
  float* dpre;          // [B, T, kH]
  float* dh0;           // [C, B, H]: the carry's running cotangent
  float* dhh;           // [B, T, kH] d_hh for the dW launch (GRU only; else
                        // it is d_pre itself)
  float* hin;           // [B, T, ldh] the h each step reads
  float* hhs;           // [U, B, kH] hh of the time block's steps
  float* cin;           // [U, B, H] LSTM: the c each step of the block reads
  float* hg;            // [2, passes, H, kRows] delivered h (rows >= B zero)
  float* dg;            // [2, passes, kH, kRows] delivered d_hh (the same)
  unsigned int* bar;    // arrival counter (zeroed by the caller)
  unsigned long long* stamps;  // step-phase stamps, or null
  int B, T, C, cell, act, U, ldh;
  Geom g;
};

__host__ __device__ inline size_t red_floats(const Geom& g) {
  const size_t f = static_cast<size_t>(g.S) * kRows * 2 * g.CP;
  const size_t r = static_cast<size_t>(g.Sr) * kRows * 2 * g.CPr;
  return round4(f > r ? f : r);
}
// Shared memory (bytes) besides the column slice: one delivery buffer for
// the kH-wide vector, the split-K partial sums, the block's bias, the row
// slice.  ops/pallas_rnn.py::hopper_bwd_smem_bytes repeats it.
__host__ __device__ inline size_t bwd_base_bytes(const Geom& g, int wbytes) {
  return 4 * (round4(static_cast<size_t>(g.kH) * kRows) + red_floats(g) +
              round4(g.nc)) +
         (static_cast<size_t>(g.kH) * 2 * g.CPr * wbytes + 15) / 16 * 16;
}
// The shared part of a kWSplit column slice (bytes).
__host__ __device__ inline size_t split_bytes(const Geom& g, int wbytes) {
  return static_cast<size_t>(g.S) * max(0, g.klen - kSplitK) * 2 * g.CP *
         wbytes;
}

template <typename T, int kSrc, int kCl>
__global__ void __launch_bounds__(kThreads, 1)
persistent_rnn_bwd_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t s_bar;
  __shared__ int s_tmax;
  const Geom g = a.g;
  const int H = g.H, kH = g.kH, cols = g.cols;
  float* xT = reinterpret_cast<float*>(smem_raw);        // [kH][kRows]
  float* red = xT + round4(static_cast<size_t>(kH) * kRows);
  float* bS = red + red_floats(g);                        // [k][cols]
  T* wR = reinterpret_cast<T*>(bS + round4(g.nc));        // [kH][2*CPr]
  T* wS = reinterpret_cast<T*>(smem_raw + bwd_base_bytes(g, sizeof(T)));

  const int tid = threadIdx.x;
  const unsigned int G = gridDim.x;
  const int j0 = blockIdx.x * cols;
  const int ncols = min(cols, H - j0);  // >= 1: the grid has no empty block
  const T* W = static_cast<const T*>(a.w);
  const size_t BH = static_cast<size_t>(a.B) * H;
  const size_t vplane = static_cast<size_t>(g.passes) * H * kRows;
  const size_t dplane = static_cast<size_t>(g.passes) * kH * kRows;
  float* dst = a.dh0;

  Delivery dlv;
  delivery_init(dlv, &s_bar);
  ColSlice<T, kSrc> w;
  col_slice_load(w, W, wS, g, j0, ncols);
  // the row slice: wR[c][jl] = W[j0 + jl][c], own columns in pairs
  const int ldr = 2 * g.CPr;
  for (int idx = tid; idx < kH * ldr; idx += kThreads) {
    const int c = idx / ldr, jl = idx % ldr;
    wR[idx] = jl < ncols ? W[static_cast<size_t>(j0 + jl) * kH + c]
                         : from_f<T>(0.f);
  }
  if (tid == 0) {
    int m = 0;
    for (int r = 0; r < a.B; ++r) m = max(m, a.n[r]);
    s_tmax = m;
  }
  for (int c = tid; c < g.nc; c += kThreads)
    bS[c] = c % cols < ncols ? a.b[(c / cols) * H + j0 + c % cols] : 0.f;
  // the carry's cotangent starts at g_cf; steps past every row's length
  // pass it through, so the sweep starts at tmax - 1
  for (int idx = tid; idx < a.B * ncols; idx += kThreads) {
    const size_t rj = static_cast<size_t>(idx / ncols) * H + j0 + idx % ncols;
    for (int ci = 0; ci < a.C; ++ci) dst[ci * BH + rj] = a.gcf[ci * BH + rj];
  }
  __syncthreads();
  const int tmax = s_tmax;
  {  // d_pre of the steps past every row's length are zeros
    const size_t tail = static_cast<size_t>(a.T - tmax) * a.B * g.k * ncols;
    for (size_t idx = tid; idx < tail; idx += kThreads) {
      const int jl = static_cast<int>(idx % ncols);
      size_t q = idx / ncols;
      const int gg = static_cast<int>(q % g.k);
      q /= g.k;
      const int r = static_cast<int>(q % a.B);
      const int t = tmax + static_cast<int>(q / a.B);
      const size_t o = (static_cast<size_t>(r) * a.T + t) * kH + gg * H + j0 + jl;
      a.dpre[o] = 0.f;
      if (a.cell == kGru) a.dhh[o] = 0.f;
    }
  }
  // the rounded block-start h of block blk into delivery buffer hb
  auto publish_start = [&](int blk, int hb) {
    const float* hs = a.cs + (static_cast<size_t>(blk) * a.C + a.C - 1) * BH;
    for (int idx = tid; idx < a.B * ncols; idx += kThreads) {
      const int r = idx / ncols, j = j0 + idx % ncols;
      a.hg[hb * vplane + vec_index(r, j, H)] =
          as_weight_type<T>(hs[static_cast<size_t>(r) * H + j]);
    }
  };

  const int nblk = (tmax + a.U - 1) / a.U;
  int hb = 0;   // delivery buffer of the recompute's next h
  int par = 0;  // delivery buffer of the dh chain's next d_hh
  if (nblk > 0) publish_start(nblk - 1, hb);
  unsigned int epoch = 0;
  grid_sync(a.bar, ++epoch * G);  // also: both slices loaded

  // dh-chain roles: own column pair rcp, K-slice rs over the kH products
  const int rcp = tid % g.CPr, rs = tid / g.CPr;
  const bool ractive = rs < g.Sr;
  const int rc0 = min(kH, rs * g.klenr), rc1 = min(kH, rc0 + g.klenr);
  int nf = 0, nr = 0;  // steps of each chain so far (stamps)

  for (int blk = nblk - 1; blk >= 0; --blk) {
    const int t0 = blk * a.U, ueff = min(a.U, tmax - t0);
    const float* csb = a.cs + static_cast<size_t>(blk) * a.C * BH;

    // -- the recompute: K3's step over the block, from its saved carry ----
    for (int u = 0; u < ueff; ++u, ++nf) {
      const int t = t0 + u;
      stamp(a.stamps, 0, nf, 0);
      for (int p = 0; p < g.passes; ++p) {
        const int r0 = p * kRows, rows = min(kRows, a.B - r0);
        // the previous pass, or the dh chain before the block, is done
        // with red, and (cluster) every block of the cluster with xT
        if (p || u == 0) {
          if constexpr (kCl > 1) cluster_sync();
          else __syncthreads();
        }
        forward_step<true, kCl>(
            g, w, dlv, a.hg + hb * vplane + static_cast<size_t>(p) * H * kRows,
            xT, red, bS, ncols, rows, a.cell, a.act,
            StampAt{p == 0 ? a.stamps : nullptr, 0, nf}, [] {}, [] {},
            [&](int rr, int gg, int jl) {
              return a.pre[(static_cast<size_t>(r0 + rr) * a.T + t) * kH +
                           gg * H + j0 + jl];
            },
            [&](int rr, int jl, float* hold, float* cold) {
              const int r = r0 + rr, j = j0 + jl;
              const size_t rj = static_cast<size_t>(r) * H + j;
              *hold = u == 0 ? csb[(a.C - 1) * BH + rj]
                             : a.hin[(static_cast<size_t>(r) * a.T + t) * a.ldh + j];
              if (a.cell == kLstm) *cold = u == 0 ? csb[rj] : a.cin[u * BH + rj];
            },
            [&](int rr, int jl, float hnew, float hold, float cnew, float cold,
                const float* hh) {
              const int r = r0 + rr, j = j0 + jl;
              const size_t rj = static_cast<size_t>(r) * H + j;
              const size_t rt = static_cast<size_t>(r) * a.T + t;
#pragma unroll
              for (int gg = 0; gg < 4; ++gg)
                if (gg < g.k) a.hhs[(static_cast<size_t>(u) * a.B + r) * kH + gg * H + j] =
                    hh[gg];
              if (u == 0) {
                a.hin[rt * a.ldh + j] = hold;
                if (a.cell == kLstm) a.cin[rj] = cold;
              }
              if (u + 1 < ueff) {
                const bool keep = t < __ldg(a.n + r);
                const float hk = keep ? hnew : hold;
                a.hin[(rt + 1) * a.ldh + j] = hk;
                if (a.cell == kLstm) a.cin[(u + 1) * BH + rj] = keep ? cnew : cold;
                a.hg[(hb ^ 1) * vplane + vec_index(r, j, H)] =
                    as_weight_type<T>(hk);
              }
            });
      }
      stamp(a.stamps, 0, nf, 3);
      if (u + 1 < ueff) {
        grid_sync(a.bar, ++epoch * G);
        hb ^= 1;
      }
      stamp(a.stamps, 0, nf, 4);
    }

    // -- the dh chain: the block in reverse, with the row slice -----------
    for (int u = ueff - 1; u >= 0; --u, ++nr) {
      const int t = t0 + u;
      float* pub = a.dg + par * dplane;
      stamp(a.stamps, 1, nr, 0);
      __syncthreads();  // the previous step's sums are done with dst
      // the cell math's VJP for every row of the own columns
      for (int idx = tid; idx < a.B * ncols; idx += kThreads) {
        const int r = idx / ncols, jl = idx % ncols, j = j0 + jl;
        const size_t rt = static_cast<size_t>(r) * a.T + t;
        const size_t rj = static_cast<size_t>(r) * H + j;
        float* dh = dst + (a.C - 1) * BH + rj;
        float dp[4] = {0.f, 0.f, 0.f, 0.f}, dq[4] = {0.f, 0.f, 0.f, 0.f};
        if (t < __ldg(a.n + r)) {
          float hh[4], pv[4];
#pragma unroll
          for (int gg = 0; gg < 4; ++gg) {
            hh[gg] = pv[gg] = 0.f;
            if (gg >= g.k) continue;
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
            const float hold = a.hin[rt * a.ldh + j];
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
            float* dc = dst + rj;  // LSTM carry slot 0: c
            const float cold = a.cin[u * BH + rj];
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
#pragma unroll
        for (int gg = 0; gg < 4; ++gg) {
          if (gg >= g.k) continue;
          const size_t o = rt * kH + gg * H + j;
          a.dpre[o] = dp[gg];
          if (a.cell == kGru) a.dhh[o] = dq[gg];
          pub[vec_index(r, gg * H + j, kH)] = dq[gg];
        }
      }
      // the next block's recompute starts from its saved carry
      if (u == 0 && blk > 0) publish_start(blk - 1, hb ^ 1);
      stamp(a.stamps, 1, nr, 3);
      grid_sync(a.bar, ++epoch * G);
      stamp(a.stamps, 1, nr, 4);
      // dh += d_hh . W^T over all k*H products, for the own columns
      for (int p = 0; p < g.passes; ++p) {
        const int r0 = p * kRows, rows = min(kRows, a.B - r0);
        if (p) {  // the previous pass is done with red (and xT)
          if constexpr (kCl > 1) cluster_sync();
          else __syncthreads();
        }
        deliver<kCl>(dlv, xT, pub + static_cast<size_t>(p) * kH * kRows, kH);
        if (ractive) {
          delivery_wait(dlv);
          if (p == 0) stamp(a.stamps, 1, nr, 1);
          float acc[kRows][2];
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[r][0] = acc[r][1] = 0.f;
          const float4* x4 = reinterpret_cast<const float4*>(xT);
          const T* wp = wR + 2 * rcp;
#pragma unroll 4
          for (int c = rc0; c < rc1; ++c) {
            const float2 wv = pair_f(wp + static_cast<size_t>(c) * ldr);
            fma_tile(acc, x4[2 * c], x4[2 * c + 1], wv.x, wv.y);
          }
          store_partials(red, acc, ldr, g.Sr, rcp, rs);
        }
        __syncthreads();
        if (p == 0) stamp(a.stamps, 1, nr, 2);
        delivery_done(dlv);
        for (int idx = tid; idx < rows * ncols; idx += kThreads) {
          const int rr = idx / ncols, jl = idx % ncols;
          dst[(a.C - 1) * BH + static_cast<size_t>(r0 + rr) * H + j0 + jl] +=
              sum_partials(red, rr, jl, ldr, g.Sr);
        }
      }
      par ^= 1;
    }
    if (blk > 0) hb ^= 1;
  }
}

// dwb[i][c] = sum over rows r < B and steps t < max(n) of A[i][(r,t)] *
// dhh[r,t,c], with A = h_in rounded to the weight type for i < H and 1 for
// i == H (db).  One thread sums 8 x 8 outputs, each over the (r, t) pairs in
// order; the masked steps' d_hh are zeros.  Thread (ty, tx) owns rows
// ty*4 + {0..3} and 64 + ty*4 + {0..3} of the tile, columns tx*4 + {0..3}
// and 32 + tx*4 + {0..3}: its 16-byte loads of a stage fall in distinct
// banks.
template <typename W>
__global__ void __launch_bounds__(kDwThreads)
rnn_bwd_dw_kernel(const float* hin, const float* dhh, const int* n,
                  float* dwb, int B, int T, int H, int kH, int ldh) {
  __shared__ __align__(16) float As[2][kTK][kTI];
  __shared__ __align__(16) float Bs[2][kTK][kTC];
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
  const int i0 = blockIdx.y * kTI, c0 = blockIdx.x * kTC;
  const int tx = tid % 8, ty = tid / 8;
  const bool bvec = kH % 4 == 0;

  // one stage: A 16 x 128 (4 float4 a thread), B 16 x 64 (2 float4)
  float4 ra[4], rb[2];
  auto load = [&](int k0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int idx = tid + q * kDwThreads, kk = idx / 32;
      const int i = i0 + 4 * (idx % 32), kx = k0 + kk;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (kx < K) {
        const float* src =
            hin + (static_cast<size_t>(kx / tmax) * T + kx % tmax) * ldh;
        if (i + 3 < H) {
          const float4 x = __ldg(reinterpret_cast<const float4*>(src + i));
          v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = as_weight_type<W>(v[e]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[e] = i + e < H ? as_weight_type<W>(src[i + e])
                             : i + e == H ? 1.f : 0.f;
        }
      }
      ra[q] = make_float4(v[0], v[1], v[2], v[3]);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int idx = tid + q * kDwThreads, kk = idx / 16;
      const int c = c0 + 4 * (idx % 16), kx = k0 + kk;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (kx < K) {
        const float* src =
            dhh + (static_cast<size_t>(kx / tmax) * T + kx % tmax) * kH;
        if (bvec && c + 3 < kH) {
          const float4 x = __ldg(reinterpret_cast<const float4*>(src + c));
          v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = c + e < kH ? src[c + e] : 0.f;
        }
      }
      rb[q] = make_float4(v[0], v[1], v[2], v[3]);
    }
  };
  auto store = [&](int s) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int idx = tid + q * kDwThreads;
      *reinterpret_cast<float4*>(&As[s][idx / 32][4 * (idx % 32)]) = ra[q];
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int idx = tid + q * kDwThreads;
      *reinterpret_cast<float4*>(&Bs[s][idx / 16][4 * (idx % 16)]) = rb[q];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int x = 0; x < 8; ++x)
#pragma unroll
    for (int y = 0; y < 8; ++y) acc[x][y] = 0.f;

  int cur = 0;
  if (K > 0) {
    load(0);
    store(0);
  }
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += kTK) {
    const bool more = k0 + kTK < K;
    if (more) load(k0 + kTK);  // in flight while this stage is multiplied
#pragma unroll
    for (int kk = 0; kk < kTK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[cur][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[cur][kk][32 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int x = 0; x < 8; ++x)
#pragma unroll
        for (int y = 0; y < 8; ++y) acc[x][y] = fmaf(av[x], bv[y], acc[x][y]);
    }
    if (more) store(cur ^ 1);
    __syncthreads();
    cur ^= 1;
  }
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    const int i = i0 + (x < 4 ? ty * 4 + x : 64 + ty * 4 + x - 4);
    if (i > H) continue;
#pragma unroll
    for (int y = 0; y < 8; ++y) {
      const int c = c0 + (y < 4 ? tx * 4 + y : 32 + tx * 4 + y - 4);
      if (c < kH) dwb[static_cast<size_t>(i) * kH + c] = acc[x][y];
    }
  }
}

template <typename T, int kCl>
const void* sweep_for(int src) {
  return src == kWSplit ? reinterpret_cast<const void*>(
                              &persistent_rnn_bwd_kernel<T, kWSplit, kCl>)
                        : reinterpret_cast<const void*>(
                              &persistent_rnn_bwd_kernel<T, kWGlobal, kCl>);
}

const void* sweep_for(int w_bf16, int src, int cl) {
  return w_bf16 ? (cl == 2 ? sweep_for<__nv_bfloat16, 2>(src)
                           : sweep_for<__nv_bfloat16, 1>(src))
                : (cl == 2 ? sweep_for<float, 2>(src)
                           : sweep_for<float, 1>(src));
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
// [B,T,round_up(H,4)], hhs [U,B,kH], cin [U,B,H], and the delivery buffers
// hg [2,ceil(B/8),H,8] and dg [2,ceil(B/8),kH,8] as zeros; bar one zeroed
// word; stamps null or the step-phase stamp buffer.  w_source (if not null)
// gets where the column slice lives (2 L2, 3 split between registers and
// shared memory).  Returns the cudaError_t of the launches (0 = launched);
// a geometry whose blocks cannot all be resident, or whose row slice does
// not fit in shared memory, is refused.
int az_persistent_rnn_bwd(const float* pre, const float* gys, const float* cs,
                          const void* w, int w_bf16, const float* b,
                          const float* gcf, const int* n, float* dpre,
                          float* dwb, float* dh0, float* dhh, float* hin,
                          float* hhs, float* cin, float* hg, float* dg,
                          unsigned int* bar, int B, int T, int H, int cell,
                          int act, int U, unsigned long long* stamps,
                          int* w_source, void* stream) {
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
  const int wb = w_bf16 ? 2 : 4;
  const size_t base = bwd_base_bytes(g, wb);
  // the column slice: its first kSplitK rows a thread in registers and the
  // rest in shared memory when that fits beside the rest, else in L2 (the
  // whole slice in shared memory never fits where the split does not)
  const int cl = cluster_for(g.G);
  int src = kWSplit;
  const void* fn = sweep_for(w_bf16, src, cl);
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t limit = optin - attr.sharedSizeBytes;
  if (base > limit) return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = base + split_bytes(g, wb);
  if (smem > limit) {
    src = kWGlobal;
    fn = sweep_for(w_bf16, src, cl);
    smem = base;
  }
  e = check_resident(fn, smem, g.G, sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (w_source) *w_source = src;

  const int ldh = (H + 3) / 4 * 4;
  Args a{pre, gys, cs, w, b, gcf, n, dpre, dh0, dhh, hin, hhs, cin, hg, dg,
         bar, stamps, B, T, cell == kLstm ? 2 : 1, cell, act, U, ldh, g};
  void* params[] = {&a};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = launch_persistent(fn, g.G, smem, params, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  const dim3 tiles((g.kH + kTC - 1) / kTC, (H + 1 + kTI - 1) / kTI);
  const float* dhh_in = cell == kGru ? dhh : dpre;
  if (w_bf16)
    rnn_bwd_dw_kernel<__nv_bfloat16><<<tiles, kDwThreads, 0, st>>>(
        hin, dhh_in, n, dwb, B, T, H, g.kH, ldh);
  else
    rnn_bwd_dw_kernel<float><<<tiles, kDwThreads, 0, st>>>(
        hin, dhh_in, n, dwb, B, T, H, g.kH, ldh);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
