// The backward of the Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// The Pallas TPU kernel repro/kernels/ssd/kernel.py (_ssd_kernel) has no
// backward: the JAX package differentiates its jnp scan
// (repro/models/ssm.py::ssd_chunked) with jax.value_and_grad. This computes
// that VJP; the port's forward kernel is csrc/ssd.cu. Per (batch, head), over
// chunks of Q positions with seg = cumsum(dt A) and w_s = exp(total - seg_s)
// dt_s, the forward is
//   y_t   = sum_{s<=t} (C_t.B_s) exp(seg_t - seg_s) dt_s x_s
//         + exp(seg_t) C_t . S_in + D x_t
//   S_out = exp(total) S_in + sum_s w_s x_s B_s^T         (P x N)
// Given dy and the final state's gradient, it returns dx, ddt (fp32), dA and
// dD (H,), dB and dC (summed over each group's heads, in B's dtype) and the
// initial state's gradient.
//
// Five kernels on the caller's stream, in two variants chosen by the wrapper
// before the launch (kernels/ssd/ops.py:_ssd_bwd_variant), all reductions in
// a fixed order (no atomics: every output is the same bit for bit from run
// to run):
//  1. the chunk state kernel, a block per (chunk, head, batch): the chunk's
//     state contribution sum_s w_s x_s B_s^T and U = sum_t exp(seg_t) dy_t
//     C_t^T, both (P x N) fp32, and the chunk's total;
//  2. state_scan_kernel (shared), a thread per (batch, head, state
//     element): the state entering each chunk, S_in, forward over the
//     chunks, and the gradient of each chunk's outgoing state, dS =
//     exp(total) dS' + U', backward over them (the one leaving chunk 0 is
//     the initial state's);
//  3. the chunk gradient kernel, a block per (chunk, head, batch): every
//     gradient of the chunk from its S_in and dS: dx and the head's dB over
//     the column positions s, the head's dC over the row positions t, seg's
//     gradient from the score tiles' row and column sums and the state
//     terms, then its reverse cumsum into ddt and the chunk's dA share;
//  4. group_sum_kernel (shared): dB and dC summed over the heads of each
//     group in head order from per-head fp32 scratch, rounded once;
//  5. head_sum_kernel (shared): dA and dD summed over (batch, chunk) in
//     order.
//
// What bounds it on the H100, at Mamba2-1.3B's training shape x (2, 2048,
// 64, 64) bf16, B and C (2, 2048, 1, 128), chunk 256: its operations. Taken
// at their least (C.B^T once per group, the causal triangle only, five
// (q x P x N) state products a head: the chunk state, U, dS.B, x^T.dS and
// S_in^T.dy, from which seg's state share also comes), the products are
// ~47.5 GFLOP a layer, ~0.048 ms on the bf16 tensor cores; its bytes (x,
// dy, dx ~101 MB, dt and ddt ~2 MB, B, C, dB and dC ~4 MB, each read or
// written once) are ~107 MB, ~0.032 ms.
//
// "tc", bf16 with 16-byte-aligned rows, P and N in {16, 32, 64, 128}, the
// whole chunk within shared memory (P = 128 up to chunks of 176): every
// product on the tensor cores (mma.sync.m16n8k16, bf16 in, fp32
// accumulators), with the forward's building blocks (csrc/ssd.cu:
// swizzled tiles, cp.async, ldmatrix). Kernel 1 walks the chunk in tiles of
// 64 positions, two stages in flight, each warp owning 16 x 16 units of both
// (P x N) outputs; x (.) w and dy (.) exp(seg) are read transposed by
// ldmatrix.trans and rounded to bf16. Kernel 3 holds the chunk's x, dy, B
// and C in shared memory (222 KB at the training shape) and gives each warp
// whole 16-position groups in a zigzag, so the triangle's work is even and
// no barrier stands between the groups. A column walk per group s holds x_s
// and B_s as A fragments, starts dx_s and dB_s at their state terms w_s (B_s
// dS^T) and w_s (x_s dS) and d w_s = x_s . (B_s dS^T), then over every group
// t >= s forms G^T = x_s dy_t^T and (C B^T)^T = B_s C_t^T, applies the decay
// as a row factor times a column factor (exact on the diagonal group, with
// the mask) and dt_s in registers, and rounds the scores and dCB straight
// into the A fragments of dx_s += scores^T dy_t and dB_s += dCB^T C_t; the
// sums over t of G C.B L and G scores (ddt's and seg's shares) stay in
// registers and are reduced over the quad at the end. A row walk per group
// t recomputes G and C.B^T for every s <= t (on the tensor cores a product
// costs less than a trip through memory), keeps dC_t's accumulators in
// registers from its state term exp(seg_t) (dy_t S_in) to the last column,
// and takes seg's share through it as C_t . dC_t's state term. The tail
// (seg's gradient, its reverse cumsum, ddt and the dA and dD sums) runs over
// the whole block: runs of positions a thread, shuffles, warp totals in
// order. The products round four fp32 operands to bf16: dS and S_in (the
// state terms), the scores (dx) and dCB (dB, dC), plus the chunk state's x
// (.) w and dy (.) exp(seg); G, C.B^T, the score sums, the scans and every
// sum stay fp32. tests/test_torch_ssm.py holds a plain model of exactly these
// roundings against jax.vjp within 2e-2 of each gradient's scale, and the
// 2-layer gradient check of chip_smoke.py (bound 0.02) reads 0.0125 at its
// worst leaf with them, so no product needed TF32 or a split operand.
// What holds it at ~14x its bound (~0.68 ms a layer on an H100, kernel 3
// 0.40 of it): kernel 3 fits one 8-warp block an SM (222 KB of shared
// memory, ~245 registers a thread), and its walks are paced by latency, not
// by the products alone. repro_torch/analysis/ssd_bwd_phases.py stamps the
// clock in each warp: of a block's clocks up to the tail, the whole-chunk
// load takes ~22% (it overlaps nothing), the column walk ~44% and the row
// walk ~31%; without its dx and dB products (half its MMAs) the column walk
// is only ~17% shorter. The per-head fp32 scratch for dB and dC (268 MB
// written by kernel 3 and read by kernel 4, ~0.1 ms, at the training
// shape) costs as much again: with its rows replaced by a checksum each
// walk is ~17% shorter, even with the tiles going out 16 bytes a lane
// (store_tile4, half the store instructions of pairs). A block taking
// several heads of a group would share their B and C and sum their dB and
// dC in registers, cutting that scratch, but one head's chunk already fills
// shared memory; that needs x and dy streamed, as the forward's tiles are.
//
// "simt", fp32 (its 1e-4 bound) and inputs the tc kernels cannot take:
// kernels 1 and 3 in fp32 on the CUDA cores (67 TFLOP/s), ~7 ms a layer at
// the training shape. Kernel 3 works in tiles of KT positions (32, or 16
// where shared memory would not hold 32 at P = 128): one walk over the
// column tiles gives dx_s and dB_s (their state terms, then for each row
// tile t >= s the masked score tiles and their products) and adds the score
// terms of dC_t into the head's fp32 dC rows in column order; a short walk
// over the row tiles adds dC_t's state term; each thread owns a 2x2 to 4x4
// patch of an output in shared memory, its operands kept in the layout that
// lets both be read as 8- or 16-byte vectors.
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "common.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int kThreads = 256;
constexpr int kT = 32;           // positions per tile of the chunk-state kernel

struct Strides {
  long long b, s, h;             // batch, sequence, head (or group)
};

// R consecutive floats from p (R = 2 or 4, p aligned to R floats)
template <int R>
__device__ __forceinline__ void ldv(const float* p, float (&v)[R]) {
  if constexpr (R == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  }
}

template <int R>
__device__ __forceinline__ void stv(float* p, const float (&v)[R]) {
  if constexpr (R == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

// out[m][n] (+)= sum_k A(m, k) B(k, n) for an M x Nn output (M a multiple of
// PM, Nn of PN) in shared or global memory, only its first m_store rows read
// and written; A(m, k) = a[k * lda + m] if AK else a[m * lda + k], B(k, n) =
// b[k * ldb + n] if BK else b[n * ldb + k]. Each thread owns PM x PN patches
// (PM, PN in {2, 4}: small outputs take small patches, so that every thread
// has one); every sum runs over k in order.
template <bool AK, bool BK, int PM = 4, int PN = 4>
__device__ void mm(float* out, long long ldo, const float* a, int lda, const float* b, int ldb,
                   int M, int Nn, int K, bool accumulate, int m_store) {
  const int ng = Nn / PN, np = (M / PM) * ng;
  for (int pi = threadIdx.x; pi < np; pi += kThreads) {
    const int m0 = (pi / ng) * PM, n0 = (pi % ng) * PN;
    if (m0 >= m_store) continue;
    float c[PM][PN];
#pragma unroll
    for (int i = 0; i < PM; ++i) {
      if (accumulate && m0 + i < m_store) {
        ldv<PN>(out + (m0 + i) * ldo + n0, c[i]);
      } else {
#pragma unroll
        for (int j = 0; j < PN; ++j) c[i][j] = 0.f;
      }
    }
    for (int k = 0; k < K; ++k) {
      float av[PM], bv[PN];
      if constexpr (AK) {
        ldv<PM>(a + k * lda + m0, av);
      } else {
#pragma unroll
        for (int i = 0; i < PM; ++i) av[i] = a[(m0 + i) * lda + k];
      }
      if constexpr (BK) {
        ldv<PN>(b + k * ldb + n0, bv);
      } else {
#pragma unroll
        for (int j = 0; j < PN; ++j) bv[j] = b[(n0 + j) * ldb + k];
      }
#pragma unroll
      for (int i = 0; i < PM; ++i)
#pragma unroll
        for (int j = 0; j < PN; ++j) c[i][j] = fmaf(av[i], bv[j], c[i][j]);
    }
#pragma unroll
    for (int i = 0; i < PM; ++i)
      if (m0 + i < m_store) stv<PN>(out + (m0 + i) * ldo + n0, c[i]);
  }
}

template <bool AK, bool BK, int PM = 4, int PN = 4>
__device__ __forceinline__ void mm(float* out, int ldo, const float* a, int lda, const float* b,
                                   int ldb, int M, int Nn, int K, bool accumulate) {
  mm<AK, BK, PM, PN>(out, (long long)ldo, a, lda, b, ldb, M, Nn, K, accumulate, M);
}

// A tile of KT positions from row r0 of a chunk starting at s0, W values a
// position, each row times scale[r0 + r] if scale is given, zeros past
// `rows` positions: position-major into dst (dst[r * ld + c]) if dst is
// given, and position-minor into dstT (dstT[c * (KT + 4) + r]) if that is
template <int KT, typename T>
__device__ void load_tile(float* dst, int ld, float* dstT, const T* src, long long ss, int s0,
                          int r0, int rows, int W, const float* scale) {
  for (int e = threadIdx.x; e < KT * W; e += kThreads) {
    const int r = e / W, c = e % W;
    float v = 0.f;
    if (r0 + r < rows) {
      v = to_f32(src[(long long)(s0 + r0 + r) * ss + c]);
      if (scale) v *= scale[r0 + r];
    }
    if (dst) dst[r * ld + c] = v;
    if (dstT) dstT[c * (KT + 4) + r] = v;
  }
}

// the chunk's dt (zero past Qc) and seg = its inclusive cumsum of dt A, in
// position order by one thread, so every kernel gets the same bits
__device__ void chunk_seg(float* dtc, float* segs, const float* dtb, long long dt_ss, int s0,
                          int Qc, int Q, float a) {
  for (int q = threadIdx.x; q < Q; q += kThreads)
    dtc[q] = q < Qc ? dtb[(long long)(s0 + q) * dt_ss] : 0.f;
  __syncthreads();
  if (threadIdx.x == 0) {
    float run = 0.f;
    for (int q = 0; q < Q; ++q) {
      run += dtc[q] * a;
      segs[q] = run;
    }
  }
  __syncthreads();
}

// ----------------------------------------------------------------- kernel 1
template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const T* __restrict__ Bm,
                   const T* __restrict__ Cm, const T* __restrict__ dy, float* __restrict__ states,
                   float* __restrict__ ubuf, float* __restrict__ totals, int S, int H, int G,
                   int P, int N, int Q, Strides xs, Strides dts, Strides bs, Strides cs) {
  extern __shared__ __align__(16) float smem[];
  const int ldp = P + 4, ldn = N + 4;
  float* xt = smem;                 // (kT, P) w_s x_s
  float* bt = xt + kT * ldp;        // (kT, N) B_s
  float* yt = bt + kT * ldn;        // (kT, P) exp(seg_t) dy_t
  float* ct = yt + kT * ldp;        // (kT, N) C_t
  float* acc_s = ct + kT * ldn;     // (P, N) state contribution
  float* acc_u = acc_s + P * ldn;   // (P, N) U
  float* dtc = acc_u + P * ldn;     // (Q,)
  float* segs = dtc + Q;            // (Q,)
  float* wts = segs + Q;            // (Q,) w_s
  float* esg = wts + Q;             // (Q,) exp(seg_t)

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int g = h / (H / G);
  const int s0 = c * Q, Qc = min(Q, S - s0);
  chunk_seg(dtc, segs, dt + b * dts.b + h * dts.h, dts.s, s0, Qc, Q, A[h]);
  const float total = segs[Qc - 1];
  for (int q = threadIdx.x; q < Q; q += kThreads) {
    wts[q] = q < Qc ? expf(total - segs[q]) * dtc[q] : 0.f;
    esg[q] = q < Qc ? expf(segs[q]) : 0.f;
  }
  const T* xb = x + b * xs.b + h * xs.h;
  const T* Bb = Bm + b * bs.b + g * bs.h;
  const T* Cb = Cm + b * cs.b + g * cs.h;
  const T* dyb = dy + ((long long)b * S * H + h) * P;
  const long long dy_ss = (long long)H * P;
  for (int j0 = 0; j0 < Qc; j0 += kT) {
    __syncthreads();
    load_tile<kT>(xt, ldp, nullptr, xb, xs.s, s0, j0, Qc, P, wts);
    load_tile<kT>(bt, ldn, nullptr, Bb, bs.s, s0, j0, Qc, N, nullptr);
    load_tile<kT>(yt, ldp, nullptr, dyb, dy_ss, s0, j0, Qc, P, esg);
    load_tile<kT>(ct, ldn, nullptr, Cb, cs.s, s0, j0, Qc, N, nullptr);
    __syncthreads();
    mm<true, true>(acc_s, ldn, xt, ldp, bt, ldn, P, N, kT, j0 > 0);
    mm<true, true>(acc_u, ldn, yt, ldp, ct, ldn, P, N, kT, j0 > 0);
  }
  __syncthreads();
  const long long off = (((long long)b * nc + c) * H + h) * P * N;
  for (int e = threadIdx.x; e < P * N; e += kThreads) {
    const int p = e / N, n = e % N;
    states[off + e] = acc_s[p * ldn + n];
    ubuf[off + e] = acc_u[p * ldn + n];
  }
  if (threadIdx.x == 0) totals[((long long)b * nc + c) * H + h] = total;
}

// ----------------------------------------------------------------- kernel 2
// states[c] <- S_in of chunk c; ubuf[c] <- the gradient of chunk c's S_out.
// The loads of kScanBatch chunks are issued together, ahead of the
// recurrence that uses them, so a thread waits on memory once a batch and
// not once a chunk; the arithmetic and its order are a chunk at a time.
constexpr int kScanBatch = 8;

__global__ void __launch_bounds__(kThreads)
state_scan_kernel(float* __restrict__ states, float* __restrict__ ubuf,
                  const float* __restrict__ totals, const float* __restrict__ init,
                  const float* __restrict__ dfinal, float* __restrict__ dinit, int nc, int H,
                  int PN) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= PN) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long one = ((long long)b * H + h) * PN + e;
  const long long t0 = (long long)b * nc * H + h;    // chunk c's total: t0 + c H
  float s = init ? init[one] : 0.f;
  for (int c0 = 0; c0 < nc; c0 += kScanBatch) {
    float add[kScanBatch], dec[kScanBatch];
#pragma unroll
    for (int k = 0; k < kScanBatch; ++k) {
      const long long t = t0 + (long long)(c0 + k) * H;
      if (c0 + k < nc) {
        add[k] = states[t * PN + e];
        dec[k] = expf(totals[t]);
      }
    }
#pragma unroll
    for (int k = 0; k < kScanBatch; ++k) {
      const long long t = t0 + (long long)(c0 + k) * H;
      if (c0 + k < nc) {
        states[t * PN + e] = s;
        s = fmaf(s, dec[k], add[k]);
      }
    }
  }
  float gr = dfinal ? dfinal[one] : 0.f;
  for (int c0 = nc - 1; c0 >= 0; c0 -= kScanBatch) {
    float add[kScanBatch], dec[kScanBatch];
#pragma unroll
    for (int k = 0; k < kScanBatch; ++k) {
      const long long t = t0 + (long long)(c0 - k) * H;
      if (c0 - k >= 0) {
        add[k] = ubuf[t * PN + e];
        dec[k] = expf(totals[t]);
      }
    }
#pragma unroll
    for (int k = 0; k < kScanBatch; ++k) {
      const long long t = t0 + (long long)(c0 - k) * H;
      if (c0 - k >= 0) {
        ubuf[t * PN + e] = gr;
        gr = fmaf(gr, dec[k], add[k]);
      }
    }
  }
  if (dinit) dinit[one] = gr;
}

// ----------------------------------------------------------------- kernel 3
// The masked score tiles of row tile it and column tile js, from G (dy_t .
// x_s) and CB (C_t . B_s) in place: g <- dCB = G L dt_s, cb <- scores = CB L
// dt_s, e1 <- G CB L (ddt_s's share), mt <- G scores (seg's share)
template <int KT>
__device__ void score_tiles(float* g, float* cb, float* e1, float* mt, const float* segs,
                            const float* dtc, int it, int js, int Qc) {
  for (int e = threadIdx.x; e < KT * KT; e += kThreads) {
    const int t = e / KT, s = e % KT;
    const int gt = it * KT + t, gs = js * KT + s;
    const int i = t * (KT + 4) + s;
    float dcb = 0.f, sc = 0.f, v1 = 0.f, vm = 0.f;
    if (gs <= gt && gt < Qc) {
      const float L = expf(segs[gt] - segs[gs]);
      const float gv = g[i], cv = cb[i], d = dtc[gs];
      dcb = gv * L * d;
      sc = cv * L * d;
      v1 = gv * cv * L;
      vm = gv * sc;
    }
    g[i] = dcb;
    cb[i] = sc;
    e1[i] = v1;
    mt[i] = vm;
  }
}

// the floats of chunk_grad_kernel<KT>'s shared memory (its layout below)
__host__ __device__ constexpr size_t grad_smem_floats(int KT, int P, int N, int Q) {
  return (size_t)P * (N + 4) + 2 * (size_t)(P + N) * (KT + 4) + 2 * (size_t)KT * (N + 4) +
         (size_t)KT * (P + 4) + 4 * (size_t)KT * (KT + 4) + (size_t)KT * (P + 4) +
         (size_t)KT * (N + 4) + 6 * (size_t)Q + kThreads / 32;
}

template <typename T, int KT>
__global__ void __launch_bounds__(kThreads)
chunk_grad_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const T* __restrict__ Bm,
                  const T* __restrict__ Cm, const float* __restrict__ D,
                  const T* __restrict__ dy, const float* __restrict__ sin_buf,
                  const float* __restrict__ ds_buf, T* __restrict__ dx, float* __restrict__ ddt,
                  float* __restrict__ dBh, float* __restrict__ dCh, float* __restrict__ dApart,
                  float* __restrict__ dDpart, int S, int H, int G, int P, int N, int Q,
                  Strides xs, Strides dts, Strides bs, Strides cs) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LT = KT + 4;          // stride of the position-minor tiles
  const int ldp = P + 4, ldn = N + 4;
  float* mat = smem;                  // (P, N): dS in the column walk, S_in in the row walk
  float* xsT = mat + P * ldn;         // (P, KT) x of the column tile; S_in C_t in the row walk
  float* bsT = xsT + P * LT;          // (N, KT) B of the column tile
  float* ytT = bsT + N * LT;          // (P, KT) dy of the row tile; dS B_s before it
  float* ctT = ytT + P * LT;          // (N, KT) C of the row tile
  float* bsN = ctT + N * LT;          // (KT, N) B of the column tile
  float* ctN = bsN + KT * ldn;        // (KT, N) C of the row tile
  float* ytN = ctN + KT * ldn;        // (KT, P) dy of the row tile
  float* gm = ytN + KT * ldp;         // (KT, KT) G, then dCB
  float* cbm = gm + KT * LT;          // (KT, KT) C.B, then scores
  float* e1m = cbm + KT * LT;         // (KT, KT) G C.B L
  float* mt = e1m + KT * LT;          // (KT, KT) G scores
  float* acc_a = mt + KT * LT;        // (KT, P) dx_s
  float* acc_b = acc_a + KT * ldp;    // (KT, N) dB_s, then dC_t's state term
  float* dtc = acc_b + KT * ldn;      // (Q,) dt
  float* segs = dtc + Q;              // (Q,) seg
  float* dseg = segs + Q;             // (Q,) d seg
  float* ddtq = dseg + Q;             // (Q,) ddt's score share
  float* dwv = ddtq + Q;              // (Q,) d w_s
  float* dxx = dwv + Q;               // (Q,) dy_t . x_t
  float* red = dxx + Q;               // (kThreads / 32,) warp sums

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int s0 = c * Q, Qc = min(Q, S - s0);
  const float a = A[h], dskip = D[h];
  chunk_seg(dtc, segs, dt + b * dts.b + h * dts.h, dts.s, s0, Qc, Q, a);
  const float total = segs[Qc - 1];
  const float etot = expf(total);
  for (int q = tid; q < Q; q += kThreads) dseg[q] = ddtq[q] = dwv[q] = dxx[q] = 0.f;

  const T* xb = x + b * xs.b + h * xs.h;
  const T* Bb = Bm + b * bs.b + g * bs.h;
  const T* Cb = Cm + b * cs.b + g * cs.h;
  const long long row_ss = (long long)H * P;          // dy and dx, contiguous
  const T* dyb = dy + ((long long)b * S * H + h) * P;
  T* dxb = dx + ((long long)b * S * H + h) * P;
  const long long bh_ss = (long long)H * N;           // dBh and dCh
  float* dBb = dBh + ((long long)b * S * H + h) * N + (long long)s0 * bh_ss;
  float* dCb = dCh + ((long long)b * S * H + h) * N + (long long)s0 * bh_ss;
  const long long moff = (((long long)b * nc + c) * H + h) * P * N;
  const int nt = (Qc + KT - 1) / KT;

  // dS into shared memory; sum(dS * S_in), a share of d total
  float part = 0.f;
  for (int e = tid; e < P * N; e += kThreads) {
    const float v = ds_buf[moff + e];
    mat[(e / N) * ldn + e % N] = v;
    part = fmaf(v, sin_buf[moff + e], part);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
  if (tid % 32 == 0) red[tid / 32] = part;
  __syncthreads();
  float dtot = 0.f;
  for (int i = 0; i < kThreads / 32; ++i) dtot += red[i];
  dtot *= etot;

  // ---- the column walk: dx_s, the head's dB_s, and the score terms of
  // every dC_t (t >= s), added into dCh in column order
  for (int js = 0; js < nt; ++js) {
    const int j0 = js * KT;
    __syncthreads();
    load_tile<KT>(nullptr, 0, xsT, xb, xs.s, s0, j0, Qc, P, nullptr);
    load_tile<KT>(bsN, ldn, bsT, Bb, bs.s, s0, j0, Qc, N, nullptr);
    __syncthreads();
    // (dS B_s)^T into ytT's room; dB_s = x_s dS into acc_b
    mm<false, true, 4, 2>(ytT, LT, mat, ldn, bsT, LT, P, KT, N, false);
    mm<true, true>(acc_b, ldn, xsT, LT, mat, ldn, KT, N, P, false);
    __syncthreads();
    if (tid < KT && j0 + tid < Qc) {   // d w_s = x_s . (dS B_s), in p order
      float s = 0.f;
      for (int p = 0; p < P; ++p) s = fmaf(xsT[p * LT + tid], ytT[p * LT + tid], s);
      dwv[j0 + tid] = s;
    }
    for (int e = tid; e < KT * P; e += kThreads) {
      const int s = e / P, p = e % P;
      const int q = j0 + s;
      acc_a[s * ldp + p] = q < Qc ? expf(total - segs[q]) * dtc[q] * ytT[p * LT + s] : 0.f;
    }
    for (int e = tid; e < KT * N; e += kThreads) {
      const int s = e / N, n = e % N;
      const int q = j0 + s;
      acc_b[s * ldn + n] *= q < Qc ? expf(total - segs[q]) * dtc[q] : 0.f;
    }
    for (int it = js; it < nt; ++it) {
      const int i0 = it * KT;
      __syncthreads();
      load_tile<KT>(ytN, ldp, ytT, dyb, row_ss, s0, i0, Qc, P, nullptr);
      load_tile<KT>(ctN, ldn, ctT, Cb, cs.s, s0, i0, Qc, N, nullptr);
      __syncthreads();
      mm<true, true, 2, 2>(gm, LT, ytT, LT, xsT, LT, KT, KT, P, false);
      mm<true, true, 2, 2>(cbm, LT, ctT, LT, bsT, LT, KT, KT, N, false);
      __syncthreads();
      score_tiles<KT>(gm, cbm, e1m, mt, segs, dtc, it, js, Qc);
      __syncthreads();
      if (tid < KT) {             // column sums in row order, row sums in column order
        float s1 = 0.f, sc = 0.f, sr = 0.f;
        for (int t = 0; t < KT; ++t) {
          s1 += e1m[t * LT + tid];
          sc += mt[t * LT + tid];
        }
        for (int s = 0; s < KT; ++s) sr += mt[tid * LT + s];
        if (j0 + tid < Qc) {      // the per-position arrays hold Q >= Qc floats
          ddtq[j0 + tid] += s1;
          dseg[j0 + tid] -= sc;
        }
        if (i0 + tid < Qc) dseg[i0 + tid] += sr;
      }
      // dx_s += scores^T dy_t; dB_s += dCB^T C_t; dC_t += dCB B_s
      mm<true, true, 2, 4>(acc_a, ldp, cbm, LT, ytN, ldp, KT, P, KT, true);
      mm<true, true>(acc_b, ldn, gm, LT, ctN, ldn, KT, N, KT, true);
      mm<false, true>(dCb + (long long)i0 * bh_ss, bh_ss, gm, LT, bsN, ldn, KT, N, KT, js > 0,
                      min(KT, Qc - i0));
      if (it == js) {             // the diagonal tile: ytT holds dy_s
        __syncthreads();
        for (int e = tid; e < KT * P; e += kThreads) {
          const int s = e / P, p = e % P;
          acc_a[s * ldp + p] = fmaf(dskip, ytT[p * LT + s], acc_a[s * ldp + p]);
        }
        if (tid < KT && j0 + tid < Qc) {
          float s = 0.f;
          for (int p = 0; p < P; ++p) s = fmaf(ytT[p * LT + tid], xsT[p * LT + tid], s);
          dxx[j0 + tid] = s;
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < KT * P; e += kThreads) {
      const int s = e / P, p = e % P;
      if (j0 + s < Qc)
        dxb[(long long)(s0 + j0 + s) * row_ss + p] = from_f32<T>(acc_a[s * ldp + p]);
    }
    for (int e = tid; e < KT * N; e += kThreads) {
      const int s = e / N, n = e % N;
      if (j0 + s < Qc) dBb[(long long)(j0 + s) * bh_ss + n] = acc_b[s * ldn + n];
    }
  }

  // ---- the row walk: the state terms of dC_t and of d seg_t
  __syncthreads();
  for (int e = tid; e < P * N; e += kThreads) mat[(e / N) * ldn + e % N] = sin_buf[moff + e];
  for (int it = 0; it < nt; ++it) {
    const int i0 = it * KT;
    __syncthreads();
    load_tile<KT>(nullptr, 0, ytT, dyb, row_ss, s0, i0, Qc, P, nullptr);
    load_tile<KT>(nullptr, 0, ctT, Cb, cs.s, s0, i0, Qc, N, nullptr);
    __syncthreads();
    // (S_in C_t)^T into xsT's room; S_in^T dy_t into acc_b
    mm<false, true, 4, 2>(xsT, LT, mat, ldn, ctT, LT, P, KT, N, false);
    mm<true, true>(acc_b, ldn, ytT, LT, mat, ldn, KT, N, P, false);
    __syncthreads();
    if (tid < KT) {               // d seg_t from y_inter_t = exp(seg_t) S_in C_t
      const int q = i0 + tid;
      float s = 0.f;
      for (int p = 0; p < P; ++p) s = fmaf(ytT[p * LT + tid], xsT[p * LT + tid], s);
      if (q < Qc) dseg[q] += expf(segs[q]) * s;
    }
    for (int e = tid; e < KT * N; e += kThreads) {
      const int t = e / N, n = e % N;
      const int q = i0 + t;
      if (q < Qc) {
        float* o = dCb + (long long)q * bh_ss + n;
        *o = fmaf(expf(segs[q]), acc_b[t * ldn + n], *o);
      }
    }
  }

  // ---- seg = cumsum(dt A) and total = seg[Qc - 1]: ddt, dA, dD
  __syncthreads();
  if (tid == 0) {
    float dw_tot = 0.f;
    for (int q = 0; q < Qc; ++q) dw_tot = fmaf(expf(total - segs[q]) * dtc[q], dwv[q], dw_tot);
    // w_s = exp(total - seg_s) dt_s: its seg_s share, then total's
    for (int q = 0; q < Qc; ++q) dseg[q] -= expf(total - segs[q]) * dtc[q] * dwv[q];
    dseg[Qc - 1] += dtot + dw_tot;
    float run = 0.f, da_sum = 0.f, dd_sum = 0.f;
    for (int q = Qc - 1; q >= 0; --q) {   // d(dt_q A) = sum_{t >= q} d seg_t
      run += dseg[q];
      dseg[q] = run;
    }
    for (int q = 0; q < Qc; ++q) {
      da_sum = fmaf(dtc[q], dseg[q], da_sum);
      dd_sum += dxx[q];
    }
    const long long t = ((long long)b * nc + c) * H + h;
    dApart[t] = da_sum;
    dDpart[t] = dd_sum;
  }
  __syncthreads();
  float* ddtb = ddt + ((long long)b * S * H + h);
  for (int q = tid; q < Qc; q += kThreads)
    ddtb[(long long)(s0 + q) * H] =
        ddtq[q] + expf(total - segs[q]) * dwv[q] + a * dseg[q];
}

// ------------------------------------------------------------ kernels 4, 5
template <typename T>
__global__ void __launch_bounds__(kThreads)
group_sum_kernel(const float* __restrict__ src, T* __restrict__ dst, long long rows, int H,
                 int G, int N) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= rows * G * N) return;
  const int n = e % N, g = (e / N) % G;
  const long long r = e / ((long long)N * G);
  const int rep = H / G;
  const float* p = src + (r * H + (long long)g * rep) * N + n;
  float s = 0.f;
  for (int i = 0; i < rep; ++i) s += p[(long long)i * N];
  dst[e] = from_f32<T>(s);
}

__global__ void head_sum_kernel(const float* __restrict__ dApart,
                                const float* __restrict__ dDpart, float* __restrict__ dA,
                                float* __restrict__ dD, int Bn, int H) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  float sa = 0.f, sd = 0.f;
  for (int i = 0; i < Bn; ++i) {
    sa += dApart[(long long)i * H + h];
    sd += dDpart[(long long)i * H + h];
  }
  dA[h] = sa;
  dD[h] = sd;
}

// kernels 4 and 5 of both variants: dB and dC summed over each group's heads,
// dA and dD over (batch, chunk)
template <typename T>
cudaError_t sum_heads(void* dB, void* dC, void* dA, void* dD, const void* dBh, const void* dCh,
                      const void* dApart, const void* dDpart, int Bz, int S, int H, int G,
                      int N, int nc, cudaStream_t stream) {
  const long long rows = (long long)Bz * S;
  const long long n_out = rows * G * N;
  const unsigned blocks = (unsigned)((n_out + kThreads - 1) / kThreads);
  group_sum_kernel<T><<<blocks, kThreads, 0, stream>>>(static_cast<const float*>(dBh),
                                                       static_cast<T*>(dB), rows, H, G, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  group_sum_kernel<T><<<blocks, kThreads, 0, stream>>>(static_cast<const float*>(dCh),
                                                       static_cast<T*>(dC), rows, H, G, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  head_sum_kernel<<<(H + 127) / 128, 128, 0, stream>>>(
      static_cast<const float*>(dApart), static_cast<const float*>(dDpart),
      static_cast<float*>(dA), static_cast<float*>(dD), Bz * nc, H);
  return cudaGetLastError();
}

size_t state_smem_bytes(int P, int N, int Q) {
  return sizeof(float) * (2 * (size_t)kT * (P + 4) + 2 * (size_t)kT * (N + 4) +
                          2 * (size_t)P * (N + 4) + 4 * (size_t)Q);
}

constexpr size_t kMaxSmem = 232448;   // an H100 block's dynamic shared memory

// the column tile of chunk_grad_kernel: 32 positions where its shared memory
// fits, else 16
int grad_tile(int P, int N, int Q) {
  return sizeof(float) * grad_smem_floats(32, P, N, Q) <= kMaxSmem ? 32 : 16;
}

template <typename T, int KT>
cudaError_t launch_grad(dim3 grid, size_t smem, const T* x, const float* dt, const float* A,
                        const T* B, const T* C, const void* D, const T* dy, void* states,
                        void* ubuf, void* dx, void* ddt, void* dBh, void* dCh, void* dApart,
                        void* dDpart, int S, int H, int G, int P, int N, int Q, Strides xs,
                        Strides dts, Strides bs, Strides cs, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(chunk_grad_kernel<T, KT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  chunk_grad_kernel<T, KT><<<grid, kThreads, smem, stream>>>(
      x, dt, A, B, C, static_cast<const float*>(D), dy, static_cast<const float*>(states),
      static_cast<const float*>(ubuf), static_cast<T*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(dBh), static_cast<float*>(dCh), static_cast<float*>(dApart),
      static_cast<float*>(dDpart), S, H, G, P, N, Q, xs, dts, bs, cs);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* B, const void* C,
                   const void* D, const void* init, const void* dy, const void* dfinal,
                   void* dx, void* ddt, void* dA, void* dB, void* dC, void* dD, void* dinit,
                   void* states, void* ubuf, void* totals, void* dBh, void* dCh, void* dApart,
                   void* dDpart, int Bz, int S, int H, int G, int P, int N, int Q, Strides xs,
                   Strides dts, Strides bs, Strides cs, cudaStream_t stream) {
  const int nc = (S + Q - 1) / Q;
  const dim3 grid(nc, H, Bz);
  const T* xp = static_cast<const T*>(x);
  const T* bp = static_cast<const T*>(B);
  const T* cp = static_cast<const T*>(C);
  const T* dyp = static_cast<const T*>(dy);
  const float* dtp = static_cast<const float*>(dt);
  const float* ap = static_cast<const float*>(A);

  size_t smem = state_smem_bytes(P, N, Q);
  cudaError_t err = cudaFuncSetAttribute(chunk_state_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  chunk_state_kernel<T><<<grid, kThreads, smem, stream>>>(
      xp, dtp, ap, bp, cp, dyp, static_cast<float*>(states), static_cast<float*>(ubuf),
      static_cast<float*>(totals), S, H, G, P, N, Q, xs, dts, bs, cs);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int PN = P * N;
  state_scan_kernel<<<dim3((PN + kThreads - 1) / kThreads, H, Bz), kThreads, 0, stream>>>(
      static_cast<float*>(states), static_cast<float*>(ubuf),
      static_cast<const float*>(totals), static_cast<const float*>(init),
      static_cast<const float*>(dfinal), static_cast<float*>(dinit), nc, H, PN);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int kt = grad_tile(P, N, Q);
  smem = sizeof(float) * grad_smem_floats(kt, P, N, Q);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  err = kt == 32 ? launch_grad<T, 32>(grid, smem, xp, dtp, ap, bp, cp, D, dyp, states, ubuf, dx,
                                      ddt, dBh, dCh, dApart, dDpart, S, H, G, P, N, Q, xs, dts,
                                      bs, cs, stream)
                 : launch_grad<T, 16>(grid, smem, xp, dtp, ap, bp, cp, D, dyp, states, ubuf, dx,
                                      ddt, dBh, dCh, dApart, dDpart, S, H, G, P, N, Q, xs, dts,
                                      bs, cs, stream);
  if (err != cudaSuccess) return err;

  return sum_heads<T>(dB, dC, dA, dD, dBh, dCh, dApart, dDpart, Bz, S, H, G, N, nc, stream);
}


// -------------------------------------------------------------- tc variant
namespace tc {

using bf16 = __nv_bfloat16;
using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::ex2;
using repro::ldsm_x4;
using repro::ldsm_x4_trans;
using repro::mma16816;
using repro::pack_bf16;
using repro::swz;
using repro::unpack_bf16;

constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;              // positions per tile of the chunk-state kernel
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Shared memory of chunk_state_tc_kernel: two stages of x, dy, B and C tiles,
// then per chunk position (Q rounded up to whole tiles) dt, seg * log2 e and
// the two weights, and the scan's warp totals (ops.py::bwd_smem_bytes
// mirrors this)
__host__ __device__ constexpr size_t state_smem_bytes(int P, int N, int Q) {
  return 2 * (size_t)kTile * (4 * P + 4 * N) + 16 * (size_t)round_up(Q, kTile) +
         4 * (kWarps + 1);
}

// Shared memory of chunk_grad_tc_kernel: the chunk's x, dy, B and C (Q
// rounded up to 16 rows), a bf16 (P x N) state (dS, then S_in), nine fp32
// arrays of a value per position, and the block sums' warp totals
__host__ __device__ constexpr size_t grad_smem_bytes(int P, int N, int Q) {
  return (size_t)round_up(Q, 16) * (4 * P + 4 * N) + 2 * (size_t)P * N +
         36 * (size_t)round_up(Q, 16) + 4 * (kWarps + 1);
}

// seg2[q] = log2(e) times the inclusive cumsum of dt a over the chunk's Qc
// positions: a run of positions a thread, then a scan of the runs over the
// block (the same code in both kernels, so both get the same bits);
// positions past Qc up to Qt hold seg2[Qc - 1]. Returns the chunk's total,
// sum dt a, in natural units. wsum holds kWarps + 1 floats.
__device__ float chunk_scan(const float* dtc, float* seg2, float* wsum, int Qc, int Qt,
                            float a) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int per = (Qc + kThreads - 1) / kThreads;
  const int lo = min(tid * per, Qc), hi = min(lo + per, Qc);
  float run = 0.f;
  for (int q = lo; q < hi; ++q) run += dtc[q] * a;
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  float pre = incl - run;
  for (int w = 0; w < warp; ++w) pre += wsum[w];
  for (int q = lo; q < hi; ++q) {
    pre += dtc[q] * a;
    seg2[q] = pre * kLog2e;
    if (q == Qc - 1) wsum[kWarps] = pre;
  }
  __syncthreads();
  const float total = wsum[kWarps];
  for (int q = Qc + tid; q < Qt; q += kThreads) seg2[q] = total * kLog2e;
  __syncthreads();
  return total;
}

// the sum of v over the block, the same bits in every thread: a butterfly in
// each warp, then the warp sums in warp order (red holds kWarps floats)
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();   // every reader of red's previous sums is done
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

// the sum over a quad (the 4 lanes that hold one accumulator row), in a
// fixed butterfly
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One n8 accumulator tile v of rows (r_lo, r_lo + 8) out to rows of stride
// ld at column c0, 4 columns a lane: lanes t4, t4 ^ 1 swap a pair, so an even
// lane holds 4 columns of row r_lo and an odd lane 4 of row r_lo + 8 (half
// the store instructions of pairs; the stores pace the walks). fp32 goes out
// as float4, bf16 as 8 bytes. Rows at or past `rows` are not written.
__device__ __forceinline__ void store_tile4(float* out, long long ld, int r_lo, int c0,
                                            const float (&v)[4], int rows, int t4) {
  const bool odd = t4 & 1;
  const float r0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[2], 1);
  const float r1 = __shfl_xor_sync(0xffffffffu, odd ? v[1] : v[3], 1);
  const int row = odd ? r_lo + 8 : r_lo;
  if (row < rows)
    *reinterpret_cast<float4*>(out + row * ld + c0 + 2 * (t4 & ~1)) =
        odd ? make_float4(r0, r1, v[2], v[3]) : make_float4(v[0], v[1], r0, r1);
}

__device__ __forceinline__ void store_tile4(bf16* out, long long ld, int r_lo, int c0,
                                            const float (&v)[4], int rows, int t4) {
  const bool odd = t4 & 1;
  const uint32_t lo = pack_bf16(v[0], v[1]), hi = pack_bf16(v[2], v[3]);
  const uint32_t r = __shfl_xor_sync(0xffffffffu, odd ? lo : hi, 1);
  const int row = odd ? r_lo + 8 : r_lo;
  if (row < rows)
    *reinterpret_cast<uint2*>(out + row * ld + c0 + 2 * (t4 & ~1)) =
        odd ? make_uint2(r, hi) : make_uint2(lo, r);
}

// ------------------------------------------------------------- kernel 1, tc
// The chunk's state contribution and U on the tensor cores (the note at the
// top gives the design).
template <int P, int N>
__global__ void __launch_bounds__(kThreads)
chunk_state_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const bf16* __restrict__ Bm,
                      const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
                      float* __restrict__ states, float* __restrict__ ubuf,
                      float* __restrict__ totals, int S, int H, int G, int Q, Strides xs,
                      Strides dts, Strides bs, Strides cs) {
  constexpr int KN = N / 16, KP = P / 16;
  constexpr int U = KP * KN;
  constexpr int UPW = (U + kWarps - 1) / kWarps;
  static_assert(KN % UPW == 0, "a warp's units share one row group");
  constexpr uint32_t kX = kTile * P * 2, kB = kTile * N * 2, kStage = 2 * kX + 2 * kB;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int Qt = round_up(Q, kTile);
  float* dtc = reinterpret_cast<float*>(smem + 2 * kStage);
  float* seg2 = dtc + Qt;
  float* wts = seg2 + Qt;        // exp(total - seg_s) dt_s
  float* esg = wts + Qt;         // exp(seg_t)
  float* wsum = esg + Qt;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int g = h / (H / G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, t4 = lane % 4;
  const int s0 = c * Q, Qc = min(Q, S - s0);
  const bf16* xb = x + b * xs.b + h * xs.h;
  const bf16* Bb = Bm + b * bs.b + g * bs.h;
  const bf16* Cb = Cm + b * cs.b + g * cs.h;
  const bf16* dyb = dy + ((long long)b * S * H + h) * P;
  const long long dy_ss = (long long)H * P;
  const float* dtb = dt + b * dts.b + h * dts.h;

  auto issue = [&](int jt, int st) {
    const uint32_t base = sbase + st * kStage;
    const int j0 = jt * kTile;
    for (int i = tid; i < kTile * (P / 8); i += kThreads) {
      const int r = i / (P / 8), k = i % (P / 8), q = j0 + r;
      const bool ok = q < Qc;
      const long long row = s0 + (ok ? q : 0);
      cp_async16(base + swz<P>(r, k), xb + row * xs.s + k * 8, ok);
      cp_async16(base + kX + swz<P>(r, k), dyb + row * dy_ss + k * 8, ok);
    }
    for (int i = tid; i < kTile * (N / 8); i += kThreads) {
      const int r = i / (N / 8), k = i % (N / 8), q = j0 + r;
      const bool ok = q < Qc;
      const long long row = s0 + (ok ? q : 0);
      cp_async16(base + 2 * kX + swz<N>(r, k), Bb + row * bs.s + k * 8, ok);
      cp_async16(base + 2 * kX + kB + swz<N>(r, k), Cb + row * cs.s + k * 8, ok);
    }
  };
  issue(0, 0);
  cp_async_commit();
  for (int q = tid; q < Qt; q += kThreads) dtc[q] = q < Qc ? dtb[(long long)(s0 + q) * dts.s] : 0.f;
  __syncthreads();
  const float total = chunk_scan(dtc, seg2, wsum, Qc, Qt, A[h]);
  const float last2 = seg2[Qc - 1];
  for (int q = tid; q < Qt; q += kThreads) {
    const bool in = q < Qc;
    wts[q] = in ? ex2(last2 - seg2[q]) * dtc[q] : 0.f;
    esg[q] = in ? ex2(seg2[q]) : 0.f;
  }

  const bool owns = warp * UPW < U;
  const int mg = warp * UPW / KN, ng0 = warp * UPW % KN;
  float sa[UPW][2][4] = {}, ua[UPW][2][4] = {};
  const int nt = (Qc + kTile - 1) / kTile;
  for (int jt = 0; jt < nt; ++jt) {
    if (jt + 1 < nt) {
      issue(jt + 1, (jt + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // tile jt (and, at jt = 0, the weights) visible to every thread
    const uint32_t xt = sbase + (jt & 1) * kStage, yt = xt + kX, bt = yt + kX, ct = bt + kB;
    if (owns) {
#pragma unroll
      for (int kc = 0; kc < kTile / 16; ++kc) {
        const int jb = jt * kTile + 16 * kc;
        if (jb < Qc) {
          const float2 wlo = *reinterpret_cast<const float2*>(wts + jb + 2 * t4);
          const float2 whi = *reinterpret_cast<const float2*>(wts + jb + 8 + 2 * t4);
          const float2 elo = *reinterpret_cast<const float2*>(esg + jb + 2 * t4);
          const float2 ehi = *reinterpret_cast<const float2*>(esg + jb + 8 + 2 * t4);
          // (x (.) w)^T and (dy (.) exp(seg))^T: rows p, columns s; registers
          // 0, 1 hold positions 2t, 2t+1 and 2, 3 positions 2t+8, 2t+9
          const int ar = 16 * kc + (lane % 8) + (lane / 16) * 8, ac = 2 * mg + (lane / 8) % 2;
          uint32_t xa[4], ya[4];
          ldsm_x4_trans(xt + swz<P>(ar, ac), xa);
          ldsm_x4_trans(yt + swz<P>(ar, ac), ya);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float2 wv = r < 2 ? wlo : whi, ev = r < 2 ? elo : ehi;
            float2 v = unpack_bf16(xa[r]);
            xa[r] = pack_bf16(v.x * wv.x, v.y * wv.y);
            v = unpack_bf16(ya[r]);
            ya[r] = pack_bf16(v.x * ev.x, v.y * ev.y);
          }
#pragma unroll
          for (int k = 0; k < UPW; ++k) {
            const int br = 16 * kc + (lane % 8) + ((lane / 8) % 2) * 8,
                      bc = 2 * (ng0 + k) + lane / 16;
            uint32_t f[4];
            ldsm_x4_trans(bt + swz<N>(br, bc), f);
            mma16816(sa[k][0], xa, f[0], f[1]);
            mma16816(sa[k][1], xa, f[2], f[3]);
            ldsm_x4_trans(ct + swz<N>(br, bc), f);
            mma16816(ua[k][0], ya, f[0], f[1]);
            mma16816(ua[k][1], ya, f[2], f[3]);
          }
        }
      }
    }
    __syncthreads();   // every warp is done with this stage before it is refilled
  }
  const long long off = (((long long)b * nc + c) * H + h) * P * N;
  if (owns) {
#pragma unroll
    for (int k = 0; k < UPW; ++k) {
#pragma unroll
      for (int n8 = 0; n8 < 2; ++n8) {
        const int n = 16 * (ng0 + k) + 8 * n8;
        store_tile4(states + off, N, 16 * mg + gr, n, sa[k][n8], P, t4);
        store_tile4(ubuf + off, N, 16 * mg + gr, n, ua[k][n8], P, t4);
      }
    }
  }
  if (tid == 0) totals[((long long)b * nc + c) * H + h] = total;
}

// ------------------------------------------------------------- kernel 3, tc
// The chunk's gradients on the tensor cores (the note at the top gives the
// design): the load, the column walk (dx, dB, ddt's and seg's score
// shares), the row walk (dC and seg's other shares), then the tail.
template <int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
chunk_grad_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const bf16* __restrict__ Bm,
                     const bf16* __restrict__ Cm, const float* __restrict__ D,
                     const bf16* __restrict__ dy, const float* __restrict__ sin_buf,
                     const float* __restrict__ ds_buf, bf16* __restrict__ dx,
                     float* __restrict__ ddt, float* __restrict__ dBh, float* __restrict__ dCh,
                     float* __restrict__ dApart, float* __restrict__ dDpart, int S, int H, int G,
                     int Q, Strides xs, Strides dts, Strides bs, Strides cs) {
  constexpr int KN = N / 16, KP = P / 16;
  extern __shared__ __align__(128) uint8_t smem[];
  const int Qt = round_up(Q, 16);
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t x_sm = sbase, y_sm = x_sm + Qt * P * 2, b_sm = y_sm + Qt * P * 2,
                 c_sm = b_sm + Qt * N * 2, m_sm = c_sm + Qt * N * 2;
  uint8_t* mat = smem + (m_sm - sbase);
  float* dtc = reinterpret_cast<float*>(mat + P * N * 2);
  float* seg2 = dtc + Qt;     // seg * log2 e
  float* colf = seg2 + Qt;    // the row walk's column factors, 2^(seg2[s|15] - seg2[s]) dt_s
  float* colt = colf + Qt;    // the column walk's, 2^(seg2[t] - seg2[t & ~15])
  float* ddtq = colt + Qt;    // ddt's score share, sum_t G C.B L
  float* dsegc = ddtq + Qt;   // seg's column-walk share, -sum_t G scores
  float* dsegr = dsegc + Qt;  // seg's row-walk share
  float* dwv = dsegr + Qt;    // d w_s
  float* dxx = dwv + Qt;      // dy_t . x_t
  float* red = dxx + Qt;      // kWarps + 1 warp totals

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int g = h / (H / G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, t4 = lane % 4;
  const int s0 = c * Q, Qc = min(Q, S - s0);
  const float a = A[h], dskip = D[h];
  const bf16* xb = x + b * xs.b + h * xs.h;
  const bf16* Bb = Bm + b * bs.b + g * bs.h;
  const bf16* Cb = Cm + b * cs.b + g * cs.h;
  const long long row_ss = (long long)H * P;           // dy and dx, contiguous
  const bf16* dyb = dy + ((long long)b * S * H + h) * P;
  bf16* dxb = dx + ((long long)b * S * H + h) * P;
  const long long bh_ss = (long long)H * N;            // dBh and dCh
  float* dBb = dBh + ((long long)b * S * H + h) * N + (long long)s0 * bh_ss;
  float* dCb = dCh + ((long long)b * S * H + h) * N + (long long)s0 * bh_ss;
  const long long moff = (((long long)b * nc + c) * H + h) * P * N;
  const float* dtb = dt + b * dts.b + h * dts.h;

  // the chunk's x, dy, B, C, zeros past Qc
  for (int i = tid; i < Qt * (P / 8); i += kThreads) {
    const int r = i / (P / 8), k = i % (P / 8);
    const bool ok = r < Qc;
    const long long row = s0 + (ok ? r : 0);
    cp_async16(x_sm + swz<P>(r, k), xb + row * xs.s + k * 8, ok);
    cp_async16(y_sm + swz<P>(r, k), dyb + row * row_ss + k * 8, ok);
  }
  for (int i = tid; i < Qt * (N / 8); i += kThreads) {
    const int r = i / (N / 8), k = i % (N / 8);
    const bool ok = r < Qc;
    const long long row = s0 + (ok ? r : 0);
    cp_async16(b_sm + swz<N>(r, k), Bb + row * bs.s + k * 8, ok);
    cp_async16(c_sm + swz<N>(r, k), Cb + row * cs.s + k * 8, ok);
  }
  cp_async_commit();
  // meanwhile: dt, and dS as bf16 (sum(dS * S_in) on the way, a share of
  // d total)
  for (int q = tid; q < Qt; q += kThreads) dtc[q] = q < Qc ? dtb[(long long)(s0 + q) * dts.s] : 0.f;
  float part = 0.f;
  for (int i = tid; i < P * N / 8; i += kThreads) {
    const int p = i / (N / 8), k = i % (N / 8);
    const float4* src = reinterpret_cast<const float4*>(ds_buf + moff + (long long)i * 8);
    const float4* sin = reinterpret_cast<const float4*>(sin_buf + moff + (long long)i * 8);
    const float4 u = src[0], v = src[1], su = sin[0], sv = sin[1];
    part = fmaf(u.x, su.x, part);
    part = fmaf(u.y, su.y, part);
    part = fmaf(u.z, su.z, part);
    part = fmaf(u.w, su.w, part);
    part = fmaf(v.x, sv.x, part);
    part = fmaf(v.y, sv.y, part);
    part = fmaf(v.z, sv.z, part);
    part = fmaf(v.w, sv.w, part);
    *reinterpret_cast<uint4*>(mat + swz<N>(p, k)) =
        make_uint4(pack_bf16(u.x, u.y), pack_bf16(u.z, u.w), pack_bf16(v.x, v.y),
                   pack_bf16(v.z, v.w));
  }
  __syncthreads();
  chunk_scan(dtc, seg2, red, Qc, Qt, a);
  const float last2 = seg2[Qc - 1];
  for (int q = tid; q < Qt; q += kThreads) {
    const bool in = q < Qc;
    colf[q] = in ? ex2(seg2[min(q | 15, Qc - 1)] - seg2[q]) * dtc[q] : 0.f;
    colt[q] = in ? ex2(seg2[q] - seg2[q & ~15]) : 0.f;
  }
  const float dtot = ex2(last2) * block_sum(part, red);
  cp_async_wait<0>();
  __syncthreads();

  const int ng = (Qc + 15) / 16;
  // ---- the column walk
  for (int base = 0; base < ng; base += 2 * kWarps) {
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const int j = base + (half ? 2 * kWarps - 1 - warp : warp);
      if (j >= ng) continue;
      const int r0 = 16 * j;
      const int sa_ = r0 + gr, sb_ = sa_ + 8;    // this lane's two rows
      uint32_t xa[KP][4], ba[KN][4];
      const int lr = r0 + (lane % 8) + ((lane / 8) % 2) * 8;
#pragma unroll
      for (int kk = 0; kk < KP; ++kk) ldsm_x4(x_sm + swz<P>(lr, 2 * kk + lane / 16), xa[kk]);
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) ldsm_x4(b_sm + swz<N>(lr, 2 * kk + lane / 16), ba[kk]);
      float dxa[P / 8][4] = {}, dba[N / 8][4] = {};
      // the state terms: V = B_s dS^T into dxa, Z = x_s dS into dba
#pragma unroll
      for (int pp = 0; pp < KP; ++pp) {
#pragma unroll
        for (int kk = 0; kk < KN; ++kk) {
          uint32_t f[4];
          ldsm_x4(m_sm + swz<N>(16 * pp + (lane % 8) + (lane / 16) * 8, 2 * kk + (lane / 8) % 2),
                  f);
          mma16816(dxa[2 * pp], ba[kk], f[0], f[1]);
          mma16816(dxa[2 * pp + 1], ba[kk], f[2], f[3]);
        }
      }
#pragma unroll
      for (int nn = 0; nn < KN; ++nn) {
#pragma unroll
        for (int kk = 0; kk < KP; ++kk) {
          uint32_t f[4];
          ldsm_x4_trans(
              m_sm + swz<N>(16 * kk + (lane % 8) + ((lane / 8) % 2) * 8, 2 * nn + lane / 16), f);
          mma16816(dba[2 * nn], xa[kk], f[0], f[1]);
          mma16816(dba[2 * nn + 1], xa[kk], f[2], f[3]);
        }
      }
      // d w_s = x_s . V_s
      float dwa = 0.f, dwb = 0.f;
#pragma unroll
      for (int kk = 0; kk < KP; ++kk) {
        const float2 v0 = unpack_bf16(xa[kk][0]), v1 = unpack_bf16(xa[kk][1]),
                     v2 = unpack_bf16(xa[kk][2]), v3 = unpack_bf16(xa[kk][3]);
        dwa = fmaf(v0.x, dxa[2 * kk][0], dwa);
        dwa = fmaf(v0.y, dxa[2 * kk][1], dwa);
        dwa = fmaf(v2.x, dxa[2 * kk + 1][0], dwa);
        dwa = fmaf(v2.y, dxa[2 * kk + 1][1], dwa);
        dwb = fmaf(v1.x, dxa[2 * kk][2], dwb);
        dwb = fmaf(v1.y, dxa[2 * kk][3], dwb);
        dwb = fmaf(v3.x, dxa[2 * kk + 1][2], dwb);
        dwb = fmaf(v3.y, dxa[2 * kk + 1][3], dwb);
      }
      dwa = quad_sum(dwa);
      dwb = quad_sum(dwb);
      const float dta = dtc[sa_], dtb_ = dtc[sb_];
      const float sga = seg2[min(sa_, Qc - 1)], sgb = seg2[min(sb_, Qc - 1)];
      const float wa = sa_ < Qc ? ex2(last2 - sga) * dta : 0.f;
      const float wb = sb_ < Qc ? ex2(last2 - sgb) * dtb_ : 0.f;
#pragma unroll
      for (int n = 0; n < P / 8; ++n) {
        dxa[n][0] *= wa;
        dxa[n][1] *= wa;
        dxa[n][2] *= wb;
        dxa[n][3] *= wb;
      }
#pragma unroll
      for (int n = 0; n < N / 8; ++n) {
        dba[n][0] *= wa;
        dba[n][1] *= wa;
        dba[n][2] *= wb;
        dba[n][3] *= wb;
      }
      float e1a = 0.f, e1b = 0.f, ma = 0.f, mb = 0.f;
      for (int gt = j; gt < ng; ++gt) {
        const int t0 = 16 * gt;
        const int nr = t0 + (lane % 8) + (lane / 16) * 8, nk = (lane / 8) % 2;
        float gs[2][4] = {}, cb[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < KP; ++kk) {
          uint32_t f[4];
          ldsm_x4(y_sm + swz<P>(nr, 2 * kk + nk), f);
          mma16816(gs[0], xa[kk], f[0], f[1]);
          mma16816(gs[1], xa[kk], f[2], f[3]);
        }
#pragma unroll
        for (int kk = 0; kk < KN; ++kk) {
          uint32_t f[4];
          ldsm_x4(c_sm + swz<N>(nr, 2 * kk + nk), f);
          mma16816(cb[0], ba[kk], f[0], f[1]);
          mma16816(cb[1], ba[kk], f[2], f[3]);
        }
        // rows s (this lane's sa_, sb_), columns t = t0 + 8 n8 + 2 t4 + (e & 1)
        const float pivot = seg2[t0];
        const float ra = ex2(pivot - sga), rb = ex2(pivot - sgb);
        uint32_t psc[4], pdc[4];
#pragma unroll
        for (int n8 = 0; n8 < 2; ++n8) {
          float sc[4], dc[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = t0 + 8 * n8 + 2 * t4 + (e & 1);
            const int s = e < 2 ? sa_ : sb_;
            float L;
            if (gt == j) {
              L = t >= s ? ex2(seg2[min(t, Qc - 1)] - (e < 2 ? sga : sgb)) : 0.f;
              if (t == s && s < Qc) dxx[s] = gs[n8][e];
            } else {
              L = (e < 2 ? ra : rb) * colt[t];
            }
            const float dts_ = e < 2 ? dta : dtb_;
            const float gl = gs[n8][e] * L, cl = cb[n8][e] * L;
            dc[e] = gl * dts_;
            sc[e] = cl * dts_;
            if (e < 2) {
              e1a = fmaf(gl, cb[n8][e], e1a);
              ma = fmaf(gs[n8][e], sc[e], ma);
            } else {
              e1b = fmaf(gl, cb[n8][e], e1b);
              mb = fmaf(gs[n8][e], sc[e], mb);
            }
          }
          psc[2 * n8] = pack_bf16(sc[0], sc[1]);
          psc[2 * n8 + 1] = pack_bf16(sc[2], sc[3]);
          pdc[2 * n8] = pack_bf16(dc[0], dc[1]);
          pdc[2 * n8 + 1] = pack_bf16(dc[2], dc[3]);
        }
        // A fragments: registers 0, 1 rows gr, gr + 8 at columns 2t4 (n8 tile
        // 0); 2, 3 the same at 8 + 2t4 (n8 tile 1)
        const uint32_t pa[4] = {psc[0], psc[1], psc[2], psc[3]};
        const uint32_t pd[4] = {pdc[0], pdc[1], pdc[2], pdc[3]};
        const int tr = t0 + (lane % 8) + ((lane / 8) % 2) * 8;
#pragma unroll
        for (int dd = 0; dd < KP; ++dd) {
          uint32_t vf[4];
          ldsm_x4_trans(y_sm + swz<P>(tr, 2 * dd + lane / 16), vf);
          mma16816(dxa[2 * dd], pa, vf[0], vf[1]);
          mma16816(dxa[2 * dd + 1], pa, vf[2], vf[3]);
        }
#pragma unroll
        for (int dd = 0; dd < KN; ++dd) {
          uint32_t vf[4];
          ldsm_x4_trans(c_sm + swz<N>(tr, 2 * dd + lane / 16), vf);
          mma16816(dba[2 * dd], pd, vf[0], vf[1]);
          mma16816(dba[2 * dd + 1], pd, vf[2], vf[3]);
        }
      }
      e1a = quad_sum(e1a);
      e1b = quad_sum(e1b);
      ma = quad_sum(ma);
      mb = quad_sum(mb);
      if (t4 == 0) {
        ddtq[sa_] = e1a;
        ddtq[sb_] = e1b;
        dsegc[sa_] = -ma;
        dsegc[sb_] = -mb;
        dwv[sa_] = dwa;
        dwv[sb_] = dwb;
      }
      // dx_s = ... + D dy_s, out in bf16; the head's dB_s, out in fp32
#pragma unroll
      for (int n = 0; n < P / 8; ++n) {
        const float2 ya = unpack_bf16(*reinterpret_cast<const uint32_t*>(
            smem + (y_sm - sbase) + swz<P>(sa_, n) + 4 * t4));
        const float2 yb = unpack_bf16(*reinterpret_cast<const uint32_t*>(
            smem + (y_sm - sbase) + swz<P>(sb_, n) + 4 * t4));
        const float v[4] = {fmaf(dskip, ya.x, dxa[n][0]), fmaf(dskip, ya.y, dxa[n][1]),
                            fmaf(dskip, yb.x, dxa[n][2]), fmaf(dskip, yb.y, dxa[n][3])};
        store_tile4(dxb + (long long)s0 * row_ss, row_ss, sa_, 8 * n, v, Qc, t4);
      }
#pragma unroll
      for (int n = 0; n < N / 8; ++n) store_tile4(dBb, bh_ss, sa_, 8 * n, dba[n], Qc, t4);
    }
  }

  // ---- the row walk: S_in replaces dS
  __syncthreads();
  for (int i = tid; i < P * N / 8; i += kThreads) {
    const int p = i / (N / 8), k = i % (N / 8);
    const float4* src = reinterpret_cast<const float4*>(sin_buf + moff + (long long)i * 8);
    const float4 u = src[0], v = src[1];
    *reinterpret_cast<uint4*>(mat + swz<N>(p, k)) =
        make_uint4(pack_bf16(u.x, u.y), pack_bf16(u.z, u.w), pack_bf16(v.x, v.y),
                   pack_bf16(v.z, v.w));
  }
  __syncthreads();
  for (int base = 0; base < ng; base += 2 * kWarps) {
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const int i = base + (half ? 2 * kWarps - 1 - warp : warp);
      if (i >= ng) continue;
      const int r0 = 16 * i;
      const int ta = r0 + gr, tb = ta + 8;
      uint32_t ya[KP][4], ca[KN][4];
      const int lr = r0 + (lane % 8) + ((lane / 8) % 2) * 8;
#pragma unroll
      for (int kk = 0; kk < KP; ++kk) ldsm_x4(y_sm + swz<P>(lr, 2 * kk + lane / 16), ya[kk]);
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) ldsm_x4(c_sm + swz<N>(lr, 2 * kk + lane / 16), ca[kk]);
      float dca[N / 8][4] = {};
      // W = dy_t S_in
#pragma unroll
      for (int nn = 0; nn < KN; ++nn) {
#pragma unroll
        for (int kk = 0; kk < KP; ++kk) {
          uint32_t f[4];
          ldsm_x4_trans(
              m_sm + swz<N>(16 * kk + (lane % 8) + ((lane / 8) % 2) * 8, 2 * nn + lane / 16), f);
          mma16816(dca[2 * nn], ya[kk], f[0], f[1]);
          mma16816(dca[2 * nn + 1], ya[kk], f[2], f[3]);
        }
      }
      // C_t . W_t
      float cwa = 0.f, cwb = 0.f;
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
        const float2 v0 = unpack_bf16(ca[kk][0]), v1 = unpack_bf16(ca[kk][1]),
                     v2 = unpack_bf16(ca[kk][2]), v3 = unpack_bf16(ca[kk][3]);
        cwa = fmaf(v0.x, dca[2 * kk][0], cwa);
        cwa = fmaf(v0.y, dca[2 * kk][1], cwa);
        cwa = fmaf(v2.x, dca[2 * kk + 1][0], cwa);
        cwa = fmaf(v2.y, dca[2 * kk + 1][1], cwa);
        cwb = fmaf(v1.x, dca[2 * kk][2], cwb);
        cwb = fmaf(v1.y, dca[2 * kk][3], cwb);
        cwb = fmaf(v3.x, dca[2 * kk + 1][2], cwb);
        cwb = fmaf(v3.y, dca[2 * kk + 1][3], cwb);
      }
      cwa = quad_sum(cwa);
      cwb = quad_sum(cwb);
      const float sga = seg2[min(ta, Qc - 1)], sgb = seg2[min(tb, Qc - 1)];
      const float ea = ta < Qc ? ex2(sga) : 0.f, eb = tb < Qc ? ex2(sgb) : 0.f;
#pragma unroll
      for (int n = 0; n < N / 8; ++n) {
        dca[n][0] *= ea;
        dca[n][1] *= ea;
        dca[n][2] *= eb;
        dca[n][3] *= eb;
      }
      float ma = 0.f, mb = 0.f;
      for (int gs_ = 0; gs_ <= i; ++gs_) {
        const int c0 = 16 * gs_;
        const int nr = c0 + (lane % 8) + (lane / 16) * 8, nk = (lane / 8) % 2;
        float gm[2][4] = {}, cb[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < KP; ++kk) {
          uint32_t f[4];
          ldsm_x4(x_sm + swz<P>(nr, 2 * kk + nk), f);
          mma16816(gm[0], ya[kk], f[0], f[1]);
          mma16816(gm[1], ya[kk], f[2], f[3]);
        }
#pragma unroll
        for (int kk = 0; kk < KN; ++kk) {
          uint32_t f[4];
          ldsm_x4(b_sm + swz<N>(nr, 2 * kk + nk), f);
          mma16816(cb[0], ca[kk], f[0], f[1]);
          mma16816(cb[1], ca[kk], f[2], f[3]);
        }
        // rows t (ta, tb), columns s = c0 + 8 n8 + 2 t4 + (e & 1): below the
        // diagonal exp(seg_t - seg_s) dt_s = 2^(seg2_t - pivot) colf_s
        const float pivot = seg2[min(c0 + 15, Qc - 1)];
        const float ra = ex2(sga - pivot), rb = ex2(sgb - pivot);
        uint32_t pd[4];
#pragma unroll
        for (int n8 = 0; n8 < 2; ++n8) {
          float dc[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int s = c0 + 8 * n8 + 2 * t4 + (e & 1);
            float Lf;
            if (gs_ == i) {
              const int t = e < 2 ? ta : tb, sc_ = min(s, Qc - 1);
              Lf = s <= t ? ex2((e < 2 ? sga : sgb) - seg2[sc_]) * dtc[sc_] : 0.f;
            } else {
              Lf = (e < 2 ? ra : rb) * colf[s];
            }
            dc[e] = gm[n8][e] * Lf;
            if (e < 2)
              ma = fmaf(dc[e], cb[n8][e], ma);
            else
              mb = fmaf(dc[e], cb[n8][e], mb);
          }
          pd[2 * n8] = pack_bf16(dc[0], dc[1]);
          pd[2 * n8 + 1] = pack_bf16(dc[2], dc[3]);
        }
        const int sr = c0 + (lane % 8) + ((lane / 8) % 2) * 8;
#pragma unroll
        for (int dd = 0; dd < KN; ++dd) {
          uint32_t vf[4];
          ldsm_x4_trans(b_sm + swz<N>(sr, 2 * dd + lane / 16), vf);
          mma16816(dca[2 * dd], pd, vf[0], vf[1]);
          mma16816(dca[2 * dd + 1], pd, vf[2], vf[3]);
        }
      }
      ma = quad_sum(ma);
      mb = quad_sum(mb);
      if (t4 == 0) {
        dsegr[ta] = ma + ea * cwa;
        dsegr[tb] = mb + eb * cwb;
      }
#pragma unroll
      for (int n = 0; n < N / 8; ++n) store_tile4(dCb, bh_ss, ta, 8 * n, dca[n], Qc, t4);
    }
  }

  // ---- the tail: seg = cumsum(dt A), total = seg[Qc - 1]: ddt, dA, dD
  __syncthreads();
  const int per = (Qc + kThreads - 1) / kThreads;
  const int lo = min(tid * per, Qc), hi = min(lo + per, Qc);
  float dw_run = 0.f;
  for (int q = lo; q < hi; ++q) {   // w_s = exp(total - seg_s) dt_s: its seg_s share
    const float wd = ex2(last2 - seg2[q]) * dtc[q] * dwv[q];
    dsegc[q] += dsegr[q] - wd;
    dw_run += wd;
  }
  const float dw_tot = block_sum(dw_run, red);
  if (hi == Qc && lo < hi) dsegc[Qc - 1] += dtot + dw_tot;   // total's share
  // d(dt_q A) = sum_{t >= q} d seg_t: a reverse scan of the threads' runs
  float run = 0.f;
  for (int q = hi - 1; q >= lo; --q) run += dsegc[q];
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_down_sync(0xffffffffu, incl, off);
    if (lane + off < 32) incl += v;
  }
  __syncthreads();   // block_sum's readers of red are done
  if (lane == 0) red[warp] = incl;
  __syncthreads();
  float above = incl - run;
  for (int w = warp + 1; w < kWarps; ++w) above += red[w];
  float da_run = 0.f, dd_run = 0.f;
  float* ddtb = ddt + ((long long)b * S * H + h);
  for (int q = hi - 1; q >= lo; --q) {
    above += dsegc[q];
    da_run = fmaf(dtc[q], above, da_run);
    dd_run += dxx[q];
    ddtb[(long long)(s0 + q) * H] = ddtq[q] + ex2(last2 - seg2[q]) * dwv[q] + a * above;
  }
  const float da_sum = block_sum(da_run, red);
  const float dd_sum = block_sum(dd_run, red);
  if (tid == 0) {
    const long long t = ((long long)b * nc + c) * H + h;
    dApart[t] = da_sum;
    dDpart[t] = dd_sum;
  }
}

// sets a kernel's shared-memory limit once per device
template <typename K>
cudaError_t raise_smem(K kernel, bool (&done)[repro::kMaxDevices]) {
  int dev = 0;
  cudaError_t err = repro::current_device(&dev);
  if (err != cudaSuccess || done[dev]) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kMaxSmem);
  if (err == cudaSuccess) done[dev] = true;
  return err;
}

template <int P, int N>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* B, const void* C,
                   const void* D, const void* init, const void* dy, const void* dfinal,
                   void* dx, void* ddt, void* dA, void* dB, void* dC, void* dD, void* dinit,
                   void* states, void* ubuf, void* totals, void* dBh, void* dCh, void* dApart,
                   void* dDpart, int Bz, int S, int H, int G, int Q, Strides xs, Strides dts,
                   Strides bs, Strides cs, cudaStream_t stream) {
  const size_t ssm = state_smem_bytes(P, N, Q), gsm = grad_smem_bytes(P, N, Q);
  if (ssm > kMaxSmem || gsm > kMaxSmem) return cudaErrorInvalidValue;
  static bool state_attr[repro::kMaxDevices] = {}, grad_attr[repro::kMaxDevices] = {};
  cudaError_t err = raise_smem(chunk_state_tc_kernel<P, N>, state_attr);
  if (err == cudaSuccess) err = raise_smem(chunk_grad_tc_kernel<P, N>, grad_attr);
  if (err != cudaSuccess) return err;
  const int nc = (S + Q - 1) / Q;
  const dim3 grid(nc, H, Bz);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* bp = static_cast<const bf16*>(B);
  const bf16* cp = static_cast<const bf16*>(C);
  const bf16* dyp = static_cast<const bf16*>(dy);
  const float* dtp = static_cast<const float*>(dt);
  const float* ap = static_cast<const float*>(A);
  chunk_state_tc_kernel<P, N><<<grid, kThreads, ssm, stream>>>(
      xp, dtp, ap, bp, cp, dyp, static_cast<float*>(states), static_cast<float*>(ubuf),
      static_cast<float*>(totals), S, H, G, Q, xs, dts, bs, cs);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int PN = P * N;
  state_scan_kernel<<<dim3((PN + kThreads - 1) / kThreads, H, Bz), kThreads, 0, stream>>>(
      static_cast<float*>(states), static_cast<float*>(ubuf),
      static_cast<const float*>(totals), static_cast<const float*>(init),
      static_cast<const float*>(dfinal), static_cast<float*>(dinit), nc, H, PN);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  chunk_grad_tc_kernel<P, N><<<grid, kThreads, gsm, stream>>>(
      xp, dtp, ap, bp, cp, static_cast<const float*>(D), dyp,
      static_cast<const float*>(states), static_cast<const float*>(ubuf),
      static_cast<bf16*>(dx), static_cast<float*>(ddt), static_cast<float*>(dBh),
      static_cast<float*>(dCh), static_cast<float*>(dApart), static_cast<float*>(dDpart), S,
      H, G, Q, xs, dts, bs, cs);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return sum_heads<bf16>(dB, dC, dA, dD, dBh, dCh, dApart, dDpart, Bz, S, H, G, N, nc, stream);
}

template <int P>
cudaError_t dispatch_n(int N, const void* x, const void* dt, const void* A, const void* B,
                       const void* C, const void* D, const void* init, const void* dy,
                       const void* dfinal, void* dx, void* ddt, void* dA, void* dB, void* dC,
                       void* dD, void* dinit, void* states, void* ubuf, void* totals,
                       void* dBh, void* dCh, void* dApart, void* dDpart, int Bz, int S, int H,
                       int G, int Q, Strides xs, Strides dts, Strides bs, Strides cs,
                       cudaStream_t stream) {
#define REPRO_SSD_BWD_TC_N(NN)                                                               \
  case NN:                                                                                  \
    return launch<P, NN>(x, dt, A, B, C, D, init, dy, dfinal, dx, ddt, dA, dB, dC, dD, dinit, \
                         states, ubuf, totals, dBh, dCh, dApart, dDpart, Bz, S, H, G, Q, xs,  \
                         dts, bs, cs, stream);
  switch (N) {
    REPRO_SSD_BWD_TC_N(16)
    REPRO_SSD_BWD_TC_N(32)
    REPRO_SSD_BWD_TC_N(64)
    REPRO_SSD_BWD_TC_N(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_SSD_BWD_TC_N
}

}  // namespace tc

}  // namespace

// x (Bz,S,H,P), B and C (Bz,S,G,N) in one dtype and dt (Bz,S,H) fp32, read
// through their batch, sequence and head strides (unit stride on the last
// axis); A, D (H,) fp32; init and dfinal (Bz,H,P,N) fp32 or null; dy
// contiguous (Bz,S,H,P) in x's dtype. Writes dx (contiguous, x's dtype), ddt
// (contiguous fp32), dA, dD (H,) fp32, dB, dC (contiguous (Bz,S,G,N), B's
// dtype) and dinit (fp32, if not null). Scratch, all fp32 and contiguous:
// states and ubuf (Bz, nc, H, P, N), totals, dApart and dDpart (Bz, nc, H),
// dBh and dCh (Bz, S, H, N). variant 0 runs the CUDA-core kernels: P and N
// multiples of 4, and the larger of their shared memories
// (kernels/ssd/ops.py::bwd_smem_bytes) within a block's. variant 1 the
// tensor-core ones: bfloat16, P and N in {16, 32, 64, 128}, x, B and C
// strides that are multiples of 8, 16-byte-aligned x, B, C and dy, and both
// kernels' shared memory within a block's; it refuses anything else (the
// caller chooses; nothing falls back). Returns the CUDA error of the
// launches (0 on success).
extern "C" int ssd_bwd(const void* x, const void* dt, const void* A, const void* B,
                       const void* C, const void* D, const void* init, const void* dy,
                       const void* dfinal, void* dx, void* ddt, void* dA, void* dB, void* dC,
                       void* dD, void* dinit, void* states, void* ubuf, void* totals, void* dBh,
                       void* dCh, void* dApart, void* dDpart, int dtype, int variant, int Bz,
                       int S, int H, int G, int P, int N, int Q, long long xs_b, long long xs_s,
                       long long xs_h, long long dts_b, long long dts_s, long long dts_h,
                       long long bs_b, long long bs_s, long long bs_h, long long cs_b,
                       long long cs_s, long long cs_h, void* stream) {
  if (Bz < 1 || S < 1 || H < 1 || G < 1 || H % G || P % 4 || N % 4 || P < 4 || N < 4 ||
      Q < 1 || (variant != 0 && variant != 1))
    return cudaErrorInvalidValue;
  const Strides xs{xs_b, xs_s, xs_h}, dts{dts_b, dts_s, dts_h}, bs{bs_b, bs_s, bs_h},
      cs{cs_b, cs_s, cs_h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    bool ok = dtype == repro::kBFloat16;
    for (const Strides& st : {xs, bs, cs}) ok = ok && st.b % 8 == 0 && st.s % 8 == 0 && st.h % 8 == 0;
    for (const void* p : {x, B, C, dy}) ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
    if (!ok) return cudaErrorInvalidValue;
#define REPRO_SSD_BWD_TC_P(PP)                                                                \
  case PP:                                                                                   \
    return tc::dispatch_n<PP>(N, x, dt, A, B, C, D, init, dy, dfinal, dx, ddt, dA, dB, dC, dD, \
                              dinit, states, ubuf, totals, dBh, dCh, dApart, dDpart, Bz, S, H, \
                              G, Q, xs, dts, bs, cs, s);
    switch (P) {
      REPRO_SSD_BWD_TC_P(16)
      REPRO_SSD_BWD_TC_P(32)
      REPRO_SSD_BWD_TC_P(64)
      REPRO_SSD_BWD_TC_P(128)
      default:
        return cudaErrorInvalidValue;
    }
#undef REPRO_SSD_BWD_TC_P
  }
  switch (dtype) {
    case repro::kFloat32:
      return launch<float>(x, dt, A, B, C, D, init, dy, dfinal, dx, ddt, dA, dB, dC, dD, dinit,
                           states, ubuf, totals, dBh, dCh, dApart, dDpart, Bz, S, H, G, P, N,
                           Q, xs, dts, bs, cs, s);
    case repro::kBFloat16:
      return launch<__nv_bfloat16>(x, dt, A, B, C, D, init, dy, dfinal, dx, ddt, dA, dB, dC,
                                   dD, dinit, states, ubuf, totals, dBh, dCh, dApart, dDpart,
                                   Bz, S, H, G, P, N, Q, xs, dts, bs, cs, s);
    default:
      return cudaErrorInvalidValue;
  }
}
