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
// Five kernels on the caller's stream, all reductions in a fixed order (no
// atomics: every output is the same bit for bit from run to run):
//  1. chunk_state_kernel, a block per (chunk, head, batch): the chunk's state
//     contribution sum_s w_s x_s B_s^T and U = sum_t exp(seg_t) dy_t C_t^T,
//     both (P x N) fp32, and the chunk's total;
//  2. state_scan_kernel, a thread per (batch, head, state element): the
//     state entering each chunk, S_in, forward over the chunks, and the
//     gradient of each chunk's outgoing state, dS = exp(total) dS' + U',
//     backward over them (the one leaving chunk 0 is the initial state's);
//  3. chunk_grad_kernel, a block per (chunk, head, batch): every gradient of
//     the chunk from its S_in and dS, in tiles of KT positions (32, or 16
//     where shared memory would not hold 32 at P = 128). One walk over the
//     column tiles s gives dx_s and the head's dB_s: their state terms
//     w_s dS B_s and w_s dS^T x_s, then for each row tile t >= s the masked
//     score tiles G = dy_t x_s^T and C_t B_s^T, their products with dy_t,
//     C_t (dx_s, dB_s) and B_s (the score terms of dC_t, added into the
//     head's fp32 dC rows in column order), and the row and column sums that
//     give seg's gradient; a short walk over the row tiles adds dC_t's state
//     term exp(seg_t) S_in^T dy_t and seg's share through exp(seg_t) C_t .
//     S_in; a reverse cumsum turns seg's gradient into ddt and the chunk's dA
//     share;
//  4. group_sum_kernel: dB and dC summed over the heads of each group in
//     head order, rounded once;
//  5. head_sum_kernel: dA and dD summed over (batch, chunk) in order.
//
// What bounds it on the H100, at Mamba2-1.3B's training shape x (2, 2048,
// 64, 64) bf16, B and C (2, 2048, 1, 128), chunk 256: its operations. Taken
// at their least (C.B^T once per group, the causal triangle only), the
// products are ~52 GFLOP a layer, ~0.05 ms on the bf16 tensor cores; its
// bytes (x, dy, B, C, dt read once, dx, dB, dC, ddt written once) are ~57 MB,
// ~0.02 ms. This first version computes per head, in fp32 on the CUDA cores
// (67 TFLOP/s): ~28 G fused multiply-adds a layer, every product a loop in
// which each thread owns a 2x2 to 4x4 patch of an output held in shared
// memory (or, for dC, in the fp32 scratch rows), its operands kept in
// shared memory in the layout (position-major or position-minor) that lets
// both be read as 8- or 16-byte vectors. What holds it at ~7 ms a layer on
// an H100 (~15% of the fp32 FMA rate): one 182 KB block an SM, no overlap
// of a tile's loads with the products, the score sums on one warp between
// barriers, and fp32 FMAs at all. The way to its bound is the tensor cores
// (bf16 products, fp32 accumulators, as csrc/ssd.cu's forward does).
#include <math.h>
#include <stdint.h>

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
// states[c] <- S_in of chunk c; ubuf[c] <- the gradient of chunk c's S_out
__global__ void __launch_bounds__(kThreads)
state_scan_kernel(float* __restrict__ states, float* __restrict__ ubuf,
                  const float* __restrict__ totals, const float* __restrict__ init,
                  const float* __restrict__ dfinal, float* __restrict__ dinit, int nc, int H,
                  int PN) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= PN) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long one = ((long long)b * H + h) * PN + e;
  float s = init ? init[one] : 0.f;
  for (int c = 0; c < nc; ++c) {
    const long long t = ((long long)b * nc + c) * H + h;
    const long long i = t * PN + e;
    const float add = states[i];
    states[i] = s;
    s = fmaf(s, expf(totals[t]), add);
  }
  float gr = dfinal ? dfinal[one] : 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const long long t = ((long long)b * nc + c) * H + h;
    const long long i = t * PN + e;
    const float add = ubuf[i];
    ubuf[i] = gr;
    gr = fmaf(gr, expf(totals[t]), add);
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

  const long long rows = (long long)Bz * S;
  const long long n_out = rows * G * N;
  const unsigned blocks = (unsigned)((n_out + kThreads - 1) / kThreads);
  group_sum_kernel<T><<<blocks, kThreads, 0, stream>>>(static_cast<const float*>(dBh),
                                                       static_cast<T*>(dB), rows, H, G, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  group_sum_kernel<T><<<blocks, kThreads, 0, stream>>>(static_cast<const float*>(dCh),
                                                       static_cast<T*>(dC), rows, H, G, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  head_sum_kernel<<<(H + 127) / 128, 128, 0, stream>>>(
      static_cast<const float*>(dApart), static_cast<const float*>(dDpart),
      static_cast<float*>(dA), static_cast<float*>(dD), Bz * nc, H);
  return cudaGetLastError();
}

}  // namespace

// x (Bz,S,H,P), B and C (Bz,S,G,N) in one dtype and dt (Bz,S,H) fp32, read
// through their batch, sequence and head strides (unit stride on the last
// axis); A, D (H,) fp32; init and dfinal (Bz,H,P,N) fp32 or null; dy
// contiguous (Bz,S,H,P) in x's dtype. Writes dx (contiguous, x's dtype), ddt
// (contiguous fp32), dA, dD (H,) fp32, dB, dC (contiguous (Bz,S,G,N), B's
// dtype) and dinit (fp32, if not null). Scratch, all fp32 and contiguous:
// states and ubuf (Bz, nc, H, P, N), totals, dApart and dDpart (Bz, nc, H),
// dBh and dCh (Bz, S, H, N). P and N must be multiples of 4, and the larger
// of state_smem_bytes and grad_smem_bytes (kernels/ssd/ops.py::bwd_smem_bytes)
// must fit a block's shared memory. Returns the CUDA error of
// the launches (0 on success).
extern "C" int ssd_bwd(const void* x, const void* dt, const void* A, const void* B,
                       const void* C, const void* D, const void* init, const void* dy,
                       const void* dfinal, void* dx, void* ddt, void* dA, void* dB, void* dC,
                       void* dD, void* dinit, void* states, void* ubuf, void* totals, void* dBh,
                       void* dCh, void* dApart, void* dDpart, int dtype, int Bz, int S, int H,
                       int G, int P, int N, int Q, long long xs_b, long long xs_s,
                       long long xs_h, long long dts_b, long long dts_s, long long dts_h,
                       long long bs_b, long long bs_s, long long bs_h, long long cs_b,
                       long long cs_s, long long cs_h, void* stream) {
  if (Bz < 1 || S < 1 || H < 1 || G < 1 || H % G || P % 4 || N % 4 || P < 4 || N < 4 ||
      Q < 1)
    return cudaErrorInvalidValue;
  const Strides xs{xs_b, xs_s, xs_h}, dts{dts_b, dts_s, dts_h}, bs{bs_b, bs_s, bs_h},
      cs{cs_b, cs_s, cs_h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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

