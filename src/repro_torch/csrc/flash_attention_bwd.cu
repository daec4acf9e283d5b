// Flash-attention backward for Hopper (sm_90a): bf16 on the tensor cores,
// fp32 and unaligned views on the CUDA cores.
//
// The TPU kernel it pairs with (repro/kernels/flash_attention/kernel.py,
// _fwd_kernel) has no backward: the JAX package differentiates attention
// through the custom VJP of its chunked reference (repro/models/
// attention.py:168-204, flash_bwd). This kernel computes what flash_bwd
// computes, for the inputs the forward kernel takes, from the forward's
// out and per-row log-sum-exp (flash_attention.cu writes lse when asked):
//
//   P  = exp(softcap(scale q.k^T) + mask - lse)     recomputed, never stored
//   dV = P^T dO          dP = dO V^T          delta = rowsum(dO * O)
//   dS = P * (dP - delta), times 1 - (capped/softcap)^2 under softcap
//   dQ = scale dS K      dK = dS^T (scale q)
//
// GQA by head index (kv head = h / (Hq/Hkv)): dK and dV of a kv head sum
// over its q heads in a fixed order, the adjoint of the reference's
// _repeat_kv, with no atomics: two calls give the same bits. The masks are
// the forward's: column j is visible from row i iff j <= i (causal) and
// i - j < window (a window > 0: Gemma-3's local layers). A masked pair's P
// and dS are 0 through the predicate, never through exp of the mask value,
// and every form skips the tiles and chunks that the causal band and the
// window's band empty (a window leaves a kv tile at most window + 63 rows).
// Each tensor-core kernel is compiled twice, with the window (kWindow, the
// entry's choice for a window > 0) and without, where the window is never
// read: on an H100 the runtime tests in the inner loops cost the
// unwindowed streaming and short forms 30-40% of their time (chip_smoke.py
// phase 5). The window is their last parameter, so that the others keep
// the offsets they had before it came: a moved pair of parameters is
// loaded differently and the whole kernel scheduled anew (analysis/
// sass_diff.py). The CUDA-core kernels, which no bf16 training path runs,
// test it at run time.
//
// What bounds it on the H100: at the Mirage trunk's shape (640 sequences x
// 8 heads, S=144, D=32, bf16) it must read q, k, v, o, dO and write dq, dk,
// dv, ~0.38 GB, ~0.11 ms at 3.35 TB/s; at TinyLlama's training layer
// (2 x 2048, 32 q heads over 4 kv heads of 64, causal) its five products
// over the causal triangle are ~86 GFLOP, ~0.087 ms at the bf16 peak, and
// ~1.3 ms in fp32 on the CUDA cores (67 TFLOP/s). So every bf16 input goes
// to the tensor cores, and fp32 keeps a CUDA-core kernel. Two variants,
// chosen by the wrapper from the inputs before the launch
// (kernels/flash_attention/ops.py:_flash_bwd_variant), and the tensor-core
// one in three forms, chosen here from the shapes (mirrored by ops.py's
// bwd_tc_form; the entry's last argument can name one):
//
// "tc", bf16 with 16-byte rows (strides multiples of 8, aligned pointers),
// D a multiple of 16 up to 128 (each form takes each such D when named;
// the short form up to 64):
//  - the short form, for MHA heads with D <= 64 and both sequences <= 256
//    whose q, dO, K, V and dS^T fit one block's shared memory (the agent
//    trunk's): one block of 4 warps per (head, batch) copies q, dO, K and
//    V whole into shared memory (cp.async, XOR-swizzled 16-byte chunks, as
//    the forward's short form) and computes delta there. Phase 1: each
//    warp owns 16-row groups of K/V and walks the q rows in chunks of 16
//    (from the diagonal under the causal mask): S^T = K.q^T and dP^T =
//    V.dO^T on mma.sync.m16n8k16 (bf16 in, fp32 accumulators), P^T and
//    dS^T in fp32 registers, then dV += P^T.dO and dK += dS^T.q with P^T
//    and dS^T rounded to bf16 as A operands straight from the accumulators
//    (as the forward's P); dS^T is also stored to shared memory as bf16.
//    Phase 2, after one barrier: each warp owns 16-row groups of q and
//    computes dQ = dS.K, reading dS with transposed ldmatrix from the dS^T
//    it stored. dK, dV and dQ leave from the accumulators in 4-byte pairs.
//  - the Hopper streaming form (namespace wg below), for every other
//    input at D from 48 (GQA, D = 128, long and ragged sequences: every
//    LM training layer; 48 on its D = 64 kernels, 80, 96 and 112 on its D
//    = 128 ones, the padded twins whose global reads and writes stop at
//    the true D), the mma.sync streaming form's structure on
//    wgmma fed by TMA rings: at Command-R's training layer (2 x 2048
//    causal, 64 q heads over 8 of 128) the five products are 344 GFLOP,
//    0.348 ms at 989 TFLOP/s, against 0.302 GB moved, 0.090 ms, and the
//    mma.sync form ran at 15% of that bound, 2.47x SDPA's backward;
//  - the mma.sync streaming form, at D = 16 and 32 (GQA, long and
//    ragged sequences): FlashAttention-2's backward as two launches on the
//    stream, recomputing S and dP in each (7 products where the function
//    needs 5: the price of no dQ atomics and no fp32 dQ scratch).
//    The dq kernel: one block per (64-row q tile, q head, batch), 4 warps
//    of 16 rows, the longest causal rows first. It stores its rows' delta
//    for the second kernel; K and V stream through a double-buffered
//    cp.async ring of 64-row tiles that stops at the diagonal; per 32
//    columns of a tile, S = q.K^T and dP = dO.V^T, P and dS in fp32, then
//    dQ += dS.K with dS rounded to bf16 as an A operand from the
//    accumulators. q and dO fragments stay in registers at D <= 64 and are
//    read from shared memory per product at D = 128 (registers).
//    The dkdv kernel: one block per (64-row kv tile, kv head, share of the
//    head's q heads, batch), the first tiles (the most causal rows) first.
//    K and V stay resident; the block walks its q heads in order and, for
//    each, the q tiles from the first the causal mask lets see its rows,
//    with q, dO, lse and delta double-buffered; per 32 q rows, S^T = K.q^T
//    and dP^T = V.dO^T, then dV += P^T.dO and dK += dS^T.q (the short
//    form's phase 1 on streamed tiles). dK and dV sum over the q heads in
//    fp32 registers. Under the causal mask the first kv tiles see ~32x the
//    rows of the last, so a kv head's q heads may be split over several
//    blocks (the wrapper's split count): each then writes fp32 partials,
//    and a last pass sums them in split order and rounds once.
//
// "simt", fp32 (TF32 would break the 3e-5 fp32 bound) and views off 16
// bytes: two kernels on the stream, no atomics:
//  - compiled at D = 16, 32, 64 and 128, the true D their last argument:
//    any D up to 128 runs on the next of those, loads and stores masked
//    at the true D;
//  - dq: one block per (64-row q tile, q head, batch). A row's TPR = D/16
//    adjacent threads each own 16 head dims of scale*q, dO and the dQ
//    accumulator in registers, and reduce dot products with warp shuffles.
//    It computes the row's delta first (dO and O are read here once),
//    stores it for the second kernel, then walks K and V in shared tiles
//    (fp32), each column costing two dot products and one axpy.
//  - dkdv: one block per (64-row kv tile, kv head, batch). A thread owns 16
//    dims of its kv row's k, v, dK and dV; the block walks every q head of
//    its group and every q tile (from the first row the causal mask lets
//    see the block's columns), with scale*q, dO, lse and delta staged in
//    shared memory; each row costs two dot products and two axpys.
// All read q, k, v through (batch, sequence, head) strides, so the model's
// views need no copy; o, dO and the gradients are contiguous.
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "common.cuh"
#include "hopper.cuh"

namespace {

// variant and form codes shared with kernels/_build.py
constexpr int kSimt = 0, kTc = 1;
constexpr int kFormAuto = 0, kFormShort = 1, kFormStream = 2, kFormWg = 3;

using repro::from_f32;
using repro::to_f32;

constexpr int kDPT = 16;   // head dims per thread
constexpr int kRows = 64;  // q rows (dq) or kv rows (dkdv) per block

template <int D>
struct Shape {
  static constexpr int TPR = D / kDPT;            // threads per row
  static constexpr int THREADS = kRows * TPR;
  static constexpr int TILE = D == 128 ? 32 : 64;  // rows per shared tile (32 KB)
};

template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Rows [r0, r0 + TILE) of a (rows, D) operand with row stride rs, times mul,
// into a shared fp32 tile; rows at or past n and columns at or past the true
// head dim dt as zeros.
template <typename T, int D, int TILE, int THREADS>
__device__ __forceinline__ void stage(float (*tile)[D], const T* base, long long rs, int r0, int n,
                                      float mul, int dt) {
  for (int idx = threadIdx.x; idx < TILE * D; idx += THREADS) {
    const int r = idx / D, dd = idx % D, p = r0 + r;
    tile[r][dd] = p < n && dd < dt ? to_f32(base[(long long)p * rs + dd]) * mul : 0.f;
  }
}

// The probability and score gradient of one (row, column) pair from the raw
// scaled score s and the row's lse and delta: (p, ds).
__device__ __forceinline__ float2 prob_grad(float s, float dp, float lse, float delta,
                                            float softcap) {
  float x = s, fac = 1.f;
  if (softcap != 0.f) {
    const float t = tanhf(s / softcap);
    x = t * softcap;
    fac = 1.f - t * t;
  }
  const float p = expf(x - lse);
  return make_float2(p, p * (dp - delta) * fac);
}

// The CUDA-core dq kernel at D in {16, 32, 64, 128}, the next of those at
// or above the true head dim dt (its last parameter): columns dt..D-1 are
// read as zeros and never stored.
template <typename T, int D>
__global__ void __launch_bounds__(Shape<D>::THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    T* __restrict__ dq, int Hq, int group, int Sq, int Skv,
                    long long q_sb, long long q_ss, long long q_sh,
                    long long k_sb, long long k_ss, long long k_sh,
                    long long v_sb, long long v_ss, long long v_sh,
                    int causal, int window, float softcap, float scale, int dt) {
  constexpr int TPR = Shape<D>::TPR, THREADS = Shape<D>::THREADS, TILE = Shape<D>::TILE;
  __shared__ __align__(16) float ks[TILE][D];
  __shared__ __align__(16) float vs[TILE][D];

  const int b = blockIdx.z, h = blockIdx.y, hk = h / group;
  const int q_start = blockIdx.x * kRows;
  const int i = q_start + threadIdx.x / TPR;
  const int ic = min(i, Sq - 1);   // rows past Sq compute on the last row and store nothing
  const int d0 = (threadIdx.x % TPR) * kDPT;

  float qr[kDPT], gr[kDPT], acc[kDPT];
  const T* qp = q + b * q_sb + (long long)ic * q_ss + h * q_sh + d0;
  const long long orow = (((long long)b * Sq + ic) * Hq + h) * dt + d0;
  float dl = 0.f;
#pragma unroll
  for (int e = 0; e < kDPT; ++e) {
    const bool in = d0 + e < dt;
    qr[e] = in ? to_f32(qp[e]) * scale : 0.f;
    gr[e] = in ? to_f32(dout[orow + e]) : 0.f;
    dl = fmaf(gr[e], in ? to_f32(o[orow + e]) : 0.f, dl);
    acc[e] = 0.f;
  }
  dl = row_sum<TPR>(dl);
  const long long lrow = ((long long)b * Hq + h) * Sq + ic;
  const float L = lse[lrow];
  if (i < Sq && threadIdx.x % TPR == 0) delta[lrow] = dl;

  // the causal mask lets this block's rows see no column past its last
  // row, a window none at or before its first row's position - window
  const int kv_end = causal ? min(Skv, q_start + kRows) : Skv;
  const int kv_begin = window ? max(0, q_start - window + 1) / TILE * TILE : 0;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  for (int k0 = kv_begin; k0 < kv_end; k0 += TILE) {
    __syncthreads();   // every thread is done with the previous tile
    stage<T, D, TILE, THREADS>(ks, kb, k_ss, k0, Skv, 1.f, dt);
    stage<T, D, TILE, THREADS>(vs, vb, v_ss, k0, Skv, 1.f, dt);
    __syncthreads();
    const int jn = min(TILE, kv_end - k0);   // the same for every thread
#pragma unroll 2
    for (int jj = 0; jj < jn; ++jj) {
      const float* kr = &ks[jj][d0];
      const float* vr = &vs[jj][d0];
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int e = 0; e < kDPT; ++e) {
        s = fmaf(qr[e], kr[e], s);
        dp = fmaf(gr[e], vr[e], dp);
      }
      s = row_sum<TPR>(s);
      dp = row_sum<TPR>(dp);
      const int j = k0 + jj;
      const bool ok = (!causal || j <= i) && (!window || i - j < window);
      const float ds = ok ? prob_grad(s, dp, L, dl, softcap).y : 0.f;
#pragma unroll
      for (int e = 0; e < kDPT; ++e) acc[e] = fmaf(ds, kr[e], acc[e]);
    }
  }
  if (i < Sq) {
#pragma unroll
    for (int e = 0; e < kDPT; ++e)
      if (d0 + e < dt) dq[orow + e] = from_f32<T>(acc[e] * scale);
  }
}

// The CUDA-core dkdv kernel (D and dt as flash_bwd_dq_kernel's)
template <typename T, int D>
__global__ void __launch_bounds__(Shape<D>::THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      int Hq, int Hkv, int group, int Sq, int Skv,
                      long long q_sb, long long q_ss, long long q_sh,
                      long long k_sb, long long k_ss, long long k_sh,
                      long long v_sb, long long v_ss, long long v_sh,
                      int causal, int window, float softcap, float scale, int dt) {
  constexpr int TPR = Shape<D>::TPR, THREADS = Shape<D>::THREADS, TILE = Shape<D>::TILE;
  __shared__ __align__(16) float qs[TILE][D];
  __shared__ __align__(16) float gs[TILE][D];
  __shared__ float ls[TILE], dls[TILE];

  const int b = blockIdx.z, hk = blockIdx.y;
  const int k_start = blockIdx.x * kRows;
  const int j = k_start + threadIdx.x / TPR;
  const bool live = j < Skv;
  const int jc = min(j, Skv - 1);
  const int d0 = (threadIdx.x % TPR) * kDPT;

  float kr[kDPT], vr[kDPT], dka[kDPT], dva[kDPT];
  {
    const T* kp = k + b * k_sb + (long long)jc * k_ss + hk * k_sh + d0;
    const T* vp = v + b * v_sb + (long long)jc * v_ss + hk * v_sh + d0;
#pragma unroll
    for (int e = 0; e < kDPT; ++e) {
      const bool in = d0 + e < dt;
      kr[e] = in ? to_f32(kp[e]) : 0.f;
      vr[e] = in ? to_f32(vp[e]) : 0.f;
      dka[e] = dva[e] = 0.f;
    }
  }

  // causal: rows before the block's first column see none of its columns;
  // a window: nor rows past its last column's position + window - 1
  const int i_begin = causal ? k_start / TILE * TILE : 0;
  const int i_end = window ? min(Sq, min(Skv, k_start + kRows) - 1 + window) : Sq;
  for (int h = hk * group; h < (hk + 1) * group; ++h) {
    const T* qb = q + b * q_sb + h * q_sh;
    const T* gb = dout + (long long)b * Sq * Hq * dt + (long long)h * dt;
    const float* lb = lse + ((long long)b * Hq + h) * Sq;
    const float* db = delta + ((long long)b * Hq + h) * Sq;
    for (int i0 = i_begin; i0 < i_end; i0 += TILE) {
      __syncthreads();   // every thread is done with the previous tile
      stage<T, D, TILE, THREADS>(qs, qb, q_ss, i0, Sq, scale, dt);
      stage<T, D, TILE, THREADS>(gs, gb, (long long)Hq * dt, i0, Sq, 1.f, dt);
      for (int r = threadIdx.x; r < TILE; r += THREADS) {
        ls[r] = i0 + r < Sq ? lb[i0 + r] : 0.f;
        dls[r] = i0 + r < Sq ? db[i0 + r] : 0.f;
      }
      __syncthreads();
      const int in = min(TILE, i_end - i0);   // the same for every thread
#pragma unroll 2
      for (int ii = 0; ii < in; ++ii) {
        const float* qrow = &qs[ii][d0];
        const float* grow = &gs[ii][d0];
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int e = 0; e < kDPT; ++e) {
          s = fmaf(qrow[e], kr[e], s);
          dp = fmaf(grow[e], vr[e], dp);
        }
        s = row_sum<TPR>(s);
        dp = row_sum<TPR>(dp);
        float2 pg = make_float2(0.f, 0.f);
        const int i = i0 + ii;
        if (live && (!causal || j <= i) && (!window || i - j < window))
          pg = prob_grad(s, dp, ls[ii], dls[ii], softcap);
#pragma unroll
        for (int e = 0; e < kDPT; ++e) {
          dva[e] = fmaf(pg.x, grow[e], dva[e]);
          dka[e] = fmaf(pg.y, qrow[e], dka[e]);
        }
      }
    }
  }
  if (live) {
    const long long off = (((long long)b * Skv + j) * Hkv + hk) * dt + d0;
#pragma unroll
    for (int e = 0; e < kDPT; ++e) {
      if (d0 + e < dt) {
        dk[off + e] = from_f32<T>(dka[e]);
        dv[off + e] = from_f32<T>(dva[e]);
      }
    }
  }
}

// the two CUDA-core kernels at D for a true head dim dt <= D
template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int Hq,
                   int Hkv, int Sq, int Skv, const long long* qs, const long long* ks_,
                   const long long* vs_, int causal, int window, float softcap, float scale,
                   cudaStream_t stream, int dt) {
  constexpr int THREADS = Shape<D>::THREADS;
  const T *qp = static_cast<const T*>(q), *kp = static_cast<const T*>(k),
          *vp = static_cast<const T*>(v);
  const dim3 dq_grid((Sq + kRows - 1) / kRows, Hq, B), kv_grid((Skv + kRows - 1) / kRows, Hkv, B);
  flash_bwd_dq_kernel<T, D><<<dq_grid, THREADS, 0, stream>>>(
      qp, kp, vp, static_cast<const T*>(o), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), Hq, Hq / Hkv, Sq, Skv, qs[0], qs[1], qs[2], ks_[0], ks_[1], ks_[2],
      vs_[0], vs_[1], vs_[2], causal, window, softcap, scale, dt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T, D><<<kv_grid, THREADS, 0, stream>>>(
      qp, kp, vp, static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk),
      static_cast<T*>(dv), Hq, Hkv, Hq / Hkv, Sq, Skv, qs[0], qs[1], qs[2], ks_[0], ks_[1],
      ks_[2], vs_[0], vs_[1], vs_[2], causal, window, softcap, scale, dt);
  return cudaGetLastError();
}

// the CUDA-core kernels at any D from 1 to 128: the next of 16, 32, 64 and
// 128 at or above it
template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, int B, int Hq, int Hkv, int Sq, int Skv, const long long* qs,
                       const long long* ks_, const long long* vs_, int causal, int window,
                       float softcap, float scale, cudaStream_t stream) {
#define REPRO_FLASH_BWD_D(DD)                                                                  \
  return launch<T, DD>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, Sq, Skv, qs, ks_, \
                       vs_, causal, window, softcap, scale, stream, D);
  if (D < 1 || D > 128) return cudaErrorInvalidValue;
  if (D <= 16) REPRO_FLASH_BWD_D(16)
  if (D <= 32) REPRO_FLASH_BWD_D(32)
  if (D <= 64) REPRO_FLASH_BWD_D(64)
  REPRO_FLASH_BWD_D(128)
#undef REPRO_FLASH_BWD_D
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
using repro::mma16816_zero;
using repro::pack_bf16;
using repro::swz;

constexpr int THREADS = 128, WARPS = 4;
constexpr int kMaxS = 256;            // the dS^T tile holds 256 q columns a row
constexpr long long kMaxSmem = 232448;  // an H100 block's shared-memory ceiling
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr long long round16(long long x) { return (x + 15) / 16 * 16; }

// P and dS of one (q row, kv column) pair, in place of the raw score s =
// q.k (unscaled) and dp = dO.v, from the row's lse and delta; ok false
// masks the pair (P = dS = 0). Both tensor-core forms take their
// exponents, masks and softcap factor from here.
__device__ __forceinline__ void prob_ds(float& s, float& dp, float lse, float delta, float scale,
                                        float softcap, bool ok) {
  float x = s * scale, fac = 1.f;
  if (softcap != 0.f) {
    const float th = tanhf(x / softcap);
    x = th * softcap;
    fac = 1.f - th * th;
  }
  const float p = ok ? ex2((x - lse) * kLog2e) : 0.f;
  s = p;
  dp = p * (dp - delta) * fac;
}

// q and dO, K and V (bf16), dS^T (kv rows of kMaxS bf16), lse and delta
__host__ __device__ constexpr long long smem_bytes(int Sq, int Skv, int D) {
  return 4LL * D * (round16(Sq) + round16(Skv)) + round16(Skv) * kMaxS * 2 + 8 * round16(Sq);
}

template <int D, bool kWindow>
__global__ void __launch_bounds__(THREADS)
flash_bwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ o,
                    const bf16* __restrict__ dout, const float* __restrict__ lse,
                    bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                    int H, int Sq, int Skv,
                    long long q_sb, long long q_ss, long long q_sh,
                    long long k_sb, long long k_ss, long long k_sh,
                    long long v_sb, long long v_ss, long long v_sh,
                    int causal, float softcap, float scale, int window) {
  constexpr int CPR = D / 8;            // 16-byte chunks per row
  const int sq16 = (int)round16(Sq), skv16 = (int)round16(Skv);
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t s_q = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t s_do = s_q + sq16 * D * 2;
  const uint32_t s_k = s_do + sq16 * D * 2;
  const uint32_t s_v = s_k + skv16 * D * 2;
  const uint32_t s_dst = s_v + skv16 * D * 2;
  uint8_t* dst_ptr = smem + (s_dst - s_q);
  float* lse_s = reinterpret_cast<float*>(dst_ptr + skv16 * kMaxS * 2);
  float* delta_s = lse_s + sq16;

  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const long long o_row = (long long)H * D;   // row stride of o, dO, dq
  const bf16* ob = o + (long long)b * Sq * o_row + (long long)h * D;
  const bf16* gb = dout + (long long)b * Sq * o_row + (long long)h * D;

  // q, dO, K, V whole into shared memory; rows past the sequence as zeros
  {
    const int c = tid % CPR, rstep = THREADS / CPR;
    const bf16* qb = q + b * q_sb + h * q_sh + c * 8;
    const bf16* kb = k + b * k_sb + h * k_sh + c * 8;
    const bf16* vb = v + b * v_sb + h * v_sh + c * 8;
    for (int r = tid / CPR; r < sq16; r += rstep) {
      const bool ok = r < Sq;
      cp_async16(s_q + swz<D>(r, c), ok ? qb + (long long)r * q_ss : q, ok);
      cp_async16(s_do + swz<D>(r, c), ok ? gb + (long long)r * o_row + c * 8 : dout, ok);
    }
    for (int r = tid / CPR; r < skv16; r += rstep) {
      const bool ok = r < Skv;
      cp_async16(s_k + swz<D>(r, c), ok ? kb + (long long)r * k_ss : k, ok);
      cp_async16(s_v + swz<D>(r, c), ok ? vb + (long long)r * v_ss : v, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  // delta = rowsum(dO * O) from the staged dO and O read once; lse
  for (int r = tid; r < sq16; r += THREADS) {
    float dl = 0.f, L = 0.f;
    if (r < Sq) {
      for (int c = 0; c < CPR; ++c) {
        const uint4 gv = *reinterpret_cast<const uint4*>(smem + (s_do - s_q) + swz<D>(r, c));
        const uint4 ov = *reinterpret_cast<const uint4*>(ob + (long long)r * o_row + c * 8);
        const uint32_t gw[4] = {gv.x, gv.y, gv.z, gv.w}, ow[4] = {ov.x, ov.y, ov.z, ov.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 a = repro::unpack_bf16(gw[e]), bo = repro::unpack_bf16(ow[e]);
          dl = fmaf(a.x, bo.x, fmaf(a.y, bo.y, dl));
        }
      }
      L = lse[((long long)b * H + h) * Sq + r];
    }
    delta_s[r] = dl;
    lse_s[r] = L;
  }
  __syncthreads();

  // phase 1: dK, dV for this warp's kv row groups; dS^T to shared memory
  for (int jg = warp; jg < skv16 / 16; jg += WARPS) {
    uint32_t kA[D / 16][4], vA[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = swz<D>(16 * jg + (lane % 8) + ((lane / 8) % 2) * 8, 2 * kk + lane / 16);
      ldsm_x4(s_k + off, kA[kk]);
      ldsm_x4(s_v + off, vA[kk]);
    }
    float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

    // q chunks from the diagonal (causal) to the last row the window lets
    // see this group's last column, 16 jg + 15 + window - 1
    const int ic_end = kWindow ? min(sq16 / 16, (16 * jg + 14 + window) / 16 + 1) : sq16 / 16;
    for (int ic = causal ? jg : 0; ic < ic_end; ++ic) {
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off =
            swz<D>(16 * ic + (lane % 8) + (lane / 16) * 8, 2 * kk + (lane / 8) % 2);
        uint32_t qf[4], gf[4];
        ldsm_x4(s_q + off, qf);
        ldsm_x4(s_do + off, gf);
        if (kk == 0) {
          mma16816_zero(st[0], kA[kk], qf[0], qf[1]);
          mma16816_zero(st[1], kA[kk], qf[2], qf[3]);
          mma16816_zero(dpt[0], vA[kk], gf[0], gf[1]);
          mma16816_zero(dpt[1], vA[kk], gf[2], gf[3]);
        } else {
          mma16816(st[0], kA[kk], qf[0], qf[1]);
          mma16816(st[1], kA[kk], qf[2], qf[3]);
          mma16816(dpt[0], vA[kk], gf[0], gf[1]);
          mma16816(dpt[1], vA[kk], gf[2], gf[3]);
        }
      }
      // P^T and dS^T in fp32: element (t, e) is kv row j, q column i
#pragma unroll
      for (int t = 0; t < 2; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 16 * jg + g + (e >> 1) * 8;
          const int i = 16 * ic + 8 * t + 2 * t4 + (e & 1);
          prob_ds(st[t][e], dpt[t][e], lse_s[i], delta_s[i], scale, softcap,
                  i < Sq && j < Skv && (!causal || j <= i) && (!kWindow || i - j < window));
        }
        // dS^T to shared memory, rows j, columns i
        *reinterpret_cast<uint32_t*>(dst_ptr + swz<kMaxS>(16 * jg + g, 2 * ic + t) + 4 * t4) =
            pack_bf16(dpt[t][0], dpt[t][1]);
        *reinterpret_cast<uint32_t*>(dst_ptr + swz<kMaxS>(16 * jg + g + 8, 2 * ic + t) + 4 * t4) =
            pack_bf16(dpt[t][2], dpt[t][3]);
      }
      const uint32_t pA[4] = {pack_bf16(st[0][0], st[0][1]), pack_bf16(st[0][2], st[0][3]),
                              pack_bf16(st[1][0], st[1][1]), pack_bf16(st[1][2], st[1][3])};
      const uint32_t sA[4] = {pack_bf16(dpt[0][0], dpt[0][1]), pack_bf16(dpt[0][2], dpt[0][3]),
                              pack_bf16(dpt[1][0], dpt[1][1]), pack_bf16(dpt[1][2], dpt[1][3])};
      // dV += P^T.dO, dK += dS^T.q: dO and q as transposed B operands
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        const uint32_t off =
            swz<D>(16 * ic + (lane % 8) + ((lane / 8) % 2) * 8, 2 * dd + lane / 16);
        uint32_t gf[4], qf[4];
        ldsm_x4_trans(s_do + off, gf);
        ldsm_x4_trans(s_q + off, qf);
        mma16816(dv_acc[2 * dd], pA, gf[0], gf[1]);
        mma16816(dv_acc[2 * dd + 1], pA, gf[2], gf[3]);
        mma16816(dk_acc[2 * dd], sA, qf[0], qf[1]);
        mma16816(dk_acc[2 * dd + 1], sA, qf[2], qf[3]);
      }
    }
    // dK (times the scale that q.k^T carried) and dV, rows j < Skv
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = 16 * jg + g + 8 * half;
      if (j >= Skv) continue;
      const long long row = (((long long)b * Skv + j) * H + h) * D + 2 * t4;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<uint32_t*>(dk + row + 8 * n) =
            pack_bf16(dk_acc[n][2 * half] * scale, dk_acc[n][2 * half + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + row + 8 * n) =
            pack_bf16(dv_acc[n][2 * half], dv_acc[n][2 * half + 1]);
      }
    }
  }
  __syncthreads();   // every dS^T tile is stored

  // phase 2: dQ = dS.K for this warp's q row groups, dS read transposed
  for (int ig = warp; ig < sq16 / 16; ig += WARPS) {
    float dq_acc[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;
    // the kv chunks phase 1 stored for these rows: from the first the
    // window lets see row 16 ig to the diagonal (causal)
    const int jc_begin = kWindow ? max(0, 16 * ig - window + 1) / 16 : 0;
    const int jc_end = causal ? min(ig + 1, skv16 / 16) : skv16 / 16;
    for (int jc = jc_begin; jc < jc_end; ++jc) {
      uint32_t sA[4];
      ldsm_x4_trans(s_dst + swz<kMaxS>(16 * jc + (lane % 8) + (lane / 16) * 8,
                                       2 * ig + (lane / 8) % 2),
                    sA);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t kf[4];
        ldsm_x4_trans(s_k + swz<D>(16 * jc + (lane % 8) + ((lane / 8) % 2) * 8,
                                   2 * dd + lane / 16),
                      kf);
        mma16816(dq_acc[2 * dd], sA, kf[0], kf[1]);
        mma16816(dq_acc[2 * dd + 1], sA, kf[2], kf[3]);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = 16 * ig + g + 8 * half;
      if (i >= Sq) continue;
      const long long row = ((long long)b * Sq + i) * o_row + (long long)h * D + 2 * t4;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(dq + row + 8 * n) =
            pack_bf16(dq_acc[n][2 * half] * scale, dq_acc[n][2 * half + 1] * scale);
    }
  }
}

template <int D, bool kWindow>
cudaError_t launch_short(const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const float* lse, void* dq, void* dk, void* dv, int B,
                         int H, int Sq, int Skv, const long long* qs, const long long* ks_,
                         const long long* vs_, int causal, int window, float softcap,
                         float scale, cudaStream_t stream) {
  const long long bytes = smem_bytes(Sq, Skv, D);
  // the shared-memory limit is raised once per device
  static bool attr[repro::kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = repro::current_device(&dev);
  if (err != cudaSuccess) return err;
  if (!attr[dev]) {
    err = cudaFuncSetAttribute(flash_bwd_tc_kernel<D, kWindow>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (err != cudaSuccess) return err;
    attr[dev] = true;
  }
  flash_bwd_tc_kernel<D, kWindow><<<dim3(1, H, B), THREADS, (int)bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Sq, Skv, qs[0], qs[1], qs[2], ks_[0],
      ks_[1], ks_[2], vs_[0], vs_[1], vs_[2], causal, softcap, scale, window);
  return cudaGetLastError();
}


// ------------------------------------------------ tc, the streaming form
constexpr int BR = 64;   // rows a block owns: q rows (dq) or kv rows (dkdv), 4 warps x 16
constexpr int BT = 64;   // rows of a streamed tile: kv rows (dq) or q rows (dkdv)
constexpr int BC = 32;   // a tile's rows a warp takes at once (its columns of S or S^T)

// dq: q and dO (BR rows), K and V x 2 buffers, lse and delta of the BR rows
template <int D>
constexpr int dq_smem() { return 2 * BR * D * 2 + 4 * BT * D * 2 + 2 * BR * 4; }
// dkdv: K and V (BR rows), q and dO x 2 buffers, lse and delta x 2 buffers
template <int D>
constexpr int dkdv_smem() { return 2 * BR * D * 2 + 4 * BT * D * 2 + 4 * BT * 4; }

// Rows [r0, r0 + R) of a (rows, D) bf16 operand with row stride rs into a
// swizzled tile at dst (shared); rows at or past n as zeros.
template <int D, int R>
__device__ __forceinline__ void load_rows(uint32_t dst, const bf16* base, long long rs, int r0,
                                          int n, int tid) {
  constexpr int CPR = D / 8;
  for (int i = tid; i < R * CPR; i += THREADS) {
    const int r = i / CPR, c = i % CPR, p = r0 + r;
    const bool ok = p < n;
    cp_async16(dst + swz<D>(r, c), base + (long long)(ok ? p : 0) * rs + c * 8, ok);
  }
}

// A fragments (16 rows at r0, the k16 slice kk of D) of a swizzled tile
template <int D>
__device__ __forceinline__ void ldsm_a(uint32_t tile, int r0, int kk, int lane, uint32_t (&a)[4]) {
  ldsm_x4(tile + swz<D>(r0 + (lane % 8) + ((lane / 8) % 2) * 8, 2 * kk + lane / 16), a);
}

// B fragments of two n8 tiles (rows r0 and r0 + 8 of a tile) for a
// product over D: element (d, row) of tile^T
template <int D>
__device__ __forceinline__ void ldsm_b(uint32_t tile, int r0, int kk, int lane, uint32_t (&b)[4]) {
  ldsm_x4(tile + swz<D>(r0 + (lane % 8) + (lane / 16) * 8, 2 * kk + (lane / 8) % 2), b);
}

// B fragments of the n8 tiles 2dd and 2dd + 1 of D for a product over
// rows [r0, r0 + 16) of a tile: element (row, d)
template <int D>
__device__ __forceinline__ void ldsm_bt(uint32_t tile, int r0, int dd, int lane,
                                        uint32_t (&b)[4]) {
  ldsm_x4_trans(tile + swz<D>(r0 + (lane % 8) + ((lane / 8) % 2) * 8, 2 * dd + lane / 16), b);
}

// 16 fp32 rows of a warp's (16 x D) accumulator, times mul, as bf16 rows
// [r0, r0 + 16) of the swizzled tile at smem (rows only this warp uses),
// then in 16-byte chunks to dst row p0 + r (row stride rs) while p0 + r < n
template <int D>
__device__ __forceinline__ void store_acc(const float (&acc)[D / 8][4], float mul, uint8_t* smem,
                                          int r0, bf16* dst, long long rs, int p0, int n,
                                          int lane) {
  constexpr int CPR = D / 8;
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    *reinterpret_cast<uint32_t*>(smem + swz<D>(r0 + g, c) + 4 * t4) =
        pack_bf16(acc[c][0] * mul, acc[c][1] * mul);
    *reinterpret_cast<uint32_t*>(smem + swz<D>(r0 + g + 8, c) + 4 * t4) =
        pack_bf16(acc[c][2] * mul, acc[c][3] * mul);
  }
  __syncwarp();
  for (int i = lane; i < 16 * CPR; i += 32) {
    const int r = i / CPR, c = i % CPR;
    if (p0 + r < n)
      *reinterpret_cast<uint4*>(dst + (long long)(p0 + r) * rs + c * 8) =
          *reinterpret_cast<const uint4*>(smem + swz<D>(r0 + r, c));
  }
}

template <int D, bool kWindow>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ o,
                       const bf16* __restrict__ dout, const float* __restrict__ lse,
                       float* __restrict__ delta, bf16* __restrict__ dq,
                       int Hq, int group, int Sq, int Skv,
                       long long q_sb, long long q_ss, long long q_sh,
                       long long k_sb, long long k_ss, long long k_sh,
                       long long v_sb, long long v_ss, long long v_sh,
                       int causal, float softcap, float scale, int window) {
  constexpr int CPR = D / 8;
  constexpr int TILE = BT * D * 2;
  constexpr bool kRegA = D <= 64;   // q and dO fragments kept in registers
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t s_q = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t s_do = s_q + BR * D * 2;
  const uint32_t s_k = s_do + BR * D * 2, s_v = s_k + 2 * TILE;
  float* lse_s = reinterpret_cast<float*>(smem + 2 * BR * D * 2 + 4 * TILE);
  float* delta_s = lse_s + BR;

  const int h = blockIdx.x, b = blockIdx.y, hk = h / group;
  // under the causal mask the last q tiles see the most columns: they start first
  const int n_qt = (Sq + BR - 1) / BR;
  const int q_start = (causal ? n_qt - 1 - (int)blockIdx.z : (int)blockIdx.z) * BR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const long long o_row = (long long)Hq * D;   // row stride of o, dO, dq
  const long long orow0 = (long long)b * Sq * o_row + (long long)h * D;

  // kv tiles that hold an unmasked column for some row of this block:
  // causal keeps columns <= its last row, a window columns > its first
  // row's position - window
  const int kv_end = causal ? min(Skv, q_start + BR) : Skv;
  const int t_begin = kWindow ? max(0, q_start - window + 1) / BT : 0;
  const int n_tiles = (kv_end + BT - 1) / BT;
  const bf16* kb = k + b * k_sb + hk * k_sh;
  const bf16* vb = v + b * v_sb + hk * v_sh;
  auto load_kv = [&](int t, int buf) {
    load_rows<D, BT>(s_k + buf * TILE, kb, k_ss, t * BT, Skv, tid);
    load_rows<D, BT>(s_v + buf * TILE, vb, v_ss, t * BT, Skv, tid);
  };
  load_rows<D, BR>(s_q, q + b * q_sb + h * q_sh, q_ss, q_start, Sq, tid);
  load_rows<D, BR>(s_do, dout + orow0, o_row, q_start, Sq, tid);
  cp_async_commit();
  if (!kWindow || t_begin < n_tiles) load_kv(t_begin, t_begin & 1);   // a band past Skv: none
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();   // q and dO have landed

  // delta = rowsum(dO * O), two threads a row, each half of its chunks;
  // stored for the dkdv kernel
  {
    const int r = tid / 2, half = tid % 2, p = q_start + r;
    float dl = 0.f;
    if (p < Sq) {
      const bf16* orow = o + orow0 + (long long)p * o_row;
      for (int c = half * CPR / 2; c < (half + 1) * CPR / 2; ++c) {
        const uint4 gv = *reinterpret_cast<const uint4*>(smem + (s_do - s_q) + swz<D>(r, c));
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c * 8);
        const uint32_t gw[4] = {gv.x, gv.y, gv.z, gv.w}, ow[4] = {ov.x, ov.y, ov.z, ov.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 a = repro::unpack_bf16(gw[e]), bo = repro::unpack_bf16(ow[e]);
          dl = fmaf(a.x, bo.x, fmaf(a.y, bo.y, dl));
        }
      }
    }
    dl += __shfl_xor_sync(0xffffffffu, dl, 1);
    if (half == 0) {
      const long long lrow = ((long long)b * Hq + h) * Sq + p;
      delta_s[r] = dl;
      lse_s[r] = p < Sq ? lse[lrow] : 0.f;
      if (p < Sq) delta[lrow] = dl;
    }
  }
  __syncthreads();

  const int r0 = warp * 16, p0 = q_start + r0;   // this warp's rows, their first position
  const bool active = p0 < Sq;
  const float L0 = lse_s[r0 + g], L1 = lse_s[r0 + g + 8];
  const float D0 = delta_s[r0 + g], D1 = delta_s[r0 + g + 8];
  uint32_t qf[kRegA ? D / 16 : 1][4], gf[kRegA ? D / 16 : 1][4];
  if constexpr (kRegA) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      ldsm_a<D>(s_q, r0, kk, lane, qf[kk]);
      ldsm_a<D>(s_do, r0, kk, lane, gf[kk]);
    }
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int t = t_begin; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      load_kv(t + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // tile t has landed
    const uint32_t kt = s_k + buf * TILE, vt = s_v + buf * TILE;
#pragma unroll 1
    for (int c = 0; active && c < BT / BC; ++c) {
      const int c0 = t * BT + c * BC;   // the chunk's first kv column
      if (c0 >= Skv || (causal && c0 > p0 + 15)) break;   // and every later one masked
      if (kWindow && p0 - (c0 + BC - 1) >= window) continue;   // before every row's band
      float s[BC / 8][4], dp[BC / 8][4];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qa[4], ga[4];
        if constexpr (kRegA) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            qa[e] = qf[kk][e];
            ga[e] = gf[kk][e];
          }
        } else {
          ldsm_a<D>(s_q, r0, kk, lane, qa);
          ldsm_a<D>(s_do, r0, kk, lane, ga);
        }
#pragma unroll
        for (int j = 0; j < BC / 16; ++j) {
          uint32_t kf[4], vf[4];
          ldsm_b<D>(kt, c * BC + 16 * j, kk, lane, kf);
          ldsm_b<D>(vt, c * BC + 16 * j, kk, lane, vf);
          if (kk == 0) {
            mma16816_zero(s[2 * j], qa, kf[0], kf[1]);
            mma16816_zero(s[2 * j + 1], qa, kf[2], kf[3]);
            mma16816_zero(dp[2 * j], ga, vf[0], vf[1]);
            mma16816_zero(dp[2 * j + 1], ga, vf[2], vf[3]);
          } else {
            mma16816(s[2 * j], qa, kf[0], kf[1]);
            mma16816(s[2 * j + 1], qa, kf[2], kf[3]);
            mma16816(dp[2 * j], ga, vf[0], vf[1]);
            mma16816(dp[2 * j + 1], ga, vf[2], vf[3]);
          }
        }
      }
      // P and dS in fp32: element (n, e) is row p0 + g + 8 (e >> 1), column
      // c0 + 8n + 2 t4 + (e & 1); masks only where the chunk meets the
      // diagonal, the window's lower edge (some row's band starts past the
      // chunk's first column) or an edge of the operands
      const bool edge = (causal && c0 + BC - 1 > p0) || (kWindow && p0 + 15 - c0 >= window) ||
                        c0 + BC > Skv || p0 + 16 > Sq;
#pragma unroll
      for (int n = 0; n < BC / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = p0 + g + (e >> 1) * 8, j = c0 + 8 * n + 2 * t4 + (e & 1);
          prob_ds(s[n][e], dp[n][e], e < 2 ? L0 : L1, e < 2 ? D0 : D1, scale, softcap,
                  !edge || (i < Sq && j < Skv && (!causal || j <= i) &&
                            (!kWindow || i - j < window)));
        }
      }
      // dQ += dS.K: the dS fragment of columns [16j, 16j + 16) is the A
      // fragment of the k16 step j
#pragma unroll
      for (int j = 0; j < BC / 16; ++j) {
        const uint32_t a[4] = {pack_bf16(dp[2 * j][0], dp[2 * j][1]),
                               pack_bf16(dp[2 * j][2], dp[2 * j][3]),
                               pack_bf16(dp[2 * j + 1][0], dp[2 * j + 1][1]),
                               pack_bf16(dp[2 * j + 1][2], dp[2 * j + 1][3])};
#pragma unroll
        for (int dd = 0; dd < D / 16; ++dd) {
          uint32_t kf[4];
          ldsm_bt<D>(kt, c * BC + 16 * j, dd, lane, kf);
          mma16816(acc[2 * dd], a, kf[0], kf[1]);
          mma16816(acc[2 * dd + 1], a, kf[2], kf[3]);
        }
      }
    }
    __syncthreads();   // every warp is done with buffer buf before it is refilled
  }
  // dQ (times the scale q.k^T carried) through this warp's rows of the q tile
  if (active) store_acc<D>(acc, scale, smem, r0, dq + orow0, o_row, p0, Sq, lane);
}

template <int D, bool kWindow>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ part,
                         int Hq, int Hkv, int group, int splits, int Sq, int Skv,
                         long long q_sb, long long q_ss, long long q_sh,
                         long long k_sb, long long k_ss, long long k_sh,
                         long long v_sb, long long v_ss, long long v_sh,
                         int causal, float softcap, float scale, int window) {
  constexpr int TILE = BT * D * 2;
  constexpr bool kRegA = D <= 64;   // K and V fragments kept in registers
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t s_k = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t s_v = s_k + BR * D * 2;
  const uint32_t s_q = s_v + BR * D * 2, s_do = s_q + 2 * TILE;   // 2 buffers each
  const uint32_t s_l = s_do + 2 * TILE;                          // lse, delta x 2 buffers
  const float* lse_s = reinterpret_cast<const float*>(smem + (s_l - s_k));
  const float* delta_s = lse_s + 2 * BT;

  const int hk = blockIdx.x / splits, split = blockIdx.x % splits, b = blockIdx.y;
  const int k_start = blockIdx.z * BR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const long long o_row = (long long)Hq * D;

  // this block's q heads, and the q tiles from the first the causal mask
  // lets see its rows to the last a window lets see them (rows past its
  // last column's position + window - 1 see none)
  const int per = group / splits, h0 = hk * group + split * per;
  const int i_first = causal ? k_start / BT : 0;
  const int i_end = kWindow ? min(Sq, min(Skv, k_start + BR) - 1 + window) : Sq;
  const int n_qt = max(0, (i_end + BT - 1) / BT - i_first);
  const int n_it = per * n_qt;
  load_rows<D, BR>(s_k, k + b * k_sb + hk * k_sh, k_ss, k_start, Skv, tid);
  load_rows<D, BR>(s_v, v + b * v_sb + hk * v_sh, v_ss, k_start, Skv, tid);
  cp_async_commit();
  auto load_q = [&](int it, int buf) {
    const int h = h0 + it / n_qt, i0 = (i_first + it % n_qt) * BT;
    load_rows<D, BT>(s_q + buf * TILE, q + b * q_sb + h * q_sh, q_ss, i0, Sq, tid);
    load_rows<D, BT>(s_do + buf * TILE, dout + (long long)b * Sq * o_row + (long long)h * D,
                     o_row, i0, Sq, tid);
    // lse by threads [0, BT), delta by [BT, 2 BT); past Sq as zeros
    const int r = tid % BT, which = tid / BT, i = i0 + r;
    const float* src = (which ? delta : lse) + ((long long)b * Hq + h) * Sq;
    repro::cp_async4(s_l + ((which * 2 + buf) * BT + r) * 4, src + (i < Sq ? i : 0), i < Sq);
  };
  if (n_it > 0) load_q(0, 0);
  cp_async_commit();

  const int r0 = warp * 16, j0 = k_start + r0;   // this warp's kv rows, their first position
  const bool active = j0 < Skv;
  uint32_t kf[kRegA ? D / 16 : 1][4], vf[kRegA ? D / 16 : 1][4];
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1, i0 = (i_first + it % n_qt) * BT;
    if (it + 1 < n_it) {
      load_q(it + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // tile it (and, the first time, K and V) has landed
    if constexpr (kRegA) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          ldsm_a<D>(s_k, r0, kk, lane, kf[kk]);
          ldsm_a<D>(s_v, r0, kk, lane, vf[kk]);
        }
      }
    }
    const uint32_t qt = s_q + buf * TILE, gt = s_do + buf * TILE;
    const float* ls = lse_s + buf * BT;
    const float* ds_ = delta_s + buf * BT;
#pragma unroll 1
    for (int c = 0; active && c < BT / BC; ++c) {
      const int c0 = i0 + c * BC;   // the chunk's first q row
      if (c0 >= Sq) break;
      if (causal && j0 > c0 + BC - 1) continue;   // every row of the chunk precedes this warp's
      if (kWindow && c0 - (j0 + 15) >= window) continue;   // every row past this warp's band
      float st[BC / 8][4], dpt[BC / 8][4];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        if constexpr (kRegA) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ka[e] = kf[kk][e];
            va[e] = vf[kk][e];
          }
        } else {
          ldsm_a<D>(s_k, r0, kk, lane, ka);
          ldsm_a<D>(s_v, r0, kk, lane, va);
        }
#pragma unroll
        for (int j = 0; j < BC / 16; ++j) {
          uint32_t qb[4], gb[4];
          ldsm_b<D>(qt, c * BC + 16 * j, kk, lane, qb);
          ldsm_b<D>(gt, c * BC + 16 * j, kk, lane, gb);
          if (kk == 0) {
            mma16816_zero(st[2 * j], ka, qb[0], qb[1]);
            mma16816_zero(st[2 * j + 1], ka, qb[2], qb[3]);
            mma16816_zero(dpt[2 * j], va, gb[0], gb[1]);
            mma16816_zero(dpt[2 * j + 1], va, gb[2], gb[3]);
          } else {
            mma16816(st[2 * j], ka, qb[0], qb[1]);
            mma16816(st[2 * j + 1], ka, qb[2], qb[3]);
            mma16816(dpt[2 * j], va, gb[0], gb[1]);
            mma16816(dpt[2 * j + 1], va, gb[2], gb[3]);
          }
        }
      }
      // P^T and dS^T in fp32: element (n, e) is kv row j0 + g + 8 (e >> 1),
      // q row c0 + 8n + 2 t4 + (e & 1)
      const bool edge = (causal && j0 + 15 > c0) || (kWindow && c0 + BC - 1 - j0 >= window) ||
                        c0 + BC > Sq || j0 + 16 > Skv;
#pragma unroll
      for (int n = 0; n < BC / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = c * BC + 8 * n + 2 * t4 + (e & 1);
          const int i = i0 + r, j = j0 + g + (e >> 1) * 8;
          prob_ds(st[n][e], dpt[n][e], ls[r], ds_[r], scale, softcap,
                  !edge || (i < Sq && j < Skv && (!causal || j <= i) &&
                            (!kWindow || i - j < window)));
        }
      }
      // dV += P^T.dO, dK += dS^T.q: dO and q as transposed B operands
#pragma unroll
      for (int ic = 0; ic < BC / 16; ++ic) {
        const uint32_t pA[4] = {pack_bf16(st[2 * ic][0], st[2 * ic][1]),
                                pack_bf16(st[2 * ic][2], st[2 * ic][3]),
                                pack_bf16(st[2 * ic + 1][0], st[2 * ic + 1][1]),
                                pack_bf16(st[2 * ic + 1][2], st[2 * ic + 1][3])};
        const uint32_t sA[4] = {pack_bf16(dpt[2 * ic][0], dpt[2 * ic][1]),
                                pack_bf16(dpt[2 * ic][2], dpt[2 * ic][3]),
                                pack_bf16(dpt[2 * ic + 1][0], dpt[2 * ic + 1][1]),
                                pack_bf16(dpt[2 * ic + 1][2], dpt[2 * ic + 1][3])};
#pragma unroll
        for (int dd = 0; dd < D / 16; ++dd) {
          uint32_t gb[4], qb[4];
          ldsm_bt<D>(gt, c * BC + 16 * ic, dd, lane, gb);
          ldsm_bt<D>(qt, c * BC + 16 * ic, dd, lane, qb);
          mma16816(dv_acc[2 * dd], pA, gb[0], gb[1]);
          mma16816(dv_acc[2 * dd + 1], pA, gb[2], gb[3]);
          mma16816(dk_acc[2 * dd], sA, qb[0], qb[1]);
          mma16816(dk_acc[2 * dd + 1], sA, qb[2], qb[3]);
        }
      }
    }
    __syncthreads();   // every warp is done with buffer buf before it is refilled
  }
  // with no q tile the K and V copies may still be in flight
  cp_async_wait<0>();
  __syncthreads();
  if (!active) return;
  const long long kv_row = (long long)Hkv * D;
  const long long off0 = (long long)b * Skv * kv_row + (long long)hk * D;
  if (splits == 1) {
    // dK (times the scale q.k^T carried) and dV through this warp's K and V rows
    store_acc<D>(dk_acc, scale, smem, r0, dk + off0, kv_row, j0, Skv, lane);
    store_acc<D>(dv_acc, 1.f, smem + BR * D * 2, r0, dv + off0, kv_row, j0, Skv, lane);
    return;
  }
  // fp32 partials: [split][dK, dV][B, Skv, Hkv, D]
  const long long n = (long long)gridDim.y * Skv * kv_row;
  float* pk = part + 2 * split * n + off0;
  float* pv = pk + n;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = j0 + g + 8 * half;
    if (j >= Skv) continue;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const long long at = (long long)j * kv_row + 8 * c + 2 * t4;
      *reinterpret_cast<float2*>(pk + at) =
          make_float2(dk_acc[c][2 * half] * scale, dk_acc[c][2 * half + 1] * scale);
      *reinterpret_cast<float2*>(pv + at) =
          make_float2(dv_acc[c][2 * half], dv_acc[c][2 * half + 1]);
    }
  }
}

// dK and dV from their fp32 partials, summed in split order and rounded
// once: 8 elements a thread (n, the elements of dk, a multiple of 8)
__global__ void __launch_bounds__(256)
flash_bwd_split_sum_kernel(const float* __restrict__ part, bf16* __restrict__ dk,
                           bf16* __restrict__ dv, long long n, int splits) {
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (i >= n) return;
  float sk[8] = {}, sv[8] = {};
  for (int s = 0; s < splits; ++s) {
    const float* pk = part + 2 * s * n + i;
    const float* pv = pk + n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 a = *reinterpret_cast<const float4*>(pk + 4 * h);
      const float4 c = *reinterpret_cast<const float4*>(pv + 4 * h);
      sk[4 * h] += a.x, sk[4 * h + 1] += a.y, sk[4 * h + 2] += a.z, sk[4 * h + 3] += a.w;
      sv[4 * h] += c.x, sv[4 * h + 1] += c.y, sv[4 * h + 2] += c.z, sv[4 * h + 3] += c.w;
    }
  }
  *reinterpret_cast<uint4*>(dk + i) = repro::pack16(sk);
  *reinterpret_cast<uint4*>(dv + i) = repro::pack16(sv);
}

// the shared-memory limit of kernel fn raised once per device (slot: one
// per kernel)
template <typename F>
cudaError_t raise_smem(F fn, int bytes, bool (&done)[repro::kMaxDevices]) {
  int dev = 0;
  cudaError_t err = repro::current_device(&dev);
  if (err != cudaSuccess || done[dev]) return err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done[dev] = true;
  return err;
}

template <int D, bool kWindow>
cudaError_t launch_stream(const void* q, const void* k, const void* v, const void* o,
                          const void* dout, const float* lse, float* delta, void* dq, void* dk,
                          void* dv, float* part, int splits, int B, int Hq, int Hkv, int Sq,
                          int Skv, const long long* qs, const long long* ks_,
                          const long long* vs_, int causal, int window, float softcap,
                          float scale, cudaStream_t stream) {
  static bool attr_dq[repro::kMaxDevices] = {}, attr_dkdv[repro::kMaxDevices] = {};
  cudaError_t err = raise_smem(flash_bwd_dq_tc_kernel<D, kWindow>, dq_smem<D>(), attr_dq);
  if (err == cudaSuccess)
    err = raise_smem(flash_bwd_dkdv_tc_kernel<D, kWindow>, dkdv_smem<D>(), attr_dkdv);
  if (err != cudaSuccess) return err;
  const bf16 *qp = static_cast<const bf16*>(q), *kp = static_cast<const bf16*>(k),
             *vp = static_cast<const bf16*>(v), *gp = static_cast<const bf16*>(dout);
  const int group = Hq / Hkv;
  flash_bwd_dq_tc_kernel<D, kWindow>
      <<<dim3(Hq, B, (Sq + BR - 1) / BR), THREADS, dq_smem<D>(), stream>>>(
      qp, kp, vp, static_cast<const bf16*>(o), gp, lse, delta, static_cast<bf16*>(dq), Hq,
      group, Sq, Skv, qs[0], qs[1], qs[2], ks_[0], ks_[1], ks_[2], vs_[0], vs_[1], vs_[2],
      causal, softcap, scale, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_tc_kernel<D, kWindow>
      <<<dim3(Hkv * splits, B, (Skv + BR - 1) / BR), THREADS, dkdv_smem<D>(), stream>>>(
          qp, kp, vp, gp, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), part, Hq,
          Hkv, group, splits, Sq, Skv, qs[0], qs[1], qs[2], ks_[0], ks_[1], ks_[2], vs_[0],
          vs_[1], vs_[2], causal, softcap, scale, window);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long n = (long long)B * Skv * Hkv * D;
  flash_bwd_split_sum_kernel<<<(unsigned)((n / 8 + 255) / 256), 256, 0, stream>>>(
      part, static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, splits);
  return cudaGetLastError();
}

}  // namespace tc

// ------------------------------------------- tc, the Hopper streaming form
// The mma.sync streaming form's two kernels on wgmma fed by TMA rings, at
// D in {64, 128} (any D from 48 on these, padded: launch below): three
// warpgroups a block, one producer (one thread
// issuing TMA loads into a ring of mbarrier-guarded stages; setmaxnreg
// gives its registers to the others) and two consumers of 64 resident
// rows each.
//  - dq: one block per (128-row q tile, q head, batch), the longest causal
//    rows first, a kv head's q heads side by side. q and dO are resident
//    (TMA, once); the consumers first compute their rows' delta =
//    rowsum(dO * O) from the resident dO and O read once, and store it for
//    dkdv. K and V tiles of 64 rows stream through the ring, from the first
//    the window lets the block see to the diagonal. Per tile: S = q.K^T and
//    dP = dO.V^T (wgmma, operands in shared memory, K-major), P and dS in
//    fp32 (prob_ds), then dQ += dS.K with dS rounded to bf16 as the
//    register A operand and K read through the transpose bit.
//  - dkdv: one block per (128-row kv tile, kv head, share of its q heads,
//    batch), the first kv tiles (the most causal rows) first. K and V are
//    resident; q and dO tiles of 64 rows stream with their rows' lse and
//    delta (1-D TMA boxes from the row rounded down to 16 bytes), for each q head of the share in order, from the
//    first q tile the causal mask lets see the block. Per tile: S^T =
//    K.q^T and dP^T = V.dO^T, P^T and dS^T in fp32, then dV += P^T.dO and
//    dK += dS^T.q with P^T and dS^T as register A operands and dO and q
//    read through the transpose bit. A share is any count up to the group:
//    share i takes the q heads [i g / n, (i + 1) g / n) of a group of g, and
//    with n > 1 writes fp32 partials that the split pass sums in share
//    order, so two calls give the same bits.
// A consumer whose rows see none of a tile waits for it and frees it
// without a product; tiles masked for the whole block are not loaded.
// Gradients leave from the accumulators in 4-byte pairs (8-byte pairs for
// the partials).
namespace wg {

using bf16 = __nv_bfloat16;
using namespace repro::hopper;

constexpr int BR = 128;                       // resident rows a block: q (dq), kv (dkdv)
constexpr int BT = 64;                        // rows of a streamed tile
constexpr int CONSUMERS = 2, THREADS = (CONSUMERS + 1) * 128;
constexpr int BOX_ROW = 128;                  // bytes of a box row: 64 bf16
constexpr int R_BOX = BR * BOX_ROW;           // one box of a resident operand
constexpr int T_BOX = BT * BOX_ROW;           // one box of a streamed tile
// a tile's lse or delta: a 1-D TMA box must start on 16 bytes, so it starts
// at the row rounded down to 4 and holds 4 rows more; a slot of 384 bytes
constexpr int L_BOX = BT + 4, L_SLOT = 384;

template <int D>
struct Bwd {
  static constexpr int BOXES = D / 64;
  static constexpr int R_BYTES = BOXES * R_BOX;   // one resident operand
  static constexpr int T_BYTES = BOXES * T_BOX;   // one streamed operand tile
  static constexpr int STAGES = D == 128 ? 3 : 4;
  // lse and delta: the block's rows (dq), a slot each a stage (dkdv)
  static constexpr int L_BYTES = 2 * STAGES * L_SLOT > 8 * BR ? 2 * STAGES * L_SLOT : 8 * BR;
  // resident pair, the ring (two operands a stage), lse and delta, barriers
  static constexpr int SMEM =
      2 * R_BYTES + STAGES * 2 * T_BYTES + L_BYTES + (1 + 2 * STAGES) * 8 + 1024;
};

__device__ __forceinline__ uint32_t smem_base(const uint8_t* raw) {
  return (static_cast<uint32_t>(__cvta_generic_to_shared(raw)) + 1023) & ~1023u;
}

// The dq kernel's body at D (64 or 128); with kPad, D is the kernel's
// width above the true head dim dt: the maps name dt (TMA reads columns
// dt..D-1 as zeros), and what leaves through no map, O's reads for delta
// and dQ's stores, stops at dt.
template <int D, bool kWindow, bool kPad>
__device__ __forceinline__ void dq_wg(const CUtensorMap* qmap, const CUtensorMap* domap,
                                      const CUtensorMap* kmap, const CUtensorMap* vmap,
                                      const bf16* __restrict__ o, const float* __restrict__ lse,
                                      float* __restrict__ delta, bf16* __restrict__ dq, int Hq,
                                      int group, int Sq, int Skv, int causal, float softcap,
                                      float scale, int window, int dt) {
  using W = Bwd<D>;
  constexpr int STAGES = W::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_base(smem_raw);
  uint8_t* gbase = smem_raw + (base - static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)));
  const uint32_t s_q = base, s_do = base + W::R_BYTES, s_ring = s_do + W::R_BYTES;
  float* lse_s = reinterpret_cast<float*>(gbase + 2 * W::R_BYTES + STAGES * 2 * W::T_BYTES);
  float* delta_s = lse_s + BR;
  const uint32_t bars = base + 2 * W::R_BYTES + STAGES * 2 * W::T_BYTES + W::L_BYTES;
  const uint32_t r_full = bars, full0 = bars + 8, empty0 = full0 + 8 * STAGES;

  const int h = blockIdx.x, b = blockIdx.y, hk = h / group;
  const int n_qt = (Sq + BR - 1) / BR;
  const int q0 = (causal ? n_qt - 1 - (int)blockIdx.z : (int)blockIdx.z) * BR;
  // kv tiles that hold an unmasked column for some row of the block
  const int kv_end = causal ? min(Skv, q0 + BR) : Skv;
  const int t_begin = kWindow ? max(0, q0 - window + 1) / BT : 0;
  const int n_t = max(0, (kv_end + BT - 1) / BT - t_begin);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(r_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMERS * 4) {
    setmaxnreg_dec<24>();
    if (warp == CONSUMERS * 4 && lane == 0) {
      mbar_expect_tx(r_full, 2 * W::R_BYTES);
      for (int bx = 0; bx < W::BOXES; ++bx) {
        tma_load(s_q + bx * R_BOX, qmap, r_full, 64 * bx, h, q0, b);
        tma_load(s_do + bx * R_BOX, domap, r_full, 64 * bx, h, q0, b);
      }
      for (int it = 0; it < n_t; ++it) {
        const int s = it % STAGES, k0 = (t_begin + it) * BT;
        if (it >= STAGES) mbar_wait(empty0 + 8 * s, (it / STAGES - 1) & 1);
        const uint32_t kt = s_ring + s * 2 * W::T_BYTES, vt = kt + W::T_BYTES;
        mbar_expect_tx(full0 + 8 * s, 2 * W::T_BYTES);
        for (int bx = 0; bx < W::BOXES; ++bx) {
          tma_load(kt + bx * T_BOX, kmap, full0 + 8 * s, 64 * bx, hk, k0, b);
          tma_load(vt + bx * T_BOX, vmap, full0 + 8 * s, 64 * bx, hk, k0, b);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<240>();

  const int wg = warp / 4, wi = warp % 4, g = lane / 4, t4 = lane % 4;
  const int r0 = q0 + 64 * wg, p0 = r0 + 16 * wi + g;
  const long long o_row = (long long)Hq * (kPad ? dt : D);   // row stride of o, dO, dq
  const long long orow0 = (long long)b * Sq * o_row + (long long)h * (kPad ? dt : D);
  mbar_wait(r_full, 0);
  // delta = rowsum(dO * O), two threads a row, each half of its 16-byte
  // chunks (dO from the resident tile, O read once); stored for dkdv
  {
    const int CPR = (kPad ? dt : D) / 8;
    const int r = threadIdx.x / 2, half = threadIdx.x % 2, p = q0 + r;
    float dl = 0.f;
    if (p < Sq) {
      const bf16* orow = o + orow0 + (long long)p * o_row;
      for (int c = half * CPR / 2; c < (half + 1) * CPR / 2; ++c) {
        const uint4 gv = *reinterpret_cast<const uint4*>(
            gbase + W::R_BYTES + (c / 8) * R_BOX + r * BOX_ROW + (((c % 8) ^ (r % 8)) << 4));
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c * 8);
        const uint32_t gw[4] = {gv.x, gv.y, gv.z, gv.w}, ow[4] = {ov.x, ov.y, ov.z, ov.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 a = repro::unpack_bf16(gw[e]), bo = repro::unpack_bf16(ow[e]);
          dl = fmaf(a.x, bo.x, fmaf(a.y, bo.y, dl));
        }
      }
    }
    dl += __shfl_xor_sync(0xffffffffu, dl, 1);
    if (half == 0) {
      const long long lrow = ((long long)b * Hq + h) * Sq + p;
      delta_s[r] = dl;
      lse_s[r] = p < Sq ? lse[lrow] : 0.f;
      if (p < Sq) delta[lrow] = dl;
    }
  }
  named_sync(1, CONSUMERS * 128);
  const float L0 = lse_s[p0 - q0], L1 = lse_s[p0 + 8 - q0];
  const float D0 = delta_s[p0 - q0], D1 = delta_s[p0 + 8 - q0];
  const uint32_t qa = s_q + wg * 64 * BOX_ROW, ga = s_do + wg * 64 * BOX_ROW;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int it = 0; it < n_t; ++it) {
    const int s = it % STAGES, k0 = (t_begin + it) * BT;
    const uint32_t kt = s_ring + s * 2 * W::T_BYTES, vt = kt + W::T_BYTES;
    const bool seen = r0 < Sq && (!causal || k0 <= r0 + 63) &&
                      (!kWindow || r0 - (k0 + BT - 1) < window);
    mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
    if (seen) {
      float sf[BT / 2], dp[BT / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * R_BOX + (kk % 4) * 32, toff = (kk / 4) * T_BOX + (kk % 4) * 32;
        wgmma_ss(sf, sw128_desc(qa + off, 16, 1024), sw128_desc(kt + toff, 16, 1024), kk > 0);
        wgmma_ss(dp, sw128_desc(ga + off, 16, 1024), sw128_desc(vt + toff, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      // masks only where the tile meets the diagonal, the window's lower
      // edge or an edge of the operands
      const bool edge = (causal && k0 + BT - 1 > r0) || (kWindow && r0 + 63 - k0 >= window) ||
                        k0 + BT > Skv || r0 + 64 > Sq;
      uint32_t da[BT / 16][4];
#pragma unroll
      for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = p0 + 8 * (e >> 1), c = k0 + 8 * j + 2 * t4 + (e & 1);
          tc::prob_ds(sf[4 * j + e], dp[4 * j + e], e < 2 ? L0 : L1, e < 2 ? D0 : D1, scale,
                      softcap,
                      !edge || (i < Sq && c < Skv && (!causal || c <= i) &&
                                (!kWindow || i - c < window)));
        }
        da[j / 2][2 * (j % 2)] = repro::pack_bf16(dp[4 * j], dp[4 * j + 1]);
        da[j / 2][2 * (j % 2) + 1] = repro::pack_bf16(dp[4 * j + 2], dp[4 * j + 3]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk)
        wgmma_rs(acc, da[kk], sw128_desc(kt + kk * 16 * BOX_ROW, T_BOX, 1024));
      wgmma_commit();
      wgmma_wait();
    }
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }
  // dQ (times the scale q.k^T carried), rows p0 and p0 + 8 below Sq
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int p = p0 + 8 * hr;
    if (p >= Sq) continue;
    bf16* row = dq + orow0 + (long long)p * o_row + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (!kPad || 8 * j < dt)
        *reinterpret_cast<uint32_t*>(row + 8 * j) =
            repro::pack_bf16(acc[4 * j + 2 * hr] * scale, acc[4 * j + 2 * hr + 1] * scale);
  }
}

template <int D, bool kWindow>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_wg_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap domap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, const bf16* __restrict__ o,
                       const float* __restrict__ lse, float* __restrict__ delta,
                       bf16* __restrict__ dq, int Hq, int group, int Sq, int Skv, int causal,
                       float softcap, float scale, int window) {
  dq_wg<D, kWindow, false>(&qmap, &domap, &kmap, &vmap, o, lse, delta, dq, Hq, group, Sq, Skv,
                           causal, softcap, scale, window, D);
}

// the same at a true head dim dt below D, its last parameter
template <int D, bool kWindow>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_wg_pad_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap domap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap, const bf16* __restrict__ o,
                           const float* __restrict__ lse, float* __restrict__ delta,
                           bf16* __restrict__ dq, int Hq, int group, int Sq, int Skv, int causal,
                           float softcap, float scale, int window, int dt) {
  dq_wg<D, kWindow, true>(&qmap, &domap, &kmap, &vmap, o, lse, delta, dq, Hq, group, Sq, Skv,
                          causal, softcap, scale, window, dt);
}

// The dkdv kernel's body (kPad and dt as dq_wg's: dK, dV and their fp32
// partials stop at dt)
template <int D, bool kWindow, bool kPad>
__device__ __forceinline__ void dkdv_wg(const CUtensorMap* kmap, const CUtensorMap* vmap,
                                        const CUtensorMap* qmap, const CUtensorMap* domap,
                                        const CUtensorMap* lmap, const CUtensorMap* dlmap,
                                        bf16* __restrict__ dk, bf16* __restrict__ dv,
                                        float* __restrict__ part, int Hq, int Hkv, int group,
                                        int splits, int Sq, int Skv, int causal, float softcap,
                                        float scale, int window, int dt) {
  using W = Bwd<D>;
  constexpr int STAGES = W::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_base(smem_raw);
  uint8_t* gbase = smem_raw + (base - static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)));
  const uint32_t s_k = base, s_v = base + W::R_BYTES, s_ring = s_v + W::R_BYTES;
  const uint32_t s_l = s_ring + STAGES * 2 * W::T_BYTES;       // lse, then delta, a slot a stage
  const float* lse_s = reinterpret_cast<const float*>(gbase + (s_l - base));
  const float* delta_s = lse_s + STAGES * L_SLOT / 4;
  const uint32_t bars = s_l + W::L_BYTES;
  const uint32_t r_full = bars, full0 = bars + 8, empty0 = full0 + 8 * STAGES;

  const int hk = blockIdx.x / splits, split = blockIdx.x % splits, b = blockIdx.y;
  const int k_start = blockIdx.z * BR;
  // this block's q heads, and the q tiles from the first the causal mask
  // lets see its rows to the last a window lets see them
  const int h_lo = hk * group + split * group / splits;
  const int per = hk * group + (split + 1) * group / splits - h_lo;
  const int i_first = causal ? k_start / BT : 0;
  const int i_end = kWindow ? min(Sq, min(Skv, k_start + BR) - 1 + window) : Sq;
  const int n_qt = max(0, (i_end + BT - 1) / BT - i_first);
  const int n_it = per * n_qt;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(r_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMERS * 4) {
    setmaxnreg_dec<24>();
    if (warp == CONSUMERS * 4 && lane == 0) {
      mbar_expect_tx(r_full, 2 * W::R_BYTES);
      for (int bx = 0; bx < W::BOXES; ++bx) {
        tma_load(s_k + bx * R_BOX, kmap, r_full, 64 * bx, hk, k_start, b);
        tma_load(s_v + bx * R_BOX, vmap, r_full, 64 * bx, hk, k_start, b);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % STAGES, h = h_lo + it / n_qt, i0 = (i_first + it % n_qt) * BT;
        if (it >= STAGES) mbar_wait(empty0 + 8 * s, (it / STAGES - 1) & 1);
        const uint32_t qt = s_ring + s * 2 * W::T_BYTES, gt = qt + W::T_BYTES, bar = full0 + 8 * s;
        mbar_expect_tx(bar, 2 * W::T_BYTES + 2 * L_BOX * 4);
        for (int bx = 0; bx < W::BOXES; ++bx) {
          tma_load(qt + bx * T_BOX, qmap, bar, 64 * bx, h, i0, b);
          tma_load(gt + bx * T_BOX, domap, bar, 64 * bx, h, i0, b);
        }
        // rows past Sq read the next head's (masked below)
        const int lrow = ((b * Hq + h) * Sq + i0) & ~3;
        tma_load(s_l + s * L_SLOT, lmap, bar, lrow);
        tma_load(s_l + (STAGES + s) * L_SLOT, dlmap, bar, lrow);
      }
    }
    return;
  }
  setmaxnreg_inc<240>();

  const int wg = warp / 4, wi = warp % 4, g = lane / 4, t4 = lane % 4;
  const int j0 = k_start + 64 * wg;   // the warpgroup's first kv row
  const uint32_t ka = s_k + wg * 64 * BOX_ROW, va = s_v + wg * 64 * BOX_ROW;
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

  mbar_wait(r_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % STAGES, i0 = (i_first + it % n_qt) * BT;
    const int l_off = ((b * Hq + h_lo + it / n_qt) * Sq + i0) & 3;   // the tile's row in its box
    const uint32_t qt = s_ring + s * 2 * W::T_BYTES, gt = qt + W::T_BYTES;
    const bool seen = j0 < Skv && (!causal || j0 <= i0 + BT - 1) &&
                      (!kWindow || i0 - (j0 + 63) < window);
    mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
    if (seen) {
      float st[BT / 2], dpt[BT / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * R_BOX + (kk % 4) * 32, toff = (kk / 4) * T_BOX + (kk % 4) * 32;
        wgmma_ss(st, sw128_desc(ka + off, 16, 1024), sw128_desc(qt + toff, 16, 1024), kk > 0);
        wgmma_ss(dpt, sw128_desc(va + off, 16, 1024), sw128_desc(gt + toff, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      // element 4n + e: kv row j0 + 16 wi + g + 8 (e >> 1), q row i0 + 8n +
      // 2 t4 + (e & 1)
      const bool edge = (causal && j0 + 63 > i0) || (kWindow && i0 + BT - 1 - j0 >= window) ||
                        i0 + BT > Sq || j0 + 64 > Skv;
      const float* ls = lse_s + s * L_SLOT / 4 + l_off;
      const float* dls = delta_s + s * L_SLOT / 4 + l_off;
      uint32_t pa[BT / 16][4], sa[BT / 16][4];
#pragma unroll
      for (int n = 0; n < BT / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 8 * n + 2 * t4 + (e & 1), i = i0 + r;
          const int j = j0 + 16 * wi + g + 8 * (e >> 1);
          tc::prob_ds(st[4 * n + e], dpt[4 * n + e], ls[r], dls[r], scale, softcap,
                      !edge || (i < Sq && j < Skv && (!causal || j <= i) &&
                                (!kWindow || i - j < window)));
        }
        pa[n / 2][2 * (n % 2)] = repro::pack_bf16(st[4 * n], st[4 * n + 1]);
        pa[n / 2][2 * (n % 2) + 1] = repro::pack_bf16(st[4 * n + 2], st[4 * n + 3]);
        sa[n / 2][2 * (n % 2)] = repro::pack_bf16(dpt[4 * n], dpt[4 * n + 1]);
        sa[n / 2][2 * (n % 2) + 1] = repro::pack_bf16(dpt[4 * n + 2], dpt[4 * n + 3]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {
        wgmma_rs(dva, pa[kk], sw128_desc(gt + kk * 16 * BOX_ROW, T_BOX, 1024));
        wgmma_rs(dka, sa[kk], sw128_desc(qt + kk * 16 * BOX_ROW, T_BOX, 1024));
      }
      wgmma_commit();
      wgmma_wait();
    }
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }
  // dK (times the scale q.k^T carried) and dV, kv rows below Skv: bf16
  // with one share, else this share's fp32 partials [split][dK, dV][B,
  // Skv, Hkv, D]
  const long long kv_row = (long long)Hkv * (kPad ? dt : D);
  const long long off0 = (long long)b * Skv * kv_row + (long long)hk * (kPad ? dt : D) + 2 * t4;
  const long long n = (long long)gridDim.y * Skv * kv_row;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int j = j0 + 16 * wi + g + 8 * hr;
    if (j >= Skv) continue;
    const long long at = off0 + (long long)j * kv_row;
    if (splits == 1) {
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        if (kPad && 8 * c >= dt) break;
        *reinterpret_cast<uint32_t*>(dk + at + 8 * c) =
            repro::pack_bf16(dka[4 * c + 2 * hr] * scale, dka[4 * c + 2 * hr + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + at + 8 * c) =
            repro::pack_bf16(dva[4 * c + 2 * hr], dva[4 * c + 2 * hr + 1]);
      }
    } else {
      float* pk = part + 2 * split * n + at;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        if (kPad && 8 * c >= dt) break;
        *reinterpret_cast<float2*>(pk + 8 * c) =
            make_float2(dka[4 * c + 2 * hr] * scale, dka[4 * c + 2 * hr + 1] * scale);
        *reinterpret_cast<float2*>(pk + n + 8 * c) =
            make_float2(dva[4 * c + 2 * hr], dva[4 * c + 2 * hr + 1]);
      }
    }
  }
}

template <int D, bool kWindow>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_wg_kernel(const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap domap,
                         const __grid_constant__ CUtensorMap lmap,
                         const __grid_constant__ CUtensorMap dlmap, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, float* __restrict__ part, int Hq, int Hkv,
                         int group, int splits, int Sq, int Skv, int causal, float softcap,
                         float scale, int window) {
  dkdv_wg<D, kWindow, false>(&kmap, &vmap, &qmap, &domap, &lmap, &dlmap, dk, dv, part, Hq, Hkv,
                             group, splits, Sq, Skv, causal, softcap, scale, window, D);
}

// the same at a true head dim dt below D, its last parameter
template <int D, bool kWindow>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_wg_pad_kernel(const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap domap,
                             const __grid_constant__ CUtensorMap lmap,
                             const __grid_constant__ CUtensorMap dlmap, bf16* __restrict__ dk,
                             bf16* __restrict__ dv, float* __restrict__ part, int Hq, int Hkv,
                             int group, int splits, int Sq, int Skv, int causal, float softcap,
                             float scale, int window, int dt) {
  dkdv_wg<D, kWindow, true>(&kmap, &vmap, &qmap, &domap, &lmap, &dlmap, dk, dv, part, Hq, Hkv,
                            group, splits, Sq, Skv, causal, softcap, scale, window, dt);
}

// The two kernels at D (64 or 128) for a true head dim dt <= D (D's own
// kernels where dt = D, else their padded twins): the maps name dt, so TMA
// reads columns dt..D-1 as zeros. At dt = 48, 80, 96 and 112 the padded
// columns cost 1.33x, 1.6x, 1.33x and 1.14x the products the head needs.
template <int D, bool kWindow>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* delta, void* dq, void* dk,
                   void* dv, float* part, int splits, int B, int Hq, int Hkv, int Sq, int Skv,
                   const long long* qs, const long long* ks_, const long long* vs_, int causal,
                   int window, float softcap, float scale, cudaStream_t stream, int dt) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  const long long gs[3] = {(long long)Sq * Hq * dt, (long long)Hq * dt, dt};   // dO, contiguous
  const long long n_rows = (long long)B * Hq * Sq;
  CUtensorMap qr, gr, kt, vt, kr, vr, qt, gt, lm, dlm;
  if (!make_bshd_map(enc, &qr, q, B, Sq, Hq, dt, qs, BR) ||
      !make_bshd_map(enc, &gr, dout, B, Sq, Hq, dt, gs, BR) ||
      !make_bshd_map(enc, &kt, k, B, Skv, Hkv, dt, ks_, BT) ||
      !make_bshd_map(enc, &vt, v, B, Skv, Hkv, dt, vs_, BT) ||
      !make_bshd_map(enc, &kr, k, B, Skv, Hkv, dt, ks_, BR) ||
      !make_bshd_map(enc, &vr, v, B, Skv, Hkv, dt, vs_, BR) ||
      !make_bshd_map(enc, &qt, q, B, Sq, Hq, dt, qs, BT) ||
      !make_bshd_map(enc, &gt, dout, B, Sq, Hq, dt, gs, BT) ||
      !make_f32_map(enc, &lm, lse, n_rows, L_BOX) || !make_f32_map(enc, &dlm, delta, n_rows, L_BOX))
    return cudaErrorInvalidValue;
  const bool pad = dt != D;
  static bool attr_dq[repro::kMaxDevices] = {}, attr_dkdv[repro::kMaxDevices] = {};
  static bool attr_dq_pad[repro::kMaxDevices] = {}, attr_dkdv_pad[repro::kMaxDevices] = {};
  cudaError_t err =
      pad ? tc::raise_smem(flash_bwd_dq_wg_pad_kernel<D, kWindow>, Bwd<D>::SMEM, attr_dq_pad)
          : tc::raise_smem(flash_bwd_dq_wg_kernel<D, kWindow>, Bwd<D>::SMEM, attr_dq);
  if (err == cudaSuccess)
    err = pad ? tc::raise_smem(flash_bwd_dkdv_wg_pad_kernel<D, kWindow>, Bwd<D>::SMEM,
                               attr_dkdv_pad)
              : tc::raise_smem(flash_bwd_dkdv_wg_kernel<D, kWindow>, Bwd<D>::SMEM, attr_dkdv);
  if (err != cudaSuccess) return err;
  const int group = Hq / Hkv;
  const dim3 dq_grid(Hq, B, (Sq + BR - 1) / BR), kv_grid(Hkv * splits, B, (Skv + BR - 1) / BR);
  if (pad)
    flash_bwd_dq_wg_pad_kernel<D, kWindow><<<dq_grid, THREADS, Bwd<D>::SMEM, stream>>>(
        qr, gr, kt, vt, static_cast<const bf16*>(o), lse, delta, static_cast<bf16*>(dq), Hq,
        group, Sq, Skv, causal, softcap, scale, window, dt);
  else
    flash_bwd_dq_wg_kernel<D, kWindow><<<dq_grid, THREADS, Bwd<D>::SMEM, stream>>>(
        qr, gr, kt, vt, static_cast<const bf16*>(o), lse, delta, static_cast<bf16*>(dq), Hq,
        group, Sq, Skv, causal, softcap, scale, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (pad)
    flash_bwd_dkdv_wg_pad_kernel<D, kWindow><<<kv_grid, THREADS, Bwd<D>::SMEM, stream>>>(
        kr, vr, qt, gt, lm, dlm, static_cast<bf16*>(dk), static_cast<bf16*>(dv), part, Hq, Hkv,
        group, splits, Sq, Skv, causal, softcap, scale, window, dt);
  else
    flash_bwd_dkdv_wg_kernel<D, kWindow><<<kv_grid, THREADS, Bwd<D>::SMEM, stream>>>(
        kr, vr, qt, gt, lm, dlm, static_cast<bf16*>(dk), static_cast<bf16*>(dv), part, Hq, Hkv,
        group, splits, Sq, Skv, causal, softcap, scale, window);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long n = (long long)B * Skv * Hkv * dt;
  tc::flash_bwd_split_sum_kernel<<<(unsigned)((n / 8 + 255) / 256), 256, 0, stream>>>(
      part, static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, splits);
  return cudaGetLastError();
}

}  // namespace wg

// the short tensor-core form takes the input (else the streaming one)
bool short_form(int Hq, int Hkv, int Sq, int Skv, int D) {
  return Hq == Hkv && D <= 64 && Sq <= tc::kMaxS && Skv <= tc::kMaxS &&
         tc::smem_bytes(Sq, Skv, D) <= tc::kMaxSmem;
}

}  // namespace

// q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D), unit stride on D and the given
// (batch, seq, head) strides in elements. o, dout, dq: contiguous
// (B, Sq, Hq, D); dk, dv: contiguous (B, Skv, Hkv, D); lse (from the
// forward) and delta (scratch the first kernel fills): fp32 (B, Hq, Sq).
// part: null, or with splits > 1 fp32 scratch of 2 * splits * B * Skv *
// Hkv * D for the streaming form's partial dK and dV; splits divides
// Hq / Hkv (the wrapper's bwd_splits: blocks an SM up to 4, with or
// without a window). causal and window (0: none) are the forward's masks.
// Sq, Skv > 0, window >= 0. dtype: repro::Dtype of q, k, v, o, dout and the
// gradients. variant 0 runs the CUDA-core kernels (D from 1 to 128);
// variant 1 the tensor-core ones, which take bfloat16 with D a multiple of
// 16 up to 128, strides that are multiples of 8 and 16-byte-aligned
// pointers, and refuse
// anything else (the caller chooses; nothing falls back): the short form
// where short_form says so (splits ignored), else the streaming form.
// Returns the CUDA error of the launches (0 on success).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, float* part, int dtype,
    int variant, int splits, int B, int Hq, int Hkv, int Sq, int Skv, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    int causal, int window, float softcap, float scale, void* stream, int form) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Skv <= 0 || window < 0 || form < kFormAuto ||
      form > kFormWg)
    return cudaErrorInvalidValue;
  const long long qs[3] = {q_sb, q_ss, q_sh};
  const long long kst[3] = {k_sb, k_ss, k_sh};
  const long long vst[3] = {v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == kTc) {
    bool ok = dtype == repro::kBFloat16;
    for (int i = 0; i < 3; ++i) ok = ok && qs[i] % 8 == 0 && kst[i] % 8 == 0 && vst[i] % 8 == 0;
    for (const void* p : {q, k, v, o, dout, static_cast<const void*>(dq),
                          static_cast<const void*>(dk), static_cast<const void*>(dv)})
      ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
    if (!ok) return cudaErrorInvalidValue;
    // D a multiple of 16 up to 128; the Hopper form from 48 (48 on its D =
    // 64 kernels, 80, 96 and 112 on its D = 128 ones)
    if (D < 16 || D > 128 || D % 16) return cudaErrorInvalidValue;
    const bool fits = short_form(Hq, Hkv, Sq, Skv, D), wg_d = D >= 48;
    if (form == kFormAuto) form = fits ? kFormShort : wg_d ? kFormWg : kFormStream;
    if ((form == kFormShort && !fits) || (form == kFormWg && !wg_d)) return cudaErrorInvalidValue;
    if (form == kFormShort) {
      switch (D) {
#define REPRO_FLASH_BWD_SHORT(DD)                                                             \
  case DD:                                                                                    \
    return window ? tc::launch_short<DD, true>(q, k, v, o, dout, lse, dq, dk, dv, B, Hq, Sq,  \
                                               Skv, qs, kst, vst, causal, window, softcap,   \
                                               scale, s)                                     \
                  : tc::launch_short<DD, false>(q, k, v, o, dout, lse, dq, dk, dv, B, Hq, Sq, \
                                                Skv, qs, kst, vst, causal, 0, softcap,       \
                                                scale, s);
        REPRO_FLASH_BWD_SHORT(16)
        REPRO_FLASH_BWD_SHORT(32)
        REPRO_FLASH_BWD_SHORT(48)
        REPRO_FLASH_BWD_SHORT(64)
#undef REPRO_FLASH_BWD_SHORT
        default:
          return cudaErrorInvalidValue;
      }
    }
    // the Hopper form shares a group among any count of blocks up to its
    // size, the mma.sync form among a divisor of it
    if (delta == nullptr || splits < 1 || splits > Hq / Hkv || (splits > 1 && part == nullptr) ||
        (form == kFormStream && (Hq / Hkv) % splits != 0))
      return cudaErrorInvalidValue;
    if (form == kFormWg) {
      if (D <= 64)
        return window ? wg::launch<64, true>(q, k, v, o, dout, lse, delta, dq, dk, dv, part,
                                             splits, B, Hq, Hkv, Sq, Skv, qs, kst, vst, causal,
                                             window, softcap, scale, s, D)
                      : wg::launch<64, false>(q, k, v, o, dout, lse, delta, dq, dk, dv, part,
                                              splits, B, Hq, Hkv, Sq, Skv, qs, kst, vst, causal,
                                              0, softcap, scale, s, D);
      return window ? wg::launch<128, true>(q, k, v, o, dout, lse, delta, dq, dk, dv, part,
                                            splits, B, Hq, Hkv, Sq, Skv, qs, kst, vst, causal,
                                            window, softcap, scale, s, D)
                    : wg::launch<128, false>(q, k, v, o, dout, lse, delta, dq, dk, dv, part,
                                             splits, B, Hq, Hkv, Sq, Skv, qs, kst, vst, causal,
                                             0, softcap, scale, s, D);
    }
    switch (D) {
#define REPRO_FLASH_BWD_STREAM(DD)                                                            \
  case DD:                                                                                    \
    return window ? tc::launch_stream<DD, true>(q, k, v, o, dout, lse, delta, dq, dk, dv,     \
                                                part, splits, B, Hq, Hkv, Sq, Skv, qs, kst,  \
                                                vst, causal, window, softcap, scale, s)      \
                  : tc::launch_stream<DD, false>(q, k, v, o, dout, lse, delta, dq, dk, dv,    \
                                                 part, splits, B, Hq, Hkv, Sq, Skv, qs, kst, \
                                                 vst, causal, 0, softcap, scale, s);
      REPRO_FLASH_BWD_STREAM(16)
      REPRO_FLASH_BWD_STREAM(32)
      REPRO_FLASH_BWD_STREAM(48)
      REPRO_FLASH_BWD_STREAM(64)
      REPRO_FLASH_BWD_STREAM(80)
      REPRO_FLASH_BWD_STREAM(96)
      REPRO_FLASH_BWD_STREAM(112)
      REPRO_FLASH_BWD_STREAM(128)
#undef REPRO_FLASH_BWD_STREAM
      default:
        return cudaErrorInvalidValue;
    }
  }
  if (variant != kSimt || delta == nullptr || form != kFormAuto) return cudaErrorInvalidValue;
  switch (dtype) {
    case repro::kFloat32:
      return dispatch_d<float>(D, q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, Sq, Skv,
                               qs, kst, vst, causal, window, softcap, scale, s);
    case repro::kBFloat16:
      return dispatch_d<__nv_bfloat16>(D, q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv,
                                       Sq, Skv, qs, kst, vst, causal, window, softcap, scale,
                                       s);
    default:
      return cudaErrorInvalidValue;
  }
}
