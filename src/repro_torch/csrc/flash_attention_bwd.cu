// Flash-attention backward for Hopper (sm_90a): bf16 on the tensor cores
// for the agent's short sequences, fp32 on the CUDA cores for the rest.
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
// over its q heads, the adjoint of the reference's _repeat_kv. Causal
// masking zeroes the masked probabilities; a window is refused by the
// wrapper (attention_core never sends one to the flash path).
//
// What bounds it on the H100: at the Mirage trunk's shape (640 sequences x
// 8 heads, S=144, D=32, bf16) it must read q, k, v, o, dO and write dq, dk,
// dv, ~0.38 GB, ~0.11 ms at 3.35 TB/s; its five S x S x D products are
// ~34 GFLOP, ~0.03 ms on the bf16 tensor cores but ~0.5 ms in fp32 on the
// CUDA cores (67 TFLOP/s). So the products go to the tensor cores where
// the inputs allow it, and every other input keeps a CUDA-core kernel.
// Two variants, chosen by the wrapper from the inputs before the launch
// (kernels/flash_attention/ops.py:_flash_bwd_variant):
//
// "tc", bf16, one kv head per q head, D <= 64, both sequences <= 256 and
// 16-byte rows (the trunk's case): one block of 4 warps per (head, batch)
// copies q, dO, K and V whole into shared memory (cp.async, XOR-swizzled
// 16-byte chunks, as the forward's short form) and computes delta there.
// Phase 1: each warp owns 16-row groups of K/V and walks the q rows in
// chunks of 16 (from the diagonal under the causal mask): S^T = K.q^T and
// dP^T = V.dO^T on mma.sync.m16n8k16 (bf16 in, fp32 accumulators), P^T and
// dS^T in fp32 registers, then dV += P^T.dO and dK += dS^T.q with P^T and
// dS^T rounded to bf16 as A operands straight from the accumulators (as the
// forward's P); dS^T is also stored to shared memory as bf16. Phase 2,
// after one barrier: each warp owns 16-row groups of q and computes dQ =
// dS.K, reading dS with transposed ldmatrix from the dS^T it stored. dK,
// dV and dQ leave from the accumulators in 4-byte pairs.
//
// "simt", fp32 (TF32 would break the 3e-5 fp32 bound), GQA, D = 128,
// longer sequences and unaligned views: two kernels on the stream, no
// atomics:
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
// Both read q, k, v through (batch, sequence, head) strides, so the model's
// views need no copy; o, dO and the gradients are contiguous.
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "common.cuh"

namespace {

// variant codes shared with kernels/_build.py
constexpr int kSimt = 0, kTc = 1;

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
// into a shared fp32 tile; rows at or past n as zeros.
template <typename T, int D, int TILE, int THREADS>
__device__ __forceinline__ void stage(float (*tile)[D], const T* base, long long rs, int r0, int n,
                                      float mul) {
  for (int idx = threadIdx.x; idx < TILE * D; idx += THREADS) {
    const int r = idx / D, dd = idx % D, p = r0 + r;
    tile[r][dd] = p < n ? to_f32(base[(long long)p * rs + dd]) * mul : 0.f;
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

template <typename T, int D>
__global__ void __launch_bounds__(Shape<D>::THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    T* __restrict__ dq, int Hq, int group, int Sq, int Skv,
                    long long q_sb, long long q_ss, long long q_sh,
                    long long k_sb, long long k_ss, long long k_sh,
                    long long v_sb, long long v_ss, long long v_sh,
                    int causal, float softcap, float scale) {
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
  const long long orow = (((long long)b * Sq + ic) * Hq + h) * D + d0;
  float dl = 0.f;
#pragma unroll
  for (int e = 0; e < kDPT; ++e) {
    qr[e] = to_f32(qp[e]) * scale;
    gr[e] = to_f32(dout[orow + e]);
    dl = fmaf(gr[e], to_f32(o[orow + e]), dl);
    acc[e] = 0.f;
  }
  dl = row_sum<TPR>(dl);
  const long long lrow = ((long long)b * Hq + h) * Sq + ic;
  const float L = lse[lrow];
  if (i < Sq && threadIdx.x % TPR == 0) delta[lrow] = dl;

  // the causal mask lets this block's rows see no column past its last row
  const int kv_end = causal ? min(Skv, q_start + kRows) : Skv;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  for (int k0 = 0; k0 < kv_end; k0 += TILE) {
    __syncthreads();   // every thread is done with the previous tile
    stage<T, D, TILE, THREADS>(ks, kb, k_ss, k0, Skv, 1.f);
    stage<T, D, TILE, THREADS>(vs, vb, v_ss, k0, Skv, 1.f);
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
      const float ds = (!causal || k0 + jj <= i) ? prob_grad(s, dp, L, dl, softcap).y : 0.f;
#pragma unroll
      for (int e = 0; e < kDPT; ++e) acc[e] = fmaf(ds, kr[e], acc[e]);
    }
  }
  if (i < Sq) {
#pragma unroll
    for (int e = 0; e < kDPT; ++e) dq[orow + e] = from_f32<T>(acc[e] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Shape<D>::THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      int Hq, int Hkv, int group, int Sq, int Skv,
                      long long q_sb, long long q_ss, long long q_sh,
                      long long k_sb, long long k_ss, long long k_sh,
                      long long v_sb, long long v_ss, long long v_sh,
                      int causal, float softcap, float scale) {
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
      kr[e] = to_f32(kp[e]);
      vr[e] = to_f32(vp[e]);
      dka[e] = dva[e] = 0.f;
    }
  }

  // causal: rows before the block's first column see none of its columns
  const int i_begin = causal ? k_start / TILE * TILE : 0;
  for (int h = hk * group; h < (hk + 1) * group; ++h) {
    const T* qb = q + b * q_sb + h * q_sh;
    const T* gb = dout + (long long)b * Sq * Hq * D + (long long)h * D;
    const float* lb = lse + ((long long)b * Hq + h) * Sq;
    const float* db = delta + ((long long)b * Hq + h) * Sq;
    for (int i0 = i_begin; i0 < Sq; i0 += TILE) {
      __syncthreads();   // every thread is done with the previous tile
      stage<T, D, TILE, THREADS>(qs, qb, q_ss, i0, Sq, scale);
      stage<T, D, TILE, THREADS>(gs, gb, (long long)Hq * D, i0, Sq, 1.f);
      for (int r = threadIdx.x; r < TILE; r += THREADS) {
        ls[r] = i0 + r < Sq ? lb[i0 + r] : 0.f;
        dls[r] = i0 + r < Sq ? db[i0 + r] : 0.f;
      }
      __syncthreads();
      const int in = min(TILE, Sq - i0);   // the same for every thread
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
        if (live && (!causal || j <= i0 + ii)) pg = prob_grad(s, dp, ls[ii], dls[ii], softcap);
#pragma unroll
        for (int e = 0; e < kDPT; ++e) {
          dva[e] = fmaf(pg.x, grow[e], dva[e]);
          dka[e] = fmaf(pg.y, qrow[e], dka[e]);
        }
      }
    }
  }
  if (live) {
    const long long off = (((long long)b * Skv + j) * Hkv + hk) * D + d0;
#pragma unroll
    for (int e = 0; e < kDPT; ++e) {
      dk[off + e] = from_f32<T>(dka[e]);
      dv[off + e] = from_f32<T>(dva[e]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int Hq,
                   int Hkv, int Sq, int Skv, const long long* qs, const long long* ks_,
                   const long long* vs_, int causal, float softcap, float scale,
                   cudaStream_t stream) {
  constexpr int THREADS = Shape<D>::THREADS;
  const T *qp = static_cast<const T*>(q), *kp = static_cast<const T*>(k),
          *vp = static_cast<const T*>(v);
  flash_bwd_dq_kernel<T, D><<<dim3((Sq + kRows - 1) / kRows, Hq, B), THREADS, 0, stream>>>(
      qp, kp, vp, static_cast<const T*>(o), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), Hq, Hq / Hkv, Sq, Skv, qs[0], qs[1], qs[2], ks_[0], ks_[1], ks_[2],
      vs_[0], vs_[1], vs_[2], causal, softcap, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T, D><<<dim3((Skv + kRows - 1) / kRows, Hkv, B), THREADS, 0, stream>>>(
      qp, kp, vp, static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk),
      static_cast<T*>(dv), Hq, Hkv, Hq / Hkv, Sq, Skv, qs[0], qs[1], qs[2], ks_[0], ks_[1],
      ks_[2], vs_[0], vs_[1], vs_[2], causal, softcap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, int B, int Hq, int Hkv, int Sq, int Skv, const long long* qs,
                       const long long* ks_, const long long* vs_, int causal, float softcap,
                       float scale, cudaStream_t stream) {
  switch (D) {
#define REPRO_FLASH_BWD_D(DD)                                                                  \
  case DD:                                                                                     \
    return launch<T, DD>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, Sq, Skv, qs,    \
                         ks_, vs_, causal, softcap, scale, stream);
    REPRO_FLASH_BWD_D(16)
    REPRO_FLASH_BWD_D(32)
    REPRO_FLASH_BWD_D(64)
    REPRO_FLASH_BWD_D(128)
#undef REPRO_FLASH_BWD_D
    default:
      return cudaErrorInvalidValue;
  }
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

// q and dO, K and V (bf16), dS^T (kv rows of kMaxS bf16), lse and delta
__host__ __device__ constexpr long long smem_bytes(int Sq, int Skv, int D) {
  return 4LL * D * (round16(Sq) + round16(Skv)) + round16(Skv) * kMaxS * 2 + 8 * round16(Sq);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ o,
                    const bf16* __restrict__ dout, const float* __restrict__ lse,
                    bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                    int H, int Sq, int Skv,
                    long long q_sb, long long q_ss, long long q_sh,
                    long long k_sb, long long k_ss, long long k_sh,
                    long long v_sb, long long v_ss, long long v_sh,
                    int causal, float softcap, float scale) {
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

    for (int ic = causal ? jg : 0; ic < sq16 / 16; ++ic) {
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
          float x = st[t][e] * scale, fac = 1.f;
          if (softcap != 0.f) {
            const float th = tanhf(x / softcap);
            x = th * softcap;
            fac = 1.f - th * th;
          }
          const bool ok = i < Sq && j < Skv && (!causal || j <= i);
          const float p = ok ? ex2((x - lse_s[i]) * kLog2e) : 0.f;
          st[t][e] = p;
          dpt[t][e] = p * (dpt[t][e] - delta_s[i]) * fac;
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
    const int jc_end = causal ? min(ig + 1, skv16 / 16) : skv16 / 16;
    for (int jc = 0; jc < jc_end; ++jc) {
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

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, void* dq, void* dk, void* dv, int B, int H, int Sq, int Skv,
                   const long long* qs, const long long* ks_, const long long* vs_, int causal,
                   float softcap, float scale, cudaStream_t stream) {
  const long long bytes = smem_bytes(Sq, Skv, D);
  // the shared-memory limit is raised once per device
  static bool attr[repro::kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = repro::current_device(&dev);
  if (err != cudaSuccess) return err;
  if (!attr[dev]) {
    err = cudaFuncSetAttribute(flash_bwd_tc_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (err != cudaSuccess) return err;
    attr[dev] = true;
  }
  flash_bwd_tc_kernel<D><<<dim3(1, H, B), THREADS, (int)bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Sq, Skv, qs[0], qs[1], qs[2], ks_[0],
      ks_[1], ks_[2], vs_[0], vs_[1], vs_[2], causal, softcap, scale);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D), unit stride on D and the given
// (batch, seq, head) strides in elements. o, dout, dq: contiguous
// (B, Sq, Hq, D); dk, dv: contiguous (B, Skv, Hkv, D); lse (from the
// forward) and delta (scratch the first kernel fills): fp32 (B, Hq, Sq).
// Sq, Skv > 0. dtype: repro::Dtype of q, k, v, o, dout and the gradients.
// variant 0 runs the CUDA-core kernels (delta is their scratch); variant 1
// the tensor-core kernel, which takes bfloat16 with Hq == Hkv, D <= 64,
// Sq, Skv <= 256 within the shared-memory ceiling, strides that are
// multiples of 8 and 16-byte-aligned pointers, and refuses anything else
// (the caller chooses; nothing falls back). Returns the CUDA error of the
// launches (0 on success).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, int dtype, int variant,
    int B, int Hq, int Hkv, int Sq, int Skv, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    int causal, float softcap, float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Skv <= 0) return cudaErrorInvalidValue;
  const long long qs[3] = {q_sb, q_ss, q_sh};
  const long long kst[3] = {k_sb, k_ss, k_sh};
  const long long vst[3] = {v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == kTc) {
    bool ok = dtype == repro::kBFloat16 && Hq == Hkv && D <= 64 && Sq <= tc::kMaxS &&
              Skv <= tc::kMaxS && tc::smem_bytes(Sq, Skv, D) <= tc::kMaxSmem;
    for (int i = 0; i < 3; ++i) ok = ok && qs[i] % 8 == 0 && kst[i] % 8 == 0 && vst[i] % 8 == 0;
    for (const void* p : {q, k, v, o, dout, static_cast<const void*>(dq),
                          static_cast<const void*>(dk), static_cast<const void*>(dv)})
      ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
    if (!ok) return cudaErrorInvalidValue;
    switch (D) {
      case 16:
        return tc::launch<16>(q, k, v, o, dout, lse, dq, dk, dv, B, Hq, Sq, Skv, qs, kst, vst,
                              causal, softcap, scale, s);
      case 32:
        return tc::launch<32>(q, k, v, o, dout, lse, dq, dk, dv, B, Hq, Sq, Skv, qs, kst, vst,
                              causal, softcap, scale, s);
      case 64:
        return tc::launch<64>(q, k, v, o, dout, lse, dq, dk, dv, B, Hq, Sq, Skv, qs, kst, vst,
                              causal, softcap, scale, s);
      default:
        return cudaErrorInvalidValue;
    }
  }
  if (variant != kSimt) return cudaErrorInvalidValue;
  switch (dtype) {
    case repro::kFloat32:
      return dispatch_d<float>(D, q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, Sq, Skv,
                               qs, kst, vst, causal, softcap, scale, s);
    case repro::kBFloat16:
      return dispatch_d<__nv_bfloat16>(D, q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv,
                                       Sq, Skv, qs, kst, vst, causal, softcap, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
