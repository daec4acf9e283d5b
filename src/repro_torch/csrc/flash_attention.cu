// Flash-attention forward for Hopper (sm_90a), CUDA cores, fp32 softmax.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py
// (_fwd_kernel, launched by flash_attention_fwd). It computes the same
// function: out = softmax(mask(softcap(scale*q.k^T))) v per (batch, head),
// with causal and sliding-window masks from absolute positions, GQA by
// head index (kv head = h / (Hq/Hkv)), and an online softmax whose running
// max, sum and accumulator stay in fp32 registers.
//
// What bounds it on the H100: at the Mirage agent's shape (S=144, D=32,
// 640 sequences x 8 heads) q, k, v and o move ~189 MB once, ~56 us at
// 3.35 TB/s, while the ~14 GFLOP of q.k^T and p.v take ~14 us on the bf16
// tensor cores: the card's bound is bytes. This design does its dot
// products on the CUDA cores in fp32 (67 TFLOP/s peak; ~24 GFLOP once the
// ragged last tiles pad rows and columns from 144 to 192, so >= ~0.36 ms),
// which is the ceiling it can reach, above the bytes bound.
//
// Design: one thread block per (64-row q tile, head, batch). TPR = D/32
// adjacent threads share a q row, each owning 32 head dims of q and of the
// accumulator in registers (D=16 uses one thread of 16 dims); partial dot
// products are summed with warp shuffles. K/V tiles are staged through shared
// memory as fp32, read back as warp-wide broadcasts. Scores are processed 16
// columns at a time, so the accumulator is rescaled once per 16 columns.
// Masks are applied in registers, with no padded copies of q, k or v: rows
// past Sq compute but do not store, columns past Skv load as zeros and mask
// to -1e30 (the ragged last tile at S=144). Tiles that the causal or window
// mask empties for the whole block are never loaded. Strides are taken for
// batch, sequence and head, so the model's (B, S, H, D) views need no copy.
// Tensor cores (mma.sync / wgmma) are left for a later change.
#include <math.h>

#include "common.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int kBlockQ = 64;      // query rows per thread block
constexpr int kChunk = 16;       // kv columns per online-softmax update
constexpr float kNegInf = -1e30f;

template <typename T, int D>
__global__ void __launch_bounds__(kBlockQ * (D > 32 ? D / 32 : 1))
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int Hq, int group, int Sq, int Skv,
                 long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh,
                 int causal, int window, float softcap, float scale) {
  constexpr int DPT = D > 32 ? 32 : D;      // head dims per thread
  constexpr int TPR = D / DPT;              // threads per query row
  constexpr int NT = kBlockQ * TPR;
  constexpr int BKV = D == 128 ? 32 : 64;   // kv rows per shared tile
  __shared__ __align__(16) float ks[BKV][D];
  __shared__ __align__(16) float vs[BKV][D];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int hk = h / group;
  const int q_start = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x;
  const int qpos = q_start + tid / TPR;
  const int d0 = (tid % TPR) * DPT;

  float qr[DPT], acc[DPT];
  {
    // rows past Sq read the last row (in bounds) and never store
    const T* qp = q + b * q_sb + (long long)min(qpos, Sq - 1) * q_ss + h * q_sh + d0;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      qr[i] = to_f32(qp[i]) * scale;
      acc[i] = 0.f;
    }
  }
  float m = kNegInf, l = 0.f;

  // kv tiles that hold an unmasked column for some row of this block:
  // causal keeps columns <= the block's last row, a window keeps columns
  // > the first row's position - window
  int kv_end = Skv;
  if (causal) kv_end = min(kv_end, q_start + kBlockQ);
  const int kv_begin = window ? max(0, q_start - window + 1) : 0;
  const int t_begin = kv_begin / BKV;
  const int t_end = (kv_end + BKV - 1) / BKV;

  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BKV;
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = tid; idx < BKV * D; idx += NT) {
      const int j = idx / D, dd = idx % D;
      const int kp = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (kp < Skv) {
        kx = to_f32(kb[(long long)kp * k_ss + dd]);
        vx = to_f32(vb[(long long)kp * v_ss + dd]);
      }
      ks[j][dd] = kx;
      vs[j][dd] = vx;
    }
    __syncthreads();

#pragma unroll 1
    for (int c0 = 0; c0 < BKV; c0 += kChunk) {
      float s[kChunk];
      float cmax = kNegInf;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float* kr = &ks[c0 + j][d0];
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < DPT; ++i) dot = fmaf(qr[i], kr[i], dot);
#pragma unroll
        for (int off = TPR / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (softcap != 0.f) dot = tanhf(dot / softcap) * softcap;
        const int kp = k0 + c0 + j;
        bool ok = kp < Skv;
        if (causal) ok = ok && kp <= qpos;
        if (window) ok = ok && qpos - kp < window;
        s[j] = ok ? dot : kNegInf;
        cmax = fmaxf(cmax, s[j]);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        s[j] = expf(s[j] - m_new);
        psum += s[j];
      }
      l = l * corr + psum;
      m = m_new;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] *= corr;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float* vr = &vs[c0 + j][d0];
#pragma unroll
        for (int i = 0; i < DPT; ++i) acc[i] = fmaf(s[j], vr[i], acc[i]);
      }
    }
  }

  if (qpos < Sq) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* op = o + (((long long)b * Sq + qpos) * Hq + h) * D + d0;
#pragma unroll
    for (int i = 0; i < DPT; ++i) op[i] = from_f32<T>(acc[i] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Hq, int Hkv, int Sq, int Skv,
                   const long long* qs, const long long* ks_, const long long* vs_,
                   int causal, int window, float softcap, float scale,
                   cudaStream_t stream) {
  constexpr int TPR = D > 32 ? D / 32 : 1;
  dim3 grid((Sq + kBlockQ - 1) / kBlockQ, Hq, B);
  flash_fwd_kernel<T, D><<<grid, kBlockQ * TPR, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Hq, Hq / Hkv, Sq, Skv, qs[0], qs[1], qs[2],
      ks_[0], ks_[1], ks_[2], vs_[0], vs_[1], vs_[2], causal, window, softcap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
                       int B, int Hq, int Hkv, int Sq, int Skv,
                       const long long* qs, const long long* ks_, const long long* vs_,
                       int causal, int window, float softcap, float scale,
                       cudaStream_t stream) {
#define REPRO_FLASH_D(DD)                                                            \
  case DD:                                                                           \
    return launch<T, DD>(q, k, v, o, B, Hq, Hkv, Sq, Skv, qs, ks_, vs_, causal, window, \
                         softcap, scale, stream);
  switch (D) {
    REPRO_FLASH_D(16)
    REPRO_FLASH_D(32)
    REPRO_FLASH_D(64)
    REPRO_FLASH_D(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_D
}

}  // namespace

// q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D), each with unit stride on D and
// the given (batch, seq, head) strides in elements. o: contiguous
// (B, Sq, Hq, D). Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int B, int Hq, int Hkv, int Sq, int Skv, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    int causal, int window, float softcap, float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  const long long qs[3] = {q_sb, q_ss, q_sh};
  const long long kst[3] = {k_sb, k_ss, k_sh};
  const long long vst[3] = {v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kFloat32:
      return dispatch_d<float>(D, q, k, v, o, B, Hq, Hkv, Sq, Skv, qs, kst, vst, causal,
                               window, softcap, scale, s);
    case repro::kBFloat16:
      return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, Hq, Hkv, Sq, Skv, qs, kst, vst,
                                       causal, window, softcap, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
