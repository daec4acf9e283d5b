// Grouped GEMM for Hopper (sm_90a): out[e] = x[e] @ w[e], CUDA cores,
// fp32 accumulation.
//
// Replaces the Pallas TPU kernel repro/kernels/moe_gemm/kernel.py
// (_gemm_kernel, launched by grouped_gemm): x (E, C, d) times w (E, d, f)
// into out (E, C, f) in x's dtype, the products accumulated in fp32.
//
// What bounds it on the H100: at the Mirage MoE trunk's shapes (E=10,
// C=9216, d->f of 256->1024) the work is ~48 GFLOP for ~241 MB of bf16
// traffic, ~200 FLOP/byte, below the card's ~295 FLOP/byte balance point
// (989 TFLOP/s bf16 tensor cores over 3.35 TB/s HBM). So the card's bound
// is bytes: ~72 us to move x, w and out once, against ~49 us of
// tensor-core FLOPs. The trunk's other projections (256->256, 1024->256)
// sit lower still, at ~127 and ~200 FLOP/byte. What the design does about
// the bytes: it reads each operand in place (masked ragged edges instead of
// padded copies, strided weight views instead of contiguous ones) and
// writes out once, so HBM traffic is the minimum apart from the re-reads
// of x across the f/64 column tiles, which L2 serves. What bounds this
// kernel itself is not the card's bound: it does its FMAs on the CUDA cores
// in fp32 (67 TFLOP/s peak, so >= ~0.72 ms at 256->1024, 10x the bytes
// bound). Tensor cores (mma.sync / wgmma) are the next step; they bring
// the FLOP time under the byte time, after which the tile shape must keep
// x's re-reads out of HBM.
//
// Design: grid (f tiles, C tiles, E); each block of 256 threads computes a
// 64x64 output tile, each thread a 4x4 patch in registers. The contraction
// runs in steps of 16 through shared memory, where x is kept transposed so
// that a thread reads its 4 rows and 4 columns as two 16-byte loads. Ragged
// C, d and f are masked on load (zeros) and on store: no padded copies.
// x and w may be strided on their two leading axes (unit stride on the last),
// so the model's weight views need no copy.
#include "common.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int kBM = 64, kBN = 64, kBK = 16;
constexpr int kTM = 4, kTN = 4;
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);   // 256
constexpr int kPad = 4;                               // keeps float4 alignment

template <typename T>
__global__ void __launch_bounds__(kThreads)
grouped_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                    int C, int d, int f, long long x_se, long long x_sc,
                    long long w_se, long long w_sk) {
  __shared__ __align__(16) float xs[kBK][kBM + kPad];   // x tile, transposed
  __shared__ __align__(16) float ws[kBK][kBN + kPad];

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const T* xe = x + e * x_se;
  const T* we = w + e * w_se;
  T* oe = out + (long long)e * C * f;

  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);
  const int ty = tid / (kBN / kTN);

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kBK) {
#pragma unroll
    for (int r = 0; r < kBM * kBK / kThreads; ++r) {
      const int idx = tid + r * kThreads;
      const int mm = idx / kBK, kk = idx % kBK;
      const int gm = m0 + mm, gk = k0 + kk;
      xs[kk][mm] = (gm < C && gk < d) ? to_f32(xe[gm * x_sc + gk]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kBK * kBN / kThreads; ++r) {
      const int idx = tid + r * kThreads;
      const int kk = idx / kBN, nn = idx % kBN;
      const int gk = k0 + kk, gn = n0 + nn;
      ws[kk][nn] = (gk < d && gn < f) ? to_f32(we[gk * w_sk + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * kTM]);
      const float4 bv = *reinterpret_cast<const float4*>(&ws[kk][tx * kTN]);
      const float av[kTM] = {a.x, a.y, a.z, a.w};
      const float bw[kTN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty * kTM + i;
    if (gm >= C) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + tx * kTN + j;
      if (gn < f) oe[(long long)gm * f + gn] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, int E, int C, int d, int f,
                   long long x_se, long long x_sc, long long w_se, long long w_sk,
                   cudaStream_t stream) {
  dim3 grid((f + kBN - 1) / kBN, (C + kBM - 1) / kBM, E);
  grouped_gemm_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), C, d, f,
      x_se, x_sc, w_se, w_sk);
  return cudaGetLastError();
}

}  // namespace

// x: (E, C, d) with strides (x_se, x_sc, 1); w: (E, d, f) with strides
// (w_se, w_sk, 1); out: contiguous (E, C, f). Returns the CUDA error of the
// launch (0 on success).
extern "C" int grouped_gemm(const void* x, const void* w, void* out, int dtype,
                            int E, int C, int d, int f, long long x_se, long long x_sc,
                            long long w_se, long long w_sk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kFloat32:
      return launch<float>(x, w, out, E, C, d, f, x_se, x_sc, w_se, w_sk, s);
    case repro::kBFloat16:
      return launch<__nv_bfloat16>(x, w, out, E, C, d, f, x_se, x_sc, w_se, w_sk, s);
    default:
      return cudaErrorInvalidValue;
  }
}
