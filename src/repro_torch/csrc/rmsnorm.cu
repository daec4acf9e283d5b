// RMSNorm for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * w, or
// * (1 + w) in gemma mode, computed in fp32 and written in x's dtype.
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm/kernel.py
// (_rmsnorm_kernel, launched by rmsnorm_fwd): the same function over
// (rows, d), one read of x and one write of y per row.
//
// What bounds it on the H100: bytes. A row of d values costs ~3d FLOPs
// (square-sum, scale, weight) against 2d bytes read and 2d written in bf16,
// under 1 FLOP/byte, far below the card's ~295 FLOP/byte balance point. At
// the Mamba2-1.3B prefill shapes, (8192, 2048) and (8192, 4096) in bf16 with
// an fp32 w, x and y move 67 MB and 134 MB: ~20 us and ~40 us at 3.35 TB/s.
// Each decode step's (4, 2048) and (4, 4096) rows move a few tens of KB,
// so there the launch itself (a few us) is the cost.
//
// What the design does about the bytes: one warp per row, 8 rows per block.
// The warp reads its row once for the sum of squares (coalesced, each lane
// striding by 32 elements), reduces it with shuffles, then reads the row
// again to scale and write it. The second read finds the row in L1/L2 (a
// block's 8 rows are at most 128 KB in fp32), so HBM sees x once and y
// once. Loads are one element per lane; 16-byte vector loads are the next
// step if the bytes bound is to be approached.
#include "common.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int kRowsPerBlock = 8;
constexpr int kThreads = 32 * kRowsPerBlock;

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ y,
               int rows, int d, long long x_sr, float eps, int gemma) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + row * x_sr;
  float ss = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float v = to_f32(xr[i]);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float inv = rsqrtf(ss / d + eps);
  T* yr = y + (long long)row * d;
  for (int i = lane; i < d; i += 32) {
    float wv = to_f32(w[i]);
    if (gemma) wv += 1.f;
    yr[i] = from_f32<T>(to_f32(xr[i]) * inv * wv);
  }
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* w, void* y, int rows, int d, long long x_sr,
                   float eps, int gemma, cudaStream_t stream) {
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  rmsnorm_kernel<T, W><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(y), rows, d, x_sr,
      eps, gemma);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_w(int w_dtype, const void* x, const void* w, void* y, int rows, int d,
                       long long x_sr, float eps, int gemma, cudaStream_t stream) {
  switch (w_dtype) {
    case repro::kFloat32:
      return launch<T, float>(x, w, y, rows, d, x_sr, eps, gemma, stream);
    case repro::kBFloat16:
      return launch<T, __nv_bfloat16>(x, w, y, rows, d, x_sr, eps, gemma, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (rows, d) with row stride x_sr and unit stride on d; w: contiguous (d,)
// in its own dtype; y: contiguous (rows, d) in x's dtype. Returns the CUDA
// error of the launch (0 on success).
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* y, int x_dtype, int w_dtype,
                           int rows, int d, long long x_sr, float eps, int gemma,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case repro::kFloat32:
      return dispatch_w<float>(w_dtype, x, w, y, rows, d, x_sr, eps, gemma, s);
    case repro::kBFloat16:
      return dispatch_w<__nv_bfloat16>(w_dtype, x, w, y, rows, d, x_sr, eps, gemma, s);
    default:
      return cudaErrorInvalidValue;
  }
}
