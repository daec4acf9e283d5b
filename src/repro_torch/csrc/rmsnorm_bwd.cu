// The backward of RMSNorm for Hopper (sm_90a): given x (rows, d), w (d,) and
// dy (rows, d), with r = rsqrt(mean(x^2) + eps), w' = w (or 1 + w in gemma
// mode) and g = dy * w', all in fp32,
//   dx = r g - x r^3 mean(g x)          in x's dtype, one rounding
//   dw = sum over rows of dy x r         in w's dtype, one rounding
//
// The Pallas TPU kernel repro/kernels/rmsnorm/kernel.py (_rmsnorm_kernel) has
// no backward: the JAX package differentiates its jnp RMSNorm
// (repro/models/layers.py::apply_norm) with jax.value_and_grad. This is the
// VJP that autodiff gives that function, written out; the port's forward
// kernel is csrc/rmsnorm.cu.
//
// What bounds it on the H100: bytes. Per row it reads x and dy and writes dx
// (6d bytes in bf16) for ~8d FLOPs, under 2 FLOP/byte. At Mamba2-1.3B's
// training rows (4096 x 4096 bf16) that is ~100 MB, ~30 us at 3.35 TB/s.
//
// Design, simple and deterministic: the rows are cut into at most
// kMaxBlocks contiguous ranges (a function of the row count alone), one block
// of 256 threads a range. The block walks its rows in order; for each row
// its threads take strided columns, the two row sums (x^2 and g x) are
// reduced by warp shuffles and then over the 8 warps in a fixed order, and
// the row's dx is written while dy x r is added to the block's own fp32 dw
// partial in shared memory (each column owned by one thread). A second
// kernel sums the partials over the blocks in block order and rounds once.
// No atomics: dw is the same bit for bit from run to run.
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const W* __restrict__ w, const T* __restrict__ dy,
                   T* __restrict__ dx, float* __restrict__ part, int rows, int d,
                   long long x_sr, int rows_per_block, float eps, int gemma) {
  extern __shared__ __align__(16) float smem[];
  float* dwp = smem;                 // (d,) this block's dw partial
  float* red = smem + d;             // (2 * kWarps,) warp sums
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const float one = gemma ? 1.f : 0.f;
  for (int c = tid; c < d; c += kThreads) dwp[c] = 0.f;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  for (int row = r0; row < r1; ++row) {
    const T* xr = x + row * x_sr;
    const T* dyr = dy + (long long)row * d;
    float ss = 0.f, gx = 0.f;
    for (int c = tid; c < d; c += kThreads) {
      const float xv = to_f32(xr[c]);
      const float g = to_f32(dyr[c]) * (to_f32(w[c]) + one);
      ss = fmaf(xv, xv, ss);
      gx = fmaf(g, xv, gx);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      gx += __shfl_xor_sync(0xffffffffu, gx, off);
    }
    if (lane == 0) {
      red[warp] = ss;
      red[kWarps + warp] = gx;
    }
    __syncthreads();
    ss = 0.f;
    gx = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {   // every thread sums in the same order
      ss += red[i];
      gx += red[kWarps + i];
    }
    const float r = rsqrtf(ss / d + eps);
    const float k = r * r * r * (gx / d);
    T* dxr = dx + (long long)row * d;
    for (int c = tid; c < d; c += kThreads) {
      const float xv = to_f32(xr[c]);
      const float dv = to_f32(dyr[c]);
      const float g = dv * (to_f32(w[c]) + one);
      dxr[c] = from_f32<T>(r * g - xv * k);
      dwp[c] = fmaf(dv * xv, r, dwp[c]);
    }
    __syncthreads();                     // red is rewritten by the next row
  }
  float* pr = part + (long long)blockIdx.x * d;
  for (int c = tid; c < d; c += kThreads) pr[c] = dwp[c];
}

// dw[c] = sum over blocks, in block order, of part[b][c]
template <typename W>
__global__ void __launch_bounds__(kThreads)
dw_sum_kernel(const float* __restrict__ part, W* __restrict__ dw, int blocks, int d) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += part[(long long)b * d + c];
  dw[c] = from_f32<W>(s);
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* w, const void* dy, void* dx, void* part, void* dw,
                   int rows, int d, long long x_sr, int blocks, int rows_per_block, float eps,
                   int gemma, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)d + 2 * kWarps);
  auto kern = rmsnorm_bwd_kernel<T, W>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<const T*>(dy),
      static_cast<T*>(dx), static_cast<float*>(part), rows, d, x_sr, rows_per_block, eps,
      gemma);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dw_sum_kernel<W><<<(d + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<W*>(dw), blocks, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_w(int w_dtype, const void* x, const void* w, const void* dy, void* dx,
                       void* part, void* dw, int rows, int d, long long x_sr, int blocks,
                       int rows_per_block, float eps, int gemma, cudaStream_t s) {
  switch (w_dtype) {
    case repro::kFloat32:
      return launch<T, float>(x, w, dy, dx, part, dw, rows, d, x_sr, blocks, rows_per_block,
                              eps, gemma, s);
    case repro::kBFloat16:
      return launch<T, __nv_bfloat16>(x, w, dy, dx, part, dw, rows, d, x_sr, blocks,
                                      rows_per_block, eps, gemma, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (rows, d) with row stride x_sr and unit stride on d; w: contiguous (d,);
// dy, dx: contiguous (rows, d) in x's dtype; part: fp32 (blocks, d) scratch;
// dw: (d,) in w's dtype. Block b takes rows [b * rows_per_block, ...), so
// blocks * rows_per_block must cover rows. Returns the CUDA error of the
// launches (0 on success).
extern "C" int rmsnorm_bwd(const void* x, const void* w, const void* dy, void* dx, void* part,
                           void* dw, int x_dtype, int w_dtype, int rows, int d,
                           long long x_sr, int blocks, int rows_per_block, float eps, int gemma,
                           void* stream) {
  if (rows < 1 || d < 1 || blocks < 1 || (long long)blocks * rows_per_block < rows)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case repro::kFloat32:
      return dispatch_w<float>(w_dtype, x, w, dy, dx, part, dw, rows, d, x_sr, blocks,
                               rows_per_block, eps, gemma, s);
    case repro::kBFloat16:
      return dispatch_w<__nv_bfloat16>(w_dtype, x, w, dy, dx, part, dw, rows, d, x_sr, blocks,
                                       rows_per_block, eps, gemma, s);
    default:
      return cudaErrorInvalidValue;
  }
}
