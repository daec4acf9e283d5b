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
// Two variants, chosen by the wrapper before the launch
// (kernels/rmsnorm/ops.py:_rmsnorm_variant):
//
// "vec", rows that start on 16-byte boundaries and a d that is a multiple
// of 8 (bf16) or 4 (fp32), up to 896 such vectors: one warp per row, 4 rows
// per block. Every access is 16 bytes a lane. A lane issues all of its
// loads of x (VPL vectors, a template argument: 16 at d = 4096 in bf16, 24
// at Gemma-3's d = 5376, whose 672 vectors leave 21 a lane, 28 at
// Zamba2-7B's d_inner = 7168, 896 vectors, its gated out_norm) before the
// shuffle reduction, so a warp keeps its whole row in flight (8 KB at
// d = 4096) and the bytes cover the memory latency; the row stays
// in registers between the sum of squares and the scale, so x is read
// once, with no second pass. w comes as 16-byte vectors from L1/L2 (every
// row reads all of it), y goes out as 16-byte stores. Small blocks keep
// many rows per SM in flight.
//
// "simt", everything else (d = 300 in bf16, a view one element off 16
// bytes): one warp per row, 8 rows per block; each lane reads one element at
// a time, striding by 32, for the sum of squares, then reads the row again
// (from L1/L2) to scale and write it.
#include <stdint.h>

#include <initializer_list>

#include "common.cuh"

namespace {

using repro::from_f32;
using repro::load_w;
using repro::pack16;
using repro::to_f32;
using repro::unpack16;

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
cudaError_t launch_simt(const void* x, const void* w, void* y, int rows, int d,
                        long long x_sr, float eps, int gemma, cudaStream_t stream) {
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  rmsnorm_kernel<T, W><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(y), rows, d, x_sr,
      eps, gemma);
  return cudaGetLastError();
}

// ------------------------------------------------------------- vec variant
constexpr int kVecRows = 4;
constexpr int kVecThreads = 32 * kVecRows;
constexpr int kMaxVecs = 28;      // 16-byte vectors a lane holds, at most

template <typename T, typename W, int VPL>
__global__ void __launch_bounds__(kVecThreads)
rmsnorm_vec_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ y,
                   int rows, int d, long long x_sr, float eps, int gemma) {
  constexpr int E = 16 / sizeof(T);   // elements per vector
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kVecRows + threadIdx.x / 32;
  if (row >= rows) return;
  const int nv = d / E;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * x_sr);
  uint4 v[VPL];
#pragma unroll
  for (int k = 0; k < VPL; ++k) {   // every load issued before any is used
    const int i = lane + 32 * k;
    v[k] = i < nv ? __ldcs(xr + i) : make_uint4(0u, 0u, 0u, 0u);
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    float f[E];
    unpack16(v[k], f);
#pragma unroll
    for (int e = 0; e < E; ++e) ss = fmaf(f[e], f[e], ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float inv = rsqrtf(ss / d + eps);
  uint4* yr = reinterpret_cast<uint4*>(y + (long long)row * d);
  const float one = gemma ? 1.f : 0.f;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int i = lane + 32 * k;
    if (i < nv) {
      float f[E], wv[E];
      unpack16(v[k], f);
      load_w<E>(w + i * E, wv);
#pragma unroll
      for (int e = 0; e < E; ++e) f[e] = f[e] * inv * (wv[e] + one);
      yr[i] = pack16(f);
    }
  }
}

template <typename T, typename W>
cudaError_t launch_vec(const void* x, const void* w, void* y, int rows, int d, long long x_sr,
                       float eps, int gemma, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const int nv = d / E;
  if (d % E || nv > 32 * kMaxVecs) return cudaErrorInvalidValue;
  const int blocks = (rows + kVecRows - 1) / kVecRows;
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  T* yp = static_cast<T*>(y);
#define REPRO_NORM_VPL(V)                                                          \
  if (nv <= 32 * V) {                                                              \
    rmsnorm_vec_kernel<T, W, V><<<blocks, kVecThreads, 0, stream>>>(xp, wp, yp, rows, d, \
                                                                   x_sr, eps, gemma); \
    return cudaGetLastError();                                                     \
  }
  REPRO_NORM_VPL(1)
  REPRO_NORM_VPL(2)
  REPRO_NORM_VPL(4)
  REPRO_NORM_VPL(8)
  REPRO_NORM_VPL(16)
  REPRO_NORM_VPL(24)
  REPRO_NORM_VPL(28)
#undef REPRO_NORM_VPL
  return cudaErrorInvalidValue;
}

// variant 0: the one-element-per-lane kernel; variant 1: the vectorised one
template <typename T, typename W>
cudaError_t launch(int variant, const void* x, const void* w, void* y, int rows, int d,
                   long long x_sr, float eps, int gemma, cudaStream_t stream) {
  if (variant == 1) return launch_vec<T, W>(x, w, y, rows, d, x_sr, eps, gemma, stream);
  return launch_simt<T, W>(x, w, y, rows, d, x_sr, eps, gemma, stream);
}

template <typename T>
cudaError_t dispatch_w(int w_dtype, int variant, const void* x, const void* w, void* y,
                       int rows, int d, long long x_sr, float eps, int gemma,
                       cudaStream_t stream) {
  switch (w_dtype) {
    case repro::kFloat32:
      return launch<T, float>(variant, x, w, y, rows, d, x_sr, eps, gemma, stream);
    case repro::kBFloat16:
      return launch<T, __nv_bfloat16>(variant, x, w, y, rows, d, x_sr, eps, gemma, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (rows, d) with row stride x_sr and unit stride on d; w: contiguous (d,)
// in its own dtype; y: contiguous (rows, d) in x's dtype. variant 0 runs the
// one-element-per-lane kernel; variant 1 the vectorised one, which takes a
// d that is a multiple of 16 bytes' worth of x's elements (at most 896
// vectors), x_sr a multiple of the same unless rows == 1, and 16-byte-
// aligned x, w and y, and refuses anything else (the caller chooses;
// nothing falls back). Returns the CUDA error of the launch (0 on success).
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* y, int x_dtype, int w_dtype,
                           int variant, int rows, int d, long long x_sr, float eps, int gemma,
                           void* stream) {
  if (variant != 0 && variant != 1) return cudaErrorInvalidValue;
  if (variant == 1) {
    const int e = x_dtype == repro::kFloat32 ? 4 : 8;
    bool ok = d % e == 0 && (rows == 1 || x_sr % e == 0);
    for (const void* p : {x, w, static_cast<const void*>(y)})
      ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
    if (!ok) return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case repro::kFloat32:
      return dispatch_w<float>(w_dtype, variant, x, w, y, rows, d, x_sr, eps, gemma, s);
    case repro::kBFloat16:
      return dispatch_w<__nv_bfloat16>(w_dtype, variant, x, w, y, rows, d, x_sr, eps, gemma,
                                       s);
    default:
      return cudaErrorInvalidValue;
  }
}
