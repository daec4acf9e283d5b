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
// (6d bytes in bf16) for ~10d FLOPs, under 2 FLOP/byte. At Mamba2-1.3B's
// training rows (4096 x 2048 and 4096 x 4096 bf16, one layer's two norms)
// that is ~151 MB, ~45 us at 3.35 TB/s.
//
// Two variants, chosen by the wrapper before the launch
// (kernels/rmsnorm/ops.py:_rmsnorm_bwd_variant); no atomics in either, so dw
// is the same bit for bit from run to run:
//
// "vec", rows that start on 16-byte boundaries and a d that is a multiple of
// 8 (bf16) or 4 (fp32), at most 16 vectors a lane: one warp per row, laid
// out like the forward's rmsnorm_vec_kernel. A lane issues every 16-byte
// load of its share of x and dy before it uses any, holds them in registers
// (VPL vectors each, a template argument: 16 at d = 4096 in bf16), reduces
// the two row sums by shuffles alone (no block barrier) and writes dx as
// 16-byte stores: x and dy are read once. Warps take contiguous row ranges,
// a fixed function of the row count (ops.py:bwd_vec_partition); each lane
// owns fixed columns of its warp's fp32 dw row in shared memory and adds dy
// x r to them row by row in order. At the end the block sums its 4 warps'
// rows in warp order into one partial row; a second kernel sums the
// partials over the blocks, each column's blocks split over 8 warps in a
// fixed interleave and the 8 sums added in a fixed tree, 32 columns a block.
// What holds it near half its bound (chip_smoke.py phase 5 on an H100,
// inputs flushed from L2: ~0.10 ms for a layer's two norms, ~0.7x autograd
// through F.rms_norm): each warp has one row's loads in flight at a time,
// and the training rows give 256 blocks of 4 warps, ~8 warps an SM.
//
// "simt", everything else (d = 300 in bf16, a view one element off 16
// bytes, d past the vectors): the rows are cut into at most kMaxBlocks
// contiguous ranges (a function of the row count alone), one block of 256
// threads a range. The block walks its rows in order; for each row its
// threads take strided columns, the two row sums are reduced by warp
// shuffles and then over the 8 warps in a fixed order, and the row's dx is
// written while dy x r is added to the block's own fp32 dw partial in shared
// memory (each column owned by one thread). A second kernel sums the
// partials over the blocks in block order and rounds once.
#include <stdint.h>

#include <initializer_list>

#include "common.cuh"

namespace {

using repro::from_f32;
using repro::load_w;
using repro::pack16;
using repro::to_f32;
using repro::unpack16;

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
cudaError_t launch_simt(const void* x, const void* w, const void* dy, void* dx, void* part,
                        void* dw, int rows, int d, long long x_sr, int blocks,
                        int rows_per_block, float eps, int gemma, cudaStream_t stream) {
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

// ------------------------------------------------------------- vec variant
constexpr int kVecWarps = 4;                  // warps a block, a row range each
constexpr int kVecThreads = 32 * kVecWarps;
constexpr int kMaxVecs = 16;                  // 16-byte vectors a lane holds, at most
constexpr int kSumCols = 32;                  // columns a block of the partials' sum
constexpr int kSumWarps = 8;                  // warps of that block

template <typename T, typename W, int VPL>
__global__ void __launch_bounds__(kVecThreads)
rmsnorm_bwd_vec_kernel(const T* __restrict__ x, const W* __restrict__ w,
                       const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part,
                       int rows, int d, long long x_sr, int rows_per_warp, float eps,
                       int gemma) {
  constexpr int E = 16 / sizeof(T);   // elements per vector
  extern __shared__ __align__(16) float smem[];   // (kVecWarps, d): the warps' dw rows
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nv = d / E;
  const float one = gemma ? 1.f : 0.f;
  float* dwp = smem + warp * d;
  // a lane owns the columns of its vectors i = lane + 32 k, in every row
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int i = lane + 32 * k;
    if (i < nv) {
#pragma unroll
      for (int e = 0; e < E; e += 4)
        *reinterpret_cast<float4*>(dwp + i * E + e) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  const int r0 = (blockIdx.x * kVecWarps + warp) * rows_per_warp;
  const int r1 = min(rows, r0 + rows_per_warp);
  for (int row = r0; row < r1; ++row) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * x_sr);
    const uint4* dyr = reinterpret_cast<const uint4*>(dy + (long long)row * d);
    uint4 xv[VPL], dv[VPL];
#pragma unroll
    for (int k = 0; k < VPL; ++k) {   // every load issued before any is used
      const int i = lane + 32 * k;
      xv[k] = i < nv ? __ldcs(xr + i) : make_uint4(0u, 0u, 0u, 0u);
      dv[k] = i < nv ? __ldcs(dyr + i) : make_uint4(0u, 0u, 0u, 0u);
    }
    float ss = 0.f, gx = 0.f;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int i = lane + 32 * k;
      if (i < nv) {
        float f[E], g[E], wv[E];
        unpack16(xv[k], f);
        unpack16(dv[k], g);
        load_w<E>(w + i * E, wv);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          ss = fmaf(f[e], f[e], ss);
          gx = fmaf(g[e] * (wv[e] + one), f[e], gx);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {   // a butterfly: every lane gets the same bits
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      gx += __shfl_xor_sync(0xffffffffu, gx, off);
    }
    const float r = rsqrtf(ss / d + eps);
    const float kx = r * r * r * (gx / d);
    uint4* dxr = reinterpret_cast<uint4*>(dx + (long long)row * d);
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int i = lane + 32 * k;
      if (i < nv) {
        float f[E], g[E], wv[E], o[E];
        unpack16(xv[k], f);
        unpack16(dv[k], g);
        load_w<E>(w + i * E, wv);
#pragma unroll
        for (int e = 0; e < E; ++e) o[e] = r * (g[e] * (wv[e] + one)) - f[e] * kx;
        dxr[i] = pack16(o);
#pragma unroll
        for (int e = 0; e < E; e += 4) {
          float4* p = reinterpret_cast<float4*>(dwp + i * E + e);
          float4 a = *p;
          a.x = fmaf(g[e] * f[e], r, a.x);
          a.y = fmaf(g[e + 1] * f[e + 1], r, a.y);
          a.z = fmaf(g[e + 2] * f[e + 2], r, a.z);
          a.w = fmaf(g[e + 3] * f[e + 3], r, a.w);
          *p = a;
        }
      }
    }
  }
  __syncthreads();
  // the block's partial: its warps' rows summed in warp order
  float* pr = part + (long long)blockIdx.x * d;
  for (int c = threadIdx.x * 4; c < d; c += kVecThreads * 4) {
    float4 s = *reinterpret_cast<const float4*>(smem + c);
#pragma unroll
    for (int q = 1; q < kVecWarps; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(smem + q * d + c);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    *reinterpret_cast<float4*>(pr + c) = s;
  }
}

// dw[c] = the sum over blocks of part[b][c]: warp q sums blocks q, q + 8, ...
// in order, then the 8 warp sums are added in a fixed tree
template <typename W>
__global__ void __launch_bounds__(32 * kSumWarps)
dw_tree_sum_kernel(const float* __restrict__ part, W* __restrict__ dw, int blocks, int d) {
  __shared__ float sums[kSumWarps][kSumCols];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c = blockIdx.x * kSumCols + lane;
  float s = 0.f;
  if (c < d)
    for (int b = warp; b < blocks; b += kSumWarps) s += part[(long long)b * d + c];
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < d) {
    const float a = (sums[0][lane] + sums[1][lane]) + (sums[2][lane] + sums[3][lane]);
    const float b = (sums[4][lane] + sums[5][lane]) + (sums[6][lane] + sums[7][lane]);
    dw[c] = from_f32<W>(a + b);
  }
}

template <typename T, typename W>
cudaError_t launch_vec(const void* x, const void* w, const void* dy, void* dx, void* part,
                       void* dw, int rows, int d, long long x_sr, int blocks, int rows_per_warp,
                       float eps, int gemma, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const int nv = d / E;
  if (d % E || nv > 32 * kMaxVecs) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * kVecWarps * (size_t)d;
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  const T* dyp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
  float* pp = static_cast<float*>(part);
  cudaError_t err = cudaErrorInvalidValue;
#define REPRO_NORM_BWD_VPL(V)                                                              \
  if (nv <= 32 * V) {                                                                      \
    err = cudaFuncSetAttribute(rmsnorm_bwd_vec_kernel<T, W, V>,                            \
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);    \
    if (err != cudaSuccess) return err;                                                    \
    rmsnorm_bwd_vec_kernel<T, W, V><<<blocks, kVecThreads, smem, stream>>>(               \
        xp, wp, dyp, dxp, pp, rows, d, x_sr, rows_per_warp, eps, gemma);                   \
    err = cudaGetLastError();                                                              \
  } else
  REPRO_NORM_BWD_VPL(1)
  REPRO_NORM_BWD_VPL(2)
  REPRO_NORM_BWD_VPL(4)
  REPRO_NORM_BWD_VPL(8)
  REPRO_NORM_BWD_VPL(16)
  return cudaErrorInvalidValue;
#undef REPRO_NORM_BWD_VPL
  if (err != cudaSuccess) return err;
  dw_tree_sum_kernel<W><<<(d + kSumCols - 1) / kSumCols, 32 * kSumWarps, 0, stream>>>(
      pp, static_cast<W*>(dw), blocks, d);
  return cudaGetLastError();
}

// variant 0: the strided-column kernel; variant 1: the vectorised one
template <typename T, typename W>
cudaError_t launch(int variant, const void* x, const void* w, const void* dy, void* dx,
                   void* part, void* dw, int rows, int d, long long x_sr, int blocks, int per,
                   float eps, int gemma, cudaStream_t stream) {
  if (variant == 1)
    return launch_vec<T, W>(x, w, dy, dx, part, dw, rows, d, x_sr, blocks, per, eps, gemma,
                            stream);
  return launch_simt<T, W>(x, w, dy, dx, part, dw, rows, d, x_sr, blocks, per, eps, gemma,
                           stream);
}

template <typename T>
cudaError_t dispatch_w(int w_dtype, int variant, const void* x, const void* w, const void* dy,
                       void* dx, void* part, void* dw, int rows, int d, long long x_sr,
                       int blocks, int per, float eps, int gemma, cudaStream_t s) {
  switch (w_dtype) {
    case repro::kFloat32:
      return launch<T, float>(variant, x, w, dy, dx, part, dw, rows, d, x_sr, blocks, per, eps,
                              gemma, s);
    case repro::kBFloat16:
      return launch<T, __nv_bfloat16>(variant, x, w, dy, dx, part, dw, rows, d, x_sr, blocks,
                                      per, eps, gemma, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (rows, d) with row stride x_sr and unit stride on d; w: contiguous (d,);
// dy, dx: contiguous (rows, d) in x's dtype; part: fp32 (blocks, d) scratch;
// dw: (d,) in w's dtype. variant 0 runs the strided-column kernel: block b
// takes rows [b * per, ...), so blocks * per must cover rows. variant 1 the
// vectorised one: warp q of block b takes rows [(4 b + q) * per, ...), so
// 4 * blocks * per must cover rows; it takes a d that is a multiple of 16
// bytes' worth of x's elements (at most 512 vectors), x_sr a multiple of the
// same unless rows == 1, and 16-byte-aligned x, w, dy, dx and part, and
// refuses anything else (the caller chooses; nothing falls back). Returns
// the CUDA error of the launches (0 on success).
extern "C" int rmsnorm_bwd(const void* x, const void* w, const void* dy, void* dx, void* part,
                           void* dw, int x_dtype, int w_dtype, int variant, int rows, int d,
                           long long x_sr, int blocks, int per, float eps, int gemma,
                           void* stream) {
  if (rows < 1 || d < 1 || blocks < 1 || per < 1 || (variant != 0 && variant != 1))
    return cudaErrorInvalidValue;
  const long long covered = (long long)blocks * per * (variant == 1 ? kVecWarps : 1);
  if (covered < rows) return cudaErrorInvalidValue;
  if (variant == 1) {
    const int e = x_dtype == repro::kFloat32 ? 4 : 8;
    bool ok = d % e == 0 && (rows == 1 || x_sr % e == 0);
    for (const void* p : {x, w, dy, static_cast<const void*>(dx), static_cast<const void*>(part)})
      ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
    if (!ok) return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case repro::kFloat32:
      return dispatch_w<float>(w_dtype, variant, x, w, dy, dx, part, dw, rows, d, x_sr, blocks,
                               per, eps, gemma, s);
    case repro::kBFloat16:
      return dispatch_w<__nv_bfloat16>(w_dtype, variant, x, w, dy, dx, part, dw, rows, d, x_sr,
                                       blocks, per, eps, gemma, s);
    default:
      return cudaErrorInvalidValue;
  }
}
