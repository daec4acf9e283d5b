// Shared helpers of the port's CUDA kernels: dtype codes and conversions,
// the tensor-core building blocks (cp.async copies, ldmatrix,
// mma.sync.m16n8k16 on bf16) of the flash and SSD kernels, and the 16-byte
// vectors of the RMSNorm kernels. Each kernel file is compiled by nvcc into
// its own shared library with a plain C interface (no PyTorch headers),
// loaded from Python with ctypes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// dtype codes shared with repro_torch/kernels/_build.py
enum Dtype : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// the current device, for state that a launch function keeps per device;
// refuses devices past kMaxDevices
constexpr int kMaxDevices = 64;
inline cudaError_t current_device(int* dev) {
  cudaError_t err = cudaGetDevice(dev);
  if (err == cudaSuccess && (*dev < 0 || *dev >= kMaxDevices)) err = cudaErrorInvalidDevice;
  return err;
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// ------------------------------------------------ tensor-core building blocks

// Byte offset of 16-byte chunk c of row r in a bf16 tile whose rows hold E
// elements (E/8 chunks). Chunks are XOR-swizzled within each 128-byte line,
// so the 8 rows that one ldmatrix phase reads at one column land in 8
// different bank groups. Rows of a multiple of 8 chunks swizzle within the
// row; other widths (the flash kernels' head dims of 48, 80, 96 and 112)
// within the tile's 128-byte lines taken in order, which any tile of a
// multiple of 8 chunks fills whole.
template <int E>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  constexpr int CPR = E / 8;
  if constexpr (CPR >= 8 && CPR % 8 == 0) {
    return (uint32_t)(r * CPR + ((c & ~7) | ((c & 7) ^ (r & 7)))) << 4;
  } else {
    const int lin = r * CPR + c, line = lin >> 3;
    return (uint32_t)((line << 3) | ((lin & 7) ^ (line & 7))) << 4;
  }
}

// 16 bytes global -> shared, bypassing L1; zero-filled unless ok
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared; zero-filled unless ok
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d (16x8 fp32) += a (16x16 bf16, row-major fragment) . b (16x8 bf16, col-major)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a . b, starting from zero
__device__ __forceinline__ void mma16816_zero(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  const float z = 0.f;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(z));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// 2^x, the SFU's approximation (relative error ~2^-22)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes of fp32 or bf16 as floats, and back (the RMSNorm kernels' vectors)
__device__ __forceinline__ void unpack16(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack16(const uint4& v, float (&f)[8]) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = unpack_bf16(u[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}
__device__ __forceinline__ uint4 pack16(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack16(const float (&f)[8]) {
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                    pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
}

// E elements of w from a 16-byte-aligned address, as floats
template <int E>
__device__ __forceinline__ void load_w(const float* w, float (&f)[E]) {
#pragma unroll
  for (int i = 0; i < E; i += 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(w + i));
    f[i] = v.x;
    f[i + 1] = v.y;
    f[i + 2] = v.z;
    f[i + 3] = v.w;
  }
}
template <int E>
__device__ __forceinline__ void load_w(const __nv_bfloat16* w, float (&f)[E]) {
  if constexpr (E == 8) {
    unpack16(__ldg(reinterpret_cast<const uint4*>(w)), f);
  } else {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(w));
    const float2 a = unpack_bf16(v.x), b = unpack_bf16(v.y);
    f[0] = a.x;
    f[1] = a.y;
    f[2] = b.x;
    f[3] = b.y;
  }
}

}  // namespace repro
