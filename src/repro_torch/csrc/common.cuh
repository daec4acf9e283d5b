// Shared helpers of the port's CUDA kernels: dtype codes and conversions.
// Each kernel file is compiled by nvcc into its own shared library with a
// plain C interface (no PyTorch headers), loaded from Python with ctypes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // namespace repro
