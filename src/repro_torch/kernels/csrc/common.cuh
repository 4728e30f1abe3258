// Shared device helpers for the port's kernels: fp32 conversion of the
// two element types the kernels take (float, bf16), 16-byte vector
// loads, warp reductions, and the error-string export every library
// carries.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define KERNEL_EXPORT extern "C" __attribute__((visibility("default")))

namespace port {

// Masked score, as in the Pallas kernels (finite, so exp(NEG - NEG) = 1).
constexpr float NEG_INF = -1e30f;

// dtype codes passed from the Python wrappers
constexpr int DT_F32 = 0;
constexpr int DT_BF16 = 1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Elements of T in one 16-byte vector.
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

// Load N = Vec<T>::N consecutive elements (16-byte aligned) as floats.
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) out[i] = to_f(e[i]);
}

// Store N = Vec<T>::N floats as consecutive elements (16-byte aligned).
template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float* in) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) e[i] = from_f<T>(in[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum or max; every thread gets the result. ``red`` holds at
// least 32 floats of shared memory. Reduction order is fixed, so the
// result is deterministic.
template <bool IS_MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = IS_MAX ? warp_max(v) : warp_sum(v);
  __syncthreads();  // ``red`` may still be read from a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < nwarps ? red[lane] : (IS_MAX ? NEG_INF : 0.f);
  t = IS_MAX ? warp_max(t) : warp_sum(t);
  return t;
}

}  // namespace port

KERNEL_EXPORT const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
