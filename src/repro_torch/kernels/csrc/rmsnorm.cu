// K5 — fused RMSNorm for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm (body
// ``_kernel``): out = x * rsqrt(mean(x^2) + eps) * w, with the mean of
// squares, the rsqrt and the scale all in fp32, one output write.
//
// Bound on the H100: bytes. Per element it reads x and writes out (w is
// d elements, shared by every row and served from L1/L2), and does ~4
// flops, far below the card's ~20 flops per byte for fp32 CUDA cores.
//
// Design: one block per row. Threads load 16-byte vectors (4 floats or
// 8 bf16), so a warp moves 512 contiguous bytes per load; the sum of
// squares is reduced in fp32 across the warp with shuffles and across
// warps through shared memory in a fixed order (deterministic). The
// second pass re-reads the row, which the first pass left in L1, and
// writes each output element once. With d = 1024 the whole block is
// 128 (bf16) or 256 (fp32) threads and each thread touches one vector
// per pass. Why CUDA and not Triton: a row reduction plus a scale is
// equally easy in either, and CUDA keeps the port to one nvcc build.
#include "common.cuh"

namespace {

template <typename T>
__global__ void rmsnorm_kernel(const T* __restrict__ x,
                               const T* __restrict__ w, T* __restrict__ out,
                               int d, float eps) {
  constexpr int N = port::Vec<T>::N;
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* outr = out + row * d;
  float buf[N];

  float ss = 0.f;
  for (int i = threadIdx.x * N; i < d; i += blockDim.x * N) {
    port::load_vec(xr + i, buf);
#pragma unroll
    for (int j = 0; j < N; ++j) ss += buf[j] * buf[j];
  }
  ss = port::block_reduce<false>(ss, red);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

  float wb[N];
  for (int i = threadIdx.x * N; i < d; i += blockDim.x * N) {
    port::load_vec(xr + i, buf);
    port::load_vec(w + i, wb);
#pragma unroll
    for (int j = 0; j < N; ++j) buf[j] = (buf[j] * r) * wb[j];
    port::store_vec(outr + i, buf);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, int m, int d,
                   float eps, cudaStream_t stream) {
  constexpr int N = port::Vec<T>::N;
  int threads = ((d / N + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  rmsnorm_kernel<T><<<m, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), d, eps);
  return cudaGetLastError();
}

}  // namespace

// x, out: (m, d) contiguous; w: (d,). d % 8 == 0 and 16-byte aligned
// pointers (checked by the Python wrapper).
KERNEL_EXPORT int rmsnorm_launch(const void* x, const void* w, void* out,
                                 int m, int d, float eps, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == port::DT_F32) return launch<float>(x, w, out, m, d, eps, s);
  if (dtype == port::DT_BF16)
    return launch<__nv_bfloat16>(x, w, out, m, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
