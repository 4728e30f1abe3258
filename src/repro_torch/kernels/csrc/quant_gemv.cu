// K6 — W4A16 GEMV/GEMM: x (B, K) times an int4 weight (K, N) stored as
// nibble-packed bytes with per-(group, column) fp32 scales.
//
// Replaces the TPU kernel src/repro/kernels/quant_gemv.py::quant_gemv
// (body ``_kernel``): row 2k of the weight sits in the low nibble of
// packed row k, row 2k+1 in the high nibble, a nibble v >= 8 stands for
// v - 16; each weight is dequantized in registers (int4 -> fp32, times
// its group's scale), multiplied with x in fp32 and summed in fp32; the
// output is cast to x's type once, at the end. The fp16/bf16 weight
// matrix never exists in device memory.
//
// Bound on the H100: bytes. The call must read K * N / 2 packed bytes
// and 4 * (K / group) * N bytes of scales (13.4 MB for a 3072 x 8192
// projection at group 128, 4.0 us at 3.35 TB/s) and does 2 * B flops per
// weight, ~0.53 bytes: at the decode path's B = 1 that is 3.8 flops per
// byte, far below the card's ~20 fp32 flops per byte on the CUDA cores,
// and the launch itself costs about as much as the bound. (At B = 8 it
// is 30 flops per byte, above the CUDA cores' line: there the tensor
// cores are the cure, in a later PR.)
//
// Design (simple first; 16-byte nibble loads, tensor cores and TMA are
// later work): one thread per output column, 128 columns per block, so
// the 32 threads of a warp read 32 consecutive bytes of a packed row
// and the block a 128-byte line. The Pallas kernel walks K in order on
// one core, carrying the sum in VMEM scratch; on Hopper the K axis is
// cut into splits of whole groups, one block per (column tile, split,
// tile of up to 8 x rows), sized so that N = 3072 still gives several
// hundred blocks for 132 SMs. A block stages one group of x (R rows x
// group values, fp32) in shared memory, keeps R fp32 accumulators per
// thread in registers, and writes its split's partial sums in fp32. A
// second pass adds the splits of each output in split order — a fixed
// order without atomics, so the result is deterministic — and casts.
// Columns past N (an N that is not a multiple of 128) are masked, as the
// Pallas wrapper pads them.
#include "common.cuh"

namespace {

constexpr int kCols = 128;      // output columns per block == threads
constexpr int kMaxGroup = 256;  // largest group staged in shared memory

// signed value of a 4-bit two's-complement nibble
__device__ __forceinline__ int nibble(uint32_t v) {
  return static_cast<int>(v ^ 8u) - 8;
}

template <typename T, int R>
__global__ void __launch_bounds__(kCols)
    quant_partial_kernel(const T* __restrict__ x,
                         const uint8_t* __restrict__ wp,
                         const float* __restrict__ scales,
                         float* __restrict__ part, int b, int k, int n,
                         int group, int gps) {
  __shared__ float xs[R * kMaxGroup];
  const int col = blockIdx.x * kCols + threadIdx.x;
  const int split = blockIdx.y;
  const int r0 = blockIdx.z * R;
  const int rows = min(R, b - r0);
  const int g0 = split * gps;
  const int g1 = min(g0 + gps, k / group);
  const int half = group / 2;
  const bool col_ok = col < n;

  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;

  for (int g = g0; g < g1; ++g) {
    __syncthreads();  // the previous group's x has been read
    for (int i = threadIdx.x; i < R * group; i += kCols) {
      const int r = i / group, j = i - r * group;
      xs[i] = r < rows ? port::to_f(x[static_cast<size_t>(r0 + r) * k +
                                      static_cast<size_t>(g) * group + j])
                       : 0.f;
    }
    __syncthreads();
    if (col_ok) {
      const float s = scales[static_cast<size_t>(g) * n + col];
      const uint8_t* wcol = wp + static_cast<size_t>(g) * half * n + col;
#pragma unroll 8
      for (int i = 0; i < half; ++i) {
        const uint32_t byte = wcol[static_cast<size_t>(i) * n];
        const float w0 = static_cast<float>(nibble(byte & 0xFu)) * s;
        const float w1 = static_cast<float>(nibble(byte >> 4)) * s;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          acc[r] += xs[r * group + 2 * i] * w0;
          acc[r] += xs[r * group + 2 * i + 1] * w1;
        }
      }
    }
  }
  if (col_ok) {
    for (int r = 0; r < rows; ++r)
      part[(static_cast<size_t>(split) * b + r0 + r) * n + col] = acc[r];
  }
}

template <typename T>
__global__ void quant_combine_kernel(const float* __restrict__ part,
                                     T* __restrict__ out, int total,
                                     int ns) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float s = 0.f;
  for (int sp = 0; sp < ns; ++sp)
    s += part[static_cast<size_t>(sp) * total + idx];
  out[idx] = port::from_f<T>(s);
}

template <typename T, int R>
cudaError_t launch_rows(const void* x, const void* wp, const void* scales,
                        float* part, void* out, int b, int k, int n,
                        int group, int gps, int ns, cudaStream_t stream) {
  const dim3 grid((n + kCols - 1) / kCols, ns, (b + R - 1) / R);
  quant_partial_kernel<T, R><<<grid, kCols, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(wp),
      static_cast<const float*>(scales), part, b, k, n, group, gps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int total = b * n;
  quant_combine_kernel<T><<<(total + 255) / 256, 256, 0, stream>>>(
      part, static_cast<T*>(out), total, ns);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* wp, const void* scales,
                   float* part, void* out, int b, int k, int n, int group,
                   int gps, int ns, cudaStream_t s) {
  // x rows per block: the smallest of 1, 2, 4, 8 that holds b (8 beyond)
  if (b == 1)
    return launch_rows<T, 1>(x, wp, scales, part, out, b, k, n, group, gps,
                             ns, s);
  if (b == 2)
    return launch_rows<T, 2>(x, wp, scales, part, out, b, k, n, group, gps,
                             ns, s);
  if (b <= 4)
    return launch_rows<T, 4>(x, wp, scales, part, out, b, k, n, group, gps,
                             ns, s);
  return launch_rows<T, 8>(x, wp, scales, part, out, b, k, n, group, gps,
                           ns, s);
}

}  // namespace

// x, out: (b, k) and (b, n) of one dtype; wp: (k / 2, n) uint8; scales:
// (k / group, n) fp32; part: (ns, b, n) fp32 scratch from the caller.
// The k / group groups are cut into ns splits of gps groups (the last
// may be shorter, none empty). group even and <= 256, k % group == 0.
KERNEL_EXPORT int quant_gemv_launch(const void* x, const void* wp,
                                    const void* scales, void* part,
                                    void* out, int b, int k, int n,
                                    int group, int gps, int ns, int dtype,
                                    void* stream) {
  const int ng = group > 0 ? k / group : 0;
  if (b < 1 || n < 1 || group < 2 || group % 2 || group > kMaxGroup ||
      k % group || gps < 1 || ns < 1 || (ns - 1) * gps >= ng ||
      ns * gps < ng)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(part);
  if (dtype == port::DT_F32)
    return launch<float>(x, wp, scales, pt, out, b, k, n, group, gps, ns,
                         s);
  if (dtype == port::DT_BF16)
    return launch<__nv_bfloat16>(x, wp, scales, pt, out, b, k, n, group,
                                 gps, ns, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
