// K5 — fused residual add + RMSNorm for Hopper, one pass over memory.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm (body
// ``_kernel``): h = s * rsqrt(mean(s^2) + eps) * w, with the mean of
// squares, the rsqrt and the scale all in fp32, one output write. Where
// the model adds a residual delta just before the norm, the add is
// fused: s = x + a, rounded to x's type exactly as torch's own ``x + a``
// rounds it (bf16 + bf16 -> bf16; float32 + bf16 -> float32, computed as
// x + float(a)), is written once and normalised from that rounded value.
// Without a delta it is the plain RMSNorm, h of s = x.
//
// Bound on the H100: bytes. Per element it reads x and a and writes s
// and h (w is d elements, shared by every row and served from L2), and
// does ~5 flops, far below the card's ~20 flops per byte for fp32 CUDA
// cores.
//
// Design: one memory round trip. One block per row; each thread owns a
// fixed set of the row's 16-byte vectors of x (vectors t, t + T, ...: V
// of them at most, V = 1 or 2 a compile-time constant: a block of 1024
// threads then covers every row up to d = 8192). All of its loads of x, a
// and w are issued before the first is used; s is formed, rounded,
// written and kept in registers (packed, 16 bytes a vector) with w; one
// block reduction of the sum of squares in fp32 — shuffles across the
// warp, then the warps through shared memory in a fixed order, so the
// result is deterministic and the same with or without the add — and h
// is written from registers. Nothing is read twice. Why CUDA and not
// Triton: a row reduction plus a scale is equally easy in either, and
// CUDA keeps the port to one nvcc build.
//
// K5b, its backward (``add_rmsnorm_bwd_launch``), has no TPU kernel: it
// computes the gradient XLA derives from the reference's plain RMSNorm.
// Given s (= x + a, or x), w, the output's cotangent gh and the cotangent
// gs that reaches s along the residual (none where s is not used on),
// all in fp32 per element:
//   r = rsqrt(mean(s^2) + eps), n = s * r, u = gh * w,
//   g = gs + r * (u - n * mean(u * n))     -> gx in x's type, ga in a's,
//   gw = sum over rows of gh * n           -> w's type.
// A block owns a fixed set of rows (row b, b + G, ...: G blocks) and keeps
// w and its running share of gw in registers; per row one load of s, gh
// and gs, one block reduction of (sum s^2, sum u * s) — mean(u * n) is r
// times the second over d — and one store of gx (and ga). Each block then
// writes its fp32 partial of gw, and a second kernel sums the G partials
// of each column in a fixed order (32 strided partial sums, then a fixed
// tree), so gw is the same from run to run: no float atomics.
#include "common.cuh"

namespace {

template <int B>
struct Raw;  // B bytes as one load or store
template <>
struct Raw<16> {
  using type = uint4;
};
template <>
struct Raw<8> {
  using type = uint2;
};

// N consecutive elements of T (N * sizeof(T)-byte aligned), raw
template <typename T, int N>
__device__ __forceinline__ typename Raw<N * sizeof(T)>::type load_raw(
    const T* p) {
  using R = typename Raw<N * sizeof(T)>::type;
  return __ldg(reinterpret_cast<const R*>(p));
}

template <typename T, int N, typename R>
__device__ __forceinline__ void unpack(const R& raw, float* out) {
  static_assert(sizeof(R) == N * sizeof(T), "raw size");
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = port::to_f(e[i]);
}

// N floats rounded to T (round to nearest even), packed
template <typename T, int N>
__device__ __forceinline__ typename Raw<N * sizeof(T)>::type pack(
    const float* in) {
  typename Raw<N * sizeof(T)>::type raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) e[i] = port::from_f<T>(in[i]);
  return raw;
}

template <typename T, typename R>
__device__ __forceinline__ void store_raw(T* p, const R& raw) {
  *reinterpret_cast<R*>(p) = raw;
}

// x, s, w of type TX; a of type TA (ADD only); h of type TH. One block
// per row of d elements, blockDim.x * V * N >= d.
template <typename TX, typename TA, typename TH, bool ADD, int V>
__global__ void __launch_bounds__(1024)
    add_rmsnorm_kernel(const TX* __restrict__ x, const TA* __restrict__ a,
                       const TX* __restrict__ w, TX* __restrict__ s,
                       TH* __restrict__ h, int d, float eps) {
  constexpr int N = port::Vec<TX>::N;  // elements of a 16-byte vector of x
  using RX = typename Raw<N * sizeof(TX)>::type;
  using RA = typename Raw<N * sizeof(TA)>::type;
  __shared__ float red[32];
  const size_t base = static_cast<size_t>(blockIdx.x) * d;
  const int nvec = d / N;

  RX sr[V], wr[V];
  RA ar[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    if (i < nvec) {
      sr[j] = load_raw<TX, N>(x + base + static_cast<size_t>(i) * N);
      if constexpr (ADD)
        ar[j] = load_raw<TA, N>(a + base + static_cast<size_t>(i) * N);
      wr[j] = load_raw<TX, N>(w + i * N);
    }
  }

  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    if (i < nvec) {
      float f[N];
      unpack<TX, N>(sr[j], f);
      if constexpr (ADD) {
        float fa[N];
        unpack<TA, N>(ar[j], fa);
#pragma unroll
        for (int e = 0; e < N; ++e) f[e] = f[e] + fa[e];
        sr[j] = pack<TX, N>(f);  // s as torch rounds it
        store_raw(s + base + static_cast<size_t>(i) * N, sr[j]);
        unpack<TX, N>(sr[j], f);
      }
#pragma unroll
      for (int e = 0; e < N; ++e) ss += f[e] * f[e];
    }
  }
  ss = port::block_reduce<false>(ss, red);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    if (i < nvec) {
      float f[N], fw[N];
      unpack<TX, N>(sr[j], f);
      unpack<TX, N>(wr[j], fw);
#pragma unroll
      for (int e = 0; e < N; ++e) f[e] = (f[e] * r) * fw[e];
      store_raw(h + base + static_cast<size_t>(i) * N, pack<TH, N>(f));
    }
  }
}

template <typename TX, typename TA, typename TH, bool ADD, int V>
cudaError_t launch_v(const void* x, const void* a, const void* w, void* s,
                     void* h, int m, int d, float eps, int threads,
                     cudaStream_t stream) {
  add_rmsnorm_kernel<TX, TA, TH, ADD, V><<<m, threads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TA*>(a),
      static_cast<const TX*>(w), static_cast<TX*>(s), static_cast<TH*>(h), d,
      eps);
  return cudaGetLastError();
}

template <typename TX, typename TA, typename TH, bool ADD>
cudaError_t launch(const void* x, const void* a, const void* w, void* s,
                   void* h, int m, int d, float eps, int threads, int vecs,
                   cudaStream_t st) {
  switch (vecs) {
    case 1:
      return launch_v<TX, TA, TH, ADD, 1>(x, a, w, s, h, m, d, eps, threads,
                                          st);
    case 2:
      return launch_v<TX, TA, TH, ADD, 2>(x, a, w, s, h, m, d, eps, threads,
                                          st);
  }
  return cudaErrorInvalidValue;
}

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// K5b: the backward
// ---------------------------------------------------------------------------

// s, w, gs, gx of type TX; gh of type TH; ga of type TA (ADD only). Rows
// blockIdx.x, blockIdx.x + gridDim.x, ...; the block's fp32 partial of gw
// goes to part[blockIdx.x * d ...]. blockDim.x * V * N >= d.
template <typename TX, typename TA, typename TH, bool ADD, int V>
__global__ void __launch_bounds__(1024)
    add_rmsnorm_bwd_kernel(const TX* __restrict__ s, const TX* __restrict__ w,
                           const TH* __restrict__ gh,
                           const TX* __restrict__ gs, TX* __restrict__ gx,
                           TA* __restrict__ ga, float* __restrict__ part,
                           int m, int d, float eps) {
  constexpr int N = port::Vec<TX>::N;
  using RX = typename Raw<N * sizeof(TX)>::type;
  using RH = typename Raw<N * sizeof(TH)>::type;
  __shared__ float red[32];
  const int nvec = d / N;
  const bool has_gs = gs != nullptr;

  float wf[V][N], acc[V][N];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
#pragma unroll
    for (int e = 0; e < N; ++e) wf[j][e] = acc[j][e] = 0.f;
    if (i < nvec) unpack<TX, N>(load_raw<TX, N>(w + i * N), wf[j]);
  }

  for (int row = blockIdx.x; row < m; row += gridDim.x) {
    const size_t base = static_cast<size_t>(row) * d;
    RX sr[V], gsr[V];
    RH ghr[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int i = threadIdx.x + j * blockDim.x;
      if (i < nvec) {
        const size_t at = base + static_cast<size_t>(i) * N;
        sr[j] = load_raw<TX, N>(s + at);
        ghr[j] = load_raw<TH, N>(gh + at);
        if (has_gs) gsr[j] = load_raw<TX, N>(gs + at);
      }
    }
    float ss = 0.f, us = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int i = threadIdx.x + j * blockDim.x;
      if (i < nvec) {
        float f[N], g[N];
        unpack<TX, N>(sr[j], f);
        unpack<TH, N>(ghr[j], g);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          ss += f[e] * f[e];
          us += (g[e] * wf[j][e]) * f[e];
        }
      }
    }
    ss = port::block_reduce<false>(ss, red);
    us = port::block_reduce<false>(us, red);
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    const float mun = r * (us / static_cast<float>(d));  // mean(u * n)

#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int i = threadIdx.x + j * blockDim.x;
      if (i < nvec) {
        float f[N], g[N], t[N];
        unpack<TX, N>(sr[j], f);
        unpack<TH, N>(ghr[j], g);
        if (has_gs) {
          unpack<TX, N>(gsr[j], t);
        } else {
#pragma unroll
          for (int e = 0; e < N; ++e) t[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const float n = f[e] * r;
          t[e] += r * (g[e] * wf[j][e] - n * mun);
          acc[j][e] += g[e] * n;
        }
        const size_t at = base + static_cast<size_t>(i) * N;
        store_raw(gx + at, pack<TX, N>(t));
        if constexpr (ADD) store_raw(ga + at, pack<TA, N>(t));
      }
    }
  }

  float* out = part + static_cast<size_t>(blockIdx.x) * d;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    if (i < nvec) {
#pragma unroll
      for (int e = 0; e < N; ++e) out[i * N + e] = acc[j][e];
    }
  }
}

// gw[c] = sum over the G partials of column c, in a fixed order: thread
// (x, y) of a 32 x 32 block sums partials y, y + 32, ... of column
// blockIdx.x * 32 + x, then the 32 sums of a column are added in a fixed
// tree through shared memory.
template <typename TX>
__global__ void __launch_bounds__(1024)
    add_rmsnorm_bwd_gw_kernel(const float* __restrict__ part, int blocks,
                              int d, TX* __restrict__ gw) {
  __shared__ float sums[32][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float t = 0.f;
  if (c < d)
    for (int b = threadIdx.y; b < blocks; b += 32)
      t += part[static_cast<size_t>(b) * d + c];
  sums[threadIdx.y][threadIdx.x] = t;
  __syncthreads();
#pragma unroll
  for (int half = 16; half > 0; half >>= 1) {
    if (threadIdx.y < half)
      sums[threadIdx.y][threadIdx.x] += sums[threadIdx.y + half][threadIdx.x];
    __syncthreads();
  }
  if (threadIdx.y == 0 && c < d) gw[c] = port::from_f<TX>(sums[0][threadIdx.x]);
}

template <typename TX, typename TA, typename TH, bool ADD, int V>
cudaError_t bwd_v(const void* s, const void* w, const void* gh, const void* gs,
                  void* gx, void* ga, void* gw, float* part, int m, int d,
                  float eps, int threads, int blocks, cudaStream_t stream) {
  add_rmsnorm_bwd_kernel<TX, TA, TH, ADD, V><<<blocks, threads, 0, stream>>>(
      static_cast<const TX*>(s), static_cast<const TX*>(w),
      static_cast<const TH*>(gh), static_cast<const TX*>(gs),
      static_cast<TX*>(gx), static_cast<TA*>(ga), part, m, d, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  add_rmsnorm_bwd_gw_kernel<TX><<<(d + 31) / 32, dim3(32, 32), 0, stream>>>(
      part, blocks, d, static_cast<TX*>(gw));
  return cudaGetLastError();
}

template <typename TX, typename TA, typename TH, bool ADD>
cudaError_t bwd(const void* s, const void* w, const void* gh, const void* gs,
                void* gx, void* ga, void* gw, float* part, int m, int d,
                float eps, int threads, int vecs, int blocks,
                cudaStream_t st) {
  switch (vecs) {
    case 1:
      return bwd_v<TX, TA, TH, ADD, 1>(s, w, gh, gs, gx, ga, gw, part, m, d,
                                       eps, threads, blocks, st);
    case 2:
      return bwd_v<TX, TA, TH, ADD, 2>(s, w, gh, gs, gx, ga, gw, part, m, d,
                                       eps, threads, blocks, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x, s: (m, d) of dtype ``xt``; a: (m, d) of dtype ``at``, or ``at`` = -1
// and a, s null for the plain RMSNorm; w: (d,) of dtype ``xt``; h: (m, d)
// of dtype ``ht``. The launch (rmsnorm.py::launch_plan): ``threads`` per
// block (a multiple of 32, at most 1024) and ``vecs`` in {1, 2} vectors
// per thread, threads * vecs * (16 / sizeof(x)) >= d. d % 8 == 0; pointers
// aligned to their vectors (checked by the Python wrapper). The dtype
// combinations are the ones the model paths use: bf16 x with bf16 a and
// h; float32 x with float32 or bf16 a and float32 or bf16 h.
KERNEL_EXPORT int add_rmsnorm_launch(const void* x, const void* a,
                                     const void* w, void* s, void* h, int m,
                                     int d, float eps, int xt, int at, int ht,
                                     int threads, int vecs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int F = port::DT_F32, B = port::DT_BF16;
  if (m < 1 || d < 8 || d % 8 || threads < 32 || threads % 32 ||
      threads > 1024 ||
      static_cast<long>(threads) * vecs * (xt == F ? 4 : 8) < d)
    return static_cast<int>(cudaErrorInvalidValue);
  if (xt == B && ht == B) {
    if (at < 0)
      return launch<bf16, bf16, bf16, false>(x, a, w, s, h, m, d, eps,
                                             threads, vecs, st);
    if (at == B)
      return launch<bf16, bf16, bf16, true>(x, a, w, s, h, m, d, eps,
                                            threads, vecs, st);
  }
  if (xt == F && ht == F) {
    if (at < 0)
      return launch<float, float, float, false>(x, a, w, s, h, m, d, eps,
                                                threads, vecs, st);
    if (at == F)
      return launch<float, float, float, true>(x, a, w, s, h, m, d, eps,
                                               threads, vecs, st);
    if (at == B)
      return launch<float, bf16, float, true>(x, a, w, s, h, m, d, eps,
                                              threads, vecs, st);
  }
  if (xt == F && ht == B) {
    if (at < 0)
      return launch<float, float, bf16, false>(x, a, w, s, h, m, d, eps,
                                               threads, vecs, st);
    if (at == F)
      return launch<float, float, bf16, true>(x, a, w, s, h, m, d, eps,
                                              threads, vecs, st);
    if (at == B)
      return launch<float, bf16, bf16, true>(x, a, w, s, h, m, d, eps,
                                             threads, vecs, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K5b. s, gx: (m, d) of dtype ``xt``; w, gw: (d,) of ``xt``; gh: (m, d)
// of ``ht``; gs: (m, d) of ``xt``, or null where no cotangent reaches s
// along the residual; ga: (m, d) of ``at``, or ``at`` = -1 and ga null
// when the forward had no add. ``part``: ``blocks`` x d floats of scratch
// for the per-block partials of gw. ``threads`` and ``vecs`` as for the
// forward (rmsnorm.py::launch_plan), ``blocks`` from
// rmsnorm.py::bwd_launch_plan. The dtype combinations are the forward's.
KERNEL_EXPORT int add_rmsnorm_bwd_launch(const void* s, const void* w,
                                         const void* gh, const void* gs,
                                         void* gx, void* ga, void* gw,
                                         void* part, int m, int d, float eps,
                                         int xt, int at, int ht, int threads,
                                         int vecs, int blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  constexpr int F = port::DT_F32, B = port::DT_BF16;
  if (m < 1 || d < 8 || d % 8 || threads < 32 || threads % 32 ||
      threads > 1024 || blocks < 1 || blocks > m ||
      static_cast<long>(threads) * vecs * (xt == F ? 4 : 8) < d)
    return static_cast<int>(cudaErrorInvalidValue);
  if (xt == B && ht == B) {
    if (at < 0)
      return bwd<bf16, bf16, bf16, false>(s, w, gh, gs, gx, ga, gw, p, m, d,
                                          eps, threads, vecs, blocks, st);
    if (at == B)
      return bwd<bf16, bf16, bf16, true>(s, w, gh, gs, gx, ga, gw, p, m, d,
                                         eps, threads, vecs, blocks, st);
  }
  if (xt == F && ht == F) {
    if (at < 0)
      return bwd<float, float, float, false>(s, w, gh, gs, gx, ga, gw, p, m,
                                             d, eps, threads, vecs, blocks,
                                             st);
    if (at == F)
      return bwd<float, float, float, true>(s, w, gh, gs, gx, ga, gw, p, m,
                                            d, eps, threads, vecs, blocks, st);
    if (at == B)
      return bwd<float, bf16, float, true>(s, w, gh, gs, gx, ga, gw, p, m, d,
                                           eps, threads, vecs, blocks, st);
  }
  if (xt == F && ht == B) {
    if (at < 0)
      return bwd<float, float, bf16, false>(s, w, gh, gs, gx, ga, gw, p, m,
                                            d, eps, threads, vecs, blocks, st);
    if (at == F)
      return bwd<float, float, bf16, true>(s, w, gh, gs, gx, ga, gw, p, m, d,
                                           eps, threads, vecs, blocks, st);
    if (at == B)
      return bwd<float, bf16, bf16, true>(s, w, gh, gs, gx, ga, gw, p, m, d,
                                          eps, threads, vecs, blocks, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
