// K3 — causal / sliding-window flash attention (prefill) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_bhsd (body ``_kernel``): softmax(q k^T / sqrt(Dh)) v
// with masks at absolute positions (query i sits at q_offset + i, key j
// at j), a key-pad mask (j < Skv), optional causality and an optional
// window (j > pos - window), online softmax state m / l / acc in fp32,
// and KV tiles that no query of the block can see skipped entirely.
//
// Bound on the H100: at the main path's shapes (causal, S = 512..1024,
// Dh = 64, bf16) the work is ~S/4 flops per byte of q, k, v and out —
// 128..256, just under the card's ~295 bf16 tensor-core flops per byte —
// so the roofline bound is bytes, and it is only reachable with the
// products on the tensor cores. This first version computes them on the
// CUDA cores in fp32 (wgmma/TMA tiling is later work), so what limits
// it is fp32 FMA throughput and shared-memory bandwidth; its time is
// recorded beside the bound in PERF.md.
//
// Design: one block per (batch*head, 64-query tile), 128 threads, two
// threads per query row; each thread keeps half of the row's q and of
// its output accumulator in registers (dimensions interleaved, so the
// pair reads neighbouring shared-memory words and never conflicts). The
// block walks its visible KV tiles in order: a tile of K and V (fp32)
// is staged in shared memory once and reused by all 64 queries; a
// tile's scores stay in registers, the pair combines its halves with
// one shuffle. GQA is indexed (kv_head = head / G) instead of expanding
// K/V as the TPU wrapper does: the same function with fewer bytes.
// Layouts are the model's own: q, out (B, Sq, Hq, Dh); k, v (B, Skv,
// Hkv, Dh) — no transposes around the call.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;        // queries per block
constexpr int kThreads = 128;  // two threads per query

template <typename T, int DH, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int sq,
                     int skv, int hq, int hkv, int causal, int window,
                     int q_offset, float scale) {
  constexpr int HALF = DH / 2;
  __shared__ float ks[BK][DH];
  __shared__ float vs[BK][DH];

  const int b = blockIdx.y / hq, h = blockIdx.y % hq;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x, par = tid & 1;
  const int q_row = blockIdx.x * kBQ + (tid >> 1);
  const bool row_ok = q_row < sq;
  const int qp = q_offset + q_row;  // absolute query position

  float qf[HALF], acc[HALF];
  const T* qr = q + ((static_cast<size_t>(b) * sq + q_row) * hq + h) * DH;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    qf[i] = row_ok ? port::to_f(qr[2 * i + par]) * scale : 0.f;
    acc[i] = 0.f;
  }
  float m = port::NEG_INF, l = 0.f;

  // visible KV tile range of this query block (uniform over the block)
  const int q_lo = q_offset + blockIdx.x * kBQ;
  const int q_hi = q_offset + min(blockIdx.x * kBQ + kBQ, sq) - 1;
  int kt_end = (skv + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, q_hi / BK + 1);

  for (int kt = 0; kt < kt_end; ++kt) {
    const int k_lo = kt * BK;
    if (window > 0 && k_lo + BK - 1 <= q_lo - window) continue;
    __syncthreads();  // previous tile fully consumed
    for (int idx = tid; idx < BK * DH; idx += kThreads) {
      const int j = idx / DH, dd = idx % DH, kp = k_lo + j;
      float kv = 0.f, vv = 0.f;
      if (kp < skv) {
        const size_t off =
            ((static_cast<size_t>(b) * skv + kp) * hkv + hk) * DH + dd;
        kv = port::to_f(k[off]);
        vv = port::to_f(v[off]);
      }
      ks[j][dd] = kv;
      vs[j][dd] = vv;
    }
    __syncthreads();

    float s[BK];
    float mt = port::NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float p = 0.f;
#pragma unroll
      for (int i = 0; i < HALF; ++i) p += qf[i] * ks[j][2 * i + par];
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      const int kp = k_lo + j;
      bool ok = kp < skv;
      if (causal) ok = ok && kp <= qp;
      if (window > 0) ok = ok && kp > qp - window;
      s[j] = ok ? p : port::NEG_INF;
      mt = fmaxf(mt, s[j]);
    }
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < HALF; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - m_new);
      l += p;
#pragma unroll
      for (int i = 0; i < HALF; ++i) acc[i] += p * vs[j][2 * i + par];
    }
    m = m_new;
  }

  if (row_ok) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* orow = out + ((static_cast<size_t>(b) * sq + q_row) * hq + h) * DH;
#pragma unroll
    for (int i = 0; i < HALF; ++i)
      orow[2 * i + par] = port::from_f<T>(acc[i] * inv);
  }
}

template <typename T, int DH>
cudaError_t launch_dh(const void* q, const void* k, const void* v, void* out,
                      int b, int sq, int skv, int hq, int hkv, int causal,
                      int window, int q_offset, float scale,
                      cudaStream_t stream) {
  // K and V tiles of BK x DH fp32 in static shared memory (48 KiB at
  // most): 64 keys at DH 64, 32 from DH 96 on (64 x 96 would fill the
  // 48 KiB exactly)
  constexpr int BK = DH > 64 ? 32 : 64;
  dim3 grid((sq + kBQ - 1) / kBQ, b * hq);
  flash_fwd_kernel<T, DH, BK><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, skv, hq, hkv,
      causal, window, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int b, int sq, int skv, int hq, int hkv, int dh,
                   int causal, int window, int q_offset, float scale,
                   cudaStream_t s) {
  switch (dh) {
    case 64:
      return launch_dh<T, 64>(q, k, v, out, b, sq, skv, hq, hkv, causal,
                              window, q_offset, scale, s);
    case 96:
      return launch_dh<T, 96>(q, k, v, out, b, sq, skv, hq, hkv, causal,
                              window, q_offset, scale, s);
    case 128:
      return launch_dh<T, 128>(q, k, v, out, b, sq, skv, hq, hkv, causal,
                               window, q_offset, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out: (b, sq, hq, dh); k, v: (b, skv, hkv, dh); all contiguous, one
// dtype. window <= 0 means no window. dh in {64, 96, 128}.
KERNEL_EXPORT int flash_attention_launch(const void* q, const void* k,
                                         const void* v, void* out, int b,
                                         int sq, int skv, int hq, int hkv,
                                         int dh, int causal, int window,
                                         int q_offset, float scale,
                                         int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == port::DT_F32)
    return launch<float>(q, k, v, out, b, sq, skv, hq, hkv, dh, causal,
                         window, q_offset, scale, s);
  if (dtype == port::DT_BF16)
    return launch<__nv_bfloat16>(q, k, v, out, b, sq, skv, hq, hkv, dh,
                                 causal, window, q_offset, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
