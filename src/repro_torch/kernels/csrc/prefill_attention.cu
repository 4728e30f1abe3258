// K4 — prefill over a KV cache (chunked prefill and speculative verify).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_hist_bhsd (body ``_hist_kernel``) with its entries
// src/repro/kernels/ops.py::prefill_attention / verify_attention: the S
// queries of batch row b sit at absolute positions hist_len[b] ..
// hist_len[b] + S - 1 and attend the row's cached history, valid to
// hist_len[b], plus their own KV under plain causality (query i sees
// self keys 0..i), in one online softmax (fp32 m / l / acc). Masked
// scores keep the reference's finite -1e30.
//
// Bound on the H100: chunked prefill (S = 256 over a 768-position
// history, Dh = 64) does ~4 * S flops per history element read — far
// past the card's ~295 bf16 flops per byte only with tensor cores; on
// the CUDA cores in fp32, as here, the limit is fp32 FMA throughput and
// shared-memory bandwidth. Verify (S = gamma + 1 = 5) does ~10 flops per
// history byte and is bound by bytes. Times sit beside both bounds in
// PERF.md; wgmma/TMA tiling, and reading a paged history through the
// block table instead of a gathered copy, are later work.
//
// Design: one block of 128 threads per (q-tile, batch row * q head).
// The q-tile is sized from S, as the Pallas wrapper does (block_q =
// min(128, max(8, S))): 8, 16, 32 or 64 query rows, with 128 / BQ
// threads per row, each holding Dh / (128 / BQ) interleaved dims of the
// row's q and output accumulator in registers, so every block has the
// same 128 threads whatever S is. A score is a partial dot product
// combined across the row's threads by xor shuffles. The block walks
// the history tiles up to the row's hist_len (tiles past it are never
// read), then the self tiles up to the tile's last query (causal skip);
// each tile of K and V is staged in shared memory once (fp32) and
// reused by all the tile's queries. GQA is indexed (kv_head = head / G)
// instead of repeating K/V as the TPU wrapper does. History is read
// from a (B, C, Hkv, Dh) view: the slot's rows of the contiguous cache
// for a chunk, every row for verify, or a block-table gather of the
// paged pool.
//
// Occupancy: a chunk (B = 1, S = 256, 16 heads) is 4 x 16 = 64 blocks;
// verify at B = 8, S = 5, 16 heads is 128 blocks of which each carries 5
// live query rows of 8 — one block of 4 warps per SM on 128 of the 132
// SMs, 1/16 of the SM's warp slots, each block streaming its row's
// history serially. Both are latency-bound; the time is recorded
// against the bound in PERF.md.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

// One KV tile of the online softmax. Thread ``par`` of a row owns dims
// par, par + TPR, ...; the row's TPR threads are neighbouring lanes of
// one warp.
template <int DH, int BK, int TPR>
__device__ __forceinline__ void attend_tile(float (*ks)[DH],
                                            float (*vs)[DH],
                                            const float* qf, float* acc,
                                            float& m, float& l, int k_lo,
                                            int limit, bool self_phase,
                                            int q_row, int par) {
  constexpr int PER = DH / TPR;
  float sc[BK];
  float mt = port::NEG_INF;
#pragma unroll
  for (int j = 0; j < BK; ++j) {
    float p = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) p += qf[i] * ks[j][i * TPR + par];
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1)
      p += __shfl_xor_sync(0xffffffffu, p, o);
    const int kp = k_lo + j;
    const bool ok = self_phase ? kp <= q_row : kp < limit;
    sc[j] = ok ? p : port::NEG_INF;
    mt = fmaxf(mt, sc[j]);
  }
  const float m_new = fmaxf(m, mt);
  const float alpha = expf(m - m_new);
  l *= alpha;
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] *= alpha;
#pragma unroll
  for (int j = 0; j < BK; ++j) {
    const float p = expf(sc[j] - m_new);
    l += p;
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[i] += p * vs[j][i * TPR + par];
  }
  m = m_new;
}

// Stage rows k_lo .. k_lo + BK - 1 of one (batch row, kv head) of a
// (B, n, Hkv, DH) K/V pair into shared memory as fp32; rows >= valid
// are zero.
template <typename T, int DH, int BK>
__device__ __forceinline__ void stage_tile(const T* __restrict__ k,
                                           const T* __restrict__ v,
                                           float (*ks)[DH], float (*vs)[DH],
                                           int b, int n, int hkv, int hk,
                                           int k_lo, int valid) {
  for (int idx = threadIdx.x; idx < BK * DH; idx += kThreads) {
    const int j = idx / DH, dd = idx % DH, kp = k_lo + j;
    float kv = 0.f, vv = 0.f;
    if (kp < valid) {
      const size_t off =
          ((static_cast<size_t>(b) * n + kp) * hkv + hk) * DH + dd;
      kv = port::to_f(k[off]);
      vv = port::to_f(v[off]);
    }
    ks[j][dd] = kv;
    vs[j][dd] = vv;
  }
}

template <typename T, int DH, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    prefill_hist_kernel(const T* __restrict__ q, const T* __restrict__ kh,
                        const T* __restrict__ vh, const T* __restrict__ ksf,
                        const T* __restrict__ vsf,
                        const int* __restrict__ hist_len,
                        T* __restrict__ out, int s, int c, int hq, int hkv,
                        float scale) {
  constexpr int TPR = kThreads / BQ;  // threads per query row
  constexpr int PER = DH / TPR;       // dims per thread
  static_assert(TPR >= 1 && TPR <= 32 && DH % TPR == 0, "tile shape");
  __shared__ float ks[BK][DH];
  __shared__ float vs[BK][DH];

  const int b = blockIdx.y / hq, h = blockIdx.y % hq;
  const int hk = h / (hq / hkv);
  const int par = threadIdx.x % TPR;
  const int q_row = blockIdx.x * BQ + threadIdx.x / TPR;
  const bool row_ok = q_row < s;
  const int hl = min(max(hist_len[b], 0), c);

  float qf[PER], acc[PER];
  const T* qr = q + ((static_cast<size_t>(b) * s + q_row) * hq + h) * DH;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    qf[i] = row_ok ? port::to_f(qr[i * TPR + par]) * scale : 0.f;
    acc[i] = 0.f;
  }
  float m = port::NEG_INF, l = 0.f;

  // history: tiles up to the row's valid length, none past it
  const int nk_hist = (hl + BK - 1) / BK;
  for (int kt = 0; kt < nk_hist; ++kt) {
    __syncthreads();  // previous tile fully consumed
    stage_tile<T, DH, BK>(kh, vh, ks, vs, b, c, hkv, hk, kt * BK, hl);
    __syncthreads();
    attend_tile<DH, BK, TPR>(ks, vs, qf, acc, m, l, kt * BK, hl, false,
                             q_row, par);
  }
  // self: causal, tiles up to this q-tile's last query
  const int q_hi = min(blockIdx.x * BQ + BQ, s) - 1;
  const int nk_self = q_hi / BK + 1;
  for (int kt = 0; kt < nk_self; ++kt) {
    __syncthreads();
    stage_tile<T, DH, BK>(ksf, vsf, ks, vs, b, s, hkv, hk, kt * BK, s);
    __syncthreads();
    attend_tile<DH, BK, TPR>(ks, vs, qf, acc, m, l, kt * BK, s, true, q_row,
                             par);
  }

  if (row_ok) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* orow = out + ((static_cast<size_t>(b) * s + q_row) * hq + h) * DH;
#pragma unroll
    for (int i = 0; i < PER; ++i)
      orow[i * TPR + par] = port::from_f<T>(acc[i] * inv);
  }
}

template <typename T, int DH, int BQ>
cudaError_t launch_bq(const void* q, const void* kh, const void* vh,
                      const void* ks, const void* vs, const int* hist_len,
                      void* out, int b, int s, int c, int hq, int hkv,
                      float scale, cudaStream_t stream) {
  constexpr int BK = DH >= 128 ? 32 : 64;
  dim3 grid((s + BQ - 1) / BQ, b * hq);
  prefill_hist_kernel<T, DH, BQ, BK><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kh),
      static_cast<const T*>(vh), static_cast<const T*>(ks),
      static_cast<const T*>(vs), hist_len, static_cast<T*>(out), s, c, hq,
      hkv, scale);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_dh(const void* q, const void* kh, const void* vh,
                      const void* ks, const void* vs, const int* hist_len,
                      void* out, int b, int s, int c, int hq, int hkv,
                      float scale, cudaStream_t st) {
  if (s <= 8)
    return launch_bq<T, DH, 8>(q, kh, vh, ks, vs, hist_len, out, b, s, c, hq,
                               hkv, scale, st);
  if (s <= 16)
    return launch_bq<T, DH, 16>(q, kh, vh, ks, vs, hist_len, out, b, s, c,
                                hq, hkv, scale, st);
  if (s <= 32)
    return launch_bq<T, DH, 32>(q, kh, vh, ks, vs, hist_len, out, b, s, c,
                                hq, hkv, scale, st);
  return launch_bq<T, DH, 64>(q, kh, vh, ks, vs, hist_len, out, b, s, c, hq,
                              hkv, scale, st);
}

template <typename T>
cudaError_t launch(const void* q, const void* kh, const void* vh,
                   const void* ks, const void* vs, const int* hist_len,
                   void* out, int b, int s, int c, int hq, int hkv, int dh,
                   float scale, cudaStream_t st) {
  switch (dh) {
    case 64:
      return launch_dh<T, 64>(q, kh, vh, ks, vs, hist_len, out, b, s, c, hq,
                              hkv, scale, st);
    case 128:
      return launch_dh<T, 128>(q, kh, vh, ks, vs, hist_len, out, b, s, c,
                               hq, hkv, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out: (b, s, hq, dh); kh, vh: (b, c, hkv, dh) history; ks, vs: (b, s,
// hkv, dh) the queries' own KV; hist_len: (b,) int32 on the device. All
// contiguous, one dtype; hq % hkv == 0, dh in {64, 128}.
KERNEL_EXPORT int prefill_attention_launch(const void* q, const void* kh,
                                           const void* vh, const void* ks,
                                           const void* vs,
                                           const void* hist_len, void* out,
                                           int b, int s, int c, int hq,
                                           int hkv, int dh, float scale,
                                           int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* hl = static_cast<const int*>(hist_len);
  if (hkv < 1 || hq % hkv) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == port::DT_F32)
    return launch<float>(q, kh, vh, ks, vs, hl, out, b, s, c, hq, hkv, dh,
                         scale, st);
  if (dtype == port::DT_BF16)
    return launch<__nv_bfloat16>(q, kh, vh, ks, vs, hl, out, b, s, c, hq,
                                 hkv, dh, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
