// K1 — split-KV GQA flash decode over a contiguous, ragged KV cache, and
// K2 — the same decode over a paged KV cache (shared block pool read
// through per-row block tables).
//
// Replaces the TPU kernels src/repro/kernels/decode_attention.py::
// decode_attention_bhgd (K1, body ``_kernel``) and
// decode_attention_paged_bhgd (K2, body ``_paged_kernel``): one query
// token per batch row attends its row's first cache_len[b] logical cache
// positions; all G query heads of a KV head share each K/V read; softmax
// state in fp32. It also carries what the model-side decode attention
// adds on top of the Pallas kernels (src/repro/models/attention.py:
// 314-328): the current token's own K/V (extra_k / extra_v) merged as one
// always-valid "self" partial. Choice: the self slot is merged in the
// combine pass, not by writing the token's KV into the cache first and
// attending len + 1 — the cache write then stays outside attention, as in
// the reference, and the masks match the reference slot for slot.
//
// Bound on the H100: bytes. Decode reads every valid K and V element
// once per token (~2 * sum(len) * Hkv * Dh * bytes per layer; K2 also
// reads 4 bytes per table entry) and does 2 flops per element per query
// head — G flops per byte in bf16 (G = 1 for MHA), far below the card's
// ~295 bf16 flops per byte.
//
// Design: pass 1 runs one block per (KV split of 128 positions, kv head,
// batch row) — thousands of blocks, enough to keep all 132 SMs
// streaming. Each block reads its row's length itself; a split that
// starts past it returns at once, so tiles past the length are never
// read. Thread t owns position t of the split: it finds that position's
// row once (the ``Rows`` template parameter: contiguous, or one block-
// table lookup per position for K2), keeps it in shared memory for the
// V pass, loads the K row with 16-byte vectors and scores it against the
// G queries staged in shared memory. The block takes the split's max and
// exp-sum per query head, then accumulates P V with threads laid along
// Dh (coalesced V reads) and writes the unnormalised partial (o, m, l)
// in fp32. Pass 2 runs one block per (batch row, query head): it
// computes the self score, then merges the valid splits' partials and
// the self partial in split order — a fixed order without atomics, so
// the output is deterministic — and writes the normalised result.
//
// K2 does not copy the Pallas kernel's tile of one cache block (bs = 16
// positions per grid step, steered by scalar prefetch): a Hopper block
// still covers 128 logical positions, i.e. 128 / bs pool blocks, and
// every block loads its own table entries. Only the address of a
// position differs from K1; the arithmetic and its order are the same
// code, so K2 on a pool holding the same logical rows as a K1 cache is
// bitwise equal to K1. Sentinel table entries (>= NB) are clamped to
// NB - 1 and only ever sit past the row's length, where nothing is read.
#include "common.cuh"

namespace {

constexpr int kSplit = 128;  // cache positions per pass-1 block == threads
constexpr int kMaxG = 8;     // query heads per KV head

// Where logical position p of batch row b lives: the row index into a
// (rows, Hkv, Dh) K or V array.
struct ContiguousRows {  // K1: cache (B, cap, Hkv, Dh)
  int cap;
  __device__ __forceinline__ size_t operator()(int b, int p) const {
    return static_cast<size_t>(b) * cap + p;
  }
};

struct PagedRows {  // K2: pool (NB, bs, Hkv, Dh), tables (B, W)
  const int* tab;
  int w, bs, nb;
  __device__ __forceinline__ size_t operator()(int b, int p) const {
    int blk = tab[static_cast<size_t>(b) * w + p / bs];
    blk = min(max(blk, 0), nb - 1);  // sentinel -> a real block
    return static_cast<size_t>(blk) * bs + p % bs;
  }
};

template <typename T, int DH, typename Rows>
__global__ void __launch_bounds__(kSplit)
    decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                          const T* __restrict__ vc,
                          const int* __restrict__ lens, Rows rows,
                          float* __restrict__ o_part,
                          float* __restrict__ m_part,
                          float* __restrict__ l_part, int cap, int hkv,
                          int g, int ns, float scale) {
  constexpr int N = port::Vec<T>::N;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int len = min(lens[b], cap);
  const int start = split * kSplit;
  if (start >= len) return;  // pass 2 never reads this split

  extern __shared__ float smem[];
  float* qs = smem;                  // [g][DH]
  float* ps = qs + g * DH;           // [g][kSplit] scores, then probs
  float* part = ps + g * kSplit;     // [kSplit / DH][g][DH] PV partials
  __shared__ float red[32];
  __shared__ size_t row_of[kSplit];  // KV row of each split position

  const int tid = threadIdx.x;
  const T* qb = q + (static_cast<size_t>(b) * hkv + h) * g * DH;
  for (int i = tid; i < g * DH; i += kSplit)
    qs[i] = port::to_f(qb[i]) * scale;
  __syncthreads();

  const int j = start + tid;
  const bool valid = j < len;
  if (valid) row_of[tid] = rows(b, j);
  {
    float kf[DH];
    if (valid) {
      const T* kr = kc + (row_of[tid] * hkv + h) * DH;
#pragma unroll
      for (int i = 0; i < DH; i += N) port::load_vec(kr + i, kf + i);
    }
    for (int gi = 0; gi < g; ++gi) {
      float sc = port::NEG_INF;
      if (valid) {
        sc = 0.f;
#pragma unroll
        for (int i = 0; i < DH; ++i) sc += qs[gi * DH + i] * kf[i];
      }
      ps[gi * kSplit + tid] = sc;
    }
  }

  const size_t row = (static_cast<size_t>(b) * hkv + h) * g;
  for (int gi = 0; gi < g; ++gi) {
    const float sc = ps[gi * kSplit + tid];
    const float mx = port::block_reduce<true>(sc, red);
    const float p = valid ? expf(sc - mx) : 0.f;
    ps[gi * kSplit + tid] = p;
    const float sum = port::block_reduce<false>(p, red);
    if (tid == 0) {
      m_part[(row + gi) * ns + split] = mx;
      l_part[(row + gi) * ns + split] = sum;
    }
  }
  __syncthreads();  // all probabilities and rows visible

  // P V: thread -> (dim d, slot group grp); groups stride over the split.
  // When DH does not divide kSplit (DH = 96) the threads past
  // ngrp * DH have no group and do no PV work.
  const int d = tid % DH, grp = tid / DH, ngrp = kSplit / DH;
  if (grp < ngrp) {
    float acc[kMaxG];
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) acc[gi] = 0.f;
    const int n_here = min(kSplit, len - start);
    for (int jj = grp; jj < n_here; jj += ngrp) {
      const float vv = port::to_f(vc[(row_of[jj] * hkv + h) * DH + d]);
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi)
        if (gi < g) acc[gi] += ps[gi * kSplit + jj] * vv;
    }
    for (int gi = 0; gi < g; ++gi) part[(grp * g + gi) * DH + d] = acc[gi];
  }
  __syncthreads();
  if (grp == 0) {
    for (int gi = 0; gi < g; ++gi) {
      float o = 0.f;
      for (int r = 0; r < ngrp; ++r) o += part[(r * g + gi) * DH + d];
      o_part[((row + gi) * ns + split) * DH + d] = o;
    }
  }
}

template <typename T, int DH>
__global__ void decode_combine_kernel(
    const T* __restrict__ q, const T* __restrict__ ek,
    const T* __restrict__ ev, const int* __restrict__ lens,
    const float* __restrict__ o_part, const float* __restrict__ m_part,
    const float* __restrict__ l_part, T* __restrict__ out, int cap, int hkv,
    int g, int ns, float scale, int has_self) {
  __shared__ float red[32];
  const int hq_idx = blockIdx.x, b = blockIdx.y;
  const int h = hq_idx / g;
  const int d = threadIdx.x;
  const bool dim_ok = d < DH;
  const int len = min(lens[b], cap);
  const int nv = (len + kSplit - 1) / kSplit;
  const size_t row = static_cast<size_t>(b) * hkv * g + hq_idx;

  float s_self = port::NEG_INF;
  if (has_self) {
    float t = 0.f;
    if (dim_ok)
      t = port::to_f(q[row * DH + d]) * scale *
          port::to_f(ek[(static_cast<size_t>(b) * hkv + h) * DH + d]);
    s_self = port::block_reduce<false>(t, red);
  }
  float mx = s_self;
  for (int s = 0; s < nv; ++s) mx = fmaxf(mx, m_part[row * ns + s]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < nv; ++s) {
    const float a = expf(m_part[row * ns + s] - mx);
    den += l_part[row * ns + s] * a;
    if (dim_ok) num += o_part[(row * ns + s) * DH + d] * a;
  }
  if (has_self) {
    const float a = expf(s_self - mx);
    den += a;
    if (dim_ok)
      num += port::to_f(ev[(static_cast<size_t>(b) * hkv + h) * DH + d]) * a;
  }
  if (dim_ok) out[row * DH + d] = port::from_f<T>(num / fmaxf(den, 1e-30f));
}

template <typename T, int DH, typename Rows>
cudaError_t launch_dh(const void* q, const void* kc, const void* vc,
                      const void* ek, const void* ev, const int* lens,
                      Rows rows, float* o_part, float* m_part,
                      float* l_part, void* out, int b, int cap, int hkv,
                      int g, int ns, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * g * (DH + kSplit + kSplit);
  decode_partial_kernel<T, DH, Rows>
      <<<dim3(ns, hkv, b), kSplit, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(kc),
          static_cast<const T*>(vc), lens, rows, o_part, m_part, l_part,
          cap, hkv, g, ns, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int threads = DH < 32 ? 32 : DH;
  decode_combine_kernel<T, DH><<<dim3(hkv * g, b), threads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(ek),
      static_cast<const T*>(ev), lens, o_part, m_part, l_part,
      static_cast<T*>(out), cap, hkv, g, ns, scale, ek != nullptr);
  return cudaGetLastError();
}

template <typename T, typename Rows>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const void* ek, const void* ev, const int* lens,
                   Rows rows, float* o_part, float* m_part, float* l_part,
                   void* out, int b, int cap, int hkv, int g, int dh, int ns,
                   float scale, cudaStream_t s) {
  switch (dh) {
    case 64:
      return launch_dh<T, 64>(q, kc, vc, ek, ev, lens, rows, o_part, m_part,
                              l_part, out, b, cap, hkv, g, ns, scale, s);
    case 96:
      return launch_dh<T, 96>(q, kc, vc, ek, ev, lens, rows, o_part, m_part,
                              l_part, out, b, cap, hkv, g, ns, scale, s);
    case 128:
      return launch_dh<T, 128>(q, kc, vc, ek, ev, lens, rows, o_part,
                               m_part, l_part, out, b, cap, hkv, g, ns,
                               scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename Rows>
int launch_dtype(const void* q, const void* kc, const void* vc,
                 const void* ek, const void* ev, const void* lens, Rows rows,
                 void* o_part, void* m_part, void* l_part, void* out, int b,
                 int cap, int hkv, int g, int dh, int ns, float scale,
                 int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ln = static_cast<const int*>(lens);
  float* op = static_cast<float*>(o_part);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  if (g < 1 || g > kMaxG) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == port::DT_F32)
    return launch<float>(q, kc, vc, ek, ev, ln, rows, op, mp, lp, out, b,
                         cap, hkv, g, dh, ns, scale, s);
  if (dtype == port::DT_BF16)
    return launch<__nv_bfloat16>(q, kc, vc, ek, ev, ln, rows, op, mp, lp,
                                 out, b, cap, hkv, g, dh, ns, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, out: (b, hkv * g, dh); kc, vc: (b, cap, hkv, dh); ek, ev: (b, hkv,
// dh) or both null (no self partial); lens: (b,) int32 on the device.
// o_part (b, hkv, g, ns, dh), m_part / l_part (b, hkv, g, ns): fp32
// scratch from the caller, ns = ceil(cap / 128). g <= 8, dh in
// {64, 96, 128}; pointers 16-byte aligned.
KERNEL_EXPORT int decode_attention_launch(
    const void* q, const void* kc, const void* vc, const void* ek,
    const void* ev, const void* lens, void* o_part, void* m_part,
    void* l_part, void* out, int b, int cap, int hkv, int g, int dh, int ns,
    float scale, int dtype, void* stream) {
  return launch_dtype(q, kc, vc, ek, ev, lens, ContiguousRows{cap}, o_part,
                      m_part, l_part, out, b, cap, hkv, g, dh, ns, scale,
                      dtype, stream);
}

// K2. kp, vp: pools (nb, bs, hkv, dh); tab: (b, w) int32 block ids on
// the device (ids >= nb are sentinels, clamped to nb - 1 and masked by
// the length). The logical capacity is w * bs; ns = ceil(w * bs / 128).
// Everything else as decode_attention_launch.
KERNEL_EXPORT int paged_decode_attention_launch(
    const void* q, const void* kp, const void* vp, const void* ek,
    const void* ev, const void* lens, const void* tab, void* o_part,
    void* m_part, void* l_part, void* out, int b, int w, int bs, int nb,
    int hkv, int g, int dh, int ns, float scale, int dtype, void* stream) {
  if (w < 1 || bs < 1 || nb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const PagedRows rows{static_cast<const int*>(tab), w, bs, nb};
  return launch_dtype(q, kp, vp, ek, ev, lens, rows, o_part, m_part, l_part,
                      out, b, w * bs, hkv, g, dh, ns, scale, dtype, stream);
}
