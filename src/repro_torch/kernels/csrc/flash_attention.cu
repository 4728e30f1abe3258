// K3 — causal / sliding-window flash attention (prefill) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_bhsd (body ``_kernel``): softmax(q k^T / sqrt(Dh)) v
// with masks at absolute positions (query i sits at q_offset + i, key j
// at j), a key-pad mask (j < Skv), optional causality and an optional
// window (j > pos - window), online softmax state m / l / acc in fp32,
// and KV tiles that no query of the block can see skipped entirely.
// GQA is indexed (kv_head = head / G) instead of expanding K/V as the
// TPU wrapper does: the same function with fewer bytes. Layouts are the
// model's own: q, out (B, Sq, Hq, Dh); k, v (B, Skv, Hkv, Dh).
//
// Non-causal calls (whisper's encoder, Sq == Skv == 1500, and its
// decoder's cross-attention, Sq = the prompt bucket against Skv = 1500)
// walk every KV tile; the last tile is zero-filled past Skv and masked by
// the key-pad mask, which runs on every tile that reaches past Skv.
//
// Bound on the H100: at the main path's shapes (causal, S = 512..1024,
// Dh = 64, bf16) the work is ~S/4 flops per byte of q, k, v and out —
// 128..256, under the card's ~295 bf16 tensor-core flops per byte — so
// the roofline bound is bytes (1.25 us at S = 512), reachable only with
// the products on the tensor cores and the loads overlapped with them.
//
// bf16 design (flash_tile.cuh): one block of 4 warps per (batch * head,
// 64-query tile), one warp per 16 query rows. S = Q K^T and O += P V
// run as mma.sync m16n8k16 on the tensor cores, operands from shared
// memory through ldmatrix; P stays in registers between the two. K/V
// tiles of 64 keys are staged by 16-byte cp.async into a ring of two
// stages, so tile t + 1 loads while tile t is multiplied. Q tiles are
// launched heaviest first (the last causal tiles, which walk the most
// KV tiles, get the first SMs), and masks are evaluated only on tiles
// that some query of the block sees partially. What limits it now is
// the serial chain of one block over its KV tiles: at S = 512..1024 the
// grid holds one or two blocks (4..8 warps) per SM, too few to hide the
// latency of each tile's products and softmax; a deeper ring does not
// help, since the loads already land in time (PERF.md).
//
// float32 keeps the CUDA-core body of the first port (flash_fwd_kernel:
// two threads per query row, fp32 K/V tiles in static shared memory,
// scalar loads), chosen by dtype in the launch function: it carries the
// float32 greedy-stream gates, where the tensor cores' bf16 operands
// would not do.
#include <type_traits>

#include "flash_tile.cuh"

namespace {

constexpr int kBQ = 64;        // queries per block
constexpr int kThreads = 128;  // f32: two threads per query; bf16: 4 warps

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

// bf16: tensor-core tiles (see the note at the top).
constexpr int kBK = 64;     // keys per staged tile
constexpr int kStages = 2;  // depth of the K/V cp.async ring

template <int DH>
constexpr size_t bf16_smem_bytes() {
  // Q tile + the ring of (K tile, V tile) stages
  return sizeof(tile::bf16) * tile::Dims<DH>::LD * (kBQ + kStages * 2 * kBK);
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
    flash_bf16_kernel(const tile::bf16* __restrict__ q,
                      const tile::bf16* __restrict__ k,
                      const tile::bf16* __restrict__ v,
                      tile::bf16* __restrict__ out, int sq, int skv, int hq,
                      int hkv, int causal, int window, int q_offset,
                      float scale_log2) {
  using tile::bf16;
  constexpr int LD = tile::Dims<DH>::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* kv = qs + kBQ * LD;  // stage i: K at kv + 2 i BK LD, V after it

  const int b = blockIdx.x / hq, h = blockIdx.x % hq;
  const int hk = h / (hq / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest first
  const int warp = threadIdx.x >> 5;
  const int q_lo = q_offset + q0;
  const int q_hi = q_offset + min(q0 + kBQ, sq) - 1;

  // visible KV tile range of this query block (uniform over the block)
  int kt_end = (skv + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, q_hi / kBK + 1);
  int kt_begin = 0;
  if (window > 0 && q_lo - window + 1 > 0)
    kt_begin = (q_lo - window + 1) / kBK;
  const int n_tiles = max(kt_end - kt_begin, 0);

  auto q_row = [&](int r) -> const bf16* {
    const int row = q0 + r;
    return row < sq ? q + ((static_cast<size_t>(b) * sq + row) * hq + h) * DH
                    : nullptr;
  };
  tile::stage_rows<DH>(qs, kBQ, q_row, q);
  // key row kp of this (batch row, kv head), nullptr past the keys
  auto key_row = [&](const bf16* base, int kp) -> const bf16* {
    return kp < skv
               ? base + ((static_cast<size_t>(b) * skv + kp) * hkv + hk) * DH
               : nullptr;
  };
  auto stage_kv = [&](int kt, int stage) {
    const int k_lo = kt * kBK;
    bf16* dst = kv + 2 * stage * kBK * LD;
    tile::stage_rows<DH>(
        dst, kBK, [&](int r) { return key_row(k, k_lo + r); }, k);
    tile::stage_rows<DH>(
        dst + kBK * LD, kBK, [&](int r) { return key_row(v, k_lo + r); }, v);
  };
  // prologue: tiles 0 .. kStages - 2, one commit group each (Q rides in
  // the first)
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) stage_kv(kt_begin + t, t);
    tile::cp_async_commit();
  }

  tile::Rows16<DH> rows;
  rows.init();
  for (int t = 0; t < n_tiles; ++t) {
    const int ahead = t + kStages - 1;
    if (ahead < n_tiles) stage_kv(kt_begin + ahead, ahead % kStages);
    tile::cp_async_commit();             // maybe empty: keeps the count
    tile::cp_async_wait<kStages - 1>();  // tile t has landed
    __syncthreads();
    if (t == 0) rows.load_q(qs + warp * 16 * LD);
    const int k_lo = (kt_begin + t) * kBK;
    const bool masked = k_lo + kBK > skv ||
                        (causal && k_lo + kBK - 1 > q_lo) ||
                        (window > 0 && k_lo <= q_hi - window);
    const bf16* ks = kv + 2 * (t % kStages) * kBK * LD;
    const int qp0 = q_lo + warp * 16;
    auto visible = [&](int r, int j) {
      const int qp = qp0 + r, kp = k_lo + j;
      bool ok = kp < skv;
      if (causal) ok = ok && kp <= qp;
      if (window > 0) ok = ok && kp > qp - window;
      return ok;
    };
    rows.template attend<kBK>(ks, ks + kBK * LD, scale_log2, masked,
                              visible);
    __syncthreads();  // the stage is free for tile t + kStages
  }
  tile::cp_async_wait<0>();  // nothing left in flight (n_tiles == 0)

  rows.finish();
  rows.store([&](int r) -> bf16* {
    const int row = q0 + warp * 16 + r;
    return row < sq
               ? out + ((static_cast<size_t>(b) * sq + row) * hq + h) * DH
               : nullptr;
  });
}

template <typename T, int DH>
cudaError_t launch_dh(const void* q, const void* k, const void* v, void* out,
                      int b, int sq, int skv, int hq, int hkv, int causal,
                      int window, int q_offset, float scale,
                      cudaStream_t stream) {
  const int n_qt = (sq + kBQ - 1) / kBQ;
  if constexpr (std::is_same<T, float>::value) {
    // the CUDA-core body: K and V tiles of BK x DH fp32 in static shared
    // memory (48 KiB at most): 64 keys at DH 64, 32 from DH 80 on, 16 at
    // DH 192 (32 would fill the 48 KiB exactly)
    constexpr int BK = DH > 128 ? 16 : DH > 64 ? 32 : 64;
    flash_fwd_kernel<float, DH, BK>
        <<<dim3(n_qt, b * hq), kThreads, 0, stream>>>(
            static_cast<const float*>(q), static_cast<const float*>(k),
            static_cast<const float*>(v), static_cast<float*>(out), sq, skv,
            hq, hkv, causal, window, q_offset, scale);
  } else {
    constexpr size_t smem = bf16_smem_bytes<DH>();
    const cudaError_t attr =
        tile::allow_smem_once<flash_bf16_kernel<DH>>(smem);
    if (attr != cudaSuccess) return attr;
    flash_bf16_kernel<DH><<<dim3(b * hq, n_qt), kThreads, smem, stream>>>(
        static_cast<const tile::bf16*>(q), static_cast<const tile::bf16*>(k),
        static_cast<const tile::bf16*>(v), static_cast<tile::bf16*>(out), sq,
        skv, hq, hkv, causal, window, q_offset, scale * 1.4426950408889634f);
  }
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
    case 80:
      return launch_dh<T, 80>(q, k, v, out, b, sq, skv, hq, hkv, causal,
                              window, q_offset, scale, s);
    case 96:
      return launch_dh<T, 96>(q, k, v, out, b, sq, skv, hq, hkv, causal,
                              window, q_offset, scale, s);
    case 128:
      return launch_dh<T, 128>(q, k, v, out, b, sq, skv, hq, hkv, causal,
                               window, q_offset, scale, s);
    case 192:
      return launch_dh<T, 192>(q, k, v, out, b, sq, skv, hq, hkv, causal,
                               window, q_offset, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out: (b, sq, hq, dh); k, v: (b, skv, hkv, dh); all contiguous, one
// dtype. window <= 0 means no window. dh in {64, 80, 96, 128, 192}.
KERNEL_EXPORT int flash_attention_launch(const void* q, const void* k,
                                         const void* v, void* out, int b,
                                         int sq, int skv, int hq, int hkv,
                                         int dh, int causal, int window,
                                         int q_offset, float scale,
                                         int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hkv < 1 || hq % hkv) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == port::DT_F32)
    return launch<float>(q, k, v, out, b, sq, skv, hq, hkv, dh, causal,
                         window, q_offset, scale, s);
  if (dtype == port::DT_BF16)
    return launch<__nv_bfloat16>(q, k, v, out, b, sq, skv, hq, hkv, dh,
                                 causal, window, q_offset, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
