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
// head — G flops per byte in bf16 (G = 1 for MHA), below the CUDA
// cores' ~20 fp32 flops per byte, so the CUDA cores suffice.
//
// Design. Pass 1 runs one block of 4 warps per (KV split, kv head, batch
// row). The split size P (32 or 128 positions, launch_plan in
// decode_attention.py) depends only on B and Hkv — never the capacity —
// so B = 1 still puts several blocks on every SM, and a contiguous cache
// and a block-table view cut the same positions at the same boundaries.
// A split that starts past its row's length returns at once.
// - Staging. The split is walked in tiles of 32 positions. K and V rows
//   of a tile are copied into shared memory by 16-byte cp.async, lanes
//   along a row (coalesced), double-buffered when the split holds more
//   than one tile; rows are padded by 16 bytes so that 32 lanes reading
//   32 rows hit distinct banks. Rows past the length are zero-filled
//   (src-size 0) and masked. K2 differs only in the row address: one
//   block-table lookup per copied chunk, sentinels clamped.
// - Q K^T. Lane = position of the tile, warp = a quarter of Dh: each
//   thread forms a Dh / 4-long partial dot per query head from 16-byte
//   shared loads against q in shared memory (scaled once); the four
//   partials are added in warp order. All 128 threads are busy at Dh 64,
//   96 and 128.
// - Online softmax per block, computed by every warp alike (warp max
//   and sum by shuffles), so no barrier per query head.
// - P V. Thread t owns Dh / 32 (dim, quarter of the tile) items — every
//   thread busy at every Dh — and takes each position's probability by a
//   shuffle from the lane that holds it. At the end the quarters are
//   added in order through shared memory and the unnormalised partial
//   (o, m, l) is written in fp32.
// Pass 2 runs one block per (batch row, query head): it computes the
// self score and the splits' weights (threads across splits), then
// merges the valid splits' partials and the self partial in split order
// — a fixed order without atomics, so the output is deterministic — and
// writes the normalised result.
//
// Only the address of a position differs between K1 and K2; the
// arithmetic and its order are the same code, so K2 on a pool holding
// the same logical rows as a K1 cache is bitwise equal to K1.
#include "flash_tile.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;    // positions per staged tile (one per lane)
constexpr int kMaxG = 8;     // query heads per KV head (GM: 1 or this)

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

// Dynamic shared memory of pass 1: the K/V ring, q, the QK partials of
// the 4 warps and the P V partials of the 4 quarters.
template <typename T, int DH>
size_t partial_smem(int g, int psplit) {
  const int stages = psplit > kTile ? 2 : 1;
  return static_cast<size_t>(stages) * 2 * kTile * (DH + port::Vec<T>::N) *
             sizeof(T) +
         sizeof(float) * (g * DH + kWarps * g * kTile + kWarps * g * DH);
}

template <typename T, int DH, int GM, typename Rows>
__global__ void __launch_bounds__(kThreads)
    decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                          const T* __restrict__ vc,
                          const int* __restrict__ lens, Rows rows,
                          float* __restrict__ o_part,
                          float* __restrict__ m_part,
                          float* __restrict__ l_part, int cap, int hkv,
                          int g, int ns, int psplit, float scale) {
  constexpr int NE = port::Vec<T>::N;   // elements per 16 bytes
  constexpr int LD = DH + NE;           // shared row stride, 16 B padded
  constexpr int CH = DH / NE;           // 16-byte chunks per row
  constexpr int DQ = DH / kWarps;       // dims of a warp's QK partial
  constexpr int NIT = DH / 32;          // P V items per thread
  static_assert(DQ % NE == 0, "a warp's dims are whole 16-byte chunks");
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int len = min(lens[b], cap);
  const int start = split * psplit;
  if (start >= len) return;  // pass 2 never reads this split
  const int n_here = min(psplit, len - start);
  const int ntiles = (n_here + kTile - 1) / kTile;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // [stage][K, V][kTile][LD]
  const int stages = psplit > kTile ? 2 : 1;
  float* qs = reinterpret_cast<float*>(ring + stages * 2 * kTile * LD);
  float* sp = qs + g * DH;             // [warp][g][kTile] QK partials
  float* os = sp + kWarps * g * kTile;  // [quarter][g][DH] P V partials
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // tile t of the split into ring stage st: K and V rows, 16 bytes a
  // copy, consecutive threads on consecutive chunks of a row
  auto stage = [&](int t, int st) {
    T* dst = ring + st * 2 * kTile * LD;
    const int p0 = start + t * kTile;
#pragma unroll
    for (int j = 0; j < 2 * kTile * CH / kThreads; ++j) {
      const int idx = tid + j * kThreads;
      const int kv = idx / (kTile * CH), rem = idx % (kTile * CH);
      const int r = rem / CH, c = rem % CH;
      const int p = p0 + r;
      const T* src = nullptr;
      if (p < start + n_here)
        src = (kv ? vc : kc) + (rows(b, p) * hkv + h) * DH + c * NE;
      tile::cp_async16(dst + (kv * kTile + r) * LD + c * NE, src, kc);
    }
    tile::cp_async_commit();
  };

  stage(0, 0);
  const T* qb = q + (static_cast<size_t>(b) * hkv + h) * g * DH;
  for (int i = tid; i < g * DH; i += kThreads)
    qs[i] = port::to_f(qb[i]) * scale;

  float m[GM], l[GM], o[NIT][GM];
#pragma unroll
  for (int gi = 0; gi < GM; ++gi) {
    m[gi] = port::NEG_INF;
    l[gi] = 0.f;
#pragma unroll
    for (int it = 0; it < NIT; ++it) o[it][gi] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      stage(t + 1, (t + 1) & 1);
      tile::cp_async_wait<1>();
    } else {
      tile::cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and q) visible to the block
    const T* ks = ring + (t & 1) * 2 * kTile * LD;
    const T* vs = ks + kTile * LD;

    {  // this warp's quarter of Dh for position ``lane``
      float acc[GM];
#pragma unroll
      for (int gi = 0; gi < GM; ++gi) acc[gi] = 0.f;
      const T* kr = ks + lane * LD + warp * DQ;
#pragma unroll
      for (int c = 0; c < DQ; c += NE) {
        float kf[NE];
        port::load_vec(kr + c, kf);
#pragma unroll
        for (int gi = 0; gi < GM; ++gi) {
          if (gi < g) {
            const float* qr = qs + gi * DH + warp * DQ + c;
#pragma unroll
            for (int e = 0; e < NE; ++e) acc[gi] = fmaf(qr[e], kf[e], acc[gi]);
          }
        }
      }
#pragma unroll
      for (int gi = 0; gi < GM; ++gi)
        if (gi < g) sp[(warp * g + gi) * kTile + lane] = acc[gi];
    }
    __syncthreads();

    const bool valid = lane < n_here - t * kTile;
    float p[GM];
#pragma unroll
    for (int gi = 0; gi < GM; ++gi) {
      p[gi] = 0.f;
      if (gi < g) {
        float s = sp[gi * kTile + lane];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) s += sp[(w * g + gi) * kTile + lane];
        s = valid ? s : port::NEG_INF;
        const float mx = fmaxf(m[gi], port::warp_max(s));
        const float alpha = expf(m[gi] - mx);
        p[gi] = valid ? expf(s - mx) : 0.f;
        l[gi] = l[gi] * alpha + port::warp_sum(p[gi]);
        m[gi] = mx;
#pragma unroll
        for (int it = 0; it < NIT; ++it) o[it][gi] *= alpha;
      }
    }

    // P V: item i = tid + 128 it is (quarter i / DH, dim i % DH); the 32
    // items of a warp share a quarter, so one shuffle lane per position
#pragma unroll
    for (int it = 0; it < NIT; ++it) {
      const int i = tid + kThreads * it;
      const int qr = i / DH, d = i % DH;
#pragma unroll
      for (int e = 0; e < kTile / kWarps; ++e) {
        const int pos = qr * (kTile / kWarps) + e;
        const float vv = port::to_f(vs[pos * LD + d]);
#pragma unroll
        for (int gi = 0; gi < GM; ++gi)
          if (gi < g)
            o[it][gi] =
                fmaf(__shfl_sync(0xffffffffu, p[gi], pos), vv, o[it][gi]);
      }
    }
    __syncthreads();  // ring stage and QK partials free for reuse
  }

#pragma unroll
  for (int it = 0; it < NIT; ++it) {
    const int i = tid + kThreads * it;
    const int qr = i / DH, d = i % DH;
#pragma unroll
    for (int gi = 0; gi < GM; ++gi)
      if (gi < g) os[(qr * g + gi) * DH + d] = o[it][gi];
  }
  __syncthreads();
  const size_t row = (static_cast<size_t>(b) * hkv + h) * g;
  for (int i = tid; i < g * DH; i += kThreads) {
    const int gi = i / DH, d = i % DH;
    float v = os[gi * DH + d];
#pragma unroll
    for (int qr = 1; qr < kWarps; ++qr) v += os[(qr * g + gi) * DH + d];
    o_part[((row + gi) * ns + split) * DH + d] = v;
  }
  if (tid == 0) {
#pragma unroll
    for (int gi = 0; gi < GM; ++gi)
      if (gi < g) {
        m_part[(row + gi) * ns + split] = m[gi];
        l_part[(row + gi) * ns + split] = l[gi];
      }
  }
}

template <typename T, int DH>
__global__ void decode_combine_kernel(
    const T* __restrict__ q, const T* __restrict__ ek,
    const T* __restrict__ ev, const int* __restrict__ lens,
    const float* __restrict__ o_part, const float* __restrict__ m_part,
    const float* __restrict__ l_part, T* __restrict__ out, int cap, int hkv,
    int g, int ns, int psplit, float scale, int has_self) {
  __shared__ float red[32];
  const int hq_idx = blockIdx.x, b = blockIdx.y;
  const int h = hq_idx / g;
  const int d = threadIdx.x;
  const bool dim_ok = d < DH;
  const int len = min(lens[b], cap);
  const int nv = (len + psplit - 1) / psplit;
  const size_t row = static_cast<size_t>(b) * hkv * g + hq_idx;

  float s_self = port::NEG_INF;
  if (has_self) {
    float t = 0.f;
    if (dim_ok)
      t = port::to_f(q[row * DH + d]) * scale *
          port::to_f(ek[(static_cast<size_t>(b) * hkv + h) * DH + d]);
    s_self = port::block_reduce<false>(t, red);
  }
  // the splits' max, weights and weighted sums, split by split across
  // the threads; then the sums in split order
  extern __shared__ float wl[];  // [ns] exp(m - max), [ns] l exp(m - max)
  float mloc = port::NEG_INF;
  for (int s = d; s < nv; s += blockDim.x)
    mloc = fmaxf(mloc, m_part[row * ns + s]);
  const float mx = fmaxf(s_self, port::block_reduce<true>(mloc, red));
  for (int s = d; s < nv; s += blockDim.x) {
    const float a = expf(m_part[row * ns + s] - mx);
    wl[s] = a;
    wl[ns + s] = l_part[row * ns + s] * a;
  }
  __syncthreads();
  float num = 0.f, den = 0.f;
#pragma unroll 8
  for (int s = 0; s < nv; ++s) {
    den += wl[ns + s];
    if (dim_ok) num += o_part[(row * ns + s) * DH + d] * wl[s];
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
                      int g, int ns, int psplit, float scale,
                      cudaStream_t stream) {
  const size_t smem = partial_smem<T, DH>(g, psplit);
  // register arrays sized for one query head (MHA) or for up to kMaxG
  const auto kernel = g == 1 ? decode_partial_kernel<T, DH, 1, Rows>
                             : decode_partial_kernel<T, DH, kMaxG, Rows>;
  cudaError_t err = tile::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(ns, hkv, b), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), lens, rows, o_part, m_part, l_part, cap,
      hkv, g, ns, psplit, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int threads = DH < 32 ? 32 : DH;
  decode_combine_kernel<T, DH>
      <<<dim3(hkv * g, b), threads, 2 * ns * sizeof(float), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(ek),
      static_cast<const T*>(ev), lens, o_part, m_part, l_part,
      static_cast<T*>(out), cap, hkv, g, ns, psplit, scale, ek != nullptr);
  return cudaGetLastError();
}

template <typename T, typename Rows>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const void* ek, const void* ev, const int* lens,
                   Rows rows, float* o_part, float* m_part, float* l_part,
                   void* out, int b, int cap, int hkv, int g, int dh, int ns,
                   int psplit, float scale, cudaStream_t s) {
  switch (dh) {
    case 64:
      return launch_dh<T, 64>(q, kc, vc, ek, ev, lens, rows, o_part, m_part,
                              l_part, out, b, cap, hkv, g, ns, psplit, scale,
                              s);
    case 96:
      return launch_dh<T, 96>(q, kc, vc, ek, ev, lens, rows, o_part, m_part,
                              l_part, out, b, cap, hkv, g, ns, psplit, scale,
                              s);
    case 128:
      return launch_dh<T, 128>(q, kc, vc, ek, ev, lens, rows, o_part,
                               m_part, l_part, out, b, cap, hkv, g, ns,
                               psplit, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename Rows>
int launch_dtype(const void* q, const void* kc, const void* vc,
                 const void* ek, const void* ev, const void* lens, Rows rows,
                 void* o_part, void* m_part, void* l_part, void* out, int b,
                 int cap, int hkv, int g, int dh, int ns, int psplit,
                 float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ln = static_cast<const int*>(lens);
  float* op = static_cast<float*>(o_part);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  if (g < 1 || g > kMaxG || cap < 1 ||
      (psplit != 32 && psplit != 128) ||
      ns != (cap + psplit - 1) / psplit)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == port::DT_F32)
    return launch<float>(q, kc, vc, ek, ev, ln, rows, op, mp, lp, out, b,
                         cap, hkv, g, dh, ns, psplit, scale, s);
  if (dtype == port::DT_BF16)
    return launch<__nv_bfloat16>(q, kc, vc, ek, ev, ln, rows, op, mp, lp,
                                 out, b, cap, hkv, g, dh, ns, psplit, scale,
                                 s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, out: (b, hkv * g, dh); kc, vc: (b, cap, hkv, dh); ek, ev: (b, hkv,
// dh) or both null (no self partial); lens: (b,) int32 on the device.
// ``psplit`` positions per split (32 or 128: decode_attention.py::
// launch_plan), ns = ceil(cap / psplit). o_part (b, hkv, g, ns, dh),
// m_part / l_part (b, hkv, g, ns): fp32 scratch from the caller. g <= 8,
// dh in {64, 96, 128}; pointers 16-byte aligned.
KERNEL_EXPORT int decode_attention_launch(
    const void* q, const void* kc, const void* vc, const void* ek,
    const void* ev, const void* lens, void* o_part, void* m_part,
    void* l_part, void* out, int b, int cap, int hkv, int g, int dh, int ns,
    int psplit, float scale, int dtype, void* stream) {
  return launch_dtype(q, kc, vc, ek, ev, lens, ContiguousRows{cap}, o_part,
                      m_part, l_part, out, b, cap, hkv, g, dh, ns, psplit,
                      scale, dtype, stream);
}

// K2. kp, vp: pools (nb, bs, hkv, dh); tab: (b, w) int32 block ids on
// the device (ids >= nb are sentinels, clamped to nb - 1 and masked by
// the length). The logical capacity is w * bs; ns = ceil(w * bs /
// psplit). Everything else as decode_attention_launch.
KERNEL_EXPORT int paged_decode_attention_launch(
    const void* q, const void* kp, const void* vp, const void* ek,
    const void* ev, const void* lens, const void* tab, void* o_part,
    void* m_part, void* l_part, void* out, int b, int w, int bs, int nb,
    int hkv, int g, int dh, int ns, int psplit, float scale, int dtype,
    void* stream) {
  if (w < 1 || bs < 1 || nb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const PagedRows rows{static_cast<const int*>(tab), w, bs, nb};
  return launch_dtype(q, kp, vp, ek, ev, lens, rows, o_part, m_part, l_part,
                      out, b, w * bs, hkv, g, dh, ns, psplit, scale, dtype,
                      stream);
}
