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
// K1 also takes the rolling sliding-window cache of the reference's
// decode_attention(window=) (src/repro/models/attention.py:288-296): a
// cache of cap == window slots holds position p at slot p % cap, every
// slot is valid once the row is full, and slot len % cap — the position
// exactly ``window`` back from the token being decoded — is masked.
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
//   thread forms a partial dot over a quarter of Dh's 16-byte chunks (at
//   Dh 80 in bf16, ten chunks: 2, 3, 2, 3) per query head from 16-byte
//   shared loads against q in shared memory (scaled once); the four
//   partials are added in warp order. All 128 threads are busy at Dh 64,
//   80, 96 and 128.
// - Online softmax per block, computed by every warp alike (warp max
//   and sum by shuffles), so no barrier per query head.
// - P V. Thread t owns ceil(Dh / 32) (dim, quarter of the tile) items —
//   every thread busy at every Dh; at Dh 80 the 320 items leave the last
//   round half full — and takes each position's probability by a shuffle
//   from the lane that holds it (lanes of one warp may read different
//   quarters there: each lane names its own source lane). At the end the
//   quarters are added in order through shared memory and the
//   unnormalised partial (o, m, l) is written in fp32.
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
constexpr int kMidG = 8;     // query heads per KV head: GM 1 or 8, and
constexpr int kMaxG = 12;    // 12 at kWideDh (nemotron-4-340b's 96 / 8)
constexpr int kWideDh = 192;

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
                          int g, int ns, int psplit, float scale,
                          int window, int pos_off, int whole_cap) {
  constexpr int NE = port::Vec<T>::N;   // elements per 16 bytes
  constexpr int LD = DH + NE;           // shared row stride, 16 B padded
  constexpr int CH = DH / NE;           // 16-byte chunks per row
  constexpr int CW = (CH + kWarps - 1) / kWarps;  // most chunks of a warp
  constexpr int NI = kWarps * DH;       // P V items: (quarter, dim)
  constexpr int NIT = (NI + kThreads - 1) / kThreads;  // items per thread
  static_assert(DH % NE == 0, "rows are whole 16-byte chunks");
  static_assert(2 * kTile * CH % kThreads == 0, "staging rounds are whole");
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  // this block's cache holds slots pos_off .. pos_off + cap - 1 of a row
  // of whole_cap slots (a shard of a position-split cache; the whole row
  // when pos_off is 0 and whole_cap is cap), valid to min(len, whole_cap)
  const int len = min(max(min(lens[b], whole_cap) - pos_off, 0), cap);
  // a full rolling cache (whole_cap == window): slot lens[b] % whole_cap
  // holds the position ``window`` back, outside the decoded token's
  // window (never matched when it lies in another shard)
  const int stale = window == whole_cap && lens[b] >= whole_cap
                        ? lens[b] % whole_cap - pos_off
                        : -1;
  // this warp's 16-byte chunks of Dh in the QK product
  const int c_lo = (threadIdx.x >> 5) * CH / kWarps;
  const int c_hi = ((threadIdx.x >> 5) + 1) * CH / kWarps;
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

    {  // this warp's chunks of Dh for position ``lane``
      float acc[GM];
#pragma unroll
      for (int gi = 0; gi < GM; ++gi) acc[gi] = 0.f;
      const T* kr = ks + lane * LD;
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        const int c = (c_lo + j) * NE;
        if (CH % kWarps == 0 || c_lo + j < c_hi) {
          float kf[NE];
          port::load_vec(kr + c, kf);
#pragma unroll
          for (int gi = 0; gi < GM; ++gi) {
            if (gi < g) {
              const float* qr = qs + gi * DH + c;
#pragma unroll
              for (int e = 0; e < NE; ++e)
                acc[gi] = fmaf(qr[e], kf[e], acc[gi]);
            }
          }
        }
      }
#pragma unroll
      for (int gi = 0; gi < GM; ++gi)
        if (gi < g) sp[(warp * g + gi) * kTile + lane] = acc[gi];
    }
    __syncthreads();

    const bool valid = lane < n_here - t * kTile &&
                       start + t * kTile + lane != stale;
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

    // P V: item i = tid + 128 it is (quarter i / DH, dim i % DH); past
    // the NI items (Dh 80) a thread repeats item 0 and never stores it
#pragma unroll
    for (int it = 0; it < NIT; ++it) {
      const int i = tid + kThreads * it;
      const int ic = NI % kThreads == 0 || i < NI ? i : 0;
      const int qr = ic / DH, d = ic % DH;
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
    if (NI % kThreads != 0 && i >= NI) continue;
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
    int g, int ns, int psplit, float scale, int has_self, int shard_cap) {
  __shared__ float red[32];
  const int hq_idx = blockIdx.x, b = blockIdx.y;
  const int h = hq_idx / g;
  const int d = threadIdx.x;
  const bool dim_ok = d < DH;
  const int len = min(lens[b], cap);
  // partial s covers positions from its shard's first (shards of
  // shard_cap slots, ns_sh splits each, in shard order) plus its split's;
  // it was written iff that start is below the row's length. One shard
  // (shard_cap == cap): the first nv partials, split by split.
  const int ns_sh = (shard_cap + psplit - 1) / psplit;
  const int n_iter = shard_cap >= cap ? (len + psplit - 1) / psplit : ns;
  auto live = [&](int s) {
    return (s / ns_sh) * shard_cap + (s % ns_sh) * psplit < len;
  };
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
  for (int s = d; s < n_iter; s += blockDim.x)
    if (live(s)) mloc = fmaxf(mloc, m_part[row * ns + s]);
  const float mx = fmaxf(s_self, port::block_reduce<true>(mloc, red));
  for (int s = d; s < n_iter; s += blockDim.x) {
    if (!live(s)) continue;
    const float a = expf(m_part[row * ns + s] - mx);
    wl[s] = a;
    wl[ns + s] = l_part[row * ns + s] * a;
  }
  __syncthreads();
  float num = 0.f, den = 0.f;
#pragma unroll 8
  for (int s = 0; s < n_iter; ++s) {
    if (!live(s)) continue;
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

// ``passes``: 1 runs pass 1 alone (the partials), 2 the combine alone
// over partials the caller provides, 3 both — one call of K1 or K2.
template <typename T, int DH, typename Rows>
cudaError_t launch_dh(const void* q, const void* kc, const void* vc,
                      const void* ek, const void* ev, const int* lens,
                      Rows rows, float* o_part, float* m_part,
                      float* l_part, void* out, int b, int cap, int hkv,
                      int g, int ns, int psplit, float scale, int window,
                      int pos_off, int whole_cap, int shard_cap, int passes,
                      cudaStream_t stream) {
  if (passes & 1) {
    const size_t smem = partial_smem<T, DH>(g, psplit);
    // register arrays sized for one query head (MHA), up to kMidG, or —
    // at kWideDh only, the one head dim with more query heads per KV
    // head in the registry — up to kMaxG
    auto kernel = g == 1 ? decode_partial_kernel<T, DH, 1, Rows>
                         : decode_partial_kernel<T, DH, kMidG, Rows>;
    if constexpr (DH == kWideDh) {
      if (g > kMidG) kernel = decode_partial_kernel<T, DH, kMaxG, Rows>;
    } else if (g > kMidG) {
      return cudaErrorInvalidValue;
    }
    cudaError_t err = tile::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(ns, hkv, b), kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kc),
        static_cast<const T*>(vc), lens, rows, o_part, m_part, l_part, cap,
        hkv, g, ns, psplit, scale, window, pos_off, whole_cap);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (passes & 2) {
    const int threads = (DH + 31) / 32 * 32;  // whole warps (Dh 80: 96)
    decode_combine_kernel<T, DH>
        <<<dim3(hkv * g, b), threads, 2 * ns * sizeof(float), stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(ek),
        static_cast<const T*>(ev), lens, o_part, m_part, l_part,
        static_cast<T*>(out), cap, hkv, g, ns, psplit, scale,
        ek != nullptr, shard_cap);
  }
  return cudaGetLastError();
}

// Where a call's cache sits in the row (``Where``): the shard's first
// slot and the row's whole capacity for pass 1, the slots per shard of
// the partials for the combine — a whole cache is one shard at 0.
struct Where {
  int pos_off, whole_cap, shard_cap;
};

template <typename T, typename Rows>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const void* ek, const void* ev, const int* lens,
                   Rows rows, float* o_part, float* m_part, float* l_part,
                   void* out, int b, int cap, int hkv, int g, int dh, int ns,
                   int psplit, float scale, int window, Where at, int passes,
                   cudaStream_t s) {
#define DECODE_DH(D)                                                        \
  case D:                                                                   \
    return launch_dh<T, D>(q, kc, vc, ek, ev, lens, rows, o_part, m_part,   \
                           l_part, out, b, cap, hkv, g, ns, psplit, scale,  \
                           window, at.pos_off, at.whole_cap, at.shard_cap,  \
                           passes, s);
  switch (dh) {
    DECODE_DH(64)
    DECODE_DH(80)
    DECODE_DH(96)
    DECODE_DH(128)
    DECODE_DH(192)
    default:
      return cudaErrorInvalidValue;
  }
#undef DECODE_DH
}

template <typename Rows>
int launch_dtype(const void* q, const void* kc, const void* vc,
                 const void* ek, const void* ev, const void* lens, Rows rows,
                 void* o_part, void* m_part, void* l_part, void* out, int b,
                 int cap, int hkv, int g, int dh, int ns, int psplit,
                 float scale, int window, int dtype, void* stream,
                 int passes = 3, Where at = {0, 0, 0}) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ln = static_cast<const int*>(lens);
  float* op = static_cast<float*>(o_part);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  if (at.whole_cap == 0) at = {0, cap, cap};  // one whole cache
  // pass 1 covers ``cap`` slots; the combine ns partials, whole shards
  // of ceil(shard_cap / psplit) each
  const int per_shard = (at.shard_cap + psplit - 1) / max(psplit, 1);
  if (g < 1 || g > kMaxG || cap < 1 ||
      (psplit != 32 && psplit != 128) || window < 0 || passes < 1 ||
      passes > 3 || at.pos_off < 0 || at.whole_cap < 1 ||
      at.shard_cap < 1 ||
      ((passes & 1) && ns != (cap + psplit - 1) / psplit) ||
      ((passes & 2) && ns % per_shard))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == port::DT_F32)
    return launch<float>(q, kc, vc, ek, ev, ln, rows, op, mp, lp, out, b,
                         cap, hkv, g, dh, ns, psplit, scale, window, at,
                         passes, s);
  if (dtype == port::DT_BF16)
    return launch<__nv_bfloat16>(q, kc, vc, ek, ev, ln, rows, op, mp, lp,
                                 out, b, cap, hkv, g, dh, ns, psplit, scale,
                                 window, at, passes, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, out: (b, hkv * g, dh); kc, vc: (b, cap, hkv, dh); ek, ev: (b, hkv,
// dh) or both null (no self partial); lens: (b,) int32 on the device.
// ``psplit`` positions per split (32 or 128: decode_attention.py::
// launch_plan), ns = ceil(cap / psplit). o_part (b, hkv, g, ns, dh),
// m_part / l_part (b, hkv, g, ns): fp32 scratch from the caller. g <= 8
// (12 at dh 192), dh in {64, 80, 96, 128, 192}; pointers 16-byte aligned. window: the
// rolling cache's sliding window (0: none); when it equals cap, a full
// row's slot lens[b] % cap is masked.
KERNEL_EXPORT int decode_attention_launch(
    const void* q, const void* kc, const void* vc, const void* ek,
    const void* ev, const void* lens, void* o_part, void* m_part,
    void* l_part, void* out, int b, int cap, int hkv, int g, int dh, int ns,
    int psplit, float scale, int window, int dtype, void* stream) {
  return launch_dtype(q, kc, vc, ek, ev, lens, ContiguousRows{cap}, o_part,
                      m_part, l_part, out, b, cap, hkv, g, dh, ns, psplit,
                      scale, window, dtype, stream);
}

// K2. kp, vp: pools (nb, bs, hkv, dh); tab: (b, w) int32 block ids on
// the device (ids >= nb are sentinels, clamped to nb - 1 and masked by
// the length). The logical capacity is w * bs; ns = ceil(w * bs /
// psplit). No window: a paged cache never rolls. Everything else as
// decode_attention_launch.
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
                      out, b, w * bs, hkv, g, dh, ns, psplit, scale, 0, dtype,
                      stream);
}

// K1's passes one at a time, for a cache split by position over several
// shards (the sequence-sharded decode of a mesh). Each shard runs pass 1
// over its ``cap`` slots — slots pos_off .. pos_off + cap - 1 of rows of
// whole_cap slots, ``lens`` the whole rows' lengths, ``window`` the
// rolling window as decode_attention_launch takes it on the whole row —
// with ns = ceil(cap / psplit); the shards' partials are concatenated
// along the split axis in shard order, and the combine runs over them
// with the whole capacity ``cap``, the slots per shard ``shard_cap``
// and the whole rows' lengths. When every shard holds whole splits these
// are the partials the single cache's pass 1 would have written.
KERNEL_EXPORT int decode_partial_launch(
    const void* q, const void* kc, const void* vc, const void* lens,
    void* o_part, void* m_part, void* l_part, int b, int cap, int hkv,
    int g, int dh, int ns, int psplit, float scale, int window, int pos_off,
    int whole_cap, int dtype, void* stream) {
  return launch_dtype(q, kc, vc, nullptr, nullptr, lens,
                      ContiguousRows{cap}, o_part, m_part, l_part, nullptr,
                      b, cap, hkv, g, dh, ns, psplit, scale, window, dtype,
                      stream, 1, Where{pos_off, whole_cap, cap});
}

KERNEL_EXPORT int decode_combine_launch(
    const void* q, const void* ek, const void* ev, const void* lens,
    void* o_part, void* m_part, void* l_part, void* out, int b, int cap,
    int hkv, int g, int dh, int ns, int psplit, float scale, int shard_cap,
    int dtype, void* stream) {
  return launch_dtype(q, nullptr, nullptr, ek, ev, lens, ContiguousRows{cap},
                      o_part, m_part, l_part, out, b, cap, hkv, g, dh, ns,
                      psplit, scale, 0, dtype, stream, 2,
                      Where{0, cap, shard_cap});
}
