// K4 — prefill over a KV cache (chunked prefill and speculative verify).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_hist_bhsd (body ``_hist_kernel``) with its entries
// src/repro/kernels/ops.py::prefill_attention / verify_attention: the S
// queries of batch row b sit at absolute positions hist_len[b] ..
// hist_len[b] + S - 1 and attend the row's cached history, valid to
// hist_len[b], plus their own KV under plain causality (query i sees
// self keys 0..i), in one softmax (fp32 m / l / acc). Masked scores keep
// the reference's finite -1e30. GQA is indexed (kv_head = head / G)
// instead of repeating K/V as the TPU wrapper does. History is read from
// a (B, C, Hkv, Dh) view: the slot's rows of the contiguous cache for a
// chunk, every row for verify, or a block-table gather of the paged pool.
//
// Bound on the H100: bytes at both of the path's shapes. A chunk (S =
// 256 over a 768-position history, Dh = 64) does ~4 S flops per history
// element, under the card's ~295 bf16 flops per byte only with the
// products on the tensor cores; verify (S = gamma + 1 = 5) does ~10
// flops per history byte and is bound by streaming the rows' histories,
// which needs enough blocks in flight to cover memory latency.
//
// bf16 design, two launch shapes chosen from S alone (flash_tile.cuh
// holds the tile body both share with K3: mma.sync m16n8k16 on the
// tensor cores, ldmatrix operands, P kept in registers, cp.async
// staging):
//
// - S > 16 (chunk): one block of 4 warps per (batch row * q head,
//   64-query tile), launched heaviest first. It walks the history tiles
//   of 64 keys up to the row's hist_len (tiles past it are never read),
//   then its self tiles up to the tile's last query, through a two-stage
//   cp.async ring, in one online softmax.
// - S <= 16 (verify): the history is cut into splits of a fixed 128
//   positions, as K1 does. Pass 1 runs one block per (split, batch row,
//   kv head): its tile rows are the G * S (query head, query) pairs of
//   that kv head, one warp per 16 of them, so each K/V split is read
//   once per kv head; the split is staged in two halves of 64 keys, the
//   second loading while the first is multiplied. Blocks past the row's
//   hist_len exit at once; the grid is sized from ceil(C / 128), never
//   from hist_len on the host. One more block per (batch row, kv head)
//   takes the self keys. Each writes its unnormalised partial (o, m, l)
//   in fp32; pass 2 merges the splits in order, then self, as K1's
//   combine does: deterministic, no atomics. Split boundaries depend on
//   positions only, so a contiguous view and a block-table gather of the
//   same rows give bitwise equal outputs (so does the chunk shape, whose
//   tiles start at multiples of 64).
//
// What limits it now: a chunk runs 64 blocks on 132 SMs, each a serial
// chain over up to 16 KV tiles, as K3 is limited; verify streams its
// histories with one-warp blocks (MHA) and pays a second launch for the
// merge (PERF.md).
//
// Head dim 192 (nemotron-4-340b) builds apart: prefill_attention_wide.cu
// is this source with PREFILL_WIDE defined, instantiating only Dh 192
// (and this one without it), so the two nvcc of the parallel build share
// the work of the widest tiles (prefill_attention.py picks the library
// by head dim).
//
// float32 keeps the CUDA-core body of the first port
// (prefill_hist_kernel: a q-tile of 8..64 rows sized from S, 128 / BQ
// threads per row, fp32 K/V tiles in static shared memory, scalar
// loads), chosen by dtype in the launch function: it carries the
// float32 greedy-stream gates.
#include "flash_tile.cuh"

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

// What one launch of the CUDA-core body does: the history then the self
// keys into the output (one device's call); the history only, into the
// unnormalised fp32 partial (o, m, l) of each (row, query, head) — a
// shard of a position-split history, from position pos_off —; or the
// shards' gathered partials merged in shard order, then the self keys,
// into the output.
enum Mode { kWhole = 0, kHistPartial = 1, kSelfCombine = 2 };

template <typename T, int DH, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    prefill_hist_kernel(const T* __restrict__ q, const T* __restrict__ kh,
                        const T* __restrict__ vh, const T* __restrict__ ksf,
                        const T* __restrict__ vsf,
                        const int* __restrict__ hist_len,
                        T* __restrict__ out, int s, int c, int hq, int hkv,
                        float scale, int mode, int pos_off,
                        float* __restrict__ o_part,
                        float* __restrict__ m_part,
                        float* __restrict__ l_part, int n_parts) {
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
  // the history valid here: none when merging partials; a shard's own
  // positions from pos_off
  const int hl = mode == kSelfCombine
                     ? 0
                     : min(max(hist_len[b] - pos_off, 0), c);
  // (row, query, head) index of the partials: (b, hq, s[, part])
  const size_t pidx = (static_cast<size_t>(b) * hq + h) * s + q_row;

  float qf[PER], acc[PER];
  const T* qr = q + ((static_cast<size_t>(b) * s + q_row) * hq + h) * DH;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    qf[i] = row_ok ? port::to_f(qr[i * TPR + par]) * scale : 0.f;
    acc[i] = 0.f;
  }
  float m = port::NEG_INF, l = 0.f;
  if (mode == kSelfCombine && row_ok) {
    // every shard's history partial, in shard order (no atomics)
    for (int pt = 0; pt < n_parts; ++pt) {
      const size_t at = pidx * n_parts + pt;
      const float mp = m_part[at];
      const float m_new = fmaxf(m, mp);
      const float alpha = expf(m - m_new), beta = expf(mp - m_new);
      l = l * alpha + l_part[at] * beta;
#pragma unroll
      for (int i = 0; i < PER; ++i)
        acc[i] = acc[i] * alpha + o_part[at * DH + i * TPR + par] * beta;
      m = m_new;
    }
  }

  // history: tiles up to the row's valid length, none past it
  const int nk_hist = (hl + BK - 1) / BK;
  for (int kt = 0; kt < nk_hist; ++kt) {
    __syncthreads();  // previous tile fully consumed
    stage_tile<T, DH, BK>(kh, vh, ks, vs, b, c, hkv, hk, kt * BK, hl);
    __syncthreads();
    attend_tile<DH, BK, TPR>(ks, vs, qf, acc, m, l, kt * BK, hl, false,
                             q_row, par);
  }
  if (mode == kHistPartial) {
    if (row_ok) {
#pragma unroll
      for (int i = 0; i < PER; ++i)
        o_part[pidx * DH + i * TPR + par] = acc[i];
      if (par == 0) {
        m_part[pidx] = m;
        l_part[pidx] = l;
      }
    }
    return;
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

// The CUDA-core body: float32 calls, and the position-split partials
// and their merge in either dtype. K and V tiles of BK x DH fp32 in
// static shared memory (48 KiB at most): 64 keys at DH 64, 32 from DH 96
// on, 16 at DH 192 (32 would fill the 48 KiB exactly).
struct Parts {
  int mode, pos_off;
  float *o, *m, *l;
  int n;
};

template <typename T, int DH, int BQ>
cudaError_t launch_bq(const void* q, const void* kh, const void* vh,
                      const void* ks, const void* vs, const int* hist_len,
                      void* out, int b, int s, int c, int hq, int hkv,
                      float scale, Parts pt, cudaStream_t stream) {
  constexpr int BK = DH > 128 ? 16 : DH > 64 ? 32 : 64;
  dim3 grid((s + BQ - 1) / BQ, b * hq);
  prefill_hist_kernel<T, DH, BQ, BK><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kh),
      static_cast<const T*>(vh), static_cast<const T*>(ks),
      static_cast<const T*>(vs), hist_len, static_cast<T*>(out), s, c, hq,
      hkv, scale, pt.mode, pt.pos_off, pt.o, pt.m, pt.l, pt.n);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_cuda_core(const void* q, const void* kh, const void* vh,
                             const void* ks, const void* vs,
                             const int* hist_len, void* out, int b, int s,
                             int c, int hq, int hkv, float scale, Parts pt,
                             cudaStream_t st) {
  if (s <= 8)
    return launch_bq<T, DH, 8>(q, kh, vh, ks, vs, hist_len, out, b, s, c, hq,
                               hkv, scale, pt, st);
  if (s <= 16)
    return launch_bq<T, DH, 16>(q, kh, vh, ks, vs, hist_len, out, b, s, c,
                                hq, hkv, scale, pt, st);
  if (s <= 32)
    return launch_bq<T, DH, 32>(q, kh, vh, ks, vs, hist_len, out, b, s, c,
                                hq, hkv, scale, pt, st);
  return launch_bq<T, DH, 64>(q, kh, vh, ks, vs, hist_len, out, b, s, c, hq,
                              hkv, scale, pt, st);
}

// bf16: tensor-core tiles (see the note at the top).
constexpr int kBQ = 64;             // chunk: queries per block
constexpr int kBK = 64;             // keys per staged tile
constexpr int kStages = 2;          // depth of the chunk's cp.async ring
constexpr int kSplit = 128;         // verify: history positions per split
constexpr int kVerifyMaxS = 16;     // S at or below: the split shape
constexpr int kRowsPerBlock = 128;  // verify: (head, query) rows, 8 warps
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
constexpr size_t chunk_smem_bytes() {
  // Q tile + the ring of (K tile, V tile) stages
  return sizeof(tile::bf16) * tile::Dims<DH>::LD * (kBQ + kStages * 2 * kBK);
}

template <int DH>
constexpr size_t split_smem_bytes(int warps) {
  // the warps' Q rows + one split of K and of V
  return sizeof(tile::bf16) * tile::Dims<DH>::LD *
         (warps * 16 + 2 * kSplit);
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
    chunk_bf16_kernel(const tile::bf16* __restrict__ q,
                      const tile::bf16* __restrict__ kh,
                      const tile::bf16* __restrict__ vh,
                      const tile::bf16* __restrict__ ksf,
                      const tile::bf16* __restrict__ vsf,
                      const int* __restrict__ hist_len,
                      tile::bf16* __restrict__ out, int s, int c, int hq,
                      int hkv, float scale_log2) {
  using tile::bf16;
  constexpr int LD = tile::Dims<DH>::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* kv = qs + kBQ * LD;  // stage i: K at kv + 2 i BK LD, V after it

  const int b = blockIdx.x / hq, h = blockIdx.x % hq;
  const int hk = h / (hq / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest first
  const int warp = threadIdx.x >> 5;
  const int hl = min(max(hist_len[b], 0), c);
  const int n_hist = (hl + kBK - 1) / kBK;
  const int n_tiles = n_hist + (min(q0 + kBQ, s) - 1) / kBK + 1;

  auto q_row = [&](int r) -> const bf16* {
    const int row = q0 + r;
    return row < s ? q + ((static_cast<size_t>(b) * s + row) * hq + h) * DH
                   : nullptr;
  };
  tile::stage_rows<DH>(qs, kBQ, q_row, q);
  // key row kp of this (batch row, kv head) in a (B, n, Hkv, DH) array,
  // nullptr at or past ``valid``
  auto key_row = [&](const bf16* base, int n, int valid,
                     int kp) -> const bf16* {
    return kp < valid
               ? base + ((static_cast<size_t>(b) * n + kp) * hkv + hk) * DH
               : nullptr;
  };
  // tile t: history tile t, then self tile t - n_hist
  auto stage_kv = [&](int t, int stage) {
    const bool hist = t < n_hist;
    const int k_lo = (hist ? t : t - n_hist) * kBK;
    const int n = hist ? c : s, valid = hist ? hl : s;
    const bf16* kb = hist ? kh : ksf;
    const bf16* vb = hist ? vh : vsf;
    bf16* dst = kv + 2 * stage * kBK * LD;
    tile::stage_rows<DH>(
        dst, kBK, [&](int r) { return key_row(kb, n, valid, k_lo + r); },
        kb);
    tile::stage_rows<DH>(
        dst + kBK * LD, kBK,
        [&](int r) { return key_row(vb, n, valid, k_lo + r); }, vb);
  };
  // prologue: tiles 0 .. kStages - 2, one commit group each (Q rides in
  // the first)
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) stage_kv(t, t);
    tile::cp_async_commit();
  }

  tile::Rows16<DH> rows;
  rows.init();
  for (int t = 0; t < n_tiles; ++t) {
    const int ahead = t + kStages - 1;
    if (ahead < n_tiles) stage_kv(ahead, ahead % kStages);
    tile::cp_async_commit();             // maybe empty: keeps the count
    tile::cp_async_wait<kStages - 1>();  // tile t has landed
    __syncthreads();
    if (t == 0) rows.load_q(qs + warp * 16 * LD);
    const bf16* ks = kv + 2 * (t % kStages) * kBK * LD;
    if (t < n_hist) {
      const int k_lo = t * kBK;
      auto visible = [&](int, int j) { return k_lo + j < hl; };
      rows.template attend<kBK>(ks, ks + kBK * LD, scale_log2,
                                k_lo + kBK > hl, visible);
    } else {
      const int k_lo = (t - n_hist) * kBK, row0 = q0 + warp * 16;
      auto visible = [&](int r, int j) { return k_lo + j <= row0 + r; };
      rows.template attend<kBK>(ks, ks + kBK * LD, scale_log2,
                                k_lo + kBK - 1 > q0, visible);
    }
    __syncthreads();  // the stage is free for tile t + kStages
  }

  rows.finish();
  rows.store([&](int r) -> bf16* {
    const int row = q0 + warp * 16 + r;
    return row < s ? out + ((static_cast<size_t>(b) * s + row) * hq + h) * DH
                   : nullptr;
  });
}

// Verify pass 1: one split of the history (blockIdx.x < ns) or the self
// keys (blockIdx.x == ns) for one (batch row, kv head, block of up to
// 128 (head, query) rows). Partials: o (b, hq, s, ns + 1, DH), m and l
// (b, hq, s, ns + 1), fp32, m in the log2 domain of the scores.
template <int DH>
__global__ void __launch_bounds__(kRowsPerBlock / 16 * 32)
    verify_split_kernel(const tile::bf16* __restrict__ q,
                        const tile::bf16* __restrict__ kh,
                        const tile::bf16* __restrict__ vh,
                        const tile::bf16* __restrict__ ksf,
                        const tile::bf16* __restrict__ vsf,
                        const int* __restrict__ hist_len,
                        float* __restrict__ o_part,
                        float* __restrict__ m_part,
                        float* __restrict__ l_part, int s, int c, int hq,
                        int hkv, int ns, float scale_log2) {
  using tile::bf16;
  constexpr int LD = tile::Dims<DH>::LD;
  const int sp = blockIdx.x, b = blockIdx.y;
  const int g = hq / hkv, n_rows = g * s;
  const int n_rb = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const int hk = blockIdx.z / n_rb;
  const int r0 = (blockIdx.z % n_rb) * kRowsPerBlock;
  const int hl = min(max(hist_len[b], 0), c);
  const bool self = sp == ns;
  const int k_lo = sp * kSplit;
  if (!self && k_lo >= hl) return;  // pass 2 never reads this split

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* kb = qs + warps * 16 * LD;
  bf16* vb = kb + kSplit * LD;

  // tile row r holds query row r0 + r = gi * s + i: head hk * g + gi,
  // query i
  auto q_row = [&](int r) -> const bf16* {
    const int rr = r0 + r;
    if (rr >= n_rows) return nullptr;
    const int head = hk * g + rr / s, i = rr % s;
    return q + ((static_cast<size_t>(b) * s + i) * hq + head) * DH;
  };
  tile::stage_rows<DH>(qs, warps * 16, q_row, q);
  auto key_row = [&](const bf16* base, int n, int valid,
                     int kp) -> const bf16* {
    return kp < valid
               ? base + ((static_cast<size_t>(b) * n + kp) * hkv + hk) * DH
               : nullptr;
  };
  auto stage_keys = [&](const bf16* kbase, const bf16* vbase, int n,
                        int valid, int lo, int count, int at) {
    tile::stage_rows<DH>(
        kb + at * LD, count,
        [&](int r) { return key_row(kbase, n, valid, lo + r); }, kbase);
    tile::stage_rows<DH>(
        vb + at * LD, count,
        [&](int r) { return key_row(vbase, n, valid, lo + r); }, vbase);
  };

  tile::Rows16<DH> rows;
  rows.init();
  const int row0 = r0 + warp * 16;  // the warp's first query row
  if (self) {
    stage_keys(ksf, vsf, s, s, 0, kVerifyMaxS, 0);
    tile::cp_async_commit();
    tile::cp_async_wait<0>();
    __syncthreads();
    rows.load_q(qs + warp * 16 * LD);
    auto visible = [&](int r, int j) { return j <= (row0 + r) % s; };
    rows.template attend<kVerifyMaxS>(kb, vb, scale_log2, true, visible);
  } else {
    const int n_valid = min(kSplit, hl - k_lo);
    stage_keys(kh, vh, c, hl, k_lo, kBK, 0);
    tile::cp_async_commit();
    if (n_valid > kBK) {
      stage_keys(kh, vh, c, hl, k_lo + kBK, kBK, kBK);
      tile::cp_async_commit();
      tile::cp_async_wait<1>();
    } else {
      tile::cp_async_wait<0>();
    }
    __syncthreads();
    rows.load_q(qs + warp * 16 * LD);
    auto first = [&](int, int j) { return j < n_valid; };
    rows.template attend<kBK>(kb, vb, scale_log2, n_valid < kBK, first);
    if (n_valid > kBK) {
      tile::cp_async_wait<0>();
      __syncthreads();
      auto second = [&](int, int j) { return kBK + j < n_valid; };
      rows.template attend<kBK>(kb + kBK * LD, vb + kBK * LD, scale_log2,
                                n_valid < kSplit, second);
    }
  }
  rows.finish();

  const int lane = threadIdx.x & 31, t2 = (lane & 3) * 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int rr = row0 + (lane >> 2) + half * 8;
    if (rr >= n_rows) continue;
    const int head = hk * g + rr / s, i = rr % s;
    const size_t idx =
        ((static_cast<size_t>(b) * hq + head) * s + i) * (ns + 1) + sp;
#pragma unroll
    for (int n = 0; n < tile::Dims<DH>::NT; ++n)
      *reinterpret_cast<float2*>(o_part + idx * DH + n * 8 + t2) =
          make_float2(rows.o[n][2 * half], rows.o[n][2 * half + 1]);
    if (t2 == 0) {
      m_part[idx] = rows.m[half];
      l_part[idx] = rows.l[half];
    }
  }
}

// Verify pass 2: one block of DH threads per (query, head, batch row)
// merges the row's valid splits in order, then the self partial.
template <int DH>
__global__ void __launch_bounds__(DH)
    verify_combine_kernel(const float* __restrict__ o_part,
                          const float* __restrict__ m_part,
                          const float* __restrict__ l_part,
                          const int* __restrict__ hist_len,
                          tile::bf16* __restrict__ out, int s, int c, int hq,
                          int ns) {
  const int i = blockIdx.x / hq, h = blockIdx.x % hq, b = blockIdx.y;
  const int d = threadIdx.x;
  const int hl = min(max(hist_len[b], 0), c);
  const int nv = (hl + kSplit - 1) / kSplit;
  const size_t idx0 =
      ((static_cast<size_t>(b) * hq + h) * s + i) * (ns + 1);
  float mx = m_part[idx0 + ns];
  for (int sp = 0; sp < nv; ++sp) mx = fmaxf(mx, m_part[idx0 + sp]);
  float num = 0.f, den = 0.f;
  for (int sp = 0; sp <= nv; ++sp) {
    const size_t idx = idx0 + (sp < nv ? sp : ns);  // splits, then self
    const float a = exp2f(m_part[idx] - mx);
    den += l_part[idx] * a;
    num += o_part[idx * DH + d] * a;
  }
  out[((static_cast<size_t>(b) * s + i) * hq + h) * DH + d] =
      __float2bfloat16(num / fmaxf(den, 1e-30f));
}

template <int DH>
cudaError_t launch_bf16(const void* q, const void* kh, const void* vh,
                        const void* ks, const void* vs, const int* hist_len,
                        void* o_part, void* m_part, void* l_part, void* out,
                        int b, int s, int c, int hq, int hkv, int ns,
                        float scale, cudaStream_t stream) {
  using tile::bf16;
  const auto* qp = static_cast<const bf16*>(q);
  const auto* khp = static_cast<const bf16*>(kh);
  const auto* vhp = static_cast<const bf16*>(vh);
  const auto* ksp = static_cast<const bf16*>(ks);
  const auto* vsp = static_cast<const bf16*>(vs);
  auto* op = static_cast<bf16*>(out);
  const float sl2 = scale * kLog2e;
  if (s > kVerifyMaxS) {
    constexpr size_t smem = chunk_smem_bytes<DH>();
    const cudaError_t chunk_attr =
        tile::allow_smem_once<chunk_bf16_kernel<DH>>(smem);
    if (chunk_attr != cudaSuccess) return chunk_attr;
    chunk_bf16_kernel<DH>
        <<<dim3(b * hq, (s + kBQ - 1) / kBQ), kThreads, smem, stream>>>(
            qp, khp, vhp, ksp, vsp, hist_len, op, s, c, hq, hkv, sl2);
    return cudaGetLastError();
  }
  if (o_part == nullptr || m_part == nullptr || l_part == nullptr ||
      ns < (c + kSplit - 1) / kSplit)
    return cudaErrorInvalidValue;
  const cudaError_t split_attr = tile::allow_smem_once<
      verify_split_kernel<DH>>(split_smem_bytes<DH>(kRowsPerBlock / 16));
  if (split_attr != cudaSuccess) return split_attr;
  const int n_rows = (hq / hkv) * s;
  const int n_rb = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const int warps = (min(n_rows, kRowsPerBlock) + 15) / 16;
  float* o = static_cast<float*>(o_part);
  float* m = static_cast<float*>(m_part);
  float* l = static_cast<float*>(l_part);
  verify_split_kernel<DH>
      <<<dim3(ns + 1, b, hkv * n_rb), warps * 32,
         split_smem_bytes<DH>(warps), stream>>>(qp, khp, vhp, ksp, vsp,
                                                hist_len, o, m, l, s, c, hq,
                                                hkv, ns, sl2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  verify_combine_kernel<DH><<<dim3(s * hq, b), DH, 0, stream>>>(
      o, m, l, hist_len, op, s, c, hq, ns);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dh(const void* q, const void* kh, const void* vh,
                      const void* ks, const void* vs, const int* hist_len,
                      void* o_part, void* m_part, void* l_part, void* out,
                      int b, int s, int c, int hq, int hkv, int ns,
                      float scale, int dtype, cudaStream_t st) {
  if (dtype == port::DT_BF16)
    return launch_bf16<DH>(q, kh, vh, ks, vs, hist_len, o_part, m_part,
                           l_part, out, b, s, c, hq, hkv, ns, scale, st);
  return launch_cuda_core<float, DH>(q, kh, vh, ks, vs, hist_len, out, b, s,
                                     c, hq, hkv, scale,
                                     Parts{kWhole, 0, nullptr, nullptr,
                                           nullptr, 0},
                                     st);
}

// The position-split passes (``Parts``) on the CUDA-core body, in the
// call's dtype, with 16-query tiles whatever S (one instantiation a
// dtype: the verify window and the chunk alike).
template <int DH>
cudaError_t launch_parts(const void* q, const void* kh, const void* vh,
                         const void* ks, const void* vs, const int* hist_len,
                         void* out, int b, int s, int c, int hq, int hkv,
                         float scale, int dtype, Parts pt, cudaStream_t st) {
  if (dtype == port::DT_BF16)
    return launch_bq<__nv_bfloat16, DH, 16>(q, kh, vh, ks, vs, hist_len, out,
                                            b, s, c, hq, hkv, scale, pt, st);
  return launch_bq<float, DH, 16>(q, kh, vh, ks, vs, hist_len, out, b, s, c,
                                  hq, hkv, scale, pt, st);
}

}  // namespace

// q, out: (b, s, hq, dh); kh, vh: (b, c, hkv, dh) history; ks, vs: (b, s,
// hkv, dh) the queries' own KV; hist_len: (b,) int32 on the device. All
// contiguous, one dtype; hq % hkv == 0, dh in {64, 96, 128} (192 in the
// PREFILL_WIDE build). bf16 with
// s <= 16 also takes the fp32 partial scratch o_part (b, hq, s, ns + 1,
// dh), m_part and l_part (b, hq, s, ns + 1) with ns = ceil(c / 128);
// otherwise those may be null.
KERNEL_EXPORT int prefill_attention_launch(
    const void* q, const void* kh, const void* vh, const void* ks,
    const void* vs, const void* hist_len, void* o_part, void* m_part,
    void* l_part, void* out, int b, int s, int c, int hq, int hkv, int dh,
    int ns, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* hl = static_cast<const int*>(hist_len);
  if (hkv < 1 || hq % hkv || s < 1 ||
      (dtype != port::DT_F32 && dtype != port::DT_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dh) {
#ifndef PREFILL_WIDE
    case 64:
      return launch_dh<64>(q, kh, vh, ks, vs, hl, o_part, m_part, l_part,
                           out, b, s, c, hq, hkv, ns, scale, dtype, st);
    case 96:
      return launch_dh<96>(q, kh, vh, ks, vs, hl, o_part, m_part, l_part,
                           out, b, s, c, hq, hkv, ns, scale, dtype, st);
    case 128:
      return launch_dh<128>(q, kh, vh, ks, vs, hl, o_part, m_part, l_part,
                            out, b, s, c, hq, hkv, ns, scale, dtype, st);
#else
    case 192:
      return launch_dh<192>(q, kh, vh, ks, vs, hl, o_part, m_part, l_part,
                            out, b, s, c, hq, hkv, ns, scale, dtype, st);
#endif
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

namespace {

int launch_parts_dh(const void* q, const void* kh, const void* vh,
                    const void* ks, const void* vs, const int* hist_len,
                    void* out, int b, int s, int c, int hq, int hkv, int dh,
                    float scale, int dtype, Parts pt, cudaStream_t st) {
  if (hkv < 1 || hq % hkv || s < 1 || pt.o == nullptr || pt.m == nullptr ||
      pt.l == nullptr || (dtype != port::DT_F32 && dtype != port::DT_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
#define PARTS_DH(D)                                                       \
  case D:                                                                 \
    return launch_parts<D>(q, kh, vh, ks, vs, hist_len, out, b, s, c, hq,  \
                           hkv, scale, dtype, pt, st);
  switch (dh) {
#ifndef PREFILL_WIDE
    PARTS_DH(64)
    PARTS_DH(96)
    PARTS_DH(128)
#else
    PARTS_DH(192)
#endif
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PARTS_DH
}

}  // namespace

// K4 over a history split by position across shards (the sequence-
// sharded chunk and verify of a mesh), in two calls. The partial: q (b,
// s, hq, dh) against this shard's history kh, vh (b, c, hkv, dh) —
// positions pos_off .. pos_off + c - 1 of the rows, valid below
// hist_len[b] (the whole rows' lengths) — into the unnormalised fp32
// partial o_part (b, hq, s, dh), m_part / l_part (b, hq, s). The
// combine: the shards' partials gathered along a part axis in shard
// order, o (b, hq, s, n_parts, dh), m / l (b, hq, s, n_parts), merged in
// that order, then the queries' own causal keys ks, vs (b, s, hkv, dh),
// into out (b, s, hq, dh). Both dtypes, dh as prefill_attention_launch.
KERNEL_EXPORT int prefill_partial_launch(
    const void* q, const void* kh, const void* vh, const void* hist_len,
    void* o_part, void* m_part, void* l_part, int b, int s, int c, int hq,
    int hkv, int dh, int pos_off, float scale, int dtype, void* stream) {
  if (c < 1 || pos_off < 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_parts_dh(
      q, kh, vh, nullptr, nullptr, static_cast<const int*>(hist_len),
      nullptr, b, s, c, hq, hkv, dh, scale, dtype,
      Parts{kHistPartial, pos_off, static_cast<float*>(o_part),
            static_cast<float*>(m_part), static_cast<float*>(l_part), 1},
      static_cast<cudaStream_t>(stream));
}

KERNEL_EXPORT int prefill_combine_launch(
    const void* q, const void* ks, const void* vs, void* o_part,
    void* m_part, void* l_part, void* out, int b, int s, int hq, int hkv,
    int dh, int n_parts, float scale, int dtype, void* stream) {
  if (n_parts < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_parts_dh(
      q, nullptr, nullptr, ks, vs, nullptr, out, b, s, 0, hq, hkv, dh, scale,
      dtype,
      Parts{kSelfCombine, 0, static_cast<float*>(o_part),
            static_cast<float*>(m_part), static_cast<float*>(l_part),
            n_parts},
      static_cast<cudaStream_t>(stream));
}
