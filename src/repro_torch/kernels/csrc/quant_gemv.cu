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
// weight: at the decode path's B = 1 that is 3.8 flops per byte, below
// the CUDA cores' ~20 fp32 flops per byte. (At B = 8 it is 30 flops per
// byte: there the tensor cores are the cure, in a later PR.)
//
// Design, for streaming int4 at the card's memory rate:
// - Loads. A lane reads 16 bytes of one packed row (16 columns x 2 K
//   rows, 32 weights) through the read-only path; 8 lanes cover a
//   128-column strip (one 128-byte line per row) and the 4 lane rows of
//   a warp read 4 packed rows at once. Each lane keeps 8 such loads in
//   flight before it uses the first; on the tensor cores a warp's first
//   8 are issued before x is staged, so the two overlap. An N that is
//   not a multiple of 16 takes 1-byte loads and a strip of 8 columns,
//   so the ragged edge is masked per lane.
// - Dequantisation without int -> float conversions. bf16 x (the W4
//   decode path) with N and the group multiples of 16 runs on the
//   tensor cores: a byte permute and one LOP3 turn a byte's two nibbles
//   into the bf16 pair 128 + (v ^ 8), one bf16x2 FMA subtracts 136 —
//   exact, the int4 values -8..7 — and those are the A operand of
//   mma.sync m16n8k16 (the 8 n columns are up to 8 x rows; the
//   fragment's K pairs are a byte's two nibbles, its M rows the lane's
//   16 columns), x the B operand, products exact in fp32, summed in fp32
//   per unit, then times the group's fp32 scale. float32 x, a ragged N
//   or a group that is not a multiple of 16 runs on the CUDA cores: the
//   biased nibble placed in the mantissa of 2^23 by one byte permute
//   (0x4B0000xx) minus 2^23 + 8 in fp32 — exact — times the scale and an
//   fp32 FMA with x, as the reference's ``_kernel``.
// - Work split. One block of 4 warps per (column strip, K split, tile
//   of x rows: up to 8 on the tensor cores, 4 on the CUDA cores). K is
//   cut into units of ``unit`` rows, each inside one group: the whole
//   group, unless 4 warps' x of it would outgrow what a block stages
//   (then the largest divisor of the group that fits). A K split is
//   4 x gpw whole units, gpw per warp. Any even group runs: the
//   tensor cores take groups that are multiples of 16 (in batches of 4,
//   2 or 1 16-K tiles), the CUDA cores the rest (a lane row's packed
//   rows in batches of 8, the last batch masked).
//   x for the block's K range is staged once in shared memory as fp32.
//   On the CUDA cores a warp sums its 4 lane rows by shuffles; the block
//   adds its 4 warps in warp order through shared memory.
// - Across blocks, one launch. With one split the block writes the
//   output. Otherwise each block writes its split's fp32 partial, then
//   takes a ticket from a per-(strip, row tile) counter; the block that
//   draws the last ticket adds all splits in split order, writes the
//   output and resets the counter to 0 for the next call. The ticket
//   only says who adds, never in what order, so the result is the same
//   bits on every run.
#include "flash_tile.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowLanes = 4;   // packed rows a warp reads at once
constexpr int kColLanes = 8;   // lanes along N on one packed row
constexpr int kUnroll = 8;     // weight loads in flight per lane
constexpr int kMaxXFloats = 8192;  // x values staged per block (32 KB)
constexpr int kMmaRows = 8;    // x rows of a tensor-core tile (mma's N)

template <int V>
struct Vec4 {  // 32-bit words in a V-byte load, columns per word
  static constexpr int W = V == 16 ? 4 : 1;
  static constexpr int C = V == 16 ? 4 : 1;
};

// V consecutive packed bytes (V-byte aligned) through the read-only path
template <int V>
__device__ __forceinline__ void load_w(const uint8_t* p,
                                       uint32_t (&w)[Vec4<V>::W]) {
  if constexpr (V == 16) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = r.x, w[1] = r.y, w[2] = r.z, w[3] = r.w;
  } else {
    static_assert(V == 1, "1- or 16-byte loads");
    w[0] = __ldg(p);
  }
}

// Division of a unit index by the units a group holds, a run-time value,
// without a divide: nvcc builds ``/`` by a run-time int from I2F, MUFU.RCP
// and F2I. q = (umulhi(g, m) + g) >> s with m and s set on the host
// (round-up reciprocal), exact for 0 <= g < 2^31; a group of one unit
// (every group that fits a block's stage) has m = 1, s = 0 and q = g.
struct UnitsPerGroup {
  unsigned m;
  int s;
  __device__ __forceinline__ int group_of(int g) const {
    return static_cast<int>((__umulhi(static_cast<unsigned>(g), m) +
                             static_cast<unsigned>(g)) >> s);
  }
};

inline UnitsPerGroup units_per_group(int upg) {
  int s = 0;
  while ((1u << s) < static_cast<unsigned>(upg)) ++s;
  const unsigned long long m =
      ((1ull << 32) * ((1ull << s) - static_cast<unsigned>(upg))) / upg + 1;
  return {static_cast<unsigned>(m), s};
}

// The signed value of byte e's biased nibble (v ^ 8 in 0..15) as fp32:
// 0x4B0000xx is 2^23 + xx, exactly (e is a constant after unrolling).
__device__ __forceinline__ float nibble_f(uint32_t biased, int e) {
  return __int_as_float(static_cast<int>(
             __byte_perm(biased, 0x4B00u, 0x5440u | e))) -
         8388616.f;  // 2^23 + 8
}

// The block's end: ``red`` holds each warp's sums, [kWarps][rs][SC]
// (x row, strip column); add them in warp order and write the output
// (one split) or this split's partial, and then, in the strip's last
// block to finish, the sum of all splits in split order.
template <typename T, int SC>
__device__ __forceinline__ void finish_block(
    const float* red, int rs, int rows, int r0, int strip, int split,
    int b, int n, int ns, float* __restrict__ part,
    int* __restrict__ tickets, T* __restrict__ out) {
  const int tid = threadIdx.x;
  for (int i = tid; i < rows * SC; i += kThreads) {
    const int r = i / SC, c = i % SC, column = strip * SC + c;
    if (column >= n) continue;
    float v = red[r * SC + c];
#pragma unroll
    for (int wi = 1; wi < kWarps; ++wi) v += red[(wi * rs + r) * SC + c];
    const size_t o = static_cast<size_t>(r0 + r) * n + column;
    if (ns == 1)
      out[o] = port::from_f<T>(v);
    else
      part[static_cast<size_t>(split) * b * n + o] = v;
  }
  if (ns == 1) return;

  // the last block of this (strip, row tile) to finish adds the splits
  __shared__ int last;
  __threadfence();  // this block's partials are visible card-wide
  __syncthreads();
  int* ticket = tickets + blockIdx.z * gridDim.x + strip;
  if (tid == 0) last = atomicAdd(ticket, 1) == ns - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = tid; i < rows * SC; i += kThreads) {
    const int r = i / SC, c = i % SC, column = strip * SC + c;
    if (column >= n) continue;
    const size_t o = static_cast<size_t>(r0 + r) * n + column;
    float v = 0.f;
    for (int sp = 0; sp < ns; ++sp)
      v += __ldcg(part + static_cast<size_t>(sp) * b * n + o);
    out[o] = port::from_f<T>(v);
  }
  if (tid == 0) *ticket = 0;
}

// CUDA-core body: float32 x, an N or a group that is not a multiple of
// 16. TAIL: a unit that is not a multiple of 64 rows, so a lane row's
// packed rows do not fill whole batches of 8: the last batch is masked.
template <typename T, int R, int V, bool TAIL>
__global__ void __launch_bounds__(kThreads)
    quant_gemv_kernel(const T* __restrict__ x, const uint8_t* __restrict__ wp,
                      const float* __restrict__ scales,
                      float* __restrict__ part, int* __restrict__ tickets,
                      T* __restrict__ out, int b, int k, int n, int unit,
                      UnitsPerGroup upg, int ng, int gpw, int ns) {
  constexpr int NW = Vec4<V>::W, CW = Vec4<V>::C;
  constexpr int SC = kColLanes * V;  // columns of a strip
  extern __shared__ float smem[];
  const int strip = blockIdx.x, split = blockIdx.y;
  const int r0 = blockIdx.z * R;
  const int rows = min(R, b - r0);
  const int g_blk = split * kWarps * gpw;
  const int g_end = min(g_blk + kWarps * gpw, ng);
  const int kcap = kWarps * gpw * unit;  // x row stride in shared memory
  const int kspan = (g_end - g_blk) * unit;
  float* xs = smem;              // [R][kcap] x of the block's K range
  float* red = xs + R * kcap;    // [kWarps][R][SC] per-warp sums
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int r = 0; r < R; ++r)
    for (int j = tid; j < kspan; j += kThreads)
      xs[r * kcap + j] =
          r < rows ? port::to_f(x[static_cast<size_t>(r0 + r) * k +
                                  static_cast<size_t>(g_blk) * unit + j])
                   : 0.f;
  __syncthreads();

  const int rl = lane / kColLanes, cl = lane % kColLanes;
  const int col = strip * SC + cl * V;
  float acc[R][V];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < V; ++c) acc[r][c] = 0.f;

  if (col < n) {
    const int half = unit >> 1;              // packed rows per unit
    // packed rows rl, rl + 4, ... of the unit fall to this lane row (a
    // multiple of kUnroll unless TAIL)
    const int per_lane = (half - rl + kRowLanes - 1) / kRowLanes;
    const int gw0 = g_blk + warp * gpw, gw1 = min(gw0 + gpw, g_end);
    for (int g = gw0; g < gw1; ++g) {
      float s[V];
      const float* sg =
          scales + static_cast<size_t>(upg.group_of(g)) * n + col;
      if constexpr (V == 16) {
#pragma unroll
        for (int c = 0; c < V; c += 4) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(sg + c));
          s[c] = v.x, s[c + 1] = v.y, s[c + 2] = v.z, s[c + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < V; ++c) s[c] = __ldg(sg + c);
      }
      const uint8_t* wg =
          wp + (static_cast<size_t>(g) * half + rl) * n + col;
      const float* xg = xs + (g - g_blk) * unit + 2 * rl;
      for (int i0 = 0; i0 < per_lane; i0 += kUnroll) {
        uint32_t w[kUnroll][NW];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (!TAIL || i0 + u < per_lane)
            load_w<V>(wg + static_cast<size_t>(i0 + u) * kRowLanes * n,
                      w[u]);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (TAIL && i0 + u >= per_lane) continue;
          // K rows 2p and 2p + 1 of packed row p = rl + 4 (i0 + u)
          const int kk = 2 * kRowLanes * (i0 + u);
          float x0[R], x1[R];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float2 v =
                *reinterpret_cast<const float2*>(xg + r * kcap + kk);
            x0[r] = v.x, x1[r] = v.y;
          }
#pragma unroll
          for (int j = 0; j < NW; ++j) {
            const uint32_t lo = (w[u][j] & 0x0F0F0F0Fu) ^ 0x08080808u;
            const uint32_t hi = ((w[u][j] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
            for (int e = 0; e < CW; ++e) {
              const int c = j * 4 + e;
              const float w0 = nibble_f(lo, e) * s[c];
              const float w1 = nibble_f(hi, e) * s[c];
#pragma unroll
              for (int r = 0; r < R; ++r) {
                acc[r][c] = fmaf(x0[r], w0, acc[r][c]);
                acc[r][c] = fmaf(x1[r], w1, acc[r][c]);
              }
            }
          }
        }
      }
    }
  }

  // the warp's 4 lane rows, in fixed order
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < V; ++c) {
      acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], 8);
      acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], 16);
    }
  if (rl == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < V; ++c)
        red[(warp * R + r) * SC + cl * V + c] = acc[r][c];
  }
  __syncthreads();
  finish_block<T, SC>(red, R, rows, r0, strip, split, b, n, ns, part,
                      tickets, out);
}

// Byte c (0..15) of a lane's 16-byte load — one column, K rows 2p and
// 2p + 1 in its nibbles — as the bf16 pair (v_lo, v_hi), exactly:
// (q & 0x000F000F) ^ 0x43084308 is bf16 128 + (v ^ 8) in each half, and
// the FMA subtracts 136.
__device__ __forceinline__ uint32_t nibble_pair_bf16(const uint32_t (&w)[4],
                                                     const uint32_t (&ws)[4],
                                                     int c) {
  const int word = c >> 2, e = c & 3;
  const uint32_t q = __byte_perm(w[word], ws[word], e | ((4 + e) << 8));
  const uint32_t biased = (q & 0x000F000Fu) ^ 0x43084308u;
  uint32_t v;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(v)
      : "r"(biased), "r"(0x3F803F80u), "r"(0xC308C308u));  // x 1 - 136
  return v;
}

// Tensor-core body: bf16 x, N and the unit multiples of 16, up to 8 x
// rows per tile; TILES 16-K tiles per batch of loads (4, or 2 or 1 where
// the unit holds no multiple of 4 tiles).
// Lane (g8, t) = (lane / 4, lane % 4) loads packed rows t and t + 4 of
// each 16-K tile at its 16 columns — the A fragments of 8 mma tiles,
// mma j taking columns 2j (M row g8) and 2j + 1 (M row g8 + 8) — and x
// rows g8 at K pairs 2t and 2t + 8 as the B fragment.
template <int TILES>
__global__ void __launch_bounds__(kThreads)
    quant_mma_kernel(const __nv_bfloat16* __restrict__ x,
                     const uint8_t* __restrict__ wp,
                     const float* __restrict__ scales,
                     float* __restrict__ part, int* __restrict__ tickets,
                     __nv_bfloat16* __restrict__ out, int b, int k, int n,
                     int unit, UnitsPerGroup upg, int ng, int gpw,
                     int ns) {
  constexpr int SC = kColLanes * 16;  // 128 columns of a strip
  extern __shared__ float smem[];
  const int strip = blockIdx.x, split = blockIdx.y;
  const int r0 = blockIdx.z * kMmaRows;
  const int rows = min(kMmaRows, b - r0);
  const int g_blk = split * kWarps * gpw;
  const int g_end = min(g_blk + kWarps * gpw, ng);
  // x as bf16 pairs, rows padded by 4 words: the 8 x rows one B-fragment
  // load reads fall on distinct banks
  const int xld = ((kWarps * gpw * unit) >> 1) + 4;
  const int kspan = ((g_end - g_blk) * unit) >> 1;  // pairs per row
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem);  // [rows][xld]
  float* red = smem + rows * xld;                    // [kWarps][rows][SC]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const int g8 = lane >> 2, t = lane & 3;
  const int col = strip * SC + g8 * 16;
  // mma.sync needs the whole warp: lanes past N (a ragged last strip)
  // take part with zero weights and scales and write nothing
  const bool col_ok = col < n;
  const int half = unit >> 1;
  const int gw0 = g_blk + warp * gpw, gw1 = min(gw0 + gpw, g_end);
  uint32_t w[TILES][2][4];
  float s[16];
  auto load_batch = [&](int g, int kt0) {
    const uint8_t* wg = wp + (static_cast<size_t>(g) * half + t) * n + col;
#pragma unroll
    for (int u = 0; u < TILES; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (col_ok)
          load_w<16>(wg + static_cast<size_t>((kt0 + u) * 8 + 4 * h) * n,
                     w[u][h]);
        else  // byte 0x00 dequantizes to (0 ^ 8) - 8 = 0
          w[u][h][0] = w[u][h][1] = w[u][h][2] = w[u][h][3] = 0u;
      }
  };
  auto load_scales = [&](int g) {
    const float* sg =
        scales + static_cast<size_t>(upg.group_of(g)) * n + col;
#pragma unroll
    for (int c = 0; c < 16; c += 4) {
      const float4 v = col_ok ? __ldg(reinterpret_cast<const float4*>(sg + c))
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      s[c] = v.x, s[c + 1] = v.y, s[c + 2] = v.z, s[c + 3] = v.w;
    }
  };

  // the warp's first weights are in flight while x is staged
  if (gw0 < gw1) {
    load_scales(gw0);
    load_batch(gw0, 0);
  }
  for (int r = 0; r < rows; ++r) {
    const uint32_t* xr = reinterpret_cast<const uint32_t*>(
        x + static_cast<size_t>(r0 + r) * k +
        static_cast<size_t>(g_blk) * unit);
    for (int j = tid; j < kspan; j += kThreads) xs[r * xld + j] = xr[j];
  }
  __syncthreads();

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int g = gw0; g < gw1; ++g) {
    if (g != gw0) load_scales(g);
    float accg[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) accg[j][e] = 0.f;
    const uint32_t* xg = xs + g8 * xld + (g - g_blk) * half + t;
    for (int kt0 = 0; kt0 < (unit >> 4); kt0 += TILES) {
      if (g != gw0 || kt0 != 0) load_batch(g, kt0);
#pragma unroll
      for (int u = 0; u < TILES; ++u) {
        uint32_t b0 = 0, b1 = 0;
        if (g8 < rows) {
          b0 = xg[(kt0 + u) * 8];
          b1 = xg[(kt0 + u) * 8 + 4];
        }
        uint32_t ws[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < 4; ++i) ws[h][i] = w[u][h][i] >> 4;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t a[4] = {nibble_pair_bf16(w[u][0], ws[0], 2 * j),
                                 nibble_pair_bf16(w[u][0], ws[0], 2 * j + 1),
                                 nibble_pair_bf16(w[u][1], ws[1], 2 * j),
                                 nibble_pair_bf16(w[u][1], ws[1], 2 * j + 1)};
          tile::mma_bf16(accg[j], a, b0, b1);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[j][e] = fmaf(s[2 * j + (e >> 1)], accg[j][e], acc[j][e]);
  }

  // d[j][e]: column 16 g8 + 2j + e / 2, x row 2t + e % 2
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 2 * t + (e & 1);
      if (r < rows)
        red[(warp * rows + r) * SC + g8 * 16 + 2 * j + (e >> 1)] =
            acc[j][e];
    }
  __syncthreads();
  finish_block<__nv_bfloat16, SC>(red, rows, rows, r0, strip, split, b, n,
                                  ns, part, tickets, out);
}

template <typename T, int R, int V>
cudaError_t launch_rv(const void* x, const void* wp, const void* scales,
                      float* part, int* tickets, void* out, int b, int k,
                      int n, int group, int unit, int gpw, int ns,
                      cudaStream_t stream) {
  const dim3 grid((n + kColLanes * V - 1) / (kColLanes * V), ns,
                  (b + R - 1) / R);
  const size_t smem =
      sizeof(float) * (R * kWarps * gpw * unit + kWarps * R * kColLanes * V);
  auto kernel = unit % (2 * kRowLanes * kUnroll)
                    ? quant_gemv_kernel<T, R, V, true>
                    : quant_gemv_kernel<T, R, V, false>;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(wp),
      static_cast<const float*>(scales), part, tickets, static_cast<T*>(out),
      b, k, n, unit, units_per_group(group / unit), k / unit, gpw, ns);
  return cudaGetLastError();
}

template <int TILES>
cudaError_t launch_mma_t(const void* x, const void* wp, const void* scales,
                         float* part, int* tickets, void* out, int b, int k,
                         int n, int group, int unit, int gpw, int ns,
                         cudaStream_t stream) {
  const dim3 grid((n + kColLanes * 16 - 1) / (kColLanes * 16), ns,
                  (b + kMmaRows - 1) / kMmaRows);
  const int rows = min(b, kMmaRows);
  const size_t smem =
      sizeof(float) * (rows * ((kWarps * gpw * unit) / 2 + 4) +
                       kWarps * rows * kColLanes * 16);
  quant_mma_kernel<TILES><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(wp),
      static_cast<const float*>(scales), part, tickets,
      static_cast<__nv_bfloat16*>(out), b, k, n, unit,
      units_per_group(group / unit), k / unit, gpw, ns);
  return cudaGetLastError();
}

cudaError_t launch_mma(const void* x, const void* wp, const void* scales,
                       float* part, int* tickets, void* out, int b, int k,
                       int n, int group, int unit, int gpw, int ns,
                       cudaStream_t s) {
  const int tiles = unit >> 4;
  if (tiles % 4 == 0)
    return launch_mma_t<4>(x, wp, scales, part, tickets, out, b, k, n, group,
                           unit, gpw, ns, s);
  if (tiles % 2 == 0)
    return launch_mma_t<2>(x, wp, scales, part, tickets, out, b, k, n, group,
                           unit, gpw, ns, s);
  return launch_mma_t<1>(x, wp, scales, part, tickets, out, b, k, n, group,
                         unit, gpw, ns, s);
}

template <typename T, int R>
cudaError_t launch_r(int vec, const void* x, const void* wp,
                     const void* scales, float* part, int* tickets, void* out,
                     int b, int k, int n, int group, int unit, int gpw,
                     int ns, cudaStream_t s) {
  if (vec == 16)
    return launch_rv<T, R, 16>(x, wp, scales, part, tickets, out, b, k, n,
                               group, unit, gpw, ns, s);
  return launch_rv<T, R, 1>(x, wp, scales, part, tickets, out, b, k, n,
                            group, unit, gpw, ns, s);
}

template <typename T>
cudaError_t launch(int rows, int vec, const void* x, const void* wp,
                   const void* scales, float* part, int* tickets, void* out,
                   int b, int k, int n, int group, int unit, int gpw, int ns,
                   cudaStream_t s) {
  if (rows == 1)
    return launch_r<T, 1>(vec, x, wp, scales, part, tickets, out, b, k, n,
                          group, unit, gpw, ns, s);
  if (rows == 2)
    return launch_r<T, 2>(vec, x, wp, scales, part, tickets, out, b, k, n,
                          group, unit, gpw, ns, s);
  return launch_r<T, 4>(vec, x, wp, scales, part, tickets, out, b, k, n,
                        group, unit, gpw, ns, s);
}

}  // namespace

// x, out: (b, k) and (b, n) of one dtype; wp: (k / 2, n) uint8; scales:
// (k / group, n) fp32, group even and dividing k. The launch plan
// (quant_gemv.py::launch_plan): ``unit`` K rows per piece (even, dividing
// the group), ``vec`` bytes per weight load (16 where it divides n, else
// 1), ``rows`` x rows per block (8 on the tensor cores — bf16 with vec 16
// and unit % 16 == 0 — else 1, 2 or 4), ``gpw`` units per warp and ``ns``
// = ceil((k / unit) / (4 gpw)) K splits. With ns > 1, ``part`` is (ns, b,
// n) fp32 scratch and ``tickets`` ceil(n / (8 vec)) * ceil(b / rows)
// int32 counters, all 0 (each call leaves them 0). Pointers 16-byte
// aligned.
KERNEL_EXPORT int quant_gemv_launch(const void* x, const void* wp,
                                    const void* scales, void* part,
                                    void* tickets, void* out, int b, int k,
                                    int n, int group, int unit, int vec,
                                    int rows, int gpw, int ns, int dtype,
                                    void* stream) {
  const bool unit_ok = group >= 2 && group % 2 == 0 && k % group == 0 &&
                       unit >= 2 && unit % 2 == 0 && group % unit == 0;
  const int ng = unit_ok ? k / unit : 0;
  const bool mma =
      dtype == port::DT_BF16 && vec == 16 && group % 16 == 0;
  if (b < 1 || n < 1 || !unit_ok || ng < 1 || (vec != 16 && vec != 1) ||
      n % vec || (mma && unit % 16) ||
      (mma ? rows != kMmaRows : rows != 1 && rows != 2 && rows != 4) ||
      gpw < 1 || rows * kWarps * gpw * unit > kMaxXFloats ||
      ns != (ng + kWarps * gpw - 1) / (kWarps * gpw) ||
      (ns > 1 && (part == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(part);
  int* tk = static_cast<int*>(tickets);
  if (mma)
    return launch_mma(x, wp, scales, pt, tk, out, b, k, n, group, unit, gpw,
                      ns, s);
  if (dtype == port::DT_F32)
    return launch<float>(rows, vec, x, wp, scales, pt, tk, out, b, k, n,
                         group, unit, gpw, ns, s);
  if (dtype == port::DT_BF16)
    return launch<__nv_bfloat16>(rows, vec, x, wp, scales, pt, tk, out, b,
                                 k, n, group, unit, gpw, ns, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
