// The bf16 tile body shared by the flash prefill (K3) and the prefill-
// over-cache (K4) kernels: one warp owns 16 query rows; S = Q K^T and
// O += P V run on the tensor cores as mma.sync m16n8k16 (bf16 operands,
// fp32 accumulators), operands come from shared memory through ldmatrix
// (ldmatrix.trans for V), and tiles are staged by 16-byte cp.async.
//
// Register layout (FlashAttention-2): the S accumulator of an 8-key
// n-tile holds, in lane (g = lane / 4, t = lane % 4), rows g and g + 8 at
// keys 2t and 2t + 1 — exactly the A-operand layout of the P V product
// over 16 keys, so P goes from the S fragment to the A fragment by a
// bf16 conversion in registers, never through shared memory. m, l and
// the output accumulator stay fp32. Scores carry the softmax scale and
// log2(e) (applied in fp32, after the product) so the softmax uses
// exp2f; masked scores are the finite NEG_INF of common.cuh.
//
// Shared-memory rows are DH + 8 bf16 long: the 16-byte pad moves the 8
// rows one ldmatrix phase reads onto 8 different 16-byte bank groups at
// DH 64, 96 and 128, so no load conflicts.
#pragma once

#include "common.cuh"

namespace tile {

using bf16 = __nv_bfloat16;

constexpr int kPad = 8;  // bf16 elements of padding per shared row

template <int DH>
struct Dims {
  static_assert(DH % 16 == 0, "head dim must be a multiple of 16");
  static constexpr int LD = DH + kPad;   // shared row length (elements)
  static constexpr int KS = DH / 16;     // k-steps of Q K^T
  static constexpr int NT = DH / 8;      // 8-wide n-tiles of the output
  static constexpr int CHUNKS = DH / 8;  // 16-byte chunks per row
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; ``src == nullptr`` zero-fills (src-size
// 0 reads nothing), so rows past a valid length arrive as zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           const void* any_valid) {
  const int n = src != nullptr ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src != nullptr ? src : any_valid), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col); bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage ``rows`` rows of DH bf16 into shared memory (row stride LD) with
// 16-byte cp.async, all threads of the block taking chunks in turn.
// ``row_ptr(r)`` gives row r's global address, or nullptr for a row to
// zero-fill. The caller commits the group.
template <int DH, typename RowPtr>
__device__ __forceinline__ void stage_rows(bf16* dst, int rows,
                                           RowPtr row_ptr,
                                           const void* any_valid) {
  using D = Dims<DH>;
  for (int idx = threadIdx.x; idx < rows * D::CHUNKS; idx += blockDim.x) {
    const int r = idx / D::CHUNKS, c = idx % D::CHUNKS;
    const bf16* src = row_ptr(r);
    cp_async16(dst + r * D::LD + c * 8, src != nullptr ? src + c * 8 : nullptr,
               any_valid);
  }
}

// One warp's online-softmax state over its 16 query rows: q fragments
// (A operands, loaded once), output accumulator, and m / l of rows g
// and g + 8 (l is this lane's partial sum until ``finish``).
template <int DH>
struct Rows16 {
  uint32_t q[Dims<DH>::KS][4];
  float o[Dims<DH>::NT][4];
  float m[2], l[2];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int n = 0; n < Dims<DH>::NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    m[0] = m[1] = port::NEG_INF;
    l[0] = l[1] = 0.f;
  }

  // A fragments of the warp's 16 rows of a staged Q tile (row stride LD).
  __device__ __forceinline__ void load_q(const bf16* qs) {
    const int lane = threadIdx.x & 31;
    const uint32_t base = smem_addr(qs);
    const int row = lane & 15, col = (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < Dims<DH>::KS; ++kk)
      ldsm_x4(q[kk], base + ((row * Dims<DH>::LD) + kk * 16 + col) * 2);
  }

  // Softmax over one staged tile of BK keys (K and V, row stride LD).
  // ``masked`` is uniform over the block; when set, ``ok(r, j)`` says
  // whether local row r (0..15) sees key j (0..BK-1) of the tile.
  template <int BK, typename Ok>
  __device__ __forceinline__ void attend(const bf16* ks, const bf16* vs,
                                         float scale_log2, bool masked,
                                         Ok ok) {
    using D = Dims<DH>;
    constexpr int SNT = BK / 8;  // 8-key n-tiles of S
    static_assert(BK % 16 == 0, "key tile must be a multiple of 16");
    const int lane = threadIdx.x & 31, g = lane >> 2, t2 = (lane & 3) * 2;

    float s[SNT][4];
#pragma unroll
    for (int n = 0; n < SNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    {
      // x4 matrices: (keys 0-7, dims 0-7), (0-7, 8-15), (8-15, 0-7),
      // (8-15, 8-15) of a 16-key x 16-dim block -> b0/b1 of two n-tiles
      const uint32_t base = smem_addr(ks);
      const int krow = (lane & 7) + ((lane >> 4) & 1) * 8;
      const int kcol = ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < D::KS; ++kk)
#pragma unroll
        for (int np = 0; np < SNT / 2; ++np) {
          uint32_t b[4];
          ldsm_x4(b, base + ((np * 16 + krow) * D::LD + kk * 16 + kcol) * 2);
          mma_bf16(s[2 * np], q[kk], b[0], b[1]);
          mma_bf16(s[2 * np + 1], q[kk], b[2], b[3]);
        }
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < SNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = s[n][e] * scale_log2;
        if (masked && !ok(g + (e >> 1) * 8, n * 8 + t2 + (e & 1)))
          v = port::NEG_INF;
        s[n][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float alpha = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= alpha;
#pragma unroll
      for (int n = 0; n < D::NT; ++n) {
        o[n][2 * h] *= alpha;
        o[n][2 * h + 1] *= alpha;
      }
    }
#pragma unroll
    for (int n = 0; n < SNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - mx[e >> 1]);
        s[n][e] = p;
        l[e >> 1] += p;
      }

    // O += P V: x4.trans matrices (keys 0-7, dims 0-7), (8-15, 0-7),
    // (0-7, 8-15), (8-15, 8-15) -> b0/b1 of two 8-dim n-tiles
    const uint32_t base = smem_addr(vs);
    const int vrow = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int vcol = ((lane >> 4) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D::NT / 2; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b,
                      base + ((kk * 16 + vrow) * D::LD + dp * 16 + vcol) * 2);
        mma_bf16(o[2 * dp], a, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
      }
    }
  }

  // Sum l over the row's four lanes (call once, after the last tile).
  __device__ __forceinline__ void finish() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
  }

  // Write the normalised rows: ``row_out(r)`` is local row r's output
  // (DH bf16), or nullptr for a row past the valid ones.
  template <typename RowOut>
  __device__ __forceinline__ void store(RowOut row_out) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      bf16* dst = row_out(g + h * 8);
      if (dst == nullptr) continue;
      const float inv = 1.f / fmaxf(l[h], 1e-30f);
#pragma unroll
      for (int n = 0; n < Dims<DH>::NT; ++n)
        *reinterpret_cast<uint32_t*>(dst + n * 8 + t2) =
            pack_bf16(o[n][2 * h] * inv, o[n][2 * h + 1] * inv);
    }
  }
};

// Allow a kernel more than 48 KiB of dynamic shared memory (once per
// instantiation); returns the CUDA error, if any.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace tile
