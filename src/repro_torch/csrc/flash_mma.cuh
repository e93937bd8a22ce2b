// The mma.sync building blocks the flash-attention kernels share
// (flash_attention.cu's forward, flash_attention_bwd.cu's backward):
// cp.async copies into shared memory, ldmatrix fragment loads, the bf16
// m16n8k16 product with f32 sums, MUFU's ex2, and bf16 packing; and the
// tiling both use: row tiles (position-major over the GQA groups), the
// key tiles a q tile sees, and each warp's rows with their masks.
//
// Fragment layout of m16n8k16 (lane = 4 g4 + c4): an A operand (16 x 16)
// holds rows g4 and g4 + 8, columns 2 c4, 2 c4 + 1 and those + 8; a C
// tile (16 x 8) holds the same rows at columns 2 c4, 2 c4 + 1.  So two
// neighbouring C tiles, rounded to bf16 and packed, are an A operand
// whose k runs over their 16 columns (pack_a).
#pragma once
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG_INF = -1e30f;       // a masked score

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; bytes beyond src_bytes (0 or 16) are zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
// 4 bytes global -> shared; zeros when src_bytes is 0
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// 2**x, MUFU's approximation (relative error ~2**-22, far inside the bf16
// tolerance); flushes subnormal results to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);   // round to nearest
  return *reinterpret_cast<uint32_t*>(&h);
}
// C tiles c0 (columns 0-7) and c1 (columns 8-15) as one bf16 A operand
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}
// The same as two A operands whose sum carries 16 significant bits:
// hi = bf16(c), lo = bf16(c - hi), for products whose operand the f32
// function does not round
__device__ __forceinline__ void pack_a_split(uint32_t (&hi)[4],
                                             uint32_t (&lo)[4],
                                             const float (&c0)[4],
                                             const float (&c1)[4]) {
  const float* c[2] = {c0, c1};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x = c[i >> 1][2 * (i & 1)], y = c[i >> 1][2 * (i & 1) + 1];
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const float2 hf = __bfloat1622float2(h);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = pack_bf16(x - hf.x, y - hf.y);
  }
}
// A operand: rows r0 .. r0 + 15, columns k0 .. k0 + 15 of a row-major
// shared tile with ``stride`` elements a row
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* s, int stride,
                                       int r0, int k0, int lane) {
  ldmatrix_x4(a, s + (r0 + (lane & 15)) * stride + k0 + (lane >> 4) * 8);
}
// B operands of two n-tiles: rows n0 .. n0 + 15 of a row-major shared tile
// taken as columns (B = tile^T), k over columns k0 .. k0 + 15; b[0], b[1]
// are n-tile n0, b[2], b[3] n-tile n0 + 8
__device__ __forceinline__ void load_bt(uint32_t (&b)[4],
                                        const __nv_bfloat16* s, int stride,
                                        int n0, int k0, int lane) {
  ldmatrix_x4(b, s + (n0 + (lane >> 4) * 8 + (lane & 7)) * stride + k0 +
                     ((lane >> 3) & 1) * 8);
}
// B operands of two n-tiles: k over rows k0 .. k0 + 15 of a row-major
// shared tile, n over its columns n0 .. n0 + 15 (B = tile); b[0], b[1]
// are columns n0 .. n0 + 7, b[2], b[3] columns n0 + 8 .. n0 + 15
__device__ __forceinline__ void load_b(uint32_t (&b)[4],
                                       const __nv_bfloat16* s, int stride,
                                       int k0, int n0, int lane) {
  ldmatrix_x4_trans(b, s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               stride + n0 + (lane >> 4) * 8);
}

// ---------------------------------------------------------------------------
// Tiles of rows, and the masks by absolute position (queries at the end of
// the keys: query position t is key position Tk - Tq + t)
// ---------------------------------------------------------------------------

// Rows r0 .. r0 + N of a row-major (rows, W) bf16 matrix into a shared
// tile of ``stride`` elements a row, 16 bytes a copy by all THREADS
// threads of the block; rows at or past ``limit`` are zeros.
template <int N, int W, int THREADS>
__device__ __forceinline__ void cp_rows(__nv_bfloat16* dst, int stride,
                                        const __nv_bfloat16* src, int r0,
                                        int limit, int tid) {
  constexpr int w8 = W / 8;
  for (int idx = tid; idx < N * w8; idx += THREADS) {
    const int j = idx / w8, c = idx - j * w8;
    const int r = r0 + j;
    cp_async16(dst + j * stride + c * 8,
               src + (size_t)min(r, limit - 1) * W + c * 8,
               r < limit ? 16 : 0);
  }
}

// A GQA tile of N rows, position-major: row r is group r % G at position
// t0 + r / G of a (G, T, W) matrix; rows past ``rows`` or T are zeros.
template <int N, int W, int THREADS>
__device__ __forceinline__ void cp_gqa_rows(__nv_bfloat16* dst, int stride,
                                            const __nv_bfloat16* src, int G,
                                            int T, int t0, int rows,
                                            int tid) {
  constexpr int w8 = W / 8;
  for (int idx = tid; idx < N * w8; idx += THREADS) {
    const int r = idx / w8, c = idx - r * w8;
    const int t = t0 + r / G;
    const bool ok = r < rows && t < T;
    cp_async16(dst + r * stride + c * 8,
               src + (ok ? ((size_t)(r % G) * T + t) * W + c * 8 : 0),
               ok ? 16 : 0);
  }
}

// The tiles of BK keys that query positions t0 .. t0 + bq - 1 can see:
// {first, last}
__device__ __forceinline__ int2 key_tiles(int BK, int t0, int bq, int Tq,
                                          int Tk, int causal, int window) {
  const int q_off = Tk - Tq;
  int hi = Tk - 1, lo = 0;
  if (causal) hi = min(hi, q_off + min(t0 + bq, Tq) - 1);
  if (window > 0) lo = max(0, q_off + t0 - window + 1);
  return make_int2(lo / BK, hi / BK);
}

// A warp's 16 rows of a position-major GQA tile (rows = G * bq of them,
// from position t0) and the keys they see: this thread's two rows (g4 and
// g4 + 8) see keys [lo[h], hi[h]); a padding row sees every key.
struct WarpRows {
  int first, qlo, qhi, lo[2], hi[2];
  bool live;
  __device__ __forceinline__ WarpRows(int warp, int g4, int G, int bq,
                                      int t0, int Tq, int Tk, int causal,
                                      int window) {
    const int rows = G * bq, q_off = Tk - Tq;
    first = warp * 16;
    const int last = min(first + 15, rows - 1);
    live = first < rows && t0 + first / G < Tq;
    qlo = q_off + t0 + first / G;
    qhi = q_off + min(t0 + last / G, Tq - 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = first + g4 + 8 * h;
      const int t = t0 + r / G;
      lo[h] = 0;
      hi[h] = Tk;
      if (r < rows && t < Tq) {
        if (causal) hi[h] = min(Tk, q_off + t + 1);
        if (window > 0) lo[h] = q_off + t - window + 1;
      }
    }
  }
  // no row of the warp sees a key of the tile at kpos0
  __device__ __forceinline__ bool skip(int kpos0, int BK, int causal,
                                       int window) const {
    return !live || (causal && kpos0 > qhi) ||
           (window > 0 && kpos0 + BK - 1 <= qlo - window);
  }
  // some row of the warp misses some key of the tile: mask per element
  __device__ __forceinline__ bool edge(int kpos0, int BK, int Tk, int causal,
                                       int window) const {
    return kpos0 + BK > Tk || (causal && kpos0 + BK - 1 > qlo) ||
           (window > 0 && kpos0 <= qhi - window);
  }
  __device__ __forceinline__ bool sees(int h, int kp) const {
    return kp >= lo[h] && kp < hi[h];
  }
};

}  // namespace flash
