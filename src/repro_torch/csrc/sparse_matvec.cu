// Bitmap-packed sparse matmul on the int8 tensor cores, for sm_90a:
// x (M, K) int8 @ W (K, N) -> int32 (M, N), exact, W given as bitmap
// (K/8, N) uint8 + values (keep_k, N) int8 (the nonzero codes of each
// column in ascending row order; K % 8 == 0).
//
// Replaces sparse_matvec_pallas (src/repro/kernels/sparse_matvec.py:55),
// which expands each K chunk of the bitmap in VMEM with a running
// per-column nonzero count and feeds the MXU; the port returns the int32
// product and the caller applies the column scale.
//
// What bounds it on an H100: at the LM's prefill widths (M = 1024) the
// int32 output write (4 M N bytes over 3.35 TB/s: 3.7 us at 960 -> 2560);
// at the CNN head (M = 2) and LM decode (M = 4) the packed weight bytes
// (K/8 + keep_k per column: about 0.2 us at the head).  The int8 MACs
// (1,979 TOP/s dense) bound neither.
//
// Design: one block of 8 warps owns a 64-column tile of the output and
// walks K in chunks of 128 rows.  Per chunk the x tile comes in by
// cp.async (8-byte copies, so any K % 8 == 0 row is aligned; the tail of
// the last chunk is zero-filled) while the block expands the weights: the
// chunk's 16 bitmap bytes per column are staged in shared memory, and one
// thread per (column, bitmap word = 32 K rows) finds where the word's
// codes start in the column's packed values -- the column's nonzeros
// before the chunk, carried from chunk to chunk, plus a popcount of the
// words before it -- gathers them (a pointer stepping N bytes per code)
// and writes 32 bytes of a shared [n][k] tile, K-contiguous per column:
// the "col" B operand of mma.sync.m16n8k32.s8.s8.s32 as is (ldmatrix,
// rows padded by 16 bytes so no bank is read twice).  Integer sums do not
// depend on order, so every variant is bit-exact.  The wrapper's rule
// (kernels/sparse_matvec.py ``plan``) picks the variant and the split:
//   rows  (M >= 17): a block covers 256 rows; warp w owns rows 32 w..+31
//         (two m16 tiles sharing each B fragment) and all 64 columns.
//   split (M <= 16): a block covers one m16 tile, rows past M masked;
//         warp w takes k32 step w % 4 of columns 32 (w / 4)..+31, and
//         the four steps' partial sums are added in shared memory.
// Either may split K over grid.z (``splits`` ranges of ``chunks_per``
// chunks) so that the grid fills 132 SMs where the tiles alone do not
// (16 column tiles at N = 1000); a split finds its start in each column's
// values by a popcount of the bitmap bytes before it (loads unrolled, in
// flight with the first chunk's), and the splits add into a zeroed output
// with atomicAdd (exact: integer addition).  The `keep_k` clamp of the
// plain version is kept: a code past the column's keep_k values reads the
// last one.  Every phase of a chunk (bitmap, gathers, x, MMAs) waits on
// one memory latency, and one or two blocks share an SM at the served
// prefill shapes, so the kernel sits well above its bound (PERF.md).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BN = 64;                  // output columns per block
constexpr int KC = 128;                 // K rows per chunk
constexpr int KB = KC / 8;              // bitmap bytes per column per chunk
constexpr int XS = KC + 16;             // padded shared row stride, bytes
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int ROW_TILES = 2;            // rows variant: 32 rows per warp
static_assert(THREADS == BN * KB / 4 && THREADS == 4 * BN,
              "one thread per (column, bitmap word); four per column");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 8 bytes global -> shared; zeros where src_bytes is 0
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// c (16x8 s32) += a (16x32 s8, row) * b (32x8 s8, col)
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool SPLIT>
__global__ void __launch_bounds__(THREADS)
sparse_mma_kernel(const int8_t* __restrict__ x,
                  const uint8_t* __restrict__ bitmap,
                  const int8_t* __restrict__ values,
                  int32_t* __restrict__ out, int M, int K, int N, int keep_k,
                  int chunks_per, int atomic) {
  constexpr int RT = SPLIT ? 1 : ROW_TILES;     // m16 tiles per warp
  constexpr int MT = SPLIT ? 16 : 16 * RT * WARPS;  // rows per block
  constexpr int NT = SPLIT ? 4 : 8;             // n8 tiles per warp
  extern __shared__ __align__(16) int8_t x_dyn[];
  int8_t(*x_s)[XS] = reinterpret_cast<int8_t(*)[XS]>(x_dyn);  // [MT][XS]
  __shared__ __align__(16) int8_t w_s[BN][XS];  // expanded codes, [n][k]
  // the chunk's bitmap, [n][byte], rows padded to 5 words (no bank twice)
  __shared__ __align__(4) uint8_t bm_s[BN][KB + 4];
  __shared__ int base_s[BN];                    // nonzeros before the chunk
  __shared__ int part_s[THREADS / BN][BN];
  __shared__ int red_s[SPLIT ? 4 : 1][SPLIT ? MT * BN : 1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, c4 = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * MT;
  const int kb8 = K / 8;
  const int n_chunks = (K + KC - 1) / KC;
  const int c_lo = blockIdx.z * chunks_per;
  const int c_hi = min(c_lo + chunks_per, n_chunks);

  int acc[RT][NT][4];
#pragma unroll
  for (int t = 0; t < RT; ++t)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0;

  for (int c = c_lo; c < c_hi; ++c) {
    const int k0 = c * KC;
    // ---- x tile (async), 8 bytes per copy --------------------------------
    for (int idx = tid; idx < MT * (KC / 8); idx += THREADS) {
      const int r = idx / (KC / 8), s8 = idx - r * (KC / 8);
      const int m = m0 + r, kk = k0 + s8 * 8;
      const bool ok = m < M && kk < K;
      cp_async8(&x_s[r][s8 * 8], ok ? x + (size_t)m * K + kk : x, ok ? 8 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    // ---- the chunk's bitmap bytes: loaded first, stored last, so that the
    // split's prefix loads are in flight with them --------------------------
    uint8_t bm_r[KB * BN / THREADS];
#pragma unroll
    for (int i = 0; i < KB * BN / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int b = idx / BN, col = idx - b * BN;
      const int r8 = c * KB + b, n = n0 + col;
      bm_r[i] = (r8 < kb8 && n < N) ? __ldg(bitmap + (size_t)r8 * N + n) : 0;
    }
    if (c == c_lo) {
      // each column's nonzeros before this split: popcount of its bitmap
      // bytes above row KC * c_lo, four threads per column
      const int col = tid % BN, part = tid / BN;
      const int n = n0 + col;
      int cnt = 0;
      if (n < N) {
#pragma unroll 8                        // eight loads in flight
        for (int b = part; b < c_lo * KB; b += THREADS / BN)
          cnt += __popc((unsigned)__ldg(bitmap + (size_t)b * N + n));
      }
      part_s[part][col] = cnt;
    }
#pragma unroll
    for (int i = 0; i < KB * BN / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      bm_s[idx % BN][idx / BN] = bm_r[i];
    }
    __syncthreads();                    // bm_s and part_s are ready
    // ---- expand: one thread per (column, 32 K rows = one bitmap word) ----
    {
      const int col = tid % BN, wi = tid / BN;   // THREADS = BN * KB / 4
      const int n = n0 + col;
      const uint32_t* words = reinterpret_cast<const uint32_t*>(bm_s[col]);
      // the column's nonzeros before the chunk
      int pos = c > c_lo ? base_s[col]
                         : part_s[0][col] + part_s[1][col] + part_s[2][col] +
                               part_s[3][col];
#pragma unroll
      for (int i = 0; i < KB / 4; ++i)
        if (i < wi) pos += __popc(words[i]);
      const uint32_t bits = words[wi];
      // the column's codes sit N bytes apart; past keep_k, the last one
      const int8_t* vp = values + (size_t)pos * N + n;
      const int8_t* last = values + (size_t)(keep_k - 1) * N + n;
      uint32_t code4[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        uint32_t word = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if ((bits >> (4 * q + j)) & 1u) {
            word |= (uint32_t)(uint8_t)__ldg(vp < last ? vp : last) << (8 * j);
            vp += N;
          }
        }
        code4[q] = word;
      }
      uint4* dst = reinterpret_cast<uint4*>(&w_s[col][wi * 32]);
      dst[0] = make_uint4(code4[0], code4[1], code4[2], code4[3]);
      dst[1] = make_uint4(code4[4], code4[5], code4[6], code4[7]);
    }
    __syncthreads();                    // every thread has read base_s
    if (tid < BN) {
      const uint32_t* words = reinterpret_cast<const uint32_t*>(bm_s[tid]);
      int tot = c > c_lo ? base_s[tid]
                         : part_s[0][tid] + part_s[1][tid] + part_s[2][tid] +
                               part_s[3][tid];
#pragma unroll
      for (int i = 0; i < KB / 4; ++i) tot += __popc(words[i]);
      base_s[tid] = tot;
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();                    // x_s and w_s are ready
    // ---- int8 MMA ----------------------------------------------------------
    if (!SPLIT) {
      if (m0 + 16 * RT * warp < M) {
#pragma unroll
        for (int ks = 0; ks < KC / 32; ++ks) {
          uint32_t a[RT][4];
#pragma unroll
          for (int t = 0; t < RT; ++t)
            ldmatrix_x4(a[t], &x_s[16 * (RT * warp + t) + (lane & 15)]
                                  [ks * 32 + (lane >> 4) * 16]);
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t b[4];
            ldmatrix_x4(b, &w_s[np * 16 + (lane >> 4) * 8 + (lane & 7)]
                               [ks * 32 + ((lane >> 3) & 1) * 16]);
#pragma unroll
            for (int t = 0; t < RT; ++t) {
              mma_s8(acc[t][2 * np], a[t], b[0], b[1]);
              mma_s8(acc[t][2 * np + 1], a[t], b[2], b[3]);
            }
          }
        }
      }
    } else {
      const int ks = warp & 3, nh = warp >> 2;
      uint32_t a[4];
      ldmatrix_x4(a, &x_s[lane & 15][ks * 32 + (lane >> 4) * 16]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, &w_s[nh * 32 + np * 16 + (lane >> 4) * 8 + (lane & 7)]
                           [ks * 32 + ((lane >> 3) & 1) * 16]);
        mma_s8(acc[0][2 * np], a, b[0], b[1]);
        mma_s8(acc[0][2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();                    // the chunk's tiles are consumed
  }

  // ---- epilogue: store, or add into the zeroed output across splits -------
  auto put = [&](int m, int n, int val) {
    if (m < M && n < N) {
      int32_t* o = out + (size_t)m * N + n;
      if (atomic) atomicAdd(o, val);
      else *o = val;
    }
  };
  if (!SPLIT) {
#pragma unroll
    for (int t = 0; t < RT; ++t) {
      const int mr = m0 + 16 * (RT * warp + t) + g4;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + 8 * j + 2 * c4;
        put(mr, n, acc[t][j][0]);
        put(mr, n + 1, acc[t][j][1]);
        put(mr + 8, n, acc[t][j][2]);
        put(mr + 8, n + 1, acc[t][j][3]);
      }
    }
  } else {
    // the four k32 steps' partial sums, added in shared memory
    const int ks = warp & 3, nh = warp >> 2;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = nh * 32 + 8 * j + 2 * c4;
      red_s[ks][g4 * BN + col] = acc[0][j][0];
      red_s[ks][g4 * BN + col + 1] = acc[0][j][1];
      red_s[ks][(g4 + 8) * BN + col] = acc[0][j][2];
      red_s[ks][(g4 + 8) * BN + col + 1] = acc[0][j][3];
    }
    __syncthreads();
    for (int idx = tid; idx < MT * BN; idx += THREADS) {
      const int r = idx / BN, col = idx - r * BN;
      put(m0 + r, n0 + col,
          red_s[0][idx] + red_s[1][idx] + red_s[2][idx] + red_s[3][idx]);
    }
  }
}

template <bool SPLIT>
int launch(const int8_t* x, const uint8_t* bitmap, const int8_t* values,
           int32_t* out, int M, int K, int N, int keep_k, int splits,
           int chunks_per, cudaStream_t stream) {
  constexpr int MT = SPLIT ? 16 : 16 * ROW_TILES * WARPS;
  constexpr int smem = MT * XS;         // x_s; the rest is static
  static bool configured = false;       // once per instance, before any
  if (!configured) {                    // CUDA-graph capture
    cudaError_t e = cudaFuncSetAttribute(
        sparse_mma_kernel<SPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid((N + BN - 1) / BN, (M + MT - 1) / MT, splits);
  sparse_mma_kernel<SPLIT><<<grid, THREADS, smem, stream>>>(
      x, bitmap, values, out, M, K, N, keep_k, chunks_per, splits > 1);
  return (int)cudaGetLastError();
}

}  // namespace

// variant 0: rows (M >= 17); variant 1: split (M <= 16).  grid.z =
// splits ranges of chunks_per chunks of 128 K rows; with splits > 1 the
// kernel adds into ``out``, which the caller has zeroed.  The wrapper's
// ``plan`` picks all three.  Returns cudaGetLastError() after the launch;
// cudaErrorInvalidValue (1) for arguments it does not take.
extern "C" int sparse_matvec_launch(const int8_t* x, const uint8_t* bitmap,
                                    const int8_t* values, int32_t* out,
                                    int M, int K, int N, int keep_k,
                                    int variant, int splits, int chunks_per,
                                    void* stream) {
  const int n_chunks = (K + KC - 1) / KC;
  if (M < 1 || K < 8 || K % 8 || N < 1 || keep_k < 1 || splits < 1 ||
      chunks_per < 1 || (splits - 1) * chunks_per >= n_chunks ||
      splits * chunks_per < n_chunks || (variant == 1 && M > 16) ||
      reinterpret_cast<uintptr_t>(x) % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1)
    return launch<true>(x, bitmap, values, out, M, K, N, keep_k, splits,
                        chunks_per, s);
  return launch<false>(x, bitmap, values, out, M, K, N, keep_k, splits,
                       chunks_per, s);
}
