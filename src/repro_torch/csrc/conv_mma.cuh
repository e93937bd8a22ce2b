// Implicit-GEMM int8 SAME convolution on the int8 tensor cores, with the
// fused Collector epilogue, for sm_90a.  One template on the weight
// source, behind both conv kernels: conv_implicit.cu (dense spatial-major
// codes) and conv_sparse.cu (bitmap + packed values), so the MMA loop and
// the epilogue are the same code and the two agree to the bit on the same
// (expanded) codes.
//
// Replaces conv2d_implicit_pallas (src/repro/kernels/conv_implicit.py:144)
// and conv2d_sparse_pallas (src/repro/kernels/conv_sparse.py:90, with
// expand_bitmap_tile, src/repro/kernels/bitmap.py:21).
//
// What bounds it on an H100 at the served shapes (microbatch 2): bytes —
// the f32 y (and an f32 shortcut) for the stems and most 1x1 convs, the
// weights for the deep 3x3s — and operations (1,979 TOP/s int8) nowhere.
// Those bounds are 0.1-2 us a conv, while a conv whose blocks walk K one
// chunk after another pays one memory latency per chunk: the small maps
// of conv4_x / conv5_x give 16-32 output tiles of 64 x 64, and each walks
// K = 2304-4608 rows.  The design:
//   * M is every output pixel of every image (tiles cross images; each
//     row's image picks its eff_scale, sc_scale and amax), N the output
//     channels, K = k*k*C in spatial-major order (row = tap*C + c).  A
//     block of 4 warps (2 x 2, 32 x 32 each) owns a 64 x 64 tile and walks
//     K in chunks of 64 rows.
//   * Split K over grid.z where the tiles alone do not fill the 132 SMs
//     (the wrapper's plan: kernels/conv_implicit.py ``plan``).  The splits
//     of a tile are one thread-block cluster (up to 16 blocks): each
//     block leaves its int32 partial tile in its shared memory, and after
//     a cluster barrier up to 4 blocks each add the others' partials of
//     a quarter of the tile's rows over distributed shared memory and run
//     the Collector on them.  No global workspace, no atomics, no second
//     launch; integer sums are exact in any order.
//   * A ring of STAGES = 4 chunk buffers in shared memory (36 KB dense,
//     under the 48 KB that needs no opt-in), filled by cp.async 3 chunks
//     ahead of the MMAs: the implicit im2col tile of A (16-byte copies
//     where C % 16 == 0, 4-byte where C % 4 == 0, a byte gather for the C = 3 stems; the SAME padding and the K tail
//     are cp.async's zero fill) and, dense, the weight rows (16 bytes along
//     n), or, sparse, the chunk's bitmap bytes, both through L1 (all the
//     blocks of a column tile read them).  One __syncthreads per chunk.
//   * MACs on mma.sync.m16n8k32.row.col.s32.s8.s8.s32.  A fragments come
//     by ldmatrix from rows padded to 80 bytes (no bank read twice).  The
//     B fragment wants 4 K-consecutive codes of one column per register:
//     dense, a thread reads the 4 x 4 byte block of rows k..k+3 and
//     columns 4j..4j+3 of the [k][n] staged rows (swizzled so that no
//     bank is read twice) and transposes it with __byte_perm; so the
//     thread's four n8 tiles are the columns 4g..4g+3 of its group, and
//     its accumulators cover 8 consecutive output channels per row.
//   * Sparse B: the chunk's bitmap bytes arrive with A; one thread per
//     (column, 32 K rows) finds where its codes start in the column's
//     packed values (the column's nonzeros before the chunk, carried from
//     chunk to chunk, plus a popcount) and gathers them into a K-major
//     [n][k] tile.  The gathers for chunk c+1 are issued before the MMAs
//     of chunk c and stored after them, so their latency hides behind the
//     MMAs (double-buffered tile); a split that starts at K = 0 reads its
//     first chunk's bitmap bytes straight from global memory as it starts
//     and issues their gathers ahead of the ring's first copies.  A later
//     split finds its columns' start counts by a popcount of the bitmap
//     rows before it (16-byte loads, SWAR byte counts in 16-bit lanes,
//     emptied into the shared counts every 8192 bitmap rows).  The keep_k
//     clamp of the plain version is kept: a code past the column's keep_k
//     values reads the last one.
//   * Zero counts (PROFILE, a compile-time flag: the instance without it
//     is the same code as without the feature; the profile_g output of
//     src/repro/kernels/conv_implicit.py:85-138 and conv_sparse.py:49-84).
//     Per coarse_in group of g output channels (g a power of two dividing
//     BN and n_out): the zeros of y (``y == 0.f``, as floats) over each
//     image's pixels, into zg, and the (pixel, group) cells whose whole
//     group is zero, into za, both (N, n_out/g) int32 that the wrapper
//     zeroes.  A thread's 8 channels of a row hold groups of g <= 8
//     whole; g = 16 and 32 span 2 and 4 lanes of a quad (shuffles, as the
//     row max); g = 64 spans the two wn warps, whose quads add the row's
//     zeros in shared memory.  Under split K only a leader's own rows
//     count.  A tile in one image sums its counts in registers, over the
//     warp, then in shared memory, and adds one atomicAdd per group and
//     block; a tile that crosses images counts each row into its image's
//     slot in shared memory (past ZC_SLOTS images, straight into zg / za).
//     Integer counts: exact in any order.  y is the same with or without.
#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "cluster_launch.cuh"
#include "conv_common.cuh"

namespace repro {
namespace conv_mma {

constexpr int BM = 64;                  // output pixels per tile
constexpr int BN = 64;                  // output channels per tile
constexpr int BK = 64;                  // K rows per chunk
constexpr int THREADS = 128;            // 4 warps, 2 x 2 of 32 x 32
constexpr int A_PITCH = BK + 16;        // bytes per A row (ldmatrix: no
                                        // bank read twice)
constexpr int A_BYTES = BM * A_PITCH;
constexpr int BD_BYTES = BK * BN;       // dense: staged [k][n] rows
constexpr int BMP_BYTES = BK / 8 * BN;  // sparse: the chunk's bitmap bytes
constexpr int BS_PITCH = BK / 4 + 1;    // sparse tile: words per column
constexpr int BS_WORDS = BN * BS_PITCH;
constexpr int PART = BM * BN / THREADS; // accumulators per thread
static_assert(PART == 32, "2 m16 x 4 n8 tiles of 4 accumulators");
static_assert(THREADS == BN * BK / 32, "sparse: one thread per (column, "
                                       "32 K rows)");

constexpr int MAX_SPLITS = 16;          // blocks of a cluster (non-portable)
constexpr int STAGES = 4;               // ring depth (3 and 6: no faster)
constexpr int PART_BYTES = 4 * 4 * THREADS * 8;  // split K: int2 partials
constexpr int ZC_SLOTS = 4;             // images of a tile whose zero counts
                                        // add up in shared memory

struct Plan {
  int M;                    // N * h_out * w_out
  int splits, chunks_per;
  int bvec;                 // bytes per weight / bitmap copy: 16, 4 or 1
  int vec_epi;              // n_out % 8 == 0, epilogue operands aligned
};

// The profile_g zero counts (zg null: none).
struct Profile {
  int* zg;                  // (N, n_out/g) zeros per group, zero on entry
  int* za;                  // (N, n_out/g) all-zero (pixel, group) cells
  int g;                    // channels per group: a power of two <= BN
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// global -> shared, 16 bytes through L2 only; zeros where src_bytes is 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
// the same through L1, for rows that many blocks read: every block of a
// column tile copies the same weight rows (392 blocks at the stems), and
// through L2 alone they all queue on the same few lines
__device__ __forceinline__ void cp_async16_l1(void* dst, const void* src,
                                              int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
// 4 bytes (through L1: 16 is the only size that may bypass it)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// the address of shared variable p in the cluster's block ``rank``, and
// an 8-byte load from another block's shared memory
__device__ __forceinline__ unsigned cluster_addr(const void* p, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(smem_addr(p)), "r"(rank));
  return r;
}
__device__ __forceinline__ int2 ld_cluster_v2(unsigned addr) {
  int2 v;
  asm volatile("ld.shared::cluster.v2.s32 {%0,%1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y) : "r"(addr));
  return v;
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

// Word index, in a dense chunk's staged [k][n] rows (16 words each), of
// row k's word w (columns 4w..4w+3).  Row k is stored at k ^ bit 2 of k
// and its 16-byte units are XORed with bit 3 of k (times 2), so the 32
// lanes of a B fragment load (rows c4*4 + r, words g..) hit 32 banks.
__device__ __forceinline__ int bd_word(int k, int w) {
  const int prow = k ^ ((k >> 2) & 1);
  return prow * (BN / 4) + ((((w >> 2) ^ (((k >> 3) & 1) << 1))) << 2) +
         (w & 3);
}

// Transpose a 4 x 4 byte block: r[i] holds row k+i, columns 0..3; out[j]
// holds column j, rows k..k+3 (the lowest row in the lowest byte).
__device__ __forceinline__ void transpose4(const uint32_t (&r)[4],
                                           uint32_t (&out)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  out[0] = __byte_perm(t0, t1, 0x5410);
  out[1] = __byte_perm(t0, t1, 0x7632);
  out[2] = __byte_perm(t2, t3, 0x5410);
  out[3] = __byte_perm(t2, t3, 0x7632);
}

// Per-byte popcounts of a word, each byte 0..8.
__device__ __forceinline__ uint32_t byte_popc(uint32_t x) {
  x = x - ((x >> 1) & 0x55555555u);
  x = (x & 0x33333333u) + ((x >> 2) & 0x33333333u);
  return (x + (x >> 4)) & 0x0f0f0f0fu;
}

template <bool SPARSE, int VEC, bool PROFILE>
__global__ void __launch_bounds__(THREADS)
conv_mma_kernel(ConvArgs a, Plan p, Profile z) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ unsigned int rowmax_s[BM];
  __shared__ int base_s[BN];
  // zero counts: per image slot and group of the tile; per row, for g = 64
  __shared__ int zg_s[PROFILE ? ZC_SLOTS * BN : 1];
  __shared__ int za_s[PROFILE ? ZC_SLOTS * BN : 1];
  __shared__ int zrow_s[PROFILE ? BM : 1];
  // byte gather: per tile row, the offset of its first tap in x and its
  // top-left input position (far outside the image for a row past M)
  __shared__ long long row_off_s[VEC == 1 ? BM : 1];
  __shared__ int2 row_s[VEC == 1 ? BM : 1];
  constexpr int STAGE = A_BYTES + (SPARSE ? BMP_BYTES : BD_BYTES);
  constexpr int S = STAGES;
  uint32_t* bs = reinterpret_cast<uint32_t*>(smem + S * STAGE);  // sparse

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, c4 = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int m_img = a.h_out * a.w_out;
  const int n_out = a.n_out;
  const int n_chunks = ((SPARSE ? a.Kb8 * 8 : a.K) + BK - 1) / BK;
  const int c_lo = blockIdx.z * p.chunks_per;
  const int n_local = min(p.chunks_per, n_chunks - c_lo);

  // sparse, a split from K = 0: the first chunk's bitmap bytes of the
  // thread's expansion column (tid % BN), straight from global memory
  uint32_t w0[2] = {0u, 0u};
  if (SPARSE && c_lo == 0) {
    const int n = n0 + tid % BN;
#pragma unroll
    for (int r = 0; r < BK / 8; ++r)
      if (r < a.Kb8 && n < n_out)
        w0[r >> 2] |= (uint32_t)__ldg(a.bitmap + (size_t)r * n_out + n)
                      << (8 * (r & 3));
  }
  if (tid < BM) rowmax_s[tid] = 0u;
  if (SPARSE && tid < BN) base_s[tid] = 0;
  if constexpr (PROFILE) {      // the ring's first barrier orders these
    for (int i = tid; i < ZC_SLOTS * BN; i += THREADS) zg_s[i] = za_s[i] = 0;
    if (tid < BM) zrow_s[tid] = 0;
  }

  // ---- A loader ----------------------------------------------------------
  // VEC 16 / 4: thread owns output row tid / 2 and half (32 K rows) of each
  // chunk; its K position (tap dy, dx; channel ch) steps chunk by chunk,
  // without a division.
  const int a_row = tid >> 1, a_half = tid & 1;
  const int am = m0 + a_row;
  const bool a_valid = am < p.M;
  int a_ih0 = 0, a_iw0 = 0;
  const int8_t* x_img = a.x;
  if (a_valid) {
    const int img = am / m_img, pix = am - img * m_img;
    const int oh = pix / a.w_out, ow = pix - oh * a.w_out;
    a_ih0 = oh * a.stride - a.pad_top;
    a_iw0 = ow * a.stride - a.pad_left;
    x_img = a.x + (size_t)img * a.H * a.W * a.C;
  }
  int a_k = c_lo * BK + a_half * 32, a_ch = 0, a_dy = 0, a_dx = 0;
  if (VEC != 1) {
    const int tap = a_k / a.C;
    a_ch = a_k - tap * a.C;
    a_dy = tap / a.k;
    a_dx = tap - a_dy * a.k;
  }
  auto step = [&](int& ch, int& dy, int& dx, int n) {   // K += n
    for (ch += n; ch >= a.C; ch -= a.C)
      if (++dx == a.k) { dx = 0; ++dy; }
  };
  if (VEC == 1 && tid < BM) {
    const int m = m0 + tid, img = m / m_img, pix = m - img * m_img;
    const int oh = pix / a.w_out, ow = pix - oh * a.w_out;
    const int ih0 = m < p.M ? oh * a.stride - a.pad_top : -(1 << 30);
    const int iw0 = ow * a.stride - a.pad_left;
    row_s[tid] = make_int2(ih0, iw0);
    row_off_s[tid] = (((long long)img * a.H + ih0) * a.W + iw0) * a.C;
  }
  auto load_a = [&](int c, uint8_t* As) {
    uint8_t* dst = As + a_row * A_PITCH + a_half * 32;
    if (VEC == 16) {            // one tap's 16 channels per copy
      int ch = a_ch, dy = a_dy, dx = a_dx;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (i) step(ch, dy, dx, 16);
        const int ih = a_ih0 + dy, iw = a_iw0 + dx;
        const bool ok = a_valid && a_k + 16 * i < a.K && ih >= 0 &&
                        ih < a.H && iw >= 0 && iw < a.W;
        const int8_t* src = x_img + ((size_t)ih * a.W + iw) * a.C + ch;
        cp_async16(dst + 16 * i, ok ? src : a.x, ok ? 16 : 0);
      }
    } else if (VEC == 4) {      // 4 channels of one tap per copy
      int ch = a_ch, dy = a_dy, dx = a_dx;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (i) step(ch, dy, dx, 4);
        const int ih = a_ih0 + dy, iw = a_iw0 + dx;
        const bool ok = a_valid && a_k + 4 * i < a.K && ih >= 0 &&
                        ih < a.H && iw >= 0 && iw < a.W;
        const int8_t* src = x_img + ((size_t)ih * a.W + iw) * a.C + ch;
        cp_async4(dst + 4 * i, ok ? src : a.x, ok ? 4 : 0);
      }
    } else {                    // byte gather (taps straddle words: the
      // C = 3 stems): the lanes of a warp take 32 consecutive K bytes of
      // one row at a time, so a warp's loads hit one or two lines
      uint8_t b[2][BM / 4] = {};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (c * BK + 32 * h >= a.K) break;   // past K: zeros
        const int k = c * BK + 32 * h + lane;
        const int tap = k / a.C, ch = k - tap * a.C;
        const int dy = k < a.K ? tap / a.k : -(1 << 30);
        const int dx = tap - (tap / a.k) * a.k;
        const long long off = ((long long)dy * a.W + dx) * a.C + ch;
#pragma unroll
        for (int i = 0; i < BM / 4; ++i) {
          const int r = warp * (BM / 4) + i;
          const int2 ri = row_s[r];
          const int ih = ri.x + dy, iw = ri.y + dx;
          const bool ok = ih >= 0 && ih < a.H && iw >= 0 && iw < a.W;
          b[h][i] = ok ? (uint8_t)__ldg(a.x + row_off_s[r] + off)
                       : (uint8_t)0;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < BM / 4; ++i)
          As[(warp * (BM / 4) + i) * A_PITCH + 32 * h + lane] = b[h][i];
    }
    if (VEC != 1) {             // the next chunk
      a_k += BK;
      step(a_ch, a_dy, a_dx, BK);
    }
  };

  // ---- B loader (dense): thread owns chunk row tid / 2, half the columns
  auto load_b = [&](int c, uint8_t* Bd) {
    const int row = tid >> 1, kk = c * BK + row;
    const bool row_ok = kk < a.K;
    const int8_t* src_row = a.w + (size_t)kk * n_out;
    uint32_t* Bw = reinterpret_cast<uint32_t*>(Bd);
    if (p.bvec == 16) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int u = (tid & 1) * 2 + i, n = n0 + 16 * u;
        const bool ok = row_ok && n < n_out;
        cp_async16_l1(Bw + bd_word(row, 4 * u), ok ? src_row + n : a.w,
                      ok ? 16 : 0);
      }
    } else if (p.bvec == 4) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int w = (tid & 1) * 8 + i, n = n0 + 4 * w;
        const bool ok = row_ok && n < n_out;
        cp_async4(Bw + bd_word(row, w), ok ? src_row + n : a.w, ok ? 4 : 0);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int w = (tid & 1) * 8 + i;
        uint32_t word = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + 4 * w + j;
          if (row_ok && n < n_out)
            word |= (uint32_t)(uint8_t)__ldg(src_row + n) << (8 * j);
        }
        Bw[bd_word(row, w)] = word;
      }
    }
  };

  // ---- bitmap loader (sparse): the chunk's 8 bitmap rows x 64 columns --
  auto load_bitmap = [&](int c, uint8_t* bm) {
    if (p.bvec == 16) {
      if (tid < BMP_BYTES / 16) {
        const int i = tid >> 2, u = tid & 3;
        const int r8 = c * (BK / 8) + i, n = n0 + 16 * u;
        const bool ok = r8 < a.Kb8 && n < n_out;
        cp_async16_l1(bm + i * BN + 16 * u,
                      ok ? a.bitmap + (size_t)r8 * n_out + n : a.bitmap,
                      ok ? 16 : 0);
      }
    } else if (p.bvec == 4) {
      const int i = tid >> 4, w = tid & 15;
      const int r8 = c * (BK / 8) + i, n = n0 + 4 * w;
      const bool ok = r8 < a.Kb8 && n < n_out;
      cp_async4(bm + i * BN + 4 * w,
                ok ? a.bitmap + (size_t)r8 * n_out + n : a.bitmap,
                ok ? 4 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < BMP_BYTES / THREADS; ++j) {
        const int idx = tid + j * THREADS, i = idx / BN, col = idx % BN;
        const int r8 = c * (BK / 8) + i, n = n0 + col;
        bm[idx] = (r8 < a.Kb8 && n < n_out)
                      ? __ldg(a.bitmap + (size_t)r8 * n_out + n) : 0;
      }
    }
  };

  uint8_t* ring = smem;
  auto issue = [&](int i) {     // chunk c_lo + i into stage i % S
    if (i < n_local) {
      uint8_t* st = ring + (i % S) * STAGE;
      // B first: its copies are in flight while a byte gather of A waits
      if (SPARSE) load_bitmap(c_lo + i, st + A_BYTES);
      else load_b(c_lo + i, st + A_BYTES);
      load_a(c_lo + i, st);
    }
    cp_async_commit();          // empty groups keep the count uniform
  };

  // ---- sparse: expand the chunk's codes of column g_col, K rows 32 g_wi
  // ..+31, into codes[] (8 words, 4 K-consecutive codes each), from the
  // chunk's bitmap words w; base (the column's nonzeros before the chunk)
  // moves past it
  const int g_col = tid % BN, g_wi = tid / BN;
  int base = 0;
  uint32_t codes[8];
  auto gather_words = [&](const uint32_t (&w)[2]) {
    const uint32_t bits = w[g_wi];
#pragma unroll
    for (int q = 0; q < 8; ++q) codes[q] = 0u;
    if (bits == 0u) {           // all zeros (whole warps at padded columns)
      base += __popc(w[0]) + __popc(w[1]);
      return;
    }
    const int pos = base + (g_wi ? __popc(w[0]) : 0);
    // the column's codes sit n_out bytes apart (32-bit offsets: the
    // wrapper keeps K_pad * n_out under 2**31); past keep_k, the last one
    const int n = n0 + g_col;   // bits are zero past n_out
    int off = pos * n_out + n;
    const int last = (a.keep_k - 1) * n_out + n;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if ((bits >> (4 * q + j)) & 1u) {
          codes[q] |= (uint32_t)(uint8_t)__ldg(a.values + min(off, last))
                      << (8 * j);
          off += n_out;
        }
      }
    }
    base += __popc(w[0]) + __popc(w[1]);
  };
  auto gather = [&](const uint8_t* bm) {   // the bitmap bytes in the ring
    uint32_t w[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      w[h] = (uint32_t)bm[(4 * h) * BN + g_col] |
             (uint32_t)bm[(4 * h + 1) * BN + g_col] << 8 |
             (uint32_t)bm[(4 * h + 2) * BN + g_col] << 16 |
             (uint32_t)bm[(4 * h + 3) * BN + g_col] << 24;
    gather_words(w);
  };
  auto store_codes = [&](uint32_t* tile_s) {
#pragma unroll
    for (int q = 0; q < 8; ++q)
      tile_s[g_col * BS_PITCH + g_wi * 8 + q] = codes[q];
  };

  if (SPARSE || VEC == 1) __syncthreads();  // base_s, row_s are set
  // the first chunk's codes, their loads in flight with the ring's first
  // copies
  if (SPARSE && c_lo == 0 && n_local > 0) gather_words(w0);
  for (int i = 0; i < S - 1; ++i) issue(i);

  // ---- sparse: each column's nonzeros before this split ------------------
  if (SPARSE && c_lo > 0) {
    const int rows = c_lo * (BK / 8);
    if (p.bvec == 16) {         // 16 columns per thread, 32 row phases
      const int q = tid & 3, n = n0 + 16 * q;
      // a 16-bit lane sums a byte's counts (<= 8) over 8 threads' rows:
      // SWAR_ROWS rows keep it at 8 * 8192 / 32 * 8 = 16384 < 65536
      constexpr int SWAR_ROWS = 8192;
      for (int r0 = 0; r0 < rows; r0 += SWAR_ROWS) {
        const int r1 = min(rows, r0 + SWAR_ROWS);
        uint32_t ev[4] = {0, 0, 0, 0}, od[4] = {0, 0, 0, 0};
        if (n < n_out) {
#pragma unroll 4
          for (int r = r0 + (tid >> 2); r < r1; r += THREADS / 4) {
            const uint4 v = __ldg(reinterpret_cast<const uint4*>(
                a.bitmap + (size_t)r * n_out + n));
            const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {   // bytes 0, 2 and 1, 3 in
              const uint32_t b = byte_popc(w4[i]);  // 16-bit lanes
              ev[i] += b & 0x00ff00ffu;
              od[i] += (b >> 8) & 0x00ff00ffu;
            }
          }
        }
#pragma unroll
        for (int off = 4; off < 32; off *= 2)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ev[i] += __shfl_xor_sync(0xffffffffu, ev[i], off);
            od[i] += __shfl_xor_sync(0xffffffffu, od[i], off);
          }
        if (lane < 4) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = 16 * q + 4 * i;
            atomicAdd(&base_s[col], (int)(ev[i] & 0xffffu));
            atomicAdd(&base_s[col + 1], (int)(od[i] & 0xffffu));
            atomicAdd(&base_s[col + 2], (int)(ev[i] >> 16));
            atomicAdd(&base_s[col + 3], (int)(od[i] >> 16));
          }
        }
      }
    } else {                    // one column per thread, 2 row phases
      const int n = n0 + g_col;
      int cnt = 0;
      if (n < n_out) {
#pragma unroll 8
        for (int r = g_wi; r < rows; r += THREADS / BN)
          cnt += __popc((unsigned)__ldg(a.bitmap + (size_t)r * n_out + n));
      }
      atomicAdd(&base_s[g_col], cnt);
    }
  }
  int acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;

  auto mma_chunk = [&](const uint8_t* As, const uint8_t* Bd,
                       const uint32_t* Bsp) {
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(af[mt], As + (32 * wm + 16 * mt + (lane & 15)) * A_PITCH +
                                ks * 32 + (lane >> 4) * 16);
      uint32_t bf[4][2];        // n8 tile j = columns 4 g4 + j of the warp's
#pragma unroll                  // 32, K halves 0 and 1
      for (int h = 0; h < 2; ++h) {
        if (SPARSE) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            bf[j][h] = Bsp[(32 * wn + 4 * g4 + j) * BS_PITCH + ks * 8 +
                           h * 4 + c4];
        } else {
          const uint32_t* Bw = reinterpret_cast<const uint32_t*>(Bd);
          const int kb = ks * 32 + h * 16 + c4 * 4;
          uint32_t r[4], t[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) r[i] = Bw[bd_word(kb + i, 8 * wn + g4)];
          transpose4(r, t);
#pragma unroll
          for (int j = 0; j < 4; ++j) bf[j][h] = t[j];
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_s8(acc[mt][j], af[mt], bf[j][0], bf[j][1]);
    }
  };

  // ---- the ring -----------------------------------------------------------
  if (SPARSE && n_local > 0) {
    if (c_lo > 0) {             // a later split: its prefix counts first
      cp_async_wait<S - 2>();
      __syncthreads();          // chunk 0 has landed; base_s is complete
      base = base_s[g_col];
      gather(ring + A_BYTES);
    }
    store_codes(bs);
  }
  for (int i = 0; i < n_local; ++i) {
    // dense: chunk i has landed; sparse: chunk i + 1's bitmap too
    cp_async_wait<SPARSE ? S - 3 : S - 2>();
    __syncthreads();            // ... for every thread; stage (i - 1) % S
                                // and the other tile buffer are free
    issue(i + S - 1);
    const uint8_t* st = ring + (i % S) * STAGE;
    const bool next = SPARSE && i + 1 < n_local;
    if (next) gather(ring + ((i + 1) % S) * STAGE + A_BYTES);
    mma_chunk(st, st + A_BYTES, bs + (i & 1) * BS_WORDS);
    if (next) store_codes(bs + ((i + 1) & 1) * BS_WORDS);
  }
  cp_async_wait<0>();

  // ---- split K: the splits of a tile are one cluster.  The tile's rows
  // fall in 4 groups g = (m16 tile, half): rank g % leaders adds the
  // others' partial sums of group g over distributed shared memory and
  // runs the Collector on it.
  int rank = 0, leaders = 1;
  if (p.splits > 1) {
    cooperative_groups::cluster_group cluster =
        cooperative_groups::this_cluster();
    rank = (int)cluster.block_rank();
    leaders = min(p.splits, 4);
    __syncthreads();            // every warp is done with the ring
    int2* part_s = reinterpret_cast<int2*>(smem);  // [g][j][tid]
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        part_s[(g * 4 + j) * THREADS + tid] =
            make_int2(acc[g >> 1][j][2 * (g & 1)],
                      acc[g >> 1][j][2 * (g & 1) + 1]);
    cluster.sync();             // every block's partial is in place
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      if (g % leaders != rank) continue;
      const int mt = g >> 1, e0 = 2 * (g & 1);
      for (int z0 = 0; z0 < p.splits; z0 += 4) {   // 16 loads in flight
        int2 v[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int z = z0 + u;
          const bool use = z < p.splits && z != rank;
          const unsigned src = cluster_addr(part_s + g * 4 * THREADS + tid,
                                            use ? z : rank);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            v[u][j] = use ? ld_cluster_v2(src + j * THREADS * 8)
                          : make_int2(0, 0);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[mt][j][e0] += v[u][j].x;
            acc[mt][j][e0 + 1] += v[u][j].y;
          }
      }
    }
    cluster.sync();             // every partial has been read
    if (rank >= leaders) return;
  }

  // ---- Collector epilogue --------------------------------------------------
  // accumulator (mt, j, 2 hf + e) is row 32 wm + 16 mt + 8 hf + g4, column
  // 32 wn + 8 c4 + 4 e + j: eight consecutive channels per row
  const int sc_kind = a.shortcut ? 1 : (a.sc_q ? 2 : 0);
  const int img_lo = m0 / m_img;
  const bool one_img = img_lo == (min(m0 + BM, p.M) - 1) / m_img;
  float tmax = 0.f;             // one image: the thread's max|y|
  // the thread's 8 channels are the same in every row: their bias, and in
  // a one-image tile their dequant row, are loaded once
  const int nb = n0 + 32 * wn + 8 * c4;
  const bool vec = p.vec_epi && nb < n_out;
  float sv[8], bv[8];
  auto load8 = [](float (&d)[8], const float* src) {
    const float4 u0 = __ldg(reinterpret_cast<const float4*>(src));
    const float4 u1 = __ldg(reinterpret_cast<const float4*>(src) + 1);
    d[0] = u0.x; d[1] = u0.y; d[2] = u0.z; d[3] = u0.w;
    d[4] = u1.x; d[5] = u1.y; d[6] = u1.z; d[7] = u1.w;
  };
  if (vec) {
    load8(bv, a.eff_bias + nb);
    if (one_img) load8(sv, a.eff_scale + (size_t)img_lo * n_out + nb);
  }

  // ---- zero counts (PROFILE): group u of the thread's 8 channels is the
  // tile's group (32 wn + 8 c4 + u g) / g; g >= 8 gives one (u = 0)
  int zcnt[8], acnt[8];         // one image: the thread's counts per u
#pragma unroll
  for (int u = 0; u < 8; ++u) zcnt[u] = acnt[u] = 0;
  auto add_counts = [&](int u, int zc, int ac, int img) {
    if (one_img) {
      zcnt[u] += zc;
      acnt[u] += ac;
    } else if (zc) {            // no zeros, no all-zero cell
      const int grp = (32 * wn + 8 * c4 + u * z.g) / z.g;
      const int slot = img - img_lo;
      if (slot < ZC_SLOTS) {
        atomicAdd(&zg_s[slot * BN + grp], zc);
        if (ac) atomicAdd(&za_s[slot * BN + grp], ac);
      } else {
        const size_t o = (size_t)img * (n_out / z.g) + n0 / z.g + grp;
        atomicAdd(z.zg + o, zc);
        if (ac) atomicAdd(z.za + o, ac);
      }
    }
  };
  // one row's zeros: bit e of zm is channel nb + e (0 past n_out and for
  // rows that are not the thread's); every lane calls it (shuffles)
  auto count_row = [&](unsigned zm, int r, int img) {
    const int g = z.g;
    if (g <= 8) {
      const unsigned full = (1u << g) - 1u;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (u * g < 8) {
          const unsigned bits = (zm >> (u * g)) & full;
          add_counts(u, __popc(bits), bits == full, img);
        }
      }
      return;
    }
    const int zc = __popc(zm);
    int all = zm == 0xffu;      // n_out % g == 0: 8 channels valid or none
    all &= __shfl_xor_sync(0xffffffffu, all, 1);
    if (g >= 32) all &= __shfl_xor_sync(0xffffffffu, all, 2);
    if (g == BN) {              // the other half is the other wn warp's
      int q = zc + __shfl_xor_sync(0xffffffffu, zc, 1);
      q += __shfl_xor_sync(0xffffffffu, q, 2);
      if (c4 == 0 && q) atomicAdd(&zrow_s[r], q);
      all = 0;                  // counted from zrow_s below
    }
    add_counts(0, zc, all && (8 * c4) % g == 0, img);
  };

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = 32 * wm + 16 * mt + 8 * hf + g4, m = m0 + r;
      const bool mine = (2 * mt + hf) % leaders == rank;
      float rmax = 0.f;
      unsigned zm = 0u;         // PROFILE: the row's zeros of y
      int img = img_lo;
      if (mine && m < p.M) {
        img = one_img ? img_lo : m / m_img;
        int v[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] = acc[mt][j][2 * hf];
          v[4 + j] = acc[mt][j][2 * hf + 1];
        }
        const size_t o = (size_t)m * n_out + nb;
        if (vec) {
          if (!one_img) load8(sv, a.eff_scale + (size_t)img * n_out + nb);
          float scv[8] = {0, 0, 0, 0, 0, 0, 0, 0};
          int qv[8] = {0, 0, 0, 0, 0, 0, 0, 0};
          float q_scale = 0.f;
          if (sc_kind == 1) {
            const float4* sp = reinterpret_cast<const float4*>(a.shortcut + o);
            const float4 h0 = __ldg(sp), h1 = __ldg(sp + 1);
            scv[0] = h0.x; scv[1] = h0.y; scv[2] = h0.z; scv[3] = h0.w;
            scv[4] = h1.x; scv[5] = h1.y; scv[6] = h1.z; scv[7] = h1.w;
          } else if (sc_kind == 2) {
            const uint2 qq = __ldg(reinterpret_cast<const uint2*>(a.sc_q + o));
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              qv[e] = (int)(int8_t)(qq.x >> (8 * e));
              qv[4 + e] = (int)(int8_t)(qq.y >> (8 * e));
            }
            q_scale = a.sc_scale[img];
          }
          float y[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            y[e] = collect(v[e], sv[e], bv[e], sc_kind, scv[e], qv[e], q_scale,
                           a.relu);
            rmax = fmaxf(rmax, fabsf(y[e]));
            if constexpr (PROFILE) zm |= (unsigned)(y[e] == 0.f) << e;
          }
          float4* yp = reinterpret_cast<float4*>(a.y + o);
          yp[0] = make_float4(y[0], y[1], y[2], y[3]);
          yp[1] = make_float4(y[4], y[5], y[6], y[7]);
          if (a.acc_out) {
            int4* ap = reinterpret_cast<int4*>(a.acc_out + o);
            ap[0] = make_int4(v[0], v[1], v[2], v[3]);
            ap[1] = make_int4(v[4], v[5], v[6], v[7]);
          }
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int n = nb + e;
            if (n >= n_out) continue;
            const float y = collector(a, v[e], img, o + e, n);
            a.y[o + e] = y;
            if (a.acc_out) a.acc_out[o + e] = v[e];
            rmax = fmaxf(rmax, fabsf(y));
            if constexpr (PROFILE) zm |= (unsigned)(y == 0.f) << e;
          }
        }
      }
      tmax = fmaxf(tmax, rmax);
      if (!one_img) {
        // the row's max over the quad's 32 columns, then over the 2 warps
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 2));
        if (mine && c4 == 0 && m < p.M)
          atomicMax(&rowmax_s[r], __float_as_uint(rmax));
      }
      if constexpr (PROFILE) count_row(zm, r, img);
    }
  }
  if constexpr (PROFILE) {
    const int g = z.g, G = n_out / g, per_tile = BN / g;
    if (one_img) {              // the thread's counts over the warp's rows
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (u * g < 8 || u == 0) {
#pragma unroll
          for (int off = 4; off < 32; off *= 2) {
            zcnt[u] += __shfl_xor_sync(0xffffffffu, zcnt[u], off);
            acnt[u] += __shfl_xor_sync(0xffffffffu, acnt[u], off);
          }
          const int grp = (32 * wn + 8 * c4 + u * g) / g;
          if (g4 == 0 && zcnt[u]) atomicAdd(&zg_s[grp], zcnt[u]);
          if (g4 == 0 && acnt[u]) atomicAdd(&za_s[grp], acnt[u]);
        }
      }
    }
    __syncthreads();            // zrow_s, zg_s and za_s are complete
    if (g == BN) {              // a row's one group: all zero at BN zeros
      if (tid < BM && zrow_s[tid] == BN) {
        const int img = (m0 + tid) / m_img, slot = img - img_lo;
        if (slot < ZC_SLOTS) atomicAdd(&za_s[slot * BN], 1);
        else atomicAdd(z.za + (size_t)img * G + n0 / g, 1);
      }
      __syncthreads();
    }
    const int img_hi = (min(m0 + BM, p.M) - 1) / m_img;
    const int slots = min(ZC_SLOTS, img_hi - img_lo + 1);
    for (int i = tid; i < slots * per_tile; i += THREADS) {
      const int s = i / per_tile, j = i - s * per_tile, grp = n0 / g + j;
      const int zc = zg_s[s * BN + j], ac = za_s[s * BN + j];
      const size_t o = (size_t)(img_lo + s) * G + grp;
      if (grp < G && zc) atomicAdd(z.zg + o, zc);
      if (grp < G && ac) atomicAdd(z.za + o, ac);
    }
  }
  if (one_img) {                // the tile lies in one image
    amax_reduce(a, img_lo, tmax);
    return;
  }
  __syncthreads();
  // per-image amax: a segmented max over the tile's rows (images are
  // contiguous runs of rows), one atomicMax per image and warp
  if (warp < BM / 32) {
    const int r = warp * 32 + lane, m = m0 + r;
    const bool valid = m < p.M;
    const int img = valid ? m / m_img : -1;
    unsigned int v = valid ? rowmax_s[r] : 0u;
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const unsigned int v2 = __shfl_down_sync(0xffffffffu, v, off);
      const int img2 = __shfl_down_sync(0xffffffffu, img, off);
      if (lane + off < 32 && img2 == img) v = max(v, v2);
    }
    const int prev = __shfl_up_sync(0xffffffffu, img, 1);
    if (valid && (lane == 0 || prev != img)) atomicMax(a.amax + img, v);
  }
}

template <bool SPARSE, int VEC>
int launch_vec(const ConvArgs& a, const Plan& p, const Profile& z, dim3 grid,
               cudaStream_t stream) {
  constexpr int STAGE = A_BYTES + (SPARSE ? BMP_BYTES : BD_BYTES);
  constexpr int SMEM = STAGES * STAGE + (SPARSE ? 2 * BS_WORDS * 4 : 0);
  static_assert(SMEM + 4096 <= 48 * 1024, "dynamic + static shared memory "
                "under 48 KB: no opt-in attribute");
  static_assert(PART_BYTES <= SMEM, "split K: the partials reuse the ring");
  if (z.zg)
    return launch_split_z<conv_mma_kernel<SPARSE, VEC, true>>(
        grid, THREADS, SMEM, stream, p.splits, a, p, z);
  return launch_split_z<conv_mma_kernel<SPARSE, VEC, false>>(
      grid, THREADS, SMEM, stream, p.splits, a, p, z);
}

// Check the plan (and the zero counts' group) against the shape and
// launch; cudaErrorInvalidValue (1) for a plan the kernel does not take.
template <bool SPARSE>
int launch(const ConvArgs& a, const Plan& p, const Profile& z, int vec,
           cudaStream_t stream) {
  const int n_chunks = ((SPARSE ? a.Kb8 * 8 : a.K) + BK - 1) / BK;
  const int m_tiles = (p.M + BM - 1) / BM, n_tiles = (a.n_out + BN - 1) / BN;
  const int bvec_ok = p.bvec == 16 || p.bvec == 4 || p.bvec == 1;
  if (p.M != a.N * a.h_out * a.w_out || p.M < 1 || a.n_out < 1 ||
      a.K < 1 || n_tiles > 65535 || p.splits < 1 ||
      p.splits > MAX_SPLITS || p.chunks_per < 1 ||
      (p.splits - 1) * p.chunks_per >= n_chunks ||
      p.splits * p.chunks_per < n_chunks || !bvec_ok || a.n_out % p.bvec ||
      (p.vec_epi && a.n_out % 8) || a.C % vec ||
      (SPARSE && a.Kb8 * 8 < a.K) ||
      (z.zg && (!z.za || z.g < 1 || z.g > BN || (z.g & (z.g - 1)) ||
                a.n_out % z.g)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(m_tiles, n_tiles, p.splits);
  switch (vec) {
    case 16: return launch_vec<SPARSE, 16>(a, p, z, grid, stream);
    case 4: return launch_vec<SPARSE, 4>(a, p, z, grid, stream);
    case 1: return launch_vec<SPARSE, 1>(a, p, z, grid, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace conv_mma
}  // namespace repro
