// int8 GEMM on the int8 tensor cores, for sm_90a: x (M, K) int8 @ codes
// (K, N) int8 -> the exact int32 product, or, with a per-column scale,
// f32 out = float(acc) * scale[n], applied once to the full int32 sum.
//
// Replaces cfmm_matmul_pallas (src/repro/kernels/cfmm_matmul.py:44).  In
// the port it is the product of every compiled linear in the ``int8`` and
// ``cfmm`` serve modes (core/compiled_linear.py ``apply_linear``): every
// SmolLM-360M linear (M = the prefill bucket, 64-1024, or the 4 decode
// slots; K, N in {960, 320, 2560}) and the CNN heads (M = microbatch
// rows; K = 2048 or 1280; N = 1000).
//
// What bounds it on an H100: at prefill widths the int32 output write
// (4 M N bytes over 3.35 TB/s: 3.1 us at 1024 x 2560) with the int8 MACs
// (1,979 TOP/s) below it; in decode and at the heads (M <= 16) the codes,
// read once (0.73 us for the 2.46 MB at 960 x 2560).  The design:
//   * Two variants, picked by the wrapper's plan (kernels/cfmm_matmul.py
//     ``plan``).  rows (M >= 17): a block of 4 warps (2 x 2, 32 x 32
//     each) owns a 64 x 64 output tile and walks K in chunks of 64 rows
//     (a 128 x 64 tile of 64 x 32 warp tiles, tried first, was slower at
//     the 1024-token shapes: at 199 registers one or two blocks share an
//     SM, too few warps to hide a chunk's latencies).
//     split (M <= 16): a block owns one m16 tile (rows past M are never
//     written) of 64 columns and walks K in chunks of 128 rows, warp w
//     taking the chunk's k32 step w for all 64 columns; the four warps'
//     partial sums are added at the end.
//   * K is split over grid.z where the tiles alone do not fill the card
//     (at M = 4, N = 960 the column tiles give 15 blocks).  The splits of
//     a tile are one thread-block cluster (up to 16 blocks): each leaves
//     its int32 partial tile in its shared memory and, after a cluster
//     barrier, adds a 1/splits share of the tile from every split over
//     distributed shared memory and writes it.  Integer sums are exact in
//     any order, and the scale is applied once, to the full sum.  No
//     workspace, no atomics, no zeroed output, so no second launch: a
//     CUDA-graph replay equals the eager call.
//   * A ring of 4 chunk buffers in shared memory (under 48 KB, no
//     opt-in) filled by cp.async: x rows and code
//     rows in 16-, 8- or 4-byte copies where K, N and the pointers allow,
//     else byte loads.  The K tail of x is cp.async's zero fill; what is
//     left in shared memory past M, past N, or in code rows past K meets
//     only zero x bytes or outputs that are never written.
//   * MACs on mma.sync.m16n8k32.row.col.s32.s8.s8.s32.  The fragment code
//     is conv_mma.cuh's dense weight path, shared rather than repeated:
//     A by ldmatrix from rows padded by 16 bytes; B straight from the
//     row-major (K, N) codes, staged [k][n] in that file's swizzled layout
//     (``bd_word``) and turned into K-consecutive column words by its 4 x 4
//     ``__byte_perm`` transpose (``transpose4``), so the compiled bytes
//     are read as they are and no second copy of the weights exists.  (The
//     other candidate, sparse_matvec.cu's split variant, expands bitmaps
//     into a [n][k] tile and adds splits with atomics into a zeroed
//     output; neither fits a dense operand whose scaled output may not be
//     split-summed.)  A thread's accumulators then cover 8 consecutive
//     columns of a row, which the epilogue stores as two 16-byte words.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "cluster_launch.cuh"
#include "conv_mma.cuh"

namespace {

namespace cm = repro::conv_mma;

constexpr int BN = 64;                  // output columns per tile
constexpr int THREADS = 128;            // 4 warps
constexpr int MAX_SPLITS = 16;          // blocks of a cluster (non-portable)
constexpr int PART_PITCH = BN + 4;      // ints per partial row: the
                                        // fragment stores hit 32 banks
static_assert(BN == cm::BN, "the staged code rows use conv_mma's layout");

template <bool SPLIT>
struct Cfg;
template <>
struct Cfg<false> {                     // rows
  static constexpr int TM = 64, BK = 64, STAGES = 4, RT = 2, NG = 1;
  static constexpr int PARTS = 1;       // partial tiles per block
};
template <>
struct Cfg<true> {                      // split
  static constexpr int TM = 16, BK = 128, STAGES = 4, RT = 1, NG = 2;
  static constexpr int PARTS = 4;       // one per warp (k32 step)
};

template <bool SPLIT>
struct Geo {
  using C = Cfg<SPLIT>;
  static constexpr int A_PITCH = C::BK + 16;    // ldmatrix: no bank twice
  static constexpr int A_BYTES = C::TM * A_PITCH;
  static constexpr int B_BYTES = C::BK * BN;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int SMEM = C::STAGES * STAGE;
  static_assert(SMEM <= 48 * 1024, "no opt-in attribute");
  static_assert(C::PARTS * C::TM * PART_PITCH * 4 <= SMEM,
                "the partials reuse the ring");
};

struct Args {
  const int8_t* x;
  const int8_t* w;
  const float* scale;
  int32_t* out_i32;
  float* out_f32;
  int M, K, N;
  int splits, chunks_per;
  int xvec, wvec;               // bytes per copy: 16, 8, 4 or 1
  int vec_out;                  // N % 4 == 0: 16-byte output stores
};

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   cm::smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ int4 ld_cluster_v4(unsigned addr) {
  int4 v;
  asm volatile("ld.shared::cluster.v4.s32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// Copy a ROWS x COLS byte tile of a row-major int8 matrix (row r at
// src + r * ld) into shared memory at dst + off(r, c), VEC bytes per copy.
// Rows at or past n_rows are left as they are; bytes at or past n_cols
// are zeros (n_cols is a multiple of VEC).
template <int ROWS, int COLS, int VEC, typename Off>
__device__ __forceinline__ void stage(uint8_t* dst, Off off,
                                      const int8_t* src, size_t ld,
                                      int n_rows, int n_cols, int tid) {
  constexpr int PER_ROW = COLS / VEC;
#pragma unroll 4
  for (int i = tid; i < ROWS * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    if (r >= n_rows) continue;
    const bool ok = c < n_cols;
    const int8_t* s = ok ? src + r * ld + c : src;
    uint8_t* d = dst + off(r, c);
    if (VEC == 16) cm::cp_async16(d, s, ok ? 16 : 0);
    else if (VEC == 8) cp_async8(d, s, ok ? 8 : 0);
    else if (VEC == 4) cm::cp_async4(d, s, ok ? 4 : 0);
    else *d = ok ? (uint8_t)__ldg(s) : (uint8_t)0;
  }
}

template <int ROWS, int COLS, typename Off>
__device__ __forceinline__ void stage_vec(int vec, uint8_t* dst, Off off,
                                          const int8_t* src, size_t ld,
                                          int n_rows, int n_cols, int tid) {
  switch (vec) {
    case 16: stage<ROWS, COLS, 16>(dst, off, src, ld, n_rows, n_cols, tid);
      break;
    case 8: stage<ROWS, COLS, 8>(dst, off, src, ld, n_rows, n_cols, tid);
      break;
    case 4: stage<ROWS, COLS, 4>(dst, off, src, ld, n_rows, n_cols, tid);
      break;
    default: stage<ROWS, COLS, 1>(dst, off, src, ld, n_rows, n_cols, tid);
  }
}

template <bool SPLIT>
__global__ void __launch_bounds__(THREADS) cfmm_mma_kernel(Args a) {
  using C = Cfg<SPLIT>;
  using G = Geo<SPLIT>;
  constexpr int TM = C::TM, BK = C::BK, S = C::STAGES, RT = C::RT;
  constexpr int NT = 4 * C::NG;         // n8 tiles per warp
  constexpr int WR = 16 * RT;           // rows per warp
  extern __shared__ __align__(16) uint8_t smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, c4 = lane & 3;
  const int wm = SPLIT ? 0 : (warp & 1), wn = SPLIT ? 0 : (warp >> 1);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * TM;
  const int n_chunks = (a.K + BK - 1) / BK;
  const int c_lo = blockIdx.z * a.chunks_per;
  const int n_local = min(a.chunks_per, n_chunks - c_lo);
  const int rows_m = min(TM, a.M - m0), cols_n = min(BN, a.N - n0);
  const int8_t* xt = a.x + (size_t)m0 * a.K;
  const int8_t* wt = a.w + n0;

  const auto a_off = [](int r, int c) { return r * G::A_PITCH + c; };
  const auto b_off = [](int r, int c) {
    return cm::bd_word(r, c >> 2) * 4 + (c & 3);
  };
  auto issue = [&](int i) {     // chunk c_lo + i into stage i % S
    if (i < n_local) {
      const int k0 = (c_lo + i) * BK;
      uint8_t* st = smem + (i % S) * G::STAGE;
      stage_vec<BK, BN>(a.wvec, st + G::A_BYTES, b_off,
                        wt + (size_t)k0 * a.N, a.N, a.K - k0, cols_n, tid);
      stage_vec<TM, BK>(a.xvec, st, a_off, xt + k0, a.K, rows_m, a.K - k0,
                        tid);
    }
    cm::cp_async_commit();      // empty groups keep the count uniform
  };

  int acc[RT][NT][4];
#pragma unroll
  for (int mt = 0; mt < RT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;

  // rows: the warp's 32 x 32 over both k32 steps of the chunk; split: all
  // 16 x 64 over the chunk's k32 step ``warp``
  auto mma_chunk = [&](const uint8_t* As, const uint32_t* Bw) {
#pragma unroll
    for (int s = 0; s < (SPLIT ? 1 : BK / 32); ++s) {
      const int ks = SPLIT ? warp : s;
      uint32_t af[RT][4];
#pragma unroll
      for (int mt = 0; mt < RT; ++mt)
        cm::ldmatrix_x4(af[mt], As + (WR * wm + 16 * mt + (lane & 15)) *
                                         G::A_PITCH +
                                     ks * 32 + (lane >> 4) * 16);
      uint32_t bf[NT][2];       // n8 tile 4 g + j = columns 32 (wn + g) +
#pragma unroll                  // 4 g4 + j, K halves 0 and 1
      for (int g = 0; g < C::NG; ++g)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kb = ks * 32 + h * 16 + c4 * 4;
          uint32_t r[4], t[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            r[i] = Bw[cm::bd_word(kb + i, 8 * (wn + g) + g4)];
          cm::transpose4(r, t);
#pragma unroll
          for (int j = 0; j < 4; ++j) bf[4 * g + j][h] = t[j];
        }
#pragma unroll
      for (int mt = 0; mt < RT; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          cm::mma_s8(acc[mt][j], af[mt], bf[j][0], bf[j][1]);
    }
  };

  // ---- the ring ------------------------------------------------------------
  for (int i = 0; i < S - 1; ++i) issue(i);
  for (int i = 0; i < n_local; ++i) {
    cm::cp_async_wait<S - 2>();   // chunk i has landed ...
    __syncthreads();              // ... for every thread; stage (i - 1) % S
    issue(i + S - 1);             // is free
    const uint8_t* st = smem + (i % S) * G::STAGE;
    mma_chunk(st, reinterpret_cast<const uint32_t*>(st + G::A_BYTES));
  }
  cm::cp_async_wait<0>();
  __syncthreads();                // every warp is done with the ring

  // ---- partial tile(s) in shared memory ------------------------------------
  // accumulator (mt, 4 g + j, 2 hf + e) is row WR wm + 16 mt + 8 hf + g4,
  // column 32 (wn + g) + 8 c4 + 4 e + j: eight consecutive columns per row
  int* part = reinterpret_cast<int*>(smem);
  {
    const int p = SPLIT ? warp : 0;
#pragma unroll
    for (int mt = 0; mt < RT; ++mt)
#pragma unroll
      for (int g = 0; g < C::NG; ++g)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = WR * wm + 16 * mt + 8 * hf + g4;
          int4* dst = reinterpret_cast<int4*>(
              part + (p * TM + r) * PART_PITCH + 32 * (wn + g) + 8 * c4);
          const int q = 4 * g;
          dst[0] = make_int4(acc[mt][q][2 * hf], acc[mt][q + 1][2 * hf],
                             acc[mt][q + 2][2 * hf], acc[mt][q + 3][2 * hf]);
          dst[1] = make_int4(acc[mt][q][2 * hf + 1],
                             acc[mt][q + 1][2 * hf + 1],
                             acc[mt][q + 2][2 * hf + 1],
                             acc[mt][q + 3][2 * hf + 1]);
        }
  }
  const int splits = a.splits, rank = blockIdx.z;  // cluster (1, 1, splits)
  if (splits > 1) cooperative_groups::this_cluster().sync();
  else __syncthreads();

  // ---- this block's share of the tile: every split's partials added, the
  // scale applied once, 4 columns per thread and step -----------------------
  const int units = rows_m * (BN / 4);
  const int u_lo = units * rank / splits, u_hi = units * (rank + 1) / splits;
  for (int u = u_lo + tid; u < u_hi; u += THREADS) {
    const int r = u / (BN / 4), q = (u % (BN / 4)) * 4;
    const int n = n0 + q;
    if (n >= a.N) continue;
    int4 s = make_int4(0, 0, 0, 0);
#pragma unroll 4
    for (int z = 0; z < splits; ++z) {
#pragma unroll
      for (int p = 0; p < C::PARTS; ++p) {
        const int* src = part + (p * TM + r) * PART_PITCH + q;
        const int4 v = z == rank ? *reinterpret_cast<const int4*>(src)
                                 : ld_cluster_v4(cm::cluster_addr(src, z));
        s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
      }
    }
    const size_t o = (size_t)(m0 + r) * a.N + n;
    const int sv[4] = {s.x, s.y, s.z, s.w};
    if (a.vec_out && n + 3 < a.N) {
      if (a.out_i32) *reinterpret_cast<int4*>(a.out_i32 + o) = s;
      if (a.out_f32)
        *reinterpret_cast<float4*>(a.out_f32 + o) = make_float4(
            __int2float_rn(sv[0]) * __ldg(a.scale + n),
            __int2float_rn(sv[1]) * __ldg(a.scale + n + 1),
            __int2float_rn(sv[2]) * __ldg(a.scale + n + 2),
            __int2float_rn(sv[3]) * __ldg(a.scale + n + 3));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (n + e >= a.N) break;
        if (a.out_i32) a.out_i32[o + e] = sv[e];
        if (a.out_f32)
          a.out_f32[o + e] = __int2float_rn(sv[e]) * __ldg(a.scale + n + e);
      }
    }
  }
  // no block leaves while another may still read its partials
  if (splits > 1) cooperative_groups::this_cluster().sync();
}

bool vec_ok(int vec, int n, const void* p) {
  return (vec == 16 || vec == 8 || vec == 4 || vec == 1) && n % vec == 0 &&
         reinterpret_cast<uintptr_t>(p) % vec == 0;
}

}  // namespace

// Plain C interface for ctypes.  out_i32 (M, N) and/or out_f32 (M, N) with
// scale (N,).  variant 0: rows; 1: split (M <= 16).  grid.z = ``splits``
// ranges of ``chunks_per`` K chunks (64 rows for rows, 128 for split);
// xvec / wvec: bytes per copy of x / code rows (16, 8, 4 or 1; K / N and
// the pointer are multiples).  The wrapper's ``plan`` picks them all.
// Returns cudaGetLastError() after the launch; cudaErrorInvalidValue (1)
// for arguments it does not take.
extern "C" int cfmm_matmul_launch(const int8_t* x, const int8_t* w,
                                  const float* scale, int32_t* out_i32,
                                  float* out_f32, int M, int K, int N,
                                  int variant, int splits, int chunks_per,
                                  int xvec, int wvec, void* stream) {
  const bool split = variant == 1;
  const int tm = split ? Cfg<true>::TM : Cfg<false>::TM;
  const int bk = split ? Cfg<true>::BK : Cfg<false>::BK;
  const int n_chunks = K > 0 ? (K + bk - 1) / bk : 0;
  if (M < 1 || K < 1 || N < 1 || (variant != 0 && variant != 1) ||
      (split && M > tm) || (M + tm - 1) / tm > 65535 || splits < 1 ||
      splits > MAX_SPLITS || chunks_per < 1 ||
      (splits - 1) * chunks_per >= n_chunks ||
      splits * chunks_per < n_chunks || !vec_ok(xvec, K, x) ||
      !vec_ok(wvec, N, w) || (!out_i32 && !out_f32) || (out_f32 && !scale))
    return (int)cudaErrorInvalidValue;
  Args a{x, w, scale, out_i32, out_f32, M, K, N, splits, chunks_per, xvec,
         wvec, 0};
  a.vec_out = N % 4 == 0 &&
              reinterpret_cast<uintptr_t>(out_i32) % 16 == 0 &&
              reinterpret_cast<uintptr_t>(out_f32) % 16 == 0;
  const dim3 grid((N + BN - 1) / BN, (M + tm - 1) / tm, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split)
    return repro::launch_split_z<cfmm_mma_kernel<true>>(
        grid, THREADS, Geo<true>::SMEM, s, splits, a);
  return repro::launch_split_z<cfmm_mma_kernel<false>>(
      grid, THREADS, Geo<false>::SMEM, s, splits, a);
}
