// Block-sparse constant-weight matmul for sm_90a: bf16 on the tensor
// cores, f32 on the CUDA cores.
//
// Replaces block_sparse_matmul_pallas (src/repro/kernels/block_sparse.py:64).
// x (M, K) row-major, f32 or bf16; w_blocks (n_active, bk, bn) of x's
// type, the active weight blocks in plan order (column-major: the blocks
// of output block column nb are offsets[nb] .. offsets[nb + 1] - 1, in
// ascending k); meta (4, n_active) int32, row 0 the k-block of each
// active block; out (M, n_blocks_n * bn) in x's type.  Per output
// element: the f32 sum over its column's active blocks, ascending k, of
// x[m, kb * bk + k] * w_block[k, n], rounded once to x's type.  As in
// the TPU kernel, each active block's product is summed in a fresh f32
// accumulator and then added to the column's f32 sum (a sum of K terms
// in one running accumulator would round at every step and drift up to
// 3e-4 off the plain version at K = 2048).  Block columns with no active
// block are written as zeros.  The TPU kernel's grid walks the active
// blocks with first/last flags; here the CSC offsets bound each tile's
// walk instead.
//
// What bounds it on an H100: in bf16, with the tensor cores' 989
// TFLOP/s, bytes (x, the active blocks and the output once each, at 3.35
// TB/s) at ResNet50's 1x1 shapes and operations at SmolLM-360M's
// 1024-token gate/up; in f32, operations (2 M bk bn flops per active
// block at 67 TFLOP/s on the CUDA cores; TF32 would change the function).
// The design:
//   * A block of 4 warps owns a 64 x 64 output tile of one block column
//     (a block column wider than 64 takes several tiles) and walks the
//     column's active blocks, each in steps of 32 k-rows.  Every step's
//     x slice (64 x 32) and weight rows (32 x 64) come into a ring of
//     shared-memory stages by cp.async (bf16: 4 deep; f32, whose steps
//     are long, 2), one step ahead or more of the MACs and across block
//     boundaries: 16-byte copies where K, bk, bn and the pointers allow,
//     else 4-byte, else element loads.  Ragged M, blocks that are no
//     multiple of the tile (48 x 80, 32 x 24) and the k tail of a block
//     are cp.async's zero fill; nothing is padded in memory.
//   * bf16: mma.sync.m16n8k16 bf16 -> f32, each warp a 32 x 32 quarter of
//     the tile; x fragments by ldmatrix, weight fragments by
//     ldmatrix.trans from the row-major (bk, bn) rows (as
//     flash_attention.cu loads V), rows padded by 16 bytes so that no
//     bank is read twice.  f32: each thread 8 rows x 4 columns of FMAs,
//     16-byte shared loads along k for x and along n for the weights.
//     Either way the block's product goes to a fresh accumulator that is
//     added to the column's at the block's last step.
//   * At small M the tiles do not fill the 132 SMs (16 tiles at ResNet50
//     conv5_x), so the wrapper's plan (kernels/block_sparse.py ``plan``)
//     splits each column's active blocks over grid.z: split z of a
//     column with c active blocks takes blocks [c z / S, c (z + 1) / S).
//     The splits of a tile are one thread-block cluster: each leaves its
//     f32 partial tile in its shared memory and, after a cluster
//     barrier, writes a 1/S share of the tile as the sum of the S
//     partials in ascending z, read over distributed shared memory.  The
//     order is fixed, so two calls, and CUDA-graph replays, agree to the
//     bit; no float atomics, no workspace, no second launch.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cluster_launch.cuh"
#include "conv_mma.cuh"

namespace {

namespace cm = repro::conv_mma;

constexpr int TM = 64;                    // output rows per tile
constexpr int TN = 64;                    // output columns per tile
constexpr int KS = 32;                    // k-rows of a block per step
constexpr int THREADS = 128;              // 4 warps
constexpr int MAX_SPLITS = 16;            // blocks of a cluster
constexpr int PART_PITCH = TN + 4;        // floats per partial row

template <typename T>
struct Geo;
template <>
struct Geo<__nv_bfloat16> {
  static constexpr int XP = KS + 8;       // x row pitch, elements (80 B)
  static constexpr int WP = TN + 8;       // weight row pitch (144 B)
  static constexpr int STAGES = 4;
};
template <>
struct Geo<float> {
  static constexpr int XP = KS + 4;       // 144 B: 16-byte loads along k
  static constexpr int WP = TN;
  static constexpr int STAGES = 2;
};
template <typename T>
struct Ring {
  static constexpr int X_BYTES = TM * Geo<T>::XP * (int)sizeof(T);
  static constexpr int W_BYTES = KS * Geo<T>::WP * (int)sizeof(T);
  static constexpr int STAGE = X_BYTES + W_BYTES;
  static constexpr int SMEM = Geo<T>::STAGES * STAGE;
  static_assert(SMEM <= 48 * 1024, "no opt-in attribute");
  static_assert(TM * PART_PITCH * 4 <= SMEM, "the partials reuse the ring");
};

struct Args {
  const void* x;
  const void* w_blocks;
  const int* kblock;                      // meta row 0
  const int* offsets;
  void* out;
  int M, K, bk, bn, tiles_n, splits;
};

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(cm::smem_addr(p)));
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
__device__ __forceinline__ float ld_cluster_f32(unsigned addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);             // round to nearest even
}

// Copy a ROWS x COLS tile of a row-major T matrix (row r at src + r * ld)
// into shared memory at dst + r * pitch, VEC bytes per copy (16 or 4 by
// cp.async; sizeof(T) is a plain load).  Elements of rows at or past
// n_rows, or of columns at or past n_cols (a multiple of VEC /
// sizeof(T)), are zeros.
template <typename T, int ROWS, int COLS, int VEC>
__device__ __forceinline__ void stage(T* dst, int pitch, const T* src,
                                      size_t ld, int n_rows, int n_cols,
                                      int tid) {
  constexpr int E = VEC / (int)sizeof(T);  // elements per copy
  constexpr int PER_ROW = COLS / E;
#pragma unroll 4
  for (int i = tid; i < ROWS * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * E;
    const bool ok = r < n_rows && c < n_cols;
    const T* s = ok ? src + r * ld + c : src;
    T* d = dst + r * pitch + c;
    if (VEC == 16) cm::cp_async16(d, s, ok ? 16 : 0);
    else if (VEC == 4) cm::cp_async4(d, s, ok ? 4 : 0);
    else *d = ok ? s[0] : from_f<T>(0.f);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS) block_sparse_kernel(Args a) {
  using Gt = Geo<T>;
  using R = Ring<T>;
  constexpr bool MMA = sizeof(T) == 2;
  constexpr int S = Gt::STAGES;
  extern __shared__ __align__(16) uint8_t smem[];
  const T* x = static_cast<const T*>(a.x);
  const T* wb = static_cast<const T*>(a.w_blocks);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = blockIdx.x / a.tiles_n;
  const int n0 = (blockIdx.x - nb * a.tiles_n) * TN;  // within the column
  const int m0 = blockIdx.y * TM;
  const int N = (int)gridDim.x / a.tiles_n * a.bn;
  const int rows_m = min(TM, a.M - m0), cols_n = min(TN, a.bn - n0);
  const int splits = a.splits, z = blockIdx.z;   // cluster (1, 1, splits)

  // this split's share of the column's active blocks, in steps of KS rows
  const int lo = __ldg(a.offsets + nb), cnt = __ldg(a.offsets + nb + 1) - lo;
  const int b_lo = lo + (int)((long long)cnt * z / splits);
  const int b_hi = lo + (int)((long long)cnt * (z + 1) / splits);
  const int spb = (a.bk + KS - 1) / KS;
  const int n_steps = (b_hi - b_lo) * spb;

  int is_blk = b_lo, is_k0 = 0;           // the next step to issue
  auto issue = [&](int i) {               // step i into stage i % S
    if (i < n_steps) {
      uint8_t* st = smem + (i % S) * R::STAGE;
      const int kb = __ldg(a.kblock + is_blk);
      const int n_k = min(KS, a.bk - is_k0);
      stage<T, TM, KS, VEC>(reinterpret_cast<T*>(st), Gt::XP,
                            x + (size_t)m0 * a.K + (size_t)kb * a.bk + is_k0,
                            a.K, rows_m, n_k, tid);
      stage<T, KS, TN, VEC>(
          reinterpret_cast<T*>(st + R::X_BYTES), Gt::WP,
          wb + ((size_t)is_blk * a.bk + is_k0) * a.bn + n0, a.bn, n_k,
          cols_n, tid);
      is_k0 += KS;
      if (is_k0 >= a.bk) { is_k0 = 0; ++is_blk; }
    }
    cm::cp_async_commit();                // empty groups keep the count
  };

  // bf16: warp (wm, wn) owns rows 32 wm.., columns 32 wn..: fragment
  // (mt, j, e) is row 32 wm + 16 mt + 8 (e >> 1) + g4, column 32 wn + 8 j
  // + 2 c4 + (e & 1).  f32: thread (ty, tx) owns rows 8 ty + i, columns
  // 4 tx + j.
  constexpr int RA = MMA ? 2 : 8, RB = MMA ? 4 : 1;   // [mt][j] / [i][0]
  float acc[RA][RB][4], part[RA][RB][4];
#pragma unroll
  for (int i = 0; i < RA; ++i)
#pragma unroll
    for (int j = 0; j < RB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = part[i][j][e] = 0.f;
  const int g4 = lane >> 2, c4 = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  const int tx = tid & 15, ty = tid >> 4;

  auto mac_step = [&](const uint8_t* st) {
    const T* xs = reinterpret_cast<const T*>(st);
    const T* ws = reinterpret_cast<const T*>(st + R::X_BYTES);
    if constexpr (MMA) {
#pragma unroll
      for (int ks = 0; ks < KS / 16; ++ks) {
        uint32_t af[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          cm::ldmatrix_x4(af[mt], xs + (32 * wm + 16 * mt + (lane & 15)) *
                                           Gt::XP +
                                       ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, ws + (ks * 16 + (lane & 7) +
                                     ((lane >> 3) & 1) * 8) * Gt::WP +
                                   32 * wn + np * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(part[mt][2 * np], af[mt], b[0], b[1]);
            mma_bf16(part[mt][2 * np + 1], af[mt], b[2], b[3]);
          }
        }
      }
    } else {
#pragma unroll 2
      for (int k = 0; k < KS; k += 4) {
        float4 xv[8], wv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          xv[i] = *reinterpret_cast<const float4*>(
              reinterpret_cast<const float*>(xs) + (8 * ty + i) * Gt::XP + k);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wv[kk] = *reinterpret_cast<const float4*>(
              reinterpret_cast<const float*>(ws) + (k + kk) * Gt::WP + 4 * tx);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float xk[4] = {xv[i].x, xv[i].y, xv[i].z, xv[i].w};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float wk[4] = {wv[kk].x, wv[kk].y, wv[kk].z, wv[kk].w};
#pragma unroll
            for (int j = 0; j < 4; ++j)
              part[i][0][j] = fmaf(xk[kk], wk[j], part[i][0][j]);
          }
        }
      }
    }
  };

  // ---- the ring ------------------------------------------------------------
#pragma unroll
  for (int i = 0; i < S - 1; ++i) issue(i);
  int k_step = 0;                         // the computed step's place in
  for (int i = 0; i < n_steps; ++i) {     // its block
    cm::cp_async_wait<S - 2>();           // step i has landed ...
    __syncthreads();                      // ... for every thread; stage
    issue(i + S - 1);                     // (i - 1) % S is free
    mac_step(smem + (i % S) * R::STAGE);
    if (++k_step == spb) {                // the block's last step
      k_step = 0;
#pragma unroll
      for (int i = 0; i < RA; ++i)
#pragma unroll
        for (int j = 0; j < RB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[i][j][e] += part[i][j][e];
            part[i][j][e] = 0.f;
          }
    }
  }
  cm::cp_async_wait<0>();
  __syncthreads();                        // every warp is done with the ring

  // ---- the partial tile in shared memory -----------------------------------
  float* ps = reinterpret_cast<float*>(smem);
  if constexpr (MMA) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = 32 * wm + 16 * mt + 8 * hf + g4;
          const int c = 32 * wn + 8 * j + 2 * c4;
          *reinterpret_cast<float2*>(ps + r * PART_PITCH + c) =
              make_float2(acc[mt][j][2 * hf], acc[mt][j][2 * hf + 1]);
        }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<float4*>(ps + (8 * ty + i) * PART_PITCH + 4 * tx) =
          make_float4(acc[i][0][0], acc[i][0][1], acc[i][0][2],
                      acc[i][0][3]);
  }
  if (splits > 1) cooperative_groups::this_cluster().sync();
  else __syncthreads();

  // ---- this block's share of the tile: the splits' partials added in
  // ascending z, rounded once to T ------------------------------------------
  T* out = static_cast<T*>(a.out);
  const int elems = rows_m * TN;
  const int e_lo = elems * z / splits, e_hi = elems * (z + 1) / splits;
  for (int e = e_lo + tid; e < e_hi; e += THREADS) {
    const int r = e / TN, c = e % TN;
    if (c >= cols_n) continue;
    const float* src = ps + r * PART_PITCH + c;
    float v = 0.f;
#pragma unroll 4
    for (int q = 0; q < splits; ++q) {
      const float p = q == z ? *src : ld_cluster_f32(cm::cluster_addr(src, q));
      v = q == 0 ? p : v + p;
    }
    out[(size_t)(m0 + r) * N + (size_t)nb * a.bn + n0 + c] = from_f<T>(v);
  }
  // no block leaves while another may still read its partials
  if (splits > 1) cooperative_groups::this_cluster().sync();
}

template <typename T>
int launch_typed(const Args& a, int vec, dim3 grid, cudaStream_t s) {
  constexpr int SMEM = Ring<T>::SMEM;
  switch (vec) {
    case 16:
      return repro::launch_split_z<block_sparse_kernel<T, 16>>(
          grid, THREADS, SMEM, s, a.splits, a);
    case 4:
      return repro::launch_split_z<block_sparse_kernel<T, 4>>(
          grid, THREADS, SMEM, s, a.splits, a);
    default:
      return repro::launch_split_z<block_sparse_kernel<T, (int)sizeof(T)>>(
          grid, THREADS, SMEM, s, a.splits, a);
  }
}

}  // namespace

// splits: grid.z, the ranges of each column's active blocks (the wrapper's
// ``plan``); vec: bytes per copy of x and weight rows (16, 4 or the
// element size; K, bk, bn and the pointers are multiples).  Returns
// cudaGetLastError() after the launch; cudaErrorInvalidValue (1) for
// arguments the kernel does not take (the wrapper checks them first).
extern "C" int block_sparse_launch(const void* x, const void* w_blocks,
                                   const void* meta, const void* offsets,
                                   void* out, int M, int K, int bk, int bn,
                                   int n_blocks_n, int bf16, int splits,
                                   int vec, void* stream) {
  const int elt = bf16 ? 2 : 4;
  const int e = vec / elt;
  const int tiles_n = bn > 0 ? (bn + TN - 1) / TN : 0;
  if (M < 1 || bk < 1 || bn < 1 || K % bk != 0 || n_blocks_n < 1 ||
      (M + TM - 1) / TM > 65535 ||
      (long long)n_blocks_n * tiles_n > 0x7fffffffLL || splits < 1 ||
      splits > MAX_SPLITS || (vec != 16 && vec != 4 && vec != elt) ||
      e < 1 || K % e || bk % e || bn % e ||
      reinterpret_cast<uintptr_t>(x) % vec ||
      reinterpret_cast<uintptr_t>(w_blocks) % vec)
    return (int)cudaErrorInvalidValue;
  const Args a{x, w_blocks, static_cast<const int*>(meta),
               static_cast<const int*>(offsets), out, M, K, bk, bn,
               tiles_n, splits};
  const dim3 grid(n_blocks_n * tiles_n, (M + TM - 1) / TM, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_typed<__nv_bfloat16>(a, vec, grid, s);
  return launch_typed<float>(a, vec, grid, s);
}
