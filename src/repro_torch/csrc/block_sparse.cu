// Block-sparse constant-weight matmul for sm_90a.
//
// Replaces block_sparse_matmul_pallas (src/repro/kernels/block_sparse.py:64).
// x (M, K) row-major, f32 or bf16; w_blocks (n_active, bk, bn) of x's
// type, the active weight blocks in plan order (column-major: the blocks
// of output block column nb are offsets[nb] .. offsets[nb + 1] - 1, in
// ascending k); meta (4, n_active) int32, row 0 the k-block of each
// active block; out (M, n_blocks_n * bn) in x's type.  Per output
// element: the f32 sum over its column's active blocks, ascending k, of
// x[m, kb * bk + k] * w_block[k, n], rounded once to x's type.  As in
// the TPU kernel, each active block's product is summed on its own and
// then added to the column's f32 accumulator (a sum of K terms in one
// running accumulator would round at every step and drift up to 3e-4
// off the plain version at K = 2048).  Block columns with no active
// block are written as zeros.  The TPU kernel's grid walks the active
// blocks with first/last flags; here the CSC offsets bound each block's
// loop instead.
//
// Layout: one block of 256 threads per (64-row M tile, 64-column tile
// of one block column); a block column wider than 64 takes several
// tiles.  The block walks only its column's active k-blocks and stages
// each through shared memory 16 k-rows at a time: the x tile (64 x 16,
// stored k-major) and the weight tile (16 x 64), both widened to f32.
// Each thread keeps 4 x 4 register tiles of f32 sums (the block's and
// the column's) and reads its four rows and four columns of a k-row as
// two 16-byte shared-memory loads.
// Ragged M, and bk or bn that are no multiple of the tile, are masked:
// masked elements are staged as 0 and never written, nothing is padded.
//
// What bounds it on an H100: in f32, operations (2 M bk bn flops per
// active block at 67 TFLOP/s on the CUDA cores; no TF32, which would
// change the function); in bf16, with the tensor cores' 989 TFLOP/s,
// bytes (x, the active blocks and the output once each, at 3.35 TB/s)
// at ResNet50's 1x1 shapes and operations at SmolLM-360M's 1024-token
// gate/up.  This first kernel does f32 FMAs on the CUDA cores, one
// 16-byte shared load per 8 FMAs, stages each k-step with no load in
// flight during its FMAs, and launches as few as 16 blocks on 132 SMs
// at small M, so it sits above the f32 bound and far above the bf16 one
// (PERF.md); double-buffered staging (cp.async / TMA), a split over
// k-blocks at small M and wgmma tiles are the next steps.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TM = 64;                    // output rows per block
constexpr int TN = 64;                    // output columns per block
constexpr int TK = 16;                    // k-rows staged per step
constexpr int THREADS = 256;              // 16 x 16 threads, 4 x 4 each
constexpr int XS_LD = TM + 4;             // x tile row stride (floats)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);             // round to nearest even
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
block_sparse_kernel(const T* __restrict__ x, const T* __restrict__ w_blocks,
                    const int* __restrict__ kblock,
                    const int* __restrict__ offsets, T* __restrict__ out,
                    int M, int K, int bk, int bn, int tiles_n) {
  __shared__ __align__(16) float xs[TK][XS_LD];   // [k][m]
  __shared__ __align__(16) float ws[TK][TN];      // [k][n]
  const int nb = blockIdx.x / tiles_n;
  const int n0 = (blockIdx.x - nb * tiles_n) * TN;  // within the block column
  const int m0 = blockIdx.y * TM;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int N = (int)gridDim.x / tiles_n * bn;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int lo = offsets[nb], hi = offsets[nb + 1];
  for (int blk = lo; blk < hi; ++blk) {
    const T* xb = x + (size_t)kblock[blk] * bk;
    const T* wb = w_blocks + (size_t)blk * bk * bn;
    float part[4][4];                     // this block's product
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
    for (int k0 = 0; k0 < bk; k0 += TK) {
      __syncthreads();                    // the previous tiles are consumed
      for (int e = threadIdx.x; e < TM * TK; e += THREADS) {
        const int r = e / TK, c = e - r * TK;
        const int m = m0 + r, k = k0 + c;
        xs[c][r] = (m < M && k < bk) ? to_f(xb[(size_t)m * K + k]) : 0.f;
      }
      for (int e = threadIdx.x; e < TK * TN; e += THREADS) {
        const int r = e / TN, c = e - r * TN;
        const int k = k0 + r, n = n0 + c;
        ws[r][c] = (k < bk && n < bn) ? to_f(wb[(size_t)k * bn + n]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < TK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[k][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&ws[k][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            part[i][j] = fmaf(av[i], bv[j], part[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < bn) out[(size_t)m * N + (size_t)nb * bn + n] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch_typed(const void* x, const void* w_blocks, const int* kblock,
                 const int* offsets, void* out, int M, int K, int bk, int bn,
                 int n_blocks_n, cudaStream_t stream) {
  const int tiles_n = (bn + TN - 1) / TN;
  const dim3 grid(n_blocks_n * tiles_n, (M + TM - 1) / TM);
  block_sparse_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_blocks), kblock,
      offsets, static_cast<T*>(out), M, K, bk, bn, tiles_n);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch; cudaErrorInvalidValue (1)
// for shapes the kernel does not take (the wrapper checks them first).
extern "C" int block_sparse_launch(const void* x, const void* w_blocks,
                                   const void* meta, const void* offsets,
                                   void* out, int M, int K, int bk, int bn,
                                   int n_blocks_n, int bf16, void* stream) {
  if (M < 1 || bk < 1 || bn < 1 || K % bk != 0 || n_blocks_n < 1 ||
      (M + TM - 1) / TM > 65535 ||
      (long long)n_blocks_n * ((bn + TN - 1) / TN) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* kblock = static_cast<const int*>(meta);   // meta row 0
  const int* offs = static_cast<const int*>(offsets);
  if (bf16)
    return launch_typed<__nv_bfloat16>(x, w_blocks, kblock, offs, out, M, K,
                                       bk, bn, n_blocks_n, s);
  return launch_typed<float>(x, w_blocks, kblock, offs, out, M, K, bk, bn,
                             n_blocks_n, s);
}
