// int8 GEMM for the cfmm serve mode: x (M, K) int8 @ codes (K, N) int8
// -> the exact int32 product, and, when a per-column scale is given,
// f32 out = float(acc) * scale[n] (one rounding).
//
// Work decomposition.  A block owns COLS = 128 columns (four per lane,
// one 32-bit word of a weight row) and MT = 8 rows of x, and splits K
// over its 8 warps.  Each step a lane reads four weight rows of its four
// columns as four coalesced words, transposes the 4 x 4 bytes with
// __byte_perm so each column's four K-consecutive codes share a word,
// and issues __dp4a against the matching word of each x row (a
// broadcast read).  The warps' partial sums meet in shared memory; int32
// adds are exact in any order.  At M <= 8 (the classifier head) every
// weight byte is read once, which is what bounds the call: the weights
// are nearly all of its bytes.  Ragged edges (K or N not a multiple of
// four, or unaligned pointers) take a byte-wise path with masks.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;        // K segments per block (one per warp)
constexpr int COLS = 128;       // columns per block: four per lane
constexpr int MT = 8;           // rows of x per block

// Four K-consecutive codes of x row m from k on, packed in a word.
__device__ __forceinline__ int load_x4(const int8_t* x, int K, int m, int k,
                                       bool vec) {
  const int8_t* p = x + (size_t)m * K + k;
  if (vec) return *reinterpret_cast<const int*>(p);
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (k + j < K) w |= (uint32_t)(uint8_t)p[j] << (8 * j);
  return (int)w;
}

// Rows k..k+3 of columns n..n+3 -> col[j] = the four codes of column
// n + j, row k in the low byte.
__device__ __forceinline__ void load_w4x4(const int8_t* w, int K, int N,
                                          int k, int n, bool vec,
                                          int col[4]) {
  if (vec && n + 3 < N) {
    uint32_t r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[i] = (k + i < K)
                 ? *reinterpret_cast<const uint32_t*>(w + (size_t)(k + i) * N + n)
                 : 0u;
    const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
    const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
    const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
    col[0] = (int)__byte_perm(t0, t1, 0x5410);
    col[1] = (int)__byte_perm(t0, t1, 0x7632);
    col[2] = (int)__byte_perm(t2, t3, 0x5410);
    col[3] = (int)__byte_perm(t2, t3, 0x7632);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t c = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (k + i < K && n + j < N)
        c |= (uint32_t)(uint8_t)w[(size_t)(k + i) * N + n + j] << (8 * i);
    col[j] = (int)c;
  }
}

__global__ void __launch_bounds__(WARPS * 32)
cfmm_matmul_kernel(const int8_t* __restrict__ x,
                   const int8_t* __restrict__ w,
                   const float* __restrict__ scale,
                   int32_t* __restrict__ out_i32,
                   float* __restrict__ out_f32, int M, int K, int N,
                   int vec_x, int vec_w) {
  __shared__ int part[WARPS][MT][COLS];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n = blockIdx.x * COLS + lane * 4;
  const int m0 = blockIdx.y * MT;
  const int k4 = (K + 3) / 4;                  // groups of four K rows
  const int seg = (k4 + WARPS - 1) / WARPS;
  const int g_lo = min(warp * seg, k4), g_hi = min(g_lo + seg, k4);

  int acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  if (n < N) {
    for (int g = g_lo; g < g_hi; ++g) {
      const int k = g * 4;
      int col[4];
      load_w4x4(w, K, N, k, n, vec_w, col);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (m0 + i < M) {
          const int xv = load_x4(x, K, m0 + i, k, vec_x);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(xv, col[j], acc[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) part[warp][i][lane * 4 + j] = acc[i][j];
  __syncthreads();
  for (int e = threadIdx.x; e < MT * COLS; e += WARPS * 32) {
    const int i = e / COLS, c = e - i * COLS;
    const int m = m0 + i, nn = blockIdx.x * COLS + c;
    if (m >= M || nn >= N) continue;
    int s = 0;
#pragma unroll
    for (int v = 0; v < WARPS; ++v) s += part[v][i][c];
    const size_t o = (size_t)m * N + nn;
    if (out_i32) out_i32[o] = s;
    if (out_f32) out_f32[o] = __int2float_rn(s) * scale[nn];
  }
}

}  // namespace

// Plain C interface for ctypes; returns the cudaGetLastError() of the
// launch.  out_i32 (M, N) and/or out_f32 (M, N) with scale (N,).
extern "C" int cfmm_matmul_launch(const int8_t* x, const int8_t* w,
                                  const float* scale, int32_t* out_i32,
                                  float* out_f32, int M, int K, int N,
                                  void* stream) {
  const int vec_x = (K % 4 == 0) && ((uintptr_t)x % 4 == 0);
  const int vec_w = (N % 4 == 0) && ((uintptr_t)w % 4 == 0);
  dim3 grid((N + COLS - 1) / COLS, (M + MT - 1) / MT);
  cfmm_matmul_kernel<<<grid, WARPS * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      x, w, scale, out_i32, out_f32, M, K, N, vec_x, vec_w);
  return (int)cudaGetLastError();
}
