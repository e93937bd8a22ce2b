// Bitmap-packed sparse matmul: x (M, K) int8 @ W (K, N) -> int32 (M, N),
// W given as bitmap (K/8, N) uint8 + values (keep_k, N) int8.
//
// A block owns 32 columns (one per lane) and splits K into 8 segments,
// one per warp.  Each thread first popcounts its column's bitmap bytes in
// its segment; a shared-memory prefix over the warps gives every segment
// its starting index into the column's packed values (the running
// nonzero count).  Each thread then walks its segment's set bits, gathers
// the packed value and accumulates MT rows of x in int32; the 8 segment
// partial sums are added in shared memory.  Only nonzero weights cost a
// MAC; every bitmap byte and value is read once per row tile.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int COLS = 32;    // columns per block (one per lane)
constexpr int SEGS = 8;     // K segments per block (one per warp)
constexpr int MT = 8;       // rows of x per block

__global__ void __launch_bounds__(COLS * SEGS)
sparse_matvec_kernel(const int8_t* __restrict__ x,
                     const uint8_t* __restrict__ bitmap,
                     const int8_t* __restrict__ values,
                     int32_t* __restrict__ out, int M, int K, int N,
                     int keep_k) {
  __shared__ int seg_cnt[SEGS][COLS];
  __shared__ int part[SEGS][MT][COLS];
  const int lane = threadIdx.x % COLS, warp = threadIdx.x / COLS;
  const int n = blockIdx.x * COLS + lane;
  const int m0 = blockIdx.y * MT;
  const int kb8 = K / 8;
  const int seg = (kb8 + SEGS - 1) / SEGS;
  const int b_lo = min(warp * seg, kb8), b_hi = min(b_lo + seg, kb8);
  const bool live = n < N;

  int cnt = 0;
  if (live)
    for (int b = b_lo; b < b_hi; ++b)
      cnt += __popc((unsigned)bitmap[(size_t)b * N + n]);
  seg_cnt[warp][lane] = cnt;
  __syncthreads();
  int pos = 0;
  for (int w = 0; w < warp; ++w) pos += seg_cnt[w][lane];

  int acc[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) acc[i] = 0;
  if (live) {
    for (int b = b_lo; b < b_hi; ++b) {
      unsigned bits = bitmap[(size_t)b * N + n];
      while (bits) {
        int j = __ffs(bits) - 1;
        bits &= bits - 1;
        int p = pos < keep_k ? pos : keep_k - 1;
        int v = values[(size_t)p * N + n];
        ++pos;
        int kk = b * 8 + j;
#pragma unroll
        for (int i = 0; i < MT; ++i)
          if (m0 + i < M) acc[i] += (int)x[(size_t)(m0 + i) * K + kk] * v;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) part[warp][i][lane] = acc[i];
  __syncthreads();
  if (warp == 0 && live) {
    for (int i = 0; i < MT && m0 + i < M; ++i) {
      int s = 0;
#pragma unroll
      for (int w = 0; w < SEGS; ++w) s += part[w][i][lane];
      out[(size_t)(m0 + i) * N + n] = s;
    }
  }
}

}  // namespace

extern "C" int sparse_matvec_launch(const int8_t* x, const uint8_t* bitmap,
                                    const int8_t* values, int32_t* out,
                                    int M, int K, int N, int keep_k,
                                    void* stream) {
  dim3 grid((N + COLS - 1) / COLS, (M + MT - 1) / MT);
  sparse_matvec_kernel<<<grid, COLS * SEGS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      x, bitmap, values, out, M, K, N, keep_k);
  return (int)cudaGetLastError();
}
