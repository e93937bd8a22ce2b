// Implicit-GEMM int8 SAME convolution with the fused Collector epilogue,
// shared by the dense (conv_implicit.cu) and bitmap-packed
// (conv_sparse.cu) kernels: one template on the weight source, so the MAC
// loop and the epilogue are the same code and the two kernels agree to
// the bit on the same (expanded) codes.  The epilogue (``collector``,
// ``amax_reduce``) is also the depthwise kernel's (conv_depthwise.cu).
//
// Work decomposition.  A block computes a BM x BN tile of output pixels x
// output channels of ONE image (blockIdx.z), so the per-image dequant row
// eff_scale[image] and the per-image amax stay per image.  K = k*k*C runs
// in BK-deep chunks in spatial-major order (row = tap*C + c).  Each chunk:
//   A  the implicit im2col tile, gathered straight from the NHWC input
//      with the SAME zero padding done by bounds checks, four K-consecutive
//      bytes packed per 32-bit word (the stem's C = 3 taps straddle words,
//      so it gathers byte by byte);
//   B  the weight tile, four K-consecutive codes per column packed per
//      word: read from the dense codes, or expanded from the bitmap and
//      the packed values with a running per-column nonzero count
//      (popcount of the bitmap bytes) carried from chunk to chunk;
// then every thread issues __dp4a over its 4 x 4 outputs, accumulating in
// int32.  The epilogue is y = fmaf(float(acc), eff_scale, eff_bias), then
// the shortcut — an f32 add, or for an int8 shortcut (the identity
// block's dequantized input) y = fmaf(float(q), sc_scale[image], y) —
// then ReLU, and a per-image max|y| over valid outputs, reduced with
// atomicMax on the bits of the non-negative float (order-independent, so
// exact).  Both fmaf roundings are the ones XLA's fused lowering of the
// same expressions makes.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

constexpr int BM = 64;             // output pixels per tile (one image)
constexpr int BN = 64;             // output channels per tile
constexpr int BK = 32;             // K rows per chunk
constexpr int BKW = BK / 4;        // packed 32-bit words per chunk row
constexpr int THREADS = 256;       // 16 x 16 threads, 4 x 4 outputs each
static_assert(BK / 8 * BN == THREADS,
              "sparse B loader maps one (column, bitmap byte) per thread");

struct ConvArgs {
  const int8_t* x;          // (N, H, W, C) int8 NHWC, unpadded
  const int8_t* w;          // dense: (K, n_out) spatial-major codes
  const uint8_t* bitmap;    // sparse: (Kb8, n_out) validity bits down K
  const int8_t* values;     // sparse: (keep_k, n_out) nonzero codes
  const float* eff_scale;   // (N, n_out) dequant * BN scale, per image
  const float* eff_bias;    // (n_out,)
  const float* shortcut;    // (N, h_out, w_out, n_out) f32, or null
  const int8_t* sc_q;       // or an int8 shortcut (N, h_out, w_out, n_out)
  const float* sc_scale;    //   with its per-image scale (N,), or null
  float* y;                 // (N, h_out, w_out, n_out) f32
  unsigned int* amax;       // (N,) bits of max|y|, zero on entry
  int32_t* acc_out;         // (N, h_out, w_out, n_out) int32, or null
  int N, H, W, C, n_out, k, stride, pad_top, pad_left, h_out, w_out;
  int K;                    // k*k*C
  int Kb8;                  // bitmap rows (sparse): ceil(K/8)
  int keep_k;               // packed values per column (sparse)
  int relu;
};

__device__ __forceinline__ uint32_t pack4(int b0, int b1, int b2, int b3) {
  return (uint32_t)(b0 & 0xff) | ((uint32_t)(b1 & 0xff) << 8) |
         ((uint32_t)(b2 & 0xff) << 16) | ((uint32_t)(b3 & 0xff) << 24);
}

// One input byte of the implicit im2col row of output pixel (oh, ow),
// K index kk; zero outside the image (SAME padding) and past K.
__device__ __forceinline__ int im2col_byte(const ConvArgs& a,
                                           const int8_t* x_img, int oh,
                                           int ow, int kk) {
  if (kk >= a.K) return 0;
  int tap = kk / a.C, c = kk - tap * a.C;
  int dy = tap / a.k, dx = tap - dy * a.k;
  int ih = oh * a.stride + dy - a.pad_top;
  int iw = ow * a.stride + dx - a.pad_left;
  if (ih < 0 || ih >= a.H || iw < 0 || iw >= a.W) return 0;
  return x_img[((size_t)ih * a.W + iw) * a.C + c];
}

// The Collector of one output o = (image img, pixel, channel n):
// y = fmaf(float(acc), eff_scale[img][n], eff_bias[n]), the shortcut (an
// f32 add, or fmaf(float(q), sc_scale[img], y) for an int8 one), ReLU.
// Shared by every conv kernel (conv_implicit, conv_sparse,
// conv_depthwise), so all of them round alike.
__device__ __forceinline__ float collector(const ConvArgs& a, int acc,
                                           int img, size_t o, int n) {
  float y = fmaf(__int2float_rn(acc), a.eff_scale[(size_t)img * a.n_out + n],
                 a.eff_bias[n]);
  if (a.shortcut) y += a.shortcut[o];
  else if (a.sc_q) y = fmaf((float)a.sc_q[o], a.sc_scale[img], y);
  if (a.relu) y = fmaxf(y, 0.f);
  return y;
}

// Fold a thread's max|y| into the image's amax: a warp max, then one
// atomicMax on the bits of the non-negative float per warp.  Every lane
// of the warp must call it, for one image.
__device__ __forceinline__ void amax_reduce(const ConvArgs& a, int img,
                                            float local_max) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    local_max = fmaxf(local_max, __shfl_xor_sync(0xffffffffu, local_max, off));
  if ((threadIdx.x & 31) == 0)
    atomicMax(a.amax + img, __float_as_uint(local_max));
}

template <bool SPARSE>
__global__ void __launch_bounds__(THREADS)
conv_kernel(ConvArgs a) {
  __shared__ uint32_t As[BM][BKW + 1];
  __shared__ uint32_t Bs[BKW][BN];
  __shared__ uint8_t bm_s[BK / 8][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int img = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int m_img = a.h_out * a.w_out;
  const int8_t* x_img = a.x + (size_t)img * a.H * a.W * a.C;
  const bool c_aligned = (a.C % 4) == 0;

  // sparse B loader role: one (column, bitmap byte) per thread; base is
  // the column's nonzeros consumed by earlier chunks (every thread of a
  // column carries the same count)
  const int b_col = tid % BN, b_byte = tid / BN;
  int base = 0;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  const int k_end = SPARSE ? a.Kb8 * 8 : a.K;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    // ---- A: implicit im2col tile ---------------------------------------
    for (int idx = tid; idx < BM * BKW; idx += THREADS) {
      int row = idx / BKW, kw = idx - row * BKW;
      int m = m0 + row, kk = k0 + kw * 4;
      uint32_t word = 0;
      if (m < m_img && kk < a.K) {
        int oh = m / a.w_out, ow = m - oh * a.w_out;
        if (c_aligned) {        // four channels of one tap: one aligned word
          int tap = kk / a.C, c = kk - tap * a.C;
          int dy = tap / a.k, dx = tap - dy * a.k;
          int ih = oh * a.stride + dy - a.pad_top;
          int iw = ow * a.stride + dx - a.pad_left;
          if (ih >= 0 && ih < a.H && iw >= 0 && iw < a.W)
            word = *reinterpret_cast<const uint32_t*>(
                x_img + ((size_t)ih * a.W + iw) * a.C + c);
        } else {                // taps straddle words (the C = 3 stem)
          word = pack4(im2col_byte(a, x_img, oh, ow, kk),
                       im2col_byte(a, x_img, oh, ow, kk + 1),
                       im2col_byte(a, x_img, oh, ow, kk + 2),
                       im2col_byte(a, x_img, oh, ow, kk + 3));
        }
      }
      As[row][kw] = word;
    }
    // ---- B: weight tile -------------------------------------------------
    if (!SPARSE) {
      for (int idx = tid; idx < BKW * BN; idx += THREADS) {
        int kw = idx / BN, col = idx - kw * BN;
        int n = n0 + col, kk = k0 + kw * 4;
        int b[4] = {0, 0, 0, 0};
        if (n < a.n_out) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (kk + j < a.K) b[j] = a.w[(size_t)(kk + j) * a.n_out + n];
        }
        Bs[kw][col] = pack4(b[0], b[1], b[2], b[3]);
      }
    } else {
      int n = n0 + b_col, r8 = k0 / 8 + b_byte;
      bm_s[b_byte][b_col] =
          (n < a.n_out && r8 < a.Kb8) ? a.bitmap[(size_t)r8 * a.n_out + n] : 0;
      __syncthreads();
      int pre = 0, tot = 0;
#pragma unroll
      for (int b = 0; b < BK / 8; ++b) {
        int c = __popc((unsigned)bm_s[b][b_col]);
        pre += (b < b_byte) ? c : 0;
        tot += c;
      }
      unsigned bits = bm_s[b_byte][b_col];
      int pos = base + pre;
      int code[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        code[j] = 0;
        if ((bits >> j) & 1u) {
          int p = pos < a.keep_k ? pos : a.keep_k - 1;
          code[j] = a.values[(size_t)p * a.n_out + n];
          ++pos;
        }
      }
      Bs[2 * b_byte][b_col] = pack4(code[0], code[1], code[2], code[3]);
      Bs[2 * b_byte + 1][b_col] = pack4(code[4], code[5], code[6], code[7]);
      base += tot;
    }
    __syncthreads();
    // ---- MACs ------------------------------------------------------------
#pragma unroll
    for (int kw = 0; kw < BKW; ++kw) {
      int av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = (int)As[ty + 16 * i][kw];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = (int)Bs[kw][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // ---- Collector epilogue ------------------------------------------------
  float local_max = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int m = m0 + ty + 16 * i;
    if (m >= m_img) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int n = n0 + tx + 16 * j;
      if (n >= a.n_out) continue;
      size_t o = ((size_t)img * m_img + m) * a.n_out + n;
      float y = collector(a, acc[i][j], img, o, n);
      a.y[o] = y;
      if (a.acc_out) a.acc_out[o] = acc[i][j];
      local_max = fmaxf(local_max, fabsf(y));
    }
  }
  amax_reduce(a, img, local_max);
}

template <bool SPARSE>
int launch_conv(const ConvArgs& a, cudaStream_t stream) {
  int m_img = a.h_out * a.w_out;
  dim3 grid((m_img + BM - 1) / BM, (a.n_out + BN - 1) / BN, a.N);
  conv_kernel<SPARSE><<<grid, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace repro
