// Depthwise int8 SAME convolution + fused Collector:
//   acc[m, c] = sum over taps t of x[tap t of pixel m, c] * w[t, c]
// with w tap-major (k*k, C) int8, then the Collector of conv_common.cuh
// (``collector``, ``amax_reduce``), so it rounds exactly as the dense
// conv kernels do.
//
// Work decomposition.  One thread owns one output pixel and a group of
// four consecutive channels; consecutive threads take consecutive channel
// groups of a pixel, so a warp's input and weight reads are consecutive
// 32-bit words.  A block stays inside one image (blockIdx.z), so its
// warps fold into that image's amax.  For each of the k*k taps the thread
// reads one word of input (zero outside the image: the SAME padding is a
// bounds check) and one word of weights, and adds the four int8 products
// into int32 (exact: |acc| <= k*k * 127 * 127).  When C is not a multiple
// of four (or a pointer is not word-aligned) the same loop reads bytes
// and masks the ragged channel edge; no channel padding is needed.
#include "conv_common.cuh"

namespace {

constexpr int DW_THREADS = 256;

__global__ void __launch_bounds__(DW_THREADS)
conv_dw_kernel(repro::ConvArgs a, int vec) {
  const int img = blockIdx.z;
  const int C = a.C;
  const int n_cg = (C + 3) / 4;
  const int m_img = a.h_out * a.w_out;
  const long long idx = (long long)blockIdx.x * DW_THREADS + threadIdx.x;
  float local_max = 0.f;
  if (idx < (long long)m_img * n_cg) {
    const int m = (int)(idx / n_cg), cg = (int)(idx - (long long)m * n_cg);
    const int oh = m / a.w_out, ow = m - oh * a.w_out;
    const int c0 = cg * 4;
    const int8_t* x_img = a.x + (size_t)img * a.H * a.W * C;
    int acc[4] = {0, 0, 0, 0};
    for (int dy = 0; dy < a.k; ++dy) {
      const int ih = oh * a.stride + dy - a.pad_top;
      if (ih < 0 || ih >= a.H) continue;
      for (int dx = 0; dx < a.k; ++dx) {
        const int iw = ow * a.stride + dx - a.pad_left;
        if (iw < 0 || iw >= a.W) continue;
        const int8_t* xp = x_img + ((size_t)ih * a.W + iw) * C + c0;
        const int8_t* wp = a.w + (size_t)(dy * a.k + dx) * C + c0;
        if (vec) {
          const char4 xv = *reinterpret_cast<const char4*>(xp);
          const char4 wv = *reinterpret_cast<const char4*>(wp);
          acc[0] += (int)xv.x * (int)wv.x;
          acc[1] += (int)xv.y * (int)wv.y;
          acc[2] += (int)xv.z * (int)wv.z;
          acc[3] += (int)xv.w * (int)wv.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (c0 + j < C) acc[j] += (int)xp[j] * (int)wp[j];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = c0 + j;
      if (n >= C) break;
      const size_t o = ((size_t)img * m_img + m) * C + n;
      const float y = repro::collector(a, acc[j], img, o, n);
      a.y[o] = y;
      if (a.acc_out) a.acc_out[o] = acc[j];
      local_max = fmaxf(local_max, fabsf(y));
    }
  }
  repro::amax_reduce(a, img, local_max);
}

}  // namespace

// Plain C interface for ctypes; returns the cudaGetLastError() of the
// launch.  eff_scale is (N, C), eff_bias (C,), y and the shortcuts
// (N, h_out, w_out, C).
extern "C" int conv_depthwise_launch(
    const int8_t* x, const int8_t* w, const float* eff_scale,
    const float* eff_bias, const float* shortcut, const int8_t* sc_q,
    const float* sc_scale, float* y, float* amax, int32_t* acc_out, int N,
    int H, int W, int C, int k, int stride, int pad_top, int pad_left,
    int h_out, int w_out, int relu, void* stream) {
  repro::ConvArgs a{};
  a.x = x; a.w = w; a.eff_scale = eff_scale; a.eff_bias = eff_bias;
  a.shortcut = shortcut; a.sc_q = sc_q; a.sc_scale = sc_scale; a.y = y;
  a.amax = reinterpret_cast<unsigned int*>(amax); a.acc_out = acc_out;
  a.N = N; a.H = H; a.W = W; a.C = C; a.n_out = C; a.k = k;
  a.stride = stride; a.pad_top = pad_top; a.pad_left = pad_left;
  a.h_out = h_out; a.w_out = w_out; a.K = k * k; a.relu = relu;
  const int vec = (C % 4 == 0) && ((uintptr_t)x % 4 == 0) &&
                  ((uintptr_t)w % 4 == 0);
  const long long work = (long long)h_out * w_out * ((C + 3) / 4);
  dim3 grid((unsigned)((work + DW_THREADS - 1) / DW_THREADS), 1, N);
  conv_dw_kernel<<<grid, DW_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, vec);
  return (int)cudaGetLastError();
}
