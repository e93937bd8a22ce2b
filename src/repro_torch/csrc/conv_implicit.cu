// Dense implicit-GEMM int8 SAME conv + fused Collector on the int8 tensor
// cores (see conv_mma.cuh).  Plain C interface for ctypes; returns the
// cudaGetLastError() of the launch, or cudaErrorInvalidValue (1) for a
// plan the kernel does not take.  zg / za (N, n_out/g) int32, zeroed,
// take the zero counts of y per group of g channels; null: none.
#include "conv_mma.cuh"

extern "C" int conv_implicit_launch(
    const int8_t* x, const int8_t* w, const float* eff_scale,
    const float* eff_bias, const float* shortcut, const int8_t* sc_q,
    const float* sc_scale, float* y, float* amax, int32_t* acc_out, int* zg,
    int* za, int N, int H, int W, int C, int n_out, int k, int stride,
    int pad_top, int pad_left, int h_out, int w_out, int relu, int vec,
    int bvec, int vec_epi, int splits, int chunks_per, int g,
    void* stream) {
  repro::ConvArgs a{};
  a.x = x; a.w = w; a.eff_scale = eff_scale; a.eff_bias = eff_bias;
  a.shortcut = shortcut; a.sc_q = sc_q; a.sc_scale = sc_scale; a.y = y;
  a.amax = reinterpret_cast<unsigned int*>(amax); a.acc_out = acc_out;
  a.N = N; a.H = H; a.W = W; a.C = C; a.n_out = n_out; a.k = k;
  a.stride = stride; a.pad_top = pad_top; a.pad_left = pad_left;
  a.h_out = h_out; a.w_out = w_out; a.K = k * k * C; a.relu = relu;
  repro::conv_mma::Plan p{N * h_out * w_out, splits, chunks_per, bvec,
                          vec_epi};
  repro::conv_mma::Profile z{zg, za, g};
  return repro::conv_mma::launch<false>(a, p, z, vec,
                                        static_cast<cudaStream_t>(stream));
}
