// The Collector epilogue shared by every conv kernel of the port: the
// implicit-GEMM int8 SAME conv (conv_mma.cuh, behind conv_implicit.cu and
// conv_sparse.cu) and the depthwise conv (conv_depthwise.cu), so all of
// them round alike.
//
// y = fmaf(float(acc), eff_scale[image], eff_bias), then the shortcut —
// an f32 add, or for an int8 shortcut (the identity block's dequantized
// input) y = fmaf(float(q), sc_scale[image], y) — then ReLU, and a
// per-image max|y| over valid outputs, reduced with atomicMax on the bits
// of the non-negative float (order-independent, so exact).  Both fmaf
// roundings are the ones XLA's fused lowering of the same expressions
// makes.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

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

// The Collector's arithmetic on loaded operands: sc_kind 0 none, 1 an f32
// shortcut ``sc``, 2 an int8 one ``q`` with its image's scale ``q_scale``.
__device__ __forceinline__ float collect(int acc, float scale, float bias,
                                         int sc_kind, float sc, int q,
                                         float q_scale, int relu) {
  float y = fmaf(__int2float_rn(acc), scale, bias);
  if (sc_kind == 1) y += sc;
  else if (sc_kind == 2) y = fmaf((float)q, q_scale, y);
  if (relu) y = fmaxf(y, 0.f);
  return y;
}

// The Collector of one output o = (image img, pixel, channel n).
__device__ __forceinline__ float collector(const ConvArgs& a, int acc,
                                           int img, size_t o, int n) {
  const int kind = a.shortcut ? 1 : (a.sc_q ? 2 : 0);
  return collect(acc, a.eff_scale[(size_t)img * a.n_out + n], a.eff_bias[n],
                 kind, kind == 1 ? a.shortcut[o] : 0.f,
                 kind == 2 ? (int)a.sc_q[o] : 0,
                 kind == 2 ? a.sc_scale[img] : 0.f, a.relu);
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

}  // namespace repro
