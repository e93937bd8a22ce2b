// Depthwise int8 SAME convolution + fused Collector, for Hopper (sm_90a):
//   acc[m, c] = sum over taps t of x[tap t of pixel m, c] * w[t, c]
// with w tap-major (k*k, C) int8, then the Collector of conv_common.cuh
// (``collect``), so y rounds exactly as the dense conv kernels' does.
// Replaces conv2d_dw_pallas (repro/kernels/conv_depthwise.py:80, with
// dw_tap_macs :36 and the profile_g zero counts :58-74, 137-143).
//
// What bounds it: bytes.  A tap-MAC is a diagonal, 2*k*k operations per
// output, so tensor cores do not apply; the kernel moves an int8 input
// and writes an f32 output, 4 bytes of every 5.  The design moves every
// byte once, in wide coalesced copies, and keeps the MAC loop short:
//
// Tiles.  A block owns one image, a band of ``rows`` output rows and a
// slice of ``cb`` channels (a power of two, 4..64); kernels/
// conv_depthwise.py ``plan`` chooses them so the grid fills a wave of the
// SMs where the shape allows.  The block stages its halo'd input band,
// (rows-1)*stride + k rows of the padded width, into shared memory with
// cp.async (16 or 4 bytes, or bytes when C or the pointer allows no
// more), the SAME padding and the channels past C written as zeros, so
// the MAC loop has no bounds checks.  A staged column is ``cw`` words
// (cb/4 plus the plan's pad against bank conflicts at stride 2).
//
// MACs.  Thread t owns channel group cg = t % (cb/4), four channels, for
// the whole block, so its k*k weight words (and its eff_scale / eff_bias)
// load once; it walks the band's pixels t / (cb/4), + threads / (cb/4),
// ...: a warp reads consecutive words of shared memory.  Four int8
// products per input word, summed in int32 (exact: |acc| <= k*k*127*127).
//
// Epilogue.  repro::collect as in every conv kernel; y (and the int32
// accumulators on request) stored as one 16-byte vector per pixel and
// thread where C and the pointers allow.  max|y| reduces by warp
// shuffles and shared memory to one atomicMax per block on the bits of
// the non-negative float (order-independent, so exact) into amax[img],
// which the wrapper zeroes.  (A last-block-done reduction of per-block
// partials, which drops that zeroing launch, measured slower on an H100:
// its arrival atomic and second round of loads outlast a graph node.)
//
// Zero counts (PROFILE, a compile-time flag: the instance without it is
// the same code as without the feature).  Per coarse_in group of g
// channels, g dividing cb: the zeros of y over the image's pixels, and
// the pixels whose whole group is zero; summed per thread in registers,
// per block in shared memory, then one atomicAdd per group and block into
// zg / za (N, C/g), which the wrapper zeroes (exact integer counts).
// y is the same with or without it.
#include "conv_common.cuh"

namespace {

constexpr int DW_MAX_THREADS = 256;
constexpr int DW_MAX_GROUPS = 64;       // cb / g at most
constexpr int DW_MAX_SMEM = 48 * 1024;  // dynamic shared memory without opt-in

struct DwArgs {
  repro::ConvArgs a;   // operands, geometry, amax (bits, zero on entry)
  int* zg;             // (N, C/g) zeros per group, zero on entry, or null
  int* za;             // (N, C/g) all-zero (pixel, group) cells, or null
  int g;               // channels per counted group
  int cb, rows, cw;    // channels per slice, output rows per band, words
                       // per staged column
  int vec;             // bytes per input copy: 16, 4 or 1
  int vec_epi;         // C % 4 == 0 and the epilogue's operands aligned
  int n_slices, n_bands;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// global -> shared, zeros where src_bytes is 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// byte j of w, sign-extended: one prmt (a selector nibble with its top
// bit set replicates the selected byte's sign)
__device__ __forceinline__ int sbyte(uint32_t w, int j) {
  int r;
  asm("prmt.b32 %0, %1, 0, %2;" : "=r"(r) : "r"(w), "r"(0x8880u + 0x1111u * j));
  return r;
}

// Stage the block's halo'd input band: rows_in x wp columns x cb channels
// into xs (a column is cw words), zeros outside the image and past C.
__device__ __forceinline__ void stage_band(const DwArgs& d, uint32_t* xs,
                                           const int8_t* x_img, int ih0,
                                           int rows_in, int wp, int c0) {
  const repro::ConvArgs& a = d.a;
  const int C = a.C;
  if (d.vec >= 4) {            // cp.async of 16 or 4 bytes
    const int chunks = d.cb / d.vec;
    const int n = rows_in * wp * chunks;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int ch = i % chunks, col = (i / chunks) % wp;
      const int ih = ih0 + i / (chunks * wp), iw = col - a.pad_left;
      const int c = c0 + d.vec * ch;
      const bool ok = ih >= 0 && ih < a.H && iw >= 0 && iw < a.W && c < C;
      const int8_t* src = ok ? x_img + ((size_t)ih * a.W + iw) * C + c : a.x;
      uint32_t* dst = xs + (i / chunks) * d.cw + ch * (d.vec >> 2);
      if (d.vec == 16) cp_async16(dst, src, ok ? 16 : 0);
      else cp_async4(dst, src, ok ? 4 : 0);
    }
  } else {                    // any C, any alignment: bytes
    const int n = rows_in * wp * d.cb;
    int8_t* xb = reinterpret_cast<int8_t*>(xs);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int cc = i % d.cb, col = (i / d.cb) % wp;
      const int ih = ih0 + i / (d.cb * wp), iw = col - a.pad_left;
      const int c = c0 + cc;
      const bool ok = ih >= 0 && ih < a.H && iw >= 0 && iw < a.W && c < C;
      xb[(i / d.cb) * d.cw * 4 + cc] =
          ok ? x_img[((size_t)ih * a.W + iw) * C + c] : (int8_t)0;
    }
  }
}

// K = 3 with stride S (1 or 2), or K = 0: any k and stride, read from a.
template <int K, int S, bool PROFILE>
__global__ void __launch_bounds__(DW_MAX_THREADS)
conv_dw_kernel(DwArgs d) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ float red[DW_MAX_THREADS / 32];
  __shared__ int zg_s[PROFILE ? DW_MAX_GROUPS : 1];
  __shared__ int za_s[PROFILE ? DW_MAX_GROUPS : 1];
  const repro::ConvArgs& a = d.a;
  const int k = K ? K : a.k, s = K ? S : a.stride;
  const int C = a.C, n_cg = d.cb >> 2, cw = d.cw;
  int b = blockIdx.x;
  const int c0 = (b % d.n_slices) * d.cb;
  b /= d.n_slices;
  const int r0 = (b % d.n_bands) * d.rows, img = b / d.n_bands;
  const int rows = min(d.rows, a.h_out - r0);
  const int wp = (a.w_out - 1) * s + k;
  uint32_t* xs = smem;                                 // [rows_in][wp][cw]
  uint32_t* ws = smem + ((d.rows - 1) * s + k) * wp * cw;  // [k*k][n_cg]

  stage_band(d, xs, a.x + (size_t)img * a.H * a.W * C, r0 * s - a.pad_top,
             (rows - 1) * s + k, wp, c0);
  for (int i = threadIdx.x; i < k * k * n_cg; i += blockDim.x) {
    const int tap = i / n_cg, c = c0 + 4 * (i % n_cg);
    uint32_t w = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c + j < C) w |= (uint32_t)(uint8_t)a.w[tap * C + c + j] << (8 * j);
    ws[i] = w;
  }
  if constexpr (PROFILE) {
    for (int i = threadIdx.x; i < DW_MAX_GROUPS; i += blockDim.x)
      zg_s[i] = za_s[i] = 0;
  }
  cp_async_wait_all();
  __syncthreads();

  // this thread's four channels, for the whole block
  const int cg = threadIdx.x % n_cg, cbase = c0 + 4 * cg;
  const int nvalid = min(4, C - cbase);        // <= 0 past a ragged C
  float scale[4], bias[4];
  if (d.vec_epi && nvalid == 4) {
    const float4 sv = *reinterpret_cast<const float4*>(
        a.eff_scale + (size_t)img * C + cbase);
    const float4 bv = *reinterpret_cast<const float4*>(a.eff_bias + cbase);
    scale[0] = sv.x; scale[1] = sv.y; scale[2] = sv.z; scale[3] = sv.w;
    bias[0] = bv.x; bias[1] = bv.y; bias[2] = bv.z; bias[3] = bv.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      scale[j] = j < nvalid ? a.eff_scale[(size_t)img * C + cbase + j] : 0.f;
      bias[j] = j < nvalid ? a.eff_bias[cbase + j] : 0.f;
    }
  }
  const int sc_kind = a.shortcut ? 1 : (a.sc_q ? 2 : 0);
  const float q_scale = sc_kind == 2 ? a.sc_scale[img] : 0.f;
  int wk[K ? K * K : 1][4];                    // K = 3: weights in registers
  if constexpr (K != 0) {
#pragma unroll
    for (int t = 0; t < K * K; ++t) {
      const uint32_t w = ws[t * n_cg + cg];
#pragma unroll
      for (int j = 0; j < 4; ++j) wk[t][j] = sbyte(w, j);
    }
  }
  // zero counts of this thread's groups: g <= 4, the 4 / g groups of its
  // four channels; g > 4, its share of one group (its four channels)
  const int g = d.g;
  int zcount[4] = {0, 0, 0, 0}, acount[4] = {0, 0, 0, 0};

  float local_max = 0.f;
  const int pix_step = blockDim.x / n_cg;
  for (int p = threadIdx.x / n_cg; p < rows * a.w_out; p += pix_step) {
    const int r = p / a.w_out, ow = p - r * a.w_out;
    const uint32_t* xp = xs + (r * s * wp + ow * s) * cw + cg;
    int acc[4] = {0, 0, 0, 0};
    if constexpr (K != 0) {
#pragma unroll
      for (int dy = 0; dy < K; ++dy)
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          const uint32_t xv = xp[(dy * wp + dx) * cw];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[j] += sbyte(xv, j) * wk[dy * K + dx][j];
        }
    } else {
      for (int dy = 0; dy < k; ++dy)
        for (int dx = 0; dx < k; ++dx) {
          const uint32_t xv = xp[(dy * wp + dx) * cw];
          const uint32_t wv = ws[(dy * k + dx) * n_cg + cg];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[j] += sbyte(xv, j) * sbyte(wv, j);
        }
    }
    const size_t o =
        (((size_t)img * a.h_out + r0 + r) * a.w_out + ow) * C + cbase;
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
    int q[4] = {0, 0, 0, 0};
    const bool vec = d.vec_epi && nvalid == 4;
    if (sc_kind == 1) {
      if (vec) {
        const float4 v = *reinterpret_cast<const float4*>(a.shortcut + o);
        sc[0] = v.x; sc[1] = v.y; sc[2] = v.z; sc[3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) if (j < nvalid) sc[j] = a.shortcut[o + j];
      }
    } else if (sc_kind == 2) {
      if (vec) {
        const char4 v = *reinterpret_cast<const char4*>(a.sc_q + o);
        q[0] = v.x; q[1] = v.y; q[2] = v.z; q[3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) if (j < nvalid) q[j] = a.sc_q[o + j];
      }
    }
    float y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      y[j] = repro::collect(acc[j], scale[j], bias[j], sc_kind, sc[j], q[j],
                            q_scale, a.relu);
      if (j < nvalid) local_max = fmaxf(local_max, fabsf(y[j]));
    }
    if (vec) {
      *reinterpret_cast<float4*>(a.y + o) = make_float4(y[0], y[1], y[2], y[3]);
      if (a.acc_out)
        *reinterpret_cast<int4*>(a.acc_out + o) =
            make_int4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < nvalid) {
          a.y[o + j] = y[j];
          if (a.acc_out) a.acc_out[o + j] = acc[j];
        }
    }
    if constexpr (PROFILE) {
      unsigned zm = 0;                         // bit j: channel j is zero
#pragma unroll
      for (int j = 0; j < 4; ++j) zm |= (unsigned)(j < nvalid && y[j] == 0.f) << j;
      if (g <= 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (u * g < 4) {
            const unsigned bits = (zm >> (u * g)) & ((1u << g) - 1u);
            zcount[u] += __popc(bits);
            acount[u] += bits == (1u << g) - 1u;
          }
      } else {
        // the group's g / 4 threads are consecutive lanes, aligned
        const int span = g >> 2, lane = threadIdx.x & 31;
        const unsigned mask = ((1u << span) - 1u) << (lane & ~(span - 1));
        int all = zm == 0xfu;
        for (int off = 1; off < span; off *= 2)
          all &= __shfl_xor_sync(mask, all, off);
        zcount[0] += __popc(zm);
        acount[0] += all && (cg & (span - 1)) == 0;
      }
    }
  }

  if constexpr (PROFILE) {
    if (nvalid > 0) {
      if (g <= 4) {
        for (int u = 0; u * g < 4; ++u) {
          atomicAdd(zg_s + (4 * cg + u * g) / g, zcount[u]);
          atomicAdd(za_s + (4 * cg + u * g) / g, acount[u]);
        }
      } else {
        atomicAdd(zg_s + 4 * cg / g, zcount[0]);
        atomicAdd(za_s + 4 * cg / g, acount[0]);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    local_max = fmaxf(local_max, __shfl_xor_sync(0xffffffffu, local_max, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = local_max;
  __syncthreads();
  if constexpr (PROFILE) {
    const int groups = min(d.cb, C - c0) / g, G = C / g;
    for (int i = threadIdx.x; i < groups; i += blockDim.x) {
      atomicAdd(d.zg + (size_t)img * G + c0 / g + i, zg_s[i]);
      atomicAdd(d.za + (size_t)img * G + c0 / g + i, za_s[i]);
    }
  }
  if (threadIdx.x == 0) {
    float m = red[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) m = fmaxf(m, red[w]);
    atomicMax(a.amax + img, __float_as_uint(m));
  }
}

template <int K, int S>
int launch_k(const DwArgs& d, int grid, int threads, int smem,
             cudaStream_t stream) {
  if (d.zg)
    conv_dw_kernel<K, S, true><<<grid, threads, smem, stream>>>(d);
  else
    conv_dw_kernel<K, S, false><<<grid, threads, smem, stream>>>(d);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes; returns the cudaGetLastError() of the
// launch (or cudaErrorInvalidValue for a plan the kernel does not take).
// eff_scale is (N, C), eff_bias (C,), y and the shortcuts (N, h_out,
// w_out, C); amax (N,) zeroed; zg / za (N, C/g) zeroed int32, or null
// without profiling.
extern "C" int conv_depthwise_launch(
    const int8_t* x, const int8_t* w, const float* eff_scale,
    const float* eff_bias, const float* shortcut, const int8_t* sc_q,
    const float* sc_scale, float* y, float* amax, int32_t* acc_out, int* zg,
    int* za, int N, int H, int W, int C, int k, int stride, int pad_top,
    int pad_left, int h_out, int w_out, int relu, int g, int cb, int rows,
    int cw, int vec, int vec_epi, int threads, void* stream) {
  DwArgs d{};
  repro::ConvArgs& a = d.a;
  a.x = x; a.w = w; a.eff_scale = eff_scale; a.eff_bias = eff_bias;
  a.shortcut = shortcut; a.sc_q = sc_q; a.sc_scale = sc_scale; a.y = y;
  a.amax = reinterpret_cast<unsigned int*>(amax); a.acc_out = acc_out;
  a.N = N; a.H = H; a.W = W; a.C = C; a.n_out = C; a.k = k;
  a.stride = stride; a.pad_top = pad_top; a.pad_left = pad_left;
  a.h_out = h_out; a.w_out = w_out; a.K = k * k; a.relu = relu;
  d.zg = zg; d.za = za; d.g = g;
  d.cb = cb; d.rows = rows; d.cw = cw; d.vec = vec; d.vec_epi = vec_epi;
  d.n_slices = (C + cb - 1) / cb;
  d.n_bands = (h_out + rows - 1) / rows;
  const bool ok = cb >= 4 && cb <= 64 && (cb & (cb - 1)) == 0 &&
                  cw >= cb / 4 && (vec == 1 || vec == 4 || vec == 16) &&
                  cb % vec == 0 && C % vec == 0 &&
                  (vec != 16 || cw % 4 == 0) && threads % 32 == 0 &&
                  threads <= DW_MAX_THREADS && threads % (cb / 4) == 0 &&
                  (!zg || (g > 0 && cb % g == 0 && C % g == 0));
  const int wp = (w_out - 1) * stride + k;
  const long long smem =
      (((long long)(rows - 1) * stride + k) * wp * cw + k * k * (cb / 4)) * 4;
  if (!ok || smem > DW_MAX_SMEM) return (int)cudaErrorInvalidValue;
  const int grid = N * d.n_bands * d.n_slices;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 3 && stride == 1) return launch_k<3, 1>(d, grid, threads, (int)smem, st);
  if (k == 3 && stride == 2) return launch_k<3, 2>(d, grid, threads, (int)smem, st);
  return launch_k<0, 0>(d, grid, threads, (int)smem, st);
}
