// Flash attention: GQA-native streaming-softmax attention for sm_90a.
//
// Replaces flash_attention_pallas (src/repro/kernels/flash_attention.py:84).
// q (BH, G, Tq, D), k (BH, Tk, D), v (BH, Tk, Dv), out (BH, G, Tq, Dv),
// contiguous, f32 or bf16; BH = batch * kv heads.  Queries sit at the end
// of the key sequence (q_offset = Tk - Tq).  Per (query row, key):
//   s = (q . k) * scale, summed in f32;
//   mask by absolute position: key < Tk, causal key <= qpos, window
//   key > qpos - window; masked s = -1e30 and masked p = 0;
//   online softmax with m, l in f32; p rounded to v's type before p . v;
//   out = acc / max(l, 1e-30) in v's type.
// This is what the Pallas kernel computes, tile for tile.
//
// Layout: one block of 4 warps per (q tile, b * kv head).  A q tile is
// bq = 32 / G query positions of ALL G query groups of one KV head (32
// rows), so every K/V tile a block stages in shared memory serves all G
// groups: K/V are read once per q tile and never repeated in memory.
// Each warp owns 8 rows and keeps their m, l and output accumulators in
// registers (lane c of the warp holds output columns c, c + 32, ...).
// Keys stream in tiles of 32, one key per lane for the scores; the
// probabilities are broadcast by shuffles for the p . v update.  Tiles
// wholly above the causal diagonal or left of the window are skipped;
// the ragged edges (Tq, Tk not multiples of a tile) are masked, so no
// input is ever padded.
//
// What bounds it on an H100: at the LM's prefill shapes (D = 64, G = 3)
// operations — 4 * Tq * Tk_visible * D flops per query head against
// 989 TFLOP/s bf16 on the tensor cores — over bytes (q, k, v, o once,
// at 3.35 TB/s).  This first kernel does its products as f32 FMAs on the
// CUDA cores (67 TFLOP/s peak, less with each FMA reading shared memory),
// so it sits well above that bound; mma.sync / wgmma tiles are the next
// step (PERF.md).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BK = 32;                    // keys per tile: one per lane
constexpr int WARPS = 4;
constexpr int ROWS = 8;                   // query rows per warp
constexpr int MAX_ROWS = WARPS * ROWS;    // G * bq rows per block
constexpr int MAX_D = 256;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);             // round to nearest even
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__host__ __device__ constexpr size_t smem_floats(int D, int Dv) {
  return (size_t)MAX_ROWS * D + (size_t)BK * (D + 1) + (size_t)BK * Dv;
}

template <typename T, int NACC>
__global__ void __launch_bounds__(WARPS * 32)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int G, int Tq,
             int Tk, int D, int Dv, int bq, int causal, int window,
             float scale) {
  extern __shared__ float smem[];
  const int ks = D + 1;                   // padded: conflict-free for even D
  float* q_s = smem;                      // [rows][D]
  float* k_s = q_s + MAX_ROWS * D;        // [BK][D + 1]
  float* v_s = k_s + BK * ks;             // [BK][Dv]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.y;
  const int t0 = blockIdx.x * bq;
  const int rows = G * bq;
  const int q_off = Tk - Tq;
  const T* qb = q + (size_t)bh * G * Tq * D;
  const T* kb = k + (size_t)bh * Tk * D;
  const T* vb = v + (size_t)bh * Tk * Dv;
  T* ob = out + (size_t)bh * G * Tq * Dv;

  // this block's query rows: row r = g * bq + i is (group g, t0 + i)
  for (int idx = threadIdx.x; idx < rows * D; idx += blockDim.x) {
    const int r = idx / D, d = idx - r * D;
    const int g = r / bq, t = t0 + r - g * bq;
    q_s[idx] = t < Tq ? to_f(qb[((size_t)g * Tq + t) * D + d]) : 0.f;
  }

  // the key range any row of this block can see
  const int qpos_lo = q_off + t0;
  const int qpos_hi = q_off + min(t0 + bq, Tq) - 1;
  int kv_hi = Tk - 1, kv_lo = 0;
  if (causal) kv_hi = min(kv_hi, qpos_hi);
  if (window > 0) kv_lo = max(0, qpos_lo - window + 1);
  const int tile_lo = kv_lo / BK, tile_hi = kv_hi / BK;

  float m[ROWS], l[ROWS], acc[ROWS][NACC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NACC; ++c) acc[i][c] = 0.f;
  }

  for (int tile = tile_lo; tile <= tile_hi; ++tile) {
    const int kpos0 = tile * BK;
    __syncthreads();                      // the previous tile is consumed
    for (int idx = threadIdx.x; idx < BK * D; idx += blockDim.x) {
      const int j = idx / D, d = idx - j * D;
      const int kp = kpos0 + j;
      k_s[j * ks + d] = kp < Tk ? to_f(kb[(size_t)kp * D + d]) : 0.f;
    }
    for (int idx = threadIdx.x; idx < BK * Dv; idx += blockDim.x) {
      const int j = idx / Dv;
      const int kp = kpos0 + j;
      v_s[idx] = kp < Tk ? to_f(vb[(size_t)kpos0 * Dv + idx]) : 0.f;
    }
    __syncthreads();

    const int kp = kpos0 + lane;          // this lane's key
    const float* kr = k_s + lane * ks;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int r = warp + WARPS * i;
      if (r >= rows) break;               // warp-uniform
      const int g = r / bq, t = t0 + r - g * bq;
      if (t >= Tq) continue;              // warp-uniform
      const int qpos = q_off + t;
      const float* qr = q_s + r * D;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      s *= scale;
      const bool ok = kp < Tk && (!causal || kp <= qpos) &&
                      (window <= 0 || kp > qpos - window);
      s = ok ? s : NEG_INF;
      const float m_new = fmaxf(m[i], warp_max(s));
      const float p = ok ? expf(s - m_new) : 0.f;
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + warp_sum(p);
      const float pr = to_f(from_f<T>(p));   // p in v's type for p . v
#pragma unroll
      for (int c = 0; c < NACC; ++c) acc[i][c] *= alpha;
#pragma unroll 4
      for (int j = 0; j < BK; ++j) {
        const float pj = __shfl_sync(FULL, pr, j);
        const float* vr = v_s + j * Dv;
#pragma unroll
        for (int c = 0; c < NACC; ++c) {
          const int d = lane + 32 * c;
          if (d < Dv) acc[i][c] = fmaf(pj, vr[d], acc[i][c]);
        }
      }
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = warp + WARPS * i;
    if (r >= rows) break;
    const int g = r / bq, t = t0 + r - g * bq;
    if (t >= Tq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = ob + ((size_t)g * Tq + t) * Dv;
#pragma unroll
    for (int c = 0; c < NACC; ++c) {
      const int d = lane + 32 * c;
      if (d < Dv) orow[d] = from_f<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, int NACC>
int launch_typed(const void* q, const void* k, const void* v, void* out,
                 int BH, int G, int Tq, int Tk, int D, int Dv, int causal,
                 int window, float scale, cudaStream_t stream) {
  static bool configured = false;         // once per instance, before any
  if (!configured) {                      // CUDA-graph capture
    cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, NACC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(smem_floats(MAX_D, MAX_D) * sizeof(float)));
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int bq = MAX_ROWS / G;
  dim3 grid((Tq + bq - 1) / bq, BH);
  const size_t smem = smem_floats(D, Dv) * sizeof(float);
  flash_kernel<T, NACC><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), G, Tq, Tk, D, Dv, bq,
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_nacc(const void* q, const void* k, const void* v, void* out,
                int BH, int G, int Tq, int Tk, int D, int Dv, int causal,
                int window, float scale, cudaStream_t stream) {
  if (Dv <= 64)
    return launch_typed<T, 2>(q, k, v, out, BH, G, Tq, Tk, D, Dv, causal,
                              window, scale, stream);
  if (Dv <= 128)
    return launch_typed<T, 4>(q, k, v, out, BH, G, Tq, Tk, D, Dv, causal,
                              window, scale, stream);
  return launch_typed<T, 8>(q, k, v, out, BH, G, Tq, Tk, D, Dv, causal,
                            window, scale, stream);
}

}  // namespace

// Returns cudaGetLastError() after the launch; cudaErrorInvalidValue (1)
// for shapes the kernel does not take (the wrapper checks them first).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int BH,
                                      int G, int Tq, int Tk, int D, int Dv,
                                      int causal, int window, int bf16,
                                      float scale, void* stream) {
  if (G < 1 || G > MAX_ROWS || D < 1 || D > MAX_D || Dv < 1 || Dv > MAX_D ||
      Tq < 1 || Tq > Tk || BH < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_nacc<__nv_bfloat16>(q, k, v, out, BH, G, Tq, Tk, D, Dv,
                                      causal, window, scale, s);
  return launch_nacc<float>(q, k, v, out, BH, G, Tq, Tk, D, Dv, causal,
                            window, scale, s);
}
