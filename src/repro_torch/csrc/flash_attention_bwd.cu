// Flash attention backward: dq, dk, dv of the GQA streaming-softmax
// attention in flash_attention.cu, for sm_90a.
//
// Replaces no Pallas kernel: the JAX package takes this gradient through
// XLA's autodiff of its chunked attention (src/repro/models/attention.py:57,
// under jax.value_and_grad in src/repro/training/train_step.py:30).  The
// port's forward is an opaque CUDA launch, so its training path needs this
// gradient as a kernel of its own.
//
// q (BH, G, Tq, D), k (BH, Tk, D), v (BH, Tk, Dv), o and dout (BH, G, Tq, Dv),
// lse (BH, G, Tq) f32 from the forward; contiguous, f32 or bf16; BH = batch
// * kv heads.  Queries sit at the end of the keys (q_offset = Tk - Tq) and
// the masks are the forward's (key < Tk, causal key <= qpos, window key >
// qpos - window).  Per visible (query row i, key j), all in f32:
//   p    = exp(s * scale - lse_i),   s = q_i . k_j
//   dv_j += p * dout_i               (summed over the G query heads too)
//   dp   = dout_i . v_j
//   ds   = p * (dp - delta_i),       delta_i = dout_i . o_i
//   dq_i += scale * ds * k_j
//   dk_j += scale * ds * q_i         (summed over the G query heads too)
// dq, dk, dv are written once each, in the inputs' type.
//
// Deterministic, no float atomics: two kernels, each output written by the
// one block that owns it.
//   flash_bwd_dq_kernel: one block per (32 query rows = all G groups x
//     32 / G positions, b * kv head); it first reduces delta for its rows
//     (written to scratch for the next kernel), then streams the visible
//     K/V tiles of 32 keys through shared memory.
//   flash_bwd_dkdv_kernel: one block per (32 keys, b * kv head); it holds
//     its K/V tile in shared memory and streams the visible query rows of
//     every group g in tiles of 32 (q, dout, lse, delta), so dk and dv sum
//     over G inside the block.  It runs after the dq kernel on the stream,
//     which wrote delta.
// In both, 8 threads share one row (dq: a query; dkdv: a key) and own its
// columns c = sub + 8 n: their partial dots reduce over 3 shuffles, and each
// thread's accumulator columns stay in registers.  Shared rows are padded
// by 8 floats so the 4 rows one warp reads hit distinct banks.
//
// What bounds it on an H100: operations.  2 (3 D + 2 Dv) flops per visible
// pair (2.5 times the forward's 2 (D + Dv) at D = Dv), against bytes of q,
// k, v, o, dout, lse, dq, dk, dv moved once.  This first kernel runs them
// on the CUDA cores in f32 FMAs (67 TFLOP/s peak, not the tensor cores'
// 989 bf16); tensor cores, TMA and wgmma are later work.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int SUB = 8;                  // threads per row
constexpr int TILE = THREADS / SUB;     // rows per block, keys per tile: 32
constexpr int PAD = 8;                  // floats of padding per shared row
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
  return __float2bfloat16(x);           // round to nearest even
}

// sum over the 8 threads of a row (lanes 8 r .. 8 r + 7 of a warp)
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  x += __shfl_xor_sync(FULL, x, 2);
  x += __shfl_xor_sync(FULL, x, 4);
  return x;
}

__device__ __forceinline__ bool visible(int kp, int qpos, int Tk, int causal,
                                        int window) {
  return kp < Tk && (!causal || kp <= qpos) &&
         (window <= 0 || kp > qpos - window);
}

// stage rows [r0, r0 + TILE) of a (rows, W) matrix as f32, rows >= n zero
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0, int n,
                                      int W, int stride) {
  for (int idx = threadIdx.x; idx < TILE * W; idx += THREADS) {
    const int j = idx / W, c = idx - j * W;
    dst[j * stride + c] =
        r0 + j < n ? to_f(src[(size_t)(r0 + j) * W + c]) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// dq (and delta): a block per 32 query rows of one b * kv head
// ---------------------------------------------------------------------------

template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ delta, T* __restrict__ dq, int G,
                    int Tq, int Tk, int D, int Dv, int bq, int causal,
                    int window, float scale) {
  extern __shared__ float smem[];
  const int ks = D + PAD, vs = Dv + PAD;
  float* k_s = smem;                    // [TILE][D + PAD]
  float* v_s = k_s + TILE * ks;         // [TILE][Dv + PAD]
  const int r = threadIdx.x / SUB, sub = threadIdx.x % SUB;
  const int bh = blockIdx.y, t0 = blockIdx.x * bq;
  const int q_off = Tk - Tq;
  // this thread's row: r = g * bq + i is (group g, position t0 + i)
  const int g = r / bq, t = t0 + r - g * bq;
  const bool live = g < G && t < Tq;
  const size_t row = ((size_t)bh * G + (live ? g : 0)) * Tq + (live ? t : 0);
  const int qpos = q_off + t;

  float qr[NC], dr[NC], acc[NC];
  float dl = 0.f;
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    const int c = sub + SUB * n;
    qr[n] = live && c < D ? to_f(q[row * D + c]) : 0.f;
    dr[n] = live && c < Dv ? to_f(dout[row * Dv + c]) : 0.f;
    if (live && c < Dv) dl = fmaf(dr[n], to_f(o[row * Dv + c]), dl);
    acc[n] = 0.f;
  }
  dl = row_sum(dl);
  if (live && sub == 0) delta[row] = dl;
  const float lse_r = live ? lse[row] : 0.f;

  // the key range any row of this block can see
  const int qpos_lo = q_off + t0;
  const int qpos_hi = q_off + min(t0 + bq, Tq) - 1;
  int kv_hi = Tk - 1, kv_lo = 0;
  if (causal) kv_hi = min(kv_hi, qpos_hi);
  if (window > 0) kv_lo = max(0, qpos_lo - window + 1);
  const T* kb = k + (size_t)bh * Tk * D;
  const T* vb = v + (size_t)bh * Tk * Dv;

  for (int tile = kv_lo / TILE; tile <= kv_hi / TILE; ++tile) {
    const int kp0 = tile * TILE;
    __syncthreads();                    // the previous tile is consumed
    stage(k_s, kb, kp0, Tk, D, ks);
    stage(v_s, vb, kp0, Tk, Dv, vs);
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < TILE; ++j) {
      const float* kr = k_s + j * ks;
      const float* vr = v_s + j * vs;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int c = sub + SUB * n;
        if (c < D) s = fmaf(qr[n], kr[c], s);
        if (c < Dv) dp = fmaf(dr[n], vr[c], dp);
      }
      s = row_sum(s);
      dp = row_sum(dp);
      const bool ok = live && visible(kp0 + j, qpos, Tk, causal, window);
      const float p = ok ? expf(s * scale - lse_r) : 0.f;
      const float ds = p * (dp - dl);
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int c = sub + SUB * n;
        if (c < D) acc[n] = fmaf(ds, kr[c], acc[n]);
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    const int c = sub + SUB * n;
    if (c < D) dq[row * D + c] = from_f<T>(acc[n] * scale);
  }
}

// ---------------------------------------------------------------------------
// dk, dv: a block per 32 keys of one b * kv head, summed over G groups
// ---------------------------------------------------------------------------

template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int G, int Tq, int Tk, int D,
                      int Dv, int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int ks = D + PAD, vs = Dv + PAD;
  float* k_s = smem;                    // [TILE][D + PAD] this block's keys
  float* v_s = k_s + TILE * ks;         // [TILE][Dv + PAD]
  float* q_s = v_s + TILE * vs;         // [TILE][D] a tile of query rows
  float* d_s = q_s + TILE * D;          // [TILE][Dv] their dout
  float* l_s = d_s + TILE * Dv;         // [TILE] their lse
  float* e_s = l_s + TILE;              // [TILE] their delta
  const int j = threadIdx.x / SUB, sub = threadIdx.x % SUB;
  const int bh = blockIdx.y, kp0 = blockIdx.x * TILE;
  const int kp = kp0 + j;
  const int q_off = Tk - Tq;
  stage(k_s, k + (size_t)bh * Tk * D, kp0, Tk, D, ks);
  stage(v_s, v + (size_t)bh * Tk * Dv, kp0, Tk, Dv, vs);

  // the query positions that can see any key of this tile
  const int kp_hi = min(kp0 + TILE, Tk) - 1;
  int t_lo = 0, t_hi = Tq - 1;
  if (causal) t_lo = max(0, kp0 - q_off);
  if (window > 0) t_hi = min(t_hi, kp_hi + window - 1 - q_off);

  float ak[NC], av[NC];
#pragma unroll
  for (int n = 0; n < NC; ++n) ak[n] = av[n] = 0.f;

  for (int g = 0; g < G; ++g) {
    const size_t rows0 = ((size_t)bh * G + g) * Tq;
    for (int tt = t_lo; tt <= t_hi; tt += TILE) {
      const int nrow = min(TILE, t_hi - tt + 1);
      __syncthreads();                  // the previous rows are consumed
      stage(q_s, q + rows0 * D, tt, tt + nrow, D, D);
      stage(d_s, dout + rows0 * Dv, tt, tt + nrow, Dv, Dv);
      if (threadIdx.x < nrow) {
        l_s[threadIdx.x] = lse[rows0 + tt + threadIdx.x];
        e_s[threadIdx.x] = delta[rows0 + tt + threadIdx.x];
      }
      __syncthreads();
#pragma unroll 2
      for (int i = 0; i < nrow; ++i) {
        const float* qr = q_s + i * D;
        const float* dr = d_s + i * Dv;
        const float* kr = k_s + j * ks;
        const float* vr = v_s + j * vs;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          const int c = sub + SUB * n;
          if (c < D) s = fmaf(qr[c], kr[c], s);
          if (c < Dv) dp = fmaf(dr[c], vr[c], dp);
        }
        s = row_sum(s);
        dp = row_sum(dp);
        const bool ok = visible(kp, q_off + tt + i, Tk, causal, window);
        const float p = ok ? expf(s * scale - l_s[i]) : 0.f;
        const float ds = p * (dp - e_s[i]);
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          const int c = sub + SUB * n;
          if (c < Dv) av[n] = fmaf(p, dr[c], av[n]);
          if (c < D) ak[n] = fmaf(ds, qr[c], ak[n]);
        }
      }
    }
  }
  if (kp >= Tk) return;
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    const int c = sub + SUB * n;
    if (c < D) dk[((size_t)bh * Tk + kp) * D + c] = from_f<T>(ak[n] * scale);
    if (c < Dv) dv[((size_t)bh * Tk + kp) * Dv + c] = from_f<T>(av[n]);
  }
}

__host__ __device__ constexpr size_t dq_smem(int D, int Dv) {
  return (size_t)TILE * ((D + PAD) + (Dv + PAD)) * sizeof(float);
}
__host__ __device__ constexpr size_t dkdv_smem(int D, int Dv) {
  return (size_t)TILE * ((D + PAD) + (Dv + PAD) + D + Dv + 2) * sizeof(float);
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int BH, G, Tq, Tk, D, Dv, causal, window;
  float scale;
  cudaStream_t stream;
};

template <typename T, int NC>
int launch(const Args& a) {
  static bool configured = false;       // once per instance, before any
  if (!configured) {                    // CUDA-graph capture
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<T, NC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)dq_smem(MAX_D, MAX_D));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, NC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dkdv_smem(MAX_D, MAX_D));
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int bq = TILE / a.G;
  dim3 grid_q((a.Tq + bq - 1) / bq, a.BH);
  flash_bwd_dq_kernel<T, NC><<<grid_q, THREADS, dq_smem(a.D, a.Dv),
                               a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.o),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dq),
      a.G, a.Tq, a.Tk, a.D, a.Dv, bq, a.causal, a.window, a.scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 grid_k((a.Tk + TILE - 1) / TILE, a.BH);
  flash_bwd_dkdv_kernel<T, NC><<<grid_k, THREADS, dkdv_smem(a.D, a.Dv),
                                 a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.G, a.Tq,
      a.Tk, a.D, a.Dv, a.causal, a.window, a.scale);
  return (int)cudaGetLastError();
}

// one instance per bound on max(D, Dv): 32, 64, 128, 256 columns
template <typename T>
int launch_nc(const Args& a) {
  const int w = a.D > a.Dv ? a.D : a.Dv;
  if (w <= 32) return launch<T, 4>(a);
  if (w <= 64) return launch<T, 8>(a);
  if (w <= 128) return launch<T, 16>(a);
  return launch<T, 32>(a);
}

}  // namespace

// Launches the dq kernel (which also writes delta, (BH, G, Tq) f32 scratch)
// and then the dk/dv kernel on ``stream``.  Returns cudaGetLastError() after
// the launches; cudaErrorInvalidValue (1) for shapes the kernels do not take
// (the wrapper checks first).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int BH, int G, int Tq, int Tk, int D, int Dv, int causal,
    int window, int bf16, float scale, void* stream) {
  if (G < 1 || G > TILE || D < 1 || D > MAX_D || Dv < 1 || Dv > MAX_D ||
      Tq < 1 || Tq > Tk || BH < 1)
    return (int)cudaErrorInvalidValue;
  const Args a{q,  k,  v,  o,      dout,   static_cast<const float*>(lse),
               static_cast<float*>(delta), dq, dk, dv, BH, G, Tq, Tk, D, Dv,
               causal, window, scale, static_cast<cudaStream_t>(stream)};
  return bf16 ? launch_nc<__nv_bfloat16>(a) : launch_nc<float>(a);
}
