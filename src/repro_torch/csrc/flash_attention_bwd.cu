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
// qpos - window); as there, a non-causal call with no window may have Tq
// > Tk, its negative q_offset read by no mask.  Per visible (query row i,
// key j), all in f32:
//   p    = exp(s * scale - lse_i),   s = q_i . k_j
//   dv_j += p * dout_i               (summed over the G query heads too)
//   dp   = dout_i . v_j
//   ds   = p * (dp - delta_i),       delta_i = dout_i . o_i
//   dq_i += scale * ds * k_j
//   dk_j += scale * ds * q_i         (summed over the G query heads too)
// dq, dk, dv are written once each, in the inputs' type.
//
// Deterministic, no float atomics: two kernels, each output written by the
// one block that owns it, every sum taken in a fixed order.  The dq kernel
// first reduces delta for its rows (written to scratch for the next
// kernel), then streams the visible K/V tiles; the dk/dv kernel holds its
// keys' K/V tile and streams the visible query rows of every group g (q,
// dout, lse, delta), so dk and dv sum over G inside the block.  It runs
// after the dq kernel on the stream, which wrote delta.
//
// What bounds it on an H100: operations.  2 (3 D + 2 Dv) flops per visible
// pair (2.5 times the forward's 2 (D + Dv) at D = Dv: S and dP recomputed,
// then dV, dQ, dK), against bytes of q, k, v, o, dout, lse, dq, dk, dv
// moved once.  The kernel pair is chosen per call by the wrapper's
// ``bwd_variant`` rule (kernels/flash_attention.py), passed as ``variant``:
//
// mma (bf16 at FLASH_BWD_MMA_PAIRS: (64, 64), (80, 80), (128, 128),
// (192, 128), (256, 256), every LM config's head width): all five products
// on the tensor cores, mma.sync.m16n8k16 bf16 -> f32, fragments by
// ldmatrix(.trans) from shared tiles whose rows are padded by 16 bytes (as
// the forward: no bank read twice), tiles streamed through two-stage
// cp.async rings.  p and ds, f32 in the function, are the A operands of
// dv = p^T dout, dq = ds k and dk = ds^T q: each goes in as two bf16
// operands, hi = bf16(x) and lo = bf16(x - hi), whose sum keeps 16
// significant bits, and both multiply the same B fragments into the f32
// sums.  One bf16 rounding (2**-9 relative a term) would not hold the bf16
// tolerance where a key is seen by few rows with large p: replayed on the
// CPU (tests/test_torch_flash_attention.py) it misses the bound by up to
// 1.8x at a window of 2 with G = 32; the split stays within 0.7 of it.
// That costs the three products a second MMA each (no second fragment
// load).
//   flash_bwd_dq_mma_kernel: a block of 4 warps per 64 query rows (all G
//     groups, position-major as the forward), a warp per 16 rows.  S = Q K^T
//     and dP = dO V^T on the tensor cores, Q's and dO's A fragments read
//     from their shared tiles at every k-step; P = exp2(S scale log2(e) -
//     lse log2(e)) and dS = P (dP - delta) in registers; dS, split and
//     packed, is the A operand of dQ += dS K with K through ldmatrix.trans.
//     A thread holds D / 2 accumulators and two BK / 2 score tiles: BK = 64
//     keys a tile up to D = 128, 32 past it (128 + 32 registers at D = 256).
//   flash_bwd_dkdv_mma_kernel: a block of 4 warps per 64 / WN keys.  A warp
//     computes the transposed tiles S^T = K Q^T and dP^T = V dO^T for its
//     16 keys, so P^T and dS^T come out of the MMAs already in the layout
//     of an A operand for dV += P^T dO and dK += dS^T Q (dO and Q through
//     ldmatrix.trans): no transpose through shared memory.  Its
//     accumulators are 16 keys by D + Dv columns, (D + Dv) / 2 registers a
//     thread: 256 at D = Dv = 256, more than a thread has.  So past D = 128
//     (WN = 2) two warps share 16 keys: each computes S^T and dP^T over half
//     of a tile's query rows, stages P^T and dS^T in bf16 through shared
//     memory, and after a barrier takes half of dk's and dv's columns over
//     all the rows (FA2's split for head width 256): 128 + 16 registers a
//     thread at D = 256.  The staged tiles are the hi and lo halves of P^T
//     and dS^T, read back by ldmatrix as A operands.  Query rows stream in
//     tiles of BQ = 64 (32 from D = 128, which keeps the score tiles at 16
//     registers).
//   ptxas reports no spills for any instance.
//
// fma (f32, whose 1e-4 tolerance bf16 products would not hold, and bf16
// outside those pairs): the CUDA-core kernels, a block per 32 query rows
// (dq) or 32 keys (dk/dv) in which 8 threads share one row and own its
// columns c = sub + 8 n: their partial dots reduce over 3 shuffles, and
// each thread's accumulator columns stay in registers; shared rows padded
// by 8 floats so the 4 rows one warp reads hit distinct banks.
#include "flash_mma.cuh"

namespace {

using namespace flash;

// ---------------------------------------------------------------------------
// The CUDA-core kernels: f32, and bf16 outside FLASH_BWD_MMA_PAIRS
// ---------------------------------------------------------------------------


constexpr int THREADS = 256;
constexpr int SUB = 8;                  // threads per row
constexpr int TILE = THREADS / SUB;     // rows per block, keys per tile: 32
constexpr int PAD = 8;                  // floats of padding per shared row
constexpr int MAX_D = 256;
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


// ---------------------------------------------------------------------------
// The tensor-core kernels: bf16 on mma.sync, at FLASH_BWD_MMA_PAIRS
// ---------------------------------------------------------------------------

constexpr int MW = 4;                   // warps per block
constexpr int M_THREADS = 32 * MW;
constexpr int M_ROWS = 16 * MW;         // dq: query rows per block

// dq: keys per K/V tile.  dk/dv: warps that share 16 keys (each taking
// 1 / WN of dk's and dv's columns), and query rows per streamed tile.
__host__ __device__ constexpr int dq_bk(int D) { return D > 128 ? 32 : 64; }
__host__ __device__ constexpr int dkdv_wn(int D) { return D > 128 ? 2 : 1; }
__host__ __device__ constexpr int dkdv_bq(int D) { return D >= 128 ? 32 : 64; }

// Q and dO tiles, two K/V stages, the rows' lse and delta
__host__ __device__ constexpr size_t dq_mma_smem(int D, int Dv) {
  return ((size_t)M_ROWS + 2 * dq_bk(D)) * ((D + 8) + (Dv + 8)) * 2 +
         2 * (size_t)M_ROWS * sizeof(float);
}
// the block's K and V, two stages of (Q, dO, lse, delta) and, for WN = 2,
// the staged P^T and dS^T, each as hi and lo
__host__ __device__ constexpr size_t dkdv_mma_smem(int D, int Dv) {
  return ((size_t)64 / dkdv_wn(D) + 2 * dkdv_bq(D)) * ((D + 8) + (Dv + 8)) *
             2 +
         2 * 2 * (size_t)dkdv_bq(D) * sizeof(float) +
         (dkdv_wn(D) > 1 ? 4 * (size_t)(64 / dkdv_wn(D)) * (dkdv_bq(D) + 8) * 2
                         : 0);
}

// dq (and delta): a block per 64 query rows (all G groups, position-major,
// as the forward) of one b * kv head
template <int D, int Dv>
__global__ void __launch_bounds__(M_THREADS)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ o,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int G, int Tq,
                        int Tk, int bq, int causal, int window, float scale,
                        float scale_log2) {
  extern __shared__ __align__(16) unsigned char m_smem[];
  constexpr int BK = dq_bk(D), NT = BK / 8;
  constexpr int ds = D + 8, dvs = Dv + 8;
  constexpr int DT = D / 16, DVT = Dv / 16;
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(m_smem);
  __nv_bfloat16* do_s = q_s + M_ROWS * ds;
  __nv_bfloat16* k_s0 = do_s + M_ROWS * dvs;
  __nv_bfloat16* v_s0 = k_s0 + BK * ds;
  constexpr int kv_stage = BK * (ds + dvs);
  float* l_s = reinterpret_cast<float*>(k_s0 + 2 * kv_stage);  // lse log2(e)
  float* e_s = l_s + M_ROWS;                                   // delta
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, c4 = lane & 3;
  const int bh = blockIdx.y;
  const int t0 = blockIdx.x * bq;
  const int rows = G * bq;
  const size_t row0 = (size_t)bh * G * Tq;     // (bh, group 0, position 0)
  const __nv_bfloat16* kb = k + (size_t)bh * Tk * D;
  const __nv_bfloat16* vb = v + (size_t)bh * Tk * Dv;
  const int2 tiles = key_tiles(BK, t0, bq, Tq, Tk, causal, window);
  const int tile_lo = tiles.x, tile_hi = tiles.y;
  auto load_kv = [&](int tile, int stage) {
    cp_rows<BK, D, M_THREADS>(k_s0 + stage * kv_stage, ds, kb, tile * BK,
                              Tk, tid);
    cp_rows<BK, Dv, M_THREADS>(v_s0 + stage * kv_stage, dvs, vb, tile * BK,
                               Tk, tid);
  };
  cp_gqa_rows<M_ROWS, D, M_THREADS>(q_s, ds, q + row0 * D, G, Tq, t0, rows,
                                    tid);
  cp_gqa_rows<M_ROWS, Dv, M_THREADS>(do_s, dvs, dout + row0 * Dv, G, Tq, t0,
                                     rows, tid);
  cp_async_commit();
  load_kv(tile_lo, 0);
  cp_async_commit();

  // delta = rowsum(dout * o), written for the dk/dv kernel, and the rows'
  // lse: a warp per 16 rows, its lanes across the row
  for (int i = 0; i < 16; ++i) {
    const int r = warp * 16 + i;
    const int t = t0 + r / G;
    float dl = 0.f, ls = 0.f;
    if (r < rows && t < Tq) {                 // warp-uniform
      const size_t row = row0 + (size_t)(r % G) * Tq + t;
      for (int c = lane; c < Dv; c += 32)
        dl = fmaf(__bfloat162float(dout[row * Dv + c]),
                  __bfloat162float(o[row * Dv + c]), dl);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dl += __shfl_xor_sync(FULL, dl, off);
      ls = lse[row] * LOG2E;
      if (lane == 0) delta[row] = dl;
    }
    if (lane == 0) {
      e_s[r] = dl;
      l_s[r] = ls;
    }
  }

  const WarpRows wr(warp, g4, G, bq, t0, Tq, Tk, causal, window);

  float acc[2 * DT][4];
#pragma unroll
  for (int n = 0; n < 2 * DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  cp_async_wait<1>();                     // Q and dO have landed
  __syncthreads();                        // and delta, lse
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse2[h] = l_s[wr.first + g4 + 8 * h];
    dl[h] = e_s[wr.first + g4 + 8 * h];
  }

  for (int tile = tile_lo; tile <= tile_hi; ++tile) {
    const int stage = (tile - tile_lo) & 1;
    if (tile < tile_hi) load_kv(tile + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                   // this tile has landed
    __syncthreads();
    const int kpos0 = tile * BK;
    if (!wr.skip(kpos0, BK, causal, window)) {
      const __nv_bfloat16* ks = k_s0 + stage * kv_stage;
      const __nv_bfloat16* vs = v_s0 + stage * kv_stage;
      // ---- S = Q K^T and dP = dO V^T: NT n-tiles of 8 keys each ----------
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kt = 0; kt < DT; ++kt) {
        uint32_t a[4];
        load_a(a, q_s, ds, wr.first, kt * 16, lane);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t b[4];
          load_bt(b, ks, ds, np * 16, kt * 16, lane);
          mma_bf16(s[2 * np], a, b[0], b[1]);
          mma_bf16(s[2 * np + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int kt = 0; kt < DVT; ++kt) {
        uint32_t a[4];
        load_a(a, do_s, dvs, wr.first, kt * 16, lane);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t b[4];
          load_bt(b, vs, dvs, np * 16, kt * 16, lane);
          mma_bf16(dp[2 * np], a, b[0], b[1]);
          mma_bf16(dp[2 * np + 1], a, b[2], b[3]);
        }
      }
      // ---- P = exp(s scale - lse) on the visible pairs, dS = P (dP - delta)
      const bool edge = wr.edge(kpos0, BK, Tk, causal, window);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int kp = kpos0 + 8 * j + 2 * c4 + (e & 1);
          const bool ok = !edge || wr.sees(h, kp);
          const float p = ok ? ex2(fmaf(s[j][e], scale_log2, -lse2[h])) : 0.f;
          s[j][e] = p * (dp[j][e] - dl[h]);
        }
      // ---- dQ += dS K: dS as two bf16 A operands (hi, lo), 16 keys a step
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        uint32_t hi[4], lo[4];
        pack_a_split(hi, lo, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int c = 0; c < DT; ++c) {
          uint32_t b[4];
          load_b(b, ks, ds, kk * 16, c * 16, lane);
          mma_bf16(acc[2 * c], hi, b[0], b[1]);
          mma_bf16(acc[2 * c + 1], hi, b[2], b[3]);
          mma_bf16(acc[2 * c], lo, b[0], b[1]);
          mma_bf16(acc[2 * c + 1], lo, b[2], b[3]);
        }
      }
    }
    __syncthreads();                      // this stage is consumed
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wr.first + g4 + 8 * h;
    const int t = t0 + r / G;
    if (r >= rows || t >= Tq) continue;
    __nv_bfloat16* qrow = dq + (row0 + (size_t)(r % G) * Tq + t) * D;
#pragma unroll
    for (int n = 0; n < 2 * DT; ++n)
      *reinterpret_cast<uint32_t*>(qrow + 8 * n + 2 * c4) =
          pack_bf16(acc[n][2 * h] * scale, acc[n][2 * h + 1] * scale);
  }
}

// dk, dv: a block per 64 / WN keys of one b * kv head, summed over G groups.
// A warp owns 16 keys (and, at WN = 2, half of dk's and dv's columns); it
// computes the transposed scores S^T = K Q^T and dP^T = V dO^T over its
// share of a tile's query rows, so P^T and dS^T come out of the MMAs as
// A operands of dV += P^T dO and dK += dS^T Q.
template <int D, int Dv>
__global__ void __launch_bounds__(M_THREADS)
flash_bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int G, int Tq,
                          int Tk, int causal, int window, float scale,
                          float scale_log2) {
  extern __shared__ __align__(16) unsigned char m_smem[];
  constexpr int WN = dkdv_wn(D), KB = 64 / WN, BQ = dkdv_bq(D);
  constexpr int ds = D + 8, dvs = Dv + 8;
  constexpr int DT = D / 16, DVT = Dv / 16;
  constexpr int DH = D / WN, DVH = Dv / WN;   // a warp's dk, dv columns
  constexpr int NQ = BQ / WN / 8;             // its n-tiles of 8 query rows
  constexpr int ps = BQ + 8;                  // staged P^T, dS^T row stride
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(m_smem);
  __nv_bfloat16* v_s = k_s + KB * ds;
  __nv_bfloat16* q_s0 = v_s + KB * dvs;
  __nv_bfloat16* do_s0 = q_s0 + BQ * ds;
  constexpr int q_stage = BQ * (ds + dvs);
  float* l_s0 = reinterpret_cast<float*>(q_s0 + 2 * q_stage);
  float* e_s0 = l_s0 + 2 * BQ;
  // staged P^T (hi, then lo) and dS^T (hi, then lo), at WN = 2
  __nv_bfloat16* p_s = reinterpret_cast<__nv_bfloat16*>(e_s0 + 2 * BQ);
  __nv_bfloat16* g_s = p_s + 2 * KB * ps;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, c4 = lane & 3;
  const int kw0 = (warp / WN) * 16;           // the warp's keys in the block
  const int ch = warp % WN;                   // its share of the columns
  const int n0 = ch * (BQ / WN);              // and of a tile's rows
  const int bh = blockIdx.y, kp0 = blockIdx.x * KB;
  const int key_w = kp0 + kw0;
  const int q_off = Tk - Tq;
  const size_t row0 = (size_t)bh * G * Tq;

  cp_rows<KB, D, M_THREADS>(k_s, ds, k + (size_t)bh * Tk * D, kp0, Tk, tid);
  cp_rows<KB, Dv, M_THREADS>(v_s, dvs, v + (size_t)bh * Tk * Dv, kp0, Tk,
                             tid);

  // the query positions that can see any key of this block, in tiles of
  // BQ per group
  const int kp_hi = min(kp0 + KB, Tk) - 1;
  int t_lo = 0, t_hi = Tq - 1;
  if (causal) t_lo = max(0, kp0 - q_off);
  if (window > 0) t_hi = min(t_hi, kp_hi + window - 1 - q_off);
  const int n_t = t_hi >= t_lo ? (t_hi - t_lo) / BQ + 1 : 0;
  const int n_tiles = G * n_t;

  auto load_q = [&](int it, int stage) {
    const int g = it / n_t, tt = t_lo + (it - g * n_t) * BQ;
    const size_t rg = row0 + (size_t)g * Tq;
    cp_rows<BQ, D, M_THREADS>(q_s0 + stage * q_stage, ds, q + rg * D, tt, Tq,
                              tid);
    cp_rows<BQ, Dv, M_THREADS>(do_s0 + stage * q_stage, dvs, dout + rg * Dv,
                               tt, Tq, tid);
    for (int r = tid; r < BQ; r += M_THREADS) {
      const bool ok = tt + r < Tq;
      const size_t row = rg + (ok ? tt + r : 0);
      cp_async4(l_s0 + stage * BQ + r, lse + row, ok ? 4 : 0);
      cp_async4(e_s0 + stage * BQ + r, delta + row, ok ? 4 : 0);
    }
  };
  if (n_tiles > 0) load_q(0, 0);
  cp_async_commit();                      // K, V and the first tile

  float ak[DH / 8][4], av[DVH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[n][e] = 0.f;
#pragma unroll
  for (int n = 0; n < DVH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) av[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) load_q(it + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                   // this tile has landed
    __syncthreads();
    const int tt = t_lo + (it % n_t) * BQ;
    const __nv_bfloat16* qs = q_s0 + stage * q_stage;
    const __nv_bfloat16* dos = do_s0 + stage * q_stage;
    const float* ls = l_s0 + stage * BQ;
    const float* es = e_s0 + stage * BQ;
    const int qlo = q_off + tt;
    const int qhi = q_off + min(tt + BQ, Tq) - 1;
    // the warp's 16 keys unseen by every row of the tile (WN = 1 only: at
    // WN = 2 every warp reaches the staging barrier)
    const bool skip = WN == 1 && ((causal && key_w > qhi) ||
                                  (window > 0 && key_w + 15 <= qlo - window));
    if (!skip) {
      // ---- S^T = K Q^T and dP^T = V dO^T: NQ n-tiles of 8 query rows -----
      float st[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kt = 0; kt < DT; ++kt) {
        uint32_t a[4];
        load_a(a, k_s, ds, kw0, kt * 16, lane);
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          uint32_t b[4];
          load_bt(b, qs, ds, n0 + np * 16, kt * 16, lane);
          mma_bf16(st[2 * np], a, b[0], b[1]);
          mma_bf16(st[2 * np + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int kt = 0; kt < DVT; ++kt) {
        uint32_t a[4];
        load_a(a, v_s, dvs, kw0, kt * 16, lane);
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          uint32_t b[4];
          load_bt(b, dos, dvs, n0 + np * 16, kt * 16, lane);
          mma_bf16(dpt[2 * np], a, b[0], b[1]);
          mma_bf16(dpt[2 * np + 1], a, b[2], b[3]);
        }
      }
      // ---- P^T on the visible pairs, dS^T = P^T (dP^T - delta) -----------
      const bool edge = tt + BQ > Tq || key_w + 16 > Tk ||
                        (causal && key_w + 15 > qlo) ||
                        (window > 0 && key_w <= qhi - window);
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = key_w + g4 + 8 * (e >> 1);
          const int col = n0 + 8 * j + 2 * c4 + (e & 1);
          const int qpos = qlo + col;
          const bool ok = !edge || (qpos < q_off + Tq && kp < Tk &&
                                    (!causal || kp <= qpos) &&
                                    (window <= 0 || kp > qpos - window));
          const float p =
              ok ? ex2(fmaf(st[j][e], scale_log2, -ls[col] * LOG2E)) : 0.f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - es[col]);
        }
      if constexpr (WN == 1) {
        // ---- dV += P^T dO, dK += dS^T Q: steps of 16 query rows ----------
#pragma unroll
        for (int kk = 0; kk < NQ / 2; ++kk) {
          uint32_t hi[4], lo[4];
          pack_a_split(hi, lo, st[2 * kk], st[2 * kk + 1]);
#pragma unroll
          for (int c = 0; c < DVT; ++c) {
            uint32_t b[4];
            load_b(b, dos, dvs, kk * 16, c * 16, lane);
            mma_bf16(av[2 * c], hi, b[0], b[1]);
            mma_bf16(av[2 * c + 1], hi, b[2], b[3]);
            mma_bf16(av[2 * c], lo, b[0], b[1]);
            mma_bf16(av[2 * c + 1], lo, b[2], b[3]);
          }
          pack_a_split(hi, lo, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
          for (int c = 0; c < DT; ++c) {
            uint32_t b[4];
            load_b(b, qs, ds, kk * 16, c * 16, lane);
            mma_bf16(ak[2 * c], hi, b[0], b[1]);
            mma_bf16(ak[2 * c + 1], hi, b[2], b[3]);
            mma_bf16(ak[2 * c], lo, b[0], b[1]);
            mma_bf16(ak[2 * c + 1], lo, b[2], b[3]);
          }
        }
      } else {
        // ---- stage P^T and dS^T (hi, lo) for the warps sharing these keys
#pragma unroll
        for (int kk = 0; kk < NQ / 2; ++kk) {
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            if (x == 0) pack_a_split(hi, lo, st[2 * kk], st[2 * kk + 1]);
            else pack_a_split(hi, lo, dpt[2 * kk], dpt[2 * kk + 1]);
            __nv_bfloat16* dst = x == 0 ? p_s : g_s;
#pragma unroll
            for (int i = 0; i < 4; ++i) {   // A register i: row +8 (i & 1),
              const int off = (kw0 + g4 + 8 * (i & 1)) * ps + n0 + 16 * kk +
                              8 * (i >> 1) + 2 * c4;   // column +8 (i >> 1)
              *reinterpret_cast<uint32_t*>(dst + off) = hi[i];
              *reinterpret_cast<uint32_t*>(dst + KB * ps + off) = lo[i];
            }
          }
        }
      }
    }
    if constexpr (WN > 1) {
      __syncthreads();                    // P^T, dS^T of all BQ rows staged
      // ---- dV += P^T dO, dK += dS^T Q over this warp's columns -----------
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t hi[4], lo[4];
        load_a(hi, p_s, ps, kw0, kk * 16, lane);
        load_a(lo, p_s + KB * ps, ps, kw0, kk * 16, lane);
#pragma unroll
        for (int c = 0; c < DVH / 16; ++c) {
          uint32_t b[4];
          load_b(b, dos, dvs, kk * 16, ch * DVH + c * 16, lane);
          mma_bf16(av[2 * c], hi, b[0], b[1]);
          mma_bf16(av[2 * c + 1], hi, b[2], b[3]);
          mma_bf16(av[2 * c], lo, b[0], b[1]);
          mma_bf16(av[2 * c + 1], lo, b[2], b[3]);
        }
        load_a(hi, g_s, ps, kw0, kk * 16, lane);
        load_a(lo, g_s + KB * ps, ps, kw0, kk * 16, lane);
#pragma unroll
        for (int c = 0; c < DH / 16; ++c) {
          uint32_t b[4];
          load_b(b, qs, ds, kk * 16, ch * DH + c * 16, lane);
          mma_bf16(ak[2 * c], hi, b[0], b[1]);
          mma_bf16(ak[2 * c + 1], hi, b[2], b[3]);
          mma_bf16(ak[2 * c], lo, b[0], b[1]);
          mma_bf16(ak[2 * c + 1], lo, b[2], b[3]);
        }
      }
    }
    __syncthreads();                      // this stage is consumed
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kp = key_w + g4 + 8 * h;
    if (kp >= Tk) continue;
    __nv_bfloat16* krow = dk + ((size_t)bh * Tk + kp) * D + ch * DH;
    __nv_bfloat16* vrow = dv + ((size_t)bh * Tk + kp) * Dv + ch * DVH;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<uint32_t*>(krow + 8 * n + 2 * c4) =
          pack_bf16(ak[n][2 * h] * scale, ak[n][2 * h + 1] * scale);
#pragma unroll
    for (int n = 0; n < DVH / 8; ++n)
      *reinterpret_cast<uint32_t*>(vrow + 8 * n + 2 * c4) =
          pack_bf16(av[n][2 * h], av[n][2 * h + 1]);
  }
}

template <int D, int Dv>
int launch_mma(const Args& a) {
  static bool configured = false;       // once per instance, before any
  if (!configured) {                    // CUDA-graph capture
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_mma_kernel<D, Dv>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_mma_smem(D, Dv));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_bwd_dkdv_mma_kernel<D, Dv>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dkdv_mma_smem(D, Dv));
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  using bf = __nv_bfloat16;
  const float scale_log2 = a.scale * LOG2E;
  const int bq = M_ROWS / a.G;
  dim3 grid_q((a.Tq + bq - 1) / bq, a.BH);
  flash_bwd_dq_mma_kernel<D, Dv><<<grid_q, M_THREADS, dq_mma_smem(D, Dv),
                                   a.stream>>>(
      static_cast<const bf*>(a.q), static_cast<const bf*>(a.k),
      static_cast<const bf*>(a.v), static_cast<const bf*>(a.o),
      static_cast<const bf*>(a.dout), a.lse, a.delta, static_cast<bf*>(a.dq),
      a.G, a.Tq, a.Tk, bq, a.causal, a.window, a.scale, scale_log2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  constexpr int KB = 64 / dkdv_wn(D);
  dim3 grid_k((a.Tk + KB - 1) / KB, a.BH);
  flash_bwd_dkdv_mma_kernel<D, Dv><<<grid_k, M_THREADS,
                                     dkdv_mma_smem(D, Dv), a.stream>>>(
      static_cast<const bf*>(a.q), static_cast<const bf*>(a.k),
      static_cast<const bf*>(a.v), static_cast<const bf*>(a.dout), a.lse,
      a.delta, static_cast<bf*>(a.dk), static_cast<bf*>(a.dv), a.G, a.Tq,
      a.Tk, a.causal, a.window, a.scale, scale_log2);
  return (int)cudaGetLastError();
}

// The (D, Dv) pairs with tensor-core instances: the wrapper's
// BWD_MMA_PAIRS (kernels/flash_attention.py), which a CPU test holds to
// this list; the head widths of every LM config in the repository.
#define FLASH_BWD_MMA_PAIRS(X) \
  X(64, 64) X(80, 80) X(128, 128) X(192, 128) X(256, 256)

int launch_mma_pair(const Args& a) {
#define FLASH_BWD_LAUNCH(d, dv) \
  if (a.D == d && a.Dv == dv) return launch_mma<d, dv>(a);
  FLASH_BWD_MMA_PAIRS(FLASH_BWD_LAUNCH)
#undef FLASH_BWD_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launches the dq kernel (which also writes delta, (BH, G, Tq) f32 scratch)
// and then the dk/dv kernel on ``stream``: variant 1 the tensor-core pair
// (bf16 at FLASH_BWD_MMA_PAIRS, 16-byte aligned q, k, v, dout), variant 0
// the CUDA-core pair.  Returns cudaGetLastError() after the launches;
// cudaErrorInvalidValue (1) for shapes the kernels do not take (the
// wrapper checks first).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int BH, int G, int Tq, int Tk, int D, int Dv, int causal,
    int window, int bf16, int variant, float scale, void* stream) {
  if (G < 1 || G > TILE || D < 1 || D > MAX_D || Dv < 1 || Dv > MAX_D ||
      Tq < 1 || Tk < 1 || (Tq > Tk && (causal || window > 0)) || BH < 1)
    return (int)cudaErrorInvalidValue;
  const Args a{q,  k,  v,  o,      dout,   static_cast<const float*>(lse),
               static_cast<float*>(delta), dq, dk, dv, BH, G, Tq, Tk, D, Dv,
               causal, window, scale, static_cast<cudaStream_t>(stream)};
  if (variant == 1) {
    if (!bf16 || (reinterpret_cast<uintptr_t>(q) |
                  reinterpret_cast<uintptr_t>(k) |
                  reinterpret_cast<uintptr_t>(v) |
                  reinterpret_cast<uintptr_t>(dout)) % 16)
      return (int)cudaErrorInvalidValue;
    return launch_mma_pair(a);
  }
  return bf16 ? launch_nc<__nv_bfloat16>(a) : launch_nc<float>(a);
}
