// Flash attention: GQA-native streaming-softmax attention for sm_90a.
//
// Replaces flash_attention_pallas (src/repro/kernels/flash_attention.py:84).
// q (BH, G, Tq, D), k (BH, Tk, D), v (BH, Tk, Dv), out (BH, G, Tq, Dv),
// contiguous, f32 or bf16; BH = batch * kv heads.  Queries sit at the end
// of the key sequence (q_offset = Tk - Tq).  Non-causal with no window,
// every query sees every key and Tq may exceed Tk (the encoder-decoder's
// cross-attention): q_offset is then negative, and only the causal and
// window masks, which such a call does not have, read it.  Per (query
// row, key):
//   s = (q . k) * scale, summed in f32;
//   mask by absolute position: key < Tk, causal key <= qpos, window
//   key > qpos - window; masked s = -1e30 and masked p = 0;
//   online softmax with m, l in f32; p rounded to v's type before p . v;
//   out = acc / max(l, 1e-30) in v's type;
//   optionally lse = m + log(max(l, 1e-30)) per row in f32 (natural log of
//   the row's sum of exp(s)), the one statistic the backward kernels
//   (flash_attention_bwd.cu) need to rebuild p; null on the serve paths,
//   which then write nothing more.
// This is what the Pallas kernel computes, tile for tile.  Tiles wholly
// above the causal diagonal or left of the window are skipped; the ragged
// edges (Tq, Tk not multiples of a tile) are masked, so no input is ever
// padded.
//
// What bounds it on an H100: at the served shapes operations -- 2 * (D +
// Dv) flops per visible (query, key) pair against 989 TFLOP/s bf16 on the
// tensor cores -- over bytes (q, k, v, o once, at 3.35 TB/s).  Two
// kernels, chosen per call by the wrapper's rule (kernels/flash_attention.py
// ``variant``), passed in as ``variant``:
//
// flash_mma_kernel (bf16 at the (D, Dv) pairs of FLASH_MMA_PAIRS below:
// 16, 32, 64 or 128 each, and (80, 80), (192, 128), (256, 256) -- every
// served head width).  FA2-style on the tensor cores.  One block of 4 warps
// per (64-row q tile, b * kv head); each warp owns 16 rows (one m16 tile).
// GQA without repeats: the 64 rows of a block are bq = 64 / G query
// positions of ALL G groups, position-major (row r is position t0 + r / G,
// group r % G; at G = 3, 21 positions and one padding row), so every K/V
// tile staged serves all G groups and K/V are read once per q tile;
// position-major keeps a warp's 16 rows within 16 / G positions, so the
// causal edge cuts few of them.  (The other choice, a block per query head
// with L2 serving the G repeated K/V reads, gives the same grid at T = 1024
// but stages each K/V tile G times.)  Q comes in once by cp.async.  K/V
// tiles of BK keys stream through a two-stage cp.async ring in shared
// memory, rows padded by 16 bytes so that ldmatrix reads no bank twice (a
// row of D + 8 bf16 is 16 (D / 8 + 1) bytes, an odd number of 16-byte
// chunks for every D here, 176 bytes at D = 80: the 8 rows of one 8x8
// matrix start in 8 distinct 16-byte bank groups).  S = Q K^T runs on
// mma.sync.m16n8k16 bf16 -> f32; the row max and sum reduce across each
// quad with two shuffles; P is rounded to bf16 in registers, which is the
// "p in v's type" rounding, and feeds P V directly as the A operand, with
// V through ldmatrix.trans.  A warp skips the tiles none of its rows can
// see and masks only the tiles that cut its rows.  One instance per (D,
// Dv), so every loop over columns has a fixed trip count and a tile's
// fragment loads and MMAs schedule as one block of code; exp is MUFU's ex2
// of log2(e)-scaled scores (the same function, rounded otherwise; within
// the bf16 tolerance).
//   Registers: a thread holds its two rows' output accumulators (Dv / 2
// floats: 128 at Dv = 256) and one tile's scores (BK / 2).  Up to D = 128
// Q's A fragments stay in registers too (D / 4); past it (D = 192, 256)
// they would not fit beside a 256-column accumulator, so the S loop reads
// them from the shared Q tile by ldmatrix at every k-step (one more x4
// load per four K loads).  ptxas reports no spills for any instance.
//   Shared memory: the Q tile and two K/V stages, (64 (D + 8) + 2 BK
// (D + Dv + 16)) * 2 bytes, with BK = 64 keys: at most 104 KB up to D =
// 128 (two blocks an SM), 169 KB at D = 256 (one block an SM).  32-key
// tiles would fit two blocks an SM at D = 256 (101 KB); timed against 64
// at the six wide served shapes on an H100 80GB HBM3 at 700 W (PERF.md,
// row 6), 64 keys are faster summed (0.2569 ms against 0.2680) and at five
// of the six: a 64-key tile takes half the trips, and barriers, of the key
// loop.  32 keys won only at Gemma3's training forward (batch 8: 256
// blocks at D = 256, two waves at one block an SM, one at two; 0.0465 ms
// against 0.0568), a shape whose step is bound by the host.
//
// flash_kernel (f32, and bf16 shapes outside FLASH_MMA_PAIRS: D or Dv not
// a multiple of 16, or pairs with no instance).  The CUDA-core kernel: one
// block of 4 warps per (32 query rows = all G groups x 32 / G positions, b
// * kv head), keys in tiles of 32 (one per lane for the scores, shuffled to
// every lane for p . v), f32 FMAs.  f32 stays here: TF32 tensor-core
// products would not hold the 2e-5 f32 tolerance, and no served path runs
// attention in f32.
#include "flash_mma.cuh"

namespace {

using namespace flash;

// ---------------------------------------------------------------------------
// flash_mma_kernel: bf16 on mma.sync
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 4;
constexpr int TC_ROWS = 16 * TC_WARPS;    // query rows per block

constexpr int TC_BK = 64;                // keys per K/V tile (see the header)

// dynamic shared memory: Q tile, then two stages of (K tile, V tile),
// rows padded by 8 elements (16 bytes)
__host__ __device__ constexpr size_t tc_smem_bytes(int D, int Dv) {
  return ((size_t)TC_ROWS * (D + 8) +
          2 * (size_t)TC_BK * ((D + 8) + (Dv + 8))) * 2;
}

// one instance per (D, Dv): every loop over columns has a fixed trip count,
// so the fragment loads and MMAs of a tile schedule as one block of code.
// A minimum of one block an SM lets ptxas take the registers an instance
// needs: without it, it held some (64 x 64, 64 x 16, 32 x 128, 32 x 64)
// to 96-168 registers and spilled 4-12 bytes.
template <int D, int Dv>
__global__ void __launch_bounds__(TC_WARPS * 32, 1)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 int G, int Tq, int Tk, int bq, int causal, int window,
                 float scale_log2) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  constexpr int BK = TC_BK;               // keys per tile
  constexpr int NT = BK / 8;              // n-tiles of 8 keys
  constexpr bool QREG = D <= 128;         // Q's fragments in registers
  constexpr int ds = D + 8, dvs = Dv + 8; // padded row strides (elements)
  constexpr int DT = D / 16, DVT = Dv / 16;
  constexpr int THREADS = TC_WARPS * 32;
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* k_s0 = q_s + TC_ROWS * ds;
  __nv_bfloat16* v_s0 = k_s0 + BK * ds;
  constexpr int kv_stage = BK * (ds + dvs);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, c4 = lane & 3;   // mma fragment row, column pair
  const int bh = blockIdx.y;
  const int t0 = blockIdx.x * bq;
  const int rows = G * bq;
  const __nv_bfloat16* kb = k + (size_t)bh * Tk * D;
  const __nv_bfloat16* vb = v + (size_t)bh * Tk * Dv;
  __nv_bfloat16* ob = out + (size_t)bh * G * Tq * Dv;
  const int2 tiles = key_tiles(BK, t0, bq, Tq, Tk, causal, window);
  const int tile_lo = tiles.x, tile_hi = tiles.y;
  auto load_kv = [&](int tile, int stage) {
    cp_rows<BK, D, THREADS>(k_s0 + stage * kv_stage, ds, kb, tile * BK, Tk,
                            tid);
    cp_rows<BK, Dv, THREADS>(v_s0 + stage * kv_stage, dvs, vb, tile * BK,
                             Tk, tid);
  };
  cp_gqa_rows<TC_ROWS, D, THREADS>(q_s, ds, q + (size_t)bh * G * Tq * D, G,
                                   Tq, t0, rows, tid);
  cp_async_commit();
  load_kv(tile_lo, 0);
  cp_async_commit();
  const WarpRows wr(warp, g4, G, bq, t0, Tq, Tk, causal, window);

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[2 * DVT][4];
#pragma unroll
  for (int n = 0; n < 2 * DVT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  uint32_t qf[QREG ? DT : 1][4];          // Q, A fragments of 16 columns
  cp_async_wait<1>();                     // Q has landed
  __syncthreads();
  if constexpr (QREG) {
#pragma unroll
    for (int kt = 0; kt < DT; ++kt)
      load_a(qf[kt], q_s, ds, wr.first, kt * 16, lane);
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
      // ---- S = Q K^T: NT n-tiles of 8 keys ---------------------------------
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kt = 0; kt < DT; ++kt) {
        uint32_t a[4];
        if constexpr (QREG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qf[kt][e];
        } else {
          load_a(a, q_s, ds, wr.first, kt * 16, lane);
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t b[4];
          load_bt(b, ks, ds, np * 16, kt * 16, lane);
          mma_bf16(s[2 * np], a, b[0], b[1]);
          mma_bf16(s[2 * np + 1], a, b[2], b[3]);
        }
      }
      // ---- mask (on the tiles that cut the warp's rows), online softmax --
      float mx[2] = {NEG_INF, NEG_INF};
      uint32_t seen = 0xffffffffu;        // bit 4 j + e: the key is visible
      if (wr.edge(kpos0, BK, Tk, causal, window)) {
        seen = 0;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            const int kp = kpos0 + 8 * j + 2 * c4 + (e & 1);
            const bool ok = wr.sees(h, kp);
            seen |= (uint32_t)ok << (4 * j + e);
            if (!ok) s[j][e] = NEG_INF;
          }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          if ((seen >> (4 * j + e)) & 1u) s[j][e] *= scale_log2;
          mx[h] = fmaxf(mx[h], s[j][e]);
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        alpha[h] = ex2(m[h] - m_new);
        m[h] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const float p =
              (seen >> (4 * j + e)) & 1u ? ex2(s[j][e] - m[h]) : 0.f;
          s[j][e] = p;
          rs[h] += p;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
#pragma unroll
      for (int n = 0; n < 2 * DVT; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
      // ---- O += P V: P in bf16 as the A operand, steps of 16 keys ---------
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        uint32_t a[4];
        pack_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int dp = 0; dp < DVT; ++dp) {
          uint32_t b[4];
          load_b(b, vs, dvs, kk * 16, dp * 16, lane);
          mma_bf16(o[2 * dp], a, b[0], b[1]);
          mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();                      // this stage is consumed
  }

  // ---- out = acc / max(l, 1e-30), bf16 --------------------------------------
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wr.first + g4 + 8 * h;
    const int t = t0 + r / G;
    if (r >= rows || t >= Tq) continue;
    const float denom = fmaxf(l[h], 1e-30f);
    // m is in log2 units of the scaled scores
    if (lse != nullptr && c4 == 0)
      lse[((size_t)bh * G + r % G) * Tq + t] =
          (m[h] + log2f(denom)) * 0.69314718055994531f;
    __nv_bfloat16* orow = ob + ((size_t)(r % G) * Tq + t) * Dv;
#pragma unroll
    for (int n = 0; n < 2 * DVT; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * c4) =
          pack_bf16(o[n][2 * h] / denom, o[n][2 * h + 1] / denom);
  }
}

struct MmaArgs {
  const void *q, *k, *v;
  void* out;
  float* lse;
  int BH, G, Tq, Tk, causal, window;
  float scale;
  cudaStream_t stream;
};

template <int D, int Dv>
int launch_mma(const MmaArgs& a) {
  static bool configured = false;         // once per instance, before any
  if (!configured) {                      // CUDA-graph capture
    cudaError_t e = cudaFuncSetAttribute(
        flash_mma_kernel<D, Dv>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)tc_smem_bytes(D, Dv));
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int bq = TC_ROWS / a.G;
  dim3 grid((a.Tq + bq - 1) / bq, a.BH);
  flash_mma_kernel<D, Dv><<<grid, TC_WARPS * 32, tc_smem_bytes(D, Dv),
                            a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<__nv_bfloat16*>(a.out), a.lse, a.G, a.Tq, a.Tk, bq,
      a.causal, a.window, a.scale * LOG2E);
  return (int)cudaGetLastError();
}

// The (D, Dv) pairs with a flash_mma_kernel instance: the wrapper's
// MMA_PAIRS (kernels/flash_attention.py), which a CPU test holds to this
// list.
#define FLASH_MMA_PAIRS(X)                                                   \
  X(16, 16) X(16, 32) X(16, 64) X(16, 128)                                   \
  X(32, 16) X(32, 32) X(32, 64) X(32, 128)                                   \
  X(64, 16) X(64, 32) X(64, 64) X(64, 128)                                   \
  X(128, 16) X(128, 32) X(128, 64) X(128, 128)                               \
  X(80, 80) X(192, 128) X(256, 256)

int launch_mma_pair(const MmaArgs& a, int D, int Dv) {
#define FLASH_LAUNCH(d, dv) \
  if (D == d && Dv == dv) return launch_mma<d, dv>(a);
  FLASH_MMA_PAIRS(FLASH_LAUNCH)
#undef FLASH_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// flash_kernel: the CUDA-core kernel (f32, and bf16 outside the mma pairs)
// ---------------------------------------------------------------------------

constexpr int BK = 32;                    // keys per tile: one per lane
constexpr int WARPS = 4;
constexpr int ROWS = 8;                   // query rows per warp
constexpr int MAX_ROWS = WARPS * ROWS;    // G * bq rows per block
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
             const T* __restrict__ v, T* __restrict__ out,
             float* __restrict__ lse, int G, int Tq, int Tk, int D, int Dv,
             int bq, int causal, int window, float scale) {
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
    if (lse != nullptr && lane == 0)
      lse[((size_t)bh * G + g) * Tq + t] = m[i] + logf(denom);
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
                 float* lse, int BH, int G, int Tq, int Tk, int D, int Dv,
                 int causal, int window, float scale, cudaStream_t stream) {
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
      static_cast<const T*>(v), static_cast<T*>(out), lse, G, Tq, Tk, D, Dv,
      bq, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_nacc(const void* q, const void* k, const void* v, void* out,
                float* lse, int BH, int G, int Tq, int Tk, int D, int Dv,
                int causal, int window, float scale, cudaStream_t stream) {
  if (Dv <= 64)
    return launch_typed<T, 2>(q, k, v, out, lse, BH, G, Tq, Tk, D, Dv,
                              causal, window, scale, stream);
  if (Dv <= 128)
    return launch_typed<T, 4>(q, k, v, out, lse, BH, G, Tq, Tk, D, Dv,
                              causal, window, scale, stream);
  return launch_typed<T, 8>(q, k, v, out, lse, BH, G, Tq, Tk, D, Dv, causal,
                            window, scale, stream);
}

}  // namespace

// variant 1: flash_mma_kernel (bf16 at the pairs of FLASH_MMA_PAIRS);
// variant 0: flash_kernel.  The wrapper's ``variant`` rule picks one.
// lse: (BH, G, Tq) f32 row log-sum-exp for the backward, or null.
// Returns cudaGetLastError() after the launch; cudaErrorInvalidValue (1)
// for shapes the chosen kernel does not take (the wrapper checks first).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int BH,
                                      int G, int Tq, int Tk, int D, int Dv,
                                      int causal, int window, int bf16,
                                      int variant, float scale,
                                      void* stream) {
  if (G < 1 || G > MAX_ROWS || D < 1 || D > MAX_D || Dv < 1 || Dv > MAX_D ||
      Tq < 1 || Tk < 1 || (Tq > Tk && (causal || window > 0)) || BH < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if (!bf16 || (reinterpret_cast<uintptr_t>(q) |
                  reinterpret_cast<uintptr_t>(k) |
                  reinterpret_cast<uintptr_t>(v)) % 16)
      return (int)cudaErrorInvalidValue;
    const MmaArgs a{q, k, v, out, static_cast<float*>(lse), BH, G, Tq, Tk,
                    causal, window, scale, s};
    return launch_mma_pair(a, D, Dv);
  }
  float* lse_f = static_cast<float*>(lse);
  if (bf16)
    return launch_nacc<__nv_bfloat16>(q, k, v, out, lse_f, BH, G, Tq, Tk, D,
                                      Dv, causal, window, scale, s);
  return launch_nacc<float>(q, k, v, out, lse_f, BH, G, Tq, Tk, D, Dv,
                            causal, window, scale, s);
}
