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
//   out = acc / max(l, 1e-30) in v's type;
//   optionally lse = m + log(max(l, 1e-30)) per row in f32 (natural log of
//   the row's sum of exp(s)), the one statistic the backward kernel
//   (flash_attention_bwd.cu) needs to rebuild p; null on the serve paths,
//   which then write nothing more.
// This is what the Pallas kernel computes, tile for tile.  Tiles wholly
// above the causal diagonal or left of the window are skipped; the ragged
// edges (Tq, Tk not multiples of a tile) are masked, so no input is ever
// padded.
//
// What bounds it on an H100: at the LM's prefill shapes (D = 64, G = 3)
// operations -- 2 * (D + Dv) flops per visible (query, key) pair against
// 989 TFLOP/s bf16 on the tensor cores -- over bytes (q, k, v, o once, at
// 3.35 TB/s).  Two kernels, chosen per call by the wrapper's rule
// (kernels/flash_attention.py ``variant``), passed in as ``variant``:
//
// flash_mma_kernel (bf16, D and Dv each 16, 32, 64 or 128: every served
// shape).  FA2-style on the tensor cores.  One block of 4 warps per (64-row
// q tile, b * kv head); each warp owns 16 rows (one m16 tile).  GQA without
// repeats: the 64 rows of a block are bq = 64 / G query positions of ALL G
// groups, position-major (row r is position t0 + r / G, group r % G; at
// G = 3, 21 positions and one padding row), so every K/V tile staged
// serves all G groups and K/V are read once per q tile; position-major
// keeps a warp's 16 rows within 16 / G positions, so the causal edge cuts
// few of them.  (The other choice, a block per query head with L2 serving
// the G repeated K/V reads, gives the same grid at T = 1024 but stages
// each K/V tile G times.)  Q comes in once by cp.async and stays in
// registers (ldmatrix).  K/V tiles of 64 keys stream through a two-stage
// cp.async ring in shared memory, rows padded by 16 bytes so that ldmatrix
// reads no bank twice.  S = Q K^T runs on mma.sync.m16n8k16 bf16 -> f32;
// the row max and sum reduce across each quad with two shuffles; P is
// rounded to bf16 in registers, which is the "p in v's type" rounding, and
// feeds P V directly as the A operand, with V through ldmatrix.trans.  A
// warp skips the tiles none of its rows can see and masks only the tiles
// that cut its rows.  One instance per (D, Dv), so every loop over columns
// has a fixed trip count and a tile's fragment loads and MMAs schedule as
// one block of code; exp is MUFU's ex2 of log2(e)-scaled scores (the same
// function, rounded otherwise; within the bf16 tolerance).
//
// flash_kernel (f32, and bf16 shapes outside the rule above: D or Dv of
// 192 or 256, or not a power of two from 16).  The CUDA-core kernel: one
// block of 4 warps per (32 query rows = all G groups x 32 / G positions, b * kv
// head), keys in tiles of 32 (one per lane for the scores, shuffled to
// every lane for p . v), f32 FMAs.  f32 stays here: TF32 tensor-core
// products would not hold the 2e-5 f32 tolerance, and no served path
// runs attention in f32.  D = 256 would not fit the mma kernel's
// registers (Q fragments and accumulators of 256 columns per row pair).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// flash_mma_kernel: bf16 on mma.sync
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 4;
constexpr int TC_ROWS = 16 * TC_WARPS;    // query rows per block
constexpr int TC_BK = 64;                 // keys per tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG_INF = -1e30f;          // a masked score, both kernels

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; bytes beyond src_bytes (0 or 16) are zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// 2**x, MUFU's approximation (relative error ~2**-22, far inside the bf16
// tolerance); flushes subnormal results to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);   // round to nearest
  return *reinterpret_cast<uint32_t*>(&h);
}

// dynamic shared memory: Q tile, then two stages of (K tile, V tile),
// rows padded by 8 elements (16 bytes)
__host__ __device__ constexpr size_t tc_smem_bytes(int D, int Dv) {
  return ((size_t)TC_ROWS * (D + 8) +
          2 * (size_t)TC_BK * ((D + 8) + (Dv + 8))) * 2;
}

// one instance per (D, Dv): every loop over columns has a fixed trip count,
// so the fragment loads and MMAs of a tile schedule as one block of code
template <int D, int Dv>
__global__ void __launch_bounds__(TC_WARPS * 32)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 int G, int Tq, int Tk, int bq, int causal, int window,
                 float scale_log2) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  constexpr int ds = D + 8, dvs = Dv + 8; // padded row strides (elements)
  constexpr int d8 = D / 8, dv8 = Dv / 8, DT = D / 16, DVT = Dv / 16;
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* k_s0 = q_s + TC_ROWS * ds;
  __nv_bfloat16* v_s0 = k_s0 + TC_BK * ds;
  constexpr int kv_stage = TC_BK * (ds + dvs);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, c4 = lane & 3;   // mma fragment row, column pair
  const int bh = blockIdx.y;
  const int t0 = blockIdx.x * bq;
  const int rows = G * bq;
  const int q_off = Tk - Tq;
  const __nv_bfloat16* qb = q + (size_t)bh * G * Tq * D;
  const __nv_bfloat16* kb = k + (size_t)bh * Tk * D;
  const __nv_bfloat16* vb = v + (size_t)bh * Tk * Dv;
  __nv_bfloat16* ob = out + (size_t)bh * G * Tq * Dv;

  // the key range any row of this block can see
  const int t_last = min(t0 + bq, Tq) - 1;
  int kv_hi = Tk - 1, kv_lo = 0;
  if (causal) kv_hi = min(kv_hi, q_off + t_last);
  if (window > 0) kv_lo = max(0, q_off + t0 - window + 1);
  const int tile_lo = kv_lo / TC_BK, tile_hi = kv_hi / TC_BK;

  auto load_kv = [&](int tile, int stage) {
    __nv_bfloat16* ks = k_s0 + stage * kv_stage;
    __nv_bfloat16* vs = v_s0 + stage * kv_stage;
    const int kpos0 = tile * TC_BK;
    for (int idx = tid; idx < TC_BK * d8; idx += TC_WARPS * 32) {
      const int j = idx / d8, c = idx - j * d8;
      const int kp = kpos0 + j;
      cp_async16(ks + j * ds + c * 8,
                 kb + (size_t)min(kp, Tk - 1) * D + c * 8, kp < Tk ? 16 : 0);
    }
    for (int idx = tid; idx < TC_BK * dv8; idx += TC_WARPS * 32) {
      const int j = idx / dv8, c = idx - j * dv8;
      const int kp = kpos0 + j;
      cp_async16(vs + j * dvs + c * 8,
                 vb + (size_t)min(kp, Tk - 1) * Dv + c * 8, kp < Tk ? 16 : 0);
    }
  };

  // Q rows: row r is (group r % G, position t0 + r / G); others zeros
  for (int idx = tid; idx < TC_ROWS * d8; idx += TC_WARPS * 32) {
    const int r = idx / d8, c = idx - r * d8;
    const int g = r % G, t = t0 + r / G;
    const bool ok = r < rows && t < Tq;
    cp_async16(q_s + r * ds + c * 8,
               ok ? qb + ((size_t)g * Tq + t) * D + c * 8 : qb,
               ok ? 16 : 0);
  }
  cp_async_commit();
  load_kv(tile_lo, 0);
  cp_async_commit();

  // this warp's rows and the keys they can see
  const int r_first = warp * 16;
  const int r_last = min(r_first + 15, rows - 1);
  const bool warp_live = r_first < rows && t0 + r_first / G < Tq;
  const int w_qlo = q_off + t0 + r_first / G;
  const int w_qhi = q_off + min(t0 + r_last / G, Tq - 1);
  // this thread's two rows (g4 and g4 + 8 of the warp's 16): the keys
  // [lo, hi) they see
  int key_lo[2], key_hi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r_first + g4 + 8 * h;
    const int t = t0 + r / G;
    key_lo[h] = 0;
    key_hi[h] = Tk;
    if (r < rows && t < Tq) {               // a padding row sees every key
      const int qpos = q_off + t;
      if (causal) key_hi[h] = min(Tk, qpos + 1);
      if (window > 0) key_lo[h] = qpos - window + 1;
    }
  }

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[2 * DVT][4];
#pragma unroll
  for (int n = 0; n < 2 * DVT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  uint32_t qf[DT][4];                     // Q, A fragments of 16 columns
  cp_async_wait<1>();                     // Q has landed
  __syncthreads();
#pragma unroll
  for (int kt = 0; kt < DT; ++kt)
    ldmatrix_x4(qf[kt], q_s + (r_first + (lane & 15)) * ds + kt * 16 +
                            (lane >> 4) * 8);

  for (int tile = tile_lo; tile <= tile_hi; ++tile) {
    const int stage = (tile - tile_lo) & 1;
    if (tile < tile_hi) load_kv(tile + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                   // this tile has landed
    __syncthreads();
    const int kpos0 = tile * TC_BK;
    const bool skip = !warp_live || (causal && kpos0 > w_qhi) ||
                      (window > 0 && kpos0 + TC_BK - 1 <= w_qlo - window);
    if (!skip) {
      const __nv_bfloat16* ks = k_s0 + stage * kv_stage;
      const __nv_bfloat16* vs = v_s0 + stage * kv_stage;
      // ---- S = Q K^T: 8 n-tiles of 8 keys ----------------------------------
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kt = 0; kt < DT; ++kt) {
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4];
          ldmatrix_x4(b, ks + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * ds +
                             kt * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], qf[kt], b[0], b[1]);
          mma_bf16(s[2 * np + 1], qf[kt], b[2], b[3]);
        }
      }
      // ---- mask (on the tiles that cut the warp's rows), online softmax --
      float mx[2] = {NEG_INF, NEG_INF};
      uint32_t seen = 0xffffffffu;        // bit 4 j + e: the key is visible
      const bool edge = kpos0 + TC_BK > Tk || (causal && kpos0 + TC_BK - 1 >
                                               w_qlo) ||
                        (window > 0 && kpos0 <= w_qhi - window);
      if (edge) {
        seen = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            const int kp = kpos0 + 8 * j + 2 * c4 + (e & 1);
            const bool ok = kp >= key_lo[h] && kp < key_hi[h];
            seen |= (uint32_t)ok << (4 * j + e);
            if (!ok) s[j][e] = NEG_INF;
          }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
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
      for (int j = 0; j < 8; ++j)
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
      // ---- O += P V: P in bf16 as the A operand, 4 steps of 16 keys -------
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a[4];
        a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int dp = 0; dp < DVT; ++dp) {
          uint32_t b[4];
          ldmatrix_x4_trans(
              b, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * dvs +
                     dp * 16 + (lane >> 4) * 8);
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
    const int r = r_first + g4 + 8 * h;
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

// D, Dv each one of 16, 32, 64, 128 (the wrapper's rule)
template <int D>
int launch_mma_dv(const MmaArgs& a, int Dv) {
  switch (Dv) {
    case 16: return launch_mma<D, 16>(a);
    case 32: return launch_mma<D, 32>(a);
    case 64: return launch_mma<D, 64>(a);
    case 128: return launch_mma<D, 128>(a);
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// flash_kernel: the CUDA-core kernel (f32, and bf16 outside the mma rule)
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

// variant 1: flash_mma_kernel (bf16; D, Dv each 16, 32, 64 or 128);
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
      Tq < 1 || Tq > Tk || BH < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if (!bf16 || (reinterpret_cast<uintptr_t>(q) |
                  reinterpret_cast<uintptr_t>(k) |
                  reinterpret_cast<uintptr_t>(v)) % 16)
      return (int)cudaErrorInvalidValue;
    const MmaArgs a{q, k, v, out, static_cast<float*>(lse), BH, G, Tq, Tk,
                    causal, window, scale, s};
    switch (D) {
      case 16: return launch_mma_dv<16>(a, Dv);
      case 32: return launch_mma_dv<32>(a, Dv);
      case 64: return launch_mma_dv<64>(a, Dv);
      case 128: return launch_mma_dv<128>(a, Dv);
    }
    return (int)cudaErrorInvalidValue;
  }
  float* lse_f = static_cast<float*>(lse);
  if (bf16)
    return launch_nacc<__nv_bfloat16>(q, k, v, out, lse_f, BH, G, Tq, Tk, D,
                                      Dv, causal, window, scale, s);
  return launch_nacc<float>(q, k, v, out, lse_f, BH, G, Tq, Tk, D, Dv,
                            causal, window, scale, s);
}
