// Online-softmax flash attention over blocks of 128 keys, forward and
// backward, on the token-major layout: K20, K21 and K22.
//
// Replaces the three TPU kernels of the library module behind the DiT's
// `tpu_flash_attn` route (jax/experimental/pallas/ops/tpu/flash_attention.py,
// called at ddg_tpu/models/dit.py:361-370 with every block 128):
//   K20 _flash_attention_impl     (pallas_call :758; kernel :342-482)
//   K21 _flash_attention_bwd_dkv  (pallas_call :1121; kernel :796-940)
//   K22 _flash_attention_bwd_dq   (pallas_call :1456; kernel :1146-1285)
// For each (b, h), with q, k, v of shape (B, L, H, D), L a multiple of 128:
//   s = (q k^T) * scale                  fp32; under `causal` only key blocks
//                                        at or below the query block run, and
//                                        keys past the row give p = 0
//   K20: per query row, walking the key blocks c in order,
//        m' = max(m, max_c s), p = exp(s - m'), l' = sum p + exp(m - m') l,
//        acc = acc * (exp(m - m') l / l') + (round(p) V_c) / l'
//        (round: to v's dtype); with one key block (L = 128): p = exp(s - m)
//        / l, o = round(p) V. Writes o, and l and m for the backward.
//   K21: per key, walking the query blocks in order, p = exp(s - m) * (1 / l),
//        ds = (do v^T - di) * p * scale, dv += round(p)^T do, dk +=
//        round(ds)^T q, with di = sum(o * do) formed outside (fp32).
//   K22: per query, walking the key blocks in order, dq += round(ds) k.
// The blocking is part of the function where bf16 rounds (the forward
// rounds the unnormalised p relative to the running max), so the forward
// keeps the library's 128-key blocks and its renormalisation order; the
// backward's rounding points are elementwise and its tiles are free.
// Nothing writes the (B, H, L, L) probabilities. No atomics: every sum is
// taken in one thread's order, so reruns are bit-identical.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16 dense): at the text8
// training shape (256 x 256 x 12 x 64 bf16) K20 moves 409 MB (q, k, v, o
// and the fp32 l and m rows; 0.122 ms) against 51.5 GFLOP (0.052 ms); K21
// and K22 read q, k, v, do, l, m and di and write two or one (B, L, H, D):
// bytes again (0.183, 0.153 ms). Measured there (NVIDIA H100 80GB HBM3,
// 700 W): 0.40, 0.77 and 0.53 ms, held by one block an SM (174-244
// registers) and mma.sync rather than wgmma.
//
// Two kernels for each of the three, picked by the launch:
// * the tensor-core kernels (`*_mma`), for bf16 with D a multiple of 16 up
//   to 64 and rows on 16-byte boundaries: 8 warps of mma.sync m16n8k16,
//   bf16 in, fp32 out. K20: a block is one library query block (128 rows,
//   16 a warp), Q's A fragments in registers, the 128-key blocks of K and V
//   streamed through a two-stage cp.async ring (the next block copies
//   while this one is used), S for 128 keys in registers (64 floats), the
//   row max and sum over the quad by shuffles, P rounded to bf16 straight
//   into the A fragments of P V. K21: a block is one library key block, K's
//   and V's A fragments in registers, the query rows streamed 64 at a time
//   through the ring (q, do, and the rows' m, 1 / l and di), S^T and dP^T
//   by mma, then dV and dK by mma on the rounded P^T and dS^T. K22: a block
//   is one query block, Q's and dO's fragments in registers, the key rows
//   streamed 64 at a time, dQ by mma on the rounded dS. Shared-memory rows
//   are padded by 16 bytes, so the ldmatrix reads of the B fragments (plain
//   for K^T-like operands, transposed for V-like ones) are conflict-free.
//   The mma order of each accumulator is fixed by the tiling alone.
// * the CUDA-core kernels (`*_core`), for fp32 and every other head width up
//   to 256: 32-row (K20, K22) or 32-key (K21) tiles, 8 warps of 4 rows, fp32
//   tiles in shared memory (rows padded by one float), staged synchronously,
//   a lane per key (or query) for the dot products and a lane per column
//   for the sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBlock = 128;        // the library's block, every kind
constexpr int kThreads = 256;      // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;          // CUDA-core tile: rows or keys
constexpr int kRows = kTile / kWarps;  // 4 a warp
constexpr int kSub = 64;           // tensor-core backward: streamed rows
constexpr int kDMax = 256;
constexpr int kMmaDMax = 64;
constexpr size_t kSmemMax = 232448;

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// A fragments (16 rows x 16 columns, row-major) of the rows `ra` (g) and
// `rb` (g + 8), at column 16 kk + 2t.
template <int DK>
__device__ __forceinline__ void a_frags(const bf16* ra, const bf16* rb, int t,
                                        uint32_t (&a)[DK][4]) {
#pragma unroll
  for (int kk = 0; kk < DK; ++kk) {
    a[kk][0] = ddg::ld32(ra + 16 * kk + 2 * t);
    a[kk][1] = ddg::ld32(rb + 16 * kk + 2 * t);
    a[kk][2] = ddg::ld32(ra + 16 * kk + 2 * t + 8);
    a[kk][3] = ddg::ld32(rb + 16 * kk + 2 * t + 8);
  }
}

// The A fragments of a 16 x 16 slice (columns 16 kk2 ..) of a product's fp32
// accumulator tiles c[2 kk2], c[2 kk2 + 1], rounded to bf16.
__device__ __forceinline__ void acc_to_a(const float (&c0)[4], const float (&c1)[4],
                                         uint32_t (&a)[4]) {
  a[0] = ddg::pack_bf16(c0[0], c0[1]);
  a[1] = ddg::pack_bf16(c0[2], c0[3]);
  a[2] = ddg::pack_bf16(c1[0], c1[1]);
  a[3] = ddg::pack_bf16(c1[2], c1[3]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// `rows` rows of D bf16 from `src` (rows `ts` apart, 16-byte aligned) into
// shared memory rows of D + 8, by 16-byte cp.async (committed by the caller).
template <int D>
__device__ __forceinline__ void stage_async(bf16* dst, const bf16* src, size_t ts, int rows) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i - r * kChunks;
    cp_async16(smem_addr(dst + r * (D + 8) + c * 8), src + r * ts + c * 8, true);
  }
}

// Four 8 x 8 bf16 matrices from shared memory, rows at the lanes' addresses
// (lanes 8i..8i+7 give matrix i's rows): lane l gets row l / 4, columns
// 2 (l % 4) and + 1 of each; transposed (`_t`), column l / 4, rows 2 (l % 4)
// and + 1.
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// `rows` rows of D values of T from `src` (rows `ts` apart) into fp32
// shared memory rows of `ld`.
template <typename T>
__device__ __forceinline__ void stage_f32(float* dst, int ld, const T* src, size_t ts, int rows,
                                          int D) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    dst[r * ld + d] = ddg::to_f32(src[r * ts + d]);
  }
}

// ---------------------------------------------------------------------------
// K20, the forward
// ---------------------------------------------------------------------------

template <int DK>
__global__ void __launch_bounds__(kThreads) fwd_mma(const bf16* __restrict__ q,
                                                    const bf16* __restrict__ k,
                                                    const bf16* __restrict__ v,
                                                    bf16* __restrict__ o, float* __restrict__ lo,
                                                    float* __restrict__ mo, int L, int H, int tq,
                                                    int tk, int tv, int causal, float scale) {
  constexpr int D = 16 * DK, LD = D + 8, NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // Two stages, each a 128-key block of K then of V, [128][LD].
  bf16* stage0 = reinterpret_cast<bf16*>(smem_raw);
  const int r = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int nk = L / kBlock;
  const size_t bL = static_cast<size_t>(b) * L, hD = static_cast<size_t>(h) * D;
  const int row[2] = {r * kBlock + warp * 16 + g, r * kBlock + warp * 16 + g + 8};
  const int c_end = causal ? r + 1 : nk;
  // This lane's row and column offsets (elements) of its ldmatrix rows:
  // non-transposed x4 over two key tiles of 8 (K), transposed x4 over two
  // column tiles of 8 (V).
  const int ld_k = ((lane & 7) + 8 * ((lane >> 4) & 1)) * LD + 8 * ((lane >> 3) & 1);
  const int ld_v = ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * ((lane >> 4) & 1);

  stage_async<D>(stage0, k + bL * tk + hD, tk, kBlock);
  stage_async<D>(stage0 + kBlock * LD, v + bL * tv + hD, tv, kBlock);
  cp_async_commit();
  uint32_t qa[DK][4];
  a_frags<DK>(q + (bL + row[0]) * tq + hD, q + (bL + row[1]) * tq + hD, t, qa);
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_prev[2] = {-INFINITY, -INFINITY}, l_prev[2] = {0.f, 0.f};

  for (int c = 0; c < c_end; ++c) {
    // Copy the next key block while this one is consumed.
    if (c + 1 < c_end) {
      bf16* next = stage0 + ((c + 1) & 1) * 2 * kBlock * LD;
      stage_async<D>(next, k + (bL + (c + 1) * kBlock) * tk + hD, tk, kBlock);
      stage_async<D>(next + kBlock * LD, v + (bL + (c + 1) * kBlock) * tv + hD, tv, kBlock);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Ks = stage0 + (c & 1) * 2 * kBlock * LD;
    const uint32_t ks = smem_addr(Ks) + 2 * ld_k;
    const uint32_t vs = smem_addr(Ks + kBlock * LD) + 2 * ld_v;

    // S = Q K^T for the block's 128 keys: 16 tiles of 8 keys.
    float s[16][4];
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk)
#pragma unroll
      for (int j = 0; j < 16; j += 2) {
        uint32_t b[4];
        ldsm_x4(ks + 2 * (8 * j * LD + 16 * kk), b);
        ddg::mma_16816(s[j], qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], b[0], b[1]);
        ddg::mma_16816(s[j + 1], qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], b[2], b[3]);
      }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = c * kBlock + 8 * j + 2 * t + (e & 1);
        float x = __fmul_rn(s[j][e], scale);
        if (causal && key > row[e >> 1]) x = -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2], inv[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) mx[hh] = quad_max(mx[hh]);
    if (nk == 1) {
      // The single-step kernel: p = exp(s - m) / l, then rounded.
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - mx[e >> 1]);
          sum[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        sum[hh] = quad_sum(sum[hh]);
        m_prev[hh] = mx[hh];
        l_prev[hh] = sum[hh];
        corr[hh] = 0.f;
        inv[hh] = 1.f;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = s[j][e] / sum[e >> 1];
    } else {
      float mn[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) mn[hh] = fmaxf(m_prev[hh], mx[hh]);
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - mn[e >> 1]);
          sum[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float l_corr = __fmul_rn(expf(m_prev[hh] - mn[hh]), l_prev[hh]);
        const float l_next = quad_sum(sum[hh]) + l_corr;
        inv[hh] = l_next == 0.f ? 1.f : 1.f / l_next;
        corr[hh] = __fmul_rn(l_corr, inv[hh]);
        m_prev[hh] = mn[hh];
        l_prev[hh] = l_next;
      }
    }

    // o_c = round(P) V over the block's 128 keys, 16 a k-step.
    float oc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) oc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t a[4];
      acc_to_a(s[2 * kk], s[2 * kk + 1], a);
#pragma unroll
      for (int jd = 0; jd < NT; jd += 2) {
        uint32_t bv[4];
        ldsm_x4_t(vs + 2 * (16 * kk * LD + 8 * jd), bv);
        ddg::mma_16816(oc[jd], a[0], a[1], a[2], a[3], bv[0], bv[1]);
        ddg::mma_16816(oc[jd + 1], a[0], a[1], a[2], a[3], bv[2], bv[3]);
      }
    }
#pragma unroll
    for (int jd = 0; jd < NT; ++jd)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[jd][e] = __fadd_rn(__fmul_rn(acc[jd][e], corr[e >> 1]),
                               __fmul_rn(oc[jd][e], inv[e >> 1]));
    __syncthreads();   // the stage is refilled next
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    bf16* orow = o + ((bL + row[hh]) * H + h) * D;
#pragma unroll
    for (int jd = 0; jd < NT; ++jd)
      *reinterpret_cast<uint32_t*>(orow + 8 * jd + 2 * t) =
          ddg::pack_bf16(acc[jd][2 * hh], acc[jd][2 * hh + 1]);
    if (t == 0) {
      const size_t i = (static_cast<size_t>(b) * H + h) * L + row[hh];
      lo[i] = l_prev[hh];
      mo[i] = m_prev[hh];
    }
  }
}

// DC = columns a lane owns (D <= 32 DC).
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads) fwd_core(const T* __restrict__ q,
                                                     const T* __restrict__ k,
                                                     const T* __restrict__ v,
                                                     T* __restrict__ o, float* __restrict__ lo,
                                                     float* __restrict__ mo, int L, int H, int D,
                                                     int tq, int tk, int tv, int causal,
                                                     float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* Qs = smem;               // [32][ld]
  float* Xs = Qs + kTile * ld;    // [32][ld]: a sub-tile of K, then of V
  float* Ss = Xs + kTile * ld;    // [32][128]: the block's scores, then p
  const int row0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = row0 / kBlock, nk = L / kBlock;
  const size_t bL = static_cast<size_t>(b) * L, hD = static_cast<size_t>(h) * D;
  stage_f32(Qs, ld, q + (bL + row0) * tq + hD, tq, kTile, D);

  float acc[kRows][DC], oc[kRows][DC];
  float m_prev[kRows], l_prev[kRows], corr[kRows], inv[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m_prev[i] = -INFINITY;
    l_prev[i] = 0.f;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) acc[i][cc] = 0.f;
  }
  const int c_end = causal ? r + 1 : nk;
  for (int c = 0; c < c_end; ++c) {
    for (int st = 0; st < kBlock / kTile; ++st) {
      const int key0 = c * kBlock + st * kTile;
      __syncthreads();
      stage_f32(Xs, ld, k + (bL + key0) * tk + hD, tk, kTile, D);
      __syncthreads();
      float s[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) s[i] = 0.f;
      const float* kr = Xs + lane * ld;
      for (int d = 0; d < D; ++d) {
        const float kv = kr[d];
#pragma unroll
        for (int i = 0; i < kRows; ++i) s[i] = fmaf(Qs[(warp * kRows + i) * ld + d], kv, s[i]);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        float x = __fmul_rn(s[i], scale);
        if (causal && key0 + lane > row0 + warp * kRows + i) x = -INFINITY;
        Ss[(warp * kRows + i) * kBlock + st * kTile + lane] = x;
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float* srow = Ss + (warp * kRows + i) * kBlock;
      float x[kBlock / 32], mx = -INFINITY, sum = 0.f;
#pragma unroll
      for (int j = 0; j < kBlock / 32; ++j) {
        x[j] = srow[lane + 32 * j];
        mx = fmaxf(mx, x[j]);
      }
      mx = ddg::warp_max(mx);
      const float mn = nk == 1 ? mx : fmaxf(m_prev[i], mx);
#pragma unroll
      for (int j = 0; j < kBlock / 32; ++j) {
        x[j] = expf(x[j] - mn);
        sum += x[j];
      }
      sum = ddg::warp_sum(sum);
      if (nk == 1) {
        // The single-step kernel: p = exp(s - m) / l, then rounded.
#pragma unroll
        for (int j = 0; j < kBlock / 32; ++j) x[j] = x[j] / sum;
        l_prev[i] = sum;
        corr[i] = 0.f;
        inv[i] = 1.f;
      } else {
        const float l_corr = __fmul_rn(expf(m_prev[i] - mn), l_prev[i]);
        const float l_next = sum + l_corr;
        inv[i] = l_next == 0.f ? 1.f : 1.f / l_next;
        corr[i] = __fmul_rn(l_corr, inv[i]);
        l_prev[i] = l_next;
      }
      m_prev[i] = mn;
#pragma unroll
      for (int j = 0; j < kBlock / 32; ++j) srow[lane + 32 * j] = ddg::round_to<T>(x[j]);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) oc[i][cc] = 0.f;
    for (int st = 0; st < kBlock / kTile; ++st) {
      __syncthreads();
      stage_f32(Xs, ld, v + (bL + c * kBlock + st * kTile) * tv + hD, tv, kTile, D);
      __syncthreads();
      for (int j = 0; j < kTile; ++j) {
        float vv[DC];
#pragma unroll
        for (int cc = 0; cc < DC; ++cc) {
          const int d = lane + 32 * cc;
          vv[cc] = d < D ? Xs[j * ld + d] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float p = Ss[(warp * kRows + i) * kBlock + st * kTile + j];
#pragma unroll
          for (int cc = 0; cc < DC; ++cc) oc[i][cc] = fmaf(p, vv[cc], oc[i][cc]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int cc = 0; cc < DC; ++cc)
        acc[i][cc] = __fadd_rn(__fmul_rn(acc[i][cc], corr[i]), __fmul_rn(oc[i][cc], inv[i]));
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int rw = row0 + warp * kRows + i;
    T* orow = o + ((bL + rw) * H + h) * D;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) {
      const int d = lane + 32 * cc;
      if (d < D) orow[d] = ddg::from_f32<T>(acc[i][cc]);
    }
    if (lane == 0) {
      const size_t ix = (static_cast<size_t>(b) * H + h) * L + rw;
      lo[ix] = l_prev[i];
      mo[ix] = m_prev[i];
    }
  }
}

// ---------------------------------------------------------------------------
// K21, dK and dV
// ---------------------------------------------------------------------------

// m, 1 / l and di of the kSub query rows from q0 into st ([3][kSub]), by
// the block's first kSub threads.
__device__ __forceinline__ void stage_stats(float* st, const float* mg, const float* lg,
                                            const float* dig, size_t at) {
  if (threadIdx.x < kSub) {
    st[threadIdx.x] = mg[at + threadIdx.x];
    st[kSub + threadIdx.x] = 1.f / lg[at + threadIdx.x];
    st[2 * kSub + threadIdx.x] = dig[at + threadIdx.x];
  }
}

template <int DK>
__global__ void __launch_bounds__(kThreads) dkv_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ lg, const float* __restrict__ mg, const bf16* __restrict__ dO,
    const float* __restrict__ dig, bf16* __restrict__ dk, bf16* __restrict__ dv, int L, int H,
    int tq, int tk, int tv, int causal, float scale) {
  constexpr int D = 16 * DK, LD = D + 8, NT = D / 8;
  constexpr int kStage = 2 * kSub * LD;   // bf16: a sub-tile of q, then of do
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* stage0 = reinterpret_cast<bf16*>(smem_raw);               // two stages
  float* st0 = reinterpret_cast<float*>(stage0 + 2 * kStage);     // two [3][kSub]
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int nq = L / kBlock;
  const size_t bL = static_cast<size_t>(b) * L, hD = static_cast<size_t>(h) * D;
  const size_t stats = (static_cast<size_t>(b) * H + h) * L;
  const size_t to = static_cast<size_t>(H) * D;
  const int key[2] = {c * kBlock + warp * 16 + g, c * kBlock + warp * 16 + g + 8};
  const int ld_n = ((lane & 7) + 8 * ((lane >> 4) & 1)) * LD + 8 * ((lane >> 3) & 1);
  const int ld_t = ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * ((lane >> 4) & 1);
  // The query rows, kSub at a time, from the first block at or below the
  // diagonal under `causal`.
  const int q_begin = (causal ? c : 0) * kBlock;
  const int n_sub = (L - q_begin) / kSub;

  stage_async<D>(stage0, q + (bL + q_begin) * tq + hD, tq, kSub);
  stage_async<D>(stage0 + kSub * LD, dO + (bL + q_begin) * to + hD, to, kSub);
  cp_async_commit();
  stage_stats(st0, mg, lg, dig, stats + q_begin);
  uint32_t ka[DK][4], va[DK][4];
  a_frags<DK>(k + (bL + key[0]) * tk + hD, k + (bL + key[1]) * tk + hD, t, ka);
  a_frags<DK>(v + (bL + key[0]) * tv + hD, v + (bL + key[1]) * tv + hD, t, va);
  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int it = 0; it < n_sub; ++it) {
    const int q0 = q_begin + it * kSub;
    if (it + 1 < n_sub) {
      bf16* next = stage0 + ((it + 1) & 1) * kStage;
      stage_async<D>(next, q + (bL + q0 + kSub) * tq + hD, tq, kSub);
      stage_async<D>(next + kSub * LD, dO + (bL + q0 + kSub) * to + hD, to, kSub);
    }
    cp_async_commit();
    if (it + 1 < n_sub) stage_stats(st0 + ((it + 1) & 1) * 3 * kSub, mg, lg, dig, stats + q0 + kSub);
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Qs = stage0 + (it & 1) * kStage;
    const float* st = st0 + (it & 1) * 3 * kSub;
    const uint32_t qs = smem_addr(Qs), os = smem_addr(Qs + kSub * LD);

    // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys x kSub queries.
    float sT[kSub / 8][4], dpT[kSub / 8][4];
#pragma unroll
    for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk)
#pragma unroll
      for (int j = 0; j < kSub / 8; j += 2) {
        uint32_t bq[4], bo[4];
        ldsm_x4(qs + 2 * (ld_n + 8 * j * LD + 16 * kk), bq);
        ddg::mma_16816(sT[j], ka[kk][0], ka[kk][1], ka[kk][2], ka[kk][3], bq[0], bq[1]);
        ddg::mma_16816(sT[j + 1], ka[kk][0], ka[kk][1], ka[kk][2], ka[kk][3], bq[2], bq[3]);
        ldsm_x4(os + 2 * (ld_n + 8 * j * LD + 16 * kk), bo);
        ddg::mma_16816(dpT[j], va[kk][0], va[kk][1], va[kk][2], va[kk][3], bo[0], bo[1]);
        ddg::mma_16816(dpT[j + 1], va[kk][0], va[kk][1], va[kk][2], va[kk][3], bo[2], bo[3]);
      }
#pragma unroll
    for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * j + 2 * t + (e & 1);
        float p = 0.f, ds = 0.f;
        if (!(causal && key[e >> 1] > q0 + qc)) {
          p = expf(__fmul_rn(sT[j][e], scale) - st[qc]) * st[kSub + qc];
          ds = __fmul_rn(__fmul_rn(dpT[j][e] - st[2 * kSub + qc], p), scale);
        }
        sT[j][e] = p;
        dpT[j][e] = ds;
      }
    // dV += round(P^T) dO, dK += round(dS^T) Q, 16 queries a k-step.
#pragma unroll
    for (int kq = 0; kq < kSub / 16; ++kq) {
      uint32_t pa[4], da[4];
      acc_to_a(sT[2 * kq], sT[2 * kq + 1], pa);
      acc_to_a(dpT[2 * kq], dpT[2 * kq + 1], da);
#pragma unroll
      for (int jd = 0; jd < NT; jd += 2) {
        uint32_t bo[4], bq[4];
        ldsm_x4_t(os + 2 * (ld_t + 16 * kq * LD + 8 * jd), bo);
        ddg::mma_16816(dva[jd], pa[0], pa[1], pa[2], pa[3], bo[0], bo[1]);
        ddg::mma_16816(dva[jd + 1], pa[0], pa[1], pa[2], pa[3], bo[2], bo[3]);
        ldsm_x4_t(qs + 2 * (ld_t + 16 * kq * LD + 8 * jd), bq);
        ddg::mma_16816(dka[jd], da[0], da[1], da[2], da[3], bq[0], bq[1]);
        ddg::mma_16816(dka[jd + 1], da[0], da[1], da[2], da[3], bq[2], bq[3]);
      }
    }
    __syncthreads();   // the stage is refilled next
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const size_t at = ((bL + key[hh]) * H + h) * D;
#pragma unroll
    for (int jd = 0; jd < NT; ++jd) {
      *reinterpret_cast<uint32_t*>(dk + at + 8 * jd + 2 * t) =
          ddg::pack_bf16(dka[jd][2 * hh], dka[jd][2 * hh + 1]);
      *reinterpret_cast<uint32_t*>(dv + at + 8 * jd + 2 * t) =
          ddg::pack_bf16(dva[jd][2 * hh], dva[jd][2 * hh + 1]);
    }
  }
}

template <typename T, int DC>
__global__ void __launch_bounds__(kThreads) dkv_core(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ lg, const float* __restrict__ mg, const T* __restrict__ dO,
    const float* __restrict__ dig, T* __restrict__ dk, T* __restrict__ dv, int L, int H, int D,
    int tq, int tk, int tv, int causal, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* Ks = smem;                 // [32][ld]: the block's keys
  float* Vs = Ks + kTile * ld;      // [32][ld]
  float* Qs = Vs + kTile * ld;      // [32][ld]: a query sub-tile
  float* Os = Qs + kTile * ld;      // [32][ld]: its dO
  float* Ps = Os + kTile * ld;      // [32 keys][33]: round(p)^T
  float* Ds = Ps + kTile * 33;      // [32 keys][33]: round(ds)^T
  float* st = Ds + kTile * 33;      // m, 1 / l, di of the 32 queries
  const int key0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = key0 / kBlock, nq = L / kBlock;
  const size_t bL = static_cast<size_t>(b) * L, hD = static_cast<size_t>(h) * D;
  const size_t stats = (static_cast<size_t>(b) * H + h) * L;
  stage_f32(Ks, ld, k + (bL + key0) * tk + hD, tk, kTile, D);
  stage_f32(Vs, ld, v + (bL + key0) * tv + hD, tv, kTile, D);

  float dka[kRows][DC], dva[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) dka[i][cc] = dva[i][cc] = 0.f;

  for (int r = causal ? c : 0; r < nq; ++r)
    for (int sub = 0; sub < kBlock / kTile; ++sub) {
      const int q0 = r * kBlock + sub * kTile;
      __syncthreads();
      stage_f32(Qs, ld, q + (bL + q0) * tq + hD, tq, kTile, D);
      stage_f32(Os, ld, dO + (bL + q0) * H * D + hD, static_cast<size_t>(H) * D, kTile, D);
      if (threadIdx.x < kTile) {
        st[threadIdx.x] = mg[stats + q0 + threadIdx.x];
        st[kTile + threadIdx.x] = 1.f / lg[stats + q0 + threadIdx.x];
        st[2 * kTile + threadIdx.x] = dig[stats + q0 + threadIdx.x];
      }
      __syncthreads();
      // Lane j: query q0 + j against the warp's 4 keys.
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int kl = warp * kRows + i;
        const float* qr = Qs + lane * ld;
        const float* orow = Os + lane * ld;
        const float* kr = Ks + kl * ld;
        const float* vr = Vs + kl * ld;
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < D; ++d) {
          s = fmaf(qr[d], kr[d], s);
          dp = fmaf(orow[d], vr[d], dp);
        }
        float p = 0.f, ds = 0.f;
        if (!(causal && key0 + kl > q0 + lane)) {
          p = expf(__fmul_rn(s, scale) - st[lane]) * st[kTile + lane];
          ds = __fmul_rn(__fmul_rn(dp - st[2 * kTile + lane], p), scale);
        }
        Ps[kl * 33 + lane] = ddg::round_to<T>(p);
        Ds[kl * 33 + lane] = ddg::round_to<T>(ds);
      }
      __syncwarp();
      for (int j = 0; j < kTile; ++j) {
        float qv[DC], ov[DC];
#pragma unroll
        for (int cc = 0; cc < DC; ++cc) {
          const int d = lane + 32 * cc;
          qv[cc] = d < D ? Qs[j * ld + d] : 0.f;
          ov[cc] = d < D ? Os[j * ld + d] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float p = Ps[(warp * kRows + i) * 33 + j];
          const float ds = Ds[(warp * kRows + i) * 33 + j];
#pragma unroll
          for (int cc = 0; cc < DC; ++cc) {
            dva[i][cc] = fmaf(p, ov[cc], dva[i][cc]);
            dka[i][cc] = fmaf(ds, qv[cc], dka[i][cc]);
          }
        }
      }
    }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const size_t at = ((bL + key0 + warp * kRows + i) * H + h) * D;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) {
      const int d = lane + 32 * cc;
      if (d < D) {
        dk[at + d] = ddg::from_f32<T>(dka[i][cc]);
        dv[at + d] = ddg::from_f32<T>(dva[i][cc]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K22, dQ
// ---------------------------------------------------------------------------

template <int DK>
__global__ void __launch_bounds__(kThreads) dq_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ lg, const float* __restrict__ mg, const bf16* __restrict__ dO,
    const float* __restrict__ dig, bf16* __restrict__ dq, int L, int H, int tq, int tk, int tv,
    int causal, float scale) {
  constexpr int D = 16 * DK, LD = D + 8, NT = D / 8;
  constexpr int kStage = 2 * kSub * LD;   // bf16: a sub-tile of k, then of v
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* stage0 = reinterpret_cast<bf16*>(smem_raw);   // two stages
  const int r = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int nk = L / kBlock;
  const size_t bL = static_cast<size_t>(b) * L, hD = static_cast<size_t>(h) * D;
  const size_t stats = (static_cast<size_t>(b) * H + h) * L;
  const int row[2] = {r * kBlock + warp * 16 + g, r * kBlock + warp * 16 + g + 8};
  const size_t to = static_cast<size_t>(H) * D;
  const int ld_n = ((lane & 7) + 8 * ((lane >> 4) & 1)) * LD + 8 * ((lane >> 3) & 1);
  const int ld_t = ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * ((lane >> 4) & 1);
  // The key rows, kSub at a time, up to the diagonal block under `causal`.
  const int n_sub = (causal ? r + 1 : nk) * (kBlock / kSub);

  stage_async<D>(stage0, k + bL * tk + hD, tk, kSub);
  stage_async<D>(stage0 + kSub * LD, v + bL * tv + hD, tv, kSub);
  cp_async_commit();
  uint32_t qa[DK][4], oa[DK][4];
  a_frags<DK>(q + (bL + row[0]) * tq + hD, q + (bL + row[1]) * tq + hD, t, qa);
  a_frags<DK>(dO + (bL + row[0]) * to + hD, dO + (bL + row[1]) * to + hD, t, oa);
  float m[2], il[2], di[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    m[hh] = mg[stats + row[hh]];
    il[hh] = 1.f / lg[stats + row[hh]];
    di[hh] = dig[stats + row[hh]];
  }
  float dqa[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[j][e] = 0.f;

  for (int it = 0; it < n_sub; ++it) {
    const int key0 = it * kSub;
    if (it + 1 < n_sub) {
      bf16* next = stage0 + ((it + 1) & 1) * kStage;
      stage_async<D>(next, k + (bL + key0 + kSub) * tk + hD, tk, kSub);
      stage_async<D>(next + kSub * LD, v + (bL + key0 + kSub) * tv + hD, tv, kSub);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Ks = stage0 + (it & 1) * kStage;
    const uint32_t ks = smem_addr(Ks), vs = smem_addr(Ks + kSub * LD);
    float s[kSub / 8][4], dp[kSub / 8][4];
#pragma unroll
    for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk)
#pragma unroll
      for (int j = 0; j < kSub / 8; j += 2) {
        uint32_t bk[4], bv[4];
        ldsm_x4(ks + 2 * (ld_n + 8 * j * LD + 16 * kk), bk);
        ddg::mma_16816(s[j], qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], bk[0], bk[1]);
        ddg::mma_16816(s[j + 1], qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], bk[2], bk[3]);
        ldsm_x4(vs + 2 * (ld_n + 8 * j * LD + 16 * kk), bv);
        ddg::mma_16816(dp[j], oa[kk][0], oa[kk][1], oa[kk][2], oa[kk][3], bv[0], bv[1]);
        ddg::mma_16816(dp[j + 1], oa[kk][0], oa[kk][1], oa[kk][2], oa[kk][3], bv[2], bv[3]);
      }
#pragma unroll
    for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        float ds = 0.f;
        if (!(causal && key0 + 8 * j + 2 * t + (e & 1) > row[hh])) {
          const float p = expf(__fmul_rn(s[j][e], scale) - m[hh]) * il[hh];
          ds = __fmul_rn(__fmul_rn(dp[j][e] - di[hh], p), scale);
        }
        s[j][e] = ds;
      }
    // dQ += round(dS) K, 16 keys a k-step.
#pragma unroll
    for (int kk = 0; kk < kSub / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(s[2 * kk], s[2 * kk + 1], a);
#pragma unroll
      for (int jd = 0; jd < NT; jd += 2) {
        uint32_t bk[4];
        ldsm_x4_t(ks + 2 * (ld_t + 16 * kk * LD + 8 * jd), bk);
        ddg::mma_16816(dqa[jd], a[0], a[1], a[2], a[3], bk[0], bk[1]);
        ddg::mma_16816(dqa[jd + 1], a[0], a[1], a[2], a[3], bk[2], bk[3]);
      }
    }
    __syncthreads();   // the stage is refilled next
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    bf16* out = dq + ((bL + row[hh]) * H + h) * D;
#pragma unroll
    for (int jd = 0; jd < NT; ++jd)
      *reinterpret_cast<uint32_t*>(out + 8 * jd + 2 * t) =
          ddg::pack_bf16(dqa[jd][2 * hh], dqa[jd][2 * hh + 1]);
  }
}

template <typename T, int DC>
__global__ void __launch_bounds__(kThreads) dq_core(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ lg, const float* __restrict__ mg, const T* __restrict__ dO,
    const float* __restrict__ dig, T* __restrict__ dq, int L, int H, int D, int tq, int tk,
    int tv, int causal, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* Qs = smem;               // [32][ld]: the block's rows
  float* Os = Qs + kTile * ld;    // [32][ld]: their dO
  float* Ks = Os + kTile * ld;    // [32][ld]: a key sub-tile
  float* Vs = Ks + kTile * ld;    // [32][ld]
  float* Ds = Vs + kTile * ld;    // [32 rows][33]: round(ds)
  const int row0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = row0 / kBlock, nk = L / kBlock;
  const size_t bL = static_cast<size_t>(b) * L, hD = static_cast<size_t>(h) * D;
  const size_t stats = (static_cast<size_t>(b) * H + h) * L;
  stage_f32(Qs, ld, q + (bL + row0) * tq + hD, tq, kTile, D);
  stage_f32(Os, ld, dO + (bL + row0) * H * D + hD, static_cast<size_t>(H) * D, kTile, D);
  float m[kRows], il[kRows], di[kRows], dqa[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const size_t ix = stats + row0 + warp * kRows + i;
    m[i] = mg[ix];
    il[i] = 1.f / lg[ix];
    di[i] = dig[ix];
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) dqa[i][cc] = 0.f;
  }

  const int c_end = causal ? r + 1 : nk;
  for (int c = 0; c < c_end; ++c)
    for (int sub = 0; sub < kBlock / kTile; ++sub) {
      const int key0 = c * kBlock + sub * kTile;
      __syncthreads();
      stage_f32(Ks, ld, k + (bL + key0) * tk + hD, tk, kTile, D);
      stage_f32(Vs, ld, v + (bL + key0) * tv + hD, tv, kTile, D);
      __syncthreads();
      // Lane j: key key0 + j against the warp's 4 rows.
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int rl = warp * kRows + i;
        const float* qr = Qs + rl * ld;
        const float* orow = Os + rl * ld;
        const float* kr = Ks + lane * ld;
        const float* vr = Vs + lane * ld;
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < D; ++d) {
          s = fmaf(qr[d], kr[d], s);
          dp = fmaf(orow[d], vr[d], dp);
        }
        float ds = 0.f;
        if (!(causal && key0 + lane > row0 + rl)) {
          const float p = expf(__fmul_rn(s, scale) - m[i]) * il[i];
          ds = __fmul_rn(__fmul_rn(dp - di[i], p), scale);
        }
        Ds[rl * 33 + lane] = ddg::round_to<T>(ds);
      }
      __syncwarp();
      for (int j = 0; j < kTile; ++j) {
        float kv[DC];
#pragma unroll
        for (int cc = 0; cc < DC; ++cc) {
          const int d = lane + 32 * cc;
          kv[cc] = d < D ? Ks[j * ld + d] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float ds = Ds[(warp * kRows + i) * 33 + j];
#pragma unroll
          for (int cc = 0; cc < DC; ++cc) dqa[i][cc] = fmaf(ds, kv[cc], dqa[i][cc]);
        }
      }
    }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    T* out = dq + ((bL + row0 + warp * kRows + i) * H + h) * D;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) {
      const int d = lane + 32 * cc;
      if (d < D) out[d] = ddg::from_f32<T>(dqa[i][cc]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// What the library takes at 128-blocks, and the kernels' own limits.
bool takes(int B, int L, int H, int D, int tq, int tk, int tv) {
  if (B <= 0 || H <= 0 || B > 65535 || H > 65535 || D <= 0 || D > kDMax) return false;
  if (L < kBlock || L % kBlock || (L > kBlock && D > kBlock && D % kBlock)) return false;
  return tq >= H * D && tk >= H * D && tv >= H * D;
}

template <typename T>
bool use_mma(int D, int tq, int tk, int tv, std::initializer_list<const void*> ptrs) {
  if (!std::is_same<T, bf16>::value || D % 16 || D > kMmaDMax || tq % 8 || tk % 8 || tv % 8)
    return false;
  for (const void* p : ptrs)
    if (!aligned16(p)) return false;
  return true;
}

int col_groups(int D) { return D <= 32 ? 1 : D <= 64 ? 2 : D <= 128 ? 4 : 8; }

template <typename K>
int prepare(K kernel, size_t smem) {
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The launch body for each instantiated head width (variadic: the body
// holds commas).
#define DDG_FLASH_CORE_SWITCH(D, ...)            \
  switch (col_groups(D)) {                       \
    case 1: { constexpr int DC = 1; __VA_ARGS__ } \
    case 2: { constexpr int DC = 2; __VA_ARGS__ } \
    case 4: { constexpr int DC = 4; __VA_ARGS__ } \
    default: { constexpr int DC = 8; __VA_ARGS__ } \
  }

#define DDG_FLASH_MMA_SWITCH(D, ...)             \
  switch (D / 16) {                              \
    case 1: { constexpr int DK = 1; __VA_ARGS__ } \
    case 2: { constexpr int DK = 2; __VA_ARGS__ } \
    case 3: { constexpr int DK = 3; __VA_ARGS__ } \
    default: { constexpr int DK = 4; __VA_ARGS__ } \
  }

template <typename T>
int fwd(const void* q, const void* k, const void* v, void* o, void* l, void* m, int B, int L,
        int H, int D, int tq, int tk, int tv, int causal, float scale, cudaStream_t s,
        int* path) {
  if (!takes(B, L, H, D, tq, tk, tv)) return cudaErrorInvalidValue;
  const bool tc = use_mma<T>(D, tq, tk, tv, {q, k, v, o});
  *path = tc;
  const T* tq_ = static_cast<const T*>(q);
  const T* tk_ = static_cast<const T*>(k);
  const T* tv_ = static_cast<const T*>(v);
  float* lp = static_cast<float*>(l);
  float* mp = static_cast<float*>(m);
  if (tc) {
    const dim3 grid(L / kBlock, H, B);
    const size_t smem = 4 * kBlock * (D + 8) * sizeof(bf16);   // two stages of K and V
    DDG_FLASH_MMA_SWITCH(D, {
      auto kern = fwd_mma<DK>;
      const int err = prepare(kern, smem);
      if (err != cudaSuccess) return err;
      kern<<<grid, kThreads, smem, s>>>(
          reinterpret_cast<const bf16*>(tq_), reinterpret_cast<const bf16*>(tk_),
          reinterpret_cast<const bf16*>(tv_), static_cast<bf16*>(o), lp, mp, L, H, tq, tk, tv,
          causal, scale);
      return cudaGetLastError();
    })
  }
  const dim3 grid(L / kTile, H, B);
  const size_t smem = sizeof(float) * (2 * kTile * (D + 1) + kTile * kBlock);
  DDG_FLASH_CORE_SWITCH(D, {
    auto kern = fwd_core<T, DC>;
    const int err = prepare(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, kThreads, smem, s>>>(tq_, tk_, tv_, static_cast<T*>(o), lp, mp, L, H, D, tq,
                                      tk, tv, causal, scale);
    return cudaGetLastError();
  })
}

template <typename T>
int bwd_dkv(const void* q, const void* k, const void* v, const void* l, const void* m,
            const void* dO, const void* di, void* dk, void* dv, int B, int L, int H, int D,
            int tq, int tk, int tv, int causal, float scale, cudaStream_t s, int* path) {
  if (!takes(B, L, H, D, tq, tk, tv)) return cudaErrorInvalidValue;
  const bool tc = use_mma<T>(D, tq, tk, tv, {q, k, v, dO, dk, dv});
  *path = tc;
  const float* lp = static_cast<const float*>(l);
  const float* mp = static_cast<const float*>(m);
  const float* dp = static_cast<const float*>(di);
  if (tc) {
    const dim3 grid(L / kBlock, H, B);
    const size_t smem = 2 * (2 * kSub * (D + 8) * sizeof(bf16) + 3 * kSub * sizeof(float));
    DDG_FLASH_MMA_SWITCH(D, {
      auto kern = dkv_mma<DK>;
      const int err = prepare(kern, smem);
      if (err != cudaSuccess) return err;
      kern<<<grid, kThreads, smem, s>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), lp, mp, static_cast<const bf16*>(dO), dp,
          static_cast<bf16*>(dk), static_cast<bf16*>(dv), L, H, tq, tk, tv, causal, scale);
      return cudaGetLastError();
    })
  }
  const dim3 grid(L / kTile, H, B);
  const size_t smem = sizeof(float) * (4 * kTile * (D + 1) + 2 * kTile * 33 + 3 * kTile);
  DDG_FLASH_CORE_SWITCH(D, {
    auto kern = dkv_core<T, DC>;
    const int err = prepare(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, kThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lp, mp,
        static_cast<const T*>(dO), dp, static_cast<T*>(dk), static_cast<T*>(dv), L, H, D, tq,
        tk, tv, causal, scale);
    return cudaGetLastError();
  })
}

template <typename T>
int bwd_dq(const void* q, const void* k, const void* v, const void* l, const void* m,
           const void* dO, const void* di, void* dq, int B, int L, int H, int D, int tq,
           int tk, int tv, int causal, float scale, cudaStream_t s, int* path) {
  if (!takes(B, L, H, D, tq, tk, tv)) return cudaErrorInvalidValue;
  const bool tc = use_mma<T>(D, tq, tk, tv, {q, k, v, dO, dq});
  *path = tc;
  const float* lp = static_cast<const float*>(l);
  const float* mp = static_cast<const float*>(m);
  const float* dp = static_cast<const float*>(di);
  if (tc) {
    const dim3 grid(L / kBlock, H, B);
    const size_t smem = 4 * kSub * (D + 8) * sizeof(bf16);   // two stages of K and V
    DDG_FLASH_MMA_SWITCH(D, {
      auto kern = dq_mma<DK>;
      const int err = prepare(kern, smem);
      if (err != cudaSuccess) return err;
      kern<<<grid, kThreads, smem, s>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), lp, mp, static_cast<const bf16*>(dO), dp,
          static_cast<bf16*>(dq), L, H, tq, tk, tv, causal, scale);
      return cudaGetLastError();
    })
  }
  const dim3 grid(L / kTile, H, B);
  const size_t smem = sizeof(float) * (4 * kTile * (D + 1) + kTile * 33);
  DDG_FLASH_CORE_SWITCH(D, {
    auto kern = dq_core<T, DC>;
    const int err = prepare(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, kThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lp, mp,
        static_cast<const T*>(dO), dp, static_cast<T*>(dq), L, H, D, tq, tk, tv, causal,
        scale);
    return cudaGetLastError();
  })
}

}  // namespace

// K20. q, k, v: (B, L, H, D) with dense heads, rows tq, tk, tv elements
// apart; o: contiguous (B, L, H, D); l, m: (B, H, L) fp32. *path: 1 on the
// tensor-core kernel, 0 on the CUDA-core one.
extern "C" int ddg_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                       void* l, void* m, int B, int L, int H, int D, int tq,
                                       int tk, int tv, int causal, float scale, int dtype,
                                       void* stream, int* path) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ddg::kF32)
    return fwd<float>(q, k, v, o, l, m, B, L, H, D, tq, tk, tv, causal, scale, s, path);
  if (dtype == ddg::kBF16)
    return fwd<bf16>(q, k, v, o, l, m, B, L, H, D, tq, tk, tv, causal, scale, s, path);
  return cudaErrorInvalidValue;
}

// K21. As K20, with the forward's l and m, do (contiguous, q's dtype) and
// di = sum(o * do) ((B, H, L) fp32); writes dk, dv (contiguous).
extern "C" int ddg_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                           const void* l, const void* m, const void* dO,
                                           const void* di, void* dk, void* dv, int B, int L,
                                           int H, int D, int tq, int tk, int tv, int causal,
                                           float scale, int dtype, void* stream, int* path) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ddg::kF32)
    return bwd_dkv<float>(q, k, v, l, m, dO, di, dk, dv, B, L, H, D, tq, tk, tv, causal, scale,
                          s, path);
  if (dtype == ddg::kBF16)
    return bwd_dkv<bf16>(q, k, v, l, m, dO, di, dk, dv, B, L, H, D, tq, tk, tv, causal, scale,
                         s, path);
  return cudaErrorInvalidValue;
}

// K22. As K21; writes dq (contiguous).
extern "C" int ddg_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                          const void* l, const void* m, const void* dO,
                                          const void* di, void* dq, int B, int L, int H, int D,
                                          int tq, int tk, int tv, int causal, float scale,
                                          int dtype, void* stream, int* path) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ddg::kF32)
    return bwd_dq<float>(q, k, v, l, m, dO, di, dq, B, L, H, D, tq, tk, tv, causal, scale, s,
                         path);
  if (dtype == ddg::kBF16)
    return bwd_dq<bf16>(q, k, v, l, m, dO, di, dq, B, L, H, D, tq, tk, tv, causal, scale, s,
                        path);
  return cudaErrorInvalidValue;
}
