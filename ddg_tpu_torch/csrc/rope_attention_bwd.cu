// Softmax attention for the DiT's sequences, backward, on the token-major
// layout: K1b (with RoPE) and K2's backward (without).
//
// Replaces the backwards of ddg_tpu/ops/attention_pallas.py's two TPU
// kernels: _rope_flash_bwd (:233-248, for fused_rope_attention) and
// _flash_bwd (:101-115, for short_seq_attention). Both are plain-jnp
// recomputes whose VJPs, through _rope_reference (:190-203) and
// _reference (:63-75), round where these kernels round. For each (b, h),
// from the saved q, k, v and the output gradient dO, all (B, L, H, D):
//   q' = RoPE(q), k' = RoPE(k)     K1b only: fp32, rounded to the input dtype
//   P  = softmax(q' k'^T / sqrt(D)) fp32 (causal: keys j > i masked)
//   dV = round(P)^T dO             round(P) = P in v's dtype, fp32 sums
//   dP = dO V^T                    rounded to the input dtype
//   dS = P dP - P delta            delta = sum_j P dP (as the VJP of softmax)
//   dq' = (dS / sqrt(D)) k',  dk' = (dS / sqrt(D))^T q'   rounded to the input dtype
//   dq = RoPE^T(dq'), dk = RoPE^T(dk')   K1b only: (x1, x2) <- (g1 c + g2 s, g2 c - g1 s),
//                                        rounded again
// delta comes from P and the rounded dP, not from rowsum(dO o O) as in
// FlashAttention: that form moves the rounding point.
//
// Bound on the H100 at text8's training shape (micro-batch B=256, L=256,
// H=12, D=64): 7 B L H D elements moved, 705 MB in bf16, take 0.210 ms at
// 3.35 TB/s; five L x L x D products, 10 B H L^2 D = 128.8 GFLOP, take
// 0.130 ms at the bf16 tensor-core rate. So the function is bound by bytes.
//
// Each call is two launches (K1b on the tensor cores: four, with the
// rotations), in stream order, over tiles of 64 keys and of query rows, so
// any L is taken and nothing held grows with it:
//   kernel Q, query-tile parallel: pass A over the key tiles gives each
//     row's max m and sum l exactly as the forward's pass 1 does (so that P
//     is the forward's P bit for bit), and carries delta online beside l
//     (sum_j exp(S - m_running) round(dP), rescaled as m grows, times 1 / l
//     at the end: no extra product and no statistics saved by the forward);
//     pass B forms P, dP, dS and dq' += dS k' tile by tile. It writes dq
//     and each row's (m, 1/l or l, delta) to a workspace, (B, H, 3, Lp)
//     fp32 with Lp = L rounded up to 64.
//   kernel KV, key-tile parallel: each block owns its keys' dK and dV whole
//     and walks the query tiles in order (q', dO and the workspace rows),
//     forming P^T, dP^T and dS^T from the same formulas: dV += round(P^T)
//     dO, dK += dS^T q'.
// Neither uses atomics: every sum runs in a fixed order (dq over the keys,
// dK and dV over the queries), so reruns are bit-identical. Under `causal`
// kernel Q skips key tiles wholly past its rows and kernel KV query tiles
// wholly before its keys.
//
// * The tensor-core kernels (bf16, D = 64, rows on 16-byte boundaries):
//   attention_bwd_q_wgmma_kernel and attention_bwd_kv_wgmma_kernel, two
//   warpgroups (256 threads) a block of 128 query rows (Q) or 128 keys
//   (KV), a warpgroup's 64 rows being one wgmma M; grids (L / 128, H, B).
//   Tiles are 64 x 64 bf16 in the 128-byte swizzle, copied by cp.async
//   (wgmma.cuh, as the forward). Every product is wgmma m64n64k16 with fp32
//   sums: S = Q K^T and dP = dO V^T (kernel Q), S^T = K Q^T and dP^T = V
//   dO^T (kernel KV) from two K-major tiles in shared memory; dq' += dS K,
//   dV += round(P^T) dO and dK += dS^T Q with A from registers (the S
//   fragments turned into bf16 A fragments, as the forward's P) and B
//   MN-major through the transpose bit. dS enters dq and dk as two bf16
//   terms (split_bf16: the rounded value and the rounded remainder, together
//   dS to about 2^-16 relative; tf32 would keep fewer bits).
//   - Kernel Q keeps the block's two Q and two dO tiles; up to four key
//     tiles (L <= 256) every K and V tile stays in its own slot from pass A
//     to pass B, past that they stream through a two-stage ring (98,304
//     bytes). At most 128 registers (126), so two blocks (16 warps) an SM.
//   - Kernel KV keeps its two K and two V tiles and streams (q', dO, the
//     workspace rows) through a two-stage ring (67,584 bytes); one block an
//     SM (195 registers: dK, dV, S^T, dP^T and the A fragments). It issues
//     dV's products before forming dS^T, so that the two overlap.
//   - P = 2^((S - m) scale log2 e) / l by ex2.approx times 1 / l, the
//     forward's own formula; the scale 1/8 is a power of two, so m is kept
//     on the unscaled scores and scaling commutes exactly.
//   - K1b rotates q and k once, before them (rope_rows_kernel into a
//     (2, B, L, H, 64) workspace), and un-rotates dq' and dk' in place after
//     them: two passes over four tensors (0.8 GB at text8's shape, 0.24 ms
//     at 3.35 TB/s), where rotating tiles inside the kernels, as the
//     forward does, cost twice that (PERF.md, PR 10).
// * The CUDA-core kernels (float32; bf16 rows off 16-byte boundaries; any
//   other even D up to 290, the widest the CUDA-core forward takes):
//   attention_bwd_q_kernel (32 query rows a block, 64-key tiles) and
//   attention_bwd_kv_kernel (64 keys a block, 32-query tiles), 256 threads,
//   the same passes with expf, IEEE division and fp32 products on the CUDA
//   cores (the contract there). Shared memory: (224 D + 4224) floats for Q
//   and (320 D + 2400) for KV, which fits up to D = 174; past that the
//   tiles halve (16 query rows, 32 keys: (112 D + 1088) and (160 D + 688)
//   floats), so every head the forward serves also trains.
// The C functions report in *path which kernels they launched (1: tensor
// cores, 0: CUDA cores); ddg_attention_bwd_plan exports the launch plan,
// which ops/attention.py:backward_plan mirrors.

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using ddg::pack_bf16;

constexpr int kKeyTile = 64;               // keys of a tile (kernel Q), of a block (CUDA-core KV)
constexpr int kSmemMax = 232448;           // dynamic shared memory of a block on the H100

// --- fp32 / any-D path on the CUDA cores ------------------------------------

constexpr int kThreads = 256;
// Tiles: QT query rows and KT keys, 32 and 64 while both kernels' fp32
// tiles fit in shared memory (D <= 174), 16 and 32 past that, up to the
// widest head the CUDA-core forward takes (rope_attention.cu: 290).
constexpr int kCoreDMax = 290;

// Kernel Q: q', dO and the dq' sums (QT x D each), k' and v (KT x (D + 1)
// each, rows padded against bank conflicts), S then dS and the rounded dP
// (QT x KT each).
__host__ __device__ constexpr size_t core_q_smem(int D, int QT, int KT) {
  return sizeof(float) * (3 * static_cast<size_t>(QT) * D +
                          2 * static_cast<size_t>(KT) * (D + 1) + 2 * QT * KT);
}

// Kernel KV: k', v (KT x (D + 1)), the query tile's q', dO (QT x (D + 1)),
// P^T then dS^T (KT x (QT + 1)), the tile's m, l, delta (3 x QT), the dk'
// and dv sums (KT x D each).
__host__ __device__ constexpr size_t core_kv_smem(int D, int QT, int KT) {
  return sizeof(float) * (2 * static_cast<size_t>(KT) * (D + 1) +
                          2 * static_cast<size_t>(QT) * (D + 1) + KT * (QT + 1) + 3 * QT +
                          2 * static_cast<size_t>(KT) * D);
}

// Whether the 32-row, 64-key tiles fit D (else 16 and 32).
__host__ __device__ constexpr bool core_wide_tiles(int D) {
  return core_q_smem(D, 32, 64) <= kSmemMax && core_kv_smem(D, 32, 64) <= kSmemMax;
}

// Element d of row `pos` of q or k as the products take it: rotated and
// rounded to T (kRope; the forward's rope_at) or as it is.
template <typename T, bool kRope>
__device__ __forceinline__ float qk_at(const T* row, int pos, int d, int D, const float* cos,
                                       const float* sin) {
  if constexpr (kRope) {
    const int half = D / 2, f = d < half ? d : d - half;
    const float c = cos[pos * half + f], s = sin[pos * half + f];
    const float x = ddg::to_f32(row[d]);
    const float y = d < half ? __fsub_rn(__fmul_rn(x, c), __fmul_rn(ddg::to_f32(row[d + half]), s))
                             : __fadd_rn(__fmul_rn(x, c), __fmul_rn(ddg::to_f32(row[d - half]), s));
    return ddg::round_to<T>(y);
  } else {
    return ddg::to_f32(row[d]);
  }
}

// Rows [row0, row0 + n) of one head of x (rows ts elements apart) into dst
// (rows `stride` floats apart), as qk_at gives them; rows past L are 0.
template <typename T, bool kRope>
__device__ __forceinline__ void stage_rows(float* dst, int stride, const T* x, int ts, int row0,
                                           int n, int L, int D, const float* cos,
                                           const float* sin) {
  for (int idx = threadIdx.x; idx < n * D; idx += kThreads) {
    const int r = idx / D, d = idx % D, p = row0 + r;
    dst[r * stride + d] =
        p < L ? qk_at<T, kRope>(x + static_cast<size_t>(p) * ts, p, d, D, cos, sin) : 0.f;
  }
}

// Rows [row0, row0 + n) of dq', dk' or dv (fp32 sums, rows `stride` floats
// apart) to out (rows out_stride apart), rounded to T and, under kRope,
// un-rotated and rounded again.
template <typename T, bool kRope>
__device__ __forceinline__ void store_rows(const float* src, int stride, T* out,
                                           size_t out_stride, int row0, int n, int L, int D,
                                           const float* cos, const float* sin) {
  const int half = D / 2;
  for (int idx = threadIdx.x; idx < n * half; idx += kThreads) {
    const int r = idx / half, f = idx % half, p = row0 + r;
    if (p >= L) continue;
    T* row = out + static_cast<size_t>(p) * out_stride;
    const float g1 = ddg::round_to<T>(src[r * stride + f]);
    const float g2 = ddg::round_to<T>(src[r * stride + f + half]);
    if constexpr (kRope) {
      const float c = cos[p * half + f], s = sin[p * half + f];
      row[f] = ddg::from_f32<T>(__fadd_rn(__fmul_rn(g1, c), __fmul_rn(g2, s)));
      row[f + half] = ddg::from_f32<T>(__fsub_rn(__fmul_rn(g2, c), __fmul_rn(g1, s)));
    } else {
      row[f] = ddg::from_f32<T>(g1);
      row[f + half] = ddg::from_f32<T>(g2);
    }
  }
}

__device__ __forceinline__ float ds_of(float p, float dp, float delta, float scale) {
  return __fmul_rn(__fsub_rn(__fmul_rn(p, dp), __fmul_rn(p, delta)), scale);
}

// Kernel Q on the CUDA cores: one block per (QT-row query tile, head,
// batch), walking KT-key tiles. Warp w owns rows w, w + 8, ... for the
// softmax, a lane KT / 32 keys of each.
template <typename T, bool kRope, int QT, int KT>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_q_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const float* __restrict__ cos,
                           const float* __restrict__ sin, const T* __restrict__ dout,
                           T* __restrict__ dq, float* __restrict__ stats, int L, int H, int D,
                           int ts_q, int ts_k, int ts_v, int causal, float scale, int Lp) {
  constexpr int kRowsPerWarp = QT / (kThreads / 32);
  static_assert(KT == 32 || KT == 64, "a lane takes one or two keys of a tile");
  extern __shared__ float smem[];
  const int KS = D + 1;
  float* Qs = smem;                    // QT x D: q'
  float* Os = Qs + QT * D;             // QT x D: dO
  float* Gs = Os + QT * D;             // QT x D: the dq' sums
  float* Ks = Gs + QT * D;             // KT x (D + 1): k'
  float* Vs = Ks + KT * KS;            // KT x (D + 1): v
  float* Ss = Vs + KT * KS;            // QT x KT: S, then dS
  float* Ps = Ss + QT * KT;            // QT x KT: dP, rounded
  const int i0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int out_stride = H * D;
  const T* qh = q + static_cast<size_t>(b) * L * ts_q + static_cast<size_t>(h) * D;
  const T* kh = k + static_cast<size_t>(b) * L * ts_k + static_cast<size_t>(h) * D;
  const T* vh = v + static_cast<size_t>(b) * L * ts_v + static_cast<size_t>(h) * D;
  const size_t head = static_cast<size_t>(b) * L * out_stride + static_cast<size_t>(h) * D;

  stage_rows<T, kRope>(Qs, D, qh, ts_q, i0, QT, L, D, cos, sin);
  stage_rows<T, false>(Os, D, dout + head, out_stride, i0, QT, L, D, cos, sin);
  for (int idx = threadIdx.x; idx < QT * D; idx += kThreads) Gs[idx] = 0.f;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float m[kRowsPerWarp], l[kRowsPerWarp], dl[kRowsPerWarp], delta[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) m[r] = kNeg, l[r] = dl[r] = delta[r] = 0.f;

  const int n_tiles = (L + KT - 1) / KT;
  const int n_keys = causal ? min(n_tiles, (i0 + QT - 1) / KT + 1) : n_tiles;
  for (int pass = 0; pass < 2; ++pass) {
    for (int jt = 0; jt < n_keys; ++jt) {
      const int j0 = jt * KT;
      __syncthreads();  // the previous tile's readers are done
      stage_rows<T, kRope>(Ks, KS, kh, ts_k, j0, KT, L, D, cos, sin);
      stage_rows<T, false>(Vs, KS, vh, ts_v, j0, KT, L, D, cos, sin);
      __syncthreads();
      for (int idx = threadIdx.x; idx < QT * KT; idx += kThreads) {
        const int i = idx / KT, jj = idx % KT, key = j0 + jj;
        const float *qi = Qs + i * D, *oi = Os + i * D;
        const float *kj = Ks + jj * KS, *vj = Vs + jj * KS;
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < D; ++d) {
          s = fmaf(qi[d], kj[d], s);
          dp = fmaf(oi[d], vj[d], dp);
        }
        s *= scale;
        if (key >= L || (causal && key > i0 + i)) s = kNeg;
        Ss[idx] = s;
        Ps[idx] = ddg::round_to<T>(dp);
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        float* s = Ss + (warp + r * (kThreads / 32)) * KT;
        const float* dp = Ps + (warp + r * (kThreads / 32)) * KT;
        const float x0 = s[lane], d0 = dp[lane];
        const float x1 = KT == 64 ? s[lane + 32] : kNeg, d1 = KT == 64 ? dp[lane + 32] : 0.f;
        if (pass == 0) {
          // The forward's pass 1, with delta carried beside l.
          float mn, sum, dsum;
          if constexpr (KT == 64) {
            mn = fmaxf(m[r], ddg::warp_max(fmaxf(x0, x1)));
            const float e0 = expf(x0 - mn), e1 = expf(x1 - mn);
            sum = ddg::warp_sum(e0 + e1);
            dsum = ddg::warp_sum(fmaf(e0, d0, e1 * d1));
          } else {
            mn = fmaxf(m[r], ddg::warp_max(x0));
            const float e0 = expf(x0 - mn);
            sum = ddg::warp_sum(e0);
            dsum = ddg::warp_sum(e0 * d0);
          }
          const float f = expf(m[r] - mn);
          l[r] = l[r] * f + sum;
          dl[r] = dl[r] * f + dsum;
          m[r] = mn;
        } else {
          s[lane] = ds_of(expf(x0 - m[r]) / l[r], d0, delta[r], scale);
          if constexpr (KT == 64) s[lane + 32] = ds_of(expf(x1 - m[r]) / l[r], d1, delta[r], scale);
        }
      }
      if (pass == 0) continue;
      __syncthreads();
      // dq' += dS k' in key order.
      for (int idx = threadIdx.x; idx < QT * D; idx += kThreads) {
        const int i = idx / D, d = idx % D;
        const float* ds = Ss + i * KT;
        float acc = Gs[idx];
        for (int jj = 0; jj < KT; ++jj) acc = fmaf(ds[jj], Ks[jj * KS + d], acc);
        Gs[idx] = acc;
      }
    }
    if (pass == 0) {
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) delta[r] = dl[r] / l[r];
    }
  }
  __syncthreads();
  store_rows<T, kRope>(Gs, D, dq + head, out_stride, i0, QT, L, D, cos, sin);
  if (lane == 0) {
    float* st = stats + (static_cast<size_t>(b) * H + h) * 3 * Lp;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = i0 + warp + r * (kThreads / 32);
      if (row >= L) continue;
      st[row] = m[r];
      st[Lp + row] = l[r];
      st[2 * Lp + row] = delta[r];
    }
  }
}

// Kernel KV on the CUDA cores: one block per (KT-key tile, head, batch),
// walking the QT-row query tiles in order.
template <typename T, bool kRope, int QT, int KT>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const float* __restrict__ cos,
                            const float* __restrict__ sin, const T* __restrict__ dout,
                            T* __restrict__ dk, T* __restrict__ dv,
                            const float* __restrict__ stats, int L, int H, int D, int ts_q,
                            int ts_k, int ts_v, int causal, float scale, int Lp) {
  extern __shared__ float smem[];
  const int RS = D + 1;                // padded row of k', v, q', dO
  constexpr int PS = QT + 1;           // padded row of P^T / dS^T
  constexpr int kPer = KT * QT / kThreads;
  float* Ks = smem;                    // KT x (D + 1): k'
  float* Vs = Ks + KT * RS;            // KT x (D + 1): v
  float* Qs = Vs + KT * RS;            // QT x (D + 1): q' of the query tile
  float* Os = Qs + QT * RS;            // QT x (D + 1): dO of the query tile
  float* Pt = Os + QT * RS;            // KT x (QT + 1): P^T, then dS^T
  float* St = Pt + KT * PS;            // 3 x QT: m, l, delta of the tile's rows
  float* dKs = St + 3 * QT;            // KT x D: the dk' sums
  float* dVs = dKs + KT * D;           // KT x D: the dv sums
  const int j0 = blockIdx.x * KT, h = blockIdx.y, b = blockIdx.z;
  const int out_stride = H * D;
  const T* qh = q + static_cast<size_t>(b) * L * ts_q + static_cast<size_t>(h) * D;
  const T* kh = k + static_cast<size_t>(b) * L * ts_k + static_cast<size_t>(h) * D;
  const T* vh = v + static_cast<size_t>(b) * L * ts_v + static_cast<size_t>(h) * D;
  const size_t head = static_cast<size_t>(b) * L * out_stride + static_cast<size_t>(h) * D;
  const float* st = stats + (static_cast<size_t>(b) * H + h) * 3 * Lp;

  stage_rows<T, kRope>(Ks, RS, kh, ts_k, j0, KT, L, D, cos, sin);
  stage_rows<T, false>(Vs, RS, vh, ts_v, j0, KT, L, D, cos, sin);
  for (int idx = threadIdx.x; idx < KT * D; idx += kThreads) dKs[idx] = dVs[idx] = 0.f;

  const int n_q = (L + QT - 1) / QT;
  for (int it = causal ? j0 / QT : 0; it < n_q; ++it) {
    const int i0 = it * QT;
    __syncthreads();  // the previous tile's readers are done
    stage_rows<T, kRope>(Qs, RS, qh, ts_q, i0, QT, L, D, cos, sin);
    stage_rows<T, false>(Os, RS, dout + head, out_stride, i0, QT, L, D, cos, sin);
    for (int idx = threadIdx.x; idx < 3 * QT; idx += kThreads) {
      const int c = idx / QT, p = i0 + idx % QT;
      St[idx] = p < L ? st[c * Lp + p] : (c == 1 ? 1.f : 0.f);
    }
    __syncthreads();
    // P^T from kernel Q's formulas: S summed over d in the same order.
    for (int idx = threadIdx.x; idx < KT * QT; idx += kThreads) {
      const int jj = idx / QT, ii = idx % QT, key = j0 + jj, row = i0 + ii;
      const float *qi = Qs + ii * RS, *kj = Ks + jj * RS;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qi[d], kj[d], s);
      s *= scale;
      const bool masked = row >= L || key >= L || (causal && key > row);
      Pt[jj * PS + ii] = masked ? 0.f : expf(s - St[ii]) / St[QT + ii];
    }
    __syncthreads();
    // dv += round(P)^T dO in query order.
    for (int idx = threadIdx.x; idx < KT * D; idx += kThreads) {
      const int jj = idx / D, d = idx % D;
      const float* p = Pt + jj * PS;
      float acc = dVs[idx];
      for (int ii = 0; ii < QT; ++ii) acc = fmaf(ddg::round_to<T>(p[ii]), Os[ii * RS + d], acc);
      dVs[idx] = acc;
    }
    // dP^T rounded, dS^T over P^T once dv has read it.
    float ds[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int idx = threadIdx.x + e * kThreads, jj = idx / QT, ii = idx % QT;
      const float *oi = Os + ii * RS, *vj = Vs + jj * RS;
      float dp = 0.f;
      for (int d = 0; d < D; ++d) dp = fmaf(oi[d], vj[d], dp);
      ds[e] = ds_of(Pt[jj * PS + ii], ddg::round_to<T>(dp), St[2 * QT + ii], scale);
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int idx = threadIdx.x + e * kThreads;
      Pt[(idx / QT) * PS + idx % QT] = ds[e];
    }
    __syncthreads();
    // dk' += dS^T q' in query order.
    for (int idx = threadIdx.x; idx < KT * D; idx += kThreads) {
      const int jj = idx / D, d = idx % D;
      const float* g = Pt + jj * PS;
      float acc = dKs[idx];
      for (int ii = 0; ii < QT; ++ii) acc = fmaf(g[ii], Qs[ii * RS + d], acc);
      dKs[idx] = acc;
    }
  }
  __syncthreads();
  store_rows<T, false>(dVs, D, dv + head, out_stride, j0, KT, L, D, cos, sin);
  store_rows<T, kRope>(dKs, D, dk + head, out_stride, j0, KT, L, D, cos, sin);
}

// --- bf16 tensor-core path: wgmma over 64-row tiles --------------------------

constexpr int kGroups = 2;                        // warpgroups of a block
static_assert(kMmaThreads == 128 * kGroups, "one block is kGroups warpgroups");
constexpr int kBlockRows = kTileRows * kGroups;   // query rows (Q) or keys (KV) of a block
constexpr int kStages = 2;                        // the rings' depth
constexpr int kSlots = 4;                         // K and V tiles kept for pass B: L <= 256
constexpr int kStatBytes = 1024;                  // m, 1/l, delta of 64 rows (768 bytes), padded
// Kernel Q: Q tiles 0-1, dO tiles 2-3, K slots 4-7, V slots 8-11.
constexpr size_t kQSmem = static_cast<size_t>(kTileBytes) * (2 * kGroups + 2 * kSlots);
// Kernel KV: K tiles 0-1, V tiles 2-3, then kStages stages of (Q tile, dO
// tile, workspace rows), each stage 1024-aligned.
constexpr int kKvStage = 2 * kTileBytes + kStatBytes;
static_assert(kKvStage % kSwizzleAlign == 0, "stages keep the tiles 1024-aligned");
constexpr size_t kKvSmem = static_cast<size_t>(kTileBytes) * 2 * kGroups + kStages * kKvStage;

// (a, b) as two bf16 pairs whose sum is (a, b) to about 2^-16 relative: the
// rounded pair and the rounded remainder.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// d1 = A1 B1^T and d2 = A2 B2^T (64 x 64 over the head dim, all four tiles
// K-major in shared memory): one commit group, one wait.
__device__ __forceinline__ void two_products(float (&d1)[32], uint32_t a1, uint32_t b1,
                                             float (&d2)[32], uint32_t a2, uint32_t b2) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d1[i] = d2[i] = 0.f;
  fence_regs(d1);
  fence_regs(d2);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kMmaD / 16; ++kk)
    wgmma_ss(d1, desc_b128(a1 + 32 * kk), desc_b128(b1 + 32 * kk));
#pragma unroll
  for (int kk = 0; kk < kMmaD / 16; ++kk)
    wgmma_ss(d2, desc_b128(a2 + 32 * kk), desc_b128(b2 + 32 * kk));
  wgmma_commit();
  wgmma_wait0();
  fence_regs(d1);
  fence_regs(d2);
}

// A warpgroup's 64 x 64 fp32 sums (the wgmma D layout) to bf16 in a
// swizzled tile.
__device__ __forceinline__ void stage_acc(unsigned char* tile, const float (&acc)[32]) {
  const int lr = ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2);
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<uint32_t*>(tile + swz(lr, j) + 4 * t) = pack_bf16(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(tile + swz(lr + 8, j) + 4 * t) =
        pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// Rows row0 .. row0 + 127 of the two swizzled tiles at `tiles` (rows 0-63,
// then 64-127) to out as 16-byte rows, those < L.
__device__ __forceinline__ void store_tiles(const unsigned char* tiles, bf16* out,
                                            size_t out_stride, int row0, int L) {
  const int c = threadIdx.x & 7;
#pragma unroll
  for (int i = 0; i < kBlockRows * 8 / kMmaThreads; ++i) {
    const int r = (threadIdx.x >> 3) + i * (kMmaThreads / 8);
    if (row0 + r < L)
      *reinterpret_cast<uint4*>(out + (row0 + r) * out_stride + c * 8) =
          *reinterpret_cast<const uint4*>(tiles + (r / kTileRows) * kTileBytes +
                                          swz(r % kTileRows, c));
  }
}

// Kernel Q on the tensor cores: one block of two warpgroups per (128-row
// query tile, head, batch), warpgroup wg taking rows q0 + 64 wg .. + 63.
// A thread holds rows r0 and r0 + 8 of its warpgroup's S, dP and dq' sums
// (the wgmma D layout: s[4 j + e] is row r0 + 8 (e >> 1), key j0 + 8 j + 2 t
// + (e & 1)).
__global__ void __launch_bounds__(kMmaThreads, 2)
    attention_bwd_q_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                 bf16* __restrict__ dq, float* __restrict__ stats, int L, int H,
                                 int ts_q, int ts_k, int ts_v, int causal, float scale, int Lp) {
  extern __shared__ __align__(1024) unsigned char smem_tiles[];
  unsigned char* const smem = smem_tiles;
  const uint32_t base = smem_addr(smem);
  if (base % kSwizzleAlign) __trap();
  const int q0 = blockIdx.x * kBlockRows, h = blockIdx.y, b = blockIdx.z;
  const size_t out_stride = static_cast<size_t>(H) * kMmaD;
  const bf16* qh = q + static_cast<size_t>(b) * L * ts_q + h * kMmaD;
  const bf16* kh = k + static_cast<size_t>(b) * L * ts_k + h * kMmaD;
  const bf16* vh = v + static_cast<size_t>(b) * L * ts_v + h * kMmaD;
  const size_t head = static_cast<size_t>(b) * L * out_stride + h * kMmaD;

  const int n_tiles = (L + kKeyTile - 1) / kKeyTile;
  const int last_row = min(L, q0 + kBlockRows) - 1;
  const int n_keys = causal ? min(n_tiles, last_row / kKeyTile + 1) : n_tiles;
  const int n_steps = 2 * n_keys;  // pass A's key tiles, then pass B's
  const bool resident = n_keys <= kSlots;
  auto first_key = [&](int step) { return (step < n_keys ? step : step - n_keys) * kKeyTile; };
  auto slot = [&](int step) { return resident ? first_key(step) / kKeyTile : step % kStages; };
  auto k_slot = [&](int step) { return base + (2 * kGroups + slot(step)) * kTileBytes; };
  auto v_slot = [&](int step) { return base + (2 * kGroups + kSlots + slot(step)) * kTileBytes; };
  auto loads = [&](int step) { return step < n_keys || !resident; };
  // One commit group a step.
  auto issue = [&](int step) {
    if (step >= n_steps) return;
    if (loads(step)) {
      load_tile(k_slot(step), kh, ts_k, first_key(step), L);
      load_tile(v_slot(step), vh, ts_v, first_key(step), L);
    }
    cp_async_commit();
  };
  // As the forward's: wait for step's tiles, then step + 1's copy goes into
  // the ring stage step - 1 used.
  auto land = [&](int step) {
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    issue(step + 1);
  };

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wq0 = q0 + wg * kTileRows;
  const uint32_t qs = base + wg * kTileBytes, os = base + (kGroups + wg) * kTileBytes;
  const int r0 = wq0 + warp * 16 + g;
  auto skips = [&](int step) {
    return wq0 >= L || (causal && first_key(step) > wq0 + kTileRows - 1);
  };
  auto mask = [&](float (&s)[32], int j0) {
    if (j0 + kKeyTile <= L && !(causal && j0 + kKeyTile > wq0 + 1)) return;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = j0 + 8 * (i >> 2) + 2 * t + (i & 1);
      const int row = r0 + 8 * ((i >> 1) & 1);
      if (key >= L || (causal && key > row)) s[i] = kNeg;
    }
  };
  const float c2 = scale * kLog2e;

  for (int w = 0; w < kGroups; ++w) {
    load_tile(base + w * kTileBytes, qh, ts_q, q0 + w * kTileRows, L);
    load_tile(base + (kGroups + w) * kTileBytes, dout + head, static_cast<int>(out_stride),
              q0 + w * kTileRows, L);
  }
  issue(0);

  // Pass A: the forward's m and l, and delta's running sum dl beside l.
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  float s[32], dp[32];
  int step = 0;
  for (; step < n_keys; ++step) {
    land(step);
    if (skips(step)) continue;
    two_products(s, qs, k_slot(step), dp, os, v_slot(step));
    mask(s, first_key(step));
    float mt[2] = {kNeg, kNeg};
#pragma unroll
    for (int i = 0; i < 32; ++i) mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], s[i]);
    float part[2] = {0.f, 0.f}, dpart[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      mt[r] = fmaxf(m[r], mt[r]);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const float e = ex2((s[i] - mt[r]) * c2);
      part[r] += e;
      dpart[r] = fmaf(e, round_bf16(dp[i]), dpart[r]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float f = ex2((m[r] - mt[r]) * c2);
      l[r] = l[r] * f + part[r];
      dl[r] = dl[r] * f + dpart[r];
      m[r] = mt[r];
    }
  }
  float rl[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 1);
    dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 2);
    rl[r] = 1.f / l[r];
    delta[r] = dl[r] * rl[r];
  }

  // Pass B: dS = P dP - P delta (scaled) as hi and lo A fragments, dq' +=
  // dS K over the tile's 64 keys (K MN-major through the transpose bit).
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (; step < n_steps; ++step) {
    land(step);
    if (skips(step)) continue;
    two_products(s, qs, k_slot(step), dp, os, v_slot(step));
    mask(s, first_key(step));
    auto ds = [&](int i) {
      const int r = (i >> 1) & 1;
      const float p = ex2((s[i] - m[r]) * c2) * rl[r];
      return ds_of(p, round_bf16(dp[i]), delta[r], scale);
    };
    uint32_t hi[16], lo[16];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) split_bf16(ds(8 * kk + 2 * e), ds(8 * kk + 2 * e + 1),
                                             hi[4 * kk + e], lo[4 * kk + e]);
    const uint32_t ks = k_slot(step);
    fence_regs(hi);
    fence_regs(lo);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = desc_b128(ks + kk * 16 * 128);
      wgmma_rs_tb(acc, hi[4 * kk], hi[4 * kk + 1], hi[4 * kk + 2], hi[4 * kk + 3], db);
      wgmma_rs_tb(acc, lo[4 * kk], lo[4 * kk + 1], lo[4 * kk + 2], lo[4 * kk + 3], db);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    fence_regs(hi);
    fence_regs(lo);
  }

  // The workspace rows: (m, 1/l, delta), zeros past L (kernel KV masks those
  // rows; zeros keep them finite).
  if (t == 0) {
    float* st = stats + (static_cast<size_t>(b) * H + h) * 3 * Lp;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= Lp) continue;
      const bool ok = row < L;
      st[row] = ok ? m[r] : 0.f;
      st[Lp + row] = ok ? rl[r] : 0.f;
      st[2 * Lp + row] = ok ? delta[r] : 0.f;
    }
  }
  // dq': rounded into the warpgroup's Q tile, then stored.
  __syncthreads();  // every warpgroup is done reading its tiles
  stage_acc(smem + wg * kTileBytes, acc);
  __syncthreads();
  store_tiles(smem, dq + head, out_stride, q0, L);
}

// Kernel KV on the tensor cores: one block of two warpgroups per (128-key
// tile, head, batch), warpgroup wg owning keys k0 + 64 wg .. + 63 (the M of
// its products: S^T[4 j + e] is key r0 + 8 (e >> 1), query i0 + 8 j + 2 t +
// (e & 1)). The block walks the query tiles in order.
__global__ void __launch_bounds__(kMmaThreads, 1)
    attention_bwd_kv_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                  bf16* __restrict__ dk, bf16* __restrict__ dv,
                                  const float* __restrict__ stats, int L, int H, int ts_q,
                                  int ts_k, int ts_v, int causal, float scale, int Lp) {
  extern __shared__ __align__(1024) unsigned char smem_tiles[];
  unsigned char* const smem = smem_tiles;
  const uint32_t base = smem_addr(smem);
  if (base % kSwizzleAlign) __trap();
  const int k0 = blockIdx.x * kBlockRows, h = blockIdx.y, b = blockIdx.z;
  const size_t out_stride = static_cast<size_t>(H) * kMmaD;
  const bf16* qh = q + static_cast<size_t>(b) * L * ts_q + h * kMmaD;
  const bf16* kh = k + static_cast<size_t>(b) * L * ts_k + h * kMmaD;
  const bf16* vh = v + static_cast<size_t>(b) * L * ts_v + h * kMmaD;
  const size_t head = static_cast<size_t>(b) * L * out_stride + h * kMmaD;
  const float* st = stats + (static_cast<size_t>(b) * H + h) * 3 * Lp;

  // Under `causal` the query tiles wholly before the block's first key are
  // skipped.
  const int n_q = (L + kTileRows - 1) / kTileRows;
  const int first = causal ? k0 / kTileRows : 0;
  const int n_steps = n_q - first;
  auto q0_of = [&](int step) { return (first + step) * kTileRows; };
  auto stage = [&](int step) {
    return base + 2 * kGroups * kTileBytes + (step % kStages) * kKvStage;
  };
  // One commit group a step: the Q and dO tiles and the workspace rows
  // (three runs of 64 floats; Lp is a multiple of 64, so they are whole).
  auto issue = [&](int step) {
    if (step >= n_steps) return;
    const uint32_t sb = stage(step);
    const int i0 = q0_of(step);
    load_tile(sb, qh, ts_q, i0, L);
    load_tile(sb + kTileBytes, dout + head, static_cast<int>(out_stride), i0, L);
    if (threadIdx.x < 3 * kTileRows / 4) {
      const int c = threadIdx.x / (kTileRows / 4), j = threadIdx.x % (kTileRows / 4);
      cp_async16(sb + 2 * kTileBytes + c * kTileRows * 4 + j * 16, st + c * Lp + i0 + 4 * j, true);
    }
    cp_async_commit();
  };
  auto land = [&](int step) {
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    issue(step + 1);
  };

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wk0 = k0 + wg * kTileRows;
  const uint32_t ks = base + wg * kTileBytes, vs = base + (kGroups + wg) * kTileBytes;
  const int r0 = wk0 + warp * 16 + g;
  auto skips = [&](int step) {
    return wk0 >= L || (causal && q0_of(step) + kTileRows - 1 < wk0);
  };
  // Queries past L, and (causal) keys past a query, give P = 0.
  auto mask = [&](float (&s)[32], int i0) {
    if (i0 + kTileRows <= L && !(causal && wk0 + kTileRows - 1 > i0)) return;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int query = i0 + 8 * (i >> 2) + 2 * t + (i & 1);
      const int key = r0 + 8 * ((i >> 1) & 1);
      if (query >= L || (causal && key > query)) s[i] = kNeg;
    }
  };
  const float c2 = scale * kLog2e;

  for (int w = 0; w < kGroups; ++w) {
    load_tile(base + w * kTileBytes, kh, ts_k, k0 + w * kTileRows, L);
    load_tile(base + (kGroups + w) * kTileBytes, vh, ts_v, k0 + w * kTileRows, L);
  }
  issue(0);

  float dv_acc[32], dk_acc[32], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dv_acc[i] = dk_acc[i] = 0.f;
  for (int step = 0; step < n_steps; ++step) {
    land(step);
    if (skips(step)) continue;
    const uint32_t sb = stage(step);
    const int i0 = q0_of(step);
    const float* sm = reinterpret_cast<const float*>(smem + (sb - base) + 2 * kTileBytes);
    two_products(s, ks, sb, dp, vs, sb + kTileBytes);   // S^T = K Q^T, dP^T = V dO^T
    mask(s, i0);
    // Query columns 8 j + 2 t and + 1 of n-tile j; keys 16 kk .. 16 kk + 15
    // of the A fragments are the n-tiles 2 kk and 2 kk + 1, as the forward's
    // P. P (kept in s) and its bf16 fragments first: dV's products run while
    // dS is formed.
    uint32_t pa[16], hi[16], lo[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float2 mq = *reinterpret_cast<const float2*>(sm + col);
      const float2 rq = *reinterpret_cast<const float2*>(sm + kTileRows + col);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[4 * j + e] = ex2((s[4 * j + e] - (e & 1 ? mq.y : mq.x)) * c2) * (e & 1 ? rq.y : rq.x);
      const int a = 4 * (j >> 1) + 2 * (j & 1);
      pa[a] = pack_bf16(s[4 * j], s[4 * j + 1]);
      pa[a + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
    }
    fence_regs(pa);
    fence_regs(dv_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_tb(dv_acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                  desc_b128(sb + kTileBytes + kk * 16 * 128));
    wgmma_commit();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 dl = *reinterpret_cast<const float2*>(sm + 2 * kTileRows + 8 * j + 2 * t);
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[e] = ds_of(s[4 * j + e], round_bf16(dp[4 * j + e]), e & 1 ? dl.y : dl.x, scale);
      const int a = 4 * (j >> 1) + 2 * (j & 1);
      split_bf16(ds[0], ds[1], hi[a], lo[a]);
      split_bf16(ds[2], ds[3], hi[a + 1], lo[a + 1]);
    }
    fence_regs(hi);
    fence_regs(lo);
    fence_regs(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = desc_b128(sb + kk * 16 * 128);
      wgmma_rs_tb(dk_acc, hi[4 * kk], hi[4 * kk + 1], hi[4 * kk + 2], hi[4 * kk + 3], db);
      wgmma_rs_tb(dk_acc, lo[4 * kk], lo[4 * kk + 1], lo[4 * kk + 2], lo[4 * kk + 3], db);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(pa);
    fence_regs(hi);
    fence_regs(lo);
  }

  // dk' into the K tiles, dv into the V tiles, rounded; then 16-byte rows.
  __syncthreads();  // every warpgroup is done reading the K and V tiles
  stage_acc(smem + wg * kTileBytes, dk_acc);
  stage_acc(smem + (kGroups + wg) * kTileBytes, dv_acc);
  __syncthreads();
  store_tiles(smem, dk + head, out_stride, k0, L);
  store_tiles(smem + kGroups * kTileBytes, dv + head, out_stride, k0, L);
}

// K1b's rotations on the tensor-core path, a row pair (d, d + 32) at a time
// with separately rounded fp32 products, back to bf16 (as the plain
// version and the CUDA-core kernels round): before the kernels, q' =
// RoPE(q) and k' = RoPE(k) into a (2, B, L, H, 64) workspace (rows of a, b
// ts_a, ts_b elements apart); after them (kInverse), dq = RoPE^T(dq') and dk
// = RoPE^T(dk') in place ((g1 c + g2 s, g2 c - g1 s)). blockIdx.y picks a
// or b; a thread takes 8 pairs of a row. 32-bit index math: 4 B L H < 2^32
// for any tensor that fits on the card.
template <bool kInverse>
__global__ void __launch_bounds__(kMmaThreads)
    rope_rows_kernel(const bf16* a, const bf16* b, const float* __restrict__ cos,
                     const float* __restrict__ sin, bf16* out_a, bf16* out_b, int B, int L,
                     int H, int ts_a, int ts_b) {
  constexpr int half = kMmaD / 2;
  const unsigned rows = static_cast<unsigned>(B) * L * H;
  const unsigned idx = blockIdx.x * kMmaThreads + threadIdx.x;
  if (idx >= rows * 4) return;
  const unsigned row = idx >> 2, bl = row / H;
  const int c = idx & 3, h = row - bl * H, pos = bl % L;
  const bool second = blockIdx.y != 0;
  const bf16* src =
      (second ? b : a) + static_cast<size_t>(bl) * (second ? ts_b : ts_a) + h * kMmaD + c * 8;
  float x1[8], x2[8], cc[8], ss[8], y1[8], y2[8];
  ddg::load16(src, x1);
  ddg::load16(src + half, x2);
  ddg::load_f32<8>(cos + pos * half + c * 8, cc);
  ddg::load_f32<8>(sin + pos * half + c * 8, ss);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    if constexpr (kInverse) {
      y1[e] = __fadd_rn(__fmul_rn(x1[e], cc[e]), __fmul_rn(x2[e], ss[e]));
      y2[e] = __fsub_rn(__fmul_rn(x2[e], cc[e]), __fmul_rn(x1[e], ss[e]));
    } else {
      y1[e] = __fsub_rn(__fmul_rn(x1[e], cc[e]), __fmul_rn(x2[e], ss[e]));
      y2[e] = __fadd_rn(__fmul_rn(x2[e], cc[e]), __fmul_rn(x1[e], ss[e]));
    }
  }
  bf16* dst = (second ? out_b : out_a) + static_cast<size_t>(row) * kMmaD + c * 8;
  ddg::store16(dst, y1);
  ddg::store16(dst + half, y2);
}

// --- launch plan and dispatch -----------------------------------------------

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int cdiv(int a, int b) { return (a + b - 1) / b; }

// What one of a backward call's launches takes.
struct Launch {
  int q_tile, k_tile, stages, smem, threads, gx, gy, gz;
};

// What a backward call launches. `tc`: bf16 with D = 64 and every row on a
// 16-byte boundary, which the tensor-core kernels take at any L; K1b's call
// then launches rope_rows_kernel before and after them (`rope`: threads and
// grid; its other fields 0). stats_len: the workspace's row length Lp (L
// rounded up to 64).
struct Plan {
  int path, stats_len;
  Launch q, kv, rope;
};

int make_plan(int B, int L, int H, int D, bool tc, Plan* p) {
  if (D <= 0 || D % 2 || B <= 0 || L <= 0 || H <= 0 || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  const int stats_len = cdiv(L, kKeyTile) * kKeyTile;
  if (tc) {
    const size_t rope_threads = static_cast<size_t>(B) * L * H * 4;
    *p = {1, stats_len,
          {kBlockRows, kKeyTile, kStages, static_cast<int>(kQSmem), kMmaThreads,
           cdiv(L, kBlockRows), H, B},
          {kTileRows, kBlockRows, kStages, static_cast<int>(kKvSmem), kMmaThreads,
           cdiv(L, kBlockRows), H, B},
          {0, 0, 0, 0, kMmaThreads,
           static_cast<int>((rope_threads + kMmaThreads - 1) / kMmaThreads), 2, 1}};
    return cudaSuccess;
  }
  if (D > kCoreDMax) return cudaErrorInvalidValue;
  const int qt = core_wide_tiles(D) ? 32 : 16, kt = 2 * qt;
  const size_t q_smem = core_q_smem(D, qt, kt), kv_smem = core_kv_smem(D, qt, kt);
  *p = {0, stats_len,
        {qt, kt, 1, static_cast<int>(q_smem), kThreads, cdiv(L, qt), H, B},
        {qt, kt, 1, static_cast<int>(kv_smem), kThreads, cdiv(L, kt), H, B},
        {0, 0, 0, 0, 0, 0, 0, 0}};
  return cudaSuccess;
}

template <typename K>
cudaError_t prepare(K kernel, int smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

dim3 grid_of(const Launch& l) { return dim3(l.gx, l.gy, l.gz); }

// `rot`: K1b's (2, B, L, H, 64) bf16 workspace for the rotated q and k of
// the tensor-core path (unused otherwise, may be null).
template <typename T, bool kRope>
int launch(const void* q, const void* k, const void* v, const void* cos, const void* sin,
           const void* dout, void* dq, void* dk, void* dv, void* stats, void* rot, int B,
           int L, int H, int D, int ts_q, int ts_k, int ts_v, int causal, float scale,
           cudaStream_t stream, int* path) {
  if (ts_q < H * D || ts_k < H * D || ts_v < H * D) return cudaErrorInvalidValue;
  const bool tc = std::is_same<T, bf16>::value && D == kMmaD && ts_q % 8 == 0 &&
                  ts_k % 8 == 0 && ts_v % 8 == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v) && aligned16(dout) && aligned16(dq) && aligned16(dk) &&
                  aligned16(dv) && aligned16(stats) &&
                  (!kRope || (aligned16(cos) && aligned16(sin) && aligned16(rot)));
  Plan p;
  cudaError_t err = static_cast<cudaError_t>(make_plan(B, L, H, D, tc, &p));
  if (err != cudaSuccess) return err;
  *path = p.path;
  const int Lp = p.stats_len;
  const auto* fc = static_cast<const float*>(cos);
  const auto* fs = static_cast<const float*>(sin);
  auto* st = static_cast<float*>(stats);
  if (tc) {
    using P = const bf16*;
    auto kq = attention_bwd_q_wgmma_kernel;
    auto kkv = attention_bwd_kv_wgmma_kernel;
    if ((err = prepare(kq, p.q.smem)) != cudaSuccess) return err;
    if ((err = prepare(kkv, p.kv.smem)) != cudaSuccess) return err;
    P qp = static_cast<P>(q), kp = static_cast<P>(k);
    auto* gq = static_cast<bf16*>(dq);
    auto* gk = static_cast<bf16*>(dk);
    const int ts_out = H * kMmaD;
    if constexpr (kRope) {
      auto* r = static_cast<bf16*>(rot);
      bf16* rk = r + static_cast<size_t>(B) * L * H * kMmaD;
      rope_rows_kernel<false><<<grid_of(p.rope), p.rope.threads, 0, stream>>>(
          qp, kp, fc, fs, r, rk, B, L, H, ts_q, ts_k);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      qp = r;
      kp = rk;
      ts_q = ts_k = ts_out;
    }
    kq<<<grid_of(p.q), p.q.threads, p.q.smem, stream>>>(
        qp, kp, static_cast<P>(v), static_cast<P>(dout), gq, st, L, H, ts_q, ts_k, ts_v, causal,
        scale, Lp);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    kkv<<<grid_of(p.kv), p.kv.threads, p.kv.smem, stream>>>(
        qp, kp, static_cast<P>(v), static_cast<P>(dout), gk, static_cast<bf16*>(dv), st, L, H,
        ts_q, ts_k, ts_v, causal, scale, Lp);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if constexpr (kRope) {
      rope_rows_kernel<true><<<grid_of(p.rope), p.rope.threads, 0, stream>>>(
          gq, gk, fc, fs, gq, gk, B, L, H, ts_out, ts_out);
      err = cudaGetLastError();
    }
    return err;
  }
  using P = const T*;
  auto kq = attention_bwd_q_kernel<T, kRope, 32, 64>;
  auto kkv = attention_bwd_kv_kernel<T, kRope, 32, 64>;
  if (p.q.q_tile == 16) {
    kq = attention_bwd_q_kernel<T, kRope, 16, 32>;
    kkv = attention_bwd_kv_kernel<T, kRope, 16, 32>;
  }
  if ((err = prepare(kq, p.q.smem)) != cudaSuccess) return err;
  if ((err = prepare(kkv, p.kv.smem)) != cudaSuccess) return err;
  kq<<<grid_of(p.q), p.q.threads, p.q.smem, stream>>>(
      static_cast<P>(q), static_cast<P>(k), static_cast<P>(v), fc, fs, static_cast<P>(dout),
      static_cast<T*>(dq), st, L, H, D, ts_q, ts_k, ts_v, causal, scale, Lp);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  kkv<<<grid_of(p.kv), p.kv.threads, p.kv.smem, stream>>>(
      static_cast<P>(q), static_cast<P>(k), static_cast<P>(v), fc, fs, static_cast<P>(dout),
      static_cast<T*>(dk), static_cast<T*>(dv), st, L, H, D, ts_q, ts_k, ts_v, causal, scale,
      Lp);
  return cudaGetLastError();
}

template <bool kRope>
int dispatch(const void* q, const void* k, const void* v, const void* cos, const void* sin,
             const void* dout, void* dq, void* dk, void* dv, void* stats, void* rot, int B,
             int L, int H, int D, int ts_q, int ts_k, int ts_v, int causal, float scale,
             int dtype, void* stream, int* path) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ddg::kF32)
    return launch<float, kRope>(q, k, v, cos, sin, dout, dq, dk, dv, stats, rot, B, L, H, D,
                                ts_q, ts_k, ts_v, causal, scale, s, path);
  if (dtype == ddg::kBF16)
    return launch<bf16, kRope>(q, k, v, cos, sin, dout, dq, dk, dv, stats, rot, B, L, H, D,
                               ts_q, ts_k, ts_v, causal, scale, s, path);
  return cudaErrorInvalidValue;
}

}  // namespace

// K1b. q, k, v: (B, L, H, D) with dense heads, rows ts_q, ts_k, ts_v
// elements apart; cos, sin: (L, D / 2) fp32; dout and the outputs dq, dk,
// dv: contiguous (B, L, H, D); stats: the (B, H, 3, Lp) fp32 workspace of
// ddg_attention_bwd_plan's stats_len Lp; rot: a (2, B, L, H, D) workspace
// of the input dtype (the rotated q and k of the tensor-core path). *path:
// 1 for the tensor cores, 0 for the CUDA cores. Two launches on `stream`
// (four on the tensor-core path: the rotation before, the un-rotation
// after).
extern "C" int ddg_rope_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* cos, const void* sin, const void* dout,
                                      void* dq, void* dk, void* dv, void* stats, void* rot,
                                      int B, int L, int H, int D, int ts_q, int ts_k, int ts_v,
                                      int causal, float scale, int dtype, void* stream,
                                      int* path) {
  return dispatch<true>(q, k, v, cos, sin, dout, dq, dk, dv, stats, rot, B, L, H, D, ts_q,
                        ts_k, ts_v, causal, scale, dtype, stream, path);
}

// K2's backward: the same without the rotation (and without `rot`).
extern "C" int ddg_short_seq_attention_bwd(const void* q, const void* k, const void* v,
                                           const void* dout, void* dq, void* dk, void* dv,
                                           void* stats, int B, int L, int H, int D, int ts_q,
                                           int ts_k, int ts_v, int causal, float scale,
                                           int dtype, void* stream, int* path) {
  return dispatch<false>(q, k, v, nullptr, nullptr, dout, dq, dk, dv, stats, nullptr, B, L, H,
                         D, ts_q, ts_k, ts_v, causal, scale, dtype, stream, path);
}

// The launch plan of a K1b or K2b call of this shape, for rows on 16-byte
// boundaries (`aligned`) or not: out = {path, stats_len, then for kernel Q
// and kernel KV each: query tile, key tile, ring stages, dynamic shared
// bytes, threads, grid x, y, z; then K1b's rotation launch on the
// tensor-core path: threads, grid x, y, z (all 0 on the CUDA cores)}.
// Returns what the launch would return for the shape (0, or
// cudaErrorInvalidValue where no kernel takes it). ops/attention.py:
// backward_plan mirrors it.
extern "C" int ddg_attention_bwd_plan(int B, int L, int H, int D, int dtype, int aligned,
                                      int* out) {
  if (dtype != ddg::kF32 && dtype != ddg::kBF16) return cudaErrorInvalidValue;
  Plan p;
  const int err = make_plan(B, L, H, D, dtype == ddg::kBF16 && D == kMmaD && aligned, &p);
  if (err != cudaSuccess) return err;
  const int fields[22] = {p.path,       p.stats_len,  p.q.q_tile,   p.q.k_tile,  p.q.stages,
                          p.q.smem,     p.q.threads,  p.q.gx,       p.q.gy,      p.q.gz,
                          p.kv.q_tile,  p.kv.k_tile,  p.kv.stages,  p.kv.smem,   p.kv.threads,
                          p.kv.gx,      p.kv.gy,      p.kv.gz,      p.rope.threads,
                          p.rope.gx,    p.rope.gy,    p.rope.gz};
  for (int i = 0; i < 22; ++i) out[i] = fields[i];
  return cudaSuccess;
}
