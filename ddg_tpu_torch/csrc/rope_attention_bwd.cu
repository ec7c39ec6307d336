// Softmax attention for the DiT's short sequences, backward, on the
// token-major layout: K1b (with RoPE) and K2's backward (without).
//
// Replaces the backwards of ddg_tpu/ops/attention_pallas.py's two TPU
// kernels: _rope_flash_bwd (:233-248, for fused_rope_attention) and
// _flash_bwd (:101-115, for short_seq_attention). Both are plain-jnp
// recomputes whose VJPs, through _rope_reference (:190-203) and
// _reference (:63-75), round where this kernel rounds. For each (b, h),
// from the saved q, k, v and the output gradient dO, all (B, L, H, D):
//   q' = RoPE(q), k' = RoPE(k)     K1b only: fp32, rounded to the input dtype
//   P  = softmax(q' k'^T / sqrt(D)) fp32 (causal: keys j > i masked)
//   dV = round(P)^T dO             round(P) = P in v's dtype, fp32 sums
//   dP = dO V^T                    rounded to the input dtype
//   dS = P dP - P delta            delta = sum_j P dP (as the VJP of softmax)
//   dq' = (dS / sqrt(D)) k',  dk' = (dS / sqrt(D))^T q'   rounded to the input dtype
//   dq = RoPE^T(dq'), dk = RoPE^T(dk')   K1b only: (x1, x2) <- (g1 c + g2 s, g2 c - g1 s),
//                                        rounded again
//
// Bound on the H100 at text8's training shape (micro-batch B=256, L=256,
// H=12, D=64): 7 B L H D elements moved, 705 MB in bf16, take 0.210 ms at
// 3.35 TB/s; five L x L x D products, 10 B H L^2 D = 128.8 GFLOP, take
// 0.130 ms at the bf16 tensor-core rate. So the function is bound by
// bytes.
//
// Two kernels, each in a RoPE and a plain instantiation, one block of 256
// threads per (head, batch), for D = 64 and L <= 256 (kMaxL / kKeys = 128
// or 256, L rounded up); the wrapper raises on other shapes. Neither uses
// atomics: dK and dV sum over the query tiles in registers, in the order
// of the queries, so reruns are bit-identical. The grid is therefore only
// H x B blocks, each walking every query tile of its head in turn, and at
// L = 256 the bf16 kernel's 206.5 KB of shared memory holds one block to
// an SM: below about 11 rows (132 SMs / 12 heads) SMs sit idle, and
// fewer blocks a wave leave less to hide each block's serial walk behind.
// * attention_bwd_mma_kernel, for bf16 (rows 16-byte aligned): the products
//   on the tensor cores (mma.sync m16n8k16, fp32 sums); its comment below
//   has the layout.
// * attention_bwd_kernel, for float32: the block
//   stages k', v of its head in fp32 (two kMaxL x 65 tiles, rows padded
//   against bank conflicts, rows past L zero) and walks the queries in
//   tiles of 32 rows, staging each tile's q' and dO (32 x 65) beside a
//   32 x (kMaxL + 1) score tile: 100 KB of shared memory at kMaxL = 128,
//   183 KB at 256. A tile has every key of its rows, so its softmax, delta
//   and dq need nothing from other tiles. Per tile: S = q' k'^T with a
//   thread holding 4 rows x kMaxL / 32 keys (a warp owns whole rows, so the softmax runs on
//   registers with warp shuffles) and P written to the tile; dV +=
//   round(P)^T dO; dP = dO V^T in the same layout, delta by warp shuffles;
//   dS written over P once dV has read it; dq = dS k' (stored, un-rotated);
//   dK += dS^T q'. All products are fp32 FMAs on the CUDA cores, which
//   cannot take less than 0.96 ms at the shape above (67 TFLOP/s). The
//   un-rotation pairs columns d and d + 32, which one thread holds.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kD = 64;
constexpr int kTq = 32;              // query rows of a tile (CUDA-core kernel)
constexpr int kThreads = 256;
constexpr int kRow = kD + 1;         // padded fp32 row of k', v, q', dO
constexpr float kNeg = -1e30f;

template <int kMaxL>
constexpr size_t bwd_smem() {
  return sizeof(float) * (2 * kMaxL * kRow + 2 * kTq * kRow + kTq * (kMaxL + 1));
}

// acc[a][b] += sum_k A[(ty + RS a) am + k ak] * Bm[k bk + (tx + CS b) bn],
// A optionally rounded to T on load: a TM x TN tile of the result per
// thread, rows RS and columns CS apart.
template <int TM, int TN, int RS, int CS, bool kRoundA, typename T>
__device__ __forceinline__ void tile_fma(float (&acc)[TM][TN], const float* A, int am, int ak,
                                         const float* Bm, int bk, int bn, int K, int ty,
                                         int tx) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[TM], bv[TN];
#pragma unroll
    for (int a = 0; a < TM; ++a) {
      const float x = A[(ty + RS * a) * am + k * ak];
      av[a] = kRoundA ? ddg::round_to<T>(x) : x;
    }
#pragma unroll
    for (int b = 0; b < TN; ++b) bv[b] = Bm[k * bk + (tx + CS * b) * bn];
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int b = 0; b < TN; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
  }
}

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int b = 0; b < TN; ++b) acc[a][b] = 0.f;
}

// Store a (TM rows, 16 apart, from row0 + ty) x (4 column-groups, tx + 16 b)
// tile of dq' or dk' rounded to T: un-rotated (K1b; columns tx + 16 b and
// tx + 16 b + 32 are a pair) or as it is (K2).
template <typename T, bool kRope, int TM>
__device__ __forceinline__ void store_grad(const float (&acc)[TM][4], T* out, size_t head,
                                           size_t row_stride, const float* cos,
                                           const float* sin, int row0, int L, int ty, int tx) {
  constexpr int half = kD / 2;
#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const int i = row0 + ty + 16 * a;
    if (i >= L) continue;
    T* row = out + head + static_cast<size_t>(i) * row_stride;
    if constexpr (kRope) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int f = tx + 16 * b;
        const float g1 = ddg::round_to<T>(acc[a][b]);
        const float g2 = ddg::round_to<T>(acc[a][b + 2]);
        const float c = cos[i * half + f], s = sin[i * half + f];
        row[f] = ddg::from_f32<T>(__fadd_rn(__fmul_rn(g1, c), __fmul_rn(g2, s)));
        row[f + half] = ddg::from_f32<T>(__fsub_rn(__fmul_rn(g2, c), __fmul_rn(g1, s)));
      }
    } else {
#pragma unroll
      for (int b = 0; b < 4; ++b) row[tx + 16 * b] = ddg::from_f32<T>(acc[a][b]);
    }
  }
}

// Stage rows [row0, row0 + n) of one head of x (rows ts apart) into dst
// (n x kRow fp32): rotated and rounded to T (q, k of K1b) or as they are;
// rows past L are 0.
template <typename T, bool kRotate>
__device__ __forceinline__ void stage_rows(float* dst, const T* x, size_t head, int ts, int row0,
                                           int n, int L, const float* cos, const float* sin,
                                           int tid) {
  constexpr int half = kD / 2;
  for (int idx = tid; idx < n * half; idx += kThreads) {
    const int r = idx / half, f = idx % half, j = row0 + r;
    float y1 = 0.f, y2 = 0.f;
    if (j < L) {
      const T* row = x + head + static_cast<size_t>(j) * ts;
      const float x1 = ddg::to_f32(row[f]), x2 = ddg::to_f32(row[f + half]);
      if constexpr (kRotate) {
        const float c = cos[j * half + f], s = sin[j * half + f];
        y1 = ddg::round_to<T>(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s)));
        y2 = ddg::round_to<T>(__fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s)));
      } else {
        y1 = x1;
        y2 = x2;
      }
    }
    dst[r * kRow + f] = y1;
    dst[r * kRow + f + half] = y2;
  }
}

template <typename T, bool kRope, int kMaxL>
__global__ void __launch_bounds__(kThreads, 1)
    attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const float* __restrict__ cos,
                         const float* __restrict__ sin, const T* __restrict__ dout,
                         T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, int L,
                         int H, int ts_q, int ts_k, int ts_v, int causal, float scale) {
  constexpr int kPRow = kMaxL + 1;   // padded fp32 row of the score tile
  constexpr int kIW = kTq / 8;       // query rows of a thread in the wide layout
  constexpr int kKT = kMaxL / 32;    // keys of a thread in the wide layout
  constexpr int kIQ = kTq / 16;      // query rows of a thread's dq tile
  constexpr int kJT = kMaxL / 16;    // key rows of a thread's dK, dV tile
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                  // kMaxL x kRow: k'
  float* Vs = Ks + kMaxL * kRow;     // kMaxL x kRow: v
  float* Qs = Vs + kMaxL * kRow;     // kTq x kRow: q' of the tile
  float* Os = Qs + kTq * kRow;       // kTq x kRow: dO of the tile
  float* Ps = Os + kTq * kRow;       // kTq x kPRow: P, then dS / sqrt(D)
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  // Square layout (16 x 16) for dq, dK, dV; wide layout (8 warps x 32
  // lanes, warp w owning rows w, w + 8, ...) for S and dP.
  const int ty = tid >> 4, tx = tid & 15;
  const int wy = tid >> 5, wx = tid & 31;
  const size_t qh = static_cast<size_t>(b) * L * ts_q + static_cast<size_t>(h) * kD;
  const size_t kh = static_cast<size_t>(b) * L * ts_k + static_cast<size_t>(h) * kD;
  const size_t vh = static_cast<size_t>(b) * L * ts_v + static_cast<size_t>(h) * kD;
  // dO, dq, dk, dv are contiguous (B, L, H, D).
  const size_t out_stride = static_cast<size_t>(H) * kD;
  const size_t out_head = static_cast<size_t>(b) * L * out_stride + static_cast<size_t>(h) * kD;

  stage_rows<T, kRope>(Ks, k, kh, ts_k, 0, kMaxL, L, cos, sin, tid);
  stage_rows<T, false>(Vs, v, vh, ts_v, 0, kMaxL, L, cos, sin, tid);

  float dv_acc[kJT][4], dk_acc[kJT][4];
  zero(dv_acc);
  zero(dk_acc);

  for (int i0 = 0; i0 < L; i0 += kTq) {
    __syncthreads();   // the previous tile is done with Qs, Os, Ps
    stage_rows<T, kRope>(Qs, q, qh, ts_q, i0, kTq, L, cos, sin, tid);
    stage_rows<T, false>(Os, dout, out_head, static_cast<int>(out_stride), i0, kTq, L, cos, sin,
                         tid);
    __syncthreads();

    {  // S = q' k'^T / sqrt(D), masked; P = softmax(S) on registers; rows
       // past L are 0.
      float s[kIW][kKT];
      zero(s);
      tile_fma<kIW, kKT, 8, 32, false, T>(s, Qs, kRow, 1, Ks, 1, kRow, kD, wy, wx);
#pragma unroll
      for (int a = 0; a < kIW; ++a) {
        const int i = i0 + wy + 8 * a;
        float m = kNeg;
#pragma unroll
        for (int c = 0; c < kKT; ++c) {
          const int j = wx + 32 * c;
          float x = s[a][c] * scale;
          if (j >= L || (causal && j > i)) x = kNeg;
          s[a][c] = x;
          m = fmaxf(m, x);
        }
        m = ddg::warp_max(m);
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < kKT; ++c) {
          s[a][c] = expf(s[a][c] - m);
          sum += s[a][c];
        }
        sum = ddg::warp_sum(sum);
        float* row = Ps + (wy + 8 * a) * kPRow;
#pragma unroll
        for (int c = 0; c < kKT; ++c) row[wx + 32 * c] = i < L ? s[a][c] / sum : 0.f;
      }
    }
    __syncthreads();

    // dV += round(P)^T dO
    tile_fma<kJT, 4, 16, 16, true, T>(dv_acc, Ps, 1, kPRow, Os, kRow, 1, kTq, ty, tx);

    // dP = dO V^T (rounded), delta = rowsum(P dP), then dS = P dP - P delta
    // over P once every thread has read it.
    float dp[kIW][kKT], delta[kIW];
    zero(dp);
    tile_fma<kIW, kKT, 8, 32, false, T>(dp, Os, kRow, 1, Vs, 1, kRow, kD, wy, wx);
#pragma unroll
    for (int a = 0; a < kIW; ++a) {
      const float* row = Ps + (wy + 8 * a) * kPRow;
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < kKT; ++c) {
        dp[a][c] = ddg::round_to<T>(dp[a][c]);
        part = fmaf(row[wx + 32 * c], dp[a][c], part);
      }
      delta[a] = ddg::warp_sum(part);
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < kIW; ++a) {
      float* row = Ps + (wy + 8 * a) * kPRow;
#pragma unroll
      for (int c = 0; c < kKT; ++c) {
        float* at = row + wx + 32 * c;
        const float p = *at;
        const float ds = __fsub_rn(__fmul_rn(p, dp[a][c]), __fmul_rn(p, delta[a]));
        *at = __fmul_rn(ds, scale);
      }
    }
    __syncthreads();

    {  // dq' = dS k' for the tile's rows, stored
      float acc[kIQ][4];
      zero(acc);
      tile_fma<kIQ, 4, 16, 16, false, T>(acc, Ps, kPRow, 1, Ks, kRow, 1, kMaxL, ty, tx);
      store_grad<T, kRope, kIQ>(acc, dq, out_head, out_stride, cos, sin, i0, L, ty, tx);
    }
    // dK += dS^T q'
    tile_fma<kJT, 4, 16, 16, false, T>(dk_acc, Ps, 1, kPRow, Qs, kRow, 1, kTq, ty, tx);
  }

#pragma unroll
  for (int a = 0; a < kJT; ++a) {
    const int j = ty + 16 * a;
    if (j >= L) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      dv[out_head + static_cast<size_t>(j) * out_stride + tx + 16 * c] =
          ddg::from_f32<T>(dv_acc[a][c]);
  }
  store_grad<T, kRope, kJT>(dk_acc, dk, out_head, out_stride, cos, sin, 0, L, ty, tx);
}

// --- bf16 tensor-core path ---------------------------------------------------

using ddg::ld32;
using ddg::mma_16816;
using ddg::pack_bf16;

constexpr int kMq = 64;           // query rows of a tile
constexpr int kMRow = kD + 8;     // padded bf16 row of k', v, q', dO: 36 words, 4 mod 32
constexpr int kMTRow = kMq + 8;   // padded bf16 row of q'^T, dO^T

// Shared memory of the tensor-core kernel (byte offsets), for kKeys = 128 or
// 256 keys: k', k'^T, v of the head; q', dO, q'^T, dO^T of the query tile
// (bf16); P, then dS, of the tile (fp32, rows 4 mod 32 words); the two key
// halves' partial deltas. 122.5 KB at 128 keys, 206.5 KB at 256.
template <int kKeys>
struct MmaLayout {
  static constexpr int kKtRow = kKeys + 8;   // padded bf16 row of k'^T
  static constexpr int kPRow = kKeys + 4;    // padded fp32 row of P / dS
  static constexpr size_t kK = 0;
  static constexpr size_t kKt = kK + 2 * kKeys * kMRow;
  static constexpr size_t kV = kKt + 2 * kD * kKtRow;
  static constexpr size_t kQ = kV + 2 * kKeys * kMRow;
  static constexpr size_t kO = kQ + 2 * kMq * kMRow;
  static constexpr size_t kQt = kO + 2 * kMq * kMRow;
  static constexpr size_t kOt = kQt + 2 * kD * kMTRow;
  static constexpr size_t kP = kOt + 2 * kD * kMTRow;
  static constexpr size_t kDelta = kP + 4 * kMq * kPRow;
  static constexpr size_t kSmem = kDelta + 4 * 2 * kMq;
};

// Rows [row0, row0 + n) of one head of x (rows ts apart) into bf16 shared
// memory, rows kMRow apart and, with dst_t, transposed (dst_t[d t_row + r]):
// rotated and rounded (kRotate) or as they are; rows past L are 0.
template <bool kRotate>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, __nv_bfloat16* dst_t, int t_row,
                                           const __nv_bfloat16* x, size_t head, int ts,
                                           int row0, int n, int L, const float* cos,
                                           const float* sin, int tid) {
  constexpr int half = kD / 2;
  for (int idx = tid; idx < n * (half / 8); idx += kThreads) {
    const int r = idx / (half / 8), f = (idx % (half / 8)) * 8, j = row0 + r;
    float y1[8], y2[8];
    if (j < L) {
      const __nv_bfloat16* row = x + head + static_cast<size_t>(j) * ts;
      ddg::load16(row + f, y1);
      ddg::load16(row + f + half, y2);
      if constexpr (kRotate) {
        float c[8], s[8];
        ddg::load_f32<8>(cos + j * half + f, c);
        ddg::load_f32<8>(sin + j * half + f, s);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float x1 = y1[i], x2 = y2[i];
          y1[i] = __fsub_rn(__fmul_rn(x1, c[i]), __fmul_rn(x2, s[i]));
          y2[i] = __fadd_rn(__fmul_rn(x2, c[i]), __fmul_rn(x1, s[i]));
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) y1[i] = y2[i] = 0.f;
    }
    ddg::store16(dst + r * kMRow + f, y1);
    ddg::store16(dst + r * kMRow + f + half, y2);
    if (dst_t != nullptr) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        dst_t[(f + i) * t_row + r] = __float2bfloat16_rn(y1[i]);
        dst_t[(f + half + i) * t_row + r] = __float2bfloat16_rn(y2[i]);
      }
    }
  }
}

// Rows [row0, row0 + n) of dq' or dk' (bf16 in shared memory, rows kMRow
// apart) to the output: un-rotated and rounded again (kRope) or as they are.
template <bool kRope>
__device__ __forceinline__ void store_rows(const __nv_bfloat16* src, __nv_bfloat16* out,
                                           size_t head, size_t stride, int row0, int n, int L,
                                           const float* cos, const float* sin, int tid) {
  constexpr int half = kD / 2;
  for (int idx = tid; idx < n * half; idx += kThreads) {
    const int r = idx / half, f = idx % half, i = row0 + r;
    if (i >= L) continue;
    __nv_bfloat16* row = out + head + static_cast<size_t>(i) * stride;
    const __nv_bfloat16 x1 = src[r * kMRow + f], x2 = src[r * kMRow + f + half];
    if constexpr (kRope) {
      const float g1 = __bfloat162float(x1), g2 = __bfloat162float(x2);
      const float c = cos[i * half + f], s = sin[i * half + f];
      row[f] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(g1, c), __fmul_rn(g2, s)));
      row[f + half] = __float2bfloat16_rn(__fsub_rn(__fmul_rn(g2, c), __fmul_rn(g1, s)));
    } else {
      row[f] = x1;
      row[f + half] = x2;
    }
  }
}

// (a, b) as two bf16 pairs whose sum is (a, b) to about 2^-16 relative: the
// rounded pair and the rounded remainder.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

// bf16, D = 64, L <= kKeys: one block of 8 warps per (head, batch) stages
// k', k'^T and v of the head and walks the queries in tiles of 64. Per
// tile, a warp owns 16 query rows x half of the keys for S and dP (bf16
// products on the tensor cores, mma.sync m16n8k16, fp32 sums), 16 rows x
// half of the head dim for dq, and kKeys / 128 16-key row tiles of dK and
// dV, which sum over the tiles in registers. P goes through fp32 shared
// memory: the softmax runs a warp to a row, dV reads round(P)^T as its A
// fragments, dS = P dP - P delta overwrites it. dq and dk take the fp32 dS
// as two bf16 terms (split_bf16), so their products keep dS to about 2^-16
// where the plain version keeps it in fp32; dq' and dk' are rounded to
// bf16 and staged in shared memory, then un-rotated by rows.
template <bool kRope, int kKeys>
__global__ void __launch_bounds__(kThreads, 1)
    attention_bwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v, const float* __restrict__ cos,
                             const float* __restrict__ sin,
                             const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dq,
                             __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                             int L, int H, int ts_q, int ts_k, int ts_v, int causal,
                             float scale) {
  using M = MmaLayout<kKeys>;
  constexpr int kKtRow = M::kKtRow, kPRow = M::kPRow;
  constexpr int kNT = kKeys / 16;    // 8-key tiles of a warp's half of the keys
  constexpr int kJT = kKeys / 128;   // 16-key row tiles of a warp's dK, dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw + M::kK);
  __nv_bfloat16* Kt = reinterpret_cast<__nv_bfloat16*>(smem_raw + M::kKt);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem_raw + M::kV);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw + M::kQ);
  __nv_bfloat16* Os = reinterpret_cast<__nv_bfloat16*>(smem_raw + M::kO);
  __nv_bfloat16* Qt = reinterpret_cast<__nv_bfloat16*>(smem_raw + M::kQt);
  __nv_bfloat16* Ot = reinterpret_cast<__nv_bfloat16*>(smem_raw + M::kOt);
  float* Ps = reinterpret_cast<float*>(smem_raw + M::kP);
  float* Dl = reinterpret_cast<float*>(smem_raw + M::kDelta);
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, column pair
  const int half_ = warp >> 2;            // the warp's half of the keys (S, dP) or of d (dq)
  const int r0 = (warp & 3) * 16 + g;     // the lane's rows in the tile: r0, r0 + 8
  const int key0 = half_ * (kKeys / 2);
  const size_t qh = static_cast<size_t>(b) * L * ts_q + static_cast<size_t>(h) * kD;
  const size_t kh = static_cast<size_t>(b) * L * ts_k + static_cast<size_t>(h) * kD;
  const size_t vh = static_cast<size_t>(b) * L * ts_v + static_cast<size_t>(h) * kD;
  const size_t out_stride = static_cast<size_t>(H) * kD;
  const size_t out_head = static_cast<size_t>(b) * L * out_stride + static_cast<size_t>(h) * kD;

  stage_bf16<kRope>(Ks, Kt, kKtRow, k, kh, ts_k, 0, kKeys, L, cos, sin, tid);
  stage_bf16<false>(Vs, nullptr, 0, v, vh, ts_v, 0, kKeys, L, cos, sin, tid);

  float dv_acc[kJT][kD / 8][4], dk_acc[kJT][kD / 8][4];
#pragma unroll
  for (int jr = 0; jr < kJT; ++jr)
#pragma unroll
    for (int nt = 0; nt < kD / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dv_acc[jr][nt][e] = dk_acc[jr][nt][e] = 0.f;

  for (int i0 = 0; i0 < L; i0 += kMq) {
    __syncthreads();   // the previous tile is done with Qs, Os, Qt, Ot, Ps
    stage_bf16<kRope>(Qs, Qt, kMTRow, q, qh, ts_q, i0, kMq, L, cos, sin, tid);
    stage_bf16<false>(Os, Ot, kMTRow, dout, out_head, static_cast<int>(out_stride), i0, kMq, L,
                      cos, sin, tid);
    __syncthreads();

    {  // S = q' k'^T / sqrt(D), masked, into Ps
      float s[kNT][4];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const __nv_bfloat16* qa = Qs + r0 * kMRow + kk * 16 + 2 * t;
        const uint32_t a0 = ld32(qa), a1 = ld32(qa + 8 * kMRow);
        const uint32_t a2 = ld32(qa + 8), a3 = ld32(qa + 8 * kMRow + 8);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const __nv_bfloat16* kb = Ks + (key0 + nt * 8 + g) * kMRow + kk * 16 + 2 * t;
          mma_16816(s[nt], a0, a1, a2, a3, ld32(kb), ld32(kb + 8));
        }
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + (e >> 1) * 8, key = key0 + nt * 8 + 2 * t + (e & 1);
          float x = s[nt][e] * scale;
          if (key >= L || (causal && key > i0 + row)) x = kNeg;
          Ps[row * kPRow + key] = x;
        }
    }
    __syncthreads();

    // P = softmax(S), a warp to a row; rows past L are 0.
    for (int r = warp; r < kMq; r += kThreads / 32) {
      float* row = Ps + r * kPRow;
      if (i0 + r >= L) {
        for (int j = lane; j < kKeys; j += 32) row[j] = 0.f;
        continue;
      }
      float m = kNeg;
      for (int j = lane; j < kKeys; j += 32) m = fmaxf(m, row[j]);
      m = ddg::warp_max(m);
      float sum = 0.f;
      for (int j = lane; j < kKeys; j += 32) {
        const float e = expf(row[j] - m);
        row[j] = e;
        sum += e;
      }
      sum = ddg::warp_sum(sum);
      for (int j = lane; j < kKeys; j += 32) row[j] = row[j] / sum;
    }
    __syncthreads();

    // dV += round(P)^T dO: A fragments from P read transposed (rows of P 4
    // mod 32 words apart, so a warp's loads hit 32 banks).
#pragma unroll
    for (int jr = 0; jr < kJT; ++jr) {
      const int j0 = (warp * kJT + jr) * 16;
#pragma unroll
      for (int kk = 0; kk < kMq / 16; ++kk) {
        const float* p = Ps + (kk * 16 + 2 * t) * kPRow + j0 + g;
        const uint32_t a0 = pack_bf16(p[0], p[kPRow]);
        const uint32_t a1 = pack_bf16(p[8], p[kPRow + 8]);
        const uint32_t a2 = pack_bf16(p[8 * kPRow], p[9 * kPRow]);
        const uint32_t a3 = pack_bf16(p[8 * kPRow + 8], p[9 * kPRow + 8]);
#pragma unroll
        for (int nt = 0; nt < kD / 8; ++nt) {
          const __nv_bfloat16* ob = Ot + (nt * 8 + g) * kMTRow + kk * 16 + 2 * t;
          mma_16816(dv_acc[jr][nt], a0, a1, a2, a3, ld32(ob), ld32(ob + 8));
        }
      }
    }

    // dP = dO V^T, rounded; the half's partial rowsum(P dP).
    float dp[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const __nv_bfloat16* oa = Os + r0 * kMRow + kk * 16 + 2 * t;
      const uint32_t a0 = ld32(oa), a1 = ld32(oa + 8 * kMRow);
      const uint32_t a2 = ld32(oa + 8), a3 = ld32(oa + 8 * kMRow + 8);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const __nv_bfloat16* vb = Vs + (key0 + nt * 8 + g) * kMRow + kk * 16 + 2 * t;
        mma_16816(dp[nt], a0, a1, a2, a3, ld32(vb), ld32(vb + 8));
      }
    }
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + (e >> 1) * 8, key = key0 + nt * 8 + 2 * t + (e & 1);
        dp[nt][e] = ddg::round_to<__nv_bfloat16>(dp[nt][e]);
        part[e >> 1] = fmaf(Ps[row * kPRow + key], dp[nt][e], part[e >> 1]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      part[r] += __shfl_xor_sync(0xffffffffu, part[r], 1);
      part[r] += __shfl_xor_sync(0xffffffffu, part[r], 2);
    }
    if (t == 0) {
      Dl[half_ * kMq + r0] = part[0];
      Dl[half_ * kMq + r0 + 8] = part[1];
    }
    __syncthreads();   // dV has read P; the partial deltas are in

    {  // dS = P dP - P delta, scaled, over P
      const float delta[2] = {Dl[r0] + Dl[kMq + r0], Dl[r0 + 8] + Dl[kMq + r0 + 8]};
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + (e >> 1) * 8, key = key0 + nt * 8 + 2 * t + (e & 1);
          float* at = Ps + row * kPRow + key;
          const float p = *at;
          const float ds = __fsub_rn(__fmul_rn(p, dp[nt][e]), __fmul_rn(p, delta[e >> 1]));
          *at = __fmul_rn(ds, scale);
        }
    }
    __syncthreads();

    {  // dq' = dS k' for the tile's rows, rounded and staged in Qs
      float acc[kD / 16][4];
#pragma unroll
      for (int nt = 0; nt < kD / 16; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        const float* pa = Ps + r0 * kPRow + kk * 16 + 2 * t;
        const float2 x0 = *reinterpret_cast<const float2*>(pa);
        const float2 x1 = *reinterpret_cast<const float2*>(pa + 8 * kPRow);
        const float2 x2 = *reinterpret_cast<const float2*>(pa + 8);
        const float2 x3 = *reinterpret_cast<const float2*>(pa + 8 * kPRow + 8);
        uint32_t hi[4], lo[4];
        split_bf16(x0.x, x0.y, hi[0], lo[0]);
        split_bf16(x1.x, x1.y, hi[1], lo[1]);
        split_bf16(x2.x, x2.y, hi[2], lo[2]);
        split_bf16(x3.x, x3.y, hi[3], lo[3]);
#pragma unroll
        for (int nt = 0; nt < kD / 16; ++nt) {
          const __nv_bfloat16* kb =
              Kt + (half_ * (kD / 2) + nt * 8 + g) * kKtRow + kk * 16 + 2 * t;
          const uint32_t b0 = ld32(kb), b1 = ld32(kb + 8);
          mma_16816(acc[nt], hi[0], hi[1], hi[2], hi[3], b0, b1);
          mma_16816(acc[nt], lo[0], lo[1], lo[2], lo[3], b0, b1);
        }
      }
#pragma unroll
      for (int nt = 0; nt < kD / 16; ++nt) {
        const int d = half_ * (kD / 2) + nt * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(Qs + r0 * kMRow + d) = pack_bf16(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<uint32_t*>(Qs + (r0 + 8) * kMRow + d) =
            pack_bf16(acc[nt][2], acc[nt][3]);
      }
    }
    __syncthreads();
    store_rows<kRope>(Qs, dq, out_head, out_stride, i0, kMq, L, cos, sin, tid);

    // dK += dS^T q': A fragments from dS read transposed, in two bf16 terms.
#pragma unroll
    for (int jr = 0; jr < kJT; ++jr) {
      const int j0 = (warp * kJT + jr) * 16;
#pragma unroll
      for (int kk = 0; kk < kMq / 16; ++kk) {
        const float* p = Ps + (kk * 16 + 2 * t) * kPRow + j0 + g;
        uint32_t hi[4], lo[4];
        split_bf16(p[0], p[kPRow], hi[0], lo[0]);
        split_bf16(p[8], p[kPRow + 8], hi[1], lo[1]);
        split_bf16(p[8 * kPRow], p[9 * kPRow], hi[2], lo[2]);
        split_bf16(p[8 * kPRow + 8], p[9 * kPRow + 8], hi[3], lo[3]);
#pragma unroll
        for (int nt = 0; nt < kD / 8; ++nt) {
          const __nv_bfloat16* qb = Qt + (nt * 8 + g) * kMTRow + kk * 16 + 2 * t;
          const uint32_t b0 = ld32(qb), b1 = ld32(qb + 8);
          mma_16816(dk_acc[jr][nt], hi[0], hi[1], hi[2], hi[3], b0, b1);
          mma_16816(dk_acc[jr][nt], lo[0], lo[1], lo[2], lo[3], b0, b1);
        }
      }
    }
  }

  // dV straight from the fragments; dk' rounded and staged in Ks (last read
  // by the final tile's S), then un-rotated by rows.
#pragma unroll
  for (int jr = 0; jr < kJT; ++jr) {
    const int j = (warp * kJT + jr) * 16 + g;
#pragma unroll
    for (int nt = 0; nt < kD / 8; ++nt) {
      const int d = nt * 8 + 2 * t;
      if (j < L)
        *reinterpret_cast<uint32_t*>(dv + out_head + static_cast<size_t>(j) * out_stride + d) =
            pack_bf16(dv_acc[jr][nt][0], dv_acc[jr][nt][1]);
      if (j + 8 < L)
        *reinterpret_cast<uint32_t*>(dv + out_head + static_cast<size_t>(j + 8) * out_stride +
                                     d) = pack_bf16(dv_acc[jr][nt][2], dv_acc[jr][nt][3]);
      *reinterpret_cast<uint32_t*>(Ks + j * kMRow + d) =
          pack_bf16(dk_acc[jr][nt][0], dk_acc[jr][nt][1]);
      *reinterpret_cast<uint32_t*>(Ks + (j + 8) * kMRow + d) =
          pack_bf16(dk_acc[jr][nt][2], dk_acc[jr][nt][3]);
    }
  }
  __syncthreads();
  store_rows<kRope>(Ks, dk, out_head, out_stride, 0, kKeys, L, cos, sin, tid);
}

template <bool kRope, int kKeys>
int launch_mma(const void* q, const void* k, const void* v, const void* cos, const void* sin,
               const void* dout, void* dq, void* dk, void* dv, int B, int L, int H, int ts_q,
               int ts_k, int ts_v, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = MmaLayout<kKeys>::kSmem;
  auto kernel = attention_bwd_mma_kernel<kRope, kKeys>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  using bf = __nv_bfloat16;
  kernel<<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const float*>(cos), static_cast<const float*>(sin),
      static_cast<const bf*>(dout), static_cast<bf*>(dq), static_cast<bf*>(dk),
      static_cast<bf*>(dv), L, H, ts_q, ts_k, ts_v, causal, scale);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// --- dispatch ---------------------------------------------------------------

template <typename T, bool kRope, int kMaxL>
int launch_l(const void* q, const void* k, const void* v, const void* cos, const void* sin,
             const void* dout, void* dq, void* dk, void* dv, int B, int L, int H, int ts_q,
             int ts_k, int ts_v, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = bwd_smem<kMaxL>();
  auto kernel = attention_bwd_kernel<T, kRope, kMaxL>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(cos), static_cast<const float*>(sin),
      static_cast<const T*>(dout), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), L, H, ts_q, ts_k, ts_v, causal, scale);
  return cudaGetLastError();
}

template <typename T, bool kRope>
int launch(const void* q, const void* k, const void* v, const void* cos, const void* sin,
           const void* dout, void* dq, void* dk, void* dv, int B, int L, int H, int ts_q,
           int ts_k, int ts_v, int causal, float scale, cudaStream_t stream, int* path) {
  if (B <= 0 || B > 65535 || L <= 0 || L > 256 || H <= 0 || H > 65535 || ts_q < H * kD ||
      ts_k < H * kD || ts_v < H * kD)
    return cudaErrorInvalidValue;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // The tensor-core kernel's 16-byte row loads.
    const bool ropes_aligned = !kRope || (aligned16(cos) && aligned16(sin));
    if (ts_q % 8 || ts_k % 8 || ts_v % 8 || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
        !aligned16(dout) || !aligned16(dq) || !aligned16(dk) || !aligned16(dv) ||
        !ropes_aligned)
      return cudaErrorInvalidValue;
    *path = 1;
    if (L <= 128)
      return launch_mma<kRope, 128>(q, k, v, cos, sin, dout, dq, dk, dv, B, L, H, ts_q, ts_k,
                                    ts_v, causal, scale, stream);
    return launch_mma<kRope, 256>(q, k, v, cos, sin, dout, dq, dk, dv, B, L, H, ts_q, ts_k,
                                  ts_v, causal, scale, stream);
  } else {
    *path = 0;
    if (L <= 128)
      return launch_l<T, kRope, 128>(q, k, v, cos, sin, dout, dq, dk, dv, B, L, H, ts_q, ts_k,
                                     ts_v, causal, scale, stream);
    return launch_l<T, kRope, 256>(q, k, v, cos, sin, dout, dq, dk, dv, B, L, H, ts_q, ts_k,
                                   ts_v, causal, scale, stream);
  }
}

template <bool kRope>
int dispatch(const void* q, const void* k, const void* v, const void* cos, const void* sin,
             const void* dout, void* dq, void* dk, void* dv, int B, int L, int H, int ts_q,
             int ts_k, int ts_v, int causal, float scale, int dtype, void* stream, int* path) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ddg::kF32)
    return launch<float, kRope>(q, k, v, cos, sin, dout, dq, dk, dv, B, L, H, ts_q, ts_k, ts_v,
                                causal, scale, s, path);
  if (dtype == ddg::kBF16)
    return launch<__nv_bfloat16, kRope>(q, k, v, cos, sin, dout, dq, dk, dv, B, L, H, ts_q,
                                        ts_k, ts_v, causal, scale, s, path);
  return cudaErrorInvalidValue;
}

}  // namespace

// K1b. q, k, v: (B, L, H, 64) with dense heads, rows ts_q, ts_k, ts_v
// elements apart; cos, sin: (L, 32) fp32; dout and the outputs dq, dk, dv:
// contiguous (B, L, H, 64); L <= 256. *path: 1 for the tensor cores, 0
// for the CUDA cores.
extern "C" int ddg_rope_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* cos, const void* sin, const void* dout,
                                      void* dq, void* dk, void* dv, int B, int L, int H,
                                      int ts_q, int ts_k, int ts_v, int causal, float scale,
                                      int dtype, void* stream, int* path) {
  return dispatch<true>(q, k, v, cos, sin, dout, dq, dk, dv, B, L, H, ts_q, ts_k, ts_v, causal,
                        scale, dtype, stream, path);
}

// K2's backward: the same without the rotation.
extern "C" int ddg_short_seq_attention_bwd(const void* q, const void* k, const void* v,
                                           const void* dout, void* dq, void* dk, void* dv,
                                           int B, int L, int H, int ts_q, int ts_k, int ts_v,
                                           int causal, float scale, int dtype, void* stream,
                                           int* path) {
  return dispatch<false>(q, k, v, nullptr, nullptr, dout, dq, dk, dv, B, L, H, ts_q, ts_k,
                         ts_v, causal, scale, dtype, stream, path);
}
