// Pieces shared by the DiMamba kernels' forward (mamba.cu) and backward
// (mamba_bwd.cu): the bf16 and fp32 products, the front (conv + SiLU,
// x_proj, dt_proj + softplus), delta from dt_lr and the scan's row staging.
#pragma once

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using ddg::from_f32;
using ddg::ld32;
using ddg::mma_16816;
using ddg::pack_bf16;
using ddg::round_to;
using ddg::to_f32;
using bf16 = __nv_bfloat16;

constexpr int kMaxN = 16;       // states a thread holds: a group; d_state loops over groups
constexpr int kMaxR = 32;       // dt_rank of one tile of W_dt held in registers (K19's
constexpr int kMaxRT = 2;       // dt adjoint); tiles: dt_rank <= 64, past it rank tiles
constexpr int kSmemMax = 232448;

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// 1 / (1 + exp(-x)); the correctly rounded reciprocal is the division's result.
__device__ __forceinline__ float sigmoid(float x) { return __frcp_rn(1.f + expf(-x)); }

// log(1 + exp(x)) as jax.nn.softplus: max(x, 0) + log1p(exp(-|x|)).
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// dt_proj's sum pre = dt_lr . w, fp32 FMAs with k ascending, four at a
// time (lr zero past R up to a multiple of 4, w zero past R): the forward
// and every adjoint form delta = softplus(pre + b_dt) in this one order
// (here with w in registers, a channel's column of W_dt, as the front
// holds a rank tile of it; `delta_kernel` and K17's `dt_pre_row` with it
// in shared memory), so they agree bit for bit.
template <int NW>
__device__ __forceinline__ float dt_pre(const float* lr, const float (&w)[NW], int R) {
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < NW; k += 4) {
    if (k >= R) break;
    const float4 v = *reinterpret_cast<const float4*>(lr + k);
    acc = fmaf(v.x, w[k], acc);
    acc = fmaf(v.y, w[k + 1], acc);
    acc = fmaf(v.z, w[k + 2], acc);
    acc = fmaf(v.w, w[k + 3], acc);
  }
  return acc;
}

// Channel ch's column of W_dt (R, d) into registers, zeros past R.
template <int NW>
__device__ __forceinline__ void load_wdt(const float* __restrict__ wdt, int ch, int d, int R,
                                         float (&w)[NW]) {
#pragma unroll
  for (int k = 0; k < NW; ++k) w[k] = k < R ? wdt[static_cast<size_t>(k) * d + ch] : 0.f;
}

cudaError_t allow_smem(const void* fn, size_t bytes) {
  if (bytes > kSmemMax) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// --- products: C[M, N] = A[M, K] W[N, K]^T, rounded to T --------------------
//
// bf16 on wgmma: a block of two warpgroups owns a 128 x 128 tile of C, a
// warpgroup 64 rows of it as two m64n64 fp32 accumulators; k advances 64 at
// a time (one 128-byte swizzled row of bf16: wgmma.cuh) through a
// kGemmStages-stage ring of 16-byte cp.async copies of A's two 64 x 64
// tiles and W's two, issued kGemmStages - 1 steps ahead; rows past M or N
// and columns past K load as zeros. The same kernel (kWgrad) gives the
// weight gradients' partials, part[slice, P, Q] = X^T Y over a slice of
// kWRows rows: there both operands are read row by row, M-major, through
// wgmma's transpose bits. Each output's fp32 sum runs in the order the
// tiling fixes: reruns are bit-identical.
constexpr int kGemmTile = 2 * kTileRows;     // rows and columns of a block's C tile
constexpr int kGemmThreads = 256;            // two warpgroups
constexpr int kGemmStages = 3;
constexpr int kGemmStage = 4 * kTileBytes;   // A's two 64 x 64 tiles, then W's two
constexpr int kGemmSmem = kGemmStages * kGemmStage;   // 96 KB: two blocks an SM
constexpr int kWRows = 4096;                 // rows of one weight-gradient slice

// Rows r0 .. r0 + 63 (those < rmax) and columns c0 .. c0 + 63 (16-byte
// pieces starting < cmax) of the row-major X (rows ld elements apart) into
// a swizzled 64 x 64 tile, zeros elsewhere.
__device__ __forceinline__ void load_tile_rc(uint32_t dst, const bf16* X, int ld, int r0,
                                             int rmax, int c0, int cmax) {
  const int c = threadIdx.x & 7, col = c0 + 8 * c;
#pragma unroll
  for (int i = 0; i < kTileRows * 8 / kGemmThreads; ++i) {
    const int r = (threadIdx.x >> 3) + i * (kGemmThreads / 8), p = r0 + r;
    const bool ok = p < rmax && col < cmax;
    cp_async16(dst + swz(r, c), ok ? X + static_cast<size_t>(p) * ld + col : X, ok);
  }
}

// !kWgrad: C (+)= A W^T over k in [0, K), C in OutT (bf16 rounded, or fp32;
// acc_c adds to C's fp32 values), blocks (N tiles, M tiles). kWgrad: C =
// part + slice P Q gets X^T Y over rows [slice kWRows, + kWRows) of M = K
// rows, with A = X (P columns), W = Y (Q columns); blocks (Q tiles, P
// tiles, slices). M, N name C's rows and columns in both.
template <bool kWgrad, typename OutT>
__global__ void __launch_bounds__(kGemmThreads, 2)
    gemm_wgmma_kernel(const bf16* __restrict__ A, int lda, const bf16* __restrict__ W, int ldw,
                      OutT* __restrict__ C, int ldc, int M, int N, int K, int acc_c) {
  constexpr int S = kGemmStages;
  extern __shared__ __align__(1024) unsigned char smem_tiles[];
  const uint32_t base = smem_addr(smem_tiles);
  if (base % kSwizzleAlign) __trap();
  const int m0 = blockIdx.y * kGemmTile, n0 = blockIdx.x * kGemmTile;
  const int kb = kWgrad ? blockIdx.z * kWRows : 0;
  const int ke = kWgrad ? min(K, kb + kWRows) : K;
  if (kWgrad) C += static_cast<size_t>(blockIdx.z) * M * N;
  const int n_steps = (ke - kb + kTileRows - 1) / kTileRows;
  auto stage = [&](int step) { return base + (step % S) * kGemmStage; };
  // One commit group a k step (empty past the last).
  auto issue = [&](int step) {
    if (step < n_steps) {
      const uint32_t sb = stage(step);
      const int k0 = kb + step * kTileRows;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if constexpr (kWgrad) {
          load_tile_rc(sb + i * kTileBytes, A, lda, k0, ke, m0 + i * kTileRows, M);
          load_tile_rc(sb + (2 + i) * kTileBytes, W, ldw, k0, ke, n0 + i * kTileRows, N);
        } else {
          load_tile_rc(sb + i * kTileBytes, A, lda, m0 + i * kTileRows, M, k0, K);
          load_tile_rc(sb + (2 + i) * kTileBytes, W, ldw, n0 + i * kTileRows, N, k0, K);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < S - 1; ++st) issue(st);

  const int wg = threadIdx.x >> 7;
  float acc0[32], acc1[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.f;
  fence_regs(acc0);
  fence_regs(acc1);
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<S - 2>();
    fence_async_smem();
    __syncthreads();
    issue(step + S - 1);   // into the stage step - 1 used
    const uint32_t sa = stage(step) + wg * kTileBytes, sw = stage(step) + 2 * kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTileRows / 16; ++kk) {
      if constexpr (kWgrad) {
        wgmma_ss_tt(acc0, desc_b128(sa + kk * 16 * 128), desc_b128(sw + kk * 16 * 128));
        wgmma_ss_tt(acc1, desc_b128(sa + kk * 16 * 128),
                    desc_b128(sw + kTileBytes + kk * 16 * 128));
      } else {
        wgmma_ss(acc0, desc_b128(sa + 32 * kk), desc_b128(sw + 32 * kk));
        wgmma_ss(acc1, desc_b128(sa + 32 * kk), desc_b128(sw + kTileBytes + 32 * kk));
      }
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc0);
    fence_regs(acc1);
  }
  cp_async_wait<0>();

  // acc[4 j + e] is row 16 warp + g + 8 (e >> 1), column 8 j + 2 t + (e & 1)
  // of the warpgroup's 64 x 64 accumulator.
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  auto store = [&](const float (&acc)[32], int h2) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + h2 * kTileRows + 8 * j + 2 * t;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = m0 + wg * kTileRows + 16 * warp + g + 8 * hh;
        if (r >= M || c >= N) continue;
        OutT* dst = C + static_cast<size_t>(r) * ldc + c;
        float v0 = acc[4 * j + 2 * hh], v1 = acc[4 * j + 2 * hh + 1];
        if (acc_c) {
          v0 += to_f32(dst[0]);
          if (c + 1 < N) v1 += to_f32(dst[1]);
        }
        if (sizeof(OutT) == 2 && c + 1 < N) {
          *reinterpret_cast<uint32_t*>(dst) = pack_bf16(v0, v1);
        } else {
          dst[0] = from_f32<OutT>(v0);
          if (c + 1 < N) dst[1] = from_f32<OutT>(v1);
        }
      }
    }
  };
  store(acc0, 0);
  store(acc1, 1);
}

// fp32: a block owns 64 x 64 of C, a thread 4 x 4, in full fp32 FMAs.
__global__ void __launch_bounds__(256)
    gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ W,
                    float* __restrict__ C, int M, int N, int K, int lda, int ldc, int acc_c) {
  __shared__ float As[16][65];
  __shared__ float Ws[16][65];
  const int m0 = blockIdx.y * 64, n0 = blockIdx.x * 64;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += 16) {
    for (int i = threadIdx.x; i < 64 * 16; i += 256) {
      const int r = i >> 4, k = i & 15;
      As[k][r] = m0 + r < M && k0 + k < K ? A[static_cast<size_t>(m0 + r) * lda + k0 + k] : 0.f;
      Ws[k][r] = n0 + r < N && k0 + k < K ? W[static_cast<size_t>(n0 + r) * K + k0 + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[k][ty * 4 + i];
        b[i] = Ws[k][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + ty * 4 + i, c = n0 + tx * 4 + j;
      if (r >= M || c >= N) continue;
      float* dst = C + static_cast<size_t>(r) * ldc + c;
      *dst = acc_c ? *dst + acc[i][j] : acc[i][j];
    }
}

// The wgmma product's launch: grid, its shared memory allowed first.
template <bool kWgrad, typename OutT>
cudaError_t gemm_launch(dim3 grid, const bf16* A, int lda, const bf16* W, int ldw, OutT* C,
                        int ldc, int M, int N, int K, int acc, cudaStream_t s) {
  auto kernel = gemm_wgmma_kernel<kWgrad, OutT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kGemmThreads, kGemmSmem, s>>>(A, lda, W, ldw, C, ldc, M, N, K, acc);
  return cudaGetLastError();
}

// C[M, N] (+)= A[M, K] W[N, K]^T: bf16 inputs with C in bf16 or fp32, or
// all fp32; `acc` adds to C (fp32 only).
template <typename OutT>
cudaError_t gemm(const bf16* A, const bf16* W, OutT* C, int M, int N, int K, int lda, int ldc,
                 cudaStream_t s, bool acc = false) {
  const uintptr_t mis = reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(W);
  if (K % 8 || lda % 8 || ldc % 2 || mis % 16 || (acc && sizeof(OutT) != 4))
    return cudaErrorMisalignedAddress;
  const dim3 grid((N + kGemmTile - 1) / kGemmTile, (M + kGemmTile - 1) / kGemmTile);
  return gemm_launch<false, OutT>(grid, A, lda, W, K, C, ldc, M, N, K, acc, s);
}

cudaError_t gemm(const float* A, const float* W, float* C, int M, int N, int K, int lda, int ldc,
                 cudaStream_t s, bool acc = false) {
  gemm_f32_kernel<<<dim3((N + 63) / 64, (M + 63) / 64), 256, 0, s>>>(A, W, C, M, N, K, lda, ldc,
                                                                      acc);
  return cudaGetLastError();
}

// --- front, any shape: conv + SiLU, x_proj, dt_proj + softplus --------------
//
// One block of kFrontThreads per (kFrontRows rows, b). x_proj walks d in k
// steps of kFrontK channels: each step forms its u columns of the tile's
// rows (conv + SiLU: a thread a channel and kConvSeg rows, the K - 1 rows
// before them read first, zeros before the sequence starts) into shared
// memory beside W_x's matching columns, then multiplies them in: bf16 on
// the tensor cores (mma.sync m16n8k16, k ascending 16 at a time), fp32 on
// the CUDA cores (k ascending); the accumulators of up to kXCols columns of
// x_dbl stay in registers over the walk, and wider x_dbl takes more passes
// (the conv redone, u written once). Neither d nor dt_rank sizes the
// block's shared memory. dt_proj follows from the block's x_dbl rows as
// stored (K18's forward and K19's recompute, the same bits): the rows'
// dt_lr in rank tiles of kDtPRank in shared memory (staged once where one
// tile holds dt_rank), a thread's channel's column of each tile of W_dt in
// registers, each sum in `dt_pre`'s order.
constexpr int kFrontRows = 64;                                      // rows of a tile (row-tile
constexpr int kFrontThreads = 256;                                  // kernel: at most)
constexpr int kFrontK = 64;                                         // channels of a k step
constexpr int kXCols = 64;                                          // x_dbl columns of a pass
constexpr int kConvSeg = kFrontRows * kFrontK / kFrontThreads;      // rows of a conv thread
constexpr int kRowBatch = 8;        // rows of x the conv adjoint loads at once (mamba_bwd.cu)
constexpr int kDtPCh = 64;                                          // dt_proj: channels a step
constexpr int kDtPRank = 16;                                        // dt_proj: ranks staged
constexpr int kDtPRows = kFrontRows * kDtPCh / kFrontThreads;       // dt_proj: rows a thread

// Row strides of the staged u tile and W_x tile (elements): bf16 fragment
// loads and fp32 column reads both land on distinct banks.
__host__ __device__ constexpr int front_us_ld() { return kFrontK + 8; }
__host__ __device__ constexpr int front_wx_ld(int tsize) {
  return tsize == 2 ? kFrontK + 8 : kFrontK + 1;
}

// Bytes of the front's shared memory: the u and W_x tiles (dt_proj's rank
// tile of dt_lr reuses them: 4 KB).
__host__ __device__ constexpr int front_smem(int tsize) {
  return tsize * (kFrontRows * front_us_ld() + kXCols * front_wx_ld(tsize));
}

// u columns k0 .. k0 + kFrontK - 1 of the tile's rows into us (zeros past
// the rows and d), and into u when write_u; the conv's taps summed from the
// oldest, every op rounded to T, SiLU in fp32.
template <typename T, int K>
__device__ __forceinline__ void conv_step(const T* __restrict__ xz, const T* __restrict__ cw,
                                          const T* __restrict__ cb, T* __restrict__ u, T* us,
                                          int b, int L, int d, int t0, int rows, int k0,
                                          bool write_u) {
  const int c = threadIdx.x % kFrontK, r0 = threadIdx.x / kFrontK * kConvSeg, ch = k0 + c;
  constexpr int ld = front_us_ld();
  if (ch >= d) {
#pragma unroll
    for (int r = 0; r < kConvSeg; ++r) us[(r0 + r) * ld + c] = from_f32<T>(0.f);
    return;
  }
  // xv[i] is x at row t0 + r0 - (K - 1) + i.
  float xv[K - 1 + kConvSeg], w[K];
  const size_t base = static_cast<size_t>(b) * L;
#pragma unroll
  for (int i = 0; i < K - 1 + kConvSeg; ++i) {
    const int tt = t0 + r0 - (K - 1) + i;
    xv[i] = tt >= 0 && tt < t0 + rows ? to_f32(xz[(base + tt) * 2 * d + ch]) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < K; ++j) w[j] = to_f32(cw[j * d + ch]);
  const float bias = to_f32(cb[ch]);
#pragma unroll
  for (int r = 0; r < kConvSeg; ++r) {
    float acc = round_to<T>(xv[r] * w[0]);
#pragma unroll
    for (int j = 1; j < K; ++j) acc = round_to<T>(acc + round_to<T>(xv[r + j] * w[j]));
    const float xc = round_to<T>(acc + bias);
    const T v = from_f32<T>(xc * sigmoid(xc));
    const int rr = r0 + r;
    const bool in = rr < rows;
    us[rr * ld + c] = in ? v : from_f32<T>(0.f);
    if (write_u && in) u[(base + t0 + rr) * d + ch] = v;
  }
}

// W_x's rows cp0 .. cp0 + kXCols - 1 (those < nx), columns k0 .. k0 +
// kFrontK - 1 (those < d) into wxs, zeros elsewhere; every load issued
// before the first store.
__device__ __forceinline__ void stage_wx(const bf16* __restrict__ wx, int d, int nx, int cp0,
                                         int k0, bf16* wxs) {
  constexpr int ld = front_wx_ld(2), pieces = kFrontK / 8;
  constexpr int J = kXCols * pieces / kFrontThreads;
  uint4 v[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int i = threadIdx.x + j * kFrontThreads, r = i / pieces, c = (i % pieces) * 8;
    v[j] = make_uint4(0u, 0u, 0u, 0u);
    if (cp0 + r < nx && k0 + c < d)
      v[j] = *reinterpret_cast<const uint4*>(wx + static_cast<size_t>(cp0 + r) * d + k0 + c);
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int i = threadIdx.x + j * kFrontThreads, r = i / pieces, c = (i % pieces) * 8;
    *reinterpret_cast<uint4*>(wxs + r * ld + c) = v[j];
  }
}

__device__ __forceinline__ void stage_wx(const float* __restrict__ wx, int d, int nx, int cp0,
                                         int k0, float* wxs) {
  constexpr int ld = front_wx_ld(4), J = kXCols * kFrontK / kFrontThreads;
  float v[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int i = threadIdx.x + j * kFrontThreads, r = i / kFrontK, c = i % kFrontK;
    v[j] = cp0 + r < nx && k0 + c < d ? wx[static_cast<size_t>(cp0 + r) * d + k0 + c] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int i = threadIdx.x + j * kFrontThreads;
    wxs[i / kFrontK * ld + i % kFrontK] = v[j];
  }
}

// One k step of x_proj. bf16: warp w owns the (16-row, 8-column) tiles of
// row tile w / 2 and column tiles 4 (w % 2) .. + 3 (acc[4 j + e]); ncols
// columns of the pass are live.
__device__ __forceinline__ void xproj_step(const bf16* us, const bf16* wxs, int ncols,
                                           float (&acc)[16]) {
  constexpr int uld = front_us_ld(), wld = front_wx_ld(2);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int mt = warp >> 1, nb = (warp & 1) * 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if ((nb + j) * 8 >= ncols) break;  // uniform over the warp
    float a[4] = {acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]};
#pragma unroll
    for (int kk = 0; kk < kFrontK; kk += 16) {
      const bf16* p = us + (mt * 16 + g) * uld + kk + 2 * t;
      const bf16* q = wxs + ((nb + j) * 8 + g) * wld + kk + 2 * t;
      mma_16816(a, ld32(p), ld32(p + 8 * uld), ld32(p + 8), ld32(p + 8 * uld + 8), ld32(q),
                ld32(q + 8));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[4 * j + e] = a[e];
  }
}

// fp32: thread (column tid % 64, rows 16 (tid / 64) ..) in full fp32 FMAs.
__device__ __forceinline__ void xproj_step(const float* us, const float* wxs, int ncols,
                                           float (&acc)[16]) {
  constexpr int uld = front_us_ld(), wld = front_wx_ld(4);
  const int c = threadIdx.x % kXCols, r0 = threadIdx.x / kXCols * 16;
  if (c >= ncols) return;
#pragma unroll 4
  for (int k = 0; k < kFrontK; ++k) {
    const float wv = wxs[c * wld + k];
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] = fmaf(us[(r0 + j) * uld + k], wv, acc[j]);
  }
}

// The pass's x_dbl columns cp0 .. out, rounded to T.
__device__ __forceinline__ void xproj_store(const float (&acc)[16], bf16* __restrict__ xdbl,
                                            size_t row0, int rows, int nx, int cp0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int mt = warp >> 1, nb = (warp & 1) * 4;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = mt * 16 + g + (e >> 1) * 8, c = cp0 + (nb + j) * 8 + 2 * t + (e & 1);
      if (r < rows && c < nx) xdbl[(row0 + r) * nx + c] = __float2bfloat16_rn(acc[4 * j + e]);
    }
}

__device__ __forceinline__ void xproj_store(const float (&acc)[16], float* __restrict__ xdbl,
                                            size_t row0, int rows, int nx, int cp0) {
  const int c = cp0 + threadIdx.x % kXCols, r0 = threadIdx.x / kXCols * 16;
  if (c >= nx) return;
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (r0 + j < rows) xdbl[(row0 + r0 + j) * nx + c] = acc[j];
}

// One block per (kFrontRows-row tile, b), for K conv taps (4, or 8: fewer
// taps come padded with leading zero taps). W_x is (nx, d), W_dt (R, d).
template <typename T, int K>
__global__ void __launch_bounds__(kFrontThreads, 4)
    mamba_front_wide_kernel(const T* __restrict__ xz, const T* __restrict__ cw,
                            const T* __restrict__ cb, const T* __restrict__ wx,
                            const float* __restrict__ wdt, const float* __restrict__ bdt,
                            T* __restrict__ u, T* __restrict__ xdbl, float* __restrict__ delta,
                            int L, int d, int R, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* us = reinterpret_cast<T*>(smem);                       // kFrontRows x front_us_ld
  T* wxs = us + kFrontRows * front_us_ld();                 // kXCols x front_wx_ld
  const int nx = R + 2 * N;
  const int b = blockIdx.y, t0 = blockIdx.x * kFrontRows;
  const int rows = min(kFrontRows, L - t0);
  const size_t row0 = static_cast<size_t>(b) * L + t0;
  for (int cp0 = 0; cp0 < nx; cp0 += kXCols) {
    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.f;
    for (int k0 = 0; k0 < d; k0 += kFrontK) {
      __syncthreads();  // the last step's readers of us and wxs are done
      conv_step<T, K>(xz, cw, cb, u, us, b, L, d, t0, rows, k0, cp0 == 0);
      stage_wx(wx, d, nx, cp0, k0, wxs);
      __syncthreads();
      xproj_step(us, wxs, nx - cp0, acc);
    }
    xproj_store(acc, xdbl, row0, rows, nx, cp0);
  }

  // dt_proj on the rows' dt_lr as stored: thread (channel tid % kDtPCh of
  // the step, kDtPRows rows), k ascending four at a time (`dt_pre`).
  float* lrs = reinterpret_cast<float*>(smem);              // kFrontRows x kDtPRank
  const int c = threadIdx.x % kDtPCh, r0 = threadIdx.x / kDtPCh * kDtPRows;
  const bool one_tile = R <= kDtPRank;
  for (int ch0 = 0; ch0 < d; ch0 += kDtPCh) {
    const int ch = ch0 + c;
    const bool live = ch < d;
    float acc[kDtPRows];
#pragma unroll
    for (int j = 0; j < kDtPRows; ++j) acc[j] = 0.f;
    for (int k0 = 0; k0 < R; k0 += kDtPRank) {
      if (!one_tile || ch0 == 0) {
        __syncthreads();  // x_dbl's rows written; the last tile's readers are done
        for (int i = threadIdx.x; i < kFrontRows * kDtPRank; i += kFrontThreads) {
          const int r = i / kDtPRank, k = k0 + i % kDtPRank;
          lrs[i] = r < rows && k < R ? to_f32(xdbl[(row0 + r) * nx + k]) : 0.f;
        }
        __syncthreads();
      }
      float w[kDtPRank];
      load_wdt(wdt + static_cast<size_t>(k0) * d, live ? ch : 0, d, live ? R - k0 : 0, w);
#pragma unroll
      for (int kk = 0; kk < kDtPRank; kk += 4) {
        if (k0 + kk >= R) break;
#pragma unroll
        for (int j = 0; j < kDtPRows; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(lrs + (r0 + j) * kDtPRank + kk);
          acc[j] = fmaf(v.x, w[kk], acc[j]);
          acc[j] = fmaf(v.y, w[kk + 1], acc[j]);
          acc[j] = fmaf(v.z, w[kk + 2], acc[j]);
          acc[j] = fmaf(v.w, w[kk + 3], acc[j]);
        }
      }
    }
    if (!live) continue;
    const float bias = bdt[ch];
#pragma unroll
    for (int j = 0; j < kDtPRows; ++j)
      if (r0 + j < rows) delta[(row0 + r0 + j) * d + ch] = softplus(acc[j] + bias);
  }
}

template <typename T, int K>
cudaError_t front_wide_k(const T* xz, const T* cw, const T* cb, const T* wx, const float* wdt,
                         const float* bdt, T* u, T* xdbl, float* delta, int Bt, int L, int d,
                         int R, int N, cudaStream_t s) {
  const size_t smem = front_smem(sizeof(T));
  const dim3 grid((L + kFrontRows - 1) / kFrontRows, Bt);
  auto kernel = mamba_front_wide_kernel<T, K>;
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kFrontThreads, smem, s>>>(xz, cw, cb, wx, wdt, bdt, u, xdbl, delta, L, d, R, N);
  return cudaGetLastError();
}

// --- front, the shapes a row tile holds: a thread a channel ----------------
//
// Where dt_rank <= 64 and a tile of rows of all d channels fits in shared
// memory (`front_tile`), this kernel runs the front; the k-step kernel
// above takes every other shape. Both sum in the same orders (conv taps
// from the oldest, x_proj k ascending 16 at a time on the tensor cores or
// one at a time in fp32, dt_proj in `dt_pre`'s), so they give the same
// bits; this one is the faster at the DiMamba's shapes (2.17 against 2.39
// ms at 16 x 32768, PERF.md).

// x_proj of the tile's u rows (us, row stride us_ld; tile rows, a multiple
// of 16) on the tensor cores: warps take (16-row, 8-column) tiles in turn;
// columns past nx are zero. x_dbl goes out rounded to bf16; its dt_lr
// columns also go to lr (fp32, row stride lr_ld) for dt_proj.
__device__ void xproj_tile(const bf16* us, int us_ld, int tile, const bf16* __restrict__ wx, int d,
                           int nx, int R, float* lr, int lr_ld, int rows,
                           bf16* __restrict__ xdbl, size_t row0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_tiles = (nx + 7) / 8;
  for (int tl = warp; tl < (tile / 16) * n_tiles; tl += kFrontThreads / 32) {
    const int mt = tl / n_tiles, nt = tl % n_tiles;
    const int n = nt * 8 + g;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int k0 = 0; k0 < d; k0 += 16) {
      const bf16* p = us + (mt * 16 + g) * us_ld + k0 + 2 * t;
      const bf16* q = wx + static_cast<size_t>(n) * d + k0 + 2 * t;
      const uint32_t b0 = n < nx ? ld32(q) : 0u, b1 = n < nx ? ld32(q + 8) : 0u;
      mma_16816(acc, ld32(p), ld32(p + 8 * us_ld), ld32(p + 8), ld32(p + 8 * us_ld + 8), b0, b1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = mt * 16 + g + (e >> 1) * 8, c = nt * 8 + 2 * t + (e & 1);
      if (c >= nx) continue;
      const bf16 v = __float2bfloat16_rn(acc[e]);
      if (c < R) lr[r * lr_ld + c] = __bfloat162float(v);
      if (r < rows) xdbl[(row0 + r) * nx + c] = v;
    }
  }
}

// The same on the CUDA cores, for fp32.
__device__ void xproj_tile(const float* us, int us_ld, int tile, const float* __restrict__ wx,
                           int d, int nx, int R, float* lr, int lr_ld, int rows,
                           float* __restrict__ xdbl, size_t row0) {
  for (int i = threadIdx.x; i < tile * nx; i += kFrontThreads) {
    const int r = i / nx, c = i % nx;
    const float* a = us + r * us_ld;
    const float* w = wx + static_cast<size_t>(c) * d;
    float acc = 0.f;
    for (int k = 0; k < d; ++k) acc = fmaf(a[k], w[k], acc);
    if (c < R) lr[r * lr_ld + c] = acc;
    if (r < rows) xdbl[(row0 + r) * nx + c] = acc;
  }
}

// One block per (tile-row tile, b), for K conv taps (4, or 8: fewer taps
// come padded with leading zero taps) and W_dt held as NW / 32 register
// tiles of its column. Threads own channels and walk the tile's rows with
// the last K values of x in registers (the tile's K - 1 halo rows read
// first, zeros before the sequence starts), loading a batch of rows at a
// time; u goes to shared memory for x_proj, whose rounded dt_lr columns
// feed dt_proj (fp32 FMAs, `dt_pre`). W_dt is (R, d).
template <typename T, int K, int NW>
__global__ void __launch_bounds__(kFrontThreads)
    mamba_front_kernel(const T* __restrict__ xz, const T* __restrict__ cw,
                       const T* __restrict__ cb, const T* __restrict__ wx,
                       const float* __restrict__ wdt, const float* __restrict__ bdt,
                       T* __restrict__ u, T* __restrict__ xdbl, float* __restrict__ delta, int L,
                       int d, int R, int N, int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int us_ld = d + 8, lr_ld = round4(R);
  const int nx = R + 2 * N;
  T* us = reinterpret_cast<T*>(smem);                        // tile x us_ld
  float* lr = reinterpret_cast<float*>(us + tile * us_ld);   // tile x lr_ld
  const int b = blockIdx.y, t0 = blockIdx.x * tile;
  const int rows = min(tile, L - t0);
  const size_t row0 = static_cast<size_t>(b) * L + t0;
  const int ld = 2 * d;
  for (int i = threadIdx.x; i < tile * lr_ld; i += kFrontThreads) lr[i] = 0.f;

  for (int ch = threadIdx.x; ch < d; ch += kFrontThreads) {
    // win[K - 1] is x_t, win[K - 1 - i] is x_{t-i}.
    float win[K], w[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      w[j] = to_f32(cw[j * d + ch]);
      const int tt = t0 - K + j;  // at win[j - 1] once row t0 shifts in
      win[j] = tt >= 0 && j >= 1 ? to_f32(xz[(static_cast<size_t>(b) * L + tt) * ld + ch]) : 0.f;
    }
    const float bias = to_f32(cb[ch]);
    // Rows go in batches whose loads are all issued first: one row at a
    // time leaves the thread waiting on device memory for every row.
    for (int r0 = 0; r0 < tile; r0 += kRowBatch) {
      float xv[kRowBatch];
#pragma unroll
      for (int i = 0; i < kRowBatch; ++i)
        xv[i] = r0 + i < rows ? to_f32(xz[(row0 + r0 + i) * ld + ch]) : 0.f;
#pragma unroll
      for (int i = 0; i < kRowBatch; ++i) {
        const int r = r0 + i;
#pragma unroll
        for (int j = 0; j < K - 1; ++j) win[j] = win[j + 1];
        win[K - 1] = xv[i];
        if (r >= rows) {
          us[r * us_ld + ch] = from_f32<T>(0.f);
          continue;
        }
        float acc = round_to<T>(win[0] * w[0]);
#pragma unroll
        for (int j = 1; j < K; ++j) acc = round_to<T>(acc + round_to<T>(win[j] * w[j]));
        const float xc = round_to<T>(acc + bias);
        const T v = from_f32<T>(xc * sigmoid(xc));
        us[r * us_ld + ch] = v;
        u[(row0 + r) * d + ch] = v;
      }
    }
  }
  __syncthreads();
  xproj_tile(us, us_ld, tile, wx, d, nx, R, lr, lr_ld, rows, xdbl, row0);
  __syncthreads();

  for (int ch = threadIdx.x; ch < d; ch += kFrontThreads) {
    float wr[NW];
    load_wdt(wdt, ch, d, R, wr);
    const float bias = bdt[ch];
    for (int r = 0; r < rows; ++r)
      delta[(row0 + r) * d + ch] = softplus(dt_pre(lr + r * lr_ld, wr, R) + bias);
  }
}

size_t front_tile_smem(int tile, int d, int R, size_t tsize) {
  return tsize * tile * (d + 8) + sizeof(float) * tile * round4(R);
}

// Rows of a front tile: 64, or the most multiples of 16 whose rows fit in
// shared memory (0: d too wide).
int front_tile(int d, int R, size_t tsize) {
  for (int t = kFrontRows; t >= 16; t -= 16)
    if (front_tile_smem(t, d, R, tsize) <= kSmemMax) return t;
  return 0;
}

template <typename T, int K, int NW>
cudaError_t front_tile_k(const T* xz, const T* cw, const T* cb, const T* wx, const float* wdt,
                    const float* bdt, T* u, T* xdbl, float* delta, int Bt, int L, int d, int R,
                    int N, cudaStream_t s) {
  const int tile = front_tile(d, R, sizeof(T));
  if (tile == 0) return cudaErrorInvalidValue;
  const size_t smem = front_tile_smem(tile, d, R, sizeof(T));
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(mamba_front_kernel<T, K, NW>), smem);
  if (err != cudaSuccess) return err;
  mamba_front_kernel<T, K, NW><<<dim3((L + tile - 1) / tile, Bt), kFrontThreads, smem, s>>>(
      xz, cw, cb, wx, wdt, bdt, u, xdbl, delta, L, d, R, N, tile);
  return cudaGetLastError();
}

// Built for 4 and 8 taps (the wrapper pads 1-3 taps to 4 and 5-7 to 8
// with leading zeros); any d (bf16: a multiple of 16, fp32: of 8, the
// products' rows) and any dt_rank: the row-tile kernel where it holds the
// shape, else the k-step kernel.
template <typename T>
cudaError_t front(const T* xz, const T* cw, const T* cb, const T* wx, const float* wdt,
                  const float* bdt, T* u, T* xdbl, float* delta, int Bt, int L, int d, int K, int R,
                  int N, cudaStream_t s) {
  if (R <= 0 || N <= 0 || d % (sizeof(T) == 2 ? 16 : 8) || (K != 4 && K != 8) ||
      delta == nullptr)
    return cudaErrorInvalidValue;
  if (R <= kMaxR * kMaxRT && front_tile(d, R, sizeof(T)) > 0) {
    if (K == 4)
      return R <= kMaxR ? front_tile_k<T, 4, kMaxR>(xz, cw, cb, wx, wdt, bdt, u, xdbl, delta, Bt,
                                                      L, d, R, N, s)
                        : front_tile_k<T, 4, kMaxR * kMaxRT>(xz, cw, cb, wx, wdt, bdt, u, xdbl,
                                                              delta, Bt, L, d, R, N, s);
    return R <= kMaxR ? front_tile_k<T, 8, kMaxR>(xz, cw, cb, wx, wdt, bdt, u, xdbl, delta, Bt,
                                                    L, d, R, N, s)
                      : front_tile_k<T, 8, kMaxR * kMaxRT>(xz, cw, cb, wx, wdt, bdt, u, xdbl,
                                                            delta, Bt, L, d, R, N, s);
  }
  return K == 4 ? front_wide_k<T, 4>(xz, cw, cb, wx, wdt, bdt, u, xdbl, delta, Bt, L, d, R, N, s)
                : front_wide_k<T, 8>(xz, cw, cb, wx, wdt, bdt, u, xdbl, delta, Bt, L, d, R, N, s);
}

// --- delta = softplus(dt_lr W_dt + b_dt), once per (row, channel) -------------
//
// K16's delta. One block per channel tile, walking row tiles (grid.y blocks
// apart): W_dt's columns of the tile in shared memory, each row tile's
// dt_lr rows staged beside them; a thread owns a channel and sums
// kDeltaBatch rows at once, k ascending four at a time with zeros past R,
// which is `dt_pre`'s order, so delta is the bits K18's front and K17 form.
// dt_rank goes in rank tiles of kDeltaRank: up to one tile (kTiled false)
// W_dt is staged once for the whole walk; past it (kTiled) each row tile
// walks the rank tiles in order, restaging W_dt's rows of each, its running
// sums carried through delta's own slots, so that every sum keeps the one
// k-ascending chain whatever dt_rank is.
constexpr int kDeltaCh = 128;
constexpr int kDeltaRows = 32;
constexpr int kDeltaBatch = 8;
constexpr int kDeltaBlocks = 2048;   // blocks of a launch, at most
constexpr int kDeltaRank = 360;      // ranks of a tile (a multiple of 4)

__host__ __device__ constexpr int delta_ld(int R) {
  return round4(R) < kDeltaRank ? round4(R) : kDeltaRank;
}

size_t delta_smem(int R) {
  return sizeof(float) * static_cast<size_t>(delta_ld(R)) * (kDeltaCh + kDeltaRows);
}

template <bool kTiled>
__global__ void __launch_bounds__(kDeltaCh)
    delta_kernel(const float* __restrict__ lr, int ld_lr, const float* __restrict__ wdt,
                 const float* __restrict__ bdt, float* __restrict__ delta, size_t M, int d,
                 int R) {
  extern __shared__ __align__(16) float dsm[];
  const int lr_ld = round4(R), tw = delta_ld(R);
  float* ws = dsm;                          // tw x kDeltaCh
  float* lrs = ws + tw * kDeltaCh;          // kDeltaRows x (the tile's ranks)
  const int ch0 = blockIdx.x * kDeltaCh, tid = threadIdx.x, ch = ch0 + tid;
  const bool live = ch < d;
  // W_dt's rows [k0, k0 + kn) of the tile's channels.
  auto stage_w = [&](int k0, int kn) {
    for (int i = tid; i < kn * kDeltaCh; i += kDeltaCh) {
      const int k = k0 + i / kDeltaCh, c = ch0 + i % kDeltaCh;
      ws[i] = k < R && c < d ? wdt[static_cast<size_t>(k) * d + c] : 0.f;
    }
  };
  if (!kTiled) stage_w(0, lr_ld);
  const float bias = live ? bdt[ch] : 0.f;
  const size_t step = static_cast<size_t>(gridDim.y) * kDeltaRows;
  for (size_t m0 = static_cast<size_t>(blockIdx.y) * kDeltaRows; m0 < M; m0 += step) {
    for (int k0 = 0; k0 < lr_ld; k0 += kDeltaRank) {
      const int kn = kTiled ? min(kDeltaRank, lr_ld - k0) : lr_ld;
      __syncthreads();  // W_dt staged; the last tile's readers of ws and lrs are done
      if (kTiled) stage_w(k0, kn);
      for (int i = tid; i < kDeltaRows * kn; i += kDeltaCh) {
        const int r = i / kn, k = i - r * kn;
        lrs[i] = m0 + r < M && k0 + k < R ? lr[(m0 + r) * ld_lr + k0 + k] : 0.f;
      }
      __syncthreads();
      const bool last = !kTiled || k0 + kn == lr_ld;
      for (int rb = 0; rb < kDeltaRows; rb += kDeltaBatch) {
        float acc[kDeltaBatch];
#pragma unroll
        for (int e = 0; e < kDeltaBatch; ++e) {
          const size_t m = m0 + rb + e;
          acc[e] = kTiled && k0 > 0 && live && m < M ? delta[m * d + ch] : 0.f;
        }
        for (int k = 0; k < kn; k += 4) {
          const float w0 = ws[k * kDeltaCh + tid], w1 = ws[(k + 1) * kDeltaCh + tid];
          const float w2 = ws[(k + 2) * kDeltaCh + tid], w3 = ws[(k + 3) * kDeltaCh + tid];
#pragma unroll
          for (int e = 0; e < kDeltaBatch; ++e) {
            const float4 v = *reinterpret_cast<const float4*>(lrs + (rb + e) * kn + k);
            acc[e] = fmaf(v.x, w0, acc[e]);
            acc[e] = fmaf(v.y, w1, acc[e]);
            acc[e] = fmaf(v.z, w2, acc[e]);
            acc[e] = fmaf(v.w, w3, acc[e]);
          }
        }
        if (!live) continue;
#pragma unroll
        for (int e = 0; e < kDeltaBatch; ++e) {
          const size_t m = m0 + rb + e;
          if (m < M) delta[m * d + ch] = last ? softplus(acc[e] + bias) : acc[e];
        }
      }
    }
  }
}

// delta (M rows of d) from dt_lr (M rows of stride ld_lr, fp32).
cudaError_t form_delta(const float* lr, int ld_lr, const float* wdt, const float* bdt,
                       float* delta, size_t M, int d, int R, cudaStream_t s) {
  const size_t smem = delta_smem(R);
  const bool tiled = round4(R) > kDeltaRank;
  auto kern = tiled ? delta_kernel<true> : delta_kernel<false>;
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(kern), smem);
  if (err != cudaSuccess) return err;
  const int ct = (d + kDeltaCh - 1) / kDeltaCh;
  const size_t tiles = (M + kDeltaRows - 1) / kDeltaRows;
  const int gy = static_cast<int>(tiles < static_cast<size_t>(kDeltaBlocks / ct)
                                      ? tiles : kDeltaBlocks / ct > 0 ? kDeltaBlocks / ct : 1);
  kern<<<dim3(ct, gy), kDeltaCh, smem, s>>>(lr, ld_lr, wdt, bdt, delta, M, d, R);
  return cudaGetLastError();
}

// --- the scan ---------------------------------------------------------------

// States n0 .. n0 + 15 of B (or C) rows [0, n_rows) of chunk row0 into
// shared memory as fp32, kMaxN to a row (zeros past N and past `rows`), so
// that a thread reads a group's row as four float4s: the adjoint's passes
// stage one group at a time, which bounds their shared memory whatever
// d_state is.
template <typename T>
__device__ void stage_rows(const T* __restrict__ src, int ld, size_t row0, int rows, int n_rows,
                           int N, int n0, float* dst) {
  for (int i = threadIdx.x; i < n_rows * kMaxN; i += blockDim.x) {
    const int r = i / kMaxN, n = n0 + i % kMaxN;
    dst[i] = r < rows && n < N ? to_f32(src[(row0 + r) * ld + n]) : 0.f;
  }
}

__device__ __forceinline__ void load_row(const float* p, float (&v)[kMaxN]) {
#pragma unroll
  for (int i = 0; i < kMaxN; i += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + i);
    v[i] = q.x;
    v[i + 1] = q.y;
    v[i + 2] = q.z;
    v[i + 3] = q.w;
  }
}

// States n0 .. n0 + 15 of A's row of channel ch, round-tripped as
// -exp(log(-A)) and times log2 e; 0 past N (a = 1, and B = C = 0 there, so
// those states stay 0).
__device__ __forceinline__ void load_a(const float* __restrict__ A, int ch, int N, int n0,
                                       float (&a2)[kMaxN]) {
#pragma unroll
  for (int n = 0; n < kMaxN; ++n)
    a2[n] = n0 + n < N ? -expf(logf(-A[ch * N + n0 + n])) * kLog2e : 0.f;
}

}  // namespace
