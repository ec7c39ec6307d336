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
//   K21: per key, walking the query rows in order, di = sum_D(o * do) (fp32,
//        formed here from the rows of o, and written for K22), p = exp(s -
//        m) * (1 / l), ds = (do v^T - di) * p * scale, dv += round(p)^T do,
//        dk += round(ds)^T q.
//   K22: per query, walking the key blocks in order, dq += round(ds) k, with
//        K21's di.
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
// reads q, k, v, do, o, l and m and writes dk, dv and di, 714 MB (0.213
// ms); K22 reads q, k, v, do, l, m and di and writes dq (0.153 ms): bytes.
// At L = 1024 (4 x 1024 x 12) the products bound them instead (0.013 and
// 0.026 ms at the bf16 tensor rate).
//
// Three kinds of kernel, picked by the launch plan (make_plan, exported as
// ddg_flash_attention_plan; ops/flash_attention.py:flash_plan mirrors it):
// * wgmma (path 2), K20, K21 and K22 for bf16 with D = 64 and rows on
//   16-byte boundaries. One warpgroup (128 threads) a block owns 64 query
//   rows (K20, K22) or keys (K21), one wgmma M; 64 x 64 bf16 tiles in the 128-byte
//   swizzle (wgmma.cuh), copied by 16-byte cp.async; products by wgmma
//   m64n64k16 with fp32 sums. Three blocks an SM (12 warps): at L = 256
//   the bytes in flight, not the tensor rate, set the pace, and
//   one-warpgroup blocks finish and refill independently (two warpgroups
//   a block, which halve the L2 reads of K and V, and a third K20 stage
//   measured slower: PERF.md, section 6).
//   - K20 (`fwd_wgmma`, 153 registers): the Q tile is copied in with the
//     first key block; the 128-key blocks of K and V (four tiles, 32 KB)
//     stream through a two-stage ring, two blocks in flight, so at L = 256
//     a block's whole input is requested before its first product. S for
//     one library block is two n64 chains over the block's two K tiles (64
//     fp32 registers a thread); the row max is taken over all 128 keys
//     before any exp; p = 2^((s - m') log2 e) by ex2.approx (the library's
//     exp to 2 ulp; tests/test_torch_flash_tiles.py emulates the order);
//     the unnormalised p rounds to bf16 straight into register A fragments
//     of o_c = round(p) V_c (eight wgmma_rs_tb over the V tiles, MN-major
//     through the transpose bit) into its own accumulator, and acc = acc *
//     corr + o_c * inv with __fmul_rn / __fadd_rn, so nvcc contracts
//     nothing. o leaves through the Q tile's shared memory as 16-byte rows.
//   - K21 (`dkv_wgmma`, 168 registers): the block keeps its K and V tiles
//     and walks the query rows 64 at a time: the Q, dO and O tiles and the
//     rows' m and l stream through a two-stage ring. Per tile the block
//     first forms di (and 1 / l) for the 64 rows from the O and dO tiles
//     (a fixed order of fp32 products and one shuffle; the blocks of the
//     first key tile, which visit every row, causal or not, write di out
//     for K22), then S^T = K Q^T and dP^T = V dO^T by wgmma from shared
//     memory, P^T and dS^T elementwise, rounded to bf16 into register A
//     fragments for dV += P^T dO (issued before dS^T is formed) and dK +=
//     dS^T Q (B MN-major). dK and dV leave through the K and V tiles as
//     16-byte rows.
//   - K22 (`dq_wgmma`, 156 registers): the block keeps its Q and dO tiles
//     (by cp.async with the first key tile) and walks the 64-key tiles of K
//     and V in order through a three-stage ring (64 KB a block), S = Q K^T
//     and dP = dO V^T by wgmma, p = 2^((s - m) log2 e) / l and ds = (dP -
//     di) p scale rounded to bf16 straight into register A fragments of
//     dQ += round(ds) K (B MN-major). dq leaves through the Q tile as
//     16-byte rows.
//   Measured (scripts/ab_torch_attention.py, same-call A/B, NVIDIA H100
//   80GB HBM3, 700.00 W, 256 x 256 x 12 x 64): K20 0.185 ms (the mma.sync
//   kernel it replaced: 0.403), K21 with di 0.331 (the mma.sync K21 and the
//   eager di: 1.47), K22 0.217 (the mma.sync K22: 0.532); K21 + K22 0.55
//   against SDPA's backward 0.78; bounds 0.122, 0.213, 0.153 (bytes).
// * mma.sync (path 1), for bf16 with D a multiple of 16 up to 48 and rows
//   on 16-byte boundaries: 8 warps of m16n8k16. K20: a
//   block is one library query block (16 rows a warp), Q's A fragments in
//   registers, the 128-key blocks of K and V through a two-stage cp.async
//   ring, S for 128 keys in registers, P rounded into the A fragments of P
//   V. K21: a block is one library key block, K's and V's A fragments in
//   registers, the query rows streamed 64 at a time (q, do, and the rows'
//   m, 1 / l and di, di formed from o's and do's rows), S^T and dP^T by mma,
//   then dV and dK on the rounded P^T and dS^T. K22: a block is one query
//   block, Q's and dO's fragments in registers, the key rows streamed 64 at
//   a time, dQ by mma on the rounded dS. Shared-memory rows are padded by
//   16 bytes, so the ldmatrix reads of the B fragments are conflict-free.
// * CUDA cores (path 0), for fp32 and every other head width the library
//   takes up to 512: 32-row (K20) tiles, and 32-row or 32-key tiles (K21,
//   K22) that shrink to 16 past D = 256 so the fp32 tiles fit in shared
//   memory (rows padded by one float), staged synchronously, a lane per key
//   (or query) for the dot products and a lane per column for the sums.
// The mma order of each accumulator is fixed by the tiling alone.

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
constexpr int kThreads = 256;      // 8 warps (mma.sync and CUDA-core kernels)
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;          // CUDA-core tile: rows or keys
constexpr int kRows = kTile / kWarps;  // 4 a warp
constexpr int kSub = 64;           // mma.sync backward: streamed rows
constexpr int kDMax = 512;
constexpr int kMmaDMax = 64;
constexpr int kSmemMax = 232448;

// wgmma kernels (D = 64): one warpgroup a block, 64 query rows (K20) or
// keys (K21); the rings' depth and shared memory.
constexpr int kWgThreads = 128;
constexpr int kFwdStages = 2;
constexpr int kFwdStage = 4 * kTileBytes;   // a 128-key block of K, then of V
constexpr int kFwdSmem = kTileBytes + kFwdStages * kFwdStage;   // 72 KB: 3 blocks an SM
constexpr int kDkvStages = 2;
constexpr int kStatBytes = 1024;            // m, l then 1 / l, di of 64 rows, padded
constexpr int kDkvStage = 3 * kTileBytes + kStatBytes;   // Q, dO, O tiles, the rows
static_assert(kDkvStage % kSwizzleAlign == 0, "stages keep the tiles 1024-aligned");
constexpr int kDkvSmem = 2 * kTileBytes + kDkvStages * kDkvStage;   // 66 KB: 3 an SM
constexpr int kDqStages = 3;
constexpr int kDqStage = 2 * kTileBytes;    // a 64-key K tile, then its V tile
constexpr int kDqSmem = 2 * kTileBytes + kDqStages * kDqStage;   // 64 KB: 3 an SM

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

// --- wgmma helpers (D = 64, one warpgroup a block) -------------------------

// A warpgroup's 64 x 64 fp32 sums (the wgmma D layout: d[4 j + e] is row
// 16 warp + g + 8 (e >> 1), column 8 j + 2 t + (e & 1)) rounded to bf16 into
// a swizzled tile.
__device__ __forceinline__ void acc_to_tile(unsigned char* tile, const float (&acc)[32]) {
  const int lr = ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2);
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<uint32_t*>(tile + swz(lr, j) + 4 * t) =
        ddg::pack_bf16(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(tile + swz(lr + 8, j) + 4 * t) =
        ddg::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// The 64 rows of a swizzled tile to `out` (rows `ts` elements apart) as
// 16-byte rows.
__device__ __forceinline__ void tile_to_rows(const unsigned char* tile, bf16* out, size_t ts) {
  const int c = threadIdx.x & 7;
#pragma unroll
  for (int i = 0; i < kTileRows * 8 / kWgThreads; ++i) {
    const int r = (threadIdx.x >> 3) + i * (kWgThreads / 8);
    *reinterpret_cast<uint4*>(out + r * ts + c * 8) =
        *reinterpret_cast<const uint4*>(tile + swz(r, c));
  }
}

// The register A fragments (mma.sync's m16n8k16 layout, as wgmma_rs_tb
// takes them) of 16-column slice kk of a warpgroup's fp32 sums s, rounded
// to bf16: columns 16 kk .. + 15 are the n-tiles 2 kk and 2 kk + 1.
__device__ __forceinline__ void slice_to_a(const float* s, int kk, uint32_t* a) {
  const float* x = s + 8 * kk;
  a[0] = ddg::pack_bf16(x[0], x[1]);
  a[1] = ddg::pack_bf16(x[2], x[3]);
  a[2] = ddg::pack_bf16(x[4], x[5]);
  a[3] = ddg::pack_bf16(x[6], x[7]);
}

// ---------------------------------------------------------------------------
// K20, the forward
// ---------------------------------------------------------------------------

// wgmma: one warpgroup a block per (64 query rows, head, batch); a thread
// holds rows r0 and r0 + 8 of S, o_c and acc (the wgmma D layout).
__global__ void __launch_bounds__(kWgThreads, 3)
    fwd_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lo,
              float* __restrict__ mo, int L, int H, int tq, int tk, int tv, int causal,
              float scale) {
  // The Q tile, then kFwdStages stages of (K tiles 0-1, V tiles 0-1), each
  // tile 1024-aligned (the dynamic shared memory's base is: the kernel
  // traps if not).
  extern __shared__ __align__(1024) unsigned char smem_tiles[];
  unsigned char* const smem = smem_tiles;
  const uint32_t base = smem_addr(smem);
  if (base % kSwizzleAlign) __trap();
  const int q0 = blockIdx.x * kTileRows, h = blockIdx.y, b = blockIdx.z;
  const int nk = L / kBlock;
  const int c_end = causal ? q0 / kBlock + 1 : nk;
  const bf16* qh = q + static_cast<size_t>(b) * L * tq + h * kMmaD;
  const bf16* kh = k + static_cast<size_t>(b) * L * tk + h * kMmaD;
  const bf16* vh = v + static_cast<size_t>(b) * L * tv + h * kMmaD;
  auto stage = [&](int c) { return base + kTileBytes + (c % kFwdStages) * kFwdStage; };
  // One commit group a key block (empty past the last).
  auto issue = [&](int c) {
    if (c < c_end) {
      const uint32_t s = stage(c);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int key = c * kBlock + i * kTileRows;
        load_tile<kWgThreads>(s + i * kTileBytes, kh, tk, key, L);
        load_tile<kWgThreads>(s + (2 + i) * kTileBytes, vh, tv, key, L);
      }
    }
    cp_async_commit();
  };
  load_tile<kWgThreads>(base, qh, tq, q0, L);
#pragma unroll
  for (int c = 0; c < kFwdStages; ++c) issue(c);   // Q joins block 0's group

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16 + g;
  const uint32_t qs = base;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float m_prev[2] = {-INFINITY, -INFINITY}, l_prev[2] = {0.f, 0.f};

  for (int c = 0; c < c_end; ++c) {
    cp_async_wait<kFwdStages - 1>();
    fence_async_smem();
    __syncthreads();
    const uint32_t ks = stage(c), vs = ks + 2 * kTileBytes;

    // S for the block's 128 keys: keys 0-63 in sa, 64-127 in sb.
    float sa[32], sb[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sa[i] = sb[i] = 0.f;
    fence_regs(sa);
    fence_regs(sb);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kMmaD / 16; ++kk)
      wgmma_ss(sa, desc_b128(qs + 32 * kk), desc_b128(ks + 32 * kk));
#pragma unroll
    for (int kk = 0; kk < kMmaD / 16; ++kk)
      wgmma_ss(sb, desc_b128(qs + 32 * kk), desc_b128(ks + kTileBytes + 32 * kk));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sa);
    fence_regs(sb);

    // Scale, mask (the diagonal block under `causal`), and the row max over
    // all 128 keys.
    const bool diag = causal && c == c_end - 1;
    float mx[2] = {-INFINITY, -INFINITY};
    auto prep = [&](float (&s)[32], int key0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i >> 1) & 1;
        float x = __fmul_rn(s[i], scale);
        if (diag && key0 + 8 * (i >> 2) + 2 * t + (i & 1) > r0 + 8 * hh) x = -INFINITY;
        s[i] = x;
        mx[hh] = fmaxf(mx[hh], x);
      }
    };
    prep(sa, c * kBlock);
    prep(sb, c * kBlock + kTileRows);
    float mn[2], sum[2] = {0.f, 0.f}, corr[2], inv[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = quad_max(mx[hh]);
      mn[hh] = nk == 1 ? mx[hh] : fmaxf(m_prev[hh], mx[hh]);
    }
    auto expo = [&](float (&s)[32]) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i >> 1) & 1;
        s[i] = ex2(__fmul_rn(__fsub_rn(s[i], mn[hh]), kLog2e));
        sum[hh] += s[i];
      }
    };
    expo(sa);
    expo(sb);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) sum[hh] = quad_sum(sum[hh]);
    if (nk == 1) {
      // The single-step kernel: p = exp(s - m) / l, then rounded.
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        sa[i] = sa[i] / sum[(i >> 1) & 1];
        sb[i] = sb[i] / sum[(i >> 1) & 1];
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        m_prev[hh] = mn[hh];
        l_prev[hh] = sum[hh];
        corr[hh] = 0.f;
        inv[hh] = 1.f;
      }
    } else {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float l_corr = __fmul_rn(expf(m_prev[hh] - mn[hh]), l_prev[hh]);
        const float l_next = sum[hh] + l_corr;
        inv[hh] = l_next == 0.f ? 1.f : 1.f / l_next;
        corr[hh] = __fmul_rn(l_corr, inv[hh]);
        m_prev[hh] = mn[hh];
        l_prev[hh] = l_next;
      }
    }

    // o_c = round(p) V_c over the 128 keys: eight k-slices of 16, A from
    // registers, V's tiles MN-major.
    uint32_t pa[32];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      slice_to_a(sa, kk, pa + 4 * kk);
      slice_to_a(sb, kk, pa + 16 + 4 * kk);
    }
    float oc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) oc[i] = 0.f;
    fence_regs(pa);
    fence_regs(oc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_rs_tb(oc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                  desc_b128(vs + (kk >> 2) * kTileBytes + (kk & 3) * 16 * 128));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(oc);
    fence_regs(pa);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1;
      acc[i] = __fadd_rn(__fmul_rn(acc[i], corr[hh]), __fmul_rn(oc[i], inv[hh]));
    }
    __syncthreads();   // every warp is done with the stage
    issue(c + kFwdStages);
  }

  // o rounded into the Q tile, then 16-byte rows; l and m.
  acc_to_tile(smem, acc);
  if (t == 0) {
    const size_t i = (static_cast<size_t>(b) * H + h) * L + r0;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      lo[i + 8 * hh] = l_prev[hh];
      mo[i + 8 * hh] = m_prev[hh];
    }
  }
  __syncthreads();
  const size_t to = static_cast<size_t>(H) * kMmaD;
  tile_to_rows(smem, o + (static_cast<size_t>(b) * L + q0) * to + h * kMmaD, to);
}

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
// K21, dK and dV (and di)
// ---------------------------------------------------------------------------

// wgmma: one warpgroup a block per (64 keys, head, batch), the M of its
// products (S^T[4 j + e] is key r0 + 8 (e >> 1), query i0 + 8 j + 2 t + (e &
// 1)). The block walks the query tiles in order; o and do are contiguous
// (B, L, H, 64).
__global__ void __launch_bounds__(kWgThreads, 3)
    dkv_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const float* __restrict__ lg,
              const float* __restrict__ mg, const bf16* __restrict__ dO,
              const bf16* __restrict__ o, bf16* __restrict__ dk, bf16* __restrict__ dv,
              float* __restrict__ dig, int L, int H, int tq, int tk, int tv, int causal,
              float scale) {
  constexpr int S = kDkvStages;
  // The K tile, the V tile, then S stages of (Q tile, dO tile, O tile, the
  // rows' m, l and di).
  extern __shared__ __align__(1024) unsigned char smem_tiles[];
  unsigned char* const smem = smem_tiles;
  const uint32_t base = smem_addr(smem);
  if (base % kSwizzleAlign) __trap();
  const int k0 = blockIdx.x * kTileRows, h = blockIdx.y, b = blockIdx.z;
  const size_t to = static_cast<size_t>(H) * kMmaD;
  const bf16* qh = q + static_cast<size_t>(b) * L * tq + h * kMmaD;
  const bf16* kh = k + static_cast<size_t>(b) * L * tk + h * kMmaD;
  const bf16* vh = v + static_cast<size_t>(b) * L * tv + h * kMmaD;
  const size_t head = static_cast<size_t>(b) * L * to + h * kMmaD;
  const size_t stats = (static_cast<size_t>(b) * H + h) * L;
  // Under `causal` the query tiles wholly before the block's first key are
  // skipped; the first key tile's blocks visit every row.
  const int first = causal ? k0 / kTileRows : 0;
  const int n_steps = L / kTileRows - first;
  auto q0_of = [&](int step) { return (first + step) * kTileRows; };
  auto stage = [&](int step) { return base + 2 * kTileBytes + (step % S) * kDkvStage; };
  // One commit group a step (empty past the last): the three tiles, and
  // the rows' m and l (two runs of 64 floats).
  auto issue = [&](int step) {
    if (step < n_steps) {
      const uint32_t sb = stage(step);
      const int i0 = q0_of(step);
      load_tile<kWgThreads>(sb, qh, tq, i0, L);
      load_tile<kWgThreads>(sb + kTileBytes, dO + head, H * kMmaD, i0, L);
      load_tile<kWgThreads>(sb + 2 * kTileBytes, o + head, H * kMmaD, i0, L);
      if (threadIdx.x < 32) {
        const int which = threadIdx.x >> 4, j = threadIdx.x & 15;
        cp_async16(sb + 3 * kTileBytes + which * 256 + j * 16,
                   (which ? lg : mg) + stats + i0 + 4 * j, true);
      }
    }
    cp_async_commit();
  };
  load_tile<kWgThreads>(base, kh, tk, k0, L);
  load_tile<kWgThreads>(base + kTileBytes, vh, tv, k0, L);
#pragma unroll
  for (int s = 0; s < S - 1; ++s) issue(s);   // K and V join the first group

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t ks = base, vs = base + kTileBytes;
  const int r0 = k0 + warp * 16 + g;
  // di: TPR threads a row, each over 8 / TPR of its 16-byte chunks.
  constexpr int TPR = kWgThreads / kTileRows;
  const int di_row = threadIdx.x / TPR, di_part = threadIdx.x % TPR;

  float dv_acc[32], dk_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dv_acc[i] = dk_acc[i] = 0.f;
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<S - 2>();
    fence_async_smem();
    __syncthreads();
    issue(step + S - 1);   // into the stage step - 1 used
    const uint32_t sb = stage(step);
    const int i0 = q0_of(step);
    unsigned char* const tiles = smem + (sb - base);
    float* const st = reinterpret_cast<float*>(tiles + 3 * kTileBytes);   // m, l, di

    // di = sum_D(o * do) of the tile's rows, and 1 / l in place of l.
    {
      float part = 0.f;
#pragma unroll
      for (int c = di_part * (8 / TPR); c < (di_part + 1) * (8 / TPR); ++c) {
        float x[8], y[8];
        ddg::load16(reinterpret_cast<const bf16*>(tiles + 2 * kTileBytes + swz(di_row, c)), x);
        ddg::load16(reinterpret_cast<const bf16*>(tiles + kTileBytes + swz(di_row, c)), y);
#pragma unroll
        for (int e = 0; e < 8; ++e) part = fmaf(x[e], y[e], part);
      }
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
      if (di_part == 0) {
        st[2 * kTileRows + di_row] = part;
        st[kTileRows + di_row] = 1.f / st[kTileRows + di_row];
        if (blockIdx.x == 0) dig[stats + i0 + di_row] = part;
      }
    }
    __syncthreads();
    if (causal && i0 + kTileRows - 1 < k0) continue;   // every key past every query

    // S^T = K Q^T and dP^T = V dO^T, both operands K-major in shared memory.
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kMmaD / 16; ++kk)
      wgmma_ss(s, desc_b128(ks + 32 * kk), desc_b128(sb + 32 * kk));
#pragma unroll
    for (int kk = 0; kk < kMmaD / 16; ++kk)
      wgmma_ss(dp, desc_b128(vs + 32 * kk), desc_b128(sb + kTileBytes + 32 * kk));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    fence_regs(dp);

    // P^T (kept in s) and its bf16 fragments; keys past a query give p = 0.
    const bool diag = causal && i0 < k0 + kTileRows - 1;
    uint32_t pa[16], da[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float2 mq = *reinterpret_cast<const float2*>(st + col);
      const float2 iq = *reinterpret_cast<const float2*>(st + kTileRows + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = __fmul_rn(s[4 * j + e], scale);
        float p = ex2(__fmul_rn(__fsub_rn(x, e & 1 ? mq.y : mq.x), kLog2e)) *
                  (e & 1 ? iq.y : iq.x);
        if (diag && r0 + 8 * (e >> 1) > i0 + col + (e & 1)) p = 0.f;
        s[4 * j + e] = p;
      }
      const int a = 4 * (j >> 1) + 2 * (j & 1);
      pa[a] = ddg::pack_bf16(s[4 * j], s[4 * j + 1]);
      pa[a + 1] = ddg::pack_bf16(s[4 * j + 2], s[4 * j + 3]);
    }
    // dV += round(P^T) dO while dS^T is formed.
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
      const float2 dq2 = *reinterpret_cast<const float2*>(st + 2 * kTileRows + 8 * j + 2 * t);
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[e] = __fmul_rn(__fmul_rn(dp[4 * j + e] - (e & 1 ? dq2.y : dq2.x), s[4 * j + e]),
                          scale);
      const int a = 4 * (j >> 1) + 2 * (j & 1);
      da[a] = ddg::pack_bf16(ds[0], ds[1]);
      da[a + 1] = ddg::pack_bf16(ds[2], ds[3]);
    }
    // dK += round(dS^T) Q.
    fence_regs(da);
    fence_regs(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_tb(dk_acc, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3],
                  desc_b128(sb + kk * 16 * 128));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(pa);
    fence_regs(da);
  }

  // dk into the K tile, dv into the V tile, rounded; then 16-byte rows.
  cp_async_wait<0>();
  __syncthreads();   // every warp is done reading the K and V tiles
  acc_to_tile(smem, dk_acc);
  acc_to_tile(smem + kTileBytes, dv_acc);
  __syncthreads();
  tile_to_rows(smem, dk + head + k0 * to, to);
  tile_to_rows(smem + kTileBytes, dv + head + k0 * to, to);
}

// m, 1 / l and di = sum_D(o * do) (fp32, the row's products in order) of
// the kSub query rows from `at` into st ([3][kSub]), by the block's first
// kSub threads; with `di_out`, di also goes there.
template <int D>
__device__ __forceinline__ void stage_stats(float* st, const float* mg, const float* lg,
                                            const bf16* orow, const bf16* drow, size_t to,
                                            size_t at, float* di_out) {
  if (threadIdx.x < kSub) {
    const int r = threadIdx.x;
    st[r] = mg[at + r];
    st[kSub + r] = 1.f / lg[at + r];
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < D; d += 8) {
      float x[8], y[8];
      ddg::load16(orow + r * to + d, x);
      ddg::load16(drow + r * to + d, y);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc = fmaf(x[e], y[e], acc);
    }
    st[2 * kSub + r] = acc;
    if (di_out) di_out[at + r] = acc;
  }
}

template <int DK>
__global__ void __launch_bounds__(kThreads) dkv_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ lg, const float* __restrict__ mg, const bf16* __restrict__ dO,
    const bf16* __restrict__ o, bf16* __restrict__ dk, bf16* __restrict__ dv,
    float* __restrict__ dig, int L, int H, int tq, int tk, int tv, int causal, float scale) {
  constexpr int D = 16 * DK, LD = D + 8, NT = D / 8;
  constexpr int kStage = 2 * kSub * LD;   // bf16: a sub-tile of q, then of do
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* stage0 = reinterpret_cast<bf16*>(smem_raw);               // two stages
  float* st0 = reinterpret_cast<float*>(stage0 + 2 * kStage);     // two [3][kSub]
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const size_t bL = static_cast<size_t>(b) * L, hD = static_cast<size_t>(h) * D;
  const size_t stats = (static_cast<size_t>(b) * H + h) * L;
  const size_t to = static_cast<size_t>(H) * D;
  float* const di_out = c == 0 ? dig : nullptr;   // the first key block visits every row
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
  stage_stats<D>(st0, mg, lg, o + (bL + q_begin) * to + hD, dO + (bL + q_begin) * to + hD, to,
                 stats + q_begin, di_out);
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
    if (it + 1 < n_sub)
      stage_stats<D>(st0 + ((it + 1) & 1) * 3 * kSub, mg, lg, o + (bL + q0 + kSub) * to + hD,
                     dO + (bL + q0 + kSub) * to + hD, to, stats + q0 + kSub, di_out);
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

// KR = keys a warp owns: 4 (32 a block) up to D = 256, 2 (16) past it.
template <typename T, int DC, int KR>
__global__ void __launch_bounds__(kThreads) dkv_core(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ lg, const float* __restrict__ mg, const T* __restrict__ dO,
    const T* __restrict__ o, T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dig,
    int L, int H, int D, int tq, int tk, int tv, int causal, float scale) {
  constexpr int kOwn = kWarps * KR;
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* Ks = smem;                 // [kOwn][ld]: the block's keys
  float* Vs = Ks + kOwn * ld;       // [kOwn][ld]
  float* Qs = Vs + kOwn * ld;       // [32][ld]: a query sub-tile
  float* Os = Qs + kTile * ld;      // [32][ld]: its dO
  float* Ps = Os + kTile * ld;      // [kOwn keys][33]: round(p)^T
  float* Ds = Ps + kOwn * 33;       // [kOwn keys][33]: round(ds)^T
  float* st = Ds + kOwn * 33;       // m, 1 / l, di of the 32 queries
  const int key0 = blockIdx.x * kOwn, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = key0 / kBlock, nq = L / kBlock;
  const size_t bL = static_cast<size_t>(b) * L, hD = static_cast<size_t>(h) * D;
  const size_t stats = (static_cast<size_t>(b) * H + h) * L;
  const size_t to = static_cast<size_t>(H) * D;
  stage_f32(Ks, ld, k + (bL + key0) * tk + hD, tk, kOwn, D);
  stage_f32(Vs, ld, v + (bL + key0) * tv + hD, tv, kOwn, D);

  float dka[KR][DC], dva[KR][DC];
#pragma unroll
  for (int i = 0; i < KR; ++i)
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) dka[i][cc] = dva[i][cc] = 0.f;

  for (int r = causal ? c : 0; r < nq; ++r)
    for (int sub = 0; sub < kBlock / kTile; ++sub) {
      const int q0 = r * kBlock + sub * kTile;
      __syncthreads();
      stage_f32(Qs, ld, q + (bL + q0) * tq + hD, tq, kTile, D);
      stage_f32(Os, ld, dO + (bL + q0) * to + hD, to, kTile, D);
      if (threadIdx.x < kTile) {
        st[threadIdx.x] = mg[stats + q0 + threadIdx.x];
        st[kTile + threadIdx.x] = 1.f / lg[stats + q0 + threadIdx.x];
      }
      // di of the sub-tile's rows, a warp a row: lanes over D, then the
      // warp's sum; the first key tile's blocks write it out.
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int rw = warp * kRows + i;
        const size_t at = (bL + q0 + rw) * to + hD;
        float acc = 0.f;
        for (int d = lane; d < D; d += 32)
          acc = fmaf(ddg::to_f32(o[at + d]), ddg::to_f32(dO[at + d]), acc);
        acc = ddg::warp_sum(acc);
        if (lane == 0) {
          st[2 * kTile + rw] = acc;
          if (blockIdx.x == 0) dig[stats + q0 + rw] = acc;
        }
      }
      __syncthreads();
      // Lane j: query q0 + j against the warp's KR keys.
#pragma unroll
      for (int i = 0; i < KR; ++i) {
        const int kl = warp * KR + i;
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
        for (int i = 0; i < KR; ++i) {
          const float p = Ps[(warp * KR + i) * 33 + j];
          const float ds = Ds[(warp * KR + i) * 33 + j];
#pragma unroll
          for (int cc = 0; cc < DC; ++cc) {
            dva[i][cc] = fmaf(p, ov[cc], dva[i][cc]);
            dka[i][cc] = fmaf(ds, qv[cc], dka[i][cc]);
          }
        }
      }
    }

#pragma unroll
  for (int i = 0; i < KR; ++i) {
    const size_t at = ((bL + key0 + warp * KR + i) * H + h) * D;
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

// wgmma: one warpgroup a block per (64 query rows, head, batch), the M of
// its products (S[4 j + e] is row r0 + 8 (e >> 1), key k0 + 8 j + 2 t + (e &
// 1)). The block keeps its Q and dO tiles and walks the 64-key tiles of K
// and V in order through a three-stage ring; dO and dq are contiguous (B,
// L, H, 64).
__global__ void __launch_bounds__(kWgThreads, 3)
    dq_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const float* __restrict__ lg,
             const float* __restrict__ mg, const bf16* __restrict__ dO,
             const float* __restrict__ dig, bf16* __restrict__ dq, int L, int H, int tq, int tk,
             int tv, int causal, float scale) {
  constexpr int S = kDqStages;
  // The Q tile, the dO tile, then S stages of (K tile, V tile).
  extern __shared__ __align__(1024) unsigned char smem_tiles[];
  unsigned char* const smem = smem_tiles;
  const uint32_t base = smem_addr(smem);
  if (base % kSwizzleAlign) __trap();
  const int q0 = blockIdx.x * kTileRows, h = blockIdx.y, b = blockIdx.z;
  const size_t to = static_cast<size_t>(H) * kMmaD;
  const bf16* qh = q + static_cast<size_t>(b) * L * tq + h * kMmaD;
  const bf16* kh = k + static_cast<size_t>(b) * L * tk + h * kMmaD;
  const bf16* vh = v + static_cast<size_t>(b) * L * tv + h * kMmaD;
  const size_t head = static_cast<size_t>(b) * L * to + h * kMmaD;
  const size_t stats = (static_cast<size_t>(b) * H + h) * L;
  // Under `causal` the key tiles up to the diagonal one.
  const int n_steps = causal ? q0 / kTileRows + 1 : L / kTileRows;
  auto stage = [&](int step) { return base + 2 * kTileBytes + (step % S) * kDqStage; };
  // One commit group a key tile (empty past the last).
  auto issue = [&](int step) {
    if (step < n_steps) {
      const uint32_t sb = stage(step);
      load_tile<kWgThreads>(sb, kh, tk, step * kTileRows, L);
      load_tile<kWgThreads>(sb + kTileBytes, vh, tv, step * kTileRows, L);
    }
    cp_async_commit();
  };
  load_tile<kWgThreads>(base, qh, tq, q0, L);
  load_tile<kWgThreads>(base + kTileBytes, dO + head, H * kMmaD, q0, L);
#pragma unroll
  for (int s = 0; s < S - 1; ++s) issue(s);   // Q and dO join the first group

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16 + g;
  float m[2], il[2], di[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    m[hh] = mg[stats + r0 + 8 * hh];
    il[hh] = 1.f / lg[stats + r0 + 8 * hh];
    di[hh] = dig[stats + r0 + 8 * hh];
  }
  float dq_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq_acc[i] = 0.f;
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<S - 2>();
    fence_async_smem();
    __syncthreads();
    issue(step + S - 1);   // into the stage step - 1 used
    const uint32_t ks = stage(step), vs = ks + kTileBytes;
    const int k0 = step * kTileRows;

    // S = Q K^T and dP = dO V^T, both operands K-major in shared memory.
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kMmaD / 16; ++kk)
      wgmma_ss(s, desc_b128(base + 32 * kk), desc_b128(ks + 32 * kk));
#pragma unroll
    for (int kk = 0; kk < kMmaD / 16; ++kk)
      wgmma_ss(dp, desc_b128(base + kTileBytes + 32 * kk), desc_b128(vs + 32 * kk));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    fence_regs(dp);

    // p = exp(s - m) (1 / l), ds = (dP - di) p scale, rounded to bf16 into
    // register A fragments; keys past a row give ds = 0.
    const bool diag = causal && step == n_steps - 1;
    uint32_t da[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        const float x = __fmul_rn(s[4 * j + e], scale);
        const float p = ex2(__fmul_rn(__fsub_rn(x, m[hh]), kLog2e)) * il[hh];
        ds[e] = __fmul_rn(__fmul_rn(dp[4 * j + e] - di[hh], p), scale);
        if (diag && k0 + 8 * j + 2 * t + (e & 1) > r0 + 8 * hh) ds[e] = 0.f;
      }
      const int a = 4 * (j >> 1) + 2 * (j & 1);
      da[a] = ddg::pack_bf16(ds[0], ds[1]);
      da[a + 1] = ddg::pack_bf16(ds[2], ds[3]);
    }
    // dQ += round(dS) K, B MN-major (keys are the reduction).
    fence_regs(da);
    fence_regs(dq_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_tb(dq_acc, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3],
                  desc_b128(ks + kk * 16 * 128));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(dq_acc);
    fence_regs(da);
  }

  // dq into the Q tile, rounded; then 16-byte rows.
  cp_async_wait<0>();
  __syncthreads();   // every warp is done reading the Q tile
  acc_to_tile(smem, dq_acc);
  __syncthreads();
  tile_to_rows(smem, dq + head + q0 * to, to);
}

// KR = rows a warp owns: 4 (32 a block) up to D = 256, 2 (16) past it.
template <typename T, int DC, int KR>
__global__ void __launch_bounds__(kThreads) dq_core(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ lg, const float* __restrict__ mg, const T* __restrict__ dO,
    const float* __restrict__ dig, T* __restrict__ dq, int L, int H, int D, int tq, int tk,
    int tv, int causal, float scale) {
  constexpr int kOwn = kWarps * KR;
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* Qs = smem;               // [kOwn][ld]: the block's rows
  float* Os = Qs + kOwn * ld;     // [kOwn][ld]: their dO
  float* Ks = Os + kOwn * ld;     // [32][ld]: a key sub-tile
  float* Vs = Ks + kTile * ld;    // [32][ld]
  float* Ds = Vs + kTile * ld;    // [kOwn rows][33]: round(ds)
  const int row0 = blockIdx.x * kOwn, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = row0 / kBlock, nk = L / kBlock;
  const size_t bL = static_cast<size_t>(b) * L, hD = static_cast<size_t>(h) * D;
  const size_t stats = (static_cast<size_t>(b) * H + h) * L;
  stage_f32(Qs, ld, q + (bL + row0) * tq + hD, tq, kOwn, D);
  stage_f32(Os, ld, dO + (bL + row0) * H * D + hD, static_cast<size_t>(H) * D, kOwn, D);
  float m[KR], il[KR], di[KR], dqa[KR][DC];
#pragma unroll
  for (int i = 0; i < KR; ++i) {
    const size_t ix = stats + row0 + warp * KR + i;
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
      // Lane j: key key0 + j against the warp's KR rows.
#pragma unroll
      for (int i = 0; i < KR; ++i) {
        const int rl = warp * KR + i;
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
        for (int i = 0; i < KR; ++i) {
          const float ds = Ds[(warp * KR + i) * 33 + j];
#pragma unroll
          for (int cc = 0; cc < DC; ++cc) dqa[i][cc] = fmaf(ds, kv[cc], dqa[i][cc]);
        }
      }
    }

#pragma unroll
  for (int i = 0; i < KR; ++i) {
    T* out = dq + ((bL + row0 + warp * KR + i) * H + h) * D;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) {
      const int d = lane + 32 * cc;
      if (d < D) out[d] = ddg::from_f32<T>(dqa[i][cc]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch plan and launches
// ---------------------------------------------------------------------------

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// What the library takes at 128-blocks, and the kernels' own limits.
bool shape_ok(int B, int L, int H, int D) {
  if (B <= 0 || H <= 0 || B > 65535 || H > 65535 || D <= 0 || D > kDMax) return false;
  return !(L < kBlock || L % kBlock || (L > kBlock && D > kBlock && D % kBlock));
}

// Rows (K20, K22) or keys (K21) a CUDA-core block owns.
int core_rows(int D) { return D <= 256 ? kTile : kTile / 2; }

int col_groups(int D) {
  return D <= 32 ? 1 : D <= 64 ? 2 : D <= 128 ? 4 : D <= 256 ? 8 : 16;
}

// One kernel's launch: path (2 wgmma, 1 mma.sync, 0 CUDA cores), the rows
// or keys a block owns (`tile`), the rows or keys it takes a step
// (`step`), ring stages (1: staged synchronously), dynamic shared bytes,
// threads and grid.
struct Launch {
  int path, tile, step, stages, smem, threads, gx, gy, gz;
};

struct Plan {
  Launch fwd, dkv, dq;
};

// `tc`: bf16 with every row on a 16-byte boundary.
int make_plan(int B, int L, int H, int D, bool tc, Plan* p) {
  if (!shape_ok(B, L, H, D)) return cudaErrorInvalidValue;
  const bool mma = tc && D % 16 == 0 && D <= kMmaDMax;
  const bool wg = mma && D == kMmaD;
  const int pad = (D + 8) * 2;   // a padded bf16 row
  const int own = core_rows(D);
  if (wg)
    p->fwd = {2, kTileRows, kBlock, kFwdStages, kFwdSmem, kWgThreads, L / kTileRows, H, B};
  else if (mma)
    p->fwd = {1, kBlock, kBlock, 2, 4 * kBlock * pad, kThreads, L / kBlock, H, B};
  else
    p->fwd = {0, kTile, kTile, 1, 4 * (2 * kTile * (D + 1) + kTile * kBlock), kThreads,
              L / kTile, H, B};
  if (wg)
    p->dkv = {2, kTileRows, kTileRows, kDkvStages, kDkvSmem, kWgThreads, L / kTileRows, H, B};
  else if (mma)
    p->dkv = {1, kBlock, kSub, 2, 2 * (2 * kSub * pad + 3 * kSub * 4), kThreads, L / kBlock, H,
              B};
  else
    p->dkv = {0, own, kTile, 1,
              4 * (2 * own * (D + 1) + 2 * kTile * (D + 1) + 2 * own * 33 + 3 * kTile), kThreads,
              L / own, H, B};
  if (wg)
    p->dq = {2, kTileRows, kTileRows, kDqStages, kDqSmem, kWgThreads, L / kTileRows, H, B};
  else if (mma)
    p->dq = {1, kBlock, kSub, 2, 4 * kSub * pad, kThreads, L / kBlock, H, B};
  else
    p->dq = {0, own, kTile, 1, 4 * (2 * own * (D + 1) + 2 * kTile * (D + 1) + own * 33),
             kThreads, L / own, H, B};
  for (const Launch* l : {&p->fwd, &p->dkv, &p->dq})
    if (l->smem > kSmemMax) return cudaErrorInvalidValue;
  return cudaSuccess;
}

// Rows on 16-byte boundaries: every pointer aligned and every token stride
// a multiple of 8 elements.
bool rows_aligned(int tq, int tk, int tv, std::initializer_list<const void*> ptrs) {
  if (tq % 8 || tk % 8 || tv % 8) return false;
  for (const void* p : ptrs)
    if (!aligned16(p)) return false;
  return true;
}

template <typename K, typename... A>
int launch(K kernel, const Launch& l, cudaStream_t s, A... args) {
  int err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, l.smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(l.gx, l.gy, l.gz), l.threads, l.smem, s>>>(args...);
  return cudaGetLastError();
}

// The launch body for each instantiated head width (variadic: the body
// holds commas). CUDA cores: DC columns a lane, KR rows or keys a warp.
#define DDG_FLASH_CORE_SWITCH(D, ...)                                     \
  switch (col_groups(D)) {                                                \
    case 1: { constexpr int DC = 1, KR = 4; __VA_ARGS__ }                 \
    case 2: { constexpr int DC = 2, KR = 4; __VA_ARGS__ }                 \
    case 4: { constexpr int DC = 4, KR = 4; __VA_ARGS__ }                 \
    case 8: { constexpr int DC = 8, KR = 4; __VA_ARGS__ }                 \
    default: { constexpr int DC = 16, KR = 2; __VA_ARGS__ }               \
  }

// mma.sync: DK k-steps of 16 over D, up to `DMAX` / 16.
#define DDG_FLASH_MMA_SWITCH(D, DMAX, ...)                                \
  switch (D / 16) {                                                       \
    case 1: { constexpr int DK = 1; __VA_ARGS__ }                         \
    case 2: { constexpr int DK = 2; __VA_ARGS__ }                         \
    case 3: { constexpr int DK = 3; __VA_ARGS__ }                         \
    default: { constexpr int DK = DMAX / 16; __VA_ARGS__ }                \
  }

template <typename T>
int fwd(const void* q, const void* k, const void* v, void* o, void* l, void* m, int B, int L,
        int H, int D, int tq, int tk, int tv, int causal, float scale, cudaStream_t s,
        int* path) {
  if (tq < H * D || tk < H * D || tv < H * D) return cudaErrorInvalidValue;
  Plan p;
  const bool tc = std::is_same<T, bf16>::value && rows_aligned(tq, tk, tv, {q, k, v, o});
  int err = make_plan(B, L, H, D, tc, &p);
  if (err != cudaSuccess) return err;
  *path = p.fwd.path;
  float* lp = static_cast<float*>(l);
  float* mp = static_cast<float*>(m);
  if (p.fwd.path == 2)
    return launch(fwd_wgmma, p.fwd, s, static_cast<const bf16*>(q),
                  static_cast<const bf16*>(k), static_cast<const bf16*>(v), static_cast<bf16*>(o),
                  lp, mp, L, H, tq, tk, tv, causal, scale);
  if (p.fwd.path == 1) {
    DDG_FLASH_MMA_SWITCH(D, 48, {
      return launch(fwd_mma<DK>, p.fwd, s, static_cast<const bf16*>(q),
                    static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                    static_cast<bf16*>(o), lp, mp, L, H, tq, tk, tv, causal, scale);
    })
  }
  DDG_FLASH_CORE_SWITCH(D, {
    return launch(fwd_core<T, DC>, p.fwd, s, static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<T*>(o), lp, mp, L, H, D, tq, tk, tv,
                  causal, scale);
  })
}

template <typename T>
int bwd_dkv(const void* q, const void* k, const void* v, const void* l, const void* m,
            const void* dO, const void* o, void* dk, void* dv, void* di, int B, int L, int H,
            int D, int tq, int tk, int tv, int causal, float scale, cudaStream_t s, int* path) {
  if (tq < H * D || tk < H * D || tv < H * D) return cudaErrorInvalidValue;
  Plan p;
  const bool tc = std::is_same<T, bf16>::value &&
                  rows_aligned(tq, tk, tv, {q, k, v, dO, o, dk, dv});
  int err = make_plan(B, L, H, D, tc, &p);
  if (err != cudaSuccess) return err;
  *path = p.dkv.path;
  const float* lp = static_cast<const float*>(l);
  const float* mp = static_cast<const float*>(m);
  float* dp = static_cast<float*>(di);
  using P = const bf16*;
  if (p.dkv.path == 2)
    return launch(dkv_wgmma, p.dkv, s, static_cast<P>(q), static_cast<P>(k),
                  static_cast<P>(v), lp, mp, static_cast<P>(dO), static_cast<P>(o),
                  static_cast<bf16*>(dk), static_cast<bf16*>(dv), dp, L, H, tq, tk, tv, causal,
                  scale);
  if (p.dkv.path == 1) {
    DDG_FLASH_MMA_SWITCH(D, 48, {
      return launch(dkv_mma<DK>, p.dkv, s, static_cast<P>(q), static_cast<P>(k),
                    static_cast<P>(v), lp, mp, static_cast<P>(dO), static_cast<P>(o),
                    static_cast<bf16*>(dk), static_cast<bf16*>(dv), dp, L, H, tq, tk, tv,
                    causal, scale);
    })
  }
  DDG_FLASH_CORE_SWITCH(D, {
    return launch(dkv_core<T, DC, KR>, p.dkv, s, static_cast<const T*>(q),
                  static_cast<const T*>(k), static_cast<const T*>(v), lp, mp,
                  static_cast<const T*>(dO), static_cast<const T*>(o), static_cast<T*>(dk),
                  static_cast<T*>(dv), dp, L, H, D, tq, tk, tv, causal, scale);
  })
}

template <typename T>
int bwd_dq(const void* q, const void* k, const void* v, const void* l, const void* m,
           const void* dO, const void* di, void* dq, int B, int L, int H, int D, int tq,
           int tk, int tv, int causal, float scale, cudaStream_t s, int* path) {
  if (tq < H * D || tk < H * D || tv < H * D) return cudaErrorInvalidValue;
  Plan p;
  const bool tc = std::is_same<T, bf16>::value && rows_aligned(tq, tk, tv, {q, k, v, dO, dq});
  int err = make_plan(B, L, H, D, tc, &p);
  if (err != cudaSuccess) return err;
  *path = p.dq.path;
  const float* lp = static_cast<const float*>(l);
  const float* mp = static_cast<const float*>(m);
  const float* dp = static_cast<const float*>(di);
  using P = const bf16*;
  if (p.dq.path == 2)
    return launch(dq_wgmma, p.dq, s, static_cast<P>(q), static_cast<P>(k), static_cast<P>(v),
                  lp, mp, static_cast<P>(dO), dp, static_cast<bf16*>(dq), L, H, tq, tk, tv,
                  causal, scale);
  if (p.dq.path == 1) {
    DDG_FLASH_MMA_SWITCH(D, 48, {
      return launch(dq_mma<DK>, p.dq, s, static_cast<P>(q), static_cast<P>(k),
                    static_cast<P>(v), lp, mp, static_cast<P>(dO), dp, static_cast<bf16*>(dq),
                    L, H, tq, tk, tv, causal, scale);
    })
  }
  DDG_FLASH_CORE_SWITCH(D, {
    return launch(dq_core<T, DC, KR>, p.dq, s, static_cast<const T*>(q),
                  static_cast<const T*>(k), static_cast<const T*>(v), lp, mp,
                  static_cast<const T*>(dO), dp, static_cast<T*>(dq), L, H, D, tq, tk, tv,
                  causal, scale);
  })
}

}  // namespace

// K20. q, k, v: (B, L, H, D) with dense heads, rows tq, tk, tv elements
// apart; o: contiguous (B, L, H, D); l, m: (B, H, L) fp32. *path: 2 on the
// wgmma kernel, 1 on the mma.sync one, 0 on the CUDA cores.
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

// K21. As K20, with the forward's l and m, its output o and the output
// gradient do (both contiguous, q's dtype); writes dk, dv (contiguous) and
// di = sum(o * do) ((B, H, L) fp32, for K22).
extern "C" int ddg_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                           const void* l, const void* m, const void* dO,
                                           const void* o, void* dk, void* dv, void* di, int B,
                                           int L, int H, int D, int tq, int tk, int tv,
                                           int causal, float scale, int dtype, void* stream,
                                           int* path) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ddg::kF32)
    return bwd_dkv<float>(q, k, v, l, m, dO, o, dk, dv, di, B, L, H, D, tq, tk, tv, causal,
                          scale, s, path);
  if (dtype == ddg::kBF16)
    return bwd_dkv<bf16>(q, k, v, l, m, dO, o, dk, dv, di, B, L, H, D, tq, tk, tv, causal,
                         scale, s, path);
  return cudaErrorInvalidValue;
}

// K22. As K21, with K21's di in place of o; writes dq (contiguous).
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

// The launch plan of a K20, K21 and K22 call of this shape, for rows on
// 16-byte boundaries (`aligned`) or not: out = for K20, K21, K22 each
// {path, tile, step, stages, dynamic shared bytes, threads, grid x, y, z}.
// Returns what the launches would return for the shape (0, or
// cudaErrorInvalidValue where no kernel takes it).
// ops/flash_attention.py:flash_plan mirrors it.
extern "C" int ddg_flash_attention_plan(int B, int L, int H, int D, int dtype, int aligned,
                                        int* out) {
  if (dtype != ddg::kF32 && dtype != ddg::kBF16) return cudaErrorInvalidValue;
  Plan p;
  const int err = make_plan(B, L, H, D, dtype == ddg::kBF16 && aligned, &p);
  if (err != cudaSuccess) return err;
  int i = 0;
  for (const Launch* l : {&p.fwd, &p.dkv, &p.dq})
    for (int f : {l->path, l->tile, l->step, l->stages, l->smem, l->threads, l->gx, l->gy, l->gz})
      out[i++] = f;
  return cudaSuccess;
}
