// Softmax attention for the DiT's sequences, forward, on the token-major
// layout: K1 (with RoPE) and K2 (without).
//
// Replaces two TPU kernels of ddg_tpu/ops/attention_pallas.py:
//   K1 fused_rope_attention -> _rope_flash -> _rope_attn_kernel (pallas_call :215)
//   K2 short_seq_attention -> _flash -> _attn_kernel (pallas_call :85)
// K2 is K1 with the rotation compiled out (kRope = false): the DiT rotates
// q and k before it, outside the kernel (ddg_tpu/models/dit.py:376-380).
// For each (b, h), with q, k, v of shape (B, L, H, D):
//   q' = RoPE(q), k' = RoPE(k)  K1 only: rotate-half in fp32, rounded back to the input dtype
//   S  = q' k'^T / sqrt(D)      fp32; with `causal`, S[i][j] = -1e30 for j > i
//   P  = softmax(S)             normalised in fp32, then rounded to v's dtype
//   O  = P V                    fp32 accumulation, written in the input dtype
// q, k and v each have their own token stride: views into the fused qkv
// projection (K1), or a rotated contiguous q and k beside a view of v (K2).
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16 dense): bytes, at both
// main shapes. LM1B sampling, 48 x 128 x 12 x 64 bf16: 37.7 MB of q, k, v
// and o, 0.0113 ms, against 2.4 GFLOP of products (0.0024 ms). text8
// training, 256 x 256: 402.7 MB, 0.1202 ms, against 51.5 GFLOP (0.052 ms).
//
// Two kernels, each in a RoPE and a plain instantiation. Both walk the keys
// in tiles of 64 and take any L: nothing they hold grows with it.
//
// * attention_wgmma_kernel, for bf16 with D = 64 and rows on 16-byte
//   boundaries: a block of two warpgroups (256 threads) per (128-row query
//   tile, head, batch), each warpgroup 64 query rows (one wgmma M, 4 warps
//   of 16); the grid is (L / 128, H, B) with the query tile fastest, so that
//   a head's blocks run side by side and share its K and V through L2.
//   - Shared memory, 64 KB: the two Q tiles, four K slots and a ring of two
//     V slots, each tile 64 rows x 128 bytes, loaded by the block's threads
//     with 16-byte cp.async (one commit group a step), rows past L
//     zero-filled through the src-size form (q, k and v are views into one
//     projection, so row L of one batch is row 0 of the next; V past L must
//     be exactly 0). Each tile is stored in the 128-byte swizzle (16-byte
//     chunk c of row r at chunk c ^ (r & 7)) at a 1024-aligned address, the
//     layout the wgmma descriptors read (B128, SBO 1024 bytes).
//   - Two passes over the key tiles, one copy pipeline: the steps are pass
//     1's tiles, then pass 2's, and the copy of step i + 1 overlaps step i.
//     Pass 1: S = Q K^T by wgmma m64n64k16 (A = the warpgroup's Q tile, B =
//     the K tile, both K-major in shared memory; four k-steps over D), masked
//     (key >= L, or key > row under `causal`, gives -1e30; only tiles that
//     reach past L or the diagonal pay for it), then each row's running max
//     m and each thread's running share of the sum l (quad shuffles give the
//     row's max; the shares are added at the end of the pass).
//     Pass 2: S again, bit for bit, so m is its exact row max; P = exp(S -
//     m) / l in fp32 (2^x by ex2.approx, times 1 / l), rounded to bf16
//     straight into the register-A fragments of O += P V (wgmma m64n64k16,
//     keys as K; B = the V tile as it lies, [key][d], MN-major through the
//     transpose-B bit). The scale is 1/8, a power of two, so it is folded
//     into the exponent exactly.
//     Why two passes: a flash-style online softmax rounds the unnormalised
//     exp(S - m_running) to bf16 and divides at the end, which moves the
//     rounding point away from the plain version's (and the Pallas
//     kernels', `p = p / sum; p.astype(v.dtype)`). The extra QK^T is a
//     third more products, 77 GFLOP at text8's shape (0.078 ms at peak),
//     still under the byte bound; the exps double, 403 M at text8's shape
//     (0.10 ms at the SFU's 16 a clock an SM). The sum's order and the
//     exp's last bits differ from the plain version's by fp32 ulps; a bf16
//     output differs from it at all in 0-0.15% of the elements on the card
//     (a flash-style order: ~45%). No atomics: reruns are bit-identical.
//   - Up to four key tiles (L <= 256) the K tiles stay in their slots from
//     pass 1 to pass 2, which then loads only V; past that K streams through
//     the ring (slots 0-1) in both passes.
//   - K1 rotates each Q tile once and each K tile when it lands (pass 1;
//     again in pass 2 only when K streams), in place: the pair (d, d + 32)
//     of a row with separately rounded fp32 products, back to bf16, as the
//     plain version does, a warp's table loads on 8 rows; the tables' next
//     row is loaded a step ahead. Then fence.proxy.async, since wgmma reads
//     shared memory through the async proxy. Two warpgroups a block halve
//     the rotations and the K/V copies per query row.
//   - Under `causal`, key tiles wholly past the block's last row are
//     skipped in both passes, and a warpgroup skips the products of a tile
//     wholly past its own rows.
//   - Epilogue: O rounded to bf16 through the Q tiles' shared memory
//     (swizzled, conflict-free), then 16-byte stores of the rows < L.
//   - Registers: S 32, O 32, the P fragments 16, m and l 4, capped at 128
//     by __launch_bounds__(256, 2): 98 (K2) and 114 (K1), no spills; two
//     blocks (16 warps) an SM. 48 x 128: 576 blocks, 2.2 waves of 264;
//     256 x 256: 6,144 blocks, 23.3 waves.
//   - Measured (scripts/ab_torch_attention.py, NVIDIA H100 80GB HBM3,
//     700.00 W, CUDA-event medians, one call): K1 0.0355 ms at 48 x 128 and
//     0.4163 at 256 x 256 (the mma.sync kernel it replaces: 0.0466,
//     0.9562), K2 0.0238 and 0.2762 (0.0458, 0.9505); SDPA 0.0184 and
//     0.1544. What holds them back, and the designs tried: PERF.md,
//     section 6.
// * attention_kernel, for float32 and any other even D: one block of 256
//   threads per (32-row query tile, head, batch), the same two passes over
//   64-key tiles on the CUDA cores in full fp32 (expf and division; the fp32
//   products are the contract there). Shared memory holds the Q tile, one
//   key tile of K (rows padded by one float against bank conflicts) and V, a
//   32 x 64 score tile and the 32-row O sums: (192 D + 2112) floats, 57,600
//   bytes at D = 64, whatever L is; the shared-memory cap stops it at
//   D = 290.
// The C functions report in *path which kernel they launched (1: tensor
// cores, 0: CUDA cores); ddg_attention_fwd_plan exports the launch plan,
// which ops/attention.py:forward_plan mirrors.

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using ddg::pack_bf16;

constexpr int kKeyTile = 64;               // keys of a tile, both kernels
constexpr int kSmemMax = 232448;           // dynamic shared memory of a block on the H100

// --- fp32 / any-D path on the CUDA cores ------------------------------------

constexpr int kTile = 32;                  // query rows of a block
constexpr int kThreads = 256;

__host__ __device__ constexpr size_t core_smem(int D) {
  return sizeof(float) * (static_cast<size_t>(kTile) * D + kKeyTile * (D + 1) +
                          static_cast<size_t>(kKeyTile) * D + kTile * kKeyTile +
                          static_cast<size_t>(kTile) * D);
}

// RoPE of element d of one (L, D) head row, rounded to T: the rotate-half
// convention (x1 c - x2 s, x2 c + x1 s) with separately rounded fp32
// products, as the plain version computes it.
template <typename T>
__device__ __forceinline__ float rope_at(const T* row, int d, int D, const float* cos_row,
                                         const float* sin_row) {
  const int half = D / 2;
  const int f = d < half ? d : d - half;
  const float x = ddg::to_f32(row[d]);
  const float c = cos_row[f], s = sin_row[f];
  float y;
  if (d < half) {
    y = __fsub_rn(__fmul_rn(x, c), __fmul_rn(ddg::to_f32(row[d + half]), s));
  } else {
    y = __fadd_rn(__fmul_rn(x, c), __fmul_rn(ddg::to_f32(row[d - half]), s));
  }
  return ddg::round_to<T>(y);
}

// Element d of row j of q or k as the products take it: rotated (K1) or as
// it is (K2).
template <typename T, bool kRope>
__device__ __forceinline__ float qk_at(const T* row, int j, int d, int D, const float* cos,
                                       const float* sin) {
  if constexpr (kRope) {
    return rope_at(row, d, D, cos + j * (D / 2), sin + j * (D / 2));
  } else {
    return ddg::to_f32(row[d]);
  }
}

template <typename T, bool kRope>
__global__ void __launch_bounds__(kThreads)
    attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ cos, const float* __restrict__ sin,
                     T* __restrict__ o, int L, int H, int D, int ts_q, int ts_k, int ts_v,
                     int causal, float scale) {
  extern __shared__ float smem[];
  const int KS = D + 1;  // padded K row
  float* Qs = smem;                   // kTile x D
  float* Ks = Qs + kTile * D;         // kKeyTile x (D + 1)
  float* Vs = Ks + kKeyTile * KS;     // kKeyTile x D
  float* Ss = Vs + kKeyTile * D;      // kTile x kKeyTile
  float* Os = Ss + kTile * kKeyTile;  // kTile x D

  const int i0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  // Rows of q, k and v are ts_q, ts_k and ts_v elements apart; o is
  // contiguous (B, L, H, D).
  const size_t qh = static_cast<size_t>(b) * L * ts_q + static_cast<size_t>(h) * D;
  const size_t kh = static_cast<size_t>(b) * L * ts_k + static_cast<size_t>(h) * D;
  const size_t vh = static_cast<size_t>(b) * L * ts_v + static_cast<size_t>(h) * D;
  const size_t out_stride = static_cast<size_t>(H) * D;
  const size_t out_head = static_cast<size_t>(b) * L * out_stride + static_cast<size_t>(h) * D;

  for (int idx = threadIdx.x; idx < kTile * D; idx += blockDim.x) {
    const int i = idx / D, d = idx % D;
    const int row = i0 + i;
    Qs[idx] = row < L ? qk_at<T, kRope>(q + qh + static_cast<size_t>(row) * ts_q, row, d, D,
                                        cos, sin)
                      : 0.f;
    Os[idx] = 0.f;
  }

  // Warp w owns rows w, w + 8, w + 16, w + 24 of the tile: their running
  // max and sum stay in its registers from pass 1 into pass 2.
  constexpr int kRowsPerWarp = kTile / (kThreads / 32);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) m[r] = kNeg, l[r] = 0.f;

  const int n_tiles = (L + kKeyTile - 1) / kKeyTile;
  const int n_keys = causal ? min(n_tiles, (i0 + kTile - 1) / kKeyTile + 1) : n_tiles;
  for (int pass = 0; pass < 2; ++pass) {
    for (int jt = 0; jt < n_keys; ++jt) {
      const int j0 = jt * kKeyTile;
      __syncthreads();  // the previous tile's readers are done
      for (int idx = threadIdx.x; idx < kKeyTile * D; idx += blockDim.x) {
        const int jj = idx / D, d = idx % D, key = j0 + jj;
        Ks[jj * KS + d] =
            key < L ? qk_at<T, kRope>(k + kh + static_cast<size_t>(key) * ts_k, key, d, D, cos,
                                      sin)
                    : 0.f;
        if (pass) Vs[idx] = key < L ? ddg::to_f32(v[vh + static_cast<size_t>(key) * ts_v + d])
                                    : 0.f;
      }
      __syncthreads();
      for (int idx = threadIdx.x; idx < kTile * kKeyTile; idx += blockDim.x) {
        const int i = idx / kKeyTile, jj = idx % kKeyTile, key = j0 + jj;
        const float* qi = Qs + i * D;
        const float* kj = Ks + jj * KS;
        float acc = 0.f;
        for (int d = 0; d < D; ++d) acc = fmaf(qi[d], kj[d], acc);
        acc *= scale;
        if (key >= L || (causal && key > i0 + i)) acc = kNeg;
        Ss[idx] = acc;
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        float* s = Ss + (warp + r * (kThreads / 32)) * kKeyTile;
        const float x0 = s[lane], x1 = s[lane + 32];
        if (pass == 0) {
          const float mn = fmaxf(m[r], ddg::warp_max(fmaxf(x0, x1)));
          const float sum = ddg::warp_sum(expf(x0 - mn) + expf(x1 - mn));
          l[r] = l[r] * expf(m[r] - mn) + sum;
          m[r] = mn;
        } else {
          s[lane] = ddg::round_to<T>(expf(x0 - m[r]) / l[r]);
          s[lane + 32] = ddg::round_to<T>(expf(x1 - m[r]) / l[r]);
        }
      }
      if (pass == 0) continue;
      __syncthreads();
      // O += P V in key order: the fp32 sums run over the keys 0, 1, ...
      // as one chain from tile to tile.
      for (int idx = threadIdx.x; idx < kTile * D; idx += blockDim.x) {
        const int i = idx / D, d = idx % D;
        const int row = i0 + i;
        if (row >= L) continue;
        const int jmax = min(kKeyTile, (causal ? row + 1 : L) - j0);
        const float* p = Ss + i * kKeyTile;
        float acc = Os[idx];
        for (int jj = 0; jj < jmax; ++jj) acc = fmaf(p[jj], Vs[jj * D + d], acc);
        Os[idx] = acc;
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kTile * D; idx += blockDim.x) {
    const int i = idx / D, d = idx % D;
    const int row = i0 + i;
    if (row < L) o[out_head + row * out_stride + d] = ddg::from_f32<T>(Os[idx]);
  }
}

// --- bf16 tensor-core path: wgmma over 64-key tiles --------------------------

// Tiles of kTileRows x kMmaD bf16; the cp.async, swizzle, descriptor and
// wgmma helpers are in wgmma.cuh, shared with the backward.
constexpr int kGroups = 2;                 // warpgroups of a block
static_assert(kMmaThreads == 128 * kGroups, "one block is kGroups warpgroups");
constexpr int kQTile = kTileRows * kGroups;      // query rows of a block
constexpr int kStages = 2;                 // the ring's depth: V (and streamed K) tiles
constexpr int kKSlots = 4;                 // K tiles kept for pass 2: L <= 256
// The Q tiles, the K slots, the V slots: 65,536 bytes, two blocks an SM.
constexpr size_t kMmaSmem = static_cast<size_t>(kTileBytes) * (kGroups + kKSlots + kStages);

// A thread's share of rotating one swizzled 64 x 64 tile by RoPE: row r =
// 8 warp + lane % 8 (position row0 + r), the pairs in chunks c and c + 4
// (d in [8 c, 8 c + 8) and d + 32), c = lane / 8. A warp's table loads touch
// 8 rows of the (L, 32) tables, and a quarter warp's eight rows hit eight
// different chunks of the tile. The tables' row is loaded ahead of the
// rotation, so that its latency hides behind other work.
struct RopeRow {
  float c[8], s[8];
};

__device__ __forceinline__ int rope_row() { return 8 * (threadIdx.x >> 5) + (threadIdx.x & 7); }

__device__ __forceinline__ void rope_load(RopeRow& t, int row0, int L,
                                          const float* __restrict__ cos,
                                          const float* __restrict__ sin) {
  constexpr int half = kMmaD / 2;
  const int p = row0 + rope_row(), f = 8 * ((threadIdx.x & 31) >> 3);
  if (p >= L) return;
  ddg::load_f32<8>(cos + p * half + f, t.c);
  ddg::load_f32<8>(sin + p * half + f, t.s);
}

__device__ __forceinline__ void rope_apply(unsigned char* tile, int row0, int L,
                                           const RopeRow& t) {
  const int r = rope_row(), c = (threadIdx.x & 31) >> 3;
  if (row0 + r >= L) return;
  bf16* lo = reinterpret_cast<bf16*>(tile + swz(r, c));
  bf16* hi = reinterpret_cast<bf16*>(tile + swz(r, c + 4));
  float x1[8], x2[8], y1[8], y2[8];
  ddg::load16(lo, x1);
  ddg::load16(hi, x2);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    y1[e] = __fsub_rn(__fmul_rn(x1[e], t.c[e]), __fmul_rn(x2[e], t.s[e]));
    y2[e] = __fadd_rn(__fmul_rn(x2[e], t.c[e]), __fmul_rn(x1[e], t.s[e]));
  }
  ddg::store16(lo, y1);
  ddg::store16(hi, y2);
}

// S = Q K^T for one key tile: four k-steps of 16 over D (32 bytes along
// the swizzled rows).
__device__ __forceinline__ void qk_tile(float (&s)[32], uint32_t qs, uint32_t ks) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kMmaD / 16; ++kk)
    wgmma_ss(s, desc_b128(qs + 32 * kk), desc_b128(ks + 32 * kk));
  wgmma_commit();
  wgmma_wait0();
  fence_regs(s);
}

template <bool kRope>
__global__ void __launch_bounds__(kMmaThreads, 2)
    attention_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const float* __restrict__ cos,
                           const float* __restrict__ sin, bf16* __restrict__ o, int L, int H,
                           int ts_q, int ts_k, int ts_v, int causal, float scale) {
  // Q tiles 0-1 (one a warpgroup), K slots 0-3, V slots 0-1, each a
  // swizzled 64 x 64 tile. The swizzle needs 1024-aligned tiles; the
  // dynamic shared memory's base is (the kernel traps if it is not).
  extern __shared__ __align__(1024) unsigned char smem_tiles[];
  unsigned char* const smem = smem_tiles;
  const uint32_t base = smem_addr(smem);
  if (base % kSwizzleAlign) __trap();
  const int q0 = blockIdx.x * kQTile, h = blockIdx.y, b = blockIdx.z;
  const bf16* qh = q + static_cast<size_t>(b) * L * ts_q + h * kMmaD;
  const bf16* kh = k + static_cast<size_t>(b) * L * ts_k + h * kMmaD;
  const bf16* vh = v + static_cast<size_t>(b) * L * ts_v + h * kMmaD;

  const int n_tiles = (L + kKeyTile - 1) / kKeyTile;
  const int last_row = min(L, q0 + kQTile) - 1;
  const int n_keys = causal ? min(n_tiles, last_row / kKeyTile + 1) : n_tiles;
  const int n_steps = 2 * n_keys;  // pass 1's key tiles, then pass 2's
  // Up to four key tiles, pass 1 leaves each K tile (rotated, under K1) in
  // its own slot and pass 2 loads only V; past that, K streams through the
  // ring in both passes (and K1 rotates it again in pass 2).
  const bool resident = n_keys <= kKSlots;
  auto first_key = [&](int step) { return (step < n_keys ? step : step - n_keys) * kKeyTile; };
  auto k_slot = [&](int step) {
    return base +
           (kGroups + (resident ? first_key(step) / kKeyTile : step % kStages)) * kTileBytes;
  };
  auto v_slot = [&](int step) {
    return base + (kGroups + kKSlots + step % kStages) * kTileBytes;
  };
  auto loads_k = [&](int step) { return step < n_keys || !resident; };
  // One commit group a step.
  auto issue = [&](int step) {
    if (step >= n_steps) return;
    if (loads_k(step)) load_tile(k_slot(step), kh, ts_k, first_key(step), L);
    if (step >= n_keys) load_tile(v_slot(step), vh, ts_v, first_key(step), L);
    cp_async_commit();
  };
  // Wait for step's tiles; once every thread is past the barrier, step - 1's
  // ring stage is free and step + 1's copy goes into it. K1 then rotates a
  // K tile that landed in place, with the tables' row in `tab` (pass 1
  // loads it a step ahead). The fence publishes the tiles to the async
  // proxy (wgmma).
  RopeRow tab;
  auto land = [&](int step) {
    if constexpr (kRope) {
      if (loads_k(step)) {
        if (step >= n_keys) rope_load(tab, first_key(step), L, cos, sin);
        cp_async_wait<0>();
        __syncthreads();
        issue(step + 1);
        rope_apply(smem + (k_slot(step) - base), first_key(step), L, tab);
        if (step + 1 < n_keys) rope_load(tab, first_key(step + 1), L, cos, sin);
        fence_async_smem();
        __syncthreads();
        return;
      }
    }
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    issue(step + 1);
  };

  // Warpgroup wg takes query rows q0 + 64 wg .. + 63 (its Q tile); a
  // warpgroup with no rows left, or (causal) a key tile wholly past its
  // rows, skips the products but not the block's loads and barriers.
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wq0 = q0 + wg * kTileRows;  // the warpgroup's first row
  const uint32_t qs = base + wg * kTileBytes;
  const int r0 = wq0 + warp * 16 + g;   // the thread's rows: r0 and r0 + 8
  auto skips = [&](int step) {
    return wq0 >= L || (causal && first_key(step) > wq0 + kTileRows - 1);
  };
  // Mask one tile of (unscaled) scores where it has keys past L or
  // (causal) past a row: s[4 j + e] is row r0 + 8 (e >> 1), key j0 + 8 j +
  // 2 t + (e & 1).
  auto mask = [&](float (&s)[32], int j0) {
    if (j0 + kKeyTile <= L && !(causal && j0 + kKeyTile > wq0 + 1)) return;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = j0 + 8 * (i >> 2) + 2 * t + (i & 1);
      const int row = r0 + 8 * ((i >> 1) & 1);
      if (key >= L || (causal && key > row)) s[i] = kNeg;
    }
  };
  // The scale is 1/8, a power of two: scaling commutes exactly with the
  // max and the subtraction, so exp(S scale - max(S scale)) is taken as
  // 2^((S - max S) (scale log2 e)) on the unscaled scores, without a
  // multiply an element.
  const float c2 = scale * kLog2e;

  for (int w = 0; w < kGroups; ++w) load_tile(base + w * kTileBytes, qh, ts_q, q0 + w * kTileRows, L);
  issue(0);
  if constexpr (kRope) {
    RopeRow qtab[kGroups];
#pragma unroll
    for (int w = 0; w < kGroups; ++w) rope_load(qtab[w], q0 + w * kTileRows, L, cos, sin);
    rope_load(tab, 0, L, cos, sin);
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kGroups; ++w)
      rope_apply(smem + w * kTileBytes, q0 + w * kTileRows, L, qtab[w]);
  }

  // Pass 1: each row's exact max m and the thread's share of the sum l.
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float s[32];
  int step = 0;
  for (; step < n_keys; ++step) {
    land(step);
    if (skips(step)) continue;
    qk_tile(s, qs, k_slot(step));
    mask(s, first_key(step));
    float mt[2] = {kNeg, kNeg};
#pragma unroll
    for (int i = 0; i < 32; ++i) mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], s[i]);
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      mt[r] = fmaxf(m[r], mt[r]);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) part[(i >> 1) & 1] += ex2((s[i] - mt[(i >> 1) & 1]) * c2);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * ex2((m[r] - mt[r]) * c2) + part[r];
      m[r] = mt[r];
    }
  }
  float rl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    rl[r] = 1.f / l[r];
  }

  // Pass 2: O += P V with P = exp(S - m) / l rounded to bf16.
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (; step < n_steps; ++step) {
    land(step);
    if (skips(step)) continue;
    qk_tile(s, qs, k_slot(step));
    mask(s, first_key(step));
    // Keys 16 kk .. 16 kk + 15 are the score tiles 2 kk and 2 kk + 1:
    // s[8 kk + e] and s[8 kk + 4 + e].
    auto p_of = [&](float x, int r) { return ex2((x - m[r]) * c2) * rl[r]; };
    uint32_t pa[16];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* x = s + 8 * kk;
      pa[4 * kk + 0] = pack_bf16(p_of(x[0], 0), p_of(x[1], 0));
      pa[4 * kk + 1] = pack_bf16(p_of(x[2], 1), p_of(x[3], 1));
      pa[4 * kk + 2] = pack_bf16(p_of(x[4], 0), p_of(x[5], 0));
      pa[4 * kk + 3] = pack_bf16(p_of(x[6], 1), p_of(x[7], 1));
    }
    const uint32_t vs = v_slot(step);
    fence_regs(pa);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_tb(acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                  desc_b128(vs + kk * 16 * 128));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    fence_regs(pa);
  }
  __syncthreads();  // every warpgroup is done reading the Q tiles

  // Epilogue: O to bf16 in the warpgroup's Q tile (swizzled), then 16-byte
  // rows.
  const int lr = warp * 16 + g;
  unsigned char* const ot = smem + wg * kTileBytes;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<uint32_t*>(ot + swz(lr, j) + 4 * t) = pack_bf16(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(ot + swz(lr + 8, j) + 4 * t) =
        pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
  __syncthreads();
  const size_t out_stride = static_cast<size_t>(H) * kMmaD;
  bf16* out = o + static_cast<size_t>(b) * L * out_stride + h * kMmaD;
  const int c = threadIdx.x & 7;
#pragma unroll
  for (int i = 0; i < kQTile * 8 / kMmaThreads; ++i) {
    const int r = (threadIdx.x >> 3) + i * (kMmaThreads / 8);  // row of the block's tile
    if (q0 + r < L)
      *reinterpret_cast<uint4*>(out + (q0 + r) * out_stride + c * 8) =
          *reinterpret_cast<const uint4*>(smem + (r / kTileRows) * kTileBytes +
                                          swz(r % kTileRows, c));
  }
}

// --- launch plan and dispatch -----------------------------------------------

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// What a forward call launches. `tc`: bf16 with D = 64 and every row on a
// 16-byte boundary, which the tensor-core kernel takes at any L.
struct Plan {
  int path, q_tile, k_tile, stages, smem, threads, gx, gy, gz;
};

int make_plan(int B, int L, int H, int D, bool tc, Plan* p) {
  if (D <= 0 || D % 2 || B <= 0 || L <= 0 || H <= 0 || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  if (tc) {
    *p = {1, kQTile, kKeyTile, kStages, static_cast<int>(kMmaSmem), kMmaThreads, 0, H, B};
  } else {
    const size_t smem = core_smem(D);
    if (smem > kSmemMax) return cudaErrorInvalidValue;
    *p = {0, kTile, kKeyTile, 1, static_cast<int>(smem), kThreads, 0, H, B};
  }
  p->gx = (L + p->q_tile - 1) / p->q_tile;
  return cudaSuccess;
}

template <typename T, bool kRope>
int launch(const void* q, const void* k, const void* v, const void* cos, const void* sin,
           void* o, int B, int L, int H, int D, int ts_q, int ts_k, int ts_v, int causal,
           float scale, cudaStream_t stream, int* path) {
  if (ts_q < H * D || ts_k < H * D || ts_v < H * D) return cudaErrorInvalidValue;
  const bool tc = std::is_same<T, bf16>::value && D == kMmaD && ts_q % 8 == 0 &&
                  ts_k % 8 == 0 && ts_v % 8 == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v) && aligned16(o) &&
                  (!kRope || (aligned16(cos) && aligned16(sin)));
  Plan p;
  int err = make_plan(B, L, H, D, tc, &p);
  if (err != cudaSuccess) return err;
  *path = p.path;
  const dim3 grid(p.gx, p.gy, p.gz);
  if (tc) {
    auto kernel = attention_wgmma_kernel<kRope>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    kernel<<<grid, p.threads, p.smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const float*>(cos), static_cast<const float*>(sin), static_cast<bf16*>(o),
        L, H, ts_q, ts_k, ts_v, causal, scale);
    return cudaGetLastError();
  }
  auto kernel = attention_kernel<T, kRope>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, p.threads, p.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(cos), static_cast<const float*>(sin), static_cast<T*>(o), L, H,
      D, ts_q, ts_k, ts_v, causal, scale);
  return cudaGetLastError();
}

template <bool kRope>
int dispatch(const void* q, const void* k, const void* v, const void* cos, const void* sin,
             void* o, int B, int L, int H, int D, int ts_q, int ts_k, int ts_v, int causal,
             float scale, int dtype, void* stream, int* path) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ddg::kF32)
    return launch<float, kRope>(q, k, v, cos, sin, o, B, L, H, D, ts_q, ts_k, ts_v, causal,
                                scale, s, path);
  if (dtype == ddg::kBF16)
    return launch<bf16, kRope>(q, k, v, cos, sin, o, B, L, H, D, ts_q, ts_k, ts_v, causal,
                               scale, s, path);
  return cudaErrorInvalidValue;
}

}  // namespace

// K1. q, k, v: (B, L, H, D) with dense heads, rows ts_q, ts_k, ts_v
// elements apart; cos, sin: (L, D / 2) fp32; o: contiguous (B, L, H, D).
extern "C" int ddg_rope_attention(const void* q, const void* k, const void* v, const void* cos,
                                  const void* sin, void* o, int B, int L, int H, int D,
                                  int ts_q, int ts_k, int ts_v, int causal, float scale,
                                  int dtype, void* stream, int* path) {
  return dispatch<true>(q, k, v, cos, sin, o, B, L, H, D, ts_q, ts_k, ts_v, causal, scale,
                        dtype, stream, path);
}

// K2: the same without the rotation.
extern "C" int ddg_short_seq_attention(const void* q, const void* k, const void* v, void* o,
                                       int B, int L, int H, int D, int ts_q, int ts_k,
                                       int ts_v, int causal, float scale, int dtype,
                                       void* stream, int* path) {
  return dispatch<false>(q, k, v, nullptr, nullptr, o, B, L, H, D, ts_q, ts_k, ts_v, causal,
                         scale, dtype, stream, path);
}

// The launch plan of a K1 or K2 forward of this shape, for rows on 16-byte
// boundaries (`aligned`) or not: out = {path, query tile, key tile, ring
// stages, dynamic shared bytes, threads, grid x, y, z}. Returns what the
// launch would return for the shape (0, or cudaErrorInvalidValue where no
// kernel takes it). ops/attention.py:forward_plan mirrors it.
extern "C" int ddg_attention_fwd_plan(int B, int L, int H, int D, int dtype, int aligned,
                                      int* out) {
  if (dtype != ddg::kF32 && dtype != ddg::kBF16) return cudaErrorInvalidValue;
  Plan p;
  const int err = make_plan(B, L, H, D, dtype == ddg::kBF16 && D == kMmaD && aligned, &p);
  if (err != cudaSuccess) return err;
  const int fields[9] = {p.path, p.q_tile, p.k_tile, p.stages, p.smem, p.threads,
                         p.gx,   p.gy,     p.gz};
  for (int i = 0; i < 9; ++i) out[i] = fields[i];
  return cudaSuccess;
}
