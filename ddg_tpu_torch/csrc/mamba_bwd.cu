// The DiMamba backward kernels: the adjoint of the gated selective scan
// and of the fused Mamba block (one direction).
//
// Replaces the TPU kernels
//   ddg_tpu/ops/selective_scan_pallas.py: ssm_scan -> _bwd_call (pallas_call :653,
//     body _bwd_kernel :488), K15
//   ddg_tpu/ops/selective_scan_pallas.py: ssm_scan_dtlr -> _bwd_call_lr (:994,
//     body _bwd_kernel_lr :842), K17
//   ddg_tpu/ops/mamba_block_pallas.py: mamba_inner_pallas -> _mk_bwd_call (:553,
//     body _mk_bwd_kernel :370), K19
// with their rounding points; ddg_tpu_torch/ops/mamba.py holds the plain
// versions (`ssm_scan_bwd_plain`, `mamba_inner_bwd_plain`).
//
// The scan's adjoint (one routine for K15, K17 and K19). The TPU grid runs
// the chunks right to left and carries the adjoint in VMEM; here three
// launches make pieces of the chunks independent blocks. Each chunk is cut
// into sub-chunks of up to kSubRows = 64 rows:
//   1. every sub-chunk from a zero adjoint at its end: the carry it hands
//      left (a_t0 dh_t0) and the product P of its a_t (four threads a
//      channel, four states each, walking the rows back);
//   2. per (b, state, channel), the sub-chunks right to left: the true carry
//      into each, chi[c] = P[c + 1] chi[c + 1] + left[c + 1];
//   3. per (b, chunk, channel tile), the sub-chunks left to right, each
//      time-parallel (`scan_bwd_out_kernel`): warp w takes rows 8 w .. 8 w +
//      7, takes a_t = exp(delta_t A) of its rows once into registers, forms
//      its segment's (P, H, E) and, through shared memory, chains the
//      segments before it from the entry state (h0s, saved by the forward,
//      or the last sub-chunk's exit) and those after it from the carry, in
//      segment order; then it walks dh back and h forward from them and
//      forms every row's outputs. The recurrence is never inverted (a_t
//      underflows).
// So exp(delta A) is taken twice a state-row (pass 1 and pass 3), and a
// row's fixed work (delta, u, the gate's three terms) once per (row,
// channel): staged in shared memory for the tile's 64 channels at once.
// Sums over the states are quad shuffles; dB and dC sum over channels by a
// recursive-halving warp shuffle, then over the rounds in order in
// registers, then over the channel tiles in order (`reduce_slices`). dA and
// dD sum over a sub-chunk's segments in order, per (b, sub-chunk), then over
// those in order. No atomics: reruns are bit-identical. d_state > 16 runs
// passes 1 and 3 over groups of 16 states in order, each group's B and C
// columns staged before it, so no pass's shared memory grows with d_state;
// pass 3 carries each row's sums over the states from group to group (du in
// its output, ddelta in its output or in shared memory, C.h in shared
// memory). tests/test_torch_mamba_scan_order.py emulates this order against
// the float64 recurrence.
//
// ddg_ssm_scan_dtlr_bwd (K17) is that adjoint in its low-rank form, with
// dt_proj's adjoint inside pass 3, as the TPU kernel's body has it: delta
// formed in passes 1 and 3 from dt_lr, W_dt and b_dt as K16 forms it (its
// dt_lr rows and W_dt's columns staged in shared memory a rank tile of up
// to kRankTile at a time, `form_delta`), and sigmoid(pre) staged beside
// it; once a sub-chunk's ddelta is final, the
// block forms dpre = ddelta sigmoid(pre), ddt_lr = dpre W_dt^T over its 64
// channels and dW_dt = dt_lr^T dpre, db_dt = sum_t dpre over the rows, in
// fp32 FMAs (no TF32: JAX takes them at Precision.HIGHEST), each a
// fixed-order sum of partials: ddt_lr over the channel tiles, dW_dt and
// db_dt over the (b, chunk) slices. ddelta never leaves shared memory: the
// first K17 wrote it to an (M, d) fp32 workspace and ran K19's
// `dt_bwd_kernel` on it, which with the staging of delta made 2.06 ms of
// its 7.78 a call at 4 x 32768 beyond K15's adjoint on the same operands
// (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
// Bound at the training shape (4 x 32768, d 512, N 16, R 16): 8,704 exps a
// token for the scan and 2 x 512 for delta and its sigmoid, 0.32 ms on the
// SFU, against 0.74 GB of bytes (0.22 ms): u, z, g, dt_lr, B, C in, du, dz,
// ddt_lr, dB, dC out and h0s.
//
// ddg_mamba_inner_bwd (K19), for compute type T, per direction:
//   xz, u, x_dbl, delta   the front, recomputed from h by the forward's own
//                         in_proj GEMM and front kernel (through device memory)
//   dy    = g W_out                          (gemm, fp32 out)
//   scan adjoint with gy = dy silu(z): ddelta, du, dB, dC, dz (-> dxz, T),
//         y_g = (C.h + D u) silu(z) in T, dA, dD
//   dpre  = ddelta sigmoid(pre), ddt_lr = dpre W_dt^T, dW_dt, db_dt  (fp32 FMAs,
//           K17's dt adjoint over channel tiles)
//   dx_dbl = [ddt_lr | dB | dC] rounded to T
//   du   += dx_dbl W_x^T                     (gemm, accumulated in fp32)
//   dxc   = du silu'(xc); dx = conv adjoint (a halo of K - 1 rows read
//           from the next tile), rounded to T -> dxz; dconv_w, dconv_b
//   dh    = dxz W_in^T                       (gemm, T out)
//   dW_in = h^T dxz, dW_x = u^T dx_dbl, dW_out = y_g^T g   (wgrad)
// bf16 products are wgmma m64n64k16 with fp32 sums (mamba.cuh's
// gemm_wgmma_kernel, 128 x 128 tiles of two warpgroups); weight gradients
// sum per 4096-row slice, then over the slices in order.
//
// Bounds on the H100 at the Species10 training shape (16 rows of L = 32768,
// H = 256, d = 512, N = 16, dt_rank 16), per K19 call: 2.24 MFLOP of bf16
// products a token (1.19 ms on the tensor cores) and 10,752 exps and logs a
// token (1.35 ms on the SFU, the bound); h, g, dh and h0s are 0.28 ms of
// bytes. This design takes exp(delta A) four times a state-row (pass 1,
// pass 3's forward walk, the segment recompute and the walk back), pays
// each row's fixed work once per four states, and passes about 12 KB a
// token of workspace through device memory: 40.0 ms a call, 29.7x the
// bound (NVIDIA H100 80GB HBM3, 700 W; PERF.md). K15 at the same shape:
// 8,704 exps a token (1.09 ms) against 1.50 ms of bytes; 22.2 ms.

#include "mamba.cuh"

namespace {

constexpr int kBwdThreads = 256;
constexpr int kQ = 4;                        // states a thread holds
constexpr int kBwdCh = kBwdThreads / kQ;     // channels of a block
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kSeg = 16;                     // rows between checkpoints
constexpr int kGroup = 128;                  // slices one reduction pass sums
// Pass 3 cuts a chunk into sub-chunks of up to kSubRows rows, and a
// sub-chunk into segments of kP3Rows rows, warp w taking segment w; the
// block's kBwdCh channels go kRoundCh at a time (a round), one a lane
// quad: lane = 4 c8 + q, c8 the round's channel, q the quarter of the
// group of 16 states. Passes 1 and 2 run on the same sub-chunks.
constexpr int kP3Rows = 8;
constexpr int kRoundCh = 8;
constexpr int kSubRows = kBwdWarps * kP3Rows;
constexpr int kRowVals = 5;                  // staged per (row, channel): dt, u, gy, dzf, sg
static_assert(kRoundCh * kQ == 32 && kBwdCh % kRoundCh == 0, "a round is one warp's lanes");

// Where the adjoint takes delta from: the (Bt L, d) fp32 array (K15 and
// inside K19), or, with delta null, formed per (row, channel) as
// softplus(dt_lr W_dt + b_dt) from dt_lr (Bt L rows of stride ld_lr, fp32),
// W_dt (R, d) and b_dt (d), fp32 (K17).
struct DtSrc {
  const float* delta;
  const float* lr;
  int ld_lr;
  const float* wdt;
  const float* bdt;
  int R;
};

// K17's partials of dt_proj's adjoint, formed in pass 3 (null elsewhere):
// ddt_lr per channel tile (tiles, Bt L, R), dW_dt (Bt n_chunks, R, d) and
// db_dt (Bt n_chunks, d) per (b, chunk).
struct DtGrad {
  float* dlr;
  float* dw;
  float* db;
};

__host__ __device__ constexpr int sub_rows(int chunk) {
  return chunk < kSubRows ? chunk : kSubRows;
}
__host__ __device__ constexpr int n_subs(int chunk) { return (chunk + kSubRows - 1) / kSubRows; }
// Rows pass 3 stages a sub-chunk: sub_rows rounded up to whole kP3Rows
// segments (zeros past it), so that a last, partial segment reads zeros
// and writes into its own rows.
__host__ __device__ constexpr int p3_rows(int chunk) {
  return (sub_rows(chunk) + kP3Rows - 1) / kP3Rows * kP3Rows;
}

// States nq .. nq + 3 of channel ch's row of A, round-tripped as
// -exp(log(-A)): plain (av) and times log2 e (a2); 0 past N.
__device__ __forceinline__ void load_a4(const float* __restrict__ A, int ch, int N, int nq,
                                        float (&a2)[kQ], float (&av)[kQ]) {
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const int n = nq + i;
    av[i] = n < N ? -expf(logf(-A[ch * N + n])) : 0.f;
    a2[i] = av[i] * kLog2e;
  }
}

__device__ __forceinline__ void load_q(const float* p, float (&v)[kQ]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
}

// Pass 1's per-channel row values of a segment staged in shared memory as
// fp32, [value][row][channel of the block]: delta and gy = g silu(z). One
// coalesced load for kSeg rows, in place of a dependent load per row,
// which left the few warps an SM holds waiting on memory; the gate is
// taken once per (row, channel), not by each of its four threads.
constexpr int kStage = kSeg * kBwdCh;

// The low-rank form (dl.delta null, K17) forms delta as the forward forms
// it, from dt_lr rows and W_dt's columns of the block's channels staged in
// shared memory: lrs, rows of the tile's ranks rank_ld(R) apart, zeros
// past R and past the sub-chunk; wt, [channel][rank], wt_ld = rank_ld + 4
// to a channel, so that the channels' float4 loads hit distinct banks,
// zeros past R and d, then b_dt, one a channel. Up to kRankTile ranks (one
// tile) W_dt is staged once a block and dt_lr once a sub-chunk; past it
// (the kernels' RT instantiations), rank tiles are staged one at a time
// where they are used, and every sum walks them in order, so that it keeps
// the one k-ascending chain (and bits) whatever dt_rank is.
constexpr int kRankTile = 128;
__host__ __device__ constexpr int rank_ld(int R) {
  return round4(R) < kRankTile ? round4(R) : kRankTile;
}
__host__ __device__ constexpr int rank_tiles(int R) {
  return (round4(R) + kRankTile - 1) / kRankTile;
}
__host__ __device__ constexpr int wt_ld(int R) { return rank_ld(R) + 4; }

// W_dt's rows [k0, k0 + rank_ld) of the block's channels, and b_dt.
__device__ void stage_wt(const DtSrc& dl, int ch0, int d, int k0, float* wt) {
  const int tw = rank_ld(dl.R), ld = wt_ld(dl.R);
  for (int i = threadIdx.x; i < tw * kBwdCh; i += kBwdThreads) {
    const int k = i / kBwdCh, c = i % kBwdCh, ch = ch0 + c, kk = k0 + k;
    wt[c * ld + k] = ch < d && kk < dl.R ? dl.wdt[static_cast<size_t>(kk) * d + ch] : 0.f;
  }
  for (int c = threadIdx.x; c < kBwdCh; c += kBwdThreads)
    wt[kBwdCh * ld + c] = ch0 + c < d ? dl.bdt[ch0 + c] : 0.f;
}

// Ranks [k0, k0 + rank_ld) of dt_lr rows [0, n) of the sub-chunk starting
// at row0, zeros past `rows` and R.
__device__ void stage_lr_rows(const DtSrc& dl, size_t row0, int rows, int n, int k0, float* lrs) {
  const int tw = rank_ld(dl.R);
  for (int i = threadIdx.x; i < n * tw; i += kBwdThreads) {
    const int r = i / tw, k = i - r * tw;
    lrs[i] = r < rows && k0 + k < dl.R ? dl.lr[(row0 + r) * dl.ld_lr + k0 + k] : 0.f;
  }
}

// Pass 3's delta: the rank tile from k0 of pre - b_dt = dt_lr . W_dt for
// the sub-chunk's rows [0, n) and the tile's channels, [row][channel] in
// dst, added to the sums the tiles before left there (RT; k ascending four
// at a time over every tile: `dt_pre`'s order and bits). After the last
// tile, delta = softplus(pre) goes into dst and sigmoid(pre) into sig
// (zeros past `rows` and d). A thread takes channel tid % kBwdCh and
// kRowsAtOnce rows tid / kBwdCh + 4 e at a time, W_dt's column loaded once
// a four ranks for all of them.
constexpr int kRowPhases = kBwdThreads / kBwdCh;
constexpr int kRowsAtOnce = 8;

template <bool RT>
__device__ void form_delta(const DtSrc& dl, const float* lrs, const float* wt, int k0, int ch0,
                           int d, int rows, int n, float* dst, float* sig) {
  const int tw = rank_ld(dl.R), kn = RT ? min(tw, round4(dl.R) - k0) : tw;
  const int c = threadIdx.x % kBwdCh;
  const bool first = !RT || k0 == 0, last = !RT || k0 + kn == round4(dl.R);
  const float* wc = wt + c * wt_ld(dl.R);
  const float bias = wt[kBwdCh * wt_ld(dl.R) + c];
  for (int j0 = threadIdx.x / kBwdCh; j0 < n; j0 += kRowPhases * kRowsAtOnce) {
    float acc[kRowsAtOnce];
#pragma unroll
    for (int e = 0; e < kRowsAtOnce; ++e) {
      const int r = j0 + kRowPhases * e;
      acc[e] = first || r >= n ? 0.f : dst[r * kBwdCh + c];
    }
    for (int k = 0; k < kn; k += 4) {
      const float4 w = *reinterpret_cast<const float4*>(wc + k);
#pragma unroll
      for (int e = 0; e < kRowsAtOnce; ++e) {
        const float4 v = *reinterpret_cast<const float4*>(lrs + (j0 + kRowPhases * e) * tw + k);
        acc[e] = fmaf(v.x, w.x, acc[e]);
        acc[e] = fmaf(v.y, w.y, acc[e]);
        acc[e] = fmaf(v.z, w.z, acc[e]);
        acc[e] = fmaf(v.w, w.w, acc[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < kRowsAtOnce; ++e) {
      const int r = j0 + kRowPhases * e;
      if (r >= n) break;
      if (!last) {
        dst[r * kBwdCh + c] = acc[e];
        continue;
      }
      const bool in = r < rows && ch0 + c < d;
      const float pre = acc[e] + bias;
      dst[r * kBwdCh + c] = in ? softplus(pre) : 0.f;
      sig[r * kBwdCh + c] = in ? sigmoid(pre) : 0.f;
    }
  }
}

// pre - b_dt of one dt_lr row and W_dt's column wc over kn ranks, k
// ascending four at a time from acc: `dt_pre`'s order and bits. Not
// unrolled: pass 1 keeps its registers (and so its blocks an SM) for the
// walk.
__device__ __forceinline__ float dt_pre_row(const float* lr, const float* wc, int kn,
                                            float acc) {
#pragma unroll 1
  for (int k = 0; k < kn; k += 4) {
    const float4 v = *reinterpret_cast<const float4*>(lr + k);
    const float4 w = *reinterpret_cast<const float4*>(wc + k);
    acc = fmaf(v.x, w.x, acc);
    acc = fmaf(v.y, w.y, acc);
    acc = fmaf(v.z, w.z, acc);
    acc = fmaf(v.w, w.w, acc);
  }
  return acc;
}

// A segment's delta (from memory, or in the low-rank form formed from
// dt_lr's rows in lrs, one row a thread, which keeps pass 1's registers
// for its warps) and gate terms gy into st, [value][row][channel]. Up to
// one rank tile lrs holds the sub-chunk's rows, staged by the caller; past
// it each tile's W_dt columns and the segment's kSeg rows are staged here
// in turn, the running sums carried in st.
template <bool LR, bool RT, typename T, typename G>
__device__ void stage_seg(float* st, int r0, int rows, size_t row0, int ch0, int d,
                          const DtSrc& dl, float* lrs, float* wt, const T* __restrict__ z,
                          int ld_z, const G* __restrict__ g, int ld_g) {
  const int tw = rank_ld(dl.R), nt = RT ? rank_tiles(dl.R) : 1;
  const int lr0 = RT ? r0 : 0;  // lrs's first row
  for (int kt = 0; kt < nt; ++kt) {
    const int k0 = kt * kRankTile, kn = RT ? min(tw, round4(dl.R) - k0) : tw;
    if (RT) {
      __syncthreads();  // the last tile's readers of lrs and wt are done
      stage_wt(dl, ch0, d, k0, wt);
      stage_lr_rows(dl, row0 + r0, rows - r0, min(kSeg, rows - r0), k0, lrs);
      __syncthreads();
    }
    for (int i = threadIdx.x; i < kStage; i += kBwdThreads) {
      const int j = i / kBwdCh, c = i % kBwdCh, r = r0 + j, ch = ch0 + c;
      const bool in = r < rows && ch < d;
      const size_t row = row0 + r;
      float dt = 0.f;
      if (in && LR) {
        const float acc = dt_pre_row(lrs + (r - lr0) * tw, wt + c * wt_ld(dl.R), kn,
                                     RT && kt > 0 ? st[i] : 0.f);
        dt = kt == nt - 1 ? softplus(acc + wt[kBwdCh * wt_ld(dl.R) + c]) : acc;
      } else if (in) {
        dt = dl.delta[row * d + ch];
      }
      st[i] = dt;
      if (kt < nt - 1) continue;
      const float zz = in ? to_f32(z[row * ld_z + ch]) : 0.f;
      const float gg = in ? to_f32(g[row * ld_g + ch]) : 0.f;
      st[kStage + i] = gg * (zz * sigmoid(zz));
    }
  }
}

// Pass 1: each (b, sub-chunk, channel tile) from a zero adjoint at the
// sub-chunk's end, a group of 16 states at a time (Grp: d_state > 16), the
// group's C columns staged before it. P and E (the carry handed left) are
// (Bt, n_chunks x n_subs, N, d); a sub-chunk past L has P = 1, E = 0.
template <typename T, typename G, bool Grp, bool LR, bool RT>
__global__ void __launch_bounds__(kBwdThreads)
    scan_bwd_chunk_kernel(DtSrc dl, const T* __restrict__ Cc, int ld_bc,
                          const T* __restrict__ z, int ld_z, const G* __restrict__ g, int ld_g,
                          const float* __restrict__ A, float* __restrict__ P,
                          float* __restrict__ E, int L, int d, int N, int chunk) {
  extern __shared__ __align__(16) float sm1[];
  const int sc = sub_rows(chunk), ns = n_subs(chunk);
  float* Cs = sm1;                         // sc x kMaxN: the group's C columns
  float* st = Cs + sc * kMaxN;             // 2 x kStage: a segment's delta and gy
  float* lrs = st + 2 * kStage;            // sc x rank_ld (low-rank form)
  float* wt = lrs + sc * rank_ld(dl.R);    // kBwdCh x (wt_ld + 1) (low-rank form)
  const int b = blockIdx.z, y = blockIdx.y, c = y / ns, k = y - c * ns;
  const int q = threadIdx.x & 3, chl = threadIdx.x >> 2;
  const int ch0 = blockIdx.x * kBwdCh, ch = ch0 + chl;
  const bool live = ch < d;
  const int t0 = c * chunk + k * sc, rows = min(min(sc, chunk - k * sc), L - t0);
  const size_t row0 = static_cast<size_t>(b) * L + t0;
  if (LR && !RT) {
    stage_wt(dl, ch0, d, 0, wt);
    stage_lr_rows(dl, row0, rows, sc, 0, lrs);
  }
  const size_t o = (static_cast<size_t>(b) * gridDim.y + y) * N * d + ch;
  const int n_end = Grp ? N : 1;
  for (int n0 = 0; n0 < n_end; n0 += kMaxN) {
    const int nq = n0 + q * kQ;
    if (Grp && n0 > 0) __syncthreads();  // the last group's readers of Cs are done
    stage_rows(Cc, ld_bc, row0, rows, rows, N, n0, Cs);
    float a2[kQ], av[kQ], dh[kQ], p[kQ], aup[kQ], cv[kQ];
    load_a4(A, live ? ch : 0, N, nq, a2, av);
#pragma unroll
    for (int i = 0; i < kQ; ++i) dh[i] = 0.f, p[i] = 1.f, aup[i] = 1.f;
    for (int s = (rows - 1) / kSeg; s >= 0; --s) {
      __syncthreads();
      stage_seg<LR, RT, T, G>(st, s * kSeg, rows, row0, ch0, d, dl, lrs, wt, z, ld_z, g,
                              ld_g);
      __syncthreads();
      for (int j = min(kSeg, rows - s * kSeg) - 1; j >= 0; --j) {
        const int r = s * kSeg + j, k = j * kBwdCh + chl;
        const float dt = st[k], gy = st[kStage + k];
        load_q(Cs + r * kMaxN + q * kQ, cv);
#pragma unroll
        for (int i = 0; i < kQ; ++i) {
          const float a = ex2(dt * a2[i]);
          dh[i] = fmaf(aup[i], dh[i], cv[i] * gy);
          aup[i] = a;
          p[i] *= a;
        }
      }
    }
    if (!live) continue;
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      if (nq + i >= N) continue;
      P[o + static_cast<size_t>(nq + i) * d] = p[i];
      E[o + static_cast<size_t>(nq + i) * d] = aup[i] * dh[i];
    }
  }
}

// Pass 2: per (b, state, channel), right to left; E becomes the carry into
// each sub-chunk (0 into the last). The loads of kCarryBatch sub-chunks go
// out together, before their stores: the chain waits on memory once a batch.
constexpr int kCarryBatch = 8;

__global__ void __launch_bounds__(256)
    scan_bwd_carry_kernel(const float* __restrict__ P, float* __restrict__ E, int nc, int Nd) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= Nd) return;
  const size_t base = static_cast<size_t>(blockIdx.y) * nc * Nd + i;
  float chi = 0.f;
  for (int c0 = nc - 1; c0 >= 0; c0 -= kCarryBatch) {
    float e[kCarryBatch], p[kCarryBatch];
#pragma unroll
    for (int k = 0; k < kCarryBatch; ++k) {
      const size_t o = base + static_cast<size_t>(max(c0 - k, 0)) * Nd;
      e[k] = E[o];
      p[k] = P[o];
    }
#pragma unroll
    for (int k = 0; k < kCarryBatch; ++k) {
      if (c0 - k < 0) break;
      E[base + static_cast<size_t>(c0 - k) * Nd] = chi;
      chi = fmaf(p[k], chi, e[k]);
    }
  }
}

// Sums of eight values over the warp's 8 channels (lane bits 2-4) by
// recursive halving: each exchange sends half of what a lane holds, so
// after 4 + 2 + 1 shuffles lane l holds the full sum of value
// 4 b4 + 2 b3 + b2 (its lane bits), summed in a fixed order.
__device__ __forceinline__ float channel_sums8(const float (&v)[8], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float w[4], x[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (b4 ? v[i + 4] : v[i])
           + __shfl_xor_sync(0xffffffffu, b4 ? v[i] : v[i + 4], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    x[i] = (b3 ? w[i + 2] : w[i])
           + __shfl_xor_sync(0xffffffffu, b3 ? w[i] : w[i + 2], 8);
  return (b2 ? x[1] : x[0]) + __shfl_xor_sync(0xffffffffu, b2 ? x[0] : x[1], 4);
}

// The four per-row sums a quad holds, each over its four threads' states:
// lane q of the quad ends with the sum of v[q] (two exchanges, three
// shuffles, in a fixed order).
__device__ __forceinline__ float quad_sums4(const float (&v)[4], int q) {
  const bool b1 = q & 2, b0 = q & 1;
  const float w0 = (b1 ? v[2] : v[0]) + __shfl_xor_sync(0xffffffffu, b1 ? v[0] : v[2], 2);
  const float w1 = (b1 ? v[3] : v[1]) + __shfl_xor_sync(0xffffffffu, b1 ? v[1] : v[3], 2);
  return (b0 ? w1 : w0) + __shfl_xor_sync(0xffffffffu, b0 ? w0 : w1, 1);
}

// The sub-chunk's row values for the tile's kBwdCh channels from ch0,
// [value][row][channel] for rows [0, sp) (zeros past `rows` and past d):
// delta (from memory; the low-rank form forms it after, `form_delta`), u,
// and from z and g
// the gate's terms gy = g silu(z), g silu'(z) and silu(z), each once per
// (row, channel). The low-rank form keeps sigmoid(pre) in place of
// silu(z): K17 writes no gated output, and dt_proj's adjoint needs dpre =
// ddelta sigmoid(pre). Loads go kStageBatch pairs a thread at a time, then
// are formed.
constexpr int kStageBatch = 8;

template <bool LR, typename T, typename G>
__device__ void stage_sub_rows(float* st, int sp, int rows, size_t row0, int ch0, int d,
                               const DtSrc& dl, const T* __restrict__ u, int ld_u,
                               const T* __restrict__ z,
                               int ld_z, const G* __restrict__ g, int ld_g) {
  const int n = sp * kBwdCh;
  for (int i0 = 0; i0 < n; i0 += kStageBatch * kBwdThreads) {
    float dt[kStageBatch], uu[kStageBatch], zz[kStageBatch], gg[kStageBatch];
#pragma unroll
    for (int e = 0; e < kStageBatch; ++e) {
      const int i = i0 + threadIdx.x + e * kBwdThreads;
      const int r = i / kBwdCh, ch = ch0 + i % kBwdCh;
      const bool in = i < n && r < rows && ch < d;
      const size_t row = row0 + r;
      dt[e] = uu[e] = zz[e] = gg[e] = 0.f;
      if (in) {
        if (!LR) dt[e] = dl.delta[row * d + ch];
        uu[e] = to_f32(u[row * ld_u + ch]);
        zz[e] = to_f32(z[row * ld_z + ch]);
        gg[e] = to_f32(g[row * ld_g + ch]);
      }
    }
#pragma unroll
    for (int e = 0; e < kStageBatch; ++e) {
      const int i = i0 + threadIdx.x + e * kBwdThreads;
      if (i >= n) break;
      const float sig = sigmoid(zz[e]), sg = zz[e] * sig;
      if (!LR) st[i] = dt[e];
      st[n + i] = uu[e];
      st[2 * n + i] = gg[e] * sg;
      st[3 * n + i] = gg[e] * (sig + sg * (1.f - sig));
      if (!LR) st[4 * n + i] = sg;
    }
  }
}

// Pass 3: each (b, chunk, channel tile), its sub-chunks left to right, with
// the true carry into each (pass 2) and the entry state of each (h0s, then
// the last sub-chunk's exit state through hx, (Bt, n_chunks, N, d)). Per
// row: ddelta (K15, K19), du (fp32), dz (ZT, row stride ld_dz) and, when yg
// is given, the gated output (C.h + D u) silu(z) in T; the block's partial
// sums of dB and dC over its channels (dBp, dCp: (tiles, Bt L, N)); per (b,
// sub-chunk) the partial dA (N, d) and dD (d).
//
// Time-parallel over a sub-chunk's rows: for each round of 8 channels and
// each group of 16 states, warp w takes rows 8 w .. 8 w + 7 of the
// sub-chunk, a thread four states of one channel. It takes a_t = exp(delta_t
// A) of its 8 rows once, into registers, and forms its segment's summaries
// from them: P = prod a_t, H = the state at its end from a zero state, E =
// a_t0 dh_t0 from a zero adjoint at its end. Through shared memory each
// thread then chains the segments before its own from the sub-chunk's entry
// state, h = P h + H, and those after it from the carry, X = P X + E, in
// segment order (a fixed order: reruns are bit-identical); walks its rows
// back for dh_t = a_{t+1} dh_{t+1} + C_t gy_t (kept in registers) and
// forward for h_t = a_t h_{t-1} + delta_t u_t B_t, forming each row's
// outputs. The recurrence is never inverted. Sums over the 16 states are
// quad shuffles (`quad_sums4`); dB and dC sum over the round's 8 channels
// by `channel_sums8` and over the rounds in order in registers. A row's
// outputs go into staged values already read, and leave coalesced once the
// rounds are done. The row values of the tile's 64 channels, and the
// group's B and C columns, are staged once a (sub-chunk, group). Grp
// (d_state > 16): the groups of 16 states in order; the per-row sums over
// the states carry from group to group, du in its fp32 output (each group's
// flush adds to it), ddelta in its output or, in the low-rank form, in
// shared memory (dsm), and C.h in shared memory (ysm); the gated terms are
// written after the last group.
//
// The low-rank form stages W_dt's columns once a block and the sub-chunk's
// dt_lr rows once a sub-chunk up to one rank tile; past it each use (the
// delta of each group's staging, and the epilogue) stages the tiles in
// turn.
//
// The low-rank form (LR, K17) writes no ddelta. After a sub-chunk's last
// group its flush forms dpre = ddelta sigmoid(pre) (zero past `rows` and
// d) in the staged slots, and the block forms dt_proj's adjoint there, as
// the TPU kernel's body does (`_bwd_kernel_lr`), in fp32 FMAs on the CUDA
// cores: through a transposed copy of dpre (row stride sp | 1, odd, so that
// rows and channels both read without bank conflicts), warps 0-3 sum
// ddt_lr[r, k] over the tile's 64 channels in channel order (partials per
// channel tile) and warps 4-7 dW_dt[k, c] = dt_lr^T dpre and db_dt[c] over
// the sub-chunk's rows in row order, carried across the chunk's sub-chunks
// through their own slots of the (b, chunk) partials; a thread takes two
// rows or channels and four ranks at a time, rank tile by rank tile (each
// output is one rank's: no sum crosses a tile).
template <typename T, typename G, typename ZT, bool Grp, bool LR, bool RT>
__global__ void __launch_bounds__(kBwdThreads, 2)
    scan_bwd_out_kernel(const T* __restrict__ u, int ld_u, DtSrc dl,
                        const T* __restrict__ Bc, const T* __restrict__ Cc, int ld_bc,
                        const T* __restrict__ z, int ld_z, const G* __restrict__ g, int ld_g,
                        const float* __restrict__ A, const float* __restrict__ D,
                        const float* __restrict__ h0s, const float* __restrict__ carry,
                        float* __restrict__ hx, float* __restrict__ ddt,
                        float* __restrict__ du, ZT* __restrict__ dz, int ld_dz,
                        T* __restrict__ yg, float* __restrict__ dBp, float* __restrict__ dCp,
                        float* __restrict__ dAp, float* __restrict__ dDp, DtGrad dg, int Bt,
                        int L, int d, int N, int chunk) {
  extern __shared__ __align__(16) float sm[];
  // The staged rows: the sub-chunk's sc rows, zeros on to whole segments.
  const int sc = sub_rows(chunk), ns = n_subs(chunk), sp = p3_rows(chunk);
  const int n_seg = sp / kP3Rows;
  float* Bs = sm;                                                  // sp x kMaxN
  float* Cs = Bs + sp * kMaxN;                                     // sp x kMaxN
  float* st = Cs + sp * kMaxN;                                     // kRowVals x sp x kBwdCh
  float4* sum = reinterpret_cast<float4*>(st + kRowVals * sp * kBwdCh);  // n_seg x 3 x 32
  float* ysm = reinterpret_cast<float*>(sum + n_seg * 3 * 32);     // sp x kBwdCh, Grp
  float* dsm = ysm + (Grp ? sp * kBwdCh : 0);                      // sp x kBwdCh, Grp and LR
  float* wt = dsm + (Grp && LR ? sp * kBwdCh : 0);                 // kBwdCh x (wt_ld + 1), LR
  float* lrs = wt + (LR ? kBwdCh * (wt_ld(dl.R) + 1) : 0);         // kSubRows x rank_ld, LR
  const int b = blockIdx.z, c = blockIdx.y, nc = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, q = lane & 3, c8 = lane >> 2;
  const int ch0 = blockIdx.x * kBwdCh, r0 = w * kP3Rows;
  const bool has_seg = w < n_seg;  // uniform over the warp
  const int sv = sp * kBwdCh;      // one staged value's floats
  if (LR && !RT) stage_wt(dl, ch0, d, 0, wt);

  for (int k = 0; k < ns; ++k) {
    const int t0 = c * chunk + k * sc, rows = min(min(sc, chunk - k * sc), L - t0);
    const size_t row0 = static_cast<size_t>(b) * L + t0;
    const size_t slice = (static_cast<size_t>(b) * nc + c) * ns + k;
    if (LR && !RT) {
      __syncthreads();  // the last sub-chunk's readers of lrs are done
      stage_lr_rows(dl, row0, rows, kSubRows, 0, lrs);
    }
    // Past one rank tile: tile kt of W_dt's columns and the sub-chunk's
    // dt_lr rows (uniform over the block).
    auto stage_tile = [&](int kt) {
      if (!RT) return;
      __syncthreads();  // the readers of the last tile are done
      stage_wt(dl, ch0, d, kt * kRankTile, wt);
      stage_lr_rows(dl, row0, rows, kSubRows, kt * kRankTile, lrs);
      __syncthreads();
    };

    const int n_end = Grp ? N : 1;
    for (int n0 = 0; n0 < n_end; n0 += kMaxN) {
      const bool first = !Grp || n0 == 0, last = !Grp || n0 + kMaxN >= N;
      const int nq = n0 + q * kQ;  // the thread's first state
      float acc[kP3Rows];          // dB or dC of (row, state) over the rounds' channels
#pragma unroll
      for (int j = 0; j < kP3Rows; ++j) acc[j] = 0.f;
      for (int chr = 0; chr < kBwdCh; chr += kRoundCh) {
        const int ct = chr + c8, ch = ch0 + ct;
        const bool live = ch < d;
        const int cl = live ? ch : 0;  // channels past d compute on zeros and write nothing
        // The round's loads from device memory, issued first: A's row, D,
        // the segment's entry state (h0s, or the last sub-chunk's exit) and
        // the carry into the sub-chunk.
        float a2[kQ], av[kQ], h[kQ], X[kQ];
        load_a4(A, cl, N, nq, a2, av);
        const float Dv = D[cl];
        {
          const size_t o = (static_cast<size_t>(b) * nc + c) * N * d + cl;
          const size_t oc = slice * N * d + cl;
#pragma unroll
          for (int i = 0; i < kQ; ++i) {
            const int n = nq + i;
            h[i] = n >= N || !live ? 0.f : (k == 0 ? h0s : hx)[o + static_cast<size_t>(n) * d];
            X[i] = n < N && live ? carry[oc + static_cast<size_t>(n) * d] : 0.f;
          }
        }
        if (chr == 0) {
          __syncthreads();  // the last group's readers of Bs, Cs, st and sum are done
          stage_rows(Bc, ld_bc, row0, rows, sp, N, n0, Bs);
          stage_rows(Cc, ld_bc, row0, rows, sp, N, n0, Cs);
          stage_sub_rows<LR, T, G>(st, sp, rows, row0, ch0, d, dl, u, ld_u, z, ld_z, g, ld_g);
          if constexpr (LR) {
            for (int kt = 0; kt < (RT ? rank_tiles(dl.R) : 1); ++kt) {
              stage_tile(kt);
              form_delta<RT>(dl, lrs, wt, kt * kRankTile, ch0, d, rows, sp, st, st + 4 * sv);
            }
          }
        }
        __syncthreads();  // the staging, and the last round's readers of sum
        const int cs = ct;  // the channel's column in st

        // a_t once, and the segment's summaries P, H, E.
        float a[kP3Rows][kQ];
        if (has_seg) {
          float P[kQ], Hs[kQ], Ds[kQ], aup[kQ];
#pragma unroll
          for (int i = 0; i < kQ; ++i) P[i] = 1.f, Hs[i] = 0.f, Ds[i] = 0.f, aup[i] = 1.f;
#pragma unroll
          for (int j = 0; j < kP3Rows; ++j) {
            const int x = (r0 + j) * kBwdCh + cs;
            const float dt = st[x], dtu = dt * st[sv + x];
            float bv[kQ];
            load_q(Bs + (r0 + j) * kMaxN + q * kQ, bv);
#pragma unroll
            for (int i = 0; i < kQ; ++i) {
              a[j][i] = ex2(dt * a2[i]);
              Hs[i] = fmaf(a[j][i], Hs[i], dtu * bv[i]);
              P[i] *= a[j][i];
            }
          }
#pragma unroll
          for (int j = kP3Rows - 1; j >= 0; --j) {
            const float gy = st[2 * sv + (r0 + j) * kBwdCh + cs];
            float cv[kQ];
            load_q(Cs + (r0 + j) * kMaxN + q * kQ, cv);
#pragma unroll
            for (int i = 0; i < kQ; ++i) {
              Ds[i] = fmaf(aup[i], Ds[i], cv[i] * gy);
              aup[i] = a[j][i];
            }
          }
          sum[(w * 3) * 32 + lane] = make_float4(P[0], P[1], P[2], P[3]);
          sum[(w * 3 + 1) * 32 + lane] = make_float4(Hs[0], Hs[1], Hs[2], Hs[3]);
          sum[(w * 3 + 2) * 32 + lane] = make_float4(aup[0] * Ds[0], aup[1] * Ds[1],
                                                     aup[2] * Ds[2], aup[3] * Ds[3]);
        }
        __syncthreads();

        float dA[kQ] = {0.f, 0.f, 0.f, 0.f}, dD = 0.f;
        if (has_seg) {
          // The segment's entry state and the adjoint carried into its end.
          for (int s = 0; s < w; ++s) {
            const float4 P4 = sum[(s * 3) * 32 + lane], H4 = sum[(s * 3 + 1) * 32 + lane];
            h[0] = fmaf(P4.x, h[0], H4.x), h[1] = fmaf(P4.y, h[1], H4.y);
            h[2] = fmaf(P4.z, h[2], H4.z), h[3] = fmaf(P4.w, h[3], H4.w);
          }
          for (int s = n_seg - 1; s > w; --s) {
            const float4 P4 = sum[(s * 3) * 32 + lane], E4 = sum[(s * 3 + 2) * 32 + lane];
            X[0] = fmaf(P4.x, X[0], E4.x), X[1] = fmaf(P4.y, X[1], E4.y);
            X[2] = fmaf(P4.z, X[2], E4.z), X[3] = fmaf(P4.w, X[3], E4.w);
          }
          // Back: dh_t = a_{t+1} dh_{t+1} + C_t gy_t, from a_end dh_end = X.
          float dh[kP3Rows][kQ];
#pragma unroll
          for (int j = kP3Rows - 1; j >= 0; --j) {
            const float gy = st[2 * sv + (r0 + j) * kBwdCh + cs];
            float cv[kQ];
            load_q(Cs + (r0 + j) * kMaxN + q * kQ, cv);
#pragma unroll
            for (int i = 0; i < kQ; ++i) {
              dh[j][i] = j == kP3Rows - 1 ? X[i] + cv[i] * gy
                                          : fmaf(a[j + 1][i], dh[j + 1][i], cv[i] * gy);
            }
          }
          // Forward: the states and every row's outputs.
#pragma unroll
          for (int j = 0; j < kP3Rows; ++j) {
            const int r = r0 + j, x = r * kBwdCh + cs;
            const float dt = st[x], uu = st[sv + x], gy = st[2 * sv + x];
            const float dtu = dt * uu;
            float bv[kQ], cv[kQ], pv[8];  // dB then dC partials of the 4 states
            load_q(Bs + r * kMaxN + q * kQ, bv);
            load_q(Cs + r * kMaxN + q * kQ, cv);
            float sdd = 0.f, sb = 0.f, sy = 0.f;
#pragma unroll
            for (int i = 0; i < kQ; ++i) {
              const float hn = fmaf(a[j][i], h[i], dtu * bv[i]);
              const float daa = dh[j][i] * h[i] * a[j][i];
              sdd = fmaf(daa, av[i], sdd);
              sb = fmaf(dh[j][i], bv[i], sb);
              sy = fmaf(hn, cv[i], sy);
              dA[i] = fmaf(daa, dt, dA[i]);
              pv[i] = dh[j][i] * dtu;  // 0 past d: dt, u, gy, h and dh are
              pv[kQ + i] = hn * gy;    // staged or carried as zeros there
              h[i] = hn;
            }
            // Lane q: the sum over the states of daa A (q 0), dh B (1) or
            // h C (2, 3); lane 0 also takes lane 1's, for ddelta.
            const float red[4] = {sdd, sb, sy, sy};
            float tot = quad_sums4(red, q);
            const float sb_all = __shfl_xor_sync(0xffffffffu, tot, 1);
            acc[j] += channel_sums8(pv, lane);
            if (Grp) {
              const int yk = r * kBwdCh + ct;
              if (!first && q >= 2) tot += ysm[yk];
              if (!last) {
                __syncwarp();  // the quad's reads of ysm[yk] before its write
                if (q == 2) ysm[yk] = tot;
              }
            }
            // Each lane's output into a staged value every lane has read
            // (it fed the shuffles): ddelta over delta, du over u, dz over
            // gy, the gated output over silu(z) (not in the low-rank form,
            // whose slot holds sigmoid(pre)); `flush` writes them out.
            if (q == 0 && last && r < rows) dD = fmaf(gy, uu, dD);
            const float ypre = tot + Dv * uu;
            const float du_b = tot * dt, du_v = last ? du_b + gy * Dv : du_b;
            const float gate = st[(q == 2 ? 3 : 4) * sv + x];  // q 2, 3: g silu'(z), silu(z)
            if (!LR || q != 3)
              st[(q < 2 ? q : q == 2 ? 2 : 4) * sv + x] =
                  q == 0 ? tot + sb_all * uu : q == 1 ? du_v : ypre * gate;
          }
        }
        // dA and dD summed over the segments in order; the sub-chunk's exit
        // states for the next one.
        __syncthreads();  // every thread is done reading sum
        float* dDx = reinterpret_cast<float*>(sum + n_seg * 32);
        if (has_seg) {
          sum[w * 32 + lane] = make_float4(dA[0], dA[1], dA[2], dA[3]);
          dDx[w * 32 + lane] = dD;
          if (ns > 1 && w == n_seg - 1 && live) {
            const size_t o = (static_cast<size_t>(b) * nc + c) * N * d + ch;
#pragma unroll
            for (int i = 0; i < kQ; ++i)
              if (nq + i < N) hx[o + static_cast<size_t>(nq + i) * d] = h[i];
          }
        }
        __syncthreads();
        // The staged outputs, coalesced, after the last round; in the
        // low-rank form ddelta stays in shared memory (dpre after the last
        // group).
        if (chr == kBwdCh - kRoundCh) {
          for (int i = tid; i < sv; i += kBwdThreads) {
            const int r = i / kBwdCh, ch2 = ch0 + i % kBwdCh;
            const bool in = r < rows && ch2 < d;
            const size_t row = row0 + r;
            if (LR) {
              float dd = st[i];
              if (Grp) {
                if (!first) dd = dsm[i] + dd;
                if (!last) dsm[i] = dd;
              }
              if (last) st[i] = in ? dd * st[4 * sv + i] : 0.f;
            }
            if (!in) continue;
            if (!LR) ddt[row * d + ch2] = first ? st[i] : ddt[row * d + ch2] + st[i];
            du[row * d + ch2] = first ? st[sv + i] : du[row * d + ch2] + st[sv + i];
            if (last) {
              dz[row * ld_dz + ch2] = from_f32<ZT>(st[2 * sv + i]);
              if (yg != nullptr) yg[row * d + ch2] = from_f32<T>(st[4 * sv + i]);
            }
          }
        }
        if (w == 0 && live) {
          float4 t = sum[lane];
          float tD = dDx[lane];
          for (int s = 1; s < n_seg; ++s) {
            const float4 v = sum[s * 32 + lane];
            t.x += v.x, t.y += v.y, t.z += v.z, t.w += v.w;
            tD += dDx[s * 32 + lane];
          }
          const float tv[kQ] = {t.x, t.y, t.z, t.w};
#pragma unroll
          for (int i = 0; i < kQ; ++i)
            if (nq + i < N) dAp[(slice * N + nq + i) * d + ch] = tv[i];
          if (q == 0 && last) dDp[slice * d + ch] = tD;
        }
      }
      // The rounds' dB and dC sums: lane 4 c8 + q holds dB (c8 < 4) or dC of
      // state nq + (c8 & 3) for each of its segment's rows.
      if (has_seg) {
        const int n = nq + (c8 & 3);
        float* dst = c8 < 4 ? dBp : dCp;
#pragma unroll
        for (int j = 0; j < kP3Rows; ++j)
          if (r0 + j < rows && n < N)
            dst[(static_cast<size_t>(blockIdx.x) * Bt * L + row0 + r0 + j) * N + n] = acc[j];
      }
    }
    if constexpr (LR) {
      // dt_proj's adjoint of the sub-chunk, from dpre (slot 0, [row][channel])
      // through its transpose dT (slots 1-2, [channel][row], row stride dld).
      // Warps 0-3 take ddt_lr, thread (p, kq) rows p and p + 32; warps 4-7
      // dW_dt and db_dt, thread (p, kq) channels p and p + 32; kq takes
      // ranks 4 kq .. 4 kq + 3, then 16 on.
      const int dld = sp | 1, wld = wt_ld(dl.R), tw = rank_ld(dl.R);
      float* dT = st + sv;
      __syncthreads();  // dpre formed, every staged slot read
      for (int i = tid; i < sv; i += kBwdThreads) dT[(i % kBwdCh) * dld + i / kBwdCh] = st[i];
      __syncthreads();
      const int p = lane, kq = w & 3;
      const size_t bc = static_cast<size_t>(b) * nc + c;   // the (b, chunk) slice
      for (int kt = 0; kt < (RT ? rank_tiles(dl.R) : 1); ++kt) {
        stage_tile(kt);
        const int k0 = kt * kRankTile, kn = RT ? min(tw, round4(dl.R) - k0) : tw;
        for (int k4 = 4 * kq; k4 < kn; k4 += 16) {
          const int kr = k0 + k4;  // the four ranks' first
          float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
          if (w < 4) {
            // ddt_lr: over the tile's channels in order.
            for (int cc = 0; cc < kBwdCh; ++cc) {
              const float4 wv = *reinterpret_cast<const float4*>(wt + cc * wld + k4);
              const float x0 = dT[cc * dld + p], x1 = dT[cc * dld + p + 32];
              s0[0] = fmaf(x0, wv.x, s0[0]), s1[0] = fmaf(x1, wv.x, s1[0]);
              s0[1] = fmaf(x0, wv.y, s0[1]), s1[1] = fmaf(x1, wv.y, s1[1]);
              s0[2] = fmaf(x0, wv.z, s0[2]), s1[2] = fmaf(x1, wv.z, s1[2]);
              s0[3] = fmaf(x0, wv.w, s0[3]), s1[3] = fmaf(x1, wv.w, s1[3]);
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = p + 32 * h;
              if (r >= rows) continue;
              float* o = dg.dlr + (static_cast<size_t>(blockIdx.x) * Bt * L + row0 + r) * dl.R;
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (kr + e < dl.R) o[kr + e] = h ? s1[e] : s0[e];
            }
          } else {
            // dW_dt: over the rows in order, carried from the chunk's earlier
            // sub-chunks through the thread's own slots.
            float* w0 = dg.dw + (bc * dl.R + kr) * d + ch0 + p;
            const bool in0 = ch0 + p < d, in1 = ch0 + p + 32 < d;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const bool ke = k > 0 && kr + e < dl.R;
              s0[e] = ke && in0 ? w0[static_cast<size_t>(e) * d] : 0.f;
              s1[e] = ke && in1 ? w0[static_cast<size_t>(e) * d + 32] : 0.f;
            }
            for (int r = 0; r < rows; ++r) {
              const float4 v = *reinterpret_cast<const float4*>(lrs + r * tw + k4);
              const float x0 = dT[p * dld + r], x1 = dT[(p + 32) * dld + r];
              s0[0] = fmaf(v.x, x0, s0[0]), s1[0] = fmaf(v.x, x1, s1[0]);
              s0[1] = fmaf(v.y, x0, s0[1]), s1[1] = fmaf(v.y, x1, s1[1]);
              s0[2] = fmaf(v.z, x0, s0[2]), s1[2] = fmaf(v.z, x1, s1[2]);
              s0[3] = fmaf(v.w, x0, s0[3]), s1[3] = fmaf(v.w, x1, s1[3]);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (kr + e >= dl.R) continue;
              if (in0) w0[static_cast<size_t>(e) * d] = s0[e];
              if (in1) w0[static_cast<size_t>(e) * d + 32] = s1[e];
            }
          }
        }
      }
      if (w == 4) {
        float* o = dg.db + bc * d + ch0 + p;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (ch0 + p + 32 * h >= d) continue;
          float sb = k > 0 ? o[32 * h] : 0.f;
          for (int r = 0; r < rows; ++r) sb += dT[(p + 32 * h) * dld + r];
          o[32 * h] = sb;
        }
      }
    }
  }
}

// out[i] = sum over s of in[s n + i], in order of s, for groups of up to
// kGroup slices (grid.y groups); with A, times -exp(log(-A)) of element
// i = (state, channel) of an (N, d) array.
__global__ void __launch_bounds__(256)
    sum_slices_kernel(const float* __restrict__ in, float* __restrict__ out, int ns, size_t n,
                      const float* __restrict__ A, int N, int d) {
  const size_t i = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n) return;
  const int s0 = blockIdx.y * kGroup, s1 = min(ns, s0 + kGroup);
  float acc = 0.f;
  for (int s = s0; s < s1; ++s) acc += in[static_cast<size_t>(s) * n + i];
  if (A != nullptr) {
    const int st = static_cast<int>(i / d), ch = static_cast<int>(i % d);
    acc *= -expf(logf(-A[ch * N + st]));
  }
  out[static_cast<size_t>(blockIdx.y) * n + i] = acc;
}

// Floats of scratch `reduce_slices` needs for ns slices of n.
size_t reduce_tmp(size_t ns, size_t n) {
  size_t total = 0;
  while (ns > kGroup) {
    ns = (ns + kGroup - 1) / kGroup;
    total += ns * n;
  }
  return total;
}

// out = the sum of ns slices of n floats, in a fixed order (groups of
// kGroup, then the groups' sums, ...); tmp holds reduce_tmp(ns, n) floats.
cudaError_t reduce_slices(const float* in, float* out, int ns, size_t n, float* tmp,
                          cudaStream_t s, const float* A = nullptr, int N = 0, int d = 1) {
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  while (ns > kGroup) {
    const int groups = (ns + kGroup - 1) / kGroup;
    sum_slices_kernel<<<dim3(blocks, groups), 256, 0, s>>>(in, tmp, ns, n, nullptr, 0, 1);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    in = tmp;
    tmp += static_cast<size_t>(groups) * n;
    ns = groups;
  }
  sum_slices_kernel<<<dim3(blocks, 1), 256, 0, s>>>(in, out, ns, n, A, N, d);
  return cudaGetLastError();
}

// --- weight gradients: part[slice, p, q] = sum over the slice's rows m of
// X[m, p] Y[m, q] ----------------------------------------------------------

// fp32: a block owns 64 x 64 of (p, q), a thread 4 x 4, full fp32 FMAs.
__global__ void __launch_bounds__(256)
    wgrad_f32_kernel(const float* __restrict__ X, int ldx, const float* __restrict__ Y, int ldy,
                     float* __restrict__ part, int M, int P, int Q) {
  __shared__ float Xs[16][65];
  __shared__ float Ys[16][65];
  const int p0 = blockIdx.y * 64, q0 = blockIdx.x * 64, slice = blockIdx.z;
  const int mb = slice * kWRows, me = min(M, mb + kWRows);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4] = {};
  for (int m0 = mb; m0 < me; m0 += 16) {
    for (int i = threadIdx.x; i < 64 * 16; i += 256) {
      const int k = i >> 6, r = i & 63, m = m0 + k;
      Xs[k][r] = m < me && p0 + r < P ? X[static_cast<size_t>(m) * ldx + p0 + r] : 0.f;
      Ys[k][r] = m < me && q0 + r < Q ? Y[static_cast<size_t>(m) * ldy + q0 + r] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Xs[k][ty * 4 + i], b[i] = Ys[k][tx * 4 + i];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = part + static_cast<size_t>(slice) * P * Q;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + ty * 4 + i, qq = q0 + tx * 4 + j;
      if (p < P && qq < Q) out[static_cast<size_t>(p) * Q + qq] = acc[i][j];
    }
}

int wgrad_slices(int M) { return (M + kWRows - 1) / kWRows; }

// out[P, Q] = X^T Y over M rows, in fixed order; part holds
// wgrad_slices(M) P Q floats, tmp reduce_tmp of that.
template <typename T>
cudaError_t wgrad(const T* X, int ldx, const T* Y, int ldy, float* part, float* out, float* tmp,
                  int M, int P, int Q, cudaStream_t s) {
  const int ns = wgrad_slices(M);
  if (sizeof(T) == 2) {
    // wgmma reads X and Y as 16-byte row pieces.
    if (ldx % 8 || ldy % 8 ||
        (reinterpret_cast<uintptr_t>(X) | reinterpret_cast<uintptr_t>(Y)) % 16)
      return cudaErrorMisalignedAddress;
    const dim3 grid((Q + kGemmTile - 1) / kGemmTile, (P + kGemmTile - 1) / kGemmTile, ns);
    cudaError_t err = gemm_launch<true, float>(grid, reinterpret_cast<const bf16*>(X), ldx,
                                               reinterpret_cast<const bf16*>(Y), ldy, part, Q, P,
                                               Q, M, 0, s);
    if (err != cudaSuccess) return err;
  } else {
    wgrad_f32_kernel<<<dim3((Q + 63) / 64, (P + 63) / 64, ns), 256, 0, s>>>(
        reinterpret_cast<const float*>(X), ldx, reinterpret_cast<const float*>(Y), ldy, part, M,
        P, Q);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_slices(part, out, ns, static_cast<size_t>(P) * Q, tmp, s);
}

// --- dt_proj's adjoint over channel tiles, inside K19 ------------------------

constexpr int kDtCh = 128;                 // channels of one block, a thread each
constexpr int kDtTile = 256;               // rows of one block
constexpr int kDtRows = 16;                // rows staged at once
constexpr int kDtMaxR = kMaxR * kMaxRT;    // dt_rank

// One block per (kDtTile rows, kDtCh channels). A thread holds its
// channel's column of W_dt (R, d) in registers and recomputes pre as the
// forward forms it (`dt_pre` on the dt_lr rows, rounded as stored);
// dpre = ddelta sigmoid(pre); dW_dt and db_dt sum over the block's rows in
// row order (partials (row tiles, R, d) and (row tiles, d)). ddt_lr = dpre
// W_dt^T sums over the block's channels in channel order, four running
// sums (channel mod 4) added in a fixed order (partials (channel tiles,
// M, R), summed over the tiles in order by the caller). Any d; R <= 64
// (`dt_bwd_tiled_kernel` past it).
template <typename LrT, int NW>
__global__ void __launch_bounds__(kDtCh)
    dt_bwd_kernel(const float* __restrict__ ddt, const LrT* __restrict__ lr, int ld_lr,
                  const float* __restrict__ wdt, const float* __restrict__ bdt,
                  float* __restrict__ dlr_p, float* __restrict__ dw_p, float* __restrict__ db_p,
                  int M, int d, int R) {
  __shared__ __align__(16) float lrs[kDtRows * kDtMaxR];
  __shared__ float dps[kDtRows][kDtCh + 1];
  __shared__ float wts[kDtMaxR][kDtCh + 1];
  const int lr_ld = round4(R);
  const int ch0 = blockIdx.x * kDtCh, cn = min(kDtCh, d - ch0);
  const int tid = threadIdx.x, ch = ch0 + tid;
  const bool live = tid < cn;
  const size_t m_begin = static_cast<size_t>(blockIdx.y) * kDtTile;
  const int tile_rows = static_cast<int>(min(static_cast<size_t>(kDtTile), M - m_begin));
  float wr[NW], gw[NW];
  load_wdt(wdt, live ? ch : 0, d, live ? R : 0, wr);
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    gw[k] = 0.f;
    if (k < R) wts[k][tid] = wr[k];
  }
  const float bias = live ? bdt[ch] : 0.f;
  float gb = 0.f;
  for (int r0 = 0; r0 < tile_rows; r0 += kDtRows) {
    const int rows = min(kDtRows, tile_rows - r0);
    const size_t m0 = m_begin + r0;
    __syncthreads();  // the last batch's reads of lrs and dps are done
    for (int i = tid; i < kDtRows * lr_ld; i += kDtCh) {
      const int r = i / lr_ld, k = i % lr_ld;
      lrs[i] = r < rows && k < R ? to_f32(lr[(m0 + r) * ld_lr + k]) : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < kDtRows; ++r) {
      const float* lrr = lrs + r * lr_ld;
      // Rows past the tile have ddelta 0, so dpre 0.
      const float dd = live && r < rows ? ddt[(m0 + r) * d + ch] : 0.f;
      const float dpv = dd * sigmoid(dt_pre(lrr, wr, R) + bias);
      dps[r][tid] = dpv;
      gb += dpv;
#pragma unroll
      for (int k = 0; k < NW; k += 4) {
        if (k >= R) break;
        const float4 v = *reinterpret_cast<const float4*>(lrr + k);
        gw[k] = fmaf(v.x, dpv, gw[k]);
        gw[k + 1] = fmaf(v.y, dpv, gw[k + 1]);
        gw[k + 2] = fmaf(v.z, dpv, gw[k + 2]);
        gw[k + 3] = fmaf(v.w, dpv, gw[k + 3]);
      }
    }
    __syncthreads();
    for (int i = tid; i < rows * R; i += kDtCh) {
      const int r = i / R, k = i % R;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int c0 = 0; c0 < cn; c0 += 4) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c0 + e < cn) acc[e] = fmaf(dps[r][c0 + e], wts[k][c0 + e], acc[e]);
      }
      dlr_p[(static_cast<size_t>(blockIdx.x) * M + m0 + r) * R + k] =
          (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
  }
  if (!live) return;
#pragma unroll
  for (int k = 0; k < NW; ++k)
    if (k < R) dw_p[(static_cast<size_t>(blockIdx.y) * R + k) * d + ch] = gw[k];
  db_p[static_cast<size_t>(blockIdx.y) * d + ch] = gb;
}

// dt_rank > 64: the same sums over rank tiles of kDtMaxR, the kernel above
// looped. A first sweep forms each row's dpre = ddelta sigmoid(pre) (pre
// over the rank tiles in `dt_pre`'s order, each tile of W_dt's column in
// registers) and writes it over ddelta, which nothing reads after; then each
// rank tile runs the row loop above on it: dW_dt and db_dt in row order,
// ddt_lr over the block's channels as above.
template <typename LrT>
__global__ void __launch_bounds__(kDtCh)
    dt_bwd_tiled_kernel(float* __restrict__ ddt, const LrT* __restrict__ lr, int ld_lr,
                        const float* __restrict__ wdt, const float* __restrict__ bdt,
                        float* __restrict__ dlr_p, float* __restrict__ dw_p,
                        float* __restrict__ db_p, int M, int d, int R) {
  __shared__ __align__(16) float lrs[kDtRows * kDtMaxR];
  __shared__ float dps[kDtRows][kDtCh + 1];
  __shared__ float wts[kDtMaxR][kDtCh + 1];
  const int ch0 = blockIdx.x * kDtCh, cn = min(kDtCh, d - ch0);
  const int tid = threadIdx.x, ch = ch0 + tid;
  const bool live = tid < cn;
  const size_t m_begin = static_cast<size_t>(blockIdx.y) * kDtTile;
  const int tile_rows = static_cast<int>(min(static_cast<size_t>(kDtTile), M - m_begin));
  const float bias = live ? bdt[ch] : 0.f;
  // The rows' dt_lr ranks k0 .. k0 + kn - 1 (lr_ld = round4(kn) to a row).
  auto stage = [&](size_t m0, int rows, int k0, int kn) {
    const int lr_ld = round4(kn);
    for (int i = tid; i < kDtRows * lr_ld; i += kDtCh) {
      const int r = i / lr_ld, k = i % lr_ld;
      lrs[i] = r < rows && k < kn ? to_f32(lr[(m0 + r) * ld_lr + k0 + k]) : 0.f;
    }
  };
  for (int r0 = 0; r0 < tile_rows; r0 += kDtRows) {
    const int rows = min(kDtRows, tile_rows - r0);
    const size_t m0 = m_begin + r0;
    float acc[kDtRows];
#pragma unroll
    for (int r = 0; r < kDtRows; ++r) acc[r] = 0.f;
    for (int k0 = 0; k0 < R; k0 += kDtMaxR) {
      const int kn = min(kDtMaxR, R - k0), lr_ld = round4(kn);
      float wr[kDtMaxR];
      load_wdt(wdt + static_cast<size_t>(k0) * d, live ? ch : 0, d, live ? kn : 0, wr);
      __syncthreads();  // the last tile's readers of lrs are done
      stage(m0, rows, k0, kn);
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kDtMaxR; k += 4) {
        if (k >= kn) break;
#pragma unroll
        for (int r = 0; r < kDtRows; ++r) {
          const float4 v = *reinterpret_cast<const float4*>(lrs + r * lr_ld + k);
          acc[r] = fmaf(v.x, wr[k], acc[r]);
          acc[r] = fmaf(v.y, wr[k + 1], acc[r]);
          acc[r] = fmaf(v.z, wr[k + 2], acc[r]);
          acc[r] = fmaf(v.w, wr[k + 3], acc[r]);
        }
      }
    }
    if (!live) continue;
#pragma unroll
    for (int r = 0; r < kDtRows; ++r) {
      if (r >= rows) break;
      float* p = ddt + (m0 + r) * d + ch;
      *p = *p * sigmoid(acc[r] + bias);
    }
  }
  float gb = 0.f;
  for (int k0 = 0; k0 < R; k0 += kDtMaxR) {
    const int kn = min(kDtMaxR, R - k0), lr_ld = round4(kn);
    float gw[kDtMaxR];
#pragma unroll
    for (int k = 0; k < kDtMaxR; ++k) gw[k] = 0.f;
    __syncthreads();  // the last tile's readers of wts are done
    for (int k = 0; k < kn; ++k) wts[k][tid] = live ? wdt[static_cast<size_t>(k0 + k) * d + ch] : 0.f;
    for (int r0 = 0; r0 < tile_rows; r0 += kDtRows) {
      const int rows = min(kDtRows, tile_rows - r0);
      const size_t m0 = m_begin + r0;
      __syncthreads();  // the last batch's reads of lrs and dps are done
      stage(m0, rows, k0, kn);
      __syncthreads();
      for (int r = 0; r < kDtRows; ++r) {
        const float* lrr = lrs + r * lr_ld;
        const float dpv = live && r < rows ? ddt[(m0 + r) * d + ch] : 0.f;
        dps[r][tid] = dpv;
        if (k0 == 0) gb += dpv;
#pragma unroll
        for (int k = 0; k < kDtMaxR; k += 4) {
          if (k >= kn) break;
          const float4 v = *reinterpret_cast<const float4*>(lrr + k);
          gw[k] = fmaf(v.x, dpv, gw[k]);
          gw[k + 1] = fmaf(v.y, dpv, gw[k + 1]);
          gw[k + 2] = fmaf(v.z, dpv, gw[k + 2]);
          gw[k + 3] = fmaf(v.w, dpv, gw[k + 3]);
        }
      }
      __syncthreads();
      for (int i = tid; i < rows * kn; i += kDtCh) {
        const int r = i / kn, k = i % kn;
        float a4[4] = {0.f, 0.f, 0.f, 0.f};
        for (int c0 = 0; c0 < cn; c0 += 4) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (c0 + e < cn) a4[e] = fmaf(dps[r][c0 + e], wts[k][c0 + e], a4[e]);
        }
        dlr_p[(static_cast<size_t>(blockIdx.x) * M + m0 + r) * R + k0 + k] =
            (a4[0] + a4[1]) + (a4[2] + a4[3]);
      }
    }
    if (!live) continue;
#pragma unroll
    for (int k = 0; k < kDtMaxR; ++k)
      if (k < kn) dw_p[(static_cast<size_t>(blockIdx.y) * R + k0 + k) * d + ch] = gw[k];
  }
  if (live) db_p[static_cast<size_t>(blockIdx.y) * d + ch] = gb;
}

int dt_row_tiles(int M) { return (M + kDtTile - 1) / kDtTile; }
int dt_ch_tiles(int d) { return (d + kDtCh - 1) / kDtCh; }

// ddt: ddelta, overwritten with dpre past dt_rank 64.
template <typename LrT>
cudaError_t dt_bwd(float* ddt, const LrT* lr, int ld_lr, const float* wdt, const float* bdt,
                   float* dlr_p, float* dw_p, float* db_p, int M, int d, int R, cudaStream_t s) {
  if (R <= 0) return cudaErrorInvalidValue;
  const dim3 grid(dt_ch_tiles(d), dt_row_tiles(M));
  if (R <= kMaxR)
    dt_bwd_kernel<LrT, kMaxR><<<grid, kDtCh, 0, s>>>(ddt, lr, ld_lr, wdt, bdt, dlr_p, dw_p, db_p,
                                                     M, d, R);
  else if (R <= kDtMaxR)
    dt_bwd_kernel<LrT, kDtMaxR><<<grid, kDtCh, 0, s>>>(ddt, lr, ld_lr, wdt, bdt, dlr_p, dw_p,
                                                       db_p, M, d, R);
  else
    dt_bwd_tiled_kernel<LrT><<<grid, kDtCh, 0, s>>>(ddt, lr, ld_lr, wdt, bdt, dlr_p, dw_p, db_p,
                                                    M, d, R);
  return cudaGetLastError();
}

// K19's dx_dbl (row stride nxp) = [ddt_lr | dB | dC | 0] rounded to T:
// ddt_lr summed over the dt adjoint's channel tiles, dB and dC over the
// scan's, in order.
template <typename T>
__global__ void __launch_bounds__(256)
    dxdbl_kernel(const float* __restrict__ dlr_p, int n_ct, const float* __restrict__ dBp,
                 const float* __restrict__ dCp, int n_st, T* __restrict__ dxdbl, int nxp, int M,
                 int R, int N) {
  const size_t i = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= static_cast<size_t>(M) * nxp) return;
  const size_t m = i / nxp;
  const int col = static_cast<int>(i % nxp);
  float v = 0.f;
  if (col < R) {
    for (int t = 0; t < n_ct; ++t) v += dlr_p[(static_cast<size_t>(t) * M + m) * R + col];
  } else if (col < R + 2 * N) {
    const int n = (col - R) % N;
    const float* src = col < R + N ? dBp : dCp;
    for (int t = 0; t < n_st; ++t) v += src[(static_cast<size_t>(t) * M + m) * N + n];
  }
  dxdbl[i] = from_f32<T>(v);
}

// --- the conv + SiLU adjoint ---------------------------------------------------

constexpr int kConvRows = 128;

// One block per (kConvRows-row tile, b); threads own channels. Walking the
// tile's rows and the K - 1 after it, a thread recomputes xc as the front
// rounds it, takes dxc = du silu'(xc), and emits dx of the row K - 1 back:
// dx_t = ((dxc_{t+3} w0 + dxc_{t+2} w1) + dxc_{t+1} w2) + dxc_t w3 in fp32,
// rounded to T into dxz's x columns. dconv_w, dconv_b sum over the tile's
// own rows (partials (tiles, K, d), (tiles, d)).
template <typename T, int K>
__global__ void __launch_bounds__(kFrontThreads)
    conv_bwd_kernel(const T* __restrict__ xz, const T* __restrict__ cw, const T* __restrict__ cb,
                    const float* __restrict__ dut, T* __restrict__ dxz,
                    float* __restrict__ dcw_p, float* __restrict__ dcb_p, int L, int d) {
  const int b = blockIdx.y, t0 = blockIdx.x * kConvRows;
  const int rows = min(kConvRows, L - t0);
  const size_t tile = static_cast<size_t>(b) * gridDim.x + blockIdx.x;
  const size_t base = static_cast<size_t>(b) * L;
  const int ld = 2 * d;
  for (int ch = threadIdx.x; ch < d; ch += kFrontThreads) {
    float win[K], w[K], dwin[K], gw[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      w[j] = to_f32(cw[j * d + ch]);
      const int tt = t0 - K + j;
      win[j] = tt >= 0 && j >= 1 ? to_f32(xz[(base + tt) * ld + ch]) : 0.f;
      dwin[j] = 0.f;
      gw[j] = 0.f;
    }
    const float bias = to_f32(cb[ch]);
    float gb = 0.f;
    const int t_end = t0 + rows + K - 1;
    // Rows go in batches whose loads are all issued first, as in the front.
    for (int tb = t0; tb < t_end; tb += kRowBatch) {
      float xv[kRowBatch], dv[kRowBatch];
#pragma unroll
      for (int i = 0; i < kRowBatch; ++i) {
        const int t = tb + i;
        const bool in = t < t_end && t < L;
        xv[i] = in ? to_f32(xz[(base + t) * ld + ch]) : 0.f;
        dv[i] = in ? dut[(base + t) * d + ch] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRowBatch; ++i) {
        const int t = tb + i;
        if (t >= t_end) break;
        float dxc = 0.f;
        if (t < L) {
#pragma unroll
          for (int j = 0; j < K - 1; ++j) win[j] = win[j + 1];
          win[K - 1] = xv[i];
          float acc = round_to<T>(win[0] * w[0]);
#pragma unroll
          for (int j = 1; j < K; ++j) acc = round_to<T>(acc + round_to<T>(win[j] * w[j]));
          const float xc = round_to<T>(acc + bias);
          const float sc = sigmoid(xc);
          dxc = dv[i] * (sc * (1.f + xc * (1.f - sc)));
          if (t < t0 + rows) {
            gb += dxc;
#pragma unroll
            for (int j = 0; j < K; ++j) gw[j] = fmaf(win[j], dxc, gw[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < K - 1; ++j) dwin[j] = dwin[j + 1];
        dwin[K - 1] = dxc;
        const int tp = t - (K - 1);
        if (tp >= t0) {
          float dx = dwin[K - 1] * w[0];
#pragma unroll
          for (int j = 1; j < K; ++j) dx = fmaf(dwin[K - 1 - j], w[j], dx);
          dxz[(base + tp) * ld + ch] = from_f32<T>(dx);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < K; ++j) dcw_p[(tile * K + j) * d + ch] = gw[j];
    dcb_p[tile * d + ch] = gb;
  }
}

// --- workspaces ------------------------------------------------------------------

// Carves a byte workspace into 256-byte-aligned arrays; from address 0 it
// only measures.
struct Carve {
  uintptr_t base;
  size_t off = 0;
  template <typename X>
  X* take(size_t n) {
    off = (off + 255) & ~static_cast<size_t>(255);
    X* p = reinterpret_cast<X*>(base + off);
    off += n * sizeof(X);
    return p;
  }
};

#define DDG_TRY(x) \
  if ((err = (x)) != cudaSuccess) return err

struct ScanBwdWs {
  float *P, *E, *dBp, *dCp, *dAp, *dDp, *hx, *tmp;
};

int scan_tiles(int d) { return (d + kBwdCh - 1) / kBwdCh; }

// Sub-chunks of the adjoint's passes: chunks x sub-chunks a chunk.
size_t scan_subs(int L, int chunk) {
  return static_cast<size_t>((L + chunk - 1) / chunk) * n_subs(chunk);
}

// P holds at least p_min floats (K17 reuses it once pass 2 has read it).
ScanBwdWs carve_scan(Carve& cv, int Bt, int L, int d, int N, int chunk, size_t p_min = 0) {
  const size_t nc = scan_subs(L, chunk), cnd = Bt * nc * N * d;
  const size_t tiles_rows = static_cast<size_t>(scan_tiles(d)) * Bt * L * N;
  ScanBwdWs w;
  w.P = cv.take<float>(cnd > p_min ? cnd : p_min);
  w.E = cv.take<float>(cnd);
  w.dBp = cv.take<float>(tiles_rows);
  w.dCp = cv.take<float>(tiles_rows);
  w.dAp = cv.take<float>(cnd);
  w.dDp = cv.take<float>(Bt * nc * d);
  // Pass 3's sub-chunk exit states, past one sub-chunk a chunk.
  w.hx = cv.take<float>(n_subs(chunk) > 1 ? Bt * nc / n_subs(chunk) * N * d : 0);
  const size_t slices = Bt * nc, t1 = reduce_tmp(slices, static_cast<size_t>(N) * d);
  const size_t t2 = reduce_tmp(scan_tiles(d), static_cast<size_t>(Bt) * L * N);
  w.tmp = cv.take<float>(t1 > t2 ? t1 : t2);
  return w;
}

// Shared memory of the adjoint's passes 1 and 3 (R = 0: delta from
// memory); the wrappers' `ssm_scan_takes` and `ssm_scan_dtlr_takes` hold
// the same sums. Pass 1: a sub-chunk's C columns of one group and a staged
// 16-row segment's delta and gy, and in the low-rank form one rank tile of
// the sub-chunk's dt_lr rows and W_dt's columns.
size_t scan_bwd_smem1(int chunk, int R) {
  const int sc = sub_rows(chunk);
  return sizeof(float) * (static_cast<size_t>(sc) * kMaxN + 2 * kStage +
                          (R > 0 ? sc * rank_ld(R) + kBwdCh * (wt_ld(R) + 1) : 0));
}

// Pass 3: a sub-chunk's B and C columns of one group and its row values for
// the tile's channels, the segments' summaries (three float4 a lane), past
// 16 states each row's running C.h (and, low-rank, ddelta), and in the
// low-rank form one rank tile of W_dt's columns and of the sub-chunk's
// dt_lr rows (kSubRows).
size_t scan_bwd_smem3(int chunk, int N, int R) {
  const int sp = p3_rows(chunk), n_seg = sp / kP3Rows, lr_ld = rank_ld(R);
  const size_t rows = static_cast<size_t>(sp) * kBwdCh, grp = N > kMaxN ? rows : 0;
  return sizeof(float) * (2 * static_cast<size_t>(sp) * kMaxN + kRowVals * rows +
                          n_seg * 3 * 32 * 4 + grp +
                          (R > 0 ? grp + kBwdCh * (wt_ld(R) + 1) + kSubRows * lr_ld : 0));
}

template <typename T, typename G, typename ZT, bool Grp, bool LR, bool RT>
cudaError_t scan_bwd_k(const T* u, int ld_u, const DtSrc& dl, const T* Bc, const T* Cc,
                       int ld_bc, const T* z, int ld_z, const G* g, int ld_g, const float* A,
                       const float* D, const float* h0s, const ScanBwdWs& w, float* ddt,
                       float* du, ZT* dz, int ld_dz, T* yg, const DtGrad& dg, int Bt, int L,
                       int d, int N, int chunk, cudaStream_t s) {
  const int nc = (L + chunk - 1) / chunk, R = LR ? dl.R : 0;
  const size_t smem1 = scan_bwd_smem1(chunk, R), smem3 = scan_bwd_smem3(chunk, N, R);
  cudaError_t err;
  DDG_TRY(allow_smem(reinterpret_cast<const void*>(scan_bwd_chunk_kernel<T, G, Grp, LR, RT>),
                     smem1));
  DDG_TRY(allow_smem(
      reinterpret_cast<const void*>(scan_bwd_out_kernel<T, G, ZT, Grp, LR, RT>), smem3));
  const int n_sub = static_cast<int>(scan_subs(L, chunk));
  scan_bwd_chunk_kernel<T, G, Grp, LR, RT><<<dim3(scan_tiles(d), n_sub, Bt), kBwdThreads, smem1, s>>>(
      dl, Cc, ld_bc, z, ld_z, g, ld_g, A, w.P, w.E, L, d, N, chunk);
  DDG_TRY(cudaGetLastError());
  scan_bwd_carry_kernel<<<dim3((N * d + 255) / 256, Bt), 256, 0, s>>>(w.P, w.E, n_sub, N * d);
  DDG_TRY(cudaGetLastError());
  scan_bwd_out_kernel<T, G, ZT, Grp, LR, RT><<<dim3(scan_tiles(d), nc, Bt), kBwdThreads, smem3, s>>>(
      u, ld_u, dl, Bc, Cc, ld_bc, z, ld_z, g, ld_g, A, D, h0s, w.E, w.hx, ddt, du, dz, ld_dz, yg,
      w.dBp, w.dCp, w.dAp, w.dDp, dg, Bt, L, d, N, chunk);
  return cudaGetLastError();
}

// ddt (K15, K19) or, with dl.delta null, dg (K17) takes the delta adjoint.
template <typename T, typename G, typename ZT>
cudaError_t scan_bwd(const T* u, int ld_u, const DtSrc& dl, const T* Bc, const T* Cc, int ld_bc,
                     const T* z, int ld_z, const G* g, int ld_g, const float* A, const float* D,
                     const float* h0s, const ScanBwdWs& w, float* ddt, float* du, ZT* dz,
                     int ld_dz, T* yg, const DtGrad& dg, int Bt, int L, int d, int N, int chunk,
                     cudaStream_t s) {
  if (N <= 0 || chunk <= 0 || d <= 0 || L <= 0) return cudaErrorInvalidValue;
  if (dl.delta == nullptr && (dl.R <= 0 || L % chunk)) return cudaErrorInvalidValue;
#define DDG_SCAN_BWD(G2, L2, RT2)                                                           \
  scan_bwd_k<T, G, ZT, G2, L2, RT2>(u, ld_u, dl, Bc, Cc, ld_bc, z, ld_z, g, ld_g, A, D, h0s, w, \
                                    ddt, du, dz, ld_dz, yg, dg, Bt, L, d, N, chunk, s)
  if (dl.delta == nullptr && rank_tiles(dl.R) > 1)
    return N > kMaxN ? DDG_SCAN_BWD(true, true, true) : DDG_SCAN_BWD(false, true, true);
  if (dl.delta == nullptr)
    return N > kMaxN ? DDG_SCAN_BWD(true, true, false) : DDG_SCAN_BWD(false, true, false);
  return N > kMaxN ? DDG_SCAN_BWD(true, false, false) : DDG_SCAN_BWD(false, false, false);
#undef DDG_SCAN_BWD
}

// The (N, d) dA_log and (d,) dD from the per-(b, sub-chunk) partials.
cudaError_t scan_bwd_sums(const ScanBwdWs& w, const float* A, float* dA_log, float* dD, int Bt,
                          int L, int d, int N, int chunk, cudaStream_t s) {
  const int slices = Bt * static_cast<int>(scan_subs(L, chunk));
  cudaError_t err;
  DDG_TRY(reduce_slices(w.dAp, dA_log, slices, static_cast<size_t>(N) * d, w.tmp, s, A, N, d));
  return reduce_slices(w.dDp, dD, slices, d, w.tmp, s);
}

// dB and dC summed over the scan's channel tiles, then dA_log and dD.
cudaError_t scan_bwd_outputs(const ScanBwdWs& w, const float* A, float* dB, float* dC,
                             float* dA_log, float* dD, int Bt, int L, int d, int N, int chunk,
                             cudaStream_t s) {
  const size_t n = static_cast<size_t>(Bt) * L * N;
  cudaError_t err;
  DDG_TRY(reduce_slices(w.dBp, dB, scan_tiles(d), n, w.tmp, s));
  DDG_TRY(reduce_slices(w.dCp, dC, scan_tiles(d), n, w.tmp, s));
  return scan_bwd_sums(w, A, dA_log, dD, Bt, L, d, N, chunk, s);
}

template <typename T>
cudaError_t ssm_bwd(const T* u, int ld_u, const float* delta, const T* Bc, const T* Cc, int ld_bc,
                    const T* z, int ld_z, const float* A, const float* D, const float* h0s,
                    const T* g, float* du, float* ddelta, float* dz, float* dB, float* dC,
                    float* dA_log, float* dD, void* ws, int Bt, int L, int d, int N, int chunk,
                    cudaStream_t s) {
  Carve cv{reinterpret_cast<uintptr_t>(ws)};
  const ScanBwdWs w = carve_scan(cv, Bt, L, d, N, chunk);
  const DtSrc dl{delta, nullptr, 0, nullptr, nullptr, 0};
  cudaError_t err;
  DDG_TRY((scan_bwd<T, T, float>(u, ld_u, dl, Bc, Cc, ld_bc, z, ld_z, g, d, A, D, h0s, w, ddelta,
                                 du, dz, d, nullptr, DtGrad{}, Bt, L, d, N, chunk, s)));
  return scan_bwd_outputs(w, A, dB, dC, dA_log, dD, Bt, L, d, N, chunk, s);
}

// K17's workspace: the scan adjoint's and the partials of dt_proj's
// adjoint, no (M, d) array (ddelta never leaves pass 3). ddt_lr's partials
// (channel tiles, M, R) go over the adjoint's P, which pass 2 was the last
// to read.
struct DtlrBwdWs {
  ScanBwdWs scan;
  DtGrad dg;
  float* tmp;
};

DtlrBwdWs carve_dtlr(Carve& cv, int Bt, int L, int d, int N, int R, int chunk) {
  const size_t M = static_cast<size_t>(Bt) * L, tiles = scan_tiles(d);
  const size_t slices = static_cast<size_t>(Bt) * ((L + chunk - 1) / chunk);
  DtlrBwdWs w;
  w.scan = carve_scan(cv, Bt, L, d, N, chunk, tiles * M * R);
  w.dg.dlr = w.scan.P;
  w.dg.dw = cv.take<float>(slices * R * d);
  w.dg.db = cv.take<float>(slices * d);
  size_t t = reduce_tmp(tiles, M * R);
  const size_t t2 = reduce_tmp(slices, static_cast<size_t>(R) * d);
  w.tmp = cv.take<float>(t > t2 ? t : t2);
  return w;
}

template <typename T>
cudaError_t dtlr_bwd(const T* u, int ld_u, const float* lr, int ld_lr, const float* wdt,
                     const float* bdt, const T* Bc, const T* Cc, int ld_bc, const T* z, int ld_z,
                     const float* A, const float* D, const float* h0s, const T* g, float* du,
                     float* dlr, float* dW_dt, float* db_dt, float* dz, float* dB, float* dC,
                     float* dA_log, float* dD, void* ws, int Bt, int L, int d, int N, int R,
                     int chunk, cudaStream_t s) {
  if (R <= 0 || chunk <= 0 || L % chunk) return cudaErrorInvalidValue;
  Carve cv{reinterpret_cast<uintptr_t>(ws)};
  const DtlrBwdWs w = carve_dtlr(cv, Bt, L, d, N, R, chunk);
  const int M = Bt * L, slices = Bt * (L / chunk);
  const DtSrc dl{nullptr, lr, ld_lr, wdt, bdt, R};
  cudaError_t err;
  DDG_TRY((scan_bwd<T, T, float>(u, ld_u, dl, Bc, Cc, ld_bc, z, ld_z, g, d, A, D, h0s, w.scan,
                                 nullptr, du, dz, d, nullptr, w.dg, Bt, L, d, N, chunk, s)));
  DDG_TRY(reduce_slices(w.dg.dlr, dlr, scan_tiles(d), static_cast<size_t>(M) * R, w.tmp, s));
  DDG_TRY(reduce_slices(w.dg.dw, dW_dt, slices, static_cast<size_t>(R) * d, w.tmp, s));
  DDG_TRY(reduce_slices(w.dg.db, db_dt, slices, d, w.tmp, s));
  return scan_bwd_outputs(w.scan, A, dB, dC, dA_log, dD, Bt, L, d, N, chunk, s);
}

template <typename T>
struct InnerBwdWs {
  T *xz, *u, *xdbl, *yg, *dxz, *dxdbl;
  float *delta, *dy, *ddt, *du, *dlr_p, *dtw_p, *dtb_p, *cw_p, *cb_p, *wpart, *wtmp;
  ScanBwdWs scan;
};

int round8(int n) { return (n + 7) / 8 * 8; }

template <typename T>
InnerBwdWs<T> carve_inner(Carve& cv, int Bt, int L, int H, int d, int K, int R, int N,
                          int chunk) {
  const size_t M = static_cast<size_t>(Bt) * L;
  const int nx = R + 2 * N, nxp = round8(nx);
  InnerBwdWs<T> w;
  w.xz = cv.take<T>(M * 2 * d);
  w.u = cv.take<T>(M * d);
  w.xdbl = cv.take<T>(M * nx);
  w.yg = cv.take<T>(M * d);
  w.dxz = cv.take<T>(M * 2 * d);
  w.dxdbl = cv.take<T>(M * nxp);
  w.delta = cv.take<float>(M * d);
  w.dy = cv.take<float>(M * d);
  w.ddt = cv.take<float>(M * d);
  w.du = cv.take<float>(M * d);
  const size_t dt_tiles = dt_row_tiles(static_cast<int>(M));
  const size_t cv_tiles = static_cast<size_t>(Bt) * ((L + kConvRows - 1) / kConvRows);
  w.dlr_p = cv.take<float>(static_cast<size_t>(dt_ch_tiles(d)) * M * R);
  w.dtw_p = cv.take<float>(dt_tiles * R * d);
  w.dtb_p = cv.take<float>(dt_tiles * d);
  w.cw_p = cv.take<float>(cv_tiles * K * d);
  w.cb_p = cv.take<float>(cv_tiles * d);
  const size_t ns = wgrad_slices(static_cast<int>(M));
  size_t pq = static_cast<size_t>(H) * 2 * d;
  if (static_cast<size_t>(d) * H > pq) pq = static_cast<size_t>(d) * H;
  if (static_cast<size_t>(d) * nx > pq) pq = static_cast<size_t>(d) * nx;
  w.wpart = cv.take<float>(ns * pq);
  size_t t = reduce_tmp(ns, pq);
  const size_t sizes[][2] = {{dt_tiles, static_cast<size_t>(R) * d}, {dt_tiles, (size_t)d},
                             {cv_tiles, static_cast<size_t>(K) * d}, {cv_tiles, (size_t)d}};
  for (const auto& sz : sizes) {
    const size_t v = reduce_tmp(sz[0], sz[1]);
    if (v > t) t = v;
  }
  w.wtmp = cv.take<float>(t);
  w.scan = carve_scan(cv, Bt, L, d, N, chunk);
  return w;
}

template <typename T>
cudaError_t inner_bwd(const T* h, const T* w_in, const T* w_in_f, const T* cw, const T* cb,
                      const T* w_x, const T* w_x_f, const float* w_dt, const float* b_dt,
                      const float* A, const float* D, const T* w_out_f, const float* h0s,
                      const T* g, T* dh, float* dW_in, float* dcw, float* dcb, float* dW_x,
                      float* dW_dt, float* db_dt, float* dA_log, float* dD, float* dW_out,
                      void* ws, int Bt, int L, int H, int d, int K, int R, int N, int chunk,
                      cudaStream_t s) {
  if ((K != 4 && K != 8) || R <= 0 || chunk <= 0 || L % chunk) return cudaErrorInvalidValue;
  Carve cv{reinterpret_cast<uintptr_t>(ws)};
  const InnerBwdWs<T> w = carve_inner<T>(cv, Bt, L, H, d, K, R, N, chunk);
  const int M = Bt * L, nx = R + 2 * N, nxp = round8(nx);
  cudaError_t err;
  // The front, as the forward computes it.
  DDG_TRY(gemm(h, w_in, w.xz, M, 2 * d, H, H, 2 * d, s));
  DDG_TRY(front<T>(w.xz, cw, cb, w_x, w_dt, b_dt, w.u, w.xdbl, w.delta, Bt, L, d, K, R, N, s));
  // out_proj's adjoint, then the scan's.
  DDG_TRY(gemm(g, w_out_f, w.dy, M, d, H, H, d, s));
  const DtSrc dl{w.delta, nullptr, 0, nullptr, nullptr, 0};
  DDG_TRY((scan_bwd<T, float, T>(w.u, d, dl, w.xdbl + R, w.xdbl + R + N, nx, w.xz + d, 2 * d,
                                 w.dy, d, A, D, h0s, w.scan, w.ddt, w.du, w.dxz + d, 2 * d, w.yg,
                                 DtGrad{}, Bt, L, d, N, chunk, s)));
  // dt_proj's adjoint (on the stored dt_lr columns), then x_proj's.
  DDG_TRY(dt_bwd<T>(w.ddt, w.xdbl, nx, w_dt, b_dt, w.dlr_p, w.dtw_p, w.dtb_p, M, d, R, s));
  const size_t n_dx = static_cast<size_t>(M) * nxp;
  dxdbl_kernel<T><<<static_cast<unsigned>((n_dx + 255) / 256), 256, 0, s>>>(
      w.dlr_p, dt_ch_tiles(d), w.scan.dBp, w.scan.dCp, scan_tiles(d), w.dxdbl, nxp, M, R, N);
  DDG_TRY(cudaGetLastError());
  DDG_TRY(gemm(w.dxdbl, w_x_f, w.du, M, d, nxp, nxp, d, s, true));
  // The conv + SiLU adjoint, then in_proj's.
  const int cv_x = (L + kConvRows - 1) / kConvRows;
  if (K == 4)
    conv_bwd_kernel<T, 4><<<dim3(cv_x, Bt), kFrontThreads, 0, s>>>(w.xz, cw, cb, w.du, w.dxz,
                                                                  w.cw_p, w.cb_p, L, d);
  else
    conv_bwd_kernel<T, 8><<<dim3(cv_x, Bt), kFrontThreads, 0, s>>>(w.xz, cw, cb, w.du, w.dxz,
                                                                  w.cw_p, w.cb_p, L, d);
  DDG_TRY(cudaGetLastError());
  DDG_TRY(gemm(w.dxz, w_in_f, dh, M, H, 2 * d, 2 * d, H, s));
  // Weight gradients, each a fixed-order two-stage sum.
  const int dt_tiles = dt_row_tiles(M);
  DDG_TRY(wgrad(h, H, w.dxz, 2 * d, w.wpart, dW_in, w.wtmp, M, H, 2 * d, s));
  DDG_TRY(wgrad(w.u, d, w.dxdbl, nxp, w.wpart, dW_x, w.wtmp, M, d, nx, s));
  DDG_TRY(wgrad(w.yg, d, g, H, w.wpart, dW_out, w.wtmp, M, d, H, s));
  DDG_TRY(reduce_slices(w.dtw_p, dW_dt, dt_tiles, static_cast<size_t>(R) * d, w.wtmp, s));
  DDG_TRY(reduce_slices(w.dtb_p, db_dt, dt_tiles, d, w.wtmp, s));
  DDG_TRY(reduce_slices(w.cw_p, dcw, Bt * cv_x, static_cast<size_t>(K) * d, w.wtmp, s));
  DDG_TRY(reduce_slices(w.cb_p, dcb, Bt * cv_x, d, w.wtmp, s));
  return scan_bwd_sums(w.scan, A, dA_log, dD, Bt, L, d, N, chunk, s);
}

#undef DDG_TRY

const float* f(const void* p) { return static_cast<const float*>(p); }
float* fo(void* p) { return static_cast<float*>(p); }
const bf16* b(const void* p) { return static_cast<const bf16*>(p); }
bf16* bo(void* p) { return static_cast<bf16*>(p); }

}  // namespace

// The adjoint's share of `ops.mamba.scan_smem`, for the same check.
extern "C" long long ddg_scan_bwd_smem(int chunk, int N, int R) {
  const size_t s1 = scan_bwd_smem1(chunk, R), s3 = scan_bwd_smem3(chunk, N, R);
  return static_cast<long long>(s1 > s3 ? s1 : s3);
}

extern "C" long long ddg_ssm_scan_bwd_workspace(int Bt, int L, int d, int N, int chunk) {
  Carve cv{0};
  carve_scan(cv, Bt, L, d, N, chunk);
  return static_cast<long long>(cv.off);
}

extern "C" int ddg_ssm_scan_bwd(const void* u, int ld_u, const void* delta, const void* Bc,
                                const void* Cc, int ld_bc, const void* z, int ld_z,
                                const void* A, const void* D, const void* h0s, const void* g,
                                void* du, void* ddelta, void* dz, void* dB, void* dC,
                                void* dA_log, void* dD, void* ws, int Bt, int L, int d, int N,
                                int chunk, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ddg::kF32)
    return ssm_bwd<float>(f(u), ld_u, f(delta), f(Bc), f(Cc), ld_bc, f(z), ld_z, f(A), f(D),
                          f(h0s), f(g), fo(du), fo(ddelta), fo(dz), fo(dB), fo(dC), fo(dA_log),
                          fo(dD), ws, Bt, L, d, N, chunk, s);
  if (dtype == ddg::kBF16)
    return ssm_bwd<bf16>(b(u), ld_u, f(delta), b(Bc), b(Cc), ld_bc, b(z), ld_z, f(A), f(D),
                         f(h0s), b(g), fo(du), fo(ddelta), fo(dz), fo(dB), fo(dC), fo(dA_log),
                         fo(dD), ws, Bt, L, d, N, chunk, s);
  return cudaErrorInvalidValue;
}

extern "C" long long ddg_ssm_scan_dtlr_bwd_workspace(int Bt, int L, int d, int N, int R,
                                                     int chunk) {
  Carve cv{0};
  carve_dtlr(cv, Bt, L, d, N, R, chunk);
  return static_cast<long long>(cv.off);
}

// K17: the gradients of u, dt_lr (fp32, rows of stride ld_lr), W_dt (R, d),
// b_dt, B, C, log(-A).T, z and D.
extern "C" int ddg_ssm_scan_dtlr_bwd(const void* u, int ld_u, const void* dt_lr, int ld_lr,
                                     const void* w_dt, const void* b_dt, const void* Bc,
                                     const void* Cc, int ld_bc, const void* z, int ld_z,
                                     const void* A, const void* D, const void* h0s,
                                     const void* g, void* du, void* ddt_lr, void* dW_dt,
                                     void* db_dt, void* dz, void* dB, void* dC, void* dA_log,
                                     void* dD, void* ws, int Bt, int L, int d, int N, int R,
                                     int chunk, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ddg::kF32)
    return dtlr_bwd<float>(f(u), ld_u, f(dt_lr), ld_lr, f(w_dt), f(b_dt), f(Bc), f(Cc), ld_bc,
                           f(z), ld_z, f(A), f(D), f(h0s), f(g), fo(du), fo(ddt_lr), fo(dW_dt),
                           fo(db_dt), fo(dz), fo(dB), fo(dC), fo(dA_log), fo(dD), ws, Bt, L, d,
                           N, R, chunk, s);
  if (dtype == ddg::kBF16)
    return dtlr_bwd<bf16>(b(u), ld_u, f(dt_lr), ld_lr, f(w_dt), f(b_dt), b(Bc), b(Cc), ld_bc,
                          b(z), ld_z, f(A), f(D), f(h0s), b(g), fo(du), fo(ddt_lr), fo(dW_dt),
                          fo(db_dt), fo(dz), fo(dB), fo(dC), fo(dA_log), fo(dD), ws, Bt, L, d,
                          N, R, chunk, s);
  return cudaErrorInvalidValue;
}

extern "C" long long ddg_mamba_inner_bwd_workspace(int Bt, int L, int H, int d, int K, int R,
                                                   int N, int chunk, int dtype) {
  Carve cv{0};
  if (dtype == ddg::kF32)
    carve_inner<float>(cv, Bt, L, H, d, K, R, N, chunk);
  else
    carve_inner<bf16>(cv, Bt, L, H, d, K, R, N, chunk);
  return static_cast<long long>(cv.off);
}

extern "C" int ddg_mamba_inner_bwd(const void* h, const void* w_in, const void* w_in_f,
                                   const void* cw, const void* cb, const void* w_x,
                                   const void* w_x_f, const void* w_dt, const void* b_dt,
                                   const void* A, const void* D, const void* w_out_f,
                                   const void* h0s, const void* g, void* dh, void* dW_in,
                                   void* dcw, void* dcb, void* dW_x, void* dW_dt, void* db_dt,
                                   void* dA_log, void* dD, void* dW_out, void* ws, int Bt, int L,
                                   int H, int d, int K, int R, int N, int chunk, int dtype,
                                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ddg::kF32)
    return inner_bwd<float>(f(h), f(w_in), f(w_in_f), f(cw), f(cb), f(w_x), f(w_x_f), f(w_dt),
                            f(b_dt), f(A), f(D), f(w_out_f), f(h0s), f(g), fo(dh), fo(dW_in),
                            fo(dcw), fo(dcb), fo(dW_x), fo(dW_dt), fo(db_dt), fo(dA_log), fo(dD),
                            fo(dW_out), ws, Bt, L, H, d, K, R, N, chunk, s);
  if (dtype == ddg::kBF16)
    return inner_bwd<bf16>(b(h), b(w_in), b(w_in_f), b(cw), b(cb), b(w_x), b(w_x_f), f(w_dt),
                           f(b_dt), f(A), f(D), b(w_out_f), f(h0s), b(g), bo(dh), fo(dW_in),
                           fo(dcw), fo(dcb), fo(dW_x), fo(dW_dt), fo(db_dt), fo(dA_log), fo(dD),
                           fo(dW_out), ws, Bt, L, H, d, K, R, N, chunk, s);
  return cudaErrorInvalidValue;
}
