// The DiMamba forward kernels: the gated selective scan and the fused
// Mamba block (one direction).
//
// Replaces the TPU kernels
//   ddg_tpu/ops/selective_scan_pallas.py: ssm_scan -> _fwd_call (pallas_call :618), K14
//   ddg_tpu/ops/selective_scan_pallas.py: ssm_scan_dtlr -> _fwd_call_lr (:945), K16
//   ddg_tpu/ops/mamba_block_pallas.py: mamba_inner_pallas -> _mk_fwd_call (:511), K18
// with the rounding points of their bodies (`_fwd_kernel`, `_fwd_kernel_lr`,
// `_recompute_front`, `_mk_fwd_kernel`); ddg_tpu_torch/ops/mamba.py holds the
// plain versions.
//
// ddg_ssm_scan (K14), in fp32, for u, z, B, C of one type T (f32 or bf16):
//   h_t = exp(delta_t A) h_{t-1} + (delta_t u_t) B_t,   y_t = (C_t . h_t + D u_t) silu(z_t)
// with A = -exp(log(-A)) (the TPU call hands its kernel log(-A)), y in T,
// and h0s, the state entering each chunk of `chunk` rows. Two designs, by
// the batch (`use_passes`); K16 and K18 run the same scan.
//
// Both designs take one association, the three passes' (below), so a
// row's y and h0s are the same bits at every batch and on every card, as
// the TPU kernel's row does not depend on its batch: each chunk from its
// entry state h0s[c] (h0s[0] = 0), h = fmaf(a_t, h, (delta_t u_t) B_t)
// with a_t = exp(delta_t A) (ex2.approx of delta times A log2 e); the next
// entry state h0s[c + 1] = fmaf(P, h0s[c], E), E the chunk's end state
// from a zero state and P = exp(S A) with S the chunk's sum of delta_t,
// row by row in order; a row's C . h over a group of 16 states as pairs
// (2 j, 2 j + 1), fmaf(C[2j+1], h[2j+1], C[2j] h[2j]), summed by the tree
// ((Y0 + Y4) + (Y2 + Y6)) + ((Y1 + Y5) + (Y3 + Y7)), the groups past 16
// states added in order; y = fmaf(D, u, C.h) silu(z).
//
// The walk, `scan_fwd_kernel`, where the batch fills the card (at least
// kWalkBlocksPerSm blocks an SM: 16 rows of d = 512 on an H100): one
// launch that walks each row of L in order, as the TPU kernel carries h
// across the chunks in VMEM. A block owns (b, 16 channels), 8 lanes a
// channel, and a lane 2 of a group of 16 states, so each of the Bt d N
// recurrences is one lane's register, stepped row by row with a_t taken
// once (one SFU operation) and never stored; beside h the lane steps E on
// the same a_t and product (one more fmaf a state and row) and S (one add
// a row), and at a chunk's last row it forms the carry as pass 2 does and
// takes it as h. Per batch of 16 rows a lane takes the exps, then steps
// its states and forms their share of each row's C_t . h_t, with no branch
// in that chain where no chunk ends before the batch's last row; the
// channel's 8 lanes sum the shares by a reduce-scatter of shuffles (lanes
// j, j ^ 4; then j ^ 2; then j ^ 1), after which lane j holds rows j and
// 8 + j of the batch, gates them and writes them. Tiles of 64 rows of u, z
// and delta (the block's channels) and of B and C (16 states) land in
// shared memory by cp.async while the tile before runs, and are restaged
// once a tile as the lanes read them: a (delta, delta u) pair a row and
// channel, a lane's B and C pairs as one float4, one shared load each a
// row. d_state > 16 walks L once a group of 16 states, in order, each
// row's C . h of the groups so far kept in a (Bt L, d) fp32 workspace and
// gated after the last group. Shared memory grows with neither chunk nor
// d_state.
//
// The three passes at a smaller batch, where the walk has one warp an SMSP
// or fewer and waits on each batch's latencies: every chunk from a zero
// state (E and S, then P), the chunks' entry states chained into h0s,
// every chunk again from h0s, read out through C and gated; each exp
// taken twice, (b, chunk, channel) threads filling the card. `use_passes`
// picks the design by speed alone: the bits are the same.
//
// ddg_ssm_scan_dtlr (K16) is K14 on delta = softplus(dt_lr W_dt + b_dt):
// `delta_kernel` (mamba.cuh) forms delta once per (row, channel) into a
// (B L, d) fp32 workspace (`dt_pre`'s order), then the scan reads it, so
// K16's y and h0s equal K14's on the composite delta bit for bit. L must be
// a multiple of the chunk (a padded tail would carry softplus(b_dt) > 0
// into the state).
//
// ddg_mamba_inner (K18), for compute type T, as four launches (six where
// the scan runs its three passes):
//   xz    = h W_in^T                   in_proj, rounded to T       (gemm)
//   u     = silu(((x_{t-3} w0 + x_{t-2} w1) + ...) + b)   taps summed from the
//           oldest, every op rounded to T; SiLU in fp32, then T     (front)
//   x_dbl = u W_x^T rounded to T       (dt_lr | B | C)             (front)
//   delta = softplus(dt_lr W_dt^T + b_dt)   fp32 FMAs, `dt_pre`'s order,
//           from x_dbl's dt_lr columns as stored                    (front)
//   y     = the scan above, written in T                           (scan)
//   out   = y W_out^T rounded to T     out_proj                    (gemm)
// bf16 products run on the tensor cores (wgmma for in_proj and out_proj,
// mma.sync for x_proj), fp32 ones on the CUDA cores in full fp32. K19
// reruns the same front, the same bits.
//
// Bounds on the H100 at the Species10 shape (2B = 16 rows of L = 32768,
// H = 256, d = 512, N = 16, dt_rank 16), per K18 call: 5.4 G exps and logs
// (exp(delta A) over d x N, softplus, two sigmoids), 1.28 ms at 4.18 T/s on
// the SFU, against 0.44 ms of bf16 tensor-core products and 0.16 ms for
// reading h and writing out. The workspace it passes through device memory
// (xz, u, x_dbl, delta, y and h0s: about 7.2 GB with the products' reads)
// costs about 2.1 ms at 3.35 TB/s.

#include "mamba.cuh"

namespace {

constexpr int kScanThreads = 128;                 // a block: four warps
constexpr int kLanes = 8;                         // lanes of a channel
constexpr int kPerLane = kMaxN / kLanes;          // states of a group a lane holds
constexpr int kScanCh = kScanThreads / kLanes;    // channels of a block
constexpr int kScanRows = 64;                     // rows of a staged tile
constexpr int kBatch = 2 * kLanes;                // rows a lane steps between two reductions
static_assert(kPerLane == 2 && kLanes == 8, "the lane sums below are written for 2 and 8");

// Bytes of one raw tile (the cp.async copies of a tile's operands: u, z
// and delta of the block's channels, B and C of a group of 16 states, each
// [row][column]) and of the block's shared memory: two raw tiles and the
// staged tile the lanes read (`stage_tile`: a float2 per row and channel,
// a float4 per row and lane).
__host__ __device__ constexpr int raw_bytes(int tsize) {
  return kScanRows * (2 * kScanCh * tsize + kScanCh * 4 + 2 * kMaxN * tsize);
}
__host__ __device__ constexpr size_t scan_fwd_smem(int tsize) {
  return 2 * static_cast<size_t>(raw_bytes(tsize)) + kScanRows * (kScanCh * 8 + kLanes * 16);
}

template <typename T>
struct ScanArgs {
  const T* u;
  int ld_u;
  const float* delta;        // (rows, d) fp32
  const T* Bc;
  const T* Cc;
  int ld_bc;
  const T* z;
  int ld_z;
  const float* A;
  const float* D;
  T* y;
  float* h0s;
  float* ysum;               // (Bt L, d): the walk past 16 states
  float* P;                  // (Bt, n_chunks, N, d) each: the passes
  float* E;
  int L, d, N, chunk;
};

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// Rows [0, TR) x columns c0 .. c0 + W - 1 of src (row stride ld) into dst
// [row][W], zeros past `rows` and past nv columns: 16-byte cp.async where
// every piece is whole and aligned, 4-byte where words are, else loads and
// stores (a view of odd row stride, a ragged count of columns).
template <typename S, int W, int TR>
__device__ __forceinline__ void fetch_rows(const S* __restrict__ src, int ld, size_t row0,
                                           int rows, int c0, int nv, S* dst) {
  constexpr int E16 = 16 / sizeof(S), E4 = 4 / sizeof(S);
  const uintptr_t base = reinterpret_cast<uintptr_t>(src + c0);
  const size_t lb = static_cast<size_t>(ld) * sizeof(S);
  if (nv >= W && base % 16 == 0 && lb % 16 == 0) {
    constexpr int Q = W / E16;
#pragma unroll
    for (int j = 0; j < (TR * Q + kScanThreads - 1) / kScanThreads; ++j) {
      const int i = threadIdx.x + j * kScanThreads, t = i / Q, q = i % Q;
      if (TR * Q % kScanThreads && i >= TR * Q) break;
      const bool in = t < rows;
      cp_async16(smem_addr(dst + t * W + q * E16),
                 in ? src + (row0 + t) * ld + c0 + q * E16 : src, in);
    }
  } else if (base % 4 == 0 && lb % 4 == 0 && (nv % E4 == 0 || nv >= W)) {
    constexpr int Q = W / E4;
#pragma unroll
    for (int j = 0; j < (TR * Q + kScanThreads - 1) / kScanThreads; ++j) {
      const int i = threadIdx.x + j * kScanThreads, t = i / Q, q = i % Q;
      if (TR * Q % kScanThreads && i >= TR * Q) break;
      const bool in = t < rows && q * E4 < nv;
      cp_async4(smem_addr(dst + t * W + q * E4), in ? src + (row0 + t) * ld + c0 + q * E4 : src,
                in);
    }
  } else {
    for (int i = threadIdx.x; i < TR * W; i += kScanThreads) {
      const int t = i / W, c = i % W;
      dst[i] = t < rows && c < nv ? src[(row0 + t) * ld + c0 + c] : from_f32<S>(0.f);
    }
  }
}

// A raw tile's operands as the lanes read them, one shared load a row
// each: DX[row][channel] = (delta, delta u) and BC[row][lane j] = (B[2j],
// B[2j+1], C[2j], C[2j+1]), fp32.
template <typename T>
__device__ __forceinline__ void stage_tile(const T* u, const float* dl, const T* Bs,
                                           const T* Cs, float2* DX, float4* BC) {
  for (int i = threadIdx.x; i < kScanRows * kScanCh; i += kScanThreads) {
    const float dt = dl[i];
    DX[i] = make_float2(dt, dt * to_f32(u[i]));
  }
  for (int i = threadIdx.x; i < kScanRows * kLanes; i += kScanThreads) {
    const int o = i / kLanes * kMaxN + kPerLane * (i % kLanes);
    BC[i] = make_float4(to_f32(Bs[o]), to_f32(Bs[o + 1]), to_f32(Cs[o]), to_f32(Cs[o + 1]));
  }
}

// Rows 0 .. 7 of yp summed over the channel's 8 lanes, lane j keeping row
// j: lanes j and j ^ 4 (lanes with bit 2 keep rows 4 .. 7), then j ^ 2,
// then j ^ 1.
__device__ __forceinline__ float lane_sum(const float (&yp)[kLanes], int j) {
  const bool h4 = j & 4, h2 = j & 2, h1 = j & 1;
  float y4[4], y2[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    y4[i] = (h4 ? yp[i + 4] : yp[i]) + __shfl_xor_sync(0xffffffffu, h4 ? yp[i] : yp[i + 4], 4);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    y2[i] = (h2 ? y4[i + 2] : y4[i]) + __shfl_xor_sync(0xffffffffu, h2 ? y4[i] : y4[i + 2], 2);
  return (h1 ? y2[1] : y2[0]) + __shfl_xor_sync(0xffffffffu, h1 ? y2[0] : y2[1], 1);
}

// A row's C . h over a group of 16 states, in the one order both designs
// take: each pair of states (2 j, 2 j + 1) as fmaf(C[2j+1], h[2j+1],
// C[2j] h[2j]), then the 8 pairs' shares by the tree the walk's lanes sum
// them in (`lane_sum`: pairs j and j ^ 4, then j ^ 2, then j ^ 1).
__device__ __forceinline__ float pair_share(float c0, float c1, float h0, float h1) {
  return fmaf(c1, h1, c0 * h0);
}
__device__ __forceinline__ float group_sum(const float (&c)[kMaxN], const float (&h)[kMaxN]) {
  float s[kLanes];
#pragma unroll
  for (int k = 0; k < kLanes; ++k)
    s[k] = pair_share(c[2 * k], c[2 * k + 1], h[2 * k], h[2 * k + 1]);
  const float t0 = s[0] + s[4], t1 = s[1] + s[5], t2 = s[2] + s[6], t3 = s[3] + s[7];
  return (t0 + t2) + (t1 + t3);
}

// The gate of a row's scan sum: (C.h + D u) silu(z), fp32.
__device__ __forceinline__ float gate(float ys, float dv, float uu, float zz) {
  return fmaf(dv, uu, ys) * (zz * sigmoid(zz));
}

// One block per (kScanCh channels, b); thread (c, j) = (threadIdx.x / 8,
// threadIdx.x % 8) owns channel ch0 + c and states 2 j, 2 j + 1 of each
// group, and walks all of L in the three passes' association: per row h_s
// = a_t h_s + (delta_t u_t) B_t[s] with a_t = exp(delta_t A_s), started
// from the chunk's entry state h0 at each chunk's first row; beside it the
// chunk's state from zero, E_s (the same a_t and product, one more fmaf),
// and the sum S of the chunk's delta_t. At a chunk's last row the next
// entry state is h0 = fmaf(P_s, h0, E_s) with P_s = exp(S A_s), as
// `scan_carry_kernel` chains it from pass 1's P and E; it goes to h0s and
// becomes h. Each row's share C_t[2j] h + C_t[2j+1] h is summed over the
// channel's 8 lanes (`lane_sum`), as pass 3 sums a row's 16 states
// (`group_sum`); groups past 16 states are added in order. So a row's y
// and h0s are the bits the passes give, whatever the batch. A batch of 16
// rows takes its exps first, then the chain, with no branch between where
// no chunk ends before its last row; a batch inside which a chunk ends
// (a chunk that is not a multiple of 16) steps its rows one at a time and
// carries at each chunk's end. The channel's lanes then sum the shares of
// rows 0-7 and 8-15 (lane j keeps rows j and 8 + j), which lane j gates
// and writes (Grp, past 16 states: before the last group, adds into
// ysum). The tile after this one lands by cp.async meanwhile.
template <typename T, bool Grp>
__global__ void __launch_bounds__(kScanThreads, 4)
    scan_fwd_kernel(const ScanArgs<T> p) {
  constexpr int TR = kScanRows, CH = kScanCh, RAW = raw_bytes(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];
  auto ru = [&](int k) { return reinterpret_cast<T*>(smem + k * RAW); };
  auto rz = [&](int k) { return ru(k) + TR * CH; };
  auto rd = [&](int k) { return reinterpret_cast<float*>(rz(k) + TR * CH); };
  auto rb = [&](int k) { return reinterpret_cast<T*>(rd(k) + TR * CH); };
  auto rc = [&](int k) { return rb(k) + TR * kMaxN; };
  float2* DX = reinterpret_cast<float2*>(smem + 2 * RAW);  // TR x CH
  float4* BC = reinterpret_cast<float4*>(DX + TR * CH);     // TR x kLanes
  const int L = p.L, d = p.d, N = p.N, chunk = p.chunk;
  const int j = threadIdx.x % kLanes, c = threadIdx.x / kLanes;
  const int b = blockIdx.y, ch0 = blockIdx.x * CH, ch = ch0 + c;
  const int nch = min(CH, d - ch0);
  const bool live = ch < d;
  const int cl = live ? ch : 0;   // channels past d step zeros and write nothing
  const int nc = (L + chunk - 1) / chunk;
  const int n_groups = Grp ? (N + kMaxN - 1) / kMaxN : 1;
  const float Dv = p.D[cl];
  const size_t hb = static_cast<size_t>(b) * nc * N;   // h0s[b][0][0]
  for (int g = 0; g < n_groups; ++g) {
    const int n0 = g * kMaxN, nn = min(kMaxN, N - n0);
    const bool first = !Grp || g == 0, last = !Grp || g == n_groups - 1;
    float a2[kPerLane], h[kPerLane], h0[kPerLane], E[kPerLane], S = 0.f;
#pragma unroll
    for (int s = 0; s < kPerLane; ++s) {
      const int n = n0 + kPerLane * j + s;
      a2[s] = n < N ? -expf(logf(-p.A[static_cast<size_t>(cl) * N + n])) * kLog2e : 0.f;
      h[s] = h0[s] = E[s] = 0.f;
      if (live && n < N) p.h0s[(hb + n) * d + ch] = 0.f;
    }
    // The carry at the end of chunk cn - 1 (its last row): the entry state
    // of chunk cn into h0s and h; E and S start again.
    int next = chunk - 1, cn = 1;
    auto carry = [&]() {
#pragma unroll
      for (int s = 0; s < kPerLane; ++s) {
        h0[s] = fmaf(ex2(S * a2[s]), h0[s], E[s]);
        h[s] = h0[s];
        E[s] = 0.f;
        const int n = n0 + kPerLane * j + s;
        if (live && n < N) p.h0s[(hb + static_cast<size_t>(cn) * N + n) * d + ch] = h0[s];
      }
      S = 0.f;
      next += chunk;
      ++cn;
    };
    auto fetch_tile = [&](int t0, int k) {
      const int rows = min(TR, L - t0);
      const size_t row0 = static_cast<size_t>(b) * L + t0;
      fetch_rows<T, CH, TR>(p.u, p.ld_u, row0, rows, ch0, nch, ru(k));
      fetch_rows<T, CH, TR>(p.z, p.ld_z, row0, rows, ch0, nch, rz(k));
      fetch_rows<float, CH, TR>(p.delta, d, row0, rows, ch0, nch, rd(k));
      fetch_rows<T, kMaxN, TR>(p.Bc, p.ld_bc, row0, rows, n0, nn, rb(k));
      fetch_rows<T, kMaxN, TR>(p.Cc, p.ld_bc, row0, rows, n0, nn, rc(k));
      cp_async_commit();
    };
    if (Grp && g > 0) __syncthreads();  // the last group's readers of raw tile 0 are done
    fetch_tile(0, 0);
    int k = 0;
    for (int t0 = 0; t0 < L; t0 += TR, k ^= 1) {
      const int rows = min(TR, L - t0);
      const size_t row0 = static_cast<size_t>(b) * L + t0;
      cp_async_wait<0>();
      __syncthreads();  // tile k landed; the last tile's readers of the other raw tile are done
      if (t0 + TR < L) fetch_tile(t0 + TR, k ^ 1);
      stage_tile(ru(k), rd(k), rb(k), rc(k), DX, BC);
      __syncthreads();
      const T* us = ru(k);
      const T* zs = rz(k);
      for (int r0 = 0; r0 < rows; r0 += kBatch) {
        float a[kBatch][kPerLane], x[kBatch], yp[2][kLanes];
        // Rows of the batch that end a chunk with a chunk after it.
        const int tb = t0 + r0;
        unsigned ends = 0u;
        for (int e = next; e < tb + kBatch && e + 1 < L; e += chunk) ends |= 1u << (e - tb);
        if ((ends & ~(1u << (kBatch - 1))) == 0u) {
#pragma unroll
          for (int r = 0; r < kBatch; ++r) {
            const float2 dx = DX[(r0 + r) * CH + c];
            x[r] = dx.y;
            S += dx.x;
#pragma unroll
            for (int s = 0; s < kPerLane; ++s) a[r][s] = ex2(dx.x * a2[s]);
          }
#pragma unroll
          for (int r = 0; r < kBatch; ++r) {
            const float4 bc = BC[(r0 + r) * kLanes + j];
            const float b0 = x[r] * bc.x, b1 = x[r] * bc.y;
            h[0] = fmaf(a[r][0], h[0], b0);
            h[1] = fmaf(a[r][1], h[1], b1);
            E[0] = fmaf(a[r][0], E[0], b0);
            E[1] = fmaf(a[r][1], E[1], b1);
            yp[r / kLanes][r % kLanes] = pair_share(bc.z, bc.w, h[0], h[1]);
          }
          if (ends) carry();
        } else {
#pragma unroll
          for (int r = 0; r < kBatch; ++r) {
            const float2 dx = DX[(r0 + r) * CH + c];
            x[r] = dx.y;
#pragma unroll
            for (int s = 0; s < kPerLane; ++s) a[r][s] = ex2(dx.x * a2[s]);
          }
#pragma unroll
          for (int r = 0; r < kBatch; ++r) {
            const float4 bc = BC[(r0 + r) * kLanes + j];
            const float b0 = x[r] * bc.x, b1 = x[r] * bc.y;
            S += DX[(r0 + r) * CH + c].x;
            h[0] = fmaf(a[r][0], h[0], b0);
            h[1] = fmaf(a[r][1], h[1], b1);
            E[0] = fmaf(a[r][0], E[0], b0);
            E[1] = fmaf(a[r][1], E[1], b1);
            yp[r / kLanes][r % kLanes] = pair_share(bc.z, bc.w, h[0], h[1]);
            if ((ends >> r) & 1u) carry();
          }
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float ys = lane_sum(yp[q], j);
          const int rr = r0 + q * kLanes + j;
          const size_t o = (row0 + rr) * d + ch;
          if (live && rr < rows) {
            const float v = first ? ys : p.ysum[o] + ys;
            if (!last) {
              p.ysum[o] = v;
            } else {
              p.y[o] = from_f32<T>(gate(v, Dv, to_f32(us[rr * CH + c]), to_f32(zs[rr * CH + c])));
            }
          }
        }
      }
    }
  }
}

// --- the three passes, where the walk has too few lanes ----------------------
//
// At a small batch (fewer than kWalkBlocksPerSm blocks of the walk an SM)
// one lane a (row, channel, state pair) leaves the card's warps waiting on
// each batch's latencies (K14 at 4 x 32768: the walk 1.80 ms, these passes
// 1.02; NVIDIA H100 80GB HBM3, PERF.md). There the chunks run in parallel
// instead, each exp(delta A) taken twice: pass 1 runs every chunk from a
// zero state for its end state E and P = exp(S A) from the sum S of its
// delta_t, pass 2 chains them into h0s, pass 3 reruns every chunk from h0s and reads it out
// through C, gated; a thread holds 16 states of one channel. d_state > 16
// runs passes 1 and 3 over groups of 16 states, pass 3 keeping each row's
// C . h of the groups so far in shared memory (chunk x 128 floats), which
// with the chunk's B and C bounds the chunks they run (`scan_smem3`); the
// walk takes the rest.
constexpr int kPassThreads = 128;   // channels of a pass block
constexpr int kWalkBlocksPerSm = 3;

// Pass 1: each (b, chunk, channel) from a zero state, a group of 16 states
// at a time (Grp: d_state > 16), the group's B columns staged before it; P
// and E are (Bt, n_chunks, N, d).
template <typename T, bool Grp>
__global__ void __launch_bounds__(kPassThreads)
    scan_chunk_kernel(const T* __restrict__ u, int ld_u, const float* __restrict__ delta,
                      const T* __restrict__ Bc, int ld_bc, const float* __restrict__ A,
                      float* __restrict__ P, float* __restrict__ E, int L, int d, int N,
                      int chunk) {
  extern __shared__ __align__(16) float sm[];
  float* Bs = sm;                  // chunk x kMaxN
  const int b = blockIdx.z, c = blockIdx.y, nc = gridDim.y;
  const int ch = blockIdx.x * kPassThreads + threadIdx.x;
  const bool live = ch < d;
  const int t0 = c * chunk, rows = min(chunk, L - t0);
  const size_t row0 = static_cast<size_t>(b) * L + t0;
  const size_t o = (static_cast<size_t>(b) * nc + c) * N * d + ch;
  const int n_end = Grp ? N : 1;
  for (int n0 = 0; n0 < n_end; n0 += kMaxN) {
    if (Grp && n0 > 0) __syncthreads();  // the last group's readers of Bs are done
    stage_rows(Bc, ld_bc, row0, rows, rows, N, n0, Bs);
    __syncthreads();
    if (!live) continue;
    float a2[kMaxN], h[kMaxN], bv[kMaxN], S = 0.f;
    load_a(A, ch, N, n0, a2);
#pragma unroll
    for (int n = 0; n < kMaxN; ++n) h[n] = 0.f;
    for (int r = 0; r < rows; ++r) {
      const float dt = delta[(row0 + r) * d + ch];
      const float dtu = dt * to_f32(u[(row0 + r) * ld_u + ch]);
      S += dt;
      load_row(Bs + r * kMaxN, bv);
#pragma unroll
      for (int n = 0; n < kMaxN; ++n) h[n] = fmaf(ex2(dt * a2[n]), h[n], dtu * bv[n]);
    }
#pragma unroll
    for (int n = 0; n < kMaxN; ++n) {
      if (n0 + n >= N) break;
      P[o + static_cast<size_t>(n0 + n) * d] = ex2(S * a2[n]);
      E[o + static_cast<size_t>(n0 + n) * d] = h[n];
    }
  }
}

// Pass 2: the entry state of every chunk, per (b, state, channel).
__global__ void __launch_bounds__(256)
    scan_carry_kernel(const float* __restrict__ P, const float* __restrict__ E,
                      float* __restrict__ h0s, int nc, int Nd) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= Nd) return;
  const size_t base = static_cast<size_t>(blockIdx.y) * nc * Nd + i;
  float e = 0.f;
  for (int c = 0; c < nc; ++c) {
    const size_t o = base + static_cast<size_t>(c) * Nd;
    h0s[o] = e;
    e = fmaf(P[o], e, E[o]);
  }
}

// Pass 3: each chunk from its entry state, read out through C and gated.
// Grp (d_state > 16): the groups in order, each group's B and C columns
// staged before it, each row's C.h sum carried from group to group in
// shared memory (ysum), gated after the last.
template <typename T, bool Grp>
__global__ void __launch_bounds__(kPassThreads)
    scan_out_kernel(const T* __restrict__ u, int ld_u, const float* __restrict__ delta,
                    const T* __restrict__ Bc, const T* __restrict__ Cc, int ld_bc,
                    const T* __restrict__ z, int ld_z, const float* __restrict__ A,
                    const float* __restrict__ D, const float* __restrict__ h0s,
                    T* __restrict__ y, int L, int d, int N, int chunk) {
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.z, c = blockIdx.y, nc = gridDim.y;
  const int ch = blockIdx.x * kPassThreads + threadIdx.x;
  const bool live = ch < d;
  const int t0 = c * chunk, rows = min(chunk, L - t0);
  const size_t row0 = static_cast<size_t>(b) * L + t0;
  float* Bs = sm;                        // chunk x kMaxN
  float* Cs = Bs + chunk * kMaxN;        // chunk x kMaxN
  float* ysum = Cs + chunk * kMaxN;      // chunk x kPassThreads, Grp
  const size_t o = (static_cast<size_t>(b) * nc + c) * N * d + ch;
  const float dv = live ? D[ch] : 0.f;
  const int n_end = Grp ? N : 1;
  for (int n0 = 0; n0 < n_end; n0 += kMaxN) {
    const bool first = !Grp || n0 == 0, last = !Grp || n0 + kMaxN >= N;
    if (Grp && n0 > 0) __syncthreads();  // the last group's readers of Bs and Cs are done
    stage_rows(Bc, ld_bc, row0, rows, rows, N, n0, Bs);
    stage_rows(Cc, ld_bc, row0, rows, rows, N, n0, Cs);
    __syncthreads();
    if (!live) continue;
    float a2[kMaxN], h[kMaxN], bv[kMaxN], cv[kMaxN];
    load_a(A, ch, N, n0, a2);
#pragma unroll
    for (int n = 0; n < kMaxN; ++n)
      h[n] = n0 + n < N ? h0s[o + static_cast<size_t>(n0 + n) * d] : 0.f;
    for (int r = 0; r < rows; ++r) {
      const size_t row = row0 + r;
      const float dt = delta[row * d + ch];
      const float uu = to_f32(u[row * ld_u + ch]);
      const float dtu = dt * uu;
      load_row(Bs + r * kMaxN, bv);
      load_row(Cs + r * kMaxN, cv);
#pragma unroll
      for (int n = 0; n < kMaxN; ++n) h[n] = fmaf(ex2(dt * a2[n]), h[n], dtu * bv[n]);
      const float yg = group_sum(cv, h);
      const float ys = first ? yg : ysum[r * kPassThreads + threadIdx.x] + yg;
      if (!last) {
        ysum[r * kPassThreads + threadIdx.x] = ys;
        continue;
      }
      y[row * d + ch] = from_f32<T>(gate(ys, dv, uu, to_f32(z[row * ld_z + ch])));
    }
  }
}

// Shared memory of passes 1 and 3: one group's B (and C) columns of the
// chunk's rows, and past 16 states each row's running C.h; none of it grows
// with d_state. The wrappers' `ssm_scan_takes` and `ssm_scan_dtlr_takes`
// hold the same sums.
size_t scan_smem1(int chunk) { return sizeof(float) * chunk * kMaxN; }

size_t scan_smem3(int chunk, int N) {
  return sizeof(float) * chunk * (2 * kMaxN + (N > kMaxN ? kPassThreads : 0));
}

// Whether a scan of Bt rows of d channels runs the three passes: fewer
// than kWalkBlocksPerSm blocks of the walk an SM, and a chunk whose pass 3
// fits in shared memory.
bool use_passes(int Bt, int d, int N, int chunk) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long blocks = static_cast<long long>(Bt) * ((d + kScanCh - 1) / kScanCh);
  return blocks < static_cast<long long>(kWalkBlocksPerSm) * sms &&
         scan_smem3(chunk, N) <= static_cast<size_t>(kSmemMax);
}

template <typename T, bool Grp>
cudaError_t passes(const ScanArgs<T>& a, int Bt, cudaStream_t s) {
  const int nc = (a.L + a.chunk - 1) / a.chunk;
  const size_t s1 = scan_smem1(a.chunk), s3 = scan_smem3(a.chunk, a.N);
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(scan_chunk_kernel<T, Grp>), s1);
  if (err != cudaSuccess) return err;
  err = allow_smem(reinterpret_cast<const void*>(scan_out_kernel<T, Grp>), s3);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.d + kPassThreads - 1) / kPassThreads, nc, Bt);
  scan_chunk_kernel<T, Grp><<<grid, kPassThreads, s1, s>>>(a.u, a.ld_u, a.delta, a.Bc, a.ld_bc,
                                                           a.A, a.P, a.E, a.L, a.d, a.N, a.chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_carry_kernel<<<dim3((a.N * a.d + 255) / 256, Bt), 256, 0, s>>>(a.P, a.E, a.h0s, nc,
                                                                     a.N * a.d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_out_kernel<T, Grp><<<grid, kPassThreads, s3, s>>>(a.u, a.ld_u, a.delta, a.Bc, a.Cc,
                                                         a.ld_bc, a.z, a.ld_z, a.A, a.D, a.h0s,
                                                         a.y, a.L, a.d, a.N, a.chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t scan(const ScanArgs<T>& a, int Bt, cudaStream_t s) {
  if (a.N <= 0 || a.chunk <= 0 || a.d <= 0 || a.L <= 0 || a.delta == nullptr)
    return cudaErrorInvalidValue;
  if (use_passes(Bt, a.d, a.N, a.chunk)) {
    if (a.P == nullptr || a.E == nullptr) return cudaErrorInvalidValue;
    return a.N > kMaxN ? passes<T, true>(a, Bt, s) : passes<T, false>(a, Bt, s);
  }
  if (a.N > kMaxN && a.ysum == nullptr) return cudaErrorInvalidValue;
  auto launch = [&](auto kernel) {
    const void* fn = reinterpret_cast<const void*>(kernel);
    const size_t smem = scan_fwd_smem(sizeof(T));
    cudaError_t err = allow_smem(fn, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    kernel<<<dim3((a.d + kScanCh - 1) / kScanCh, Bt), kScanThreads, smem, s>>>(a);
    return cudaGetLastError();
  };
  return a.N > kMaxN ? launch(scan_fwd_kernel<T, true>) : launch(scan_fwd_kernel<T, false>);
}

template <typename T>
ScanArgs<T> scan_args(const T* u, int ld_u, const float* delta, const T* Bc, const T* Cc,
                      int ld_bc, const T* z, int ld_z, const float* A, const float* D, T* y,
                      float* h0s, float* ysum, float* P, float* E, int L, int d, int N,
                      int chunk) {
  ScanArgs<T> a{};
  a.u = u, a.ld_u = ld_u, a.delta = delta, a.Bc = Bc, a.Cc = Cc, a.ld_bc = ld_bc;
  a.z = z, a.ld_z = ld_z, a.A = A, a.D = D, a.y = y, a.h0s = h0s, a.ysum = ysum;
  a.P = P, a.E = E;
  a.L = L, a.d = d, a.N = N, a.chunk = chunk;
  return a;
}

// K16: delta into the (Bt L, d) fp32 workspace, then the scan on it. L must
// be a multiple of the chunk.
template <typename T>
cudaError_t scan_dtlr(const ScanArgs<T>& a, const float* lr, int ld_lr, const float* wdt,
                      const float* bdt, int Bt, int R, cudaStream_t s) {
  if (R <= 0 || a.d <= 0 || a.L <= 0 || a.chunk <= 0 || a.L % a.chunk || a.delta == nullptr)
    return cudaErrorInvalidValue;
  cudaError_t err = form_delta(lr, ld_lr, wdt, bdt, const_cast<float*>(a.delta),
                               static_cast<size_t>(Bt) * a.L, a.d, R, s);
  if (err != cudaSuccess) return err;
  return scan<T>(a, Bt, s);
}

template <typename T>
cudaError_t inner(const T* h, const T* w_in, const T* cw, const T* cb, const T* w_x,
                  const float* w_dt, const float* b_dt, const float* A, const float* D,
                  const T* w_out, T* xz, T* u, T* xdbl, float* delta, float* h0s, float* ysum,
                  float* P, float* E, T* y, T* out, int Bt, int L, int H, int d, int K, int R,
                  int N, int chunk, cudaStream_t s) {
  const int M = Bt * L, nx = R + 2 * N;
  cudaError_t err = gemm(h, w_in, xz, M, 2 * d, H, H, 2 * d, s);
  if (err != cudaSuccess) return err;
  err = front<T>(xz, cw, cb, w_x, w_dt, b_dt, u, xdbl, delta, Bt, L, d, K, R, N, s);
  if (err != cudaSuccess) return err;
  err = scan<T>(scan_args<T>(u, d, delta, xdbl + R, xdbl + R + N, nx, xz + d, 2 * d, A, D, y,
                             h0s, ysum, P, E, L, d, N, chunk),
                Bt, s);
  if (err != cudaSuccess) return err;
  return gemm(y, w_out, out, M, H, d, d, H, s);
}

const float* f(const void* p) { return static_cast<const float*>(p); }
float* fo(void* p) { return static_cast<float*>(p); }
const bf16* b(const void* p) { return static_cast<const bf16*>(p); }
bf16* bo(void* p) { return static_cast<bf16*>(p); }

}  // namespace

// K14. ysum: (Bt L, d) fp32 scratch, needed by the walk past 16 states;
// P, E: (Bt, n_chunks, N, d) fp32 scratch, needed by the passes
// (`ddg_scan_passes`); else null.
extern "C" int ddg_ssm_scan(const void* u, int ld_u, const void* delta, const void* Bc,
                            const void* Cc, int ld_bc, const void* z, int ld_z, const void* A,
                            const void* D, void* y, void* h0s, void* ysum, void* P, void* E,
                            int Bt, int L, int d, int N, int chunk, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ddg::kF32)
    return scan<float>(scan_args<float>(f(u), ld_u, f(delta), f(Bc), f(Cc), ld_bc, f(z), ld_z,
                                        f(A), f(D), fo(y), fo(h0s), fo(ysum), fo(P), fo(E), L,
                                        d, N, chunk),
                       Bt, s);
  if (dtype == ddg::kBF16)
    return scan<bf16>(scan_args<bf16>(b(u), ld_u, f(delta), b(Bc), b(Cc), ld_bc, b(z), ld_z,
                                      f(A), f(D), bo(y), fo(h0s), fo(ysum), fo(P), fo(E), L, d,
                                      N, chunk),
                      Bt, s);
  return cudaErrorInvalidValue;
}

// K16: dt_lr (Bt L rows of stride ld_lr, fp32), W_dt (R, d), b_dt (d) fp32;
// delta is a (Bt L, d) fp32 workspace, ysum, P and E as K14's.
extern "C" int ddg_ssm_scan_dtlr(const void* u, int ld_u, const void* dt_lr, int ld_lr,
                                 const void* w_dt, const void* b_dt, void* delta,
                                 const void* Bc, const void* Cc, int ld_bc, const void* z,
                                 int ld_z, const void* A, const void* D, void* y, void* h0s,
                                 void* ysum, void* P, void* E, int Bt, int L, int d, int N, int R,
                                 int chunk, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ddg::kF32)
    return scan_dtlr<float>(
        scan_args<float>(f(u), ld_u, f(delta), f(Bc), f(Cc), ld_bc, f(z), ld_z, f(A), f(D),
                         fo(y), fo(h0s), fo(ysum), fo(P), fo(E), L, d, N, chunk),
        f(dt_lr), ld_lr, f(w_dt), f(b_dt), Bt, R, s);
  if (dtype == ddg::kBF16)
    return scan_dtlr<bf16>(
        scan_args<bf16>(b(u), ld_u, f(delta), b(Bc), b(Cc), ld_bc, b(z), ld_z, f(A), f(D),
                        bo(y), fo(h0s), fo(ysum), fo(P), fo(E), L, d, N, chunk),
        f(dt_lr), ld_lr, f(w_dt), f(b_dt), Bt, R, s);
  return cudaErrorInvalidValue;
}

// 1 where a scan of Bt rows, d channels, d_state N and `chunk` runs the
// three passes on the current card (the wrappers then hand it P and E),
// 0 where it runs the walk.
extern "C" int ddg_scan_passes(int Bt, int d, int N, int chunk) {
  return use_passes(Bt, d, N, chunk) ? 1 : 0;
}

// The sums the wrappers mirror (`ops.mamba.scan_smem`, `_front_smem`,
// `_SMEM`), so that a check on the card can hold the two sides together:
// the forward scan's (fp32, its larger; the same for every chunk and
// d_state); R > 0 adds K16's delta kernel.
extern "C" long long ddg_scan_smem(int chunk, int N, int R) {
  (void)chunk, (void)N;
  size_t m = scan_fwd_smem(4);
  if (R > 0 && delta_smem(R) > m) m = delta_smem(R);
  return static_cast<long long>(m);
}

extern "C" int ddg_front_smem(int tsize) { return front_smem(tsize); }

extern "C" int ddg_smem_max() { return kSmemMax; }

extern "C" int ddg_mamba_inner(const void* h, const void* w_in, const void* cw, const void* cb,
                               const void* w_x, const void* w_dt, const void* b_dt,
                               const void* A, const void* D, const void* w_out, void* xz,
                               void* u, void* xdbl, void* delta, void* h0s, void* ysum, void* P,
                               void* E, void* y, void* out, int Bt, int L, int H, int d, int K,
                               int R, int N, int chunk, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ddg::kF32)
    return inner<float>(f(h), f(w_in), f(cw), f(cb), f(w_x), f(w_dt), f(b_dt), f(A), f(D),
                        f(w_out), fo(xz), fo(u), fo(xdbl), fo(delta), fo(h0s), fo(ysum), fo(P),
                        fo(E), fo(y), fo(out), Bt, L, H, d, K, R, N, chunk, s);
  if (dtype == ddg::kBF16)
    return inner<bf16>(b(h), b(w_in), b(cw), b(cb), b(w_x), f(w_dt), f(b_dt), f(A), f(D),
                       b(w_out), bo(xz), bo(u), bo(xdbl), fo(delta), fo(h0s), fo(ysum), fo(P),
                       fo(E), bo(y), bo(out), Bt, L, H, d, K, R, N, chunk, s);
  return cudaErrorInvalidValue;
}
