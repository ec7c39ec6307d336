// adaLN chains of the DiT block, forward.
//
// Replaces the TPU kernels in ddg_tpu/ops/adaln_pallas.py:
//   ln_modulate          -> _ln_mod_fwd   -> _lm_fwd_kernel (pallas_call :132)
//   gate_res_ln_modulate -> _gate_res_fwd -> _gr_fwd_kernel (pallas_call :215)
// computing, per (b, l) row of width D,
//   [x' = skip + gate[b] * y,  written in y's dtype]
//   h  = (x - mean) * rsqrt(max(E[x^2] - mean^2, 0) + 1e-5) * (w * (1 + scale[b])) + shift[b]
// with fp32 one-pass moments. The residual form normalises the unrounded
// fp32 x', as _gr_fwd_kernel does.
//
// Bound on the H100: bytes. About ten fp32 operations per element against
// 4-6 bytes read and written per element (bf16), far below the ~20
// operations per byte where fp32 arithmetic would take over.
//
// K3 (ln_modulate): K4's mapping (below) applied to the forward.
// A row belongs to a team of G warps (one warp up to 128 16-byte vectors a
// row, D = 1024 in bf16; G = ceil(vectors / 128) past that), a lane holding
// V <= 4 vectors of the row, lane t of the team vectors t, t + 32 G, ... A
// block is a tile of R rows of one batch row b, taken in turns by its
// teams (8 / G of them up to G = 8; one team of G warps past that). R is
// the longest of 128, 64 and 32 rows that still gives kFwdMinBlocks blocks
// (about a wave of the H100's 132 SMs at two blocks an SM), else 32: long
// tiles spread each team's start over more rows, short ones fill the card
// at small batches.
// Lane t owns the same columns in every row of the block, so it forms
// w (1 + scale[b]) and shift[b] for them once a block, in registers (past
// G = 8, where a block of G warps leaves 64 registers a thread, it reads
// them again for each row, from L1). Each team has two rows in flight: the
// next row's 16-byte loads go out before the current row's sums. The sums
// are warp shuffles, and past one warp the team's warps in order through
// shared memory behind a named barrier of the team alone (two slots,
// alternating by row): no block barrier anywhere, so no row waits on a
// block launch, a block barrier or the modulation's loads behind one.
//
// K5 (gate_res_ln_modulate) keeps the first design: one block per row,
// each thread holding up to kMaxVec 16-byte vectors of the row in
// registers, so the row streams are read once and h and x' written once,
// with 16-byte coalesced accesses; the moments reduce with warp shuffles
// and, across the warps of a block, through shared memory.
//
// Rows need D % 8 == 0 (bf16) or D % 4 == 0 (fp32), at most 4096 16-byte
// vectors; the wrapper checks that. gate/shift/scale are (B, D) views with
// a row stride (`cond_stride`), so the chunks of the adaLN projection need
// no copy.
//
// Backward (K4, K6), replacing
//   ln_modulate          -> _ln_mod_bwd   -> _lm_bwd_kernel (pallas_call :149)
//   gate_res_ln_modulate -> _gate_res_bwd -> _gr_bwd_kernel (pallas_call :234)
// with the math of _mod_bwd, all in fp32: the moments are recomputed from
// the saved x (x' for K6, as rounded by the forward), then
//   dxn = dh * w * (1 + scale[b]),  dx_ln = r (dxn - mean(dxn) - xn mean(dxn xn))
//   K6: dx_tot = dx + dx_ln,  dy = dx_tot * gate[b],  dskip = dx_tot
//   dshift[b] = sum_l dh,  dscale[b] = w * sum_l dh xn,  dgate[b] = sum_l dx_tot y
//   dw = sum_b (1 + scale[b]) * sum_l dh xn
// Bound on the H100: bytes (3 row streams for K4, 6 for K6, a few fp32
// operations per element).
// The TPU kernel walks the L tiles of a batch row in order and adds the
// conditioning grads into its output block. Hopper blocks run in parallel,
// so the sums are staged and deterministic, with no atomics:
//   1. rows: one block per (b, tile of kBwdRows rows). A row belongs to a
//      team of G warps (one warp up to 128 16-byte vectors a row, D = 1024
//      in bf16; G = ceil(vectors / 128) past that), a lane holding V <= 4
//      vectors of each stream, lane t of the team vectors t, t + 32 G, ...;
//      the block's teams (8 / G) take its rows in turn. A row's loads (x
//      and dh, and dx and y for K6) all go out at once, as raw 16-byte
//      vectors; its two pairs of sums ((x, x^2), then (dxn, dxn xn)) are
//      warp shuffles, and past one warp a fixed-order sum of the team's
//      warps through shared memory behind a named barrier of the team
//      alone: no block barrier inside the row loop. Other warps' loads
//      keep the memory busy while a warp sums. The per-column partials
//      (sum dh, sum dh xn, and for K6 sum dx_tot y) stay in shared memory,
//      one slice a team, each column updated by its one owner; w (1 +
//      scale[b]) and gate[b] are staged there once a block. At the end the
//      block adds its teams' slices in team order into an fp32 workspace
//      (P, B, tiles, D), P = 2 (K4) or 3 (K6).
//   2. conditioning: one block per (128 columns, group of kCondGroup batch
//      rows) adds each b's tiles in order into dshift, dscale = w S_b (S_b
//      = sum dh xn) and dgate, and sums (1 + scale[b]) S_b over its group's
//      b in order into a partial of dw;
//   3. dw: the groups' partials in order.
// Reruns give bit-identical grads.

#include "common.cuh"

namespace {

constexpr int kMaxVec = 4;       // K5: 16-byte vectors a thread holds, at most
constexpr int kLaneVec = 4;      // K3, K4, K6: 16-byte vectors a lane holds of a row stream
constexpr int kMaxRowVec = 4096; // 16-byte vectors a row, at most (K3, K5)

// A raw 16-byte vector of T as N fp32 values, and back.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& r, float* out);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& r, float* out) {
  out[0] = __uint_as_float(r.x), out[1] = __uint_as_float(r.y);
  out[2] = __uint_as_float(r.z), out[3] = __uint_as_float(r.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& r, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <typename T>
__device__ __forceinline__ uint4 ld_raw(const T* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// The team's two sums, in every lane: the warp's by a shuffle butterfly,
// then past one warp the team's warps' in warp order, through the team's
// exchange slot `xch` (2 G floats). A slot is rewritten only after the
// team's barrier that follows its last reads: K3 alternates two slots by
// row, K4/K6 take slot 0 for the first pair of a row and 1 for the second.
__device__ __forceinline__ void team_sum2(float& a, float& b, float* xch, int G, int wt,
                                          int lane, int team) {
  a = ddg::warp_sum(a);
  b = ddg::warp_sum(b);
  if (G == 1) return;
  if (lane == 0) {
    xch[2 * wt] = a;
    xch[2 * wt + 1] = b;
  }
  asm volatile("bar.sync %0, %1;" ::"r"(team + 1), "r"(G * 32) : "memory");
  a = xch[0];
  b = xch[1];
  for (int w = 1; w < G; ++w) {
    a += xch[2 * w];
    b += xch[2 * w + 1];
  }
}

// --- K3: ln_modulate forward --------------------------------------------------

constexpr int kFwdMinBlocks = 256;  // blocks a launch, for its tiles longer than 32 rows
constexpr int kFwdWarps = 8;     // warps of a block up to teams of 8 warps
constexpr int kFwdDepth = 2;     // rows in flight a team

// The launch for B x L rows of nvec 16-byte vectors: tiles of R rows, a
// team of G warps a row, V vectors a lane, T teams a block of `threads`;
// hold: the modulation stays in registers for the block (G <= kFwdWarps),
// else it is read again for each row.
struct FwdPlan {
  int R, tiles, G, V, T, threads, hold;
};

FwdPlan fwd_plan(int B, int L, int nvec) {
  FwdPlan p;
  p.R = 32;
  for (int r = 128; r > 32; r /= 2)
    if (static_cast<long long>(B) * ((L + r - 1) / r) >= kFwdMinBlocks) {
      p.R = r;
      break;
    }
  p.tiles = (L + p.R - 1) / p.R;
  p.G = (nvec + 32 * kLaneVec - 1) / (32 * kLaneVec);
  p.V = (nvec + 32 * p.G - 1) / (32 * p.G);
  p.hold = p.G <= kFwdWarps;
  p.T = p.hold ? kFwdWarps / p.G : 1;
  p.threads = p.T * p.G * 32;
  return p;
}

// The modulation of the N columns of vector `col`: mul = w (1 + scale[b])
// and shift[b] in fp32.
template <typename T, int N>
__device__ __forceinline__ void modulation(const float* w, const T* shift, const T* scale,
                                           size_t cond, int col, float (&mul)[N],
                                           float (&sh)[N]) {
  float wv[N], sc[N];
  ddg::load_f32<N>(w + col, wv);
  ddg::load16(shift + cond + col, sh);
  ddg::load16(scale + cond + col, sc);
#pragma unroll
  for (int i = 0; i < N; ++i) mul[i] = __fmul_rn(wv[i], __fadd_rn(1.f, sc[i]));
}

template <typename T, int V>
__device__ __forceinline__ void load_row(const T* x, size_t base, int t, int TT, int nvec,
                                         uint4 (&r)[V]) {
  constexpr int N = ddg::Vec16<T>::N;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int vi = t + k * TT;
    if (vi < nvec) r[k] = ld_raw(x + base + static_cast<size_t>(vi) * N);
  }
}

// One row: its moments (each lane's elements in order, then team_sum2 into
// slot `xch`), then h = (x - mean) r mul + shift, stored.
template <typename T, int V, bool kHold, int N = ddg::Vec16<T>::N>
__device__ __forceinline__ void modulate_row(const uint4 (&r)[V], size_t base, T* __restrict__ h,
                                             const float (&mul)[kHold ? V : 1][N],
                                             const float (&shv)[kHold ? V : 1][N], const float* w,
                                             const T* shift, const T* scale, size_t cond,
                                             float* xch, int t, int TT, int nvec, int D, int G,
                                             int wt, int lane, int team) {
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (t + k * TT >= nvec) continue;
    float v[N];
    unpack<T>(r[k], v);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      s1 += v[i];
      s2 = fmaf(v[i], v[i], s2);
    }
  }
  team_sum2(s1, s2, xch, G, wt, lane, team);
  const float m1 = s1 / D;
  const float m2 = s2 / D;
  const float rr = rsqrtf(fmaxf(m2 - m1 * m1, 0.f) + 1e-5f);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int vi = t + k * TT;
    if (vi >= nvec) continue;
    float v[N], o[N], mu[N], sh[N];
    unpack<T>(r[k], v);
    if constexpr (kHold) {
#pragma unroll
      for (int i = 0; i < N; ++i) mu[i] = mul[k][i], sh[i] = shv[k][i];
    } else {
      modulation<T, N>(w, shift, scale, cond, vi * N, mu, sh);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float xn = __fmul_rn(__fsub_rn(v[i], m1), rr);
      o[i] = __fadd_rn(__fmul_rn(xn, mu[i]), sh[i]);
    }
    ddg::store16(h + base + static_cast<size_t>(vi) * N, o);
  }
}

template <typename T, int V, bool kHold>
__global__ void __launch_bounds__(kHold ? kFwdWarps * 32 : 1024, kHold ? 2 : 1)
    ln_modulate_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       const T* __restrict__ shift, const T* __restrict__ scale,
                       T* __restrict__ h, int L, int D, int cond_stride, int R, int tiles,
                       int G) {
  constexpr int N = ddg::Vec16<T>::N;
  __shared__ float xch[4 * 32];  // per team two slots of (s1, s2) a warp; T G <= 32
  const int TT = 32 * G, Tm = blockDim.x / TT;
  const int tid = threadIdx.x, team = tid / TT, t = tid % TT;
  const int lane = tid & 31, wt = t >> 5;
  const int nvec = D / N;
  const int b = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const size_t cond = static_cast<size_t>(b) * cond_stride;
  const size_t row0 = static_cast<size_t>(b) * L;
  const int r_end = min((tile + 1) * R, L);
  float* tx = xch + team * 4 * G;

  float mul[kHold ? V : 1][N], sh[kHold ? V : 1][N];
  // kFwdDepth rows in flight: a row's loads go out kFwdDepth - 1 rows
  // before its sums.
  const int r0 = tile * R + team;
  uint4 rows[kFwdDepth][V];
#pragma unroll
  for (int j = 0; j + 1 < kFwdDepth; ++j)
    if (r0 + j * Tm < r_end) load_row<T, V>(x, (row0 + r0 + j * Tm) * D, t, TT, nvec, rows[j]);
  if constexpr (kHold) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int vi = t + k * TT;
      if (vi < nvec) modulation<T, N>(w, shift, scale, cond, vi * N, mul[k], sh[k]);
    }
  }
  int slot = 0;
  for (int r = r0; r < r_end; r += kFwdDepth * Tm) {
#pragma unroll
    for (int j = 0; j < kFwdDepth; ++j) {
      const int rj = r + j * Tm;
      if (rj >= r_end) break;
      const int rn = rj + (kFwdDepth - 1) * Tm;
      if (rn < r_end)
        load_row<T, V>(x, (row0 + rn) * D, t, TT, nvec, rows[(j + kFwdDepth - 1) % kFwdDepth]);
      modulate_row<T, V, kHold>(rows[j], (row0 + rj) * D, h, mul, sh, w, shift, scale, cond,
                                tx + 2 * G * slot, t, TT, nvec, D, G, wt, lane, team);
      slot ^= 1;
    }
  }
}

template <typename T, int V, bool kHold>
cudaError_t launch_ln_modulate(const FwdPlan& p, const void* x, const void* w, const void* shift,
                               const void* scale, void* h, int B, int L, int D, int cond_stride,
                               cudaStream_t stream) {
  ln_modulate_kernel<T, V, kHold><<<B * p.tiles, p.threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<const T*>(shift),
      static_cast<const T*>(scale), static_cast<T*>(h), L, D, cond_stride, p.R, p.tiles, p.G);
  return cudaGetLastError();
}

template <typename T>
int launch_fwd(const void* x, const void* w, const void* shift, const void* scale, void* h,
               int rows, int L, int D, int cond_stride, cudaStream_t stream) {
  constexpr int N = ddg::Vec16<T>::N;
  if (D <= 0 || D % N || cond_stride % N || L <= 0 || rows < 0 || rows % L ||
      D / N > kMaxRowVec)
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const int B = rows / L;
  const FwdPlan p = fwd_plan(B, L, D / N);
  // Past kFwdWarps warps a row (more than 1024 vectors), every lane holds 4.
  if (!p.hold) return launch_ln_modulate<T, 4, false>(p, x, w, shift, scale, h, B, L, D,
                                                      cond_stride, stream);
  switch (p.V) {
    case 1:
      return launch_ln_modulate<T, 1, true>(p, x, w, shift, scale, h, B, L, D, cond_stride,
                                            stream);
    case 2:
      return launch_ln_modulate<T, 2, true>(p, x, w, shift, scale, h, B, L, D, cond_stride,
                                            stream);
    case 3:
      return launch_ln_modulate<T, 3, true>(p, x, w, shift, scale, h, B, L, D, cond_stride,
                                            stream);
    default:
      return launch_ln_modulate<T, 4, true>(p, x, w, shift, scale, h, B, L, D, cond_stride,
                                            stream);
  }
}

// --- K5: gate_res_ln_modulate forward -------------------------------------------

__device__ __forceinline__ void block_sum2(float& a, float& b) {
  a = ddg::warp_sum(a);
  b = ddg::warp_sum(b);
  if (blockDim.x <= 32) return;
  __shared__ float sa[32], sb[32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  a = ddg::warp_sum(lane < nw ? sa[lane] : 0.f);
  b = ddg::warp_sum(lane < nw ? sb[lane] : 0.f);
  __syncthreads();  // sa/sb are free again for the next call
}

template <typename T>
__global__ void gate_res_kernel(const T* __restrict__ y, const T* __restrict__ skip,
                                const T* __restrict__ gate, const float* __restrict__ w,
                                const T* __restrict__ shift, const T* __restrict__ scale,
                                T* __restrict__ x_out, T* __restrict__ h_out, int L, int D,
                                int cond_stride) {
  constexpr int N = ddg::Vec16<T>::N;
  const int row = blockIdx.x;
  const size_t cond = static_cast<size_t>(row / L) * cond_stride;
  const size_t base = static_cast<size_t>(row) * D;
  const int nvec = D / N;

  float v[kMaxVec][N];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxVec; ++k) {
    const int vi = threadIdx.x + k * blockDim.x;
    if (vi >= nvec) continue;
    const int col = vi * N;
    ddg::load16(y + base + col, v[k]);
    float sk[N], g[N];
    ddg::load16(skip + base + col, sk);
    ddg::load16(gate + cond + col, g);
#pragma unroll
    for (int i = 0; i < N; ++i) v[k][i] = __fadd_rn(sk[i], __fmul_rn(g[i], v[k][i]));
    ddg::store16(x_out + base + col, v[k]);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      s1 += v[k][i];
      s2 = fmaf(v[k][i], v[k][i], s2);
    }
  }
  block_sum2(s1, s2);
  const float m1 = s1 / D;
  const float m2 = s2 / D;
  const float r = rsqrtf(fmaxf(m2 - m1 * m1, 0.f) + 1e-5f);

#pragma unroll
  for (int k = 0; k < kMaxVec; ++k) {
    const int vi = threadIdx.x + k * blockDim.x;
    if (vi >= nvec) continue;
    const int col = vi * N;
    float wv[N], sh[N], sc[N], h[N];
    ddg::load_f32<N>(w + col, wv);
    ddg::load16(shift + cond + col, sh);
    ddg::load16(scale + cond + col, sc);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float xn = __fmul_rn(__fsub_rn(v[k][i], m1), r);
      const float mul = __fmul_rn(wv[i], __fadd_rn(1.f, sc[i]));
      h[i] = __fadd_rn(__fmul_rn(xn, mul), sh[i]);
    }
    ddg::store16(h_out + base + col, h);
  }
}

template <typename T>
int launch_gate_res(const void* y, const void* skip, const void* gate, const void* w,
                    const void* shift, const void* scale, void* x_out, void* h, int rows, int L,
                    int D, int cond_stride, cudaStream_t stream) {
  constexpr int N = ddg::Vec16<T>::N;
  if (D % N || cond_stride % N || L <= 0 || rows % L) return cudaErrorInvalidValue;
  const int nvec = D / N;
  const int block = nvec > 1024 ? 1024 : ((nvec + 31) / 32) * 32;
  if (nvec > block * kMaxVec) return cudaErrorInvalidValue;
  gate_res_kernel<T><<<rows, block, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(skip), static_cast<const T*>(gate),
      static_cast<const float*>(w), static_cast<const T*>(shift), static_cast<const T*>(scale),
      static_cast<T*>(x_out), static_cast<T*>(h), L, D, cond_stride);
  return cudaGetLastError();
}

// --- backward ---------------------------------------------------------------

constexpr int kBwdRows = 64;     // rows of a block
constexpr int kBwdWarps = 8;     // warps of a block (a whole number of teams)
constexpr int kCondGroup = 8;    // batch rows of a conditioning block
constexpr int kCondCols = 128;   // columns of a conditioning block

// The launch of the rows kernel for rows of nvec 16-byte vectors of N
// elements: a team of G warps a row, V vectors a lane, T teams a block; S
// floats a column-ordered slice of the team's vectors; the dynamic shared
// memory: w (1 + scale), gate (K6), the teams' P partial slices and their
// sums' exchange slots (G > 1).
struct BwdPlan {
  int G, V, T, threads, S, smem;
};

BwdPlan bwd_plan(int nvec, int N, bool residual) {
  BwdPlan p;
  p.G = (nvec + 32 * kLaneVec - 1) / (32 * kLaneVec);
  p.V = (nvec + 32 * p.G - 1) / (32 * p.G);
  p.T = kBwdWarps / p.G;
  p.threads = p.T * p.G * 32;
  p.S = p.V * N * p.G * 32;
  const int P = residual ? 3 : 2;
  p.smem = static_cast<int>(sizeof(float)) *
           (p.S * ((residual ? 2 : 1) + P * p.T) + (p.G > 1 ? p.T * 4 * p.G : 0));
  return p;
}

// Partial slices and the staged w (1 + scale) and gate are column-ordered
// by owner: float4 j = (k Q + q) TT + t holds elements 4 q .. 4 q + 3 of
// vector t + k TT (TT = 32 G, Q = N / 4), so that a warp's accesses are
// consecutive 16-byte words.
template <typename T, bool kResidual, int V>
__global__ void __launch_bounds__(kBwdWarps * 32, 2)
    adaln_bwd_rows_kernel(const T* __restrict__ xs, const T* __restrict__ y,
                          const T* __restrict__ gate, const float* __restrict__ w,
                          const T* __restrict__ scale, const T* __restrict__ dx_in,
                          const T* __restrict__ dh, T* __restrict__ dx_out, T* __restrict__ dy,
                          float* __restrict__ ws, int B, int L, int D, int cond_stride,
                          int tiles, int G) {
  constexpr int N = ddg::Vec16<T>::N, Q = N / 4, P = kResidual ? 3 : 2;
  extern __shared__ __align__(16) float bsm[];
  const int TT = 32 * G, Tm = blockDim.x / TT, S4 = V * Q * TT;
  float4* mulS = reinterpret_cast<float4*>(bsm);                 // S4 float4
  float4* gS = mulS + S4;                                        // S4, K6
  float4* part = gS + (kResidual ? S4 : 0);                      // Tm x P x S4
  float* xch = reinterpret_cast<float*>(part + Tm * P * S4);     // Tm x 2 x 2G, G > 1
  const int tid = threadIdx.x, team = tid / TT, t = tid % TT;
  const int lane = tid & 31, wt = t >> 5;
  const int nvec = D / N;
  const int b = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const size_t cond = static_cast<size_t>(b) * cond_stride;

  for (int j = tid; j < S4; j += blockDim.x) {
    const int tt = j % TT, kq = j / TT, vi = tt + (kq / Q) * TT;
    const int col = vi * N + 4 * (kq % Q);
    float4 m = make_float4(0.f, 0.f, 0.f, 0.f), g = m;
    if (vi < nvec) {
      const float4 wv = *reinterpret_cast<const float4*>(w + col);
      const T* sc = scale + cond + col;
      m = make_float4(wv.x * (1.f + ddg::to_f32(sc[0])), wv.y * (1.f + ddg::to_f32(sc[1])),
                      wv.z * (1.f + ddg::to_f32(sc[2])), wv.w * (1.f + ddg::to_f32(sc[3])));
      if (kResidual) {
        const T* gg = gate + cond + col;
        g = make_float4(ddg::to_f32(gg[0]), ddg::to_f32(gg[1]), ddg::to_f32(gg[2]),
                        ddg::to_f32(gg[3]));
      }
    }
    mulS[j] = m;
    if (kResidual) gS[j] = g;
  }
  for (int j = tid; j < Tm * P * S4; j += blockDim.x) part[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  float4* pt = part + team * P * S4;   // the team's slices: dh, dh xn (, dx_tot y)
  float* tx = xch + team * 4 * G;
  const int r_end = min((tile + 1) * kBwdRows, L);
  for (int r = tile * kBwdRows + team; r < r_end; r += Tm) {
    const size_t base = (static_cast<size_t>(b) * L + r) * D;
    uint4 rx[V], rd[V], rdx[V], ry[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int vi = t + k * TT;
      if (vi >= nvec) continue;
      const size_t at = base + static_cast<size_t>(vi) * N;
      rx[k] = ld_raw(xs + at);
      rd[k] = ld_raw(dh + at);
      if (kResidual) {
        rdx[k] = ld_raw(dx_in + at);
        ry[k] = ld_raw(y + at);
      }
    }
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (t + k * TT >= nvec) continue;
      float v[N];
      unpack<T>(rx[k], v);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        s1 += v[i];
        s2 = fmaf(v[i], v[i], s2);
      }
    }
    team_sum2(s1, s2, tx, G, wt, lane, team);
    const float m1 = s1 / D;
    const float rr = rsqrtf(fmaxf(s2 / D - m1 * m1, 0.f) + 1e-5f);
    float a = 0.f, c = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (t + k * TT >= nvec) continue;
      float v[N], d[N];
      unpack<T>(rx[k], v);
      unpack<T>(rd[k], d);
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int j = (k * Q + q) * TT + t;
        const float4 mul = mulS[j];
        float4 p0 = pt[j], p1 = pt[S4 + j];
        const float mv[4] = {mul.x, mul.y, mul.z, mul.w};
        float a0[4] = {p0.x, p0.y, p0.z, p0.w}, a1[4] = {p1.x, p1.y, p1.z, p1.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * q + e;
          const float xn = (v[i] - m1) * rr;
          a0[e] += d[i];
          a1[e] = fmaf(d[i], xn, a1[e]);
          const float dxn = d[i] * mv[e];
          a += dxn;
          c = fmaf(dxn, xn, c);
        }
        pt[j] = make_float4(a0[0], a0[1], a0[2], a0[3]);
        pt[S4 + j] = make_float4(a1[0], a1[1], a1[2], a1[3]);
      }
    }
    team_sum2(a, c, tx + 2 * G, G, wt, lane, team);
    const float md = a / D, mdx = c / D;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int vi = t + k * TT;
      if (vi >= nvec) continue;
      const size_t at = base + static_cast<size_t>(vi) * N;
      float v[N], d[N], o[N];
      unpack<T>(rx[k], v);
      unpack<T>(rd[k], d);
      float dxv[N], yv[N], dyv[N];
      if (kResidual) {
        unpack<T>(rdx[k], dxv);
        unpack<T>(ry[k], yv);
      }
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int j = (k * Q + q) * TT + t;
        const float4 mul = mulS[j];
        const float mv[4] = {mul.x, mul.y, mul.z, mul.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * q + e;
          const float xn = (v[i] - m1) * rr;
          o[i] = rr * (d[i] * mv[e] - md - xn * mdx);
        }
        if (kResidual) {
          const float4 g = gS[j];
          const float gv[4] = {g.x, g.y, g.z, g.w};
          const float4 p2 = pt[2 * S4 + j];
          float a2[4] = {p2.x, p2.y, p2.z, p2.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * q + e;
            o[i] += dxv[i];
            a2[e] = fmaf(o[i], yv[i], a2[e]);
            dyv[i] = o[i] * gv[e];
          }
          pt[2 * S4 + j] = make_float4(a2[0], a2[1], a2[2], a2[3]);
        }
      }
      if (kResidual) ddg::store16(dy + at, dyv);
      ddg::store16(dx_out + at, o);
    }
  }
  __syncthreads();
  // The block's partials: its teams' slices added in team order.
  const size_t tile_at = static_cast<size_t>(b) * tiles + tile;
  for (int j = tid; j < P * S4; j += blockDim.x) {
    const int jj = j % S4, p = j / S4;
    const int tt = jj % TT, kq = jj / TT, vi = tt + (kq / Q) * TT;
    if (vi >= nvec) continue;
    float4 s = part[p * S4 + jj];
    for (int tm = 1; tm < Tm; ++tm) {
      const float4 u = part[(tm * P + p) * S4 + jj];
      s.x += u.x, s.y += u.y, s.z += u.z, s.w += u.w;
    }
    const size_t col = static_cast<size_t>(vi) * N + 4 * (kq % Q);
    *reinterpret_cast<float4*>(ws + (static_cast<size_t>(p) * B * tiles + tile_at) * D + col) =
        s;
  }
}

// Stage 2: block (x, y) takes columns x kCondCols .. and batch rows y
// kCondGroup ..: per b, its tiles in order into dshift, dscale (and dgate);
// the group's sum over b in order of (1 + scale[b]) S_b into dwp[y]. The
// group's loads of a tile go out together (the b loop unrolled), so the
// walk waits on memory once a tile, not once a batch row.
template <typename T, bool kResidual>
__global__ void __launch_bounds__(kCondCols)
    adaln_bwd_cond_kernel(const float* __restrict__ ws, const float* __restrict__ w,
                          const T* __restrict__ scale, int cond_stride, T* __restrict__ dshift,
                          T* __restrict__ dscale, T* __restrict__ dgate, float* __restrict__ dwp,
                          int B, int tiles, int D) {
  const int d = blockIdx.x * kCondCols + threadIdx.x;
  if (d >= D) return;
  const size_t part = static_cast<size_t>(B) * tiles * D;
  const int b0 = blockIdx.y * kCondGroup, nb = min(kCondGroup, B - b0);
  float sh[kCondGroup], sc[kCondGroup], sg[kCondGroup], sv[kCondGroup];
#pragma unroll
  for (int j = 0; j < kCondGroup; ++j) {
    sh[j] = sc[j] = sg[j] = 0.f;
    sv[j] = j < nb ? ddg::to_f32(scale[static_cast<size_t>(b0 + j) * cond_stride + d]) : 0.f;
  }
  for (int t = 0; t < tiles; ++t) {
#pragma unroll
    for (int j = 0; j < kCondGroup; ++j) {
      if (j >= nb) break;
      const size_t at = (static_cast<size_t>(b0 + j) * tiles + t) * D + d;
      sh[j] += ws[at];
      sc[j] += ws[part + at];
      if (kResidual) sg[j] += ws[2 * part + at];
    }
  }
  const float wd = w[d];
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < kCondGroup; ++j) {
    if (j >= nb) break;
    const size_t o = static_cast<size_t>(b0 + j) * D + d;
    dshift[o] = ddg::from_f32<T>(sh[j]);
    dscale[o] = ddg::from_f32<T>(sc[j] * wd);
    if (kResidual) dgate[o] = ddg::from_f32<T>(sg[j]);
    acc = fmaf(sc[j], 1.f + sv[j], acc);
  }
  dwp[static_cast<size_t>(blockIdx.y) * D + d] = acc;
}

// Stage 3: dw, the groups' partials in order.
__global__ void __launch_bounds__(kCondCols)
    adaln_bwd_dw_kernel(const float* __restrict__ dwp, float* __restrict__ dw, int groups,
                        int D) {
  const int d = blockIdx.x * kCondCols + threadIdx.x;
  if (d >= D) return;
  float acc = dwp[d];
  for (int g = 1; g < groups; ++g) acc += dwp[static_cast<size_t>(g) * D + d];
  dw[d] = acc;
}

template <typename T, bool kResidual, int V>
cudaError_t launch_rows(const BwdPlan& p, const void* xs, const void* y, const void* gate,
                        const void* w, const void* scale, const void* dx_in, const void* dh,
                        void* dx_out, void* dy, float* ws, int B, int L, int D,
                        int cond_stride, int tiles, cudaStream_t stream) {
  auto kern = adaln_bwd_rows_kernel<T, kResidual, V>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  kern<<<B * tiles, p.threads, p.smem, stream>>>(
      static_cast<const T*>(xs), static_cast<const T*>(y), static_cast<const T*>(gate),
      static_cast<const float*>(w), static_cast<const T*>(scale), static_cast<const T*>(dx_in),
      static_cast<const T*>(dh), static_cast<T*>(dx_out), static_cast<T*>(dy), ws, B, L, D,
      cond_stride, tiles, p.G);
  return cudaGetLastError();
}

template <typename T, bool kResidual>
int launch_bwd(const void* xs, const void* y, const void* gate, const void* w, const void* scale,
               const void* dx_in, const void* dh, void* dx_out, void* dy, void* dgate, void* dw,
               void* dshift, void* dscale, void* ws, int B, int L, int D, int cond_stride,
               int tiles, int groups, cudaStream_t stream) {
  constexpr int N = ddg::Vec16<T>::N;
  if (D % N || cond_stride % N || B <= 0 || L <= 0 || tiles != (L + kBwdRows - 1) / kBwdRows ||
      groups != (B + kCondGroup - 1) / kCondGroup)
    return cudaErrorInvalidValue;
  const int nvec = D / N;
  if (nvec > kBwdWarps * 32 * kLaneVec) return cudaErrorInvalidValue;
  const BwdPlan p = bwd_plan(nvec, N, kResidual);
  float* wsf = static_cast<float*>(ws);
  cudaError_t err;
  switch (p.V) {
#define DDG_ROWS(V_)                                                                          \
  case V_:                                                                                    \
    err = launch_rows<T, kResidual, V_>(p, xs, y, gate, w, scale, dx_in, dh, dx_out, dy, wsf, \
                                        B, L, D, cond_stride, tiles, stream);                 \
    break;
    DDG_ROWS(1)
    DDG_ROWS(2)
    DDG_ROWS(3)
    DDG_ROWS(4)
#undef DDG_ROWS
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  float* dwp = wsf + static_cast<size_t>(kResidual ? 3 : 2) * B * tiles * D;
  const int cols = (D + kCondCols - 1) / kCondCols;
  adaln_bwd_cond_kernel<T, kResidual><<<dim3(cols, groups), kCondCols, 0, stream>>>(
      wsf, static_cast<const float*>(w), static_cast<const T*>(scale), cond_stride,
      static_cast<T*>(dshift), static_cast<T*>(dscale), static_cast<T*>(dgate), dwp, B, tiles,
      D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  adaln_bwd_dw_kernel<<<cols, kCondCols, 0, stream>>>(dwp, static_cast<float*>(dw), groups, D);
  return cudaGetLastError();
}

}  // namespace

// The backward's launch plan for the wrappers' mirror (`ops.adaln.
// bwd_plan`): rows a block, tiles, conditioning groups, warps a row,
// vectors a lane, teams a block, threads, dynamic shared memory bytes, and
// the workspace's floats over D. Returns 0, or 1 for a shape it refuses.
extern "C" int ddg_adaln_bwd_plan(int B, int L, int D, int dtype, int residual, int* out) {
  const int N = dtype == ddg::kF32 ? 4 : 8;
  if (B <= 0 || L <= 0 || D <= 0 || D % N || D / N > kBwdWarps * 32 * kLaneVec) return 1;
  const BwdPlan p = bwd_plan(D / N, N, residual != 0);
  const int tiles = (L + kBwdRows - 1) / kBwdRows, groups = (B + kCondGroup - 1) / kCondGroup;
  const int vals[9] = {kBwdRows, tiles, groups, p.G, p.V, p.T, p.threads, p.smem,
                       (residual ? 3 : 2) * B * tiles + groups};
  for (int i = 0; i < 9; ++i) out[i] = vals[i];
  return 0;
}

extern "C" int ddg_ln_modulate_bwd(const void* x, const void* w, const void* scale,
                                   const void* dh, void* dx, void* dw, void* dshift,
                                   void* dscale, void* ws, int B, int L, int D, int cond_stride,
                                   int tiles, int groups, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ddg::kF32)
    return launch_bwd<float, false>(x, nullptr, nullptr, w, scale, nullptr, dh, dx, nullptr,
                                    nullptr, dw, dshift, dscale, ws, B, L, D, cond_stride, tiles,
                                    groups, s);
  if (dtype == ddg::kBF16)
    return launch_bwd<__nv_bfloat16, false>(x, nullptr, nullptr, w, scale, nullptr, dh, dx,
                                            nullptr, nullptr, dw, dshift, dscale, ws, B, L, D,
                                            cond_stride, tiles, groups, s);
  return cudaErrorInvalidValue;
}

extern "C" int ddg_gate_res_ln_modulate_bwd(const void* x_new, const void* y, const void* gate,
                                            const void* w, const void* scale, const void* dx,
                                            const void* dh, void* dy, void* dskip, void* dgate,
                                            void* dw, void* dshift, void* dscale, void* ws, int B,
                                            int L, int D, int cond_stride, int tiles, int groups,
                                            int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ddg::kF32)
    return launch_bwd<float, true>(x_new, y, gate, w, scale, dx, dh, dskip, dy, dgate, dw,
                                   dshift, dscale, ws, B, L, D, cond_stride, tiles, groups, s);
  if (dtype == ddg::kBF16)
    return launch_bwd<__nv_bfloat16, true>(x_new, y, gate, w, scale, dx, dh, dskip, dy, dgate,
                                           dw, dshift, dscale, ws, B, L, D, cond_stride, tiles,
                                           groups, s);
  return cudaErrorInvalidValue;
}

// K3's launch plan for the wrapper's mirror (`ops.adaln.fwd_plan`): rows a
// block, tiles of a batch row, blocks, warps a row, vectors a lane, teams a
// block, threads, and whether the modulation is held in registers. Returns
// 0, or 1 for a shape it refuses.
extern "C" int ddg_adaln_fwd_plan(int B, int L, int D, int dtype, int* out) {
  const int N = dtype == ddg::kF32 ? 4 : 8;
  if (B <= 0 || L <= 0 || D <= 0 || D % N || D / N > kMaxRowVec) return 1;
  const FwdPlan p = fwd_plan(B, L, D / N);
  const int vals[8] = {p.R, p.tiles, B * p.tiles, p.G, p.V, p.T, p.threads, p.hold};
  for (int i = 0; i < 8; ++i) out[i] = vals[i];
  return 0;
}

extern "C" int ddg_ln_modulate(const void* x, const void* w, const void* shift,
                               const void* scale, void* h, int rows, int L, int D,
                               int cond_stride, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ddg::kF32)
    return launch_fwd<float>(x, w, shift, scale, h, rows, L, D, cond_stride, s);
  if (dtype == ddg::kBF16)
    return launch_fwd<__nv_bfloat16>(x, w, shift, scale, h, rows, L, D, cond_stride, s);
  return cudaErrorInvalidValue;
}

extern "C" int ddg_gate_res_ln_modulate(const void* y, const void* skip, const void* gate,
                                        const void* w, const void* shift, const void* scale,
                                        void* x_out, void* h, int rows, int L, int D,
                                        int cond_stride, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ddg::kF32)
    return launch_gate_res<float>(y, skip, gate, w, shift, scale, x_out, h, rows, L, D,
                                  cond_stride, s);
  if (dtype == ddg::kBF16)
    return launch_gate_res<__nv_bfloat16>(y, skip, gate, w, shift, scale, x_out, h, rows, L, D,
                                          cond_stride, s);
  return cudaErrorInvalidValue;
}
