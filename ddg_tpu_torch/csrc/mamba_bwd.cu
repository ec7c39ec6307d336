// The DiMamba backward kernels: the adjoint of the gated selective scan
// and of the fused Mamba block (one direction).
//
// Replaces the TPU kernels
//   ddg_tpu/ops/selective_scan_pallas.py: ssm_scan -> _bwd_call (pallas_call :653,
//     body _bwd_kernel :488), K15
//   ddg_tpu/ops/mamba_block_pallas.py: mamba_inner_pallas -> _mk_bwd_call (:553,
//     body _mk_bwd_kernel :370), K19
// with their rounding points; ddg_tpu_torch/ops/mamba.py holds the plain
// versions (`ssm_scan_bwd_plain`, `mamba_inner_bwd_plain`).
//
// The scan's adjoint (one routine for both). The TPU grid runs the chunks
// right to left and carries the adjoint in VMEM; here three launches make
// the chunks independent blocks, as the forward's three do:
//   1. every chunk from a zero adjoint at its end: the carry it hands left
//      (a_t0 dh_t0) and the product P of its a_t;
//   2. per (b, state, channel), the chunks right to left: the true carry
//      into each chunk, chi[c] = P[c + 1] chi[c + 1] + left[c + 1];
//   3. every chunk again with its carry. A thread cannot hold a chunk's
//      states, so it walks the chunk forward from its entry state (h0s,
//      saved by the forward) keeping the state every kSeg = 16 rows in
//      shared memory, then takes the segments right to left: it recomputes
//      a segment's 16 states into registers and walks them back with the
//      adjoint. The recurrence is never inverted (a_t underflows).
// Four threads share a channel, four states each, so a segment's states
// fit in registers; sums over the states are quad shuffles. A segment's
// rows are staged in shared memory by coalesced loads. dB and dC sum over
// channels: a recursive-halving warp shuffle, then the block's 8 warps in
// order, then the channel tiles in order (`reduce_slices`). dA and dD sum
// per (b, chunk) and then over those in order. No atomics: reruns are
// bit-identical.
//
// ddg_mamba_inner_bwd (K19), for compute type T, per direction:
//   xz, u, x_dbl, delta   the front, recomputed from h by the forward's own
//                         in_proj GEMM and front kernel (through device memory)
//   dy    = g W_out                          (gemm, fp32 out)
//   scan adjoint with gy = dy silu(z): ddelta, du, dB, dC, dz (-> dxz, T),
//         y_g = (C.h + D u) silu(z) in T, dA, dD
//   dpre  = ddelta sigmoid(pre), ddt_lr = dpre W_dt^T, dW_dt, db_dt  (fp32 FMAs)
//   dx_dbl = [ddt_lr | dB | dC] rounded to T
//   du   += dx_dbl W_x^T                     (gemm, accumulated in fp32)
//   dxc   = du silu'(xc); dx = conv adjoint (a halo of K - 1 rows read
//           from the next tile), rounded to T -> dxz; dconv_w, dconv_b
//   dh    = dxz W_in^T                       (gemm, T out)
//   dW_in = h^T dxz, dW_x = u^T dx_dbl, dW_out = y_g^T g   (wgrad)
// bf16 products are mma.sync m16n8k16 with fp32 sums; weight gradients sum
// per 4096-row slice, then over the slices in order.
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
constexpr int kWRows = 4096;                 // rows of one weight-gradient slice

// A's quarter q of channel ch, round-tripped as -exp(log(-A)): plain (av)
// and times log2 e (a2); 0 past N.
__device__ __forceinline__ void load_a4(const float* __restrict__ A, int ch, int N, int q,
                                        float (&a2)[kQ], float (&av)[kQ]) {
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const int n = q * kQ + i;
    av[i] = n < N ? -expf(logf(-A[ch * N + n])) : 0.f;
    a2[i] = av[i] * kLog2e;
  }
}

__device__ __forceinline__ void load_q(const float* p, float (&v)[kQ]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
}

// A segment's per-channel row values staged in shared memory as fp32,
// [value][row][channel of the block]: delta, u (when given) and, from z and
// g (when given), the gate's terms gy = g silu(z), g silu'(z) and silu(z).
// One coalesced load for kSeg rows, in place of a dependent load per row,
// which left the few warps an SM holds waiting on memory; the gate is
// taken once per (row, channel), not by each of its four threads.
constexpr int kStage = kSeg * kBwdCh;
constexpr int kStaged = 5;

template <typename T, typename G>
__device__ void stage_seg(float* st, int r0, int rows, size_t row0, int ch0, int d,
                          const float* __restrict__ delta, const T* __restrict__ u, int ld_u,
                          const T* __restrict__ z, int ld_z, const G* __restrict__ g, int ld_g) {
  for (int i = threadIdx.x; i < kStage; i += kBwdThreads) {
    const int j = i / kBwdCh, c = i % kBwdCh, r = r0 + j, ch = ch0 + c;
    const bool in = r < rows && ch < d;
    const size_t row = row0 + r;
    st[i] = in ? delta[row * d + ch] : 0.f;
    if (u != nullptr) st[kStage + i] = in ? to_f32(u[row * ld_u + ch]) : 0.f;
    if (z != nullptr) {
      const float zz = in ? to_f32(z[row * ld_z + ch]) : 0.f;
      const float gg = in ? to_f32(g[row * ld_g + ch]) : 0.f;
      const float sig = sigmoid(zz), sg = zz * sig;
      st[2 * kStage + i] = gg * sg;
      st[3 * kStage + i] = gg * (sig + sg * (1.f - sig));
      st[4 * kStage + i] = sg;
    }
  }
}

// Pass 1: each (b, chunk, channel quarter) from a zero adjoint at the
// chunk's end. P and E (the carry handed left) are (Bt, n_chunks, N, d).
template <typename T, typename G>
__global__ void __launch_bounds__(kBwdThreads)
    scan_bwd_chunk_kernel(const float* __restrict__ delta, const T* __restrict__ Cc, int ld_bc,
                          const T* __restrict__ z, int ld_z, const G* __restrict__ g, int ld_g,
                          const float* __restrict__ A, float* __restrict__ P,
                          float* __restrict__ E, int L, int d, int N, int chunk) {
  extern __shared__ __align__(16) float sm1[];
  float* Cs = sm1;                            // chunk x kMaxN
  float* st = Cs + chunk * kMaxN;             // kStaged x kStage
  const int b = blockIdx.z, c = blockIdx.y, nc = gridDim.y;
  const int q = threadIdx.x & 3, chl = threadIdx.x >> 2;
  const int ch0 = blockIdx.x * kBwdCh, ch = ch0 + chl;
  const bool live = ch < d;
  const int t0 = c * chunk, rows = min(chunk, L - t0);
  const size_t row0 = static_cast<size_t>(b) * L + t0;
  stage_rows(Cc, ld_bc, row0, rows, N, Cs);
  float a2[kQ], av[kQ], dh[kQ], p[kQ], aup[kQ], cv[kQ];
  load_a4(A, live ? ch : 0, N, q, a2, av);
#pragma unroll
  for (int i = 0; i < kQ; ++i) dh[i] = 0.f, p[i] = 1.f, aup[i] = 1.f;
  for (int s = (rows - 1) / kSeg; s >= 0; --s) {
    __syncthreads();
    stage_seg<T, G>(st, s * kSeg, rows, row0, ch0, d, delta, nullptr, 0, z, ld_z, g, ld_g);
    __syncthreads();
    for (int j = min(kSeg, rows - s * kSeg) - 1; j >= 0; --j) {
      const int r = s * kSeg + j, k = j * kBwdCh + chl;
      const float dt = st[k], gy = st[2 * kStage + k];
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
  if (!live) return;
  const size_t o = (static_cast<size_t>(b) * nc + c) * N * d + ch;
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const int n = q * kQ + i;
    if (n >= N) continue;
    P[o + static_cast<size_t>(n) * d] = p[i];
    E[o + static_cast<size_t>(n) * d] = aup[i] * dh[i];
  }
}

// Pass 2: per (b, state, channel), right to left; E becomes the carry into
// each chunk (0 into the last).
__global__ void __launch_bounds__(256)
    scan_bwd_carry_kernel(const float* __restrict__ P, float* __restrict__ E, int nc, int Nd) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= Nd) return;
  const size_t base = static_cast<size_t>(blockIdx.y) * nc * Nd + i;
  float chi = 0.f;
#pragma unroll 8
  for (int c = nc - 1; c >= 0; --c) {
    const size_t o = base + static_cast<size_t>(c) * Nd;
    const float e = E[o], p = P[o];
    E[o] = chi;
    chi = fmaf(p, chi, e);
  }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
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

// Pass 3: each (b, chunk, channel tile) with its true carry. Per row:
// ddelta, du (fp32), dz (ZT, row stride ld_dz) and, when yg is given, the
// gated output (C.h + D u) silu(z) in T; the block's partial sums of dB and
// dC over its channels (dBp, dCp: (tiles, Bt L, N)); per (b, chunk) the
// partial dA (N, d) and dD (d).
template <typename T, typename G, typename ZT>
__global__ void __launch_bounds__(kBwdThreads, 2)
    scan_bwd_out_kernel(const T* __restrict__ u, int ld_u, const float* __restrict__ delta,
                        const T* __restrict__ Bc, const T* __restrict__ Cc, int ld_bc,
                        const T* __restrict__ z, int ld_z, const G* __restrict__ g, int ld_g,
                        const float* __restrict__ A, const float* __restrict__ D,
                        const float* __restrict__ h0s, const float* __restrict__ carry,
                        float* __restrict__ ddt, float* __restrict__ du, ZT* __restrict__ dz,
                        int ld_dz, T* __restrict__ yg, float* __restrict__ dBp,
                        float* __restrict__ dCp, float* __restrict__ dAp,
                        float* __restrict__ dDp, int Bt, int L, int d, int N, int chunk) {
  extern __shared__ __align__(16) float sm[];
  const int n_seg = (chunk + kSeg - 1) / kSeg;
  float* Bs = sm;
  float* Cs = Bs + chunk * kMaxN;
  float4* ck = reinterpret_cast<float4*>(Cs + chunk * kMaxN);      // [n_seg][threads]
  float* part = reinterpret_cast<float*>(ck + n_seg * kBwdThreads);  // [kSeg][warps][32]
  float* st = part + kSeg * kBwdWarps * 32;                     // kStaged x kStage
  const int b = blockIdx.z, c = blockIdx.y, nc = gridDim.y;
  const int tid = threadIdx.x, q = tid & 3, lane = tid & 31, warp = tid >> 5;
  const int chl = tid >> 2, ch0 = blockIdx.x * kBwdCh, ch = ch0 + chl;
  const bool live = ch < d;
  const int cl = live ? ch : 0;  // threads past d compute on zeros and write nothing
  const int t0 = c * chunk, rows = min(chunk, L - t0);
  const size_t row0 = static_cast<size_t>(b) * L + t0;
  stage_rows(Bc, ld_bc, row0, rows, N, Bs);
  stage_rows(Cc, ld_bc, row0, rows, N, Cs);
  __syncthreads();

  float a2[kQ], av[kQ], h[kQ];
  load_a4(A, cl, N, q, a2, av);
  const size_t o = (static_cast<size_t>(b) * nc + c) * N * d + cl;
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const int n = q * kQ + i;
    h[i] = n < N ? h0s[o + static_cast<size_t>(n) * d] : 0.f;
  }
  // Row r of the staged segment j: the state after it from the one before.
  auto step = [&](int r, int j, const float (&hp)[kQ], float (&hn)[kQ]) {
    const float dt = st[j * kBwdCh + chl];
    const float dtu = dt * st[kStage + j * kBwdCh + chl];
    float bv[kQ];
    load_q(Bs + r * kMaxN + q * kQ, bv);
#pragma unroll
    for (int i = 0; i < kQ; ++i) hn[i] = fmaf(ex2(dt * a2[i]), hp[i], dtu * bv[i]);
  };
  const int segs = (rows + kSeg - 1) / kSeg;
  for (int s = 0; s < segs; ++s) {
    ck[s * kBwdThreads + tid] = make_float4(h[0], h[1], h[2], h[3]);
    if (s + 1 == segs) break;
    __syncthreads();
    stage_seg<T, G>(st, s * kSeg, rows, row0, ch0, d, delta, u, ld_u, nullptr, 0, nullptr, 0);
    __syncthreads();
    for (int j = 0; j < kSeg; ++j) step(s * kSeg + j, j, h, h);
  }

  float dh[kQ], aup[kQ], dA[kQ];
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const int n = q * kQ + i;
    dh[i] = n < N ? carry[o + static_cast<size_t>(n) * d] : 0.f;
    aup[i] = 1.f;
    dA[i] = 0.f;
  }
  const float Dv = D[cl];
  float dD = 0.f;
  for (int s = segs - 1; s >= 0; --s) {
    __syncthreads();
    stage_seg<T, G>(st, s * kSeg, rows, row0, ch0, d, delta, u, ld_u, z, ld_z, g, ld_g);
    __syncthreads();
    float hs[kSeg + 1][kQ];
    const float4 c4 = ck[s * kBwdThreads + tid];
    hs[0][0] = c4.x, hs[0][1] = c4.y, hs[0][2] = c4.z, hs[0][3] = c4.w;
#pragma unroll
    for (int j = 0; j < kSeg; ++j) {
      if (s * kSeg + j < rows) {
        step(s * kSeg + j, j, hs[j], hs[j + 1]);
      } else {
#pragma unroll
        for (int i = 0; i < kQ; ++i) hs[j + 1][i] = 0.f;
      }
    }
#pragma unroll
    for (int j = kSeg - 1; j >= 0; --j) {
      const int r = s * kSeg + j;
      if (r >= rows) continue;  // uniform over the block
      const size_t row = row0 + r;
      const int k = j * kBwdCh + chl;
      const float dt = st[k], uu = st[kStage + k], gy = st[2 * kStage + k];
      const float dzf = st[3 * kStage + k], sg = st[4 * kStage + k], dtu = dt * uu;
      float bv[kQ], cv[kQ], pv[8];  // dB then dC partials of the 4 states
      load_q(Bs + r * kMaxN + q * kQ, bv);
      load_q(Cs + r * kMaxN + q * kQ, cv);
      float sdd = 0.f, sb = 0.f, sy = 0.f;
#pragma unroll
      for (int i = 0; i < kQ; ++i) {
        const float a = ex2(dt * a2[i]);
        dh[i] = fmaf(aup[i], dh[i], cv[i] * gy);
        aup[i] = a;
        const float daa = dh[i] * hs[j][i] * a;
        sdd = fmaf(daa, av[i], sdd);
        sb = fmaf(dh[i], bv[i], sb);
        sy = fmaf(hs[j + 1][i], cv[i], sy);
        dA[i] = fmaf(daa, dt, dA[i]);
        pv[i] = live ? dh[i] * dtu : 0.f;
        pv[kQ + i] = live ? hs[j + 1][i] * gy : 0.f;
      }
      sdd = quad_sum(sdd);
      sb = quad_sum(sb);
      sy = quad_sum(sy);
      {
        const float v = channel_sums8(pv, lane);
        const int idx = (lane >> 2) & 7;  // which of the 8 this lane holds
        part[(j * kBwdWarps + warp) * 32 + (idx >> 2) * 16 + q * kQ + (idx & 3)] = v;
      }
      if (!live) continue;
      const float ypre = sy + Dv * uu;
      if (q == 0) {
        ddt[row * d + ch] = sdd + sb * uu;
        dD = fmaf(gy, uu, dD);
      } else if (q == 1) {
        du[row * d + ch] = sb * dt + gy * Dv;
      } else if (q == 2) {
        dz[row * ld_dz + ch] = from_f32<ZT>(ypre * dzf);
      } else if (yg != nullptr) {
        yg[row * d + ch] = from_f32<T>(ypre * sg);
      }
    }
    __syncthreads();
    for (int k = tid; k < kSeg * 32; k += kBwdThreads) {
      const int j = k >> 5, v = k & 31, n = v & 15, r = s * kSeg + j;
      if (r >= rows || n >= N) continue;
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < kBwdWarps; ++w) acc += part[(j * kBwdWarps + w) * 32 + v];
      float* dst = v < 16 ? dBp : dCp;
      dst[(static_cast<size_t>(blockIdx.x) * Bt * L + row0 + r) * N + n] = acc;
    }
    __syncthreads();
  }
  if (!live) return;
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const int n = q * kQ + i;
    if (n < N) dAp[o + static_cast<size_t>(n) * d] = dA[i];
  }
  if (q == 0) dDp[(static_cast<size_t>(b) * nc + c) * d + ch] = dD;
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

// 8 values of row m, columns c..c+7, of X (zeros past P or past the slice).
__device__ __forceinline__ void load8(const bf16* __restrict__ X, int ldx, int m, int me, int c,
                                      int P, bool vec, bf16 (&v)[8]) {
  const bf16 zero = __float2bfloat16_rn(0.f);
  if (m < me && vec && c + 8 <= P) {
    const uint4 x = *reinterpret_cast<const uint4*>(X + static_cast<size_t>(m) * ldx + c);
    const bf16* e = reinterpret_cast<const bf16*>(&x);
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = e[k];
    return;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k)
    v[k] = m < me && c + k < P ? X[static_cast<size_t>(m) * ldx + c + k] : zero;
}

// bf16: the block's 128 x 128 tile of (p, q), the products as the GEMM's
// (mma.sync), the operands staged transposed ([p][m], [q][m]).
__global__ void __launch_bounds__(kGemmThreads)
    wgrad_bf16_kernel(const bf16* __restrict__ X, int ldx, const bf16* __restrict__ Y, int ldy,
                      float* __restrict__ part, int M, int P, int Q, int vx, int vy) {
  __shared__ __align__(16) bf16 Xs[kBM * kGRow];
  __shared__ __align__(16) bf16 Ys[kBN * kGRow];
  const int p0 = blockIdx.y * kBM, q0 = blockIdx.x * kBN, slice = blockIdx.z;
  const int mb = slice * kWRows, me = min(M, mb + kWRows);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 64;
  const int g = lane >> 2, t = lane & 3;
  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  // Each thread moves two 8-value pieces of X and of Y a k-step; the next
  // step's are loaded into registers while this one's products run.
  constexpr int kItems = kBK * (kBM / 8) / kGemmThreads;
  bf16 px[kItems][8], py[kItems][8];
  // A warp takes 32 rows of one 8-column piece: its transposed stores then
  // fall in distinct banks (a warp along the columns hits one bank 16 times).
  auto piece = [](int i, int& mm, int& cc) { mm = i % kBK, cc = (i / kBK) * 8; };
  auto fetch = [&](int m0) {
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int i = threadIdx.x + it * kGemmThreads;
      int mm, cc;
      piece(i, mm, cc);
      load8(X, ldx, m0 + mm, me, p0 + cc, P, vx, px[it]);
      load8(Y, ldy, m0 + mm, me, q0 + cc, Q, vy, py[it]);
    }
  };
  if (mb < me) fetch(mb);
  for (int m0 = mb; m0 < me; m0 += kBK) {
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int i = threadIdx.x + it * kGemmThreads;
      int mm, cc;
      piece(i, mm, cc);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        Xs[(cc + k) * kGRow + mm] = px[it][k];
        Ys[(cc + k) * kGRow + mm] = py[it][k];
      }
    }
    __syncthreads();
    if (m0 + kBK < me) fetch(m0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const bf16* p = Xs + (wm + i * 16 + g) * kGRow + kk * 16 + 2 * t;
        a[i][0] = ld32(p);
        a[i][1] = ld32(p + 8 * kGRow);
        a[i][2] = ld32(p + 8);
        a[i][3] = ld32(p + 8 * kGRow + 8);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bf16* qp = Ys + (wn + j * 8 + g) * kGRow + kk * 16 + 2 * t;
        const uint32_t b0 = ld32(qp), b1 = ld32(qp + 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_16816(acc[i][j], a[i][0], a[i][1], a[i][2], a[i][3], b0, b1);
      }
    }
    __syncthreads();
  }
  float* out = part + static_cast<size_t>(slice) * P * Q;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + wm + i * 16 + g + 8 * (e >> 1), qq = q0 + wn + j * 8 + 2 * t + (e & 1);
        if (p < P && qq < Q) out[static_cast<size_t>(p) * Q + qq] = acc[i][j][e];
      }
}

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
    const int vx = ldx % 8 == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0;
    const int vy = ldy % 8 == 0 && reinterpret_cast<uintptr_t>(Y) % 16 == 0;
    wgrad_bf16_kernel<<<dim3((Q + kBN - 1) / kBN, (P + kBM - 1) / kBM, ns), kGemmThreads, 0, s>>>(
        reinterpret_cast<const bf16*>(X), ldx, reinterpret_cast<const bf16*>(Y), ldy, part, M, P,
        Q, vx, vy);
  } else {
    wgrad_f32_kernel<<<dim3((Q + 63) / 64, (P + 63) / 64, ns), 256, 0, s>>>(
        reinterpret_cast<const float*>(X), ldx, reinterpret_cast<const float*>(Y), ldy, part, M,
        P, Q);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_slices(part, out, ns, static_cast<size_t>(P) * Q, tmp, s);
}

// --- dt_proj's adjoint and x_proj's input gradient ---------------------------

constexpr int kDtRows = 16;    // rows staged at once
constexpr int kDtTile = 256;   // rows of one block's partial sums

// One block per kDtTile rows. pre is recomputed exactly as the front
// forms it; dpre = ddelta sigmoid(pre); dW_dt and db_dt sum over the
// block's rows (partials (tiles, R, d) and (tiles, d)); ddt_lr = dpre
// W_dt^T in fp32 FMAs, a warp to a row.
// dx_dbl (row stride nxp) = [ddt_lr | dB | dC | 0] rounded to T, dB and dC
// summed over the scan's channel tiles in order.
template <typename T>
__global__ void __launch_bounds__(kFrontThreads)
    dtproj_bwd_kernel(const float* __restrict__ ddt, const T* __restrict__ xdbl, int nx,
                      const float* __restrict__ wdt, const float* __restrict__ bdt,
                      const float* __restrict__ dBp, const float* __restrict__ dCp, int n_tiles,
                      T* __restrict__ dxdbl, int nxp, float* __restrict__ dwdt_p,
                      float* __restrict__ dbdt_p, int M, int d, int R, int N) {
  extern __shared__ __align__(16) float smf[];
  const int lr_ld = (R + 3) / 4 * 4, dp_ld = d + 1;
  float* lr = smf;                           // kDtRows x lr_ld
  float* dp = lr + kDtRows * lr_ld;          // kDtRows x dp_ld
  float* wacc = dp + kDtRows * dp_ld;        // R x d
  float* bacc = wacc + R * d;                // d
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t m_begin = static_cast<size_t>(blockIdx.x) * kDtTile;
  const int tile_rows = static_cast<int>(min(static_cast<size_t>(kDtTile), M - m_begin));
  for (int i = threadIdx.x; i < (R + 1) * d; i += kFrontThreads) wacc[i] = 0.f;
  for (int r0 = 0; r0 < tile_rows; r0 += kDtRows) {
    const int rows = min(kDtRows, tile_rows - r0);
    const size_t m0 = m_begin + r0;
    for (int i = threadIdx.x; i < kDtRows * lr_ld; i += kFrontThreads) {
      const int r = i / lr_ld, k = i % lr_ld;
      lr[i] = r < rows && k < R ? to_f32(xdbl[(m0 + r) * nx + k]) : 0.f;
    }
    __syncthreads();
    for (int ch = threadIdx.x; ch < d; ch += kFrontThreads) {
      float wr[kMaxR], gw[kMaxR], dd[kDtRows];
#pragma unroll
      for (int k = 0; k < kMaxR; ++k) wr[k] = k < R ? wdt[ch * R + k] : 0.f, gw[k] = 0.f;
#pragma unroll
      for (int r = 0; r < kDtRows; ++r) dd[r] = r < rows ? ddt[(m0 + r) * d + ch] : 0.f;
      const float bias = bdt[ch];
      float gb = 0.f;
#pragma unroll
      for (int r = 0; r < kDtRows; ++r) {
        const float* lrr = lr + r * lr_ld;
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < kMaxR; k += 4) {
          if (k >= R) break;
          const float4 v = *reinterpret_cast<const float4*>(lrr + k);
          acc = fmaf(v.x, wr[k], acc);
          acc = fmaf(v.y, wr[k + 1], acc);
          acc = fmaf(v.z, wr[k + 2], acc);
          acc = fmaf(v.w, wr[k + 3], acc);
        }
        // Rows past the tile have ddelta 0, so dpre 0.
        const float dpv = dd[r] * sigmoid(acc + bias);
        dp[r * dp_ld + ch] = dpv;
        gb += dpv;
#pragma unroll
        for (int k = 0; k < kMaxR; k += 4) {
          if (k >= R) break;
          const float4 v = *reinterpret_cast<const float4*>(lrr + k);
          gw[k] = fmaf(v.x, dpv, gw[k]);
          gw[k + 1] = fmaf(v.y, dpv, gw[k + 1]);
          gw[k + 2] = fmaf(v.z, dpv, gw[k + 2]);
          gw[k + 3] = fmaf(v.w, dpv, gw[k + 3]);
        }
      }
#pragma unroll
      for (int k = 0; k < kMaxR; ++k)
        if (k < R) wacc[k * d + ch] += gw[k];
      bacc[ch] += gb;
    }
    __syncthreads();
    // ddt_lr: a warp to a row. Lane l sums column l mod R over the channel
    // quads of its part l / R (32 / R parts when R divides 32): its loads
    // of W_dt (d, R) are R consecutive floats across the lanes, dpre a
    // broadcast. Four running sums (ch mod 4), then the parts added in
    // butterfly order. d is a multiple of 8.
    const int parts = 32 % R == 0 ? 32 / R : 1;
    for (int r = warp; r < rows; r += kFrontThreads / 32) {
      const float* dpr = dp + r * dp_ld;
      const int k = lane % R, part = lane / R;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      if (part < parts) {
        for (int ch = 4 * part; ch < d; ch += 4 * parts) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[e] = fmaf(dpr[ch + e], wdt[(ch + e) * R + k], acc[e]);
        }
      }
      float v = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      for (int o = R; parts > 1 && o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane < R) dxdbl[(m0 + r) * nxp + lane] = from_f32<T>(v);
    }
    for (int i = threadIdx.x; i < rows * (nxp - R); i += kFrontThreads) {
      const int r = i / (nxp - R), col = R + i % (nxp - R);
      const size_t m = m0 + r;
      float v = 0.f;
      if (col < nx) {
        const int n = (col - R) % N;
        const float* src = col < R + N ? dBp : dCp;
        for (int t = 0; t < n_tiles; ++t) v += src[(static_cast<size_t>(t) * M + m) * N + n];
      }
      dxdbl[m * nxp + col] = from_f32<T>(v);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < R * d; i += kFrontThreads)
    dwdt_p[static_cast<size_t>(blockIdx.x) * R * d + i] = wacc[i];
  for (int i = threadIdx.x; i < d; i += kFrontThreads)
    dbdt_p[static_cast<size_t>(blockIdx.x) * d + i] = bacc[i];
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

struct ScanBwdWs {
  float *P, *E, *dBp, *dCp, *dAp, *dDp, *tmp;
};

int scan_tiles(int d) { return (d + kBwdCh - 1) / kBwdCh; }

ScanBwdWs carve_scan(Carve& cv, int Bt, int L, int d, int N, int chunk) {
  const size_t nc = (L + chunk - 1) / chunk, cnd = Bt * nc * N * d;
  const size_t tiles_rows = static_cast<size_t>(scan_tiles(d)) * Bt * L * N;
  ScanBwdWs w;
  w.P = cv.take<float>(cnd);
  w.E = cv.take<float>(cnd);
  w.dBp = cv.take<float>(tiles_rows);
  w.dCp = cv.take<float>(tiles_rows);
  w.dAp = cv.take<float>(cnd);
  w.dDp = cv.take<float>(Bt * nc * d);
  const size_t slices = Bt * nc, t1 = reduce_tmp(slices, static_cast<size_t>(N) * d);
  const size_t t2 = reduce_tmp(scan_tiles(d), static_cast<size_t>(Bt) * L * N);
  w.tmp = cv.take<float>(t1 > t2 ? t1 : t2);
  return w;
}

template <typename T, typename G, typename ZT>
cudaError_t scan_bwd(const T* u, int ld_u, const float* delta, const T* Bc, const T* Cc, int ld_bc,
                     const T* z, int ld_z, const G* g, int ld_g, const float* A, const float* D,
                     const float* h0s, const ScanBwdWs& w, float* ddt, float* du, ZT* dz,
                     int ld_dz, T* yg, int Bt, int L, int d, int N, int chunk, cudaStream_t s) {
  if (N > kMaxN || N <= 0 || chunk <= 0 || d <= 0 || L <= 0) return cudaErrorInvalidValue;
  const int nc = (L + chunk - 1) / chunk;
  const int n_seg = (chunk + kSeg - 1) / kSeg;
  const size_t rows = sizeof(float) * chunk * kMaxN;
  const size_t staged = sizeof(float) * kStaged * kStage;
  const size_t smem1 = rows + staged;
  const size_t smem3 = 2 * rows + sizeof(float4) * n_seg * kBwdThreads
                       + sizeof(float) * kSeg * kBwdWarps * 32 + staged;
  cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(scan_bwd_chunk_kernel<T, G>), smem1);
  if (err != cudaSuccess) return err;
  err = allow_smem(reinterpret_cast<const void*>(scan_bwd_out_kernel<T, G, ZT>), smem3);
  if (err != cudaSuccess) return err;
  const dim3 grid(scan_tiles(d), nc, Bt);
  scan_bwd_chunk_kernel<T, G><<<grid, kBwdThreads, smem1, s>>>(delta, Cc, ld_bc, z, ld_z, g, ld_g,
                                                              A, w.P, w.E, L, d, N, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_bwd_carry_kernel<<<dim3((N * d + 255) / 256, Bt), 256, 0, s>>>(w.P, w.E, nc, N * d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_bwd_out_kernel<T, G, ZT><<<grid, kBwdThreads, smem3, s>>>(
      u, ld_u, delta, Bc, Cc, ld_bc, z, ld_z, g, ld_g, A, D, h0s, w.E, ddt, du, dz, ld_dz, yg,
      w.dBp, w.dCp, w.dAp, w.dDp, Bt, L, d, N, chunk);
  return cudaGetLastError();
}

// The (N, d) dA_log and (d,) dD from the per-(b, chunk) partials.
cudaError_t scan_bwd_sums(const ScanBwdWs& w, const float* A, float* dA_log, float* dD, int Bt,
                          int L, int d, int N, int chunk, cudaStream_t s) {
  const int slices = Bt * ((L + chunk - 1) / chunk);
  cudaError_t err =
      reduce_slices(w.dAp, dA_log, slices, static_cast<size_t>(N) * d, w.tmp, s, A, N, d);
  if (err != cudaSuccess) return err;
  return reduce_slices(w.dDp, dD, slices, d, w.tmp, s);
}

template <typename T>
cudaError_t ssm_bwd(const T* u, int ld_u, const float* delta, const T* Bc, const T* Cc, int ld_bc,
                    const T* z, int ld_z, const float* A, const float* D, const float* h0s,
                    const T* g, float* du, float* ddelta, float* dz, float* dB, float* dC,
                    float* dA_log, float* dD, void* ws, int Bt, int L, int d, int N, int chunk,
                    cudaStream_t s) {
  Carve cv{reinterpret_cast<uintptr_t>(ws)};
  const ScanBwdWs w = carve_scan(cv, Bt, L, d, N, chunk);
  cudaError_t err = scan_bwd<T, T, float>(u, ld_u, delta, Bc, Cc, ld_bc, z, ld_z, g, d, A, D, h0s,
                                          w, ddelta, du, dz, d, nullptr, Bt, L, d, N, chunk, s);
  if (err != cudaSuccess) return err;
  const size_t n = static_cast<size_t>(Bt) * L * N;
  if ((err = reduce_slices(w.dBp, dB, scan_tiles(d), n, w.tmp, s)) != cudaSuccess) return err;
  if ((err = reduce_slices(w.dCp, dC, scan_tiles(d), n, w.tmp, s)) != cudaSuccess) return err;
  return scan_bwd_sums(w, A, dA_log, dD, Bt, L, d, N, chunk, s);
}

template <typename T>
struct InnerBwdWs {
  T *xz, *u, *xdbl, *yg, *dxz, *dxdbl;
  float *delta, *dy, *ddt, *du, *dtw_p, *dtb_p, *cw_p, *cb_p, *wpart, *wtmp;
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
  const size_t dt_tiles = (M + kDtTile - 1) / kDtTile;
  const size_t cv_tiles = static_cast<size_t>(Bt) * ((L + kConvRows - 1) / kConvRows);
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
  if (K != kConvTaps || R > kMaxR || N > kMaxN || L % chunk) return cudaErrorInvalidValue;
  Carve cv{reinterpret_cast<uintptr_t>(ws)};
  const InnerBwdWs<T> w = carve_inner<T>(cv, Bt, L, H, d, K, R, N, chunk);
  const int M = Bt * L, nx = R + 2 * N, nxp = round8(nx);
  cudaError_t err;
#define DDG_TRY(x) \
  if ((err = (x)) != cudaSuccess) return err
  // The front, as the forward computes it.
  DDG_TRY(gemm(h, w_in, w.xz, M, 2 * d, H, H, 2 * d, s));
  DDG_TRY(front<T>(w.xz, cw, cb, w_x, w_dt, b_dt, w.u, w.xdbl, w.delta, Bt, L, d, K, R, N, s));
  // out_proj's adjoint, then the scan's.
  DDG_TRY(gemm(g, w_out_f, w.dy, M, d, H, H, d, s));
  DDG_TRY((scan_bwd<T, float, T>(w.u, d, w.delta, w.xdbl + R, w.xdbl + R + N, nx, w.xz + d, 2 * d,
                                 w.dy, d, A, D, h0s, w.scan, w.ddt, w.du, w.dxz + d, 2 * d, w.yg,
                                 Bt, L, d, N, chunk, s)));
  // dt_proj's and x_proj's adjoints.
  const int dt_tiles = (M + kDtTile - 1) / kDtTile;
  const size_t dt_smem =
      sizeof(float) * (kDtRows * ((R + 3) / 4 * 4) + kDtRows * (d + 1) + (R + 1) * d);
  DDG_TRY(allow_smem(reinterpret_cast<const void*>(dtproj_bwd_kernel<T>), dt_smem));
  dtproj_bwd_kernel<T><<<dt_tiles, kFrontThreads, dt_smem, s>>>(
      w.ddt, w.xdbl, nx, w_dt, b_dt, w.scan.dBp, w.scan.dCp, scan_tiles(d), w.dxdbl, nxp, w.dtw_p,
      w.dtb_p, M, d, R, N);
  DDG_TRY(cudaGetLastError());
  DDG_TRY(gemm(w.dxdbl, w_x_f, w.du, M, d, nxp, nxp, d, s, true));
  // The conv + SiLU adjoint, then in_proj's.
  const int cv_x = (L + kConvRows - 1) / kConvRows;
  conv_bwd_kernel<T, kConvTaps><<<dim3(cv_x, Bt), kFrontThreads, 0, s>>>(
      w.xz, cw, cb, w.du, w.dxz, w.cw_p, w.cb_p, L, d);
  DDG_TRY(cudaGetLastError());
  DDG_TRY(gemm(w.dxz, w_in_f, dh, M, H, 2 * d, 2 * d, H, s));
  // Weight gradients, each a fixed-order two-stage sum.
  DDG_TRY(wgrad(h, H, w.dxz, 2 * d, w.wpart, dW_in, w.wtmp, M, H, 2 * d, s));
  DDG_TRY(wgrad(w.u, d, w.dxdbl, nxp, w.wpart, dW_x, w.wtmp, M, d, nx, s));
  DDG_TRY(wgrad(w.yg, d, g, H, w.wpart, dW_out, w.wtmp, M, d, H, s));
  DDG_TRY(reduce_slices(w.dtw_p, dW_dt, dt_tiles, static_cast<size_t>(R) * d, w.wtmp, s));
  DDG_TRY(reduce_slices(w.dtb_p, db_dt, dt_tiles, d, w.wtmp, s));
  DDG_TRY(reduce_slices(w.cw_p, dcw, Bt * cv_x, static_cast<size_t>(K) * d, w.wtmp, s));
  DDG_TRY(reduce_slices(w.cb_p, dcb, Bt * cv_x, d, w.wtmp, s));
#undef DDG_TRY
  return scan_bwd_sums(w.scan, A, dA_log, dD, Bt, L, d, N, chunk, s);
}

}  // namespace

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
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto fo = [](void* p) { return static_cast<float*>(p); };
  if (dtype == ddg::kF32)
    return ssm_bwd<float>(f(u), ld_u, f(delta), f(Bc), f(Cc), ld_bc, f(z), ld_z, f(A), f(D),
                          f(h0s), f(g), fo(du), fo(ddelta), fo(dz), fo(dB), fo(dC), fo(dA_log),
                          fo(dD), ws, Bt, L, d, N, chunk, s);
  if (dtype == ddg::kBF16) {
    auto b = [](const void* p) { return static_cast<const bf16*>(p); };
    return ssm_bwd<bf16>(b(u), ld_u, f(delta), b(Bc), b(Cc), ld_bc, b(z), ld_z, f(A), f(D),
                         f(h0s), b(g), fo(du), fo(ddelta), fo(dz), fo(dB), fo(dC), fo(dA_log),
                         fo(dD), ws, Bt, L, d, N, chunk, s);
  }
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
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto fo = [](void* p) { return static_cast<float*>(p); };
  if (dtype == ddg::kF32)
    return inner_bwd<float>(f(h), f(w_in), f(w_in_f), f(cw), f(cb), f(w_x), f(w_x_f), f(w_dt),
                            f(b_dt), f(A), f(D), f(w_out_f), f(h0s), f(g), fo(dh), fo(dW_in),
                            fo(dcw), fo(dcb), fo(dW_x), fo(dW_dt), fo(db_dt), fo(dA_log), fo(dD),
                            fo(dW_out), ws, Bt, L, H, d, K, R, N, chunk, s);
  if (dtype == ddg::kBF16) {
    auto b = [](const void* p) { return static_cast<const bf16*>(p); };
    return inner_bwd<bf16>(b(h), b(w_in), b(w_in_f), b(cw), b(cb), b(w_x), b(w_x_f), f(w_dt),
                           f(b_dt), f(A), f(D), b(w_out_f), f(h0s), b(g),
                           static_cast<bf16*>(dh), fo(dW_in), fo(dcw), fo(dcb), fo(dW_x),
                           fo(dW_dt), fo(db_dt), fo(dA_log), fo(dD), fo(dW_out), ws, Bt, L, H, d,
                           K, R, N, chunk, s);
  }
  return cudaErrorInvalidValue;
}
