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
// with A = -exp(log(-A)) (the TPU call hands its kernel log(-A)), y in T.
// The TPU grid runs the chunks of a row in order and carries h in VMEM;
// here three launches make the chunks independent, so (b, chunk, channel)
// threads fill the card:
//   1. every chunk from a zero state: its end state E and the product P of
//      its a_t, 16 states of one channel in one thread's registers;
//   2. per (b, state, channel), a pass over the chunks in order:
//      h0[c] = entry state, h0[c + 1] = P[c] h0[c] + E[c] (K14's h0s);
//   3. every chunk again from its entry state, read out through C, gated.
// exp(delta A) is ex2.approx of delta (A log2 e): one SFU operation.
// d_state > 16 runs passes 1 and 3 over groups of 16 states, one group in
// registers at a time and only its B and C columns staged in shared memory
// (zero states past N), so no block's shared memory grows with d_state;
// pass 3 keeps each row's C.h sum of the groups so far in shared memory and
// gates it after the last group, the groups in order. At d_state <= 16 it
// is one group, and pass 3 is built without that sum.
//
// ddg_ssm_scan_dtlr (K16) is K14 on delta = softplus(dt_lr W_dt + b_dt):
// `delta_kernel` forms delta once per (row, channel) into a (B L, d) fp32
// workspace (W_dt's columns in shared memory, fp32 FMAs in rank order four
// at a time, then the accurate softplus: `dt_pre`'s order, so the bits of
// K18's front and of K17), then K14's three passes read it, unchanged. The
// first K16 kept delta out of device memory and formed it inside passes 1
// and 3, a chain of R FMAs and a softplus ahead of each row's exps in the
// states' serial row loop, twice, with W_dt's column in registers: 8.49 ms
// at 16 x 32768 against K14's 3.78 on a delta read from memory (NVIDIA
// H100 80GB HBM3, 700 W; PERF.md). Writing delta once costs 4 bytes a (row,
// channel), 0.32 ms of bytes at that shape, and forming it outside the row
// loop takes it off the scan's critical path. The workspace is transient:
// the autograd Function saves what the TPU VJP saves, never delta. L must
// be a multiple of the chunk (a padded tail would carry softplus(b_dt) > 0
// into the state).
// Bound at 16 rows of 32768, d = 512, N = 16, R = 16: 16 exps of delta A,
// softplus's exp and log1p and the gate's sigmoid a (row, channel), 5.2 G
// SFU operations (1.24 ms at 4.18 T/s) against about 0.5 GB of bytes (u, z,
// y, dt_lr, B, C and h0s; 0.15 ms). Passes 1 and 3 each take the exps of
// delta A, so this design spends at least 2.2 ms on the SFU.
//
// ddg_mamba_inner (K18), for compute type T, as six launches:
//   xz    = h W_in^T                   in_proj, rounded to T       (gemm)
//   u     = silu(((x_{t-3} w0 + x_{t-2} w1) + ...) + b)   taps summed from the
//           oldest, every op rounded to T; SiLU in fp32, then T     (front)
//   x_dbl = u W_x^T rounded to T       (dt_lr | B | C)             (front)
//   delta = softplus(dt_lr W_dt^T + b_dt)   fp32 FMAs              (front)
//   y     = the three scan launches above, written in T
//   out   = y W_out^T rounded to T     out_proj                    (gemm)
// bf16 products run on the tensor cores (mma.sync m16n8k16, fp32
// accumulation), fp32 ones on the CUDA cores in full fp32. The TPU kernel
// keeps everything in VMEM and carries the conv's halo rows between the
// chunks it runs in order; here the front kernel's row tiles read their
// halo rows from xz, so tiles are independent, and u, delta, x_dbl and y
// pass through device memory (about 6 KB a token in bf16).
//
// Bounds on the H100 at the Species10 shape (2B = 16 rows of L = 32768,
// H = 256, d = 512, N = 16, dt_rank 16), per K18 call: the function takes
// 5.4 G exps and logs (exp(delta A) over d x N, softplus, two sigmoids),
// 1.28 ms at 4.18 T/s on the SFU, against 0.44 ms of bf16 tensor-core
// products and 0.16 ms for reading h and writing out. Passes 1 and 3 both
// take the exps of delta A (4.3 G each), so this design spends at least
// 2.06 ms on the SFU; its workspace traffic (about 9.5 GB) costs 2.8 ms.

#include "mamba.cuh"

namespace {

// Pass 1: each (b, chunk, channel) from a zero state, a group of 16 states
// at a time (Grp: d_state > 16), the group's B columns staged before it; P
// and E are (Bt, n_chunks, N, d).
template <typename T, bool Grp>
__global__ void __launch_bounds__(kScanThreads)
    scan_chunk_kernel(const T* __restrict__ u, int ld_u, const float* __restrict__ delta,
                      const T* __restrict__ Bc, int ld_bc, const float* __restrict__ A,
                      float* __restrict__ P, float* __restrict__ E, int L, int d, int N,
                      int chunk) {
  extern __shared__ __align__(16) float sm[];
  float* Bs = sm;                  // chunk x kMaxN
  const int b = blockIdx.z, c = blockIdx.y, nc = gridDim.y;
  const int ch = blockIdx.x * kScanThreads + threadIdx.x;
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
    float a2[kMaxN], h[kMaxN], p[kMaxN], bv[kMaxN];
    load_a(A, ch, N, n0, a2);
#pragma unroll
    for (int n = 0; n < kMaxN; ++n) h[n] = 0.f, p[n] = 1.f;
    for (int r = 0; r < rows; ++r) {
      const float dt = delta[(row0 + r) * d + ch];
      const float dtu = dt * to_f32(u[(row0 + r) * ld_u + ch]);
      load_row(Bs + r * kMaxN, bv);
#pragma unroll
      for (int n = 0; n < kMaxN; ++n) {
        const float a = ex2(dt * a2[n]);
        h[n] = fmaf(a, h[n], dtu * bv[n]);
        p[n] *= a;
      }
    }
#pragma unroll
    for (int n = 0; n < kMaxN; ++n) {
      if (n0 + n >= N) break;
      P[o + static_cast<size_t>(n0 + n) * d] = p[n];
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
__global__ void __launch_bounds__(kScanThreads)
    scan_out_kernel(const T* __restrict__ u, int ld_u, const float* __restrict__ delta,
                    const T* __restrict__ Bc, const T* __restrict__ Cc, int ld_bc,
                    const T* __restrict__ z, int ld_z, const float* __restrict__ A,
                    const float* __restrict__ D, const float* __restrict__ h0s,
                    T* __restrict__ y, int L, int d, int N, int chunk) {
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.z, c = blockIdx.y, nc = gridDim.y;
  const int ch = blockIdx.x * kScanThreads + threadIdx.x;
  const bool live = ch < d;
  const int t0 = c * chunk, rows = min(chunk, L - t0);
  const size_t row0 = static_cast<size_t>(b) * L + t0;
  float* Bs = sm;                        // chunk x kMaxN
  float* Cs = Bs + chunk * kMaxN;        // chunk x kMaxN
  float* ysum = Cs + chunk * kMaxN;      // chunk x kScanThreads, Grp
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
      float ys = first ? 0.f : ysum[r * kScanThreads + threadIdx.x];
#pragma unroll
      for (int n = 0; n < kMaxN; ++n) {
        const float a = ex2(dt * a2[n]);
        h[n] = fmaf(a, h[n], dtu * bv[n]);
        ys = fmaf(cv[n], h[n], ys);
      }
      if (!last) {
        ysum[r * kScanThreads + threadIdx.x] = ys;
        continue;
      }
      const float zz = to_f32(z[row * ld_z + ch]);
      y[row * d + ch] = from_f32<T>((ys + dv * uu) * (zz * sigmoid(zz)));
    }
  }
}

// Shared memory of passes 1 and 3: one group's B (and C) columns of the
// chunk's rows, and past 16 states each row's running C.h; none of it grows
// with d_state. The wrappers' `ssm_scan_takes` and `ssm_scan_dtlr_takes`
// hold the same sums.
size_t scan_smem1(int chunk) { return sizeof(float) * chunk * kMaxN; }

size_t scan_smem3(int chunk, int N) {
  return sizeof(float) * chunk * (2 * kMaxN + (N > kMaxN ? kScanThreads : 0));
}

template <typename T, bool Grp>
cudaError_t scan_k(const T* u, int ld_u, const float* delta, const T* Bc, const T* Cc, int ld_bc,
                   const T* z, int ld_z, const float* A, const float* D, T* y, float* P, float* E,
                   float* h0s, int Bt, int L, int d, int N, int chunk, cudaStream_t s) {
  const int nc = (L + chunk - 1) / chunk;
  const size_t s1 = scan_smem1(chunk), s3 = scan_smem3(chunk, N);
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(scan_chunk_kernel<T, Grp>), s1);
  if (err != cudaSuccess) return err;
  err = allow_smem(reinterpret_cast<const void*>(scan_out_kernel<T, Grp>), s3);
  if (err != cudaSuccess) return err;
  const dim3 grid((d + kScanThreads - 1) / kScanThreads, nc, Bt);
  scan_chunk_kernel<T, Grp><<<grid, kScanThreads, s1, s>>>(u, ld_u, delta, Bc, ld_bc, A, P, E, L,
                                                          d, N, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_carry_kernel<<<dim3((N * d + 255) / 256, Bt), 256, 0, s>>>(P, E, h0s, nc, N * d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_out_kernel<T, Grp><<<grid, kScanThreads, s3, s>>>(u, ld_u, delta, Bc, Cc, ld_bc, z, ld_z,
                                                        A, D, h0s, y, L, d, N, chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t scan(const T* u, int ld_u, const float* delta, const T* Bc, const T* Cc, int ld_bc,
                 const T* z, int ld_z, const float* A, const float* D, T* y, float* P, float* E,
                 float* h0s, int Bt, int L, int d, int N, int chunk, cudaStream_t s) {
  if (N <= 0 || chunk <= 0 || d <= 0 || L <= 0) return cudaErrorInvalidValue;
  return N > kMaxN ? scan_k<T, true>(u, ld_u, delta, Bc, Cc, ld_bc, z, ld_z, A, D, y, P, E, h0s,
                                     Bt, L, d, N, chunk, s)
                   : scan_k<T, false>(u, ld_u, delta, Bc, Cc, ld_bc, z, ld_z, A, D, y, P, E, h0s,
                                      Bt, L, d, N, chunk, s);
}

// --- K16's delta = softplus(dt_lr W_dt + b_dt), once per (row, channel) -----
//
// One block per channel tile, walking row tiles (grid.y blocks apart): W_dt's
// columns of the tile in shared memory for the whole walk, each row tile's
// dt_lr rows staged beside them; a thread owns a channel and sums kDeltaBatch
// rows at once, k ascending four at a time with zeros past R, which is
// `dt_pre`'s order, so delta is the bits K18's front and K17 form.
constexpr int kDeltaCh = 128;
constexpr int kDeltaRows = 32;
constexpr int kDeltaBatch = 8;
constexpr int kDeltaBlocks = 2048;   // blocks of a launch, at most

size_t delta_smem(int R) {
  return sizeof(float) * static_cast<size_t>(round4(R)) * (kDeltaCh + kDeltaRows);
}

__global__ void __launch_bounds__(kDeltaCh)
    delta_kernel(const float* __restrict__ lr, int ld_lr, const float* __restrict__ wdt,
                 const float* __restrict__ bdt, float* __restrict__ delta, size_t M, int d,
                 int R) {
  extern __shared__ __align__(16) float dsm[];
  const int lr_ld = round4(R);
  float* ws = dsm;                          // lr_ld x kDeltaCh
  float* lrs = ws + lr_ld * kDeltaCh;       // kDeltaRows x lr_ld
  const int ch0 = blockIdx.x * kDeltaCh, tid = threadIdx.x, ch = ch0 + tid;
  const bool live = ch < d;
  for (int i = tid; i < lr_ld * kDeltaCh; i += kDeltaCh) {
    const int k = i / kDeltaCh, c = ch0 + i % kDeltaCh;
    ws[i] = k < R && c < d ? wdt[static_cast<size_t>(k) * d + c] : 0.f;
  }
  const float bias = live ? bdt[ch] : 0.f;
  const size_t step = static_cast<size_t>(gridDim.y) * kDeltaRows;
  for (size_t m0 = static_cast<size_t>(blockIdx.y) * kDeltaRows; m0 < M; m0 += step) {
    __syncthreads();  // W_dt staged; the last tile's readers of lrs are done
    for (int i = tid; i < kDeltaRows * lr_ld; i += kDeltaCh) {
      const int r = i / lr_ld, k = i - r * lr_ld;
      lrs[i] = m0 + r < M && k < R ? lr[(m0 + r) * ld_lr + k] : 0.f;
    }
    __syncthreads();
    for (int rb = 0; rb < kDeltaRows; rb += kDeltaBatch) {
      float acc[kDeltaBatch];
#pragma unroll
      for (int e = 0; e < kDeltaBatch; ++e) acc[e] = 0.f;
      for (int k = 0; k < lr_ld; k += 4) {
        const float w0 = ws[k * kDeltaCh + tid], w1 = ws[(k + 1) * kDeltaCh + tid];
        const float w2 = ws[(k + 2) * kDeltaCh + tid], w3 = ws[(k + 3) * kDeltaCh + tid];
#pragma unroll
        for (int e = 0; e < kDeltaBatch; ++e) {
          const float4 v = *reinterpret_cast<const float4*>(lrs + (rb + e) * lr_ld + k);
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
        if (m < M) delta[m * d + ch] = softplus(acc[e] + bias);
      }
    }
  }
}

// K16: delta into the (Bt L, d) fp32 workspace, then K14's three passes on
// it. L must be a multiple of the chunk.
template <typename T>
cudaError_t scan_dtlr(const T* u, int ld_u, const float* lr, int ld_lr, const float* wdt,
                      const float* bdt, float* delta, const T* Bc, const T* Cc, int ld_bc,
                      const T* z, int ld_z, const float* A, const float* D, T* y, float* P,
                      float* E, float* h0s, int Bt, int L, int d, int N, int R, int chunk,
                      cudaStream_t s) {
  if (R <= 0 || d <= 0 || L <= 0 || chunk <= 0 || L % chunk) return cudaErrorInvalidValue;
  const size_t M = static_cast<size_t>(Bt) * L;
  const size_t smem = delta_smem(R);
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(delta_kernel), smem);
  if (err != cudaSuccess) return err;
  const int ct = (d + kDeltaCh - 1) / kDeltaCh;
  const size_t tiles = (M + kDeltaRows - 1) / kDeltaRows;
  const int gy = static_cast<int>(tiles < static_cast<size_t>(kDeltaBlocks / ct)
                                      ? tiles : kDeltaBlocks / ct > 0 ? kDeltaBlocks / ct : 1);
  delta_kernel<<<dim3(ct, gy), kDeltaCh, smem, s>>>(lr, ld_lr, wdt, bdt, delta, M, d, R);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return scan<T>(u, ld_u, delta, Bc, Cc, ld_bc, z, ld_z, A, D, y, P, E, h0s, Bt, L, d, N, chunk,
                 s);
}

template <typename T>
cudaError_t inner(const T* h, const T* w_in, const T* cw, const T* cb, const T* w_x,
                  const float* w_dt, const float* b_dt, const float* A, const float* D,
                  const T* w_out, T* xz, T* u, T* xdbl, float* delta, float* P, float* E,
                  float* h0s, T* y, T* out, int Bt, int L, int H, int d, int K, int R, int N,
                  int chunk, cudaStream_t s) {
  const int M = Bt * L, nx = R + 2 * N;
  cudaError_t err = gemm(h, w_in, xz, M, 2 * d, H, H, 2 * d, s);
  if (err != cudaSuccess) return err;
  err = front<T>(xz, cw, cb, w_x, w_dt, b_dt, u, xdbl, delta, Bt, L, d, K, R, N, s);
  if (err != cudaSuccess) return err;
  err = scan<T>(u, d, delta, xdbl + R, xdbl + R + N, nx, xz + d, 2 * d, A, D, y, P, E, h0s, Bt, L, d,
                N, chunk, s);
  if (err != cudaSuccess) return err;
  return gemm(y, w_out, out, M, H, d, d, H, s);
}

const float* f(const void* p) { return static_cast<const float*>(p); }
float* fo(void* p) { return static_cast<float*>(p); }
const bf16* b(const void* p) { return static_cast<const bf16*>(p); }
bf16* bo(void* p) { return static_cast<bf16*>(p); }

}  // namespace

extern "C" int ddg_ssm_scan(const void* u, int ld_u, const void* delta, const void* Bc,
                            const void* Cc, int ld_bc, const void* z, int ld_z, const void* A,
                            const void* D, void* y, void* P, void* E, void* h0s, int Bt, int L,
                            int d, int N, int chunk, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ddg::kF32)
    return scan<float>(f(u), ld_u, f(delta), f(Bc), f(Cc), ld_bc, f(z), ld_z, f(A), f(D), fo(y),
                       fo(P), fo(E), fo(h0s), Bt, L, d, N, chunk, s);
  if (dtype == ddg::kBF16)
    return scan<bf16>(b(u), ld_u, f(delta), b(Bc), b(Cc), ld_bc, b(z), ld_z, f(A), f(D), bo(y),
                      fo(P), fo(E), fo(h0s), Bt, L, d, N, chunk, s);
  return cudaErrorInvalidValue;
}

// K16: dt_lr (Bt L rows of stride ld_lr, fp32), W_dt (R, d), b_dt (d) fp32;
// delta is a (Bt L, d) fp32 workspace.
extern "C" int ddg_ssm_scan_dtlr(const void* u, int ld_u, const void* dt_lr, int ld_lr,
                                 const void* w_dt, const void* b_dt, void* delta,
                                 const void* Bc, const void* Cc, int ld_bc, const void* z,
                                 int ld_z, const void* A, const void* D, void* y, void* P,
                                 void* E, void* h0s, int Bt, int L, int d, int N, int R,
                                 int chunk, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ddg::kF32)
    return scan_dtlr<float>(f(u), ld_u, f(dt_lr), ld_lr, f(w_dt), f(b_dt), fo(delta), f(Bc),
                            f(Cc), ld_bc, f(z), ld_z, f(A), f(D), fo(y), fo(P), fo(E), fo(h0s),
                            Bt, L, d, N, R, chunk, s);
  if (dtype == ddg::kBF16)
    return scan_dtlr<bf16>(b(u), ld_u, f(dt_lr), ld_lr, f(w_dt), f(b_dt), fo(delta), b(Bc),
                           b(Cc), ld_bc, b(z), ld_z, f(A), f(D), bo(y), fo(P), fo(E), fo(h0s),
                           Bt, L, d, N, R, chunk, s);
  return cudaErrorInvalidValue;
}

// The sums the wrappers mirror (`ops.mamba.scan_smem`, `_front_tile`,
// `_SMEM`), so that a check on the card can hold the two sides together;
// R > 0 adds K16's delta kernel.
extern "C" long long ddg_scan_smem(int chunk, int N, int R) {
  size_t m = scan_smem1(chunk), s3 = scan_smem3(chunk, N);
  if (s3 > m) m = s3;
  if (R > 0 && delta_smem(R) > m) m = delta_smem(R);
  return static_cast<long long>(m);
}

extern "C" int ddg_front_tile(int d, int R, int tsize) { return front_tile(d, R, tsize); }

extern "C" int ddg_smem_max() { return kSmemMax; }

extern "C" int ddg_mamba_inner(const void* h, const void* w_in, const void* cw, const void* cb,
                               const void* w_x, const void* w_dt, const void* b_dt,
                               const void* A, const void* D, const void* w_out, void* xz,
                               void* u, void* xdbl, void* delta, void* P, void* E, void* h0s,
                               void* y, void* out, int Bt, int L, int H, int d, int K, int R,
                               int N, int chunk, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ddg::kF32)
    return inner<float>(f(h), f(w_in), f(cw), f(cb), f(w_x), f(w_dt), f(b_dt), f(A), f(D),
                        f(w_out), fo(xz), fo(u), fo(xdbl), fo(delta), fo(P), fo(E), fo(h0s),
                        fo(y), fo(out), Bt, L, H, d, K, R, N, chunk, s);
  if (dtype == ddg::kBF16)
    return inner<bf16>(b(h), b(w_in), b(cw), b(cb), b(w_x), f(w_dt), f(b_dt), f(A), f(D),
                       b(w_out), bo(xz), bo(u), bo(xdbl), fo(delta), fo(P), fo(E), fo(h0s),
                       bo(y), bo(out), Bt, L, H, d, K, R, N, chunk, s);
  return cudaErrorInvalidValue;
}
