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
// registers at a time (B and C rows staged as whole groups, zero states past
// N); pass 3 keeps each row's C.h sum of the groups so far in shared
// memory and gates it after the last group, the groups in order. At
// d_state <= 16 it is one group, and pass 3 is built without that sum.
//
// ddg_ssm_scan_dtlr (K16) is K14 with delta = softplus(dt_lr W_dt + b_dt)
// formed in passes 1 and 3 per (row, channel): the chunk's dt_lr rows staged
// in shared memory beside the B (and C) rows, W_dt's column of the thread's
// channel in registers (one or two tiles of 32 ranks), fp32 FMAs in rank
// order, then softplus, as K18's front forms it (`dt_pre`). The (B, L, d)
// delta never reaches device memory: K14 reads 4 bytes a (row, channel)
// more, twice, and needs the dt_proj and softplus passes before it. L
// must be a multiple of the chunk (a padded tail would carry softplus(b_dt)
// > 0 into the state).
// Bound at 16 rows of 32768, d = 512, N = 16, R = 16: 16 exps of delta A,
// softplus's exp and log1p and the gate's sigmoid a (row, channel), 5.2 G
// SFU operations (1.24 ms at 4.18 T/s) against about 0.5 GB of bytes (u, z,
// y, dt_lr, B, C and h0s; 0.15 ms). Passes 1 and 3 each take the exps of
// delta A and form delta, so this design spends at least 2.3 ms on the SFU.
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

// delta of row r (of the chunk starting at row0) for channel ch: from
// memory (NW = 0) or formed from the staged dt_lr row (lrs, round4(R) to a
// row) and W_dt's column in registers.
template <int NW>
struct DeltaAt {
  const float* delta;
  const float* lrs;
  size_t row0;
  int d, ch, R, lr_ld;
  float wr[NW > 0 ? NW : 1];
  float bias;
  __device__ DeltaAt(const DtSrc& dl, const float* lrs_, size_t row0_, int d_, int ch_)
      : delta(dl.delta), lrs(lrs_), row0(row0_), d(d_), ch(ch_), R(dl.R), lr_ld(round4(dl.R)),
        bias(0.f) {
    if constexpr (NW > 0) {
      load_wdt(dl.wdt, ch, d, R, wr);
      bias = dl.bdt[ch];
    }
  }
  __device__ __forceinline__ float operator()(int r) const {
    if constexpr (NW > 0)
      return softplus(dt_pre(lrs + r * lr_ld, wr, R) + bias);
    else
      return delta[(row0 + r) * d + ch];
  }
};

// Pass 1: each (b, chunk, channel) from a zero state, a group of 16 states
// at a time (Grp: d_state > 16); P and E are (Bt, n_chunks, N, d).
template <typename T, int NW, bool Grp>
__global__ void __launch_bounds__(kScanThreads)
    scan_chunk_kernel(const T* __restrict__ u, int ld_u, DtSrc dl, const T* __restrict__ Bc,
                      int ld_bc, const float* __restrict__ A, float* __restrict__ P,
                      float* __restrict__ E, int L, int d, int N, int chunk) {
  extern __shared__ __align__(16) float sm[];
  const int Np = Grp ? n_pad(N) : kMaxN;
  float* Bs = sm;                  // chunk x Np
  float* lrs = Bs + chunk * Np;    // chunk x round4(R), when NW > 0
  const int b = blockIdx.z, c = blockIdx.y, nc = gridDim.y;
  const int ch = blockIdx.x * kScanThreads + threadIdx.x;
  const int t0 = c * chunk, rows = min(chunk, L - t0);
  const size_t row0 = static_cast<size_t>(b) * L + t0;
  stage_rows<Grp>(Bc, ld_bc, row0, rows, N, Np, Bs);
  if constexpr (NW > 0) stage_lr(dl.lr, dl.ld_lr, row0, rows, dl.R, lrs);
  __syncthreads();
  if (ch >= d) return;
  const DeltaAt<NW> delta_at(dl, lrs, row0, d, ch);
  const size_t o = (static_cast<size_t>(b) * nc + c) * N * d + ch;
  const int n_end = Grp ? N : 1;
  for (int n0 = 0; n0 < n_end; n0 += kMaxN) {
    float a2[kMaxN], h[kMaxN], p[kMaxN], bv[kMaxN];
    load_a(A, ch, N, n0, a2);
#pragma unroll
    for (int n = 0; n < kMaxN; ++n) h[n] = 0.f, p[n] = 1.f;
    for (int r = 0; r < rows; ++r) {
      const float dt = delta_at(r);
      const float dtu = dt * to_f32(u[(row0 + r) * ld_u + ch]);
      load_row(Bs + r * Np + n0, bv);
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
// Grp (d_state > 16): the groups in order, each row's C.h sum carried from
// group to group in shared memory (ysum), gated after the last.
template <typename T, int NW, bool Grp>
__global__ void __launch_bounds__(kScanThreads)
    scan_out_kernel(const T* __restrict__ u, int ld_u, DtSrc dl, const T* __restrict__ Bc,
                    const T* __restrict__ Cc, int ld_bc, const T* __restrict__ z, int ld_z,
                    const float* __restrict__ A, const float* __restrict__ D,
                    const float* __restrict__ h0s, T* __restrict__ y, int L, int d, int N,
                    int chunk) {
  extern __shared__ __align__(16) float sm[];
  const int Np = Grp ? n_pad(N) : kMaxN;
  const int b = blockIdx.z, c = blockIdx.y, nc = gridDim.y;
  const int ch = blockIdx.x * kScanThreads + threadIdx.x;
  const int t0 = c * chunk, rows = min(chunk, L - t0);
  const size_t row0 = static_cast<size_t>(b) * L + t0;
  float* Bs = sm;                                          // chunk x Np
  float* Cs = Bs + chunk * Np;                             // chunk x Np
  float* lrs = Cs + chunk * Np;                            // chunk x round4(R), NW > 0
  float* ysum = lrs + (NW > 0 ? chunk * round4(dl.R) : 0);  // chunk x kScanThreads, Grp
  stage_rows<Grp>(Bc, ld_bc, row0, rows, N, Np, Bs);
  stage_rows<Grp>(Cc, ld_bc, row0, rows, N, Np, Cs);
  if constexpr (NW > 0) stage_lr(dl.lr, dl.ld_lr, row0, rows, dl.R, lrs);
  __syncthreads();
  if (ch >= d) return;
  const DeltaAt<NW> delta_at(dl, lrs, row0, d, ch);
  const size_t o = (static_cast<size_t>(b) * nc + c) * N * d + ch;
  const float dv = D[ch];
  const int n_end = Grp ? N : 1;
  for (int n0 = 0; n0 < n_end; n0 += kMaxN) {
    const bool first = !Grp || n0 == 0, last = !Grp || n0 + kMaxN >= N;
    float a2[kMaxN], h[kMaxN], bv[kMaxN], cv[kMaxN];
    load_a(A, ch, N, n0, a2);
#pragma unroll
    for (int n = 0; n < kMaxN; ++n)
      h[n] = n0 + n < N ? h0s[o + static_cast<size_t>(n0 + n) * d] : 0.f;
    for (int r = 0; r < rows; ++r) {
      const size_t row = row0 + r;
      const float dt = delta_at(r);
      const float uu = to_f32(u[row * ld_u + ch]);
      const float dtu = dt * uu;
      load_row(Bs + r * Np + n0, bv);
      load_row(Cs + r * Np + n0, cv);
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

// Shared memory of passes 1 and 3 (R = 0: delta from memory); the wrappers'
// `ssm_scan_takes` and `ssm_scan_dtlr_takes` hold the same sums.
size_t scan_smem1(int chunk, int N, int R) {
  return sizeof(float) * chunk * (n_pad(N) + (R > 0 ? round4(R) : 0));
}

size_t scan_smem3(int chunk, int N, int R) {
  return sizeof(float) * chunk *
         (2 * n_pad(N) + (R > 0 ? round4(R) : 0) + (N > kMaxN ? kScanThreads : 0));
}

template <typename T, int NW, bool Grp>
cudaError_t scan_k(const T* u, int ld_u, const DtSrc& dl, const T* Bc, const T* Cc, int ld_bc,
                   const T* z, int ld_z, const float* A, const float* D, T* y, float* P, float* E,
                   float* h0s, int Bt, int L, int d, int N, int chunk, cudaStream_t s) {
  const int nc = (L + chunk - 1) / chunk, R = NW > 0 ? dl.R : 0;
  const size_t s1 = scan_smem1(chunk, N, R), s3 = scan_smem3(chunk, N, R);
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(scan_chunk_kernel<T, NW, Grp>), s1);
  if (err != cudaSuccess) return err;
  err = allow_smem(reinterpret_cast<const void*>(scan_out_kernel<T, NW, Grp>), s3);
  if (err != cudaSuccess) return err;
  const dim3 grid((d + kScanThreads - 1) / kScanThreads, nc, Bt);
  scan_chunk_kernel<T, NW, Grp><<<grid, kScanThreads, s1, s>>>(u, ld_u, dl, Bc, ld_bc, A, P, E,
                                                               L, d, N, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_carry_kernel<<<dim3((N * d + 255) / 256, Bt), 256, 0, s>>>(P, E, h0s, nc, N * d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_out_kernel<T, NW, Grp><<<grid, kScanThreads, s3, s>>>(u, ld_u, dl, Bc, Cc, ld_bc, z, ld_z,
                                                             A, D, h0s, y, L, d, N, chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t scan(const T* u, int ld_u, const DtSrc& dl, const T* Bc, const T* Cc, int ld_bc,
                 const T* z, int ld_z, const float* A, const float* D, T* y, float* P, float* E,
                 float* h0s, int Bt, int L, int d, int N, int chunk, cudaStream_t s) {
  if (N <= 0 || chunk <= 0 || d <= 0 || L <= 0) return cudaErrorInvalidValue;
#define DDG_SCAN(NW, G) \
  scan_k<T, NW, G>(u, ld_u, dl, Bc, Cc, ld_bc, z, ld_z, A, D, y, P, E, h0s, Bt, L, d, N, chunk, s)
  const bool grp = N > kMaxN;
  if (dl.delta != nullptr) return grp ? DDG_SCAN(0, true) : DDG_SCAN(0, false);
  if (dl.R <= 0 || dl.R > kMaxR * kMaxRT || L % chunk) return cudaErrorInvalidValue;
  if (dl.R <= kMaxR) return grp ? DDG_SCAN(kMaxR, true) : DDG_SCAN(kMaxR, false);
  return grp ? DDG_SCAN(kMaxR * kMaxRT, true) : DDG_SCAN(kMaxR * kMaxRT, false);
#undef DDG_SCAN
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
  const DtSrc dl{delta, nullptr, 0, nullptr, nullptr, 0};
  err = scan<T>(u, d, dl, xdbl + R, xdbl + R + N, nx, xz + d, 2 * d, A, D, y, P, E, h0s, Bt, L, d,
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
  const DtSrc dl{f(delta), nullptr, 0, nullptr, nullptr, 0};
  if (dtype == ddg::kF32)
    return scan<float>(f(u), ld_u, dl, f(Bc), f(Cc), ld_bc, f(z), ld_z, f(A), f(D), fo(y), fo(P),
                       fo(E), fo(h0s), Bt, L, d, N, chunk, s);
  if (dtype == ddg::kBF16)
    return scan<bf16>(b(u), ld_u, dl, b(Bc), b(Cc), ld_bc, b(z), ld_z, f(A), f(D), bo(y), fo(P),
                      fo(E), fo(h0s), Bt, L, d, N, chunk, s);
  return cudaErrorInvalidValue;
}

// K16: dt_lr (Bt L rows of stride ld_lr, fp32), W_dt (R, d), b_dt (d) fp32.
extern "C" int ddg_ssm_scan_dtlr(const void* u, int ld_u, const void* dt_lr, int ld_lr,
                                 const void* w_dt, const void* b_dt, const void* Bc,
                                 const void* Cc, int ld_bc, const void* z, int ld_z,
                                 const void* A, const void* D, void* y, void* P, void* E,
                                 void* h0s, int Bt, int L, int d, int N, int R, int chunk,
                                 int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const DtSrc dl{nullptr, f(dt_lr), ld_lr, f(w_dt), f(b_dt), R};
  if (dtype == ddg::kF32)
    return scan<float>(f(u), ld_u, dl, f(Bc), f(Cc), ld_bc, f(z), ld_z, f(A), f(D), fo(y), fo(P),
                       fo(E), fo(h0s), Bt, L, d, N, chunk, s);
  if (dtype == ddg::kBF16)
    return scan<bf16>(b(u), ld_u, dl, b(Bc), b(Cc), ld_bc, b(z), ld_z, f(A), f(D), bo(y), fo(P),
                      fo(E), fo(h0s), Bt, L, d, N, chunk, s);
  return cudaErrorInvalidValue;
}

// The sums the wrappers mirror (`ops.mamba.scan_smem`, `_front_tile`,
// `_SMEM`), so that a check on the card can hold the two sides together.
extern "C" long long ddg_scan_smem(int chunk, int N, int R) {
  const size_t s1 = scan_smem1(chunk, N, R), s3 = scan_smem3(chunk, N, R);
  return static_cast<long long>(s1 > s3 ? s1 : s3);
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
