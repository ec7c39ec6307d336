// Fused uniform-state (UDLM) denoise step: softmax + posterior numerator +
// log + Gumbel-argmax, in one kernel per step.
//
// Replaces the TPU kernels in ddg_tpu/ops/fused_sampling.py (both reach
// pl.pallas_call through _uniform_call, :366-398):
//   fused_uniform_sample     -> _uniform_kernel       (K9, one logits tensor)
//   fused_uniform_cfg_sample -> _uniform_cfg_kernel   (K10, two)
// For each (b, l) row, over the columns v < V of the logits, of which the
// first `vocab_size` are the vocabulary:
//   p_v     = softmax(logits)_v over the vocabulary
//   num_v   = p_v * ((a_s - a_t) + [v == xt] * a_t * vocab_size)
//             + [v == xt] * (a_t / a_s - a_t)
//             + (1 - a_t / a_s) * (1 - a_s) / vocab_size
//   log q_v = log(num_v + 1e-35)
//             (cfg: gamma * log q_v(lc) + (1 - gamma) * log q_v(lu))
//   out     = argmax_v log q_v + g_v over the vocabulary, the lowest index
//             winning ties
// with a_t, a_s the per-row alpha(t), alpha(s). The posterior's
// denominator is constant along a row, so the argmax needs only the
// numerator. There is no copy-over: every token is resampled. g is
// standard Gumbel noise, read from a (B, L, V) fp32 tensor or made here by
// Philox4x32-10 keyed as the absorbing kernels key it: counter (v / 4, l,
// b), key (seed, 0), u = top24 / 2^24 + 1e-10, g = -log(-log(u)).
//
// Bound on the H100: at the UNet's shape (B=32, L=3072, V=256, bf16) the
// step reads 50.3 MB of logits (100.7 MB for CFG), 0.015 / 0.030 ms at
// 3.35 TB/s. Each logit also costs an exp and a log of the numerator for
// each logits tensor and the Philox words and their compare; the two logs
// of a Gumbel draw are needed only where the draw can win.
//
// K9 and K10 run the same two kernels, compiled for kIn = 1 or 2 logits
// tensors, one of them by the row's width (`plan`, from the shape alone;
// ops/fused_sampling.py's `uniform_plan` mirrors it):
//   - narrow rows (vocab_size <= 32; Species10's 12):
//     `uniform_narrow_kernel`, a thread a row, 256 rows a block, so every
//     lane works and a warp's loads cover the contiguous span of its 32
//     rows; the row's columns stay in registers (12, 16 or 32 of them: a
//     thread's work is per column held, the vocabulary's or not);
//   - wider rows: `uniform_wide_kernel`, a warp a row, a lane 8
//     consecutive columns a turn of 256 (16-byte loads where V % 8 == 0
//     and the rows are aligned); up to 256 columns the row is read once and
//     stays in registers, past that a second pass reads it again.
// Both take one exp a logit and tensor where the row stays in registers
// (exp(z - max) serves the sum and p = exp(z - max) / sum), then the
// numerator's formula and its log (the SFU's), and for K10 the mix. The
// noise is K7's (ddg::gumbel) with K7's rule (ddg::noise_kmax): the noise
// of the column with the largest log q of each thread is formed first, and
// every other column's only where log q + g can beat the best score so far
// (the warp's, for a wide row). The skipped columns lie below that best by
// a margin, so the token is that of the noise formed everywhere, the
// lowest index winning ties.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;  // rows a block of the wide kernel
constexpr int kNarrowRows = kThreads;         // rows a block of the narrow kernel
constexpr int kWideCols = 8;                  // a lane's columns a turn
constexpr int kTurn = 32 * kWideCols;         // a warp's columns a turn
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// The kernel of a call (`plan`).
enum Kernel : int { kNarrow = 1, kWideOne = 2, kWideTurns = 3 };

// Columns v0 .. v0 + 7 of a row as fp32; columns at or past V read as kNeg.
template <typename T, bool kVec>
__device__ __forceinline__ void load_cols(const T* row, int v0, int V, float* out) {
  if constexpr (kVec) {
    if constexpr (sizeof(T) == 2) {
      ddg::load16(reinterpret_cast<const __nv_bfloat16*>(row) + v0, out);
    } else {
      ddg::load_f32<kWideCols>(reinterpret_cast<const float*>(row) + v0, out);
    }
  } else {
#pragma unroll
    for (int c = 0; c < kWideCols; ++c)
      out[c] = v0 + c < V ? ddg::to_f32(row[v0 + c]) : kNeg;
  }
}

// Per-row constants of the numerator.
struct Num {
  float a;     // a_s - a_t
  float axt;   // a_t * vocab_size
  float bxt;   // a_t / a_s - a_t
  float c;     // (1 - a_t / a_s) * (1 - a_s) / vocab_size
};

__device__ __forceinline__ Num make_num(float a_t, float a_s, int vocab_size) {
  const float vs = static_cast<float>(vocab_size);
  const float a_ts = __fdiv_rn(a_t, a_s);
  return {__fsub_rn(a_s, a_t), __fmul_rn(a_t, vs), __fsub_rn(a_ts, a_t),
          __fdiv_rn(__fmul_rn(__fsub_rn(1.f, a_ts), __fsub_rn(1.f, a_s)), vs)};
}

// e[c] = 2^((z[c] - m) log2 e) in place (0 where z = -inf); returns their
// sum.
template <int N>
__device__ __forceinline__ float exps(float (&z)[N], float m) {
  const float ml = m * kLog2e;
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < N; ++c) {
    z[c] = ddg::ex2(__fmaf_rn(z[c], kLog2e, -ml));
    s += z[c];
  }
  return s;
}

// e[c] (an exp of column v0 + c's logit less the row max) becomes that
// column's log(num + 1e-35), p = e / sum being its probability; `inv` is
// 1 / sum.
template <int N>
__device__ __forceinline__ void log_nums(float (&e)[N], float inv, int v0, int tok,
                                         const Num& k) {
#pragma unroll
  for (int c = 0; c < N; ++c) {
    const float x = v0 + c == tok ? 1.f : 0.f;
    const float p = __fmul_rn(e[c], inv);
    const float num = __fadd_rn(
        __fadd_rn(__fmul_rn(p, __fadd_rn(k.a, __fmul_rn(x, k.axt))), __fmul_rn(x, k.bxt)), k.c);
    e[c] = __logf(__fadd_rn(num, 1e-35f));
  }
}

// gamma * a + (1 - gamma) * b: K10's mix of the two log numerators.
template <int N>
__device__ __forceinline__ void mix(float (&a)[N], const float (&b)[N], float gamma, float omg) {
#pragma unroll
  for (int c = 0; c < N; ++c) a[c] = __fadd_rn(__fmul_rn(gamma, a[c]), __fmul_rn(omg, b[c]));
}

// Keep (sc, v) if it beats (best, best_i), the lower index winning ties.
__device__ __forceinline__ void take(float& best, int& best_i, float sc, int v) {
  if (sc > best || (sc == best && v < best_i)) {
    best = sc;
    best_i = v;
  }
}

// The Philox words of columns v0 .. v0 + 4 n - 1 of row (b, l) (v0 a
// multiple of 4), calls past column `end` skipped.
template <int N>
__device__ __forceinline__ void words(unsigned (&w)[N], int v0, int end, int l, int b,
                                      uint2 key) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    if (v0 + 4 * q >= end) continue;
    const uint4 r = ddg::philox4x32_10(
        make_uint4(static_cast<unsigned>((v0 >> 2) + q), static_cast<unsigned>(l),
                   static_cast<unsigned>(b), 0u),
        key);
    w[4 * q] = r.x;
    w[4 * q + 1] = r.y;
    w[4 * q + 2] = r.z;
    w[4 * q + 3] = r.w;
  }
}

// The noise of a thread's column of the largest lq among v0 + c (c < N,
// v0 + c < n), always formed, into (best, best_i); returns that c, or -1.
template <int N>
__device__ __forceinline__ int pick_first(const float (&lq)[N], const unsigned (&w)[N], int v0,
                                          int n, float& best, int& best_i) {
  int cm = -1;
  float lm = -INFINITY;
  unsigned wm = 0u;
#pragma unroll
  for (int c = 0; c < N; ++c)
    if (v0 + c < n && lq[c] > lm) {
      lm = lq[c];
      wm = w[c];
      cm = c;
    }
  if (cm >= 0) take(best, best_i, __fadd_rn(lm, ddg::gumbel(wm)), v0 + cm);
  return cm;
}

// The other columns' noise (c != skip), formed only where it can beat
// max(floor, best) (`floor`: a score some column of the row reached), one
// bound for the thread's columns from the largest of their lq.
template <int N>
__device__ __forceinline__ void pick_rest(const float (&lq)[N], const unsigned (&w)[N], int v0,
                                          int n, int skip, float floor, float& best,
                                          int& best_i) {
  float vm = -INFINITY;
#pragma unroll
  for (int c = 0; c < N; ++c)
    if (v0 + c < n && c != skip) vm = fmaxf(vm, lq[c]);
  const int kmax = ddg::noise_kmax(fmaxf(floor, best), vm);
  // The columns whose noise can win, this thread's (fm) and its warp's
  // (wm: a column no lane forms is skipped by the whole warp).
  unsigned fm = 0u;
#pragma unroll
  for (int c = 0; c < N; ++c)
    if (v0 + c < n && c != skip && static_cast<int>(w[c] >> 8) > kmax) fm |= 1u << c;
  const unsigned wm = __reduce_or_sync(__activemask(), fm);
#pragma unroll
  for (int c = 0; c < N; ++c)
    if ((wm >> c) & 1u) {
      if ((fm >> c) & 1u) take(best, best_i, __fadd_rn(lq[c], ddg::gumbel(w[c])), v0 + c);
    }
}

// Narrow rows: a thread a row of n <= N columns, held in registers.
template <typename T, int N>
__device__ __forceinline__ void narrow_log_nums(const T* row, int n, int tok, const Num& k,
                                                float (&z)[N]) {
  float m = kNeg;
#pragma unroll
  for (int c = 0; c < N; ++c) {
    z[c] = c < n ? ddg::to_f32(row[c]) : -INFINITY;
    m = fmaxf(m, z[c]);
  }
  log_nums(z, __frcp_rn(exps(z, m)), 0, tok, k);
}

template <typename T, int kIn, bool kExternal, int N>
__global__ void __launch_bounds__(kNarrowRows)
    uniform_narrow_kernel(const int* __restrict__ seed, const int* __restrict__ xt,
                  const T* __restrict__ logits_c, const T* __restrict__ logits_u,
                  const float* __restrict__ alpha_t, const float* __restrict__ alpha_s,
                  const float* __restrict__ gumbel, int* __restrict__ out, int rows, int L, int V,
                  int n, float gamma, float omg) {
  const int row = blockIdx.x * kNarrowRows + threadIdx.x;
  if (row >= rows) return;
  const int b = row / L, l = row - b * L;
  const size_t base = static_cast<size_t>(row) * V;
  const Num k = make_num(alpha_t[b], alpha_s[b], n);
  const int tok = xt[row];
  float lq[N];
  narrow_log_nums<T, N>(logits_c + base, n, tok, k, lq);
  if constexpr (kIn == 2) {
    float lu[N];
    narrow_log_nums<T, N>(logits_u + base, n, tok, k, lu);
    mix(lq, lu, gamma, omg);
  }
  float best = -INFINITY;
  int best_i = 0x7fffffff;
  if (kExternal) {
#pragma unroll
    for (int c = 0; c < N; ++c)
      if (c < n) take(best, best_i, __fadd_rn(lq[c], gumbel[base + c]), c);
  } else {
    unsigned w[N];
    words(w, 0, n, l, b, make_uint2(static_cast<unsigned>(seed[0]), 0u));
    const int first = pick_first(lq, w, 0, n, best, best_i);
    pick_rest(lq, w, 0, n, first, -INFINITY, best, best_i);
  }
  out[row] = best_i;
}

// Wide rows: a warp a row, a lane 8 consecutive columns of each turn of
// 256; kOne: one turn (n <= 256), read once and kept in registers; else
// the row max and sum of exps first, then the row read again. Columns past
// n read as -inf.
template <typename T, bool kVec>
__device__ __forceinline__ void load_valid(const T* row, int v0, int V, int n,
                                           float (&z)[kWideCols]) {
  load_cols<T, kVec>(row, v0, V, z);
#pragma unroll
  for (int c = 0; c < kWideCols; ++c)
    if (v0 + c >= n) z[c] = -INFINITY;
}

__device__ __forceinline__ float max_of(const float (&z)[kWideCols]) {
  float m = kNeg;
#pragma unroll
  for (int c = 0; c < kWideCols; ++c) m = fmaxf(m, z[c]);
  return m;
}

// The row max and sum of exps of one tensor over every turn (more than
// one), each lane's online pair merged over the warp.
template <typename T, bool kVec>
__device__ __forceinline__ void row_ms(const T* row, int turns, int lane, int V, int n,
                                       float& m, float& s) {
  m = kNeg;
  s = 0.f;
  for (int t = 0; t < turns; ++t) {
    float z[kWideCols];
    load_valid<T, kVec>(row, t * kTurn + lane * kWideCols, V, n, z);
    const float nm = fmaxf(m, max_of(z));
    s = s * ddg::ex2((m - nm) * kLog2e) + exps(z, nm);
    m = nm;
  }
  ddg::warp_merge_ms(m, s);
}

template <typename T, int kIn, bool kExternal, bool kVec, bool kOne>
__global__ void __launch_bounds__(kThreads)
    uniform_wide_kernel(const int* __restrict__ seed, const int* __restrict__ xt,
                const T* __restrict__ logits_c, const T* __restrict__ logits_u,
                const float* __restrict__ alpha_t, const float* __restrict__ alpha_s,
                const float* __restrict__ gumbel, int* __restrict__ out, int rows, int L, int V,
                int n, float gamma, float omg) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int b = row / L, l = row - b * L;
  const size_t base = static_cast<size_t>(row) * V;
  const T* lc = logits_c + base;
  const T* lu = kIn == 2 ? logits_u + base : nullptr;
  const Num k = make_num(alpha_t[b], alpha_s[b], n);
  const int tok = xt[row];
  const int turns = kOne ? 1 : (n + kTurn - 1) / kTurn;

  // The row max and sum of exps of each tensor.
  float zc[kWideCols], zu[kWideCols];
  float mc, sc, mu = 0.f, su = 1.f;
  if (kOne) {
    load_valid<T, kVec>(lc, lane * kWideCols, V, n, zc);
    if (kIn == 2) load_valid<T, kVec>(lu, lane * kWideCols, V, n, zu);
    mc = ddg::warp_max(max_of(zc));
    sc = ddg::warp_sum(exps(zc, mc));
    if (kIn == 2) {
      mu = ddg::warp_max(max_of(zu));
      su = ddg::warp_sum(exps(zu, mu));
    }
  } else {
    row_ms<T, kVec>(lc, turns, lane, V, n, mc, sc);
    if (kIn == 2) row_ms<T, kVec>(lu, turns, lane, V, n, mu, su);
  }
  const float ic = __frcp_rn(sc), iu = __frcp_rn(su);

  const uint2 key = make_uint2(kExternal ? 0u : static_cast<unsigned>(seed[0]), 0u);
  const float* g_row = kExternal ? gumbel + base : nullptr;
  float best = -INFINITY;
  int best_i = 0x7fffffff;
  for (int t = 0; t < turns; ++t) {
    const int v0 = t * kTurn + lane * kWideCols;
    if (!kOne) {
      load_valid<T, kVec>(lc, v0, V, n, zc);
      exps(zc, mc);
      if (kIn == 2) {
        load_valid<T, kVec>(lu, v0, V, n, zu);
        exps(zu, mu);
      }
    }
    log_nums(zc, ic, v0, tok, k);
    if (kIn == 2) {
      log_nums(zu, iu, v0, tok, k);
      mix(zc, zu, gamma, omg);
    }
    if (kExternal) {
      float g[kWideCols];
      load_cols<float, kVec>(g_row, v0, V, g);
#pragma unroll
      for (int c = 0; c < kWideCols; ++c)
        if (v0 + c < n) take(best, best_i, __fadd_rn(zc[c], g[c]), v0 + c);
    } else {
      unsigned w[kWideCols];
      words(w, v0, n, l, b, key);
      // Each lane's column of the largest lq first, then the rest against
      // the warp's best.
      const int first = t == 0 ? pick_first(zc, w, v0, n, best, best_i) : -1;
      pick_rest(zc, w, v0, n, first, ddg::warp_max(best), best, best_i);
    }
  }
  ddg::warp_argmax(best, best_i);
  if (lane == 0) out[row] = best_i;
}

// How a call runs, from its shape alone: a thread a row where the
// vocabulary is at most 32 columns (12, 16 or 32 held), else a warp a row
// (one turn of 256 columns, or more). vec: V % 8 == 0 and every row 16-byte
// aligned, so the wide kernel loads 16-byte vectors. The same plan serves
// one logits tensor (K9) and two (K10). ops/fused_sampling.py's
// `uniform_plan` mirrors it, and chip_smoke.py holds the two equal through
// `ddg_uniform_plan`.
struct Plan {
  int kernel, rows, cols, vec;
};

Plan plan(int vocab_size, int vec) {
  if (vocab_size <= 32)
    return {kNarrow, kNarrowRows, vocab_size <= 12 ? 12 : vocab_size <= 16 ? 16 : 32, 0};
  return {vocab_size <= kTurn ? kWideOne : kWideTurns, kRowsPerBlock, kWideCols, vec ? 1 : 0};
}

template <typename T, int kIn, bool kExternal>
int launch_plan(const Plan& p, const int* seed, const int* xt, const T* lc, const T* lu,
                const float* at, const float* as, const float* gumbel, int* out, int rows, int L,
                int V, int vocab_size, float gamma, float omg, cudaStream_t stream) {
  const int blocks = (rows + p.rows - 1) / p.rows;
#define DDG_ARGS seed, xt, lc, lu, at, as, gumbel, out, rows, L, V, vocab_size, gamma, omg
  switch (p.kernel) {
    case kNarrow:
      if (p.cols == 12)
        uniform_narrow_kernel<T, kIn, kExternal, 12>
            <<<blocks, kNarrowRows, 0, stream>>>(DDG_ARGS);
      else if (p.cols == 16)
        uniform_narrow_kernel<T, kIn, kExternal, 16>
            <<<blocks, kNarrowRows, 0, stream>>>(DDG_ARGS);
      else
        uniform_narrow_kernel<T, kIn, kExternal, 32>
            <<<blocks, kNarrowRows, 0, stream>>>(DDG_ARGS);
      break;
    case kWideOne:
      if (p.vec)
        uniform_wide_kernel<T, kIn, kExternal, true, true>
            <<<blocks, kThreads, 0, stream>>>(DDG_ARGS);
      else
        uniform_wide_kernel<T, kIn, kExternal, false, true>
            <<<blocks, kThreads, 0, stream>>>(DDG_ARGS);
      break;
    default:
      if (p.vec)
        uniform_wide_kernel<T, kIn, kExternal, true, false>
            <<<blocks, kThreads, 0, stream>>>(DDG_ARGS);
      else
        uniform_wide_kernel<T, kIn, kExternal, false, false>
            <<<blocks, kThreads, 0, stream>>>(DDG_ARGS);
  }
#undef DDG_ARGS
  return cudaGetLastError();
}

template <typename T, int kIn>
int launch_noise(const Plan& p, const int* seed, const int* xt, const void* lc, const void* lu,
                 const float* at, const float* as, const float* gumbel, int* out, int rows, int L,
                 int V, int vocab_size, float gamma, float omg, cudaStream_t stream) {
  const T* c = static_cast<const T*>(lc);
  const T* u = static_cast<const T*>(lu);
  return gumbel ? launch_plan<T, kIn, true>(p, seed, xt, c, u, at, as, gumbel, out, rows, L, V,
                                            vocab_size, gamma, omg, stream)
                : launch_plan<T, kIn, false>(p, seed, xt, c, u, at, as, gumbel, out, rows, L, V,
                                             vocab_size, gamma, omg, stream);
}

template <typename T>
int launch(const Plan& p, bool cfg, const int* seed, const int* xt, const void* lc,
           const void* lu, const float* at, const float* as, const float* gumbel, int* out,
           int rows, int L, int V, int vocab_size, float gamma, float omg, cudaStream_t stream) {
  return cfg ? launch_noise<T, 2>(p, seed, xt, lc, lu, at, as, gumbel, out, rows, L, V,
                                  vocab_size, gamma, omg, stream)
             : launch_noise<T, 1>(p, seed, xt, lc, lu, at, as, gumbel, out, rows, L, V,
                                  vocab_size, gamma, omg, stream);
}

}  // namespace

// vec: 1 when V % 8 == 0 and every row pointer is 16-byte aligned (the
// wrapper checks), for vector loads; cfg: 1 for K10 (logits_u given).
extern "C" int ddg_uniform_sample(const void* seed, const void* xt, const void* logits_c,
                                  const void* logits_u, const void* alpha_t, const void* alpha_s,
                                  const void* gumbel, void* out, int rows, int L, int V,
                                  int vocab_size, float gamma, float one_minus_gamma, int cfg,
                                  int dtype, int vec, void* stream) {
  if (rows <= 0 || L <= 0 || rows % L || V <= 0 || vocab_size <= 0 || vocab_size > V ||
      (cfg && !logits_u) || (vec && V % kWideCols))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto sd = static_cast<const int*>(seed);
  auto x = static_cast<const int*>(xt);
  auto at = static_cast<const float*>(alpha_t);
  auto as = static_cast<const float*>(alpha_s);
  auto g = static_cast<const float*>(gumbel);
  auto o = static_cast<int*>(out);
  const Plan p = plan(vocab_size, vec);
  if (dtype == ddg::kF32)
    return launch<float>(p, cfg, sd, x, logits_c, logits_u, at, as, g, o, rows, L, V,
                         vocab_size, gamma, one_minus_gamma, s);
  if (dtype == ddg::kBF16)
    return launch<__nv_bfloat16>(p, cfg, sd, x, logits_c, logits_u, at, as, g, o, rows, L, V,
                                 vocab_size, gamma, one_minus_gamma, s);
  return cudaErrorInvalidValue;
}

// The plan of a call (`plan`) into out[0..3]: kernel (1 narrow; 2, 3 wide
// with one turn or more), rows a block, columns a thread (a turn's, for the
// wide kernel), vector loads.
extern "C" void ddg_uniform_plan(int vocab_size, int vec, int* out) {
  const Plan p = plan(vocab_size, vec);
  out[0] = p.kernel;
  out[1] = p.rows;
  out[2] = p.cols;
  out[3] = p.vec;
}
