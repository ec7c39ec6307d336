// Fused uniform-state (UDLM) denoise step: softmax + posterior numerator +
// log + Gumbel-argmax, in one kernel per step.
//
// Replaces the TPU kernels in ddg_tpu/ops/fused_sampling.py (both reach
// pl.pallas_call through _uniform_call, :366-398):
//   fused_uniform_sample     -> _uniform_kernel
//   fused_uniform_cfg_sample -> _uniform_cfg_kernel
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
// Bound on the H100: at the main path's shape (B=32, L=3072, V=256, bf16)
// the step reads 50.3 MB of logits (100.7 MB for CFG), 0.015 / 0.030 ms at
// 3.35 TB/s. Each logit also costs two exps and a log of the numerator
// (twice that for CFG) and the two logs of its Gumbel draw: 5 (8) SFU
// operations, which at 16 a clock per SM take longer than the bytes.
//
// Design: one warp per row, 8 rows per block of 256 threads. A lane takes
// 8 consecutive columns at a time (one 16-byte load of bf16 logits when
// V % 8 == 0, else scalar loads with bounds), so one pair of Philox calls
// gives its 8 uniforms. Pass 1 keeps a per-lane online max-and-sum,
// merged across the warp by shuffles into the LSE; pass 2 reads the row
// again (from L1: a 256-column bf16 row is 512 bytes) and keeps a
// per-lane (score, index) maximum, merged across the warp with the lowest
// index winning ties. Any V and vocab_size <= V work.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kCols = 8;
constexpr float kNeg = -1e30f;

// Columns v0 .. v0 + 7 of a row as fp32; columns at or past V read as kNeg.
template <typename T, bool kVec>
__device__ __forceinline__ void load_cols(const T* row, int v0, int V, float* out) {
  if constexpr (kVec) {
    if constexpr (sizeof(T) == 2) {
      ddg::load16(reinterpret_cast<const __nv_bfloat16*>(row) + v0, out);
    } else {
      ddg::load_f32<kCols>(reinterpret_cast<const float*>(row) + v0, out);
    }
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      out[c] = v0 + c < V ? ddg::to_f32(row[v0 + c]) : kNeg;
  }
}

// The LSE of a row over its first `n_valid` columns, on every lane.
template <typename T, bool kVec>
__device__ __forceinline__ float row_lse(const T* row, int V, int n_valid, int lane) {
  float m = kNeg, s = 0.f;
  for (int v0 = lane * kCols; v0 < V; v0 += 32 * kCols) {
    float z[kCols];
    load_cols<T, kVec>(row, v0, V, z);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (v0 + c >= n_valid) continue;
      if (z[c] > m) {
        s = s * expf(m - z[c]) + 1.f;
        m = z[c];
      } else {
        s += expf(z[c] - m);
      }
    }
  }
  ddg::warp_merge_ms(m, s);
  return m + logf(s);
}

// Per-row constants of the numerator.
struct Num {
  float a;     // a_s - a_t
  float axt;   // a_t * vocab_size
  float bxt;   // a_t / a_s - a_t
  float c;     // (1 - a_t / a_s) * (1 - a_s) / vocab_size
};

__device__ __forceinline__ float log_num(float z, float lse, bool is_xt, const Num& k) {
  const float p = expf(__fsub_rn(z, lse));
  const float x = is_xt ? 1.f : 0.f;
  const float num = __fadd_rn(
      __fadd_rn(__fmul_rn(p, __fadd_rn(k.a, __fmul_rn(x, k.axt))), __fmul_rn(x, k.bxt)), k.c);
  return logf(__fadd_rn(num, 1e-35f));
}

template <typename T, bool kCfg, bool kExternal, bool kVec>
__global__ void __launch_bounds__(kThreads)
    uniform_sample_kernel(const int* __restrict__ seed, const int* __restrict__ xt,
                          const T* __restrict__ logits_c, const T* __restrict__ logits_u,
                          const float* __restrict__ alpha_t, const float* __restrict__ alpha_s,
                          const float* __restrict__ gumbel, int* __restrict__ out, int rows,
                          int L, int V, int vocab_size, float gamma, float omg) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int b = row / L, l = row % L;
  const size_t base = static_cast<size_t>(row) * V;
  const T* lc = logits_c + base;
  const T* lu = kCfg ? logits_u + base : nullptr;
  const int n_valid = min(vocab_size, V);

  const float lse_c = row_lse<T, kVec>(lc, V, n_valid, lane);
  const float lse_u = kCfg ? row_lse<T, kVec>(lu, V, n_valid, lane) : 0.f;

  const float a_t = alpha_t[b], a_s = alpha_s[b];
  const float vs = static_cast<float>(vocab_size);
  const float a_ts = __fdiv_rn(a_t, a_s);
  const Num k = {__fsub_rn(a_s, a_t), __fmul_rn(a_t, vs), __fsub_rn(a_ts, a_t),
                 __fdiv_rn(__fmul_rn(__fsub_rn(1.f, a_ts), __fsub_rn(1.f, a_s)), vs)};
  const int tok = xt[row];

  const uint2 key = make_uint2(kExternal ? 0u : static_cast<unsigned>(seed[0]), 0u);
  const float* g_row = kExternal ? gumbel + base : nullptr;
  float best = -INFINITY;
  int best_i = 0x7fffffff;
  for (int v0 = lane * kCols; v0 < n_valid; v0 += 32 * kCols) {
    float zc[kCols], zu[kCols], g[kCols];
    load_cols<T, kVec>(lc, v0, V, zc);
    if (kCfg) load_cols<T, kVec>(lu, v0, V, zu);
    if (kExternal) {
      load_cols<float, kVec>(g_row, v0, V, g);
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 r = ddg::philox4x32_10(
            make_uint4(static_cast<unsigned>((v0 >> 2) + h), static_cast<unsigned>(l),
                       static_cast<unsigned>(b), 0u),
            key);
        g[4 * h] = ddg::gumbel_from_bits(r.x);
        g[4 * h + 1] = ddg::gumbel_from_bits(r.y);
        g[4 * h + 2] = ddg::gumbel_from_bits(r.z);
        g[4 * h + 3] = ddg::gumbel_from_bits(r.w);
      }
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int v = v0 + c;
      if (v >= n_valid) continue;
      float lq = log_num(zc[c], lse_c, v == tok, k);
      if (kCfg)
        lq = __fadd_rn(__fmul_rn(gamma, lq), __fmul_rn(omg, log_num(zu[c], lse_u, v == tok, k)));
      const float score = __fadd_rn(lq, g[c]);
      if (score > best) {
        best = score;
        best_i = v;
      }
    }
  }
  ddg::warp_argmax(best, best_i);
  if (lane == 0) out[row] = best_i;
}

template <typename T, bool kCfg, bool kExternal>
int launch_vec(bool vec, const int* seed, const int* xt, const T* lc, const T* lu,
               const float* at, const float* as, const float* gumbel, int* out, int rows, int L,
               int V, int vocab_size, float gamma, float omg, cudaStream_t stream) {
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (vec) {
    uniform_sample_kernel<T, kCfg, kExternal, true><<<blocks, kThreads, 0, stream>>>(
        seed, xt, lc, lu, at, as, gumbel, out, rows, L, V, vocab_size, gamma, omg);
  } else {
    uniform_sample_kernel<T, kCfg, kExternal, false><<<blocks, kThreads, 0, stream>>>(
        seed, xt, lc, lu, at, as, gumbel, out, rows, L, V, vocab_size, gamma, omg);
  }
  return cudaGetLastError();
}

template <typename T, bool kCfg>
int launch(bool vec, const int* seed, const int* xt, const void* lc, const void* lu,
           const float* at, const float* as, const float* gumbel, int* out, int rows, int L,
           int V, int vocab_size, float gamma, float omg, cudaStream_t stream) {
  const T* c = static_cast<const T*>(lc);
  const T* u = static_cast<const T*>(lu);
  return gumbel ? launch_vec<T, kCfg, true>(vec, seed, xt, c, u, at, as, gumbel, out, rows, L,
                                            V, vocab_size, gamma, omg, stream)
                : launch_vec<T, kCfg, false>(vec, seed, xt, c, u, at, as, gumbel, out, rows, L,
                                             V, vocab_size, gamma, omg, stream);
}

}  // namespace

// vec: 1 when V % 8 == 0 and every row pointer is 16-byte aligned (the
// wrapper checks), for vector loads.
extern "C" int ddg_uniform_sample(const void* seed, const void* xt, const void* logits_c,
                                  const void* logits_u, const void* alpha_t, const void* alpha_s,
                                  const void* gumbel, void* out, int rows, int L, int V,
                                  int vocab_size, float gamma, float one_minus_gamma, int cfg,
                                  int dtype, int vec, void* stream) {
  if (rows <= 0 || L <= 0 || rows % L || V <= 0 || vocab_size <= 0 || vocab_size > V ||
      (cfg && !logits_u) || (vec && V % kCols))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto sd = static_cast<const int*>(seed);
  auto x = static_cast<const int*>(xt);
  auto at = static_cast<const float*>(alpha_t);
  auto as = static_cast<const float*>(alpha_s);
  auto g = static_cast<const float*>(gumbel);
  auto o = static_cast<int*>(out);
  const bool v = vec != 0;
  if (dtype == ddg::kF32) {
    return cfg ? launch<float, true>(v, sd, x, logits_c, logits_u, at, as, g, o, rows, L, V,
                                     vocab_size, gamma, one_minus_gamma, s)
               : launch<float, false>(v, sd, x, logits_c, logits_u, at, as, g, o, rows, L, V,
                                      vocab_size, gamma, one_minus_gamma, s);
  }
  if (dtype == ddg::kBF16) {
    return cfg ? launch<__nv_bfloat16, true>(v, sd, x, logits_c, logits_u, at, as, g, o, rows, L,
                                             V, vocab_size, gamma, one_minus_gamma, s)
               : launch<__nv_bfloat16, false>(v, sd, x, logits_c, logits_u, at, as, g, o, rows,
                                              L, V, vocab_size, gamma, one_minus_gamma, s);
  }
  return cudaErrorInvalidValue;
}
