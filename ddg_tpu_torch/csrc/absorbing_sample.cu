// Fused absorbing-state denoise step: SUBS + posterior + Gumbel-argmax +
// copy-over, in one kernel per step.
//
// Replaces the TPU kernels in ddg_tpu/ops/fused_sampling.py:
//   fused_absorbing_sample     -> _absorbing_kernel (pallas_call :226)
//   fused_absorbing_cfg_sample -> _cfg_kernel       (pallas_call :281)
// For each (b, l) row, over the vocabulary v < V:
//   z_v     = logits_v            (cfg: gamma * lc_v + (1 - gamma) * lu_v, fp32)
//   z_mask  = -1e30               (SUBS: the mask channel gets no mass)
//   lse     = log sum_v exp(z_v)
//   score_v = z_v - lse + log(mct - mcs) for v != mask;  log(mcs) at the mask
//   xs      = argmax_v score_v + g_v, the lowest index winning ties
//   out     = xt where xt != mask (copy-over), else xs
// g is standard Gumbel noise, either read from a (B, L, V) fp32 tensor or
// made here by a Philox4x32-10 counter keyed on (seed; v / 4, l, b): the
// uniform is built from the top 24 bits, u = top24 / 2^24 + 1e-10, and
// g = -log(-log(u)), as the TPU kernel's _gumbel does.
//
// Bound on the H100: bytes. The step reads each masked row of the bf16
// logits (61 KB a row at V = 30523; 187.5 MB at B=24, L=128 when every
// token is masked), and its arithmetic (an exp, a Philox call per 4
// columns and two logs per column) stays under the byte time.
//
// Design: one block of 256 threads per row. A row whose token is already
// decoded writes it and exits without reading its logits: the output does
// not depend on them, so the bytes a step moves fall as decoding proceeds.
// Pass 1 reads the row once with coalesced scalar loads (an odd V leaves
// bf16 rows without 16-byte alignment) and keeps a per-thread online
// max-and-sum, reduced across the block to the LSE. Pass 2 reads the row
// again, mostly from L2, each thread taking 4 consecutive columns per step
// so one Philox call gives their 4 uniforms, and keeps a per-thread
// (score, index) maximum, reduced across the block with the lowest index
// winning ties.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;

template <typename T, bool kCfg>
__device__ __forceinline__ float mixed(const T* lc, const T* lu, int v, float gamma, float omg) {
  const float c = ddg::to_f32(lc[v]);
  if (!kCfg) return c;
  return __fadd_rn(__fmul_rn(gamma, c), __fmul_rn(omg, ddg::to_f32(lu[v])));
}

template <typename T, bool kCfg, bool kExternal>
__global__ void __launch_bounds__(kThreads)
    absorbing_sample_kernel(const int* __restrict__ seed, const int* __restrict__ xt,
                            const T* __restrict__ logits_c, const T* __restrict__ logits_u,
                            const float* __restrict__ mct, const float* __restrict__ mcs,
                            const float* __restrict__ gumbel, int* __restrict__ out, int L,
                            int V, int mask_index, float gamma, float omg) {
  const int row = blockIdx.x;
  const int tok = xt[row];
  if (tok != mask_index) {
    if (threadIdx.x == 0) out[row] = tok;
    return;
  }
  const int b = row / L, l = row % L;
  const size_t base = static_cast<size_t>(row) * V;
  const T* lc = logits_c + base;
  const T* lu = kCfg ? logits_u + base : nullptr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __shared__ float sh_a[kWarps], sh_b[kWarps];
  __shared__ int sh_i[kWarps];

  // Pass 1: LSE over the non-mask columns.
  float m = kNeg, s = 0.f;
  for (int v = threadIdx.x; v < V; v += kThreads) {
    if (v == mask_index) continue;
    const float z = mixed<T, kCfg>(lc, lu, v, gamma, omg);
    if (z > m) {
      s = s * expf(m - z) + 1.f;
      m = z;
    } else {
      s += expf(z - m);
    }
  }
  ddg::warp_merge_ms(m, s);
  if (lane == 0) {
    sh_a[warp] = m;
    sh_b[warp] = s;
  }
  __syncthreads();
  m = sh_a[0];
  s = sh_b[0];
  for (int w = 1; w < kWarps; ++w) ddg::merge_ms(m, s, sh_a[w], sh_b[w]);
  const float lse = m + logf(s);
  const float log_move = logf(mct[b] - mcs[b]);
  const float log_stay = logf(mcs[b]);

  // Pass 2: perturbed argmax.
  const uint2 key = make_uint2(kExternal ? 0u : static_cast<unsigned>(seed[0]), 0u);
  const float* g_row = kExternal ? gumbel + base : nullptr;
  float best = -INFINITY;
  int best_i = 0x7fffffff;
  for (int v0 = threadIdx.x * 4; v0 < V; v0 += kThreads * 4) {
    unsigned bits[4] = {0u, 0u, 0u, 0u};
    if (!kExternal) {
      const uint4 r = ddg::philox4x32_10(
          make_uint4(static_cast<unsigned>(v0 >> 2), static_cast<unsigned>(l),
                     static_cast<unsigned>(b), 0u),
          key);
      bits[0] = r.x; bits[1] = r.y; bits[2] = r.z; bits[3] = r.w;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int v = v0 + c;
      if (v >= V) continue;
      const float lq = v == mask_index
                           ? log_stay
                           : __fadd_rn(__fsub_rn(mixed<T, kCfg>(lc, lu, v, gamma, omg), lse),
                                       log_move);
      const float g = kExternal ? g_row[v] : ddg::gumbel_from_bits(bits[c]);
      const float score = __fadd_rn(lq, g);
      if (score > best) {
        best = score;
        best_i = v;
      }
    }
  }
  ddg::warp_argmax(best, best_i);
  __syncthreads();  // sh_a is reused
  if (lane == 0) {
    sh_a[warp] = best;
    sh_i[warp] = best_i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) ddg::merge_arg(best, best_i, sh_a[w], sh_i[w]);
    out[row] = best_i;
  }
}

template <typename T, bool kCfg>
int launch(const int* seed, const int* xt, const void* lc, const void* lu, const float* mct,
           const float* mcs, const float* gumbel, int* out, int rows, int L, int V,
           int mask_index, float gamma, float omg, cudaStream_t stream) {
  const T* c = static_cast<const T*>(lc);
  const T* u = static_cast<const T*>(lu);
  if (gumbel) {
    absorbing_sample_kernel<T, kCfg, true><<<rows, kThreads, 0, stream>>>(
        seed, xt, c, u, mct, mcs, gumbel, out, L, V, mask_index, gamma, omg);
  } else {
    absorbing_sample_kernel<T, kCfg, false><<<rows, kThreads, 0, stream>>>(
        seed, xt, c, u, mct, mcs, gumbel, out, L, V, mask_index, gamma, omg);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int ddg_absorbing_sample(const void* seed, const void* xt, const void* logits_c,
                                    const void* logits_u, const void* mct, const void* mcs,
                                    const void* gumbel, void* out, int rows, int L, int V,
                                    int mask_index, float gamma, float one_minus_gamma, int cfg,
                                    int dtype, void* stream) {
  if (rows <= 0 || L <= 0 || rows % L || V <= 0 || mask_index < 0 || mask_index >= V ||
      (cfg && !logits_u))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto sd = static_cast<const int*>(seed);
  auto x = static_cast<const int*>(xt);
  auto t = static_cast<const float*>(mct);
  auto u = static_cast<const float*>(mcs);
  auto g = static_cast<const float*>(gumbel);
  auto o = static_cast<int*>(out);
  if (dtype == ddg::kF32) {
    return cfg ? launch<float, true>(sd, x, logits_c, logits_u, t, u, g, o, rows, L, V,
                                     mask_index, gamma, one_minus_gamma, s)
               : launch<float, false>(sd, x, logits_c, logits_u, t, u, g, o, rows, L, V,
                                      mask_index, gamma, one_minus_gamma, s);
  }
  if (dtype == ddg::kBF16) {
    return cfg ? launch<__nv_bfloat16, true>(sd, x, logits_c, logits_u, t, u, g, o, rows, L, V,
                                             mask_index, gamma, one_minus_gamma, s)
               : launch<__nv_bfloat16, false>(sd, x, logits_c, logits_u, t, u, g, o, rows, L,
                                              V, mask_index, gamma, one_minus_gamma, s);
  }
  return cudaErrorInvalidValue;
}
