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
// logits once (61 KB a row at V = 30523; 187.5 MB at B=24, L=128 when
// every token is masked, 0.056 ms; twice that under CFG). The work that
// any exact kernel must do a logit, the Philox words, the compare of
// their top bits, one exp2 and the LSE's max and add (about 15 integer and
// fp32 instructions), takes less: forming every logit's noise (two logs
// more) is not needed, as the design below shows.
//
// Design: one block a row, kRowWarps warps, each a contiguous run of the
// row's column groups. A row whose token is already decoded writes it and
// exits without reading its logits. The row is read once: 16-byte loads
// of aligned vectors (8 bf16 or 4 fp32 columns), one vector ahead. A
// lane's group starts at a column that is a multiple of 4, so that one
// Philox call gives the words of 4 columns; where the row is not 16-byte
// aligned the group takes the tail of the lane's vector and the head of
// the next lane's (a shuffle, then a funnel shift). Per group each thread
// takes the max of its z first, then one exp2 a column (ex2.approx of the
// pre-scaled z - max: the LSE's online max-and-sum without a branch), and
// the best z + g over the group's non-mask columns against its running
// best, the first group kept on ties: the argmax of z + g is that of the
// score, since lse and log_move are constants of the row. The noise of a
// column is formed only where it could beat the warp's best z + g so far
// (g <= -log(1 - u), so its Philox word's top 24 bits decide; past each
// warp's first turn few columns pass at V = 30523); the skipped columns
// lie below that best by a margin, so the tokens are those of the noise
// formed everywhere, bit for bit. The inner log of the noise is a
// polynomial, the outer one the SFU's (g within ~2e-6 of -log(-log u) in
// float64). The lanes, then the warps, merge both in a fixed order (no
// atomics). The winning group is formed again, bit for bit, by 8 lanes;
// its first column with the best z + g is the winner, scored as
// ((z - lse) + log_move) + g against the mask column's log_stay + g_mask,
// the lower index winning a tie.

#include "common.cuh"
#include "wgmma.cuh"  // ex2, kLog2e, kNeg

namespace {

constexpr int kRowWarps = 8;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ unsigned word_of(uint4 r, int i) {
  return (i & 2) ? ((i & 1) ? r.w : r.z) : ((i & 1) ? r.y : r.x);
}

__device__ __forceinline__ uint4 ld16(const char* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// The first n words of lane src's x.
template <int n>
__device__ __forceinline__ uint4 shfl_words(uint4 x, int src) {
  uint4 h = make_uint4(0u, 0u, 0u, 0u);
  h.x = __shfl_sync(0xffffffffu, x.x, src);
  if (n > 1) h.y = __shfl_sync(0xffffffffu, x.y, src);
  if (n > 2) h.z = __shfl_sync(0xffffffffu, x.z, src);
  if (n > 3) h.w = __shfl_sync(0xffffffffu, x.w, src);
  return h;
}

template <typename T> struct Cols;
template <> struct Cols<float> {
  static constexpr int N = 4;
  static constexpr int kHead = 3;  // words of the next vector a group can take
  // Columns s..s+3 of the 8 columns (cur, head); s < 4.
  static __device__ __forceinline__ uint4 shift(uint4 c, uint4 h, int s) {
    const unsigned w[8] = {c.x, c.y, c.z, c.w, h.x, h.y, h.z, h.w};
    unsigned t[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) t[k] = (s & 2) ? w[k + 2] : w[k];
#pragma unroll
    for (int k = 0; k < 5; ++k) t[k] = (s & 1) ? t[k + 1] : t[k];
    return make_uint4(t[0], t[1], t[2], t[3]);
  }
  static __device__ __forceinline__ void unpack(uint4 v, float* z) {
    z[0] = __uint_as_float(v.x);
    z[1] = __uint_as_float(v.y);
    z[2] = __uint_as_float(v.z);
    z[3] = __uint_as_float(v.w);
  }
};
template <> struct Cols<__nv_bfloat16> {
  static constexpr int N = 8;
  static constexpr int kHead = 2;
  // Columns s..s+7 of the 16 columns (cur, head); s < 4: a word shift of
  // s / 2, then a half-word funnel shift where s is odd.
  static __device__ __forceinline__ uint4 shift(uint4 c, uint4 h, int s) {
    const unsigned w[6] = {c.x, c.y, c.z, c.w, h.x, h.y};
    unsigned t[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) t[k] = (s & 2) ? w[k + 1] : w[k];
    const unsigned sh = (s & 1) * 16;
    return make_uint4(__funnelshift_r(t[0], t[1], sh), __funnelshift_r(t[1], t[2], sh),
                      __funnelshift_r(t[2], t[3], sh), __funnelshift_r(t[3], t[4], sh));
  }
  static __device__ __forceinline__ void unpack(uint4 v, float* z) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      z[2 * k] = __uint_as_float(w[k] << 16);
      z[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
};

// z of one column, as the vector path forms it.
template <typename T, bool kCfg>
__device__ __forceinline__ float mixed(const T* lc, const T* lu, int v, float gamma, float omg) {
  const float c = ddg::to_f32(lc[v]);
  if (!kCfg) return c;
  return __fadd_rn(__fmul_rn(gamma, c), __fmul_rn(omg, ddg::to_f32(lu[v])));
}

// The vectors of one logits row: M_m holds columns [N m - a, N m - a + N)
// from a 16-byte-aligned address; loadable while its first column is < V.
struct RowVecs {
  const char* base;
  int end;  // vectors m < end hold a column of the row
};

template <typename T>
__device__ __forceinline__ RowVecs row_vecs(const T* p, int a, int V) {
  constexpr int N = Cols<T>::N;
  return {reinterpret_cast<const char*>(p) - a * static_cast<int>(sizeof(T)), (V + a + N - 1) / N};
}

__device__ __forceinline__ uint4 load_vec(const RowVecs& r, int m, int last) {
  return (m <= last && m < r.end) ? ld16(r.base + 16 * static_cast<size_t>(m))
                                  : make_uint4(0u, 0u, 0u, 0u);
}

// kUVec: lu shares lc's 16-byte alignment and is read as vectors too;
// else (a pair whose addresses differ by no multiple of 16) column by
// column.
template <typename T, bool kCfg, bool kExternal, bool kUVec>
__global__ void __launch_bounds__(kRowWarps * 32)
    absorbing_sample_kernel(const int* __restrict__ seed, const int* __restrict__ xt,
                            const T* __restrict__ logits_c, const T* __restrict__ logits_u,
                            const float* __restrict__ mct, const float* __restrict__ mcs,
                            const float* __restrict__ gumbel_in, int* __restrict__ out, int L,
                            int V, int mask_index, float gamma, float omg) {
  constexpr int N = Cols<T>::N;
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
  const float* g_row = kExternal ? gumbel_in + base : nullptr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // Group g covers columns [N g - a0, N g - a0 + N): the tail of M_g from
  // column s on and the head of M_{g+1}.
  const int a = static_cast<int>((reinterpret_cast<uintptr_t>(lc) & 15) / sizeof(T));
  const int s = a & 3, a0 = a - s;
  const int G = (V + a0 + N - 1) / N;
  const int span = (G + kRowWarps - 1) / kRowWarps;
  const int g0 = warp * span, g1 = min(G, g0 + span);
  const RowVecs rc = row_vecs(lc, a, V);
  const RowVecs ru = kCfg && kUVec ? row_vecs(lu, a, V) : rc;
  const uint2 key = make_uint2(kExternal ? 0u : static_cast<unsigned>(seed[0]), 0u);

  float m = kNeg, sum = 0.f;   // online max and sum of exp over the non-mask columns
  float best = -INFINITY;      // the best z + g of this thread's groups
  int best_g = 0x7fffffff;     // and its group
  uint4 cur_c = load_vec(rc, g0 + lane, g1), cur_u = make_uint4(0u, 0u, 0u, 0u);
  if (kCfg && kUVec) cur_u = load_vec(ru, g0 + lane, g1);
  for (int gb = g0; gb < g1; gb += 32) {
    const int g = gb + lane;
    const uint4 nxt_c = load_vec(rc, g + 32, g1);
    uint4 nxt_u = make_uint4(0u, 0u, 0u, 0u);
    if (kCfg && kUVec) nxt_u = load_vec(ru, g + 32, g1);
    uint4 grp_c = cur_c, grp_u = cur_u;
    if (s) {  // the same for the whole block
      const int src = (lane + 1) & 31;
      grp_c = Cols<T>::shift(
          cur_c, shfl_words<Cols<T>::kHead>(lane == 0 ? nxt_c : cur_c, src), s);
      if (kCfg && kUVec)
        grp_u = Cols<T>::shift(
            cur_u, shfl_words<Cols<T>::kHead>(lane == 0 ? nxt_u : cur_u, src), s);
    }
    cur_c = nxt_c;
    cur_u = nxt_u;
    const float wbest = kExternal ? 0.f : ddg::warp_max(best);
    if (g >= g1) continue;

    const int c0 = N * g - a0;
    float z[N];
    Cols<T>::unpack(grp_c, z);
    if (kCfg) {
      float zu[N];
      if (kUVec) {
        Cols<T>::unpack(grp_u, zu);
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const int v = c0 + e;
          zu[e] = (v >= 0 && v < V) ? ddg::to_f32(lu[v]) : 0.f;
        }
      }
#pragma unroll
      for (int e = 0; e < N; ++e)
        z[e] = __fadd_rn(__fmul_rn(gamma, z[e]), __fmul_rn(omg, zu[e]));
    }
    const bool edge = c0 < 0 || c0 + N > V || static_cast<unsigned>(mask_index - c0) < N;
    if (edge) {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const int v = c0 + e;
        if (v < 0 || v >= V || v == mask_index) z[e] = -INFINITY;
      }
    }
    // LSE: the group's max first, then one exp2 a column.
    float vm = z[0];
#pragma unroll
    for (int e = 1; e < N; ++e) vm = fmaxf(vm, z[e]);
    const float mn = fmaxf(m, vm);
    const float mnl = mn * kLog2e;
    float acc = sum * ex2((m - mn) * kLog2e);
#pragma unroll
    for (int e = 0; e < N; ++e) acc += ex2(__fmaf_rn(z[e], kLog2e, -mnl));
    sum = acc;
    m = mn;
    // The noise and the group's best z + g.
    if (kExternal) {
      float sm = -INFINITY;
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const int v = c0 + e;
        sm = fmaxf(sm, __fadd_rn(z[e], (v >= 0 && v < V) ? g_row[v] : 0.f));
      }
      if (sm > best) {
        best = sm;
        best_g = g;
      }
    } else {
      // A column beats the warp's best z + g only if its noise can
      // (ddg::noise_kmax): the columns whose top 24 bits are at most kmax
      // cannot, and their noise is not formed.
      const int kmax = ddg::noise_kmax(wbest, vm);
#pragma unroll
      for (int k = 0; k < N / 4; ++k) {
        const uint4 r = ddg::philox4x32_10(
            make_uint4(static_cast<unsigned>((c0 >> 2) + k), static_cast<unsigned>(l),
                       static_cast<unsigned>(b), 0u),
            key);
        const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (static_cast<int>(w[i] >> 8) > kmax) {
            const float sc = __fadd_rn(z[4 * k + i], ddg::gumbel(w[i]));
            if (sc > best) {
              best = sc;
              best_g = g;
            }
          }
        }
      }
    }
  }

  // Merge the lanes, then the warps in order.
  ddg::warp_merge_ms(m, sum);
  ddg::warp_argmax(best, best_g);
  if (kRowWarps > 1) {
    __shared__ float sh_m[kRowWarps], sh_s[kRowWarps], sh_b[kRowWarps];
    __shared__ int sh_g[kRowWarps];
    if (lane == 0) {
      sh_m[warp] = m;
      sh_s[warp] = sum;
      sh_b[warp] = best;
      sh_g[warp] = best_g;
    }
    __syncthreads();
    if (warp != 0) return;
    m = sh_m[0];
    sum = sh_s[0];
    best = sh_b[0];
    best_g = sh_g[0];
#pragma unroll
    for (int w = 1; w < kRowWarps; ++w) {
      ddg::merge_ms(m, sum, sh_m[w], sh_s[w]);
      ddg::merge_arg(best, best_g, sh_b[w], sh_g[w]);
    }
  }

  // Warp 0: the winning group formed again, one column a lane (the mask
  // column's noise on lane N), its first column with the best z + g.
  if (best_g == 0x7fffffff) {  // no column but the mask
    if (lane == 0) out[row] = mask_index;
    return;
  }
  const int v = lane < N ? N * best_g - a0 + lane : mask_index;
  const bool in = lane < N && v >= 0 && v < V && v != mask_index;
  float zv = -INFINITY, gv = 0.f;
  if (in) zv = mixed<T, kCfg>(lc, lu, v, gamma, omg);
  if (lane <= N && v >= 0 && v < V) {
    if (kExternal) {
      gv = g_row[v];
    } else {
      const uint4 r = ddg::philox4x32_10(
          make_uint4(static_cast<unsigned>(v >> 2), static_cast<unsigned>(l),
                     static_cast<unsigned>(b), 0u),
          key);
      gv = ddg::gumbel(word_of(r, v & 3));
    }
  }
  const unsigned hit = __ballot_sync(kAll, in && __fadd_rn(zv, gv) == best);
  const int e = hit ? __ffs(hit) - 1 : 0;
  const float z_win = __shfl_sync(kAll, zv, e);
  const float g_win = __shfl_sync(kAll, gv, e);
  const float g_mask = __shfl_sync(kAll, gv, N);
  if (lane == 0) {
    const int v_win = N * best_g - a0 + e;
    const float lse = m + logf(sum);
    const float log_move = logf(mct[b] - mcs[b]);
    const float log_stay = logf(mcs[b]);
    const float score = __fadd_rn(__fadd_rn(__fsub_rn(z_win, lse), log_move), g_win);
    const float score_mask = __fadd_rn(log_stay, g_mask);
    const bool win = hit && (score > score_mask || (score == score_mask && v_win < mask_index));
    out[row] = win ? v_win : mask_index;
  }
}

template <typename T, bool kCfg, bool kUVec>
void launch_noise(const int* seed, const int* xt, const T* c, const T* u, const float* mct,
                  const float* mcs, const float* gumbel, int* out, int rows, int L, int V,
                  int mask_index, float gamma, float omg, cudaStream_t stream) {
  if (gumbel) {
    absorbing_sample_kernel<T, kCfg, true, kUVec><<<rows, kRowWarps * 32, 0, stream>>>(
        seed, xt, c, u, mct, mcs, gumbel, out, L, V, mask_index, gamma, omg);
  } else {
    absorbing_sample_kernel<T, kCfg, false, kUVec><<<rows, kRowWarps * 32, 0, stream>>>(
        seed, xt, c, u, mct, mcs, gumbel, out, L, V, mask_index, gamma, omg);
  }
}

template <typename T, bool kCfg>
int launch(const int* seed, const int* xt, const void* lc, const void* lu, const float* mct,
           const float* mcs, const float* gumbel, int* out, int rows, int L, int V,
           int mask_index, float gamma, float omg, cudaStream_t stream) {
  const T* c = static_cast<const T*>(lc);
  const T* u = static_cast<const T*>(lu);
  const bool same_align =
      !kCfg || (reinterpret_cast<uintptr_t>(lc) & 15) == (reinterpret_cast<uintptr_t>(lu) & 15);
  if (same_align) {
    launch_noise<T, kCfg, true>(seed, xt, c, u, mct, mcs, gumbel, out, rows, L, V, mask_index,
                                gamma, omg, stream);
  } else if constexpr (kCfg) {
    launch_noise<T, kCfg, false>(seed, xt, c, u, mct, mcs, gumbel, out, rows, L, V, mask_index,
                                 gamma, omg, stream);
  }
  return cudaGetLastError();
}

__global__ void gumbel_probe_kernel(const unsigned* __restrict__ bits, float* __restrict__ g,
                                    int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) g[i] = ddg::gumbel(bits[i]);
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

// The kernels' Gumbel noise for given 32-bit words (a check of the
// polynomial inner log and the SFU's outer one against a reference).
extern "C" int ddg_absorbing_gumbel(const void* bits, void* g, int n, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  gumbel_probe_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(bits), static_cast<float*>(g), n);
  return cudaGetLastError();
}
