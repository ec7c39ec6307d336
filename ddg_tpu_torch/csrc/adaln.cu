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
// Design: one block per row, each thread holding up to kMaxVec 16-byte
// vectors of the row in registers, so the row stream is read once and h
// (and x') written once, with 16-byte coalesced accesses. The moments
// reduce with warp shuffles and, across the warps of a block, through
// shared memory. Rows need D % 8 == 0 (bf16) or D % 4 == 0 (fp32); the
// wrapper checks that. gate/shift/scale are (B, D) views with a row stride
// (`cond_stride`), so the chunks of the adaLN projection need no copy.
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
// so the sums are two-stage and deterministic, with no atomics: one block
// per (b, tile of kBwdRows rows) keeps its rows' per-column partials in
// registers (sum dh, sum dh xn, and for K6 sum dx_tot y) and writes them to
// an fp32 workspace (3, B, tiles, D); a second kernel adds the workspace up
// in a fixed order, per b for dshift/dscale/dgate and over all b for dw.
// Reruns give bit-identical grads.

#include "common.cuh"

namespace {

constexpr int kMaxVec = 4;

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

template <typename T, bool kResidual>
__global__ void adaln_kernel(const T* __restrict__ x_or_y, const T* __restrict__ skip,
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
    ddg::load16(x_or_y + base + col, v[k]);
    if (kResidual) {
      float sk[N], g[N];
      ddg::load16(skip + base + col, sk);
      ddg::load16(gate + cond + col, g);
#pragma unroll
      for (int i = 0; i < N; ++i) v[k][i] = __fadd_rn(sk[i], __fmul_rn(g[i], v[k][i]));
      ddg::store16(x_out + base + col, v[k]);
    }
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

template <typename T, bool kResidual>
int launch(const void* x_or_y, const void* skip, const void* gate, const void* w,
           const void* shift, const void* scale, void* x_out, void* h, int rows, int L,
           int D, int cond_stride, cudaStream_t stream) {
  constexpr int N = ddg::Vec16<T>::N;
  if (D % N || cond_stride % N || L <= 0 || rows % L) return cudaErrorInvalidValue;
  const int nvec = D / N;
  const int block = nvec > 1024 ? 1024 : ((nvec + 31) / 32) * 32;
  if (nvec > block * kMaxVec) return cudaErrorInvalidValue;
  adaln_kernel<T, kResidual><<<rows, block, 0, stream>>>(
      static_cast<const T*>(x_or_y), static_cast<const T*>(skip),
      static_cast<const T*>(gate), static_cast<const float*>(w),
      static_cast<const T*>(shift), static_cast<const T*>(scale), static_cast<T*>(x_out),
      static_cast<T*>(h), L, D, cond_stride);
  return cudaGetLastError();
}

// --- backward ---------------------------------------------------------------

constexpr int kBwdRows = 16;

template <int N>
__device__ __forceinline__ void store_f32(float* p, const float* in) {
#pragma unroll
  for (int i = 0; i < N; i += 4) ddg::store16(p + i, in + i);
}

// One block per (b, tile of kBwdRows rows); thread t owns the 16-byte
// column vector t of every row.
template <typename T, bool kResidual>
__global__ void adaln_bwd_rows_kernel(const T* __restrict__ xs, const T* __restrict__ y,
                                      const T* __restrict__ gate, const float* __restrict__ w,
                                      const T* __restrict__ scale, const T* __restrict__ dx_in,
                                      const T* __restrict__ dh, T* __restrict__ dx_out,
                                      T* __restrict__ dy, float* __restrict__ ws, int B, int L,
                                      int D, int cond_stride, int tiles) {
  constexpr int N = ddg::Vec16<T>::N;
  const int b = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int r_end = min((tile + 1) * kBwdRows, L);
  const int col = threadIdx.x * N;
  const bool active = col < D;
  const size_t cond = static_cast<size_t>(b) * cond_stride;

  float mul[N], g[N], p_dh[N], p_dhxn[N], p_dxy[N];
#pragma unroll
  for (int i = 0; i < N; ++i) p_dh[i] = p_dhxn[i] = p_dxy[i] = g[i] = 0.f;
  if (active) {
    float wv[N], sc[N];
    ddg::load_f32<N>(w + col, wv);
    ddg::load16(scale + cond + col, sc);
#pragma unroll
    for (int i = 0; i < N; ++i) mul[i] = wv[i] * (1.f + sc[i]);
    if (kResidual) ddg::load16(gate + cond + col, g);
  }

  for (int r = tile * kBwdRows; r < r_end; ++r) {
    const size_t base = (static_cast<size_t>(b) * L + r) * D + col;
    float v[N], d[N];
    float s1 = 0.f, s2 = 0.f;
    if (active) {
      ddg::load16(xs + base, v);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        s1 += v[i];
        s2 = fmaf(v[i], v[i], s2);
      }
    }
    block_sum2(s1, s2);
    const float m1 = s1 / D;
    const float rr = rsqrtf(fmaxf(s2 / D - m1 * m1, 0.f) + 1e-5f);
    float a = 0.f, c = 0.f;
    if (active) {
      ddg::load16(dh + base, d);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float xn = (v[i] - m1) * rr;
        p_dh[i] += d[i];
        p_dhxn[i] = fmaf(d[i], xn, p_dhxn[i]);
        v[i] = xn;
        d[i] *= mul[i];  // dxn
        a += d[i];
        c = fmaf(d[i], xn, c);
      }
    }
    block_sum2(a, c);
    const float md = a / D, mdx = c / D;
    if (!active) continue;
    float o[N];
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = rr * (d[i] - md - v[i] * mdx);
    if (kResidual) {
      float dxv[N], yv[N], dyv[N];
      ddg::load16(dx_in + base, dxv);
      ddg::load16(y + base, yv);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        o[i] += dxv[i];
        p_dxy[i] = fmaf(o[i], yv[i], p_dxy[i]);
        dyv[i] = o[i] * g[i];
      }
      ddg::store16(dy + base, dyv);
    }
    ddg::store16(dx_out + base, o);
  }
  if (!active) return;
  const size_t part = static_cast<size_t>(B) * tiles * D;
  const size_t at = (static_cast<size_t>(b) * tiles + tile) * D + col;
  store_f32<N>(ws + at, p_dh);
  store_f32<N>(ws + part + at, p_dhxn);
  if (kResidual) store_f32<N>(ws + 2 * part + at, p_dxy);
}

// Second stage: blockIdx.y < B sums the tiles of batch row b into
// dshift/dscale(/dgate); blockIdx.y == B sums everything into dw.
template <typename T, bool kResidual>
__global__ void adaln_bwd_cond_kernel(const float* __restrict__ ws, const float* __restrict__ w,
                                      const T* __restrict__ scale, int cond_stride,
                                      T* __restrict__ dshift, T* __restrict__ dscale,
                                      T* __restrict__ dgate, float* __restrict__ dw, int B,
                                      int tiles, int D) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;
  const size_t part = static_cast<size_t>(B) * tiles * D;
  if (blockIdx.y < B) {
    const int b = blockIdx.y;
    float sh = 0.f, sc = 0.f, sg = 0.f;
    for (int t = 0; t < tiles; ++t) {
      const size_t at = (static_cast<size_t>(b) * tiles + t) * D + d;
      sh += ws[at];
      sc += ws[part + at];
      if (kResidual) sg += ws[2 * part + at];
    }
    dshift[static_cast<size_t>(b) * D + d] = ddg::from_f32<T>(sh);
    dscale[static_cast<size_t>(b) * D + d] = ddg::from_f32<T>(sc * w[d]);
    if (kResidual) dgate[static_cast<size_t>(b) * D + d] = ddg::from_f32<T>(sg);
    return;
  }
  float acc = 0.f;
  for (int b = 0; b < B; ++b) {
    float s = 0.f;
    for (int t = 0; t < tiles; ++t) s += ws[part + (static_cast<size_t>(b) * tiles + t) * D + d];
    acc += s * (1.f + ddg::to_f32(scale[static_cast<size_t>(b) * cond_stride + d]));
  }
  dw[d] = acc;
}

template <typename T, bool kResidual>
int launch_bwd(const void* xs, const void* y, const void* gate, const void* w, const void* scale,
               const void* dx_in, const void* dh, void* dx_out, void* dy, void* dgate, void* dw,
               void* dshift, void* dscale, void* ws, int B, int L, int D, int cond_stride,
               int tiles, cudaStream_t stream) {
  constexpr int N = ddg::Vec16<T>::N;
  if (D % N || cond_stride % N || B <= 0 || L <= 0 || tiles != (L + kBwdRows - 1) / kBwdRows)
    return cudaErrorInvalidValue;
  const int nvec = D / N;
  if (nvec > 1024) return cudaErrorInvalidValue;
  const int block = ((nvec + 31) / 32) * 32;
  adaln_bwd_rows_kernel<T, kResidual><<<B * tiles, block, 0, stream>>>(
      static_cast<const T*>(xs), static_cast<const T*>(y), static_cast<const T*>(gate),
      static_cast<const float*>(w), static_cast<const T*>(scale), static_cast<const T*>(dx_in),
      static_cast<const T*>(dh), static_cast<T*>(dx_out), static_cast<T*>(dy),
      static_cast<float*>(ws), B, L, D, cond_stride, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  adaln_bwd_cond_kernel<T, kResidual><<<dim3((D + 127) / 128, B + 1), 128, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const float*>(w), static_cast<const T*>(scale),
      cond_stride, static_cast<T*>(dshift), static_cast<T*>(dscale), static_cast<T*>(dgate),
      static_cast<float*>(dw), B, tiles, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ddg_ln_modulate_bwd(const void* x, const void* w, const void* scale,
                                   const void* dh, void* dx, void* dw, void* dshift,
                                   void* dscale, void* ws, int B, int L, int D, int cond_stride,
                                   int tiles, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ddg::kF32)
    return launch_bwd<float, false>(x, nullptr, nullptr, w, scale, nullptr, dh, dx, nullptr,
                                    nullptr, dw, dshift, dscale, ws, B, L, D, cond_stride, tiles,
                                    s);
  if (dtype == ddg::kBF16)
    return launch_bwd<__nv_bfloat16, false>(x, nullptr, nullptr, w, scale, nullptr, dh, dx,
                                            nullptr, nullptr, dw, dshift, dscale, ws, B, L, D,
                                            cond_stride, tiles, s);
  return cudaErrorInvalidValue;
}

extern "C" int ddg_gate_res_ln_modulate_bwd(const void* x_new, const void* y, const void* gate,
                                            const void* w, const void* scale, const void* dx,
                                            const void* dh, void* dy, void* dskip, void* dgate,
                                            void* dw, void* dshift, void* dscale, void* ws, int B,
                                            int L, int D, int cond_stride, int tiles, int dtype,
                                            void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ddg::kF32)
    return launch_bwd<float, true>(x_new, y, gate, w, scale, dx, dh, dskip, dy, dgate, dw,
                                   dshift, dscale, ws, B, L, D, cond_stride, tiles, s);
  if (dtype == ddg::kBF16)
    return launch_bwd<__nv_bfloat16, true>(x_new, y, gate, w, scale, dx, dh, dskip, dy, dgate,
                                           dw, dshift, dscale, ws, B, L, D, cond_stride, tiles,
                                           s);
  return cudaErrorInvalidValue;
}

extern "C" int ddg_ln_modulate(const void* x, const void* w, const void* shift,
                               const void* scale, void* h, int rows, int L, int D,
                               int cond_stride, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ddg::kF32)
    return launch<float, false>(x, nullptr, nullptr, w, shift, scale, nullptr, h, rows, L, D,
                                cond_stride, s);
  if (dtype == ddg::kBF16)
    return launch<__nv_bfloat16, false>(x, nullptr, nullptr, w, shift, scale, nullptr, h, rows,
                                        L, D, cond_stride, s);
  return cudaErrorInvalidValue;
}

extern "C" int ddg_gate_res_ln_modulate(const void* y, const void* skip, const void* gate,
                                        const void* w, const void* shift, const void* scale,
                                        void* x_out, void* h, int rows, int L, int D,
                                        int cond_stride, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ddg::kF32)
    return launch<float, true>(y, skip, gate, w, shift, scale, x_out, h, rows, L, D, cond_stride,
                               s);
  if (dtype == ddg::kBF16)
    return launch<__nv_bfloat16, true>(y, skip, gate, w, shift, scale, x_out, h, rows, L, D,
                                       cond_stride, s);
  return cudaErrorInvalidValue;
}
