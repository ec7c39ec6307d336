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

}  // namespace

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
