// GroupNorm with optional SiLU over channels-last activations, in two
// kernels: per-chunk partial sums, then the statistics and the normalize
// pass.
//
// Replaces the TPU kernel ddg_tpu/ops/groupnorm_pallas.py:
//   fused_group_norm_act -> _gn_kernel (pallas_call :89)
// For x (N, HW, C) with G groups of gs = C / G adjacent channels:
//   mean_g = sum(x) / (HW gs),  var_g = max(sum(x^2) / (HW gs) - mean_g^2, 0)
//   y      = (x - mean_g) * (rsqrt(var_g + eps) * scale_c) + bias_c
//   y      = y * sigmoid(y)                       (act)
// statistics in fp32, y written in the output type.
//
// Bound on the H100: bytes. The UNet's 51 norms of one D-CFG forward (N=64,
// bf16 in, fp32 out) read and write about 1.3 GB, 0.39 ms at 3.35 TB/s.
//
// Design: the TPU holds one sample's whole (H, W, C) slab in VMEM per grid
// step (up to 768 KB here, more than a block's shared memory), and its
// one-hot segment matmuls stand in for lane reshapes Mosaic lacks. Here a
// block takes a chunk of about 8K elements (a run of whole pixels) of one
// sample, so a call has hundreds of blocks. Threads own fixed channel
// vectors (8 channels, one 16-byte load of bf16) and walk the chunk's
// pixels, so a warp reads contiguous memory. Kernel 1 keeps per-channel
// sums in registers, adds them per group in shared memory in a fixed
// order and writes one (sum, sum of squares) pair per (sample, chunk,
// group) to a workspace. Kernel 2 adds a sample's pairs over its chunks,
// again in a fixed order, so every block of a sample derives the same
// statistics and reruns are bit-identical, then normalizes its chunk. No
// atomics. The second read of x mostly hits the 50 MB L2.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// Channels a thread owns: one 16-byte load of bf16, two of fp32.
constexpr int kVec = 8;
constexpr int kMaxGroups = 2048;

__device__ __forceinline__ void load_vec(const float* p, float* out) {
  ddg::load16(p, out);
  ddg::load16(p + 4, out + 4);
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  ddg::load16(p, out);
}

__device__ __forceinline__ void store_vec(float* p, const float* in) {
  ddg::store16(p, in);
  ddg::store16(p + 4, in + 4);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* in) {
  ddg::store16(p, in);
}

// Grid (n_chunks, N). partial: (N, n_chunks, G, 2) fp32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gn_stats_kernel(const T* __restrict__ x, float* __restrict__ partial, int HW, int C, int G,
                    int chunk) {
  __shared__ float sh1[kThreads * kVec], sh2[kThreads * kVec];
  const int n = blockIdx.y, k = blockIdx.x, n_chunks = gridDim.x;
  const int cv = C / kVec, py = kThreads / cv;
  const int tx = threadIdx.x % cv, ty = threadIdx.x / cv;
  if (ty < py) {
    float s1[kVec], s2[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) s1[i] = s2[i] = 0.f;
    const int p1 = min((k + 1) * chunk, HW);
    const T* xn = x + static_cast<size_t>(n) * HW * C + tx * kVec;
    for (int p = k * chunk + ty; p < p1; p += py) {
      float v[kVec];
      load_vec(xn + static_cast<size_t>(p) * C, v);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        s1[i] += v[i];
        s2[i] = fmaf(v[i], v[i], s2[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      sh1[ty * C + tx * kVec + i] = s1[i];
      sh2[ty * C + tx * kVec + i] = s2[i];
    }
  }
  __syncthreads();
  const int gs = C / G;
  for (int g = threadIdx.x; g < G; g += kThreads) {
    float a = 0.f, b = 0.f;
    for (int y = 0; y < py; ++y)
      for (int c = g * gs; c < (g + 1) * gs; ++c) {
        a += sh1[y * C + c];
        b += sh2[y * C + c];
      }
    float* out = partial + ((static_cast<size_t>(n) * n_chunks + k) * G + g) * 2;
    out[0] = a;
    out[1] = b;
  }
}

template <typename Tin, typename Tout, bool kAct>
__global__ void __launch_bounds__(kThreads)
    gn_apply_kernel(const Tin* __restrict__ x, const float* __restrict__ partial,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    Tout* __restrict__ y, int HW, int C, int G, int chunk, float eps) {
  __shared__ float sh_mean[kMaxGroups], sh_rinv[kMaxGroups];
  const int n = blockIdx.y, k = blockIdx.x, n_chunks = gridDim.x;
  const int gs = C / G;
  const float cnt = static_cast<float>(HW) * static_cast<float>(gs);
  for (int g = threadIdx.x; g < G; g += kThreads) {
    float a = 0.f, b = 0.f;
    const float* pp = partial + static_cast<size_t>(n) * n_chunks * G * 2 + g * 2;
    for (int j = 0; j < n_chunks; ++j) {
      a += pp[static_cast<size_t>(j) * G * 2];
      b += pp[static_cast<size_t>(j) * G * 2 + 1];
    }
    const float mean = __fdiv_rn(a, cnt);
    const float var = fmaxf(__fsub_rn(__fdiv_rn(b, cnt), __fmul_rn(mean, mean)), 0.f);
    sh_mean[g] = mean;
    sh_rinv[g] = rsqrtf(__fadd_rn(var, eps));
  }
  __syncthreads();
  const int cv = C / kVec, py = kThreads / cv;
  const int tx = threadIdx.x % cv, ty = threadIdx.x / cv;
  if (ty >= py) return;
  float m[kVec], sc[kVec], bi[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int c = tx * kVec + i;
    m[i] = sh_mean[c / gs];
    sc[i] = __fmul_rn(sh_rinv[c / gs], scale[c]);
    bi[i] = bias[c];
  }
  const int p1 = min((k + 1) * chunk, HW);
  const size_t off = static_cast<size_t>(n) * HW * C + tx * kVec;
  for (int p = k * chunk + ty; p < p1; p += py) {
    float v[kVec];
    load_vec(x + off + static_cast<size_t>(p) * C, v);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      float t = __fadd_rn(__fmul_rn(__fsub_rn(v[i], m[i]), sc[i]), bi[i]);
      if (kAct) t = __fmul_rn(t, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-t))));
      v[i] = t;
    }
    store_vec(y + off + static_cast<size_t>(p) * C, v);
  }
}

template <typename Tin, typename Tout>
int launch(const void* x, float* partial, const float* scale, const float* bias, void* y, int N,
           int HW, int C, int G, int chunk, int n_chunks, float eps, int act,
           cudaStream_t stream) {
  const dim3 grid(n_chunks, N);
  const Tin* xi = static_cast<const Tin*>(x);
  gn_stats_kernel<Tin><<<grid, kThreads, 0, stream>>>(xi, partial, HW, C, G, chunk);
  const int rc = cudaGetLastError();
  if (rc) return rc;
  Tout* yo = static_cast<Tout*>(y);
  if (act) {
    gn_apply_kernel<Tin, Tout, true>
        <<<grid, kThreads, 0, stream>>>(xi, partial, scale, bias, yo, HW, C, G, chunk, eps);
  } else {
    gn_apply_kernel<Tin, Tout, false>
        <<<grid, kThreads, 0, stream>>>(xi, partial, scale, bias, yo, HW, C, G, chunk, eps);
  }
  return cudaGetLastError();
}

}  // namespace

// x: (N, HW, C) contiguous, C % 8 == 0 and C <= 2048; scale, bias: (C,)
// fp32; partial: (N, n_chunks, G, 2) fp32 workspace; y: (N, HW, C). x and y
// are each fp32 or bf16. Each block covers `chunk` pixels; n_chunks =
// ceil(HW / chunk).
extern "C" int ddg_group_norm(const void* x, const void* scale, const void* bias, void* partial,
                              void* y, int N, int HW, int C, int G, int chunk, int n_chunks,
                              float eps, int act, int in_dtype, int out_dtype, void* stream) {
  if (N <= 0 || HW <= 0 || C <= 0 || C % kVec || C / kVec > kThreads || G <= 0 ||
      G > kMaxGroups || C % G || chunk <= 0 || n_chunks != (HW + chunk - 1) / chunk ||
      n_chunks > 65535 || N > 65535)
    return cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  auto s = static_cast<cudaStream_t>(stream);
  auto w = static_cast<float*>(partial);
  auto sc = static_cast<const float*>(scale);
  auto bi = static_cast<const float*>(bias);
  if (in_dtype == ddg::kBF16 && out_dtype == ddg::kF32)
    return launch<bf16, float>(x, w, sc, bi, y, N, HW, C, G, chunk, n_chunks, eps, act, s);
  if (in_dtype == ddg::kBF16 && out_dtype == ddg::kBF16)
    return launch<bf16, bf16>(x, w, sc, bi, y, N, HW, C, G, chunk, n_chunks, eps, act, s);
  if (in_dtype == ddg::kF32 && out_dtype == ddg::kF32)
    return launch<float, float>(x, w, sc, bi, y, N, HW, C, G, chunk, n_chunks, eps, act, s);
  if (in_dtype == ddg::kF32 && out_dtype == ddg::kBF16)
    return launch<float, bf16>(x, w, sc, bi, y, N, HW, C, G, chunk, n_chunks, eps, act, s);
  return cudaErrorInvalidValue;
}
