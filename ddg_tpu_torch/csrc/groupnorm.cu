// GroupNorm with optional SiLU over channels-last activations.
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
// Design: the TPU kernel holds one sample's whole (H, W, C) slab in VMEM
// per grid step. Here a sample's slab is held on chip too, in the shared
// memory of one block or of a thread block cluster of up to 16 (`plan`:
// the fewest blocks, a power of two, that keep each block's share of
// pixels within kSlabBytes, or within the card's shared memory at 16; a
// cluster past 8 is non-portable, which the H100 takes), so each call is
// one launch that reads x once and writes y once, with no workspace. A
// block's pixels are one contiguous run of bytes, landed by bulk copies
// (cp.async.bulk) in pieces, each on its own mbarrier, so the sums start
// on the first piece while the rest land. Threads own fixed channel
// vectors (8 channels, one 16-byte read of bf16) and walk the block's
// pixels, keeping per-channel sums in registers; then per channel over the
// threads, per group over its channels, and over the cluster's blocks
// through distributed shared memory, each sum in one fixed order, so every
// block of a sample derives the same statistics, reruns are bit-identical
// and a sample's bits follow its shape only. `barrier.cluster` separates
// the partials' writes from their reads, and their reads from the blocks'
// exit. Then the normalize and SiLU run from shared memory, four channels
// a thread, so that a warp's fp32 stores are one contiguous run. No
// atomics. The UNet's 51 norms: blocks of 8 KB (4 x 4 x 256 bf16) to 96 KB
// (a share of 32 x 32 x 384 fp32 over 16 blocks). Measured on an NVIDIA
// H100 80GB HBM3 at 700 W (PERF.md):
// blocks of up to 32 KB of x, which put several blocks on an SM, beat
// 64 KB; a cluster of 16 beat 8 at 32 x 32 x 384.
//
// A slab that 16 blocks do not hold (none of the UNet configurations in
// configs/model/: past about 3 MB a sample) takes the first design's two
// kernels: per-chunk partial sums of about 8K elements into a workspace,
// then the statistics, summed in a fixed order, and the normalize pass,
// which reads x again.

#include "async.cuh"
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// Channels a thread owns: one 16-byte load of bf16, two of fp32.
constexpr int kVec = 8;
constexpr int kMaxGroups = 2048;
constexpr int kMaxCluster = 16;        // blocks of a sample (past 8, a non-portable cluster)
constexpr int kSlabBytes = 32 << 10;   // x a block holds where fewer blocks cannot
constexpr int kMaxPieces = 16;         // bulk copies (and mbarriers) a block
constexpr int kSmemMax = 232448;
constexpr int kScratch = 2 * kThreads * kVec * 4;   // per-thread sums, then statistics

// How a call runs, from its shape alone: path 1, a sample's slab on chip
// in `cluster` blocks of up to `pixels` pixels each, `smem` bytes of
// shared memory a block; path 2, the two kernels (cluster 0, pixels 0 and
// smem 0). ops/groupnorm.py's `plan` mirrors it, and chip_smoke.py holds
// the two equal through `ddg_group_norm_plan`.
struct Plan {
  int path, cluster, pixels, smem;
};

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

Plan make_plan(int HW, int C, int G, int in_size) {
  for (int cs = 1; cs <= kMaxCluster; cs *= 2) {
    const int pix = (HW + cs - 1) / cs;
    const long long bytes = static_cast<long long>(pix) * C * in_size;
    if (bytes > kSlabBytes && cs < kMaxCluster) continue;
    const long long smem = (bytes + 15) / 16 * 16 + kScratch + 8LL * G + 8LL * kMaxPieces;
    if (smem <= kSmemMax) return Plan{1, cs, pix, static_cast<int>(smem)};
  }
  return Plan{2, 0, 0, 0};
}

// y sigmoid(y): __expf and the approximate division (each within 2 ulp).
__device__ __forceinline__ float silu(float t) { return __fdividef(t, 1.f + __expf(-t)); }

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

// Four channels: 16 bytes of fp32, 8 of bf16.
__device__ __forceinline__ void load4(const float* p, float* out) { ddg::load16(p, out); }
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  out[0] = a.x, out[1] = a.y, out[2] = b.x, out[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float* in) { ddg::store16(p, in); }
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* in) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(in[0], in[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(in[2], in[3]);
  uint2 v;
  v.x = *reinterpret_cast<const uint32_t*>(&a);
  v.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = v;
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
      if (kAct) t = silu(t);
      v[i] = t;
    }
    store_vec(y + off + static_cast<size_t>(p) * C, v);
  }
}

// Path 1. Grid (cluster, N), a cluster per sample; block `rank` holds the
// sample's pixels [rank pixels, (rank + 1) pixels). Shared memory: the
// block's x, the per-thread sums (then each group's mean and rsqrt), the
// block's group sums (s1 for G groups, then s2; read by the cluster), the
// pieces' mbarriers.
template <typename Tin, typename Tout, bool kAct>
__global__ void __launch_bounds__(kThreads)
    gn_slab_kernel(const Tin* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ bias, Tout* __restrict__ y, int HW, int C, int G,
                   int pixels, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cs = gridDim.x, rank = blockIdx.x, n = blockIdx.y;
  const int p0 = min(HW, rank * pixels), np = min(HW, p0 + pixels) - p0;
  Tin* xs = reinterpret_cast<Tin*>(smem);
  float* s1 = reinterpret_cast<float*>(smem + round16(pixels * C * static_cast<int>(sizeof(Tin))));
  float* s2 = s1 + kThreads * kVec;
  float* part = s2 + kThreads * kVec;   // 2 G
  uint64_t* bars = reinterpret_cast<uint64_t*>(part + 2 * G);
  const int cv = C / kVec, py = kThreads / cv;
  const int tx = threadIdx.x % cv, ty = threadIdx.x / cv;
  // Pieces of whole sweeps (py pixels), at most kMaxPieces.
  const int sweeps = (pixels + py - 1) / py;
  const int piece = py * ((sweeps + kMaxPieces - 1) / kMaxPieces);
  const int n_pieces = (np + piece - 1) / piece;
  const size_t row = static_cast<size_t>(C) * sizeof(Tin);
  if (threadIdx.x == 0) {
    for (int i = 0; i < n_pieces; ++i) ddg::mbar_init(ddg::smem_u32(bars + i), 1);
    ddg::fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(x) + (static_cast<size_t>(n) * HW + p0) * row;
    for (int i = 0; i < n_pieces; ++i) {
      const int q0 = i * piece, q = min(piece, np - q0);
      const uint32_t bar = ddg::smem_u32(bars + i), bytes = static_cast<uint32_t>(q * row);
      ddg::mbar_expect_tx(bar, bytes);
      ddg::bulk_g2s(ddg::smem_u32(smem + q0 * row), src + q0 * row, bytes, bar);
    }
  }
  // Per-channel sums over this thread's pixels, in order.
  float a1[kVec], a2[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) a1[i] = a2[i] = 0.f;
  if (ty < py) {
    int landed = -1;
    for (int p = ty; p < np; p += py) {
      if (p / piece != landed) {
        landed = p / piece;
        ddg::mbar_wait(ddg::smem_u32(bars + landed), 0);
      }
      float v[kVec];
      load_vec(xs + static_cast<size_t>(p) * C + tx * kVec, v);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        a1[i] += v[i];
        a2[i] = fmaf(v[i], v[i], a2[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      s1[ty * C + tx * kVec + i] = a1[i];
      s2[ty * C + tx * kVec + i] = a2[i];
    }
  }
  __syncthreads();
  // Per channel over the threads' rows, in order (into row 0), then per
  // group over its channels, in order.
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float b1 = s1[c], b2 = s2[c];
    for (int r = 1; r < py; ++r) {
      b1 += s1[r * C + c];
      b2 += s2[r * C + c];
    }
    s1[c] = b1;
    s2[c] = b2;
  }
  __syncthreads();
  const int gs = C / G;
  for (int g = threadIdx.x; g < G; g += kThreads) {
    float b1 = 0.f, b2 = 0.f;
    for (int c = g * gs; c < (g + 1) * gs; ++c) {
      b1 += s1[c];
      b2 += s2[c];
    }
    part[g] = b1;
    part[G + g] = b2;
  }
  // The statistics, from the cluster's blocks in rank order.
  if (cs > 1) ddg::cluster_sync();
  else __syncthreads();
  const float cnt = static_cast<float>(HW) * static_cast<float>(gs);
  for (int g = threadIdx.x; g < G; g += kThreads) {
    float b1 = 0.f, b2 = 0.f;
    for (int r = 0; r < cs; ++r) {
      if (cs > 1) {
        b1 += ddg::ld_cluster(ddg::smem_u32(part + g), r);
        b2 += ddg::ld_cluster(ddg::smem_u32(part + G + g), r);
      } else {
        b1 += part[g];
        b2 += part[G + g];
      }
    }
    const float mean = __fdiv_rn(b1, cnt);
    const float var = fmaxf(__fsub_rn(__fdiv_rn(b2, cnt), __fmul_rn(mean, mean)), 0.f);
    s1[g] = mean;
    s2[g] = rsqrtf(__fadd_rn(var, eps));
  }
  if (cs > 1) ddg::cluster_arrive();   // this block has read its peers' sums
  __syncthreads();
  // The normalize, four channels a thread, so that a warp's stores are one
  // contiguous run (512 bytes of fp32); past 1024 channels a thread takes
  // every 256th quad of a pixel.
  const int cv4 = C / 4, py4 = max(1, kThreads / cv4);
  const int tx4 = threadIdx.x % cv4, ty4 = threadIdx.x / cv4;
  Tout* yn = y + (static_cast<size_t>(n) * HW + p0) * C;
  auto norm4 = [&](int p, int c0, const float (&m)[4], const float (&sc)[4],
                   const float (&bi)[4]) {
    float v[4];
    load4(xs + static_cast<size_t>(p) * C + c0, v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float t = __fadd_rn(__fmul_rn(__fsub_rn(v[i], m[i]), sc[i]), bi[i]);
      if (kAct) t = silu(t);
      v[i] = t;
    }
    store4(yn + static_cast<size_t>(p) * C + c0, v);
  };
  auto params = [&](int c0, float (&m)[4], float (&sc)[4], float (&bi)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + i;
      m[i] = s1[c / gs];
      sc[i] = __fmul_rn(s2[c / gs], scale[c]);
      bi[i] = bias[c];
    }
  };
  float m[4], sc[4], bi[4];
  if (cv4 <= kThreads) {
    if (ty4 < py4) {
      params(tx4 * 4, m, sc, bi);
      for (int p = ty4; p < np; p += py4) norm4(p, tx4 * 4, m, sc, bi);
    }
  } else {
    for (int qd = threadIdx.x; qd < cv4; qd += kThreads) {
      params(qd * 4, m, sc, bi);
      for (int p = 0; p < np; ++p) norm4(p, qd * 4, m, sc, bi);
    }
  }
  if (cs > 1) ddg::cluster_wait();     // no peer reads this block's sums any more
}

template <typename Tin, typename Tout, bool kAct>
int launch_slab(const Plan& pl, const void* x, const float* scale, const float* bias, void* y,
                int N, int HW, int C, int G, float eps, cudaStream_t stream) {
  auto fn = gn_slab_kernel<Tin, Tout, kAct>;
  static bool configured = false;
  cudaError_t e;
  if (!configured) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e == cudaSuccess && kMaxCluster > 8)
      e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const Tin* xi = static_cast<const Tin*>(x);
  Tout* yo = static_cast<Tout*>(y);
  if (pl.cluster == 1) {
    fn<<<dim3(1, N), kThreads, pl.smem, stream>>>(xi, scale, bias, yo, HW, C, G, pl.pixels, eps);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.cluster, N);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, fn, xi, scale, bias, yo, HW, C, G, pl.pixels, eps);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
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

// x: (N, HW, C) contiguous and 16-byte aligned, C % 8 == 0 and C <= 2048;
// scale, bias: (C,) fp32; y: (N, HW, C). x and y are each fp32 or bf16.
// Where `plan` gives path 2, partial is an (N, n_chunks, G, 2) fp32
// workspace and each of its blocks covers `chunk` pixels, n_chunks =
// ceil(HW / chunk); path 1 reads neither (partial may be null).
extern "C" int ddg_group_norm(const void* x, const void* scale, const void* bias, void* partial,
                              void* y, int N, int HW, int C, int G, int chunk, int n_chunks,
                              float eps, int act, int in_dtype, int out_dtype, void* stream) {
  if (N <= 0 || HW <= 0 || C <= 0 || C % kVec || C / kVec > kThreads || G <= 0 ||
      G > kMaxGroups || C % G || N > 65535 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 16 || (in_dtype != ddg::kF32 && in_dtype != ddg::kBF16))
    return cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  auto s = static_cast<cudaStream_t>(stream);
  auto w = static_cast<float*>(partial);
  auto sc = static_cast<const float*>(scale);
  auto bi = static_cast<const float*>(bias);
  const Plan pl = make_plan(HW, C, G, in_dtype == ddg::kF32 ? 4 : 2);
  if (pl.path == 1) {
#define DDG_SLAB(Tin, Tout)                                                              \
  return act ? launch_slab<Tin, Tout, true>(pl, x, sc, bi, y, N, HW, C, G, eps, s)       \
             : launch_slab<Tin, Tout, false>(pl, x, sc, bi, y, N, HW, C, G, eps, s)
    if (in_dtype == ddg::kBF16 && out_dtype == ddg::kF32) DDG_SLAB(bf16, float);
    if (in_dtype == ddg::kBF16 && out_dtype == ddg::kBF16) DDG_SLAB(bf16, bf16);
    if (in_dtype == ddg::kF32 && out_dtype == ddg::kF32) DDG_SLAB(float, float);
    if (in_dtype == ddg::kF32 && out_dtype == ddg::kBF16) DDG_SLAB(float, bf16);
#undef DDG_SLAB
    return cudaErrorInvalidValue;
  }
  if (w == nullptr || chunk <= 0 || n_chunks != (HW + chunk - 1) / chunk || n_chunks > 65535)
    return cudaErrorInvalidValue;
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

// The plan of a call (`make_plan`) into out[0..3]: path, cluster, pixels
// a block, shared memory a block.
extern "C" void ddg_group_norm_plan(int HW, int C, int G, int in_size, int* out) {
  const Plan pl = make_plan(HW, C, G, in_size);
  out[0] = pl.path;
  out[1] = pl.cluster;
  out[2] = pl.pixels;
  out[3] = pl.smem;
}
