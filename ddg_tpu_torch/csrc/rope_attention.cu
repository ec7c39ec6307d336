// Softmax attention for the DiT's short sequences, forward, on the
// token-major layout: K1 (with RoPE) and K2 (without).
//
// Replaces two TPU kernels of ddg_tpu/ops/attention_pallas.py:
//   K1 fused_rope_attention -> _rope_flash -> _rope_attn_kernel (pallas_call :215)
//   K2 short_seq_attention -> _flash -> _attn_kernel (pallas_call :85)
// K2 is K1 with the rotation compiled out (kRope = false): the DiT rotates
// q and k before it, outside the kernel (ddg_tpu/models/dit.py:376-380).
// For each (b, h), with q, k, v of shape (B, L, H, D):
//   q' = RoPE(q), k' = RoPE(k)  K1 only: rotate-half in fp32, rounded back to the input dtype
//   S  = q' k'^T / sqrt(D)      fp32; with `causal`, S[i][j] = -1e30 for j > i
//   P  = softmax(S)             normalised in fp32, then rounded to v's dtype
//   O  = P V                    fp32 accumulation, written in the input dtype
// q, k and v each have their own token stride: views into the fused qkv
// projection (K1), or a rotated contiguous q and k beside a view of v (K2).
//
// Bound on the H100 at the DiT-small sampling shape (B=48, L=128, H=12,
// D=64, bf16): bytes, 37.7 MB of q, k, v and o (11 us), against 2.4 GFLOP
// that the bf16 tensor cores do in 2.4 us. At text8's L=256 the products
// double per token and the function stays bound by bytes.
//
// Two kernels, each in a RoPE and a plain instantiation:
// * attention_mma_kernel, for bf16 with D = 64 and L <= 256 (the DiT's
//   shapes): one block of 8 warps per (128-row query tile, head, batch)
//   stages the tile's Q, the head's K (kKeys = 128 or 256 rows, the L
//   rounded up) and its transposed V in shared memory, bf16, rows padded
//   so that the fragment loads of a warp hit 32 banks (row of 72 for Q and
//   K, of kKeys + 8 for V^T: 36 or 68 / 132 words, 4 mod 32): 53 KB at
//   kKeys = 128, 87 KB at 256. Each warp owns 16 query rows and keeps the
//   whole row of scores in registers (kKeys / 8 fragments of 4 fp32, 128
//   registers at 256) from end to end: S = Q K^T by mma.sync m16n8k16 (bf16
//   in, fp32 accumulate), the masked softmax with quad shuffles over the
//   whole row, P divided by the row sum and only then rounded to bf16 as
//   the A operand of O = P V (no online rescale of an unnormalised P, so
//   the rounding is where the plain version has it). At L = 256 a head
//   takes two blocks, each staging K and V; nothing but q, k, v and o
//   touches device memory.
// * attention_kernel, for float32 and any other shape: one block per
//   (32-row query tile, head, batch) stages the head's K and V in fp32 (K
//   rows padded by one float against bank conflicts) and the tile's L
//   scores per row in dynamic shared memory, (L (2D + 1) + 32 (D + L))
//   floats (173 KB at L = 256, D = 64), and does the products with fp32
//   FMAs on the CUDA cores, in full fp32.
// The C functions report in *path which kernel they launched (1: tensor
// cores, 0: CUDA cores).

#include <type_traits>

#include "common.cuh"

namespace {

using ddg::ld32;
using ddg::mma_16816;
using ddg::pack_bf16;

constexpr int kTile = 32;
constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;

// RoPE of element d of one (L, D) head row, rounded to T: the rotate-half
// convention (x1 c - x2 s, x2 c + x1 s) with separately rounded fp32
// products, as the plain version computes it.
template <typename T>
__device__ __forceinline__ float rope_at(const T* row, int d, int D, const float* cos_row,
                                         const float* sin_row) {
  const int half = D / 2;
  const int f = d < half ? d : d - half;
  const float x = ddg::to_f32(row[d]);
  const float c = cos_row[f], s = sin_row[f];
  float y;
  if (d < half) {
    y = __fsub_rn(__fmul_rn(x, c), __fmul_rn(ddg::to_f32(row[d + half]), s));
  } else {
    y = __fadd_rn(__fmul_rn(x, c), __fmul_rn(ddg::to_f32(row[d - half]), s));
  }
  return ddg::round_to<T>(y);
}

// Element d of row j of q or k as the products take it: rotated (K1) or as
// it is (K2).
template <typename T, bool kRope>
__device__ __forceinline__ float qk_at(const T* row, int j, int d, int D, const float* cos,
                                       const float* sin) {
  if constexpr (kRope) {
    return rope_at(row, d, D, cos + j * (D / 2), sin + j * (D / 2));
  } else {
    return ddg::to_f32(row[d]);
  }
}

template <typename T, bool kRope>
__global__ void __launch_bounds__(kThreads)
    attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ cos, const float* __restrict__ sin,
                     T* __restrict__ o, int L, int H, int D, int ts_q, int ts_k, int ts_v,
                     int causal, float scale) {
  extern __shared__ float smem[];
  const int KS = D + 1;  // padded K row
  float* Ks = smem;                 // L x (D + 1)
  float* Vs = Ks + L * KS;          // L x D
  float* Qs = Vs + L * D;           // kTile x D
  float* Ss = Qs + kTile * D;       // kTile x L

  const int i0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  // Rows of q, k and v are ts_q, ts_k and ts_v elements apart; o is
  // contiguous (B, L, H, D).
  const size_t qh = static_cast<size_t>(b) * L * ts_q + static_cast<size_t>(h) * D;
  const size_t kh = static_cast<size_t>(b) * L * ts_k + static_cast<size_t>(h) * D;
  const size_t vh = static_cast<size_t>(b) * L * ts_v + static_cast<size_t>(h) * D;
  const size_t out_stride = static_cast<size_t>(H) * D;
  const size_t out_head = static_cast<size_t>(b) * L * out_stride + static_cast<size_t>(h) * D;

  for (int idx = threadIdx.x; idx < L * D; idx += blockDim.x) {
    const int j = idx / D, d = idx % D;
    Ks[j * KS + d] = qk_at<T, kRope>(k + kh + static_cast<size_t>(j) * ts_k, j, d, D, cos, sin);
    Vs[j * D + d] = ddg::to_f32(v[vh + static_cast<size_t>(j) * ts_v + d]);
  }
  for (int idx = threadIdx.x; idx < kTile * D; idx += blockDim.x) {
    const int i = idx / D, d = idx % D;
    const int row = i0 + i;
    Qs[idx] = row < L ? qk_at<T, kRope>(q + qh + static_cast<size_t>(row) * ts_q, row, d, D,
                                        cos, sin)
                      : 0.f;
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < kTile * L; idx += blockDim.x) {
    const int i = idx / L, j = idx % L;
    const float* qi = Qs + i * D;
    const float* kj = Ks + j * KS;
    float acc = 0.f;
    for (int d = 0; d < D; ++d) acc = fmaf(qi[d], kj[d], acc);
    acc *= scale;
    if (causal && j > i0 + i) acc = kNeg;
    Ss[idx] = acc;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < kTile; i += kThreads / 32) {
    float* s = Ss + i * L;
    float m = kNeg;
    for (int j = lane; j < L; j += 32) m = fmaxf(m, s[j]);
    m = ddg::warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(s[j] - m);
      s[j] = e;
      sum += e;
    }
    sum = ddg::warp_sum(sum);
    for (int j = lane; j < L; j += 32) s[j] = ddg::round_to<T>(s[j] / sum);
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < kTile * D; idx += blockDim.x) {
    const int i = idx / D, d = idx % D;
    const int row = i0 + i;
    if (row >= L) continue;
    const float* p = Ss + i * L;
    const int jmax = causal ? row + 1 : L;
    float acc = 0.f;
    for (int j = 0; j < jmax; ++j) acc = fmaf(p[j], Vs[j * D + d], acc);
    o[out_head + row * out_stride + d] = ddg::from_f32<T>(acc);
  }
}

// --- bf16 tensor-core path --------------------------------------------------

constexpr int kMmaD = 64;                  // head dim
constexpr int kMmaMaxL = 256;              // longest row of keys
constexpr int kQTile = 128;                // query rows of one block
constexpr int kMmaWarps = kQTile / 16;     // one warp per 16 query rows
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kQKRow = kMmaD + 8;          // padded bf16 row of Q and K

template <int kKeys>
constexpr size_t mma_smem() {
  return sizeof(__nv_bfloat16) * ((kQTile + kKeys) * kQKRow + kMmaD * (kKeys + 8));
}

// Stage 8 consecutive pairs (x1 = row[f..f+7], x2 = row[f+32..f+39]) of one
// 64-wide row at dst[f..] and dst[f+32..], in bf16: rotated by the RoPE of
// position j (K1), or copied (K2).
template <bool kRope>
__device__ __forceinline__ void stage8(const __nv_bfloat16* row, const float* cos,
                                       const float* sin, int j, int f, __nv_bfloat16* dst) {
  constexpr int half = kMmaD / 2;
  float x1[8], x2[8];
  ddg::load16(row + f, x1);
  ddg::load16(row + f + half, x2);
  if constexpr (kRope) {
    float c[8], s[8], y1[8], y2[8];
    ddg::load_f32<8>(cos + j * half + f, c);
    ddg::load_f32<8>(sin + j * half + f, s);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      y1[i] = __fsub_rn(__fmul_rn(x1[i], c[i]), __fmul_rn(x2[i], s[i]));
      y2[i] = __fadd_rn(__fmul_rn(x2[i], c[i]), __fmul_rn(x1[i], s[i]));
    }
    ddg::store16(dst + f, y1);
    ddg::store16(dst + f + half, y2);
  } else {
    ddg::store16(dst + f, x1);
    ddg::store16(dst + f + half, x2);
  }
}

template <int kKeys, bool kRope>
__global__ void __launch_bounds__(kMmaThreads)
    attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const float* __restrict__ cos,
                         const float* __restrict__ sin, __nv_bfloat16* __restrict__ o, int L,
                         int H, int ts_q, int ts_k, int ts_v, int causal, float scale) {
  constexpr int kVtRow = kKeys + 8;        // padded bf16 row of V^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // kQTile x kQKRow
  __nv_bfloat16* Ks = Qs + kQTile * kQKRow;                          // kKeys x kQKRow
  __nv_bfloat16* Vt = Ks + kKeys * kQKRow;                           // kMmaD x kVtRow
  constexpr int half = kMmaD / 2;
  const int q0 = blockIdx.x * kQTile, h = blockIdx.y, b = blockIdx.z;
  const size_t qh = static_cast<size_t>(b) * L * ts_q + static_cast<size_t>(h) * kMmaD;
  const size_t kh = static_cast<size_t>(b) * L * ts_k + static_cast<size_t>(h) * kMmaD;
  const size_t vh = static_cast<size_t>(b) * L * ts_v + static_cast<size_t>(h) * kMmaD;
  const float z[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

  // Stage Q of the tile and K of the head (8 pairs a thread) and V^T; rows
  // past L are 0.
  for (int idx = threadIdx.x; idx < kQTile * (half / 8); idx += kMmaThreads) {
    const int i = idx / (half / 8), f = (idx % (half / 8)) * 8, row = q0 + i;
    __nv_bfloat16* qd = Qs + i * kQKRow;
    if (row < L) {
      stage8<kRope>(q + qh + static_cast<size_t>(row) * ts_q, cos, sin, row, f, qd);
    } else {
      ddg::store16(qd + f, z);
      ddg::store16(qd + f + half, z);
    }
  }
  for (int idx = threadIdx.x; idx < kKeys * (half / 8); idx += kMmaThreads) {
    const int j = idx / (half / 8), f = (idx % (half / 8)) * 8;
    __nv_bfloat16* kd = Ks + j * kQKRow;
    if (j < L) {
      stage8<kRope>(k + kh + static_cast<size_t>(j) * ts_k, cos, sin, j, f, kd);
    } else {
      ddg::store16(kd + f, z);
      ddg::store16(kd + f + half, z);
    }
  }
  for (int idx = threadIdx.x; idx < kKeys * (kMmaD / 8); idx += kMmaThreads) {
    const int j = idx / (kMmaD / 8), d0 = (idx % (kMmaD / 8)) * 8;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (j < L) ddg::load16(v + vh + static_cast<size_t>(j) * ts_v + d0, x);
#pragma unroll
    for (int i = 0; i < 8; ++i) Vt[(d0 + i) * kVtRow + j] = __float2bfloat16_rn(x[i]);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (q0 + warp * 16 >= L) return;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, column pair
  const int lr0 = warp * 16 + g;          // the lane's rows in the tile: lr0, lr0 + 8
  const int r0 = q0 + lr0, r1 = r0 + 8;   // and in the sequence

  // S = Q K^T: 16 rows x kKeys keys, in kNT tiles of 8 keys.
  constexpr int kNT = kKeys / 8;
  float s[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kMmaD / 16; ++kk) {
    const __nv_bfloat16* qa = Qs + lr0 * kQKRow + kk * 16 + 2 * t;
    const uint32_t a0 = ld32(qa), a1 = ld32(qa + 8 * kQKRow);
    const uint32_t a2 = ld32(qa + 8), a3 = ld32(qa + 8 * kQKRow + 8);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const __nv_bfloat16* kb = Ks + (nt * 8 + g) * kQKRow + kk * 16 + 2 * t;
      mma_16816(s[nt], a0, a1, a2, a3, ld32(kb), ld32(kb + 8));
    }
  }

  // Scale, mask, softmax. Element e of tile nt is row (e < 2 ? r0 : r1),
  // key nt * 8 + 2 t + (e & 1); a row's keys are spread over a quad.
  float m[2] = {kNeg, kNeg};
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = nt * 8 + 2 * t + (e & 1);
      const int row = e < 2 ? r0 : r1;
      float x = s[nt][e] * scale;
      if (key >= L || (causal && key > row)) x = kNeg;
      s[nt][e] = x;
      m[e >> 1] = fmaxf(m[e >> 1], x);
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
  }
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nt][e] = expf(s[nt][e] - m[e >> 1]);
      sum[e >> 1] += s[nt][e];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
  }

  // O = P V, P normalised, then rounded to bf16 as the A fragments (the S
  // tiles' layout).
  float acc[kMmaD / 8][4];
#pragma unroll
  for (int nt = 0; nt < kMmaD / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    const int lo = 2 * kk, hi = 2 * kk + 1;
    const uint32_t a0 = pack_bf16(s[lo][0] / sum[0], s[lo][1] / sum[0]);
    const uint32_t a1 = pack_bf16(s[lo][2] / sum[1], s[lo][3] / sum[1]);
    const uint32_t a2 = pack_bf16(s[hi][0] / sum[0], s[hi][1] / sum[0]);
    const uint32_t a3 = pack_bf16(s[hi][2] / sum[1], s[hi][3] / sum[1]);
#pragma unroll
    for (int nt = 0; nt < kMmaD / 8; ++nt) {
      const __nv_bfloat16* vb = Vt + (nt * 8 + g) * kVtRow + kk * 16 + 2 * t;
      mma_16816(acc[nt], a0, a1, a2, a3, ld32(vb), ld32(vb + 8));
    }
  }

  const size_t out_stride = static_cast<size_t>(H) * kMmaD;
  __nv_bfloat16* out = o + static_cast<size_t>(b) * L * out_stride + static_cast<size_t>(h) * kMmaD;
#pragma unroll
  for (int nt = 0; nt < kMmaD / 8; ++nt) {
    const int d = nt * 8 + 2 * t;
    if (r0 < L)
      *reinterpret_cast<uint32_t*>(out + r0 * out_stride + d) = pack_bf16(acc[nt][0], acc[nt][1]);
    if (r1 < L)
      *reinterpret_cast<uint32_t*>(out + r1 * out_stride + d) = pack_bf16(acc[nt][2], acc[nt][3]);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int kKeys, bool kRope>
int launch_mma(const void* q, const void* k, const void* v, const void* cos, const void* sin,
               void* o, int B, int L, int H, int ts_q, int ts_k, int ts_v, int causal,
               float scale, cudaStream_t stream) {
  constexpr size_t smem = mma_smem<kKeys>();
  auto kernel = attention_mma_kernel<kKeys, kRope>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kQTile - 1) / kQTile, H, B);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(cos),
      static_cast<const float*>(sin), static_cast<__nv_bfloat16*>(o), L, H, ts_q, ts_k, ts_v,
      causal, scale);
  return cudaGetLastError();
}

// --- dispatch ---------------------------------------------------------------

template <typename T, bool kRope>
int launch(const void* q, const void* k, const void* v, const void* cos, const void* sin,
           void* o, int B, int L, int H, int D, int ts_q, int ts_k, int ts_v, int causal,
           float scale, cudaStream_t stream, int* path) {
  if (D % 2 || B <= 0 || L <= 0 || H <= 0 || B > 65535 || H > 65535 || ts_q < H * D ||
      ts_k < H * D || ts_v < H * D)
    return cudaErrorInvalidValue;
  const bool ropes_aligned = !kRope || (aligned16(cos) && aligned16(sin));
  if (std::is_same<T, __nv_bfloat16>::value && D == kMmaD && L <= kMmaMaxL &&
      ts_q % 8 == 0 && ts_k % 8 == 0 && ts_v % 8 == 0 && aligned16(q) && aligned16(k) &&
      aligned16(v) && aligned16(o) && ropes_aligned) {
    *path = 1;
    if (L <= 128)
      return launch_mma<128, kRope>(q, k, v, cos, sin, o, B, L, H, ts_q, ts_k, ts_v, causal,
                                    scale, stream);
    return launch_mma<256, kRope>(q, k, v, cos, sin, o, B, L, H, ts_q, ts_k, ts_v, causal,
                                  scale, stream);
  }
  *path = 0;
  const size_t smem = sizeof(float) * (static_cast<size_t>(L) * (2 * D + 1) +
                                       static_cast<size_t>(kTile) * (D + L));
  if (smem > 232448) return cudaErrorInvalidValue;
  auto kernel = attention_kernel<T, kRope>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kTile - 1) / kTile, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(cos), static_cast<const float*>(sin), static_cast<T*>(o), L, H,
      D, ts_q, ts_k, ts_v, causal, scale);
  return cudaGetLastError();
}

template <bool kRope>
int dispatch(const void* q, const void* k, const void* v, const void* cos, const void* sin,
             void* o, int B, int L, int H, int D, int ts_q, int ts_k, int ts_v, int causal,
             float scale, int dtype, void* stream, int* path) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ddg::kF32)
    return launch<float, kRope>(q, k, v, cos, sin, o, B, L, H, D, ts_q, ts_k, ts_v, causal,
                                scale, s, path);
  if (dtype == ddg::kBF16)
    return launch<__nv_bfloat16, kRope>(q, k, v, cos, sin, o, B, L, H, D, ts_q, ts_k, ts_v,
                                        causal, scale, s, path);
  return cudaErrorInvalidValue;
}

}  // namespace

// K1. q, k, v: (B, L, H, D) with dense heads, rows ts_q, ts_k, ts_v
// elements apart; cos, sin: (L, D / 2) fp32; o: contiguous (B, L, H, D).
extern "C" int ddg_rope_attention(const void* q, const void* k, const void* v, const void* cos,
                                  const void* sin, void* o, int B, int L, int H, int D,
                                  int ts_q, int ts_k, int ts_v, int causal, float scale,
                                  int dtype, void* stream, int* path) {
  return dispatch<true>(q, k, v, cos, sin, o, B, L, H, D, ts_q, ts_k, ts_v, causal, scale,
                        dtype, stream, path);
}

// K2: the same without the rotation.
extern "C" int ddg_short_seq_attention(const void* q, const void* k, const void* v, void* o,
                                       int B, int L, int H, int D, int ts_q, int ts_k,
                                       int ts_v, int causal, float scale, int dtype,
                                       void* stream, int* path) {
  return dispatch<false>(q, k, v, nullptr, nullptr, o, B, L, H, D, ts_q, ts_k, ts_v, causal,
                         scale, dtype, stream, path);
}
