// Fused RoPE + softmax attention, backward (K1b), on the token-major layout.
//
// Replaces the backward of ddg_tpu/ops/attention_pallas.py:fused_rope_attention,
// _rope_flash_bwd (:233-248): there a plain-jnp recompute whose VJP, through
// _rope_reference (:190-203) and _reference (:63-75), rounds where this
// kernel rounds. For each (b, h), from the saved q, k, v and the output
// gradient dO, all of shape (B, L, H, D):
//   q' = RoPE(q), k' = RoPE(k)     fp32, rounded to the input dtype
//   P  = softmax(q' k'^T / sqrt(D)) fp32 (causal: keys j > i masked)
//   dV = round(P)^T dO             round(P) = P in v's dtype, fp32 sums
//   dP = dO V^T                    rounded to the input dtype
//   dS = P dP - P delta            delta = sum_j P dP (as the VJP of softmax)
//   dq' = (dS / sqrt(D)) k',  dk' = (dS / sqrt(D))^T q'   rounded to the input dtype
//   dq = RoPE^T(dq'), dk = RoPE^T(dk')   (x1, x2) <- (g1 c + g2 s, g2 c - g1 s)
//
// Bound on the H100 at the training shape (micro-batch B=256, L=128, H=12,
// D=64): 7 B L H D elements moved, 352 MB in bf16, take 0.105 ms at
// 3.35 TB/s; five L x L x D products, 10 B H L^2 D = 32.2 GFLOP, take
// 0.033 ms at the bf16 tensor-core rate (989 TFLOP/s). So the function is
// bound by bytes. This kernel does the products with fp32 FMAs on the CUDA
// cores, which cannot take less than 0.48 ms (67 TFLOP/s).
//
// Design: one block of 256 threads per (head, batch), for D = 64 and
// L <= 128, the DiT's shapes (the wrapper raises on others). The block
// stages q', k', v and dO of its head in fp32 (four 128 x 65 tiles, rows
// padded against bank conflicts, rows past L zero) and the scores of the
// head in a 128 x 129 tile: 199 KB of shared memory, so no intermediate
// touches device memory. The scores become P in place, then dS in place
// once dV has read P. Each product runs as a 16 x 16 grid of threads, each
// thread holding an 8 x 8 (or 8 x 4) tile of the result in registers, one
// operand broadcast within a half-warp and the other read along padded
// rows, so the shared-memory loads are conflict-free. The softmax takes a
// warp per row; delta is reduced over the 16 threads of a row with
// shuffles. The un-rotation pairs columns d and d + 32, which one thread
// holds.

#include "common.cuh"

namespace {

constexpr int kD = 64;
constexpr int kMaxL = 128;
constexpr int kThreads = 256;        // 16 x 16
constexpr int kRow = kD + 1;         // padded fp32 row of q', k', v, dO
constexpr int kPRow = kMaxL + 1;     // padded fp32 row of P / dS
constexpr size_t kSmem = sizeof(float) * (4 * kMaxL * kRow + kMaxL * kPRow);
constexpr float kNeg = -1e30f;

// acc[a][b] = sum_k A[(ty + 16 a) am + k ak] * Bm[k bk + (tx + 16 b) bn],
// A optionally rounded to T on load.
template <int TM, int TN, bool kRoundA, typename T>
__device__ __forceinline__ void tile_mm(float (&acc)[TM][TN], const float* A, int am, int ak,
                                        const float* Bm, int bk, int bn, int K, int ty, int tx) {
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int b = 0; b < TN; ++b) acc[a][b] = 0.f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[TM], bv[TN];
#pragma unroll
    for (int a = 0; a < TM; ++a) {
      const float x = A[(ty + 16 * a) * am + k * ak];
      av[a] = kRoundA ? ddg::round_to<T>(x) : x;
    }
#pragma unroll
    for (int b = 0; b < TN; ++b) bv[b] = Bm[k * bk + (tx + 16 * b) * bn];
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int b = 0; b < TN; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
  }
}

// Round an (8 rows x 4 column-groups) tile of dq' or dk' to T, undo the
// rotation and store it: columns tx + 16 b and tx + 16 b + 32 are a pair.
template <typename T>
__device__ __forceinline__ void store_unrotated(const float (&acc)[8][4], T* out, size_t head,
                                                size_t row_stride, const float* cos,
                                                const float* sin, int L, int ty, int tx) {
  constexpr int half = kD / 2;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = ty + 16 * a;
    if (i >= L) continue;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int f = tx + 16 * b;
      const float g1 = ddg::round_to<T>(acc[a][b]);
      const float g2 = ddg::round_to<T>(acc[a][b + 2]);
      const float c = cos[i * half + f], s = sin[i * half + f];
      T* row = out + head + static_cast<size_t>(i) * row_stride;
      row[f] = ddg::from_f32<T>(__fadd_rn(__fmul_rn(g1, c), __fmul_rn(g2, s)));
      row[f + half] = ddg::from_f32<T>(__fsub_rn(__fmul_rn(g2, c), __fmul_rn(g1, s)));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rope_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const float* __restrict__ cos,
                              const float* __restrict__ sin, const T* __restrict__ dout,
                              T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, int L,
                              int H, int tok_stride, int causal, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                   // kMaxL x kRow
  float* Ks = Qs + kMaxL * kRow;
  float* Vs = Ks + kMaxL * kRow;
  float* Os = Vs + kMaxL * kRow;      // dO
  float* Ps = Os + kMaxL * kRow;      // kMaxL x kPRow: S, then P, then dS / sqrt(D)
  constexpr int half = kD / 2;
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  // q, k, v rows are tok_stride elements apart; dO, dq, dk, dv are
  // contiguous (B, L, H, D).
  const size_t in_head = static_cast<size_t>(b) * L * tok_stride + static_cast<size_t>(h) * kD;
  const size_t out_stride = static_cast<size_t>(H) * kD;
  const size_t out_head = static_cast<size_t>(b) * L * out_stride + static_cast<size_t>(h) * kD;

  for (int idx = tid; idx < kMaxL * half; idx += kThreads) {
    const int j = idx / half, f = idx % half;
    float q1 = 0.f, q2 = 0.f, k1 = 0.f, k2 = 0.f, v1 = 0.f, v2 = 0.f, o1 = 0.f, o2 = 0.f;
    if (j < L) {
      const size_t off = in_head + static_cast<size_t>(j) * tok_stride;
      const float c = cos[j * half + f], s = sin[j * half + f];
      float x1 = ddg::to_f32(q[off + f]), x2 = ddg::to_f32(q[off + f + half]);
      q1 = ddg::round_to<T>(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s)));
      q2 = ddg::round_to<T>(__fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s)));
      x1 = ddg::to_f32(k[off + f]);
      x2 = ddg::to_f32(k[off + f + half]);
      k1 = ddg::round_to<T>(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s)));
      k2 = ddg::round_to<T>(__fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s)));
      v1 = ddg::to_f32(v[off + f]);
      v2 = ddg::to_f32(v[off + f + half]);
      const size_t go = out_head + static_cast<size_t>(j) * out_stride;
      o1 = ddg::to_f32(dout[go + f]);
      o2 = ddg::to_f32(dout[go + f + half]);
    }
    Qs[j * kRow + f] = q1;
    Qs[j * kRow + f + half] = q2;
    Ks[j * kRow + f] = k1;
    Ks[j * kRow + f + half] = k2;
    Vs[j * kRow + f] = v1;
    Vs[j * kRow + f + half] = v2;
    Os[j * kRow + f] = o1;
    Os[j * kRow + f + half] = o2;
  }
  __syncthreads();

  {  // S = q' k'^T / sqrt(D), masked
    float acc[8][8];
    tile_mm<8, 8, false, T>(acc, Qs, kRow, 1, Ks, 1, kRow, kD, ty, tx);
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int i = ty + 16 * a, j = tx + 16 * c;
        float s = acc[a][c] * scale;
        if (j >= L || (causal && j > i)) s = kNeg;
        Ps[i * kPRow + j] = s;
      }
  }
  __syncthreads();

  {  // P = softmax(S) in fp32, a warp per row; rows past L are 0
    const int warp = tid >> 5, lane = tid & 31;
    for (int i = warp; i < kMaxL; i += kThreads / 32) {
      float* row = Ps + i * kPRow;
      if (i >= L) {
        for (int j = lane; j < kMaxL; j += 32) row[j] = 0.f;
        continue;
      }
      float m = kNeg;
      for (int j = lane; j < kMaxL; j += 32) m = fmaxf(m, row[j]);
      m = ddg::warp_max(m);
      float sum = 0.f;
      for (int j = lane; j < kMaxL; j += 32) {
        const float e = expf(row[j] - m);
        row[j] = e;
        sum += e;
      }
      sum = ddg::warp_sum(sum);
      for (int j = lane; j < kMaxL; j += 32) row[j] = row[j] / sum;
    }
  }
  __syncthreads();

  {  // dV = round(P)^T dO
    float acc[8][4];
    tile_mm<8, 4, true, T>(acc, Ps, 1, kPRow, Os, kRow, 1, kMaxL, ty, tx);
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int j = ty + 16 * a;
      if (j >= L) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        dv[out_head + static_cast<size_t>(j) * out_stride + tx + 16 * c] =
            ddg::from_f32<T>(acc[a][c]);
    }
  }
  __syncthreads();

  {  // dP = dO V^T (rounded), delta = rowsum(P dP), dS = P dP - P delta
    float acc[8][8], part[8];
    tile_mm<8, 8, false, T>(acc, Os, kRow, 1, Vs, 1, kRow, kD, ty, tx);
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      part[a] = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        acc[a][c] = ddg::round_to<T>(acc[a][c]);
        part[a] = fmaf(Ps[(ty + 16 * a) * kPRow + tx + 16 * c], acc[a][c], part[a]);
      }
      // The 16 threads of a row are lanes 0-15 or 16-31 of one warp.
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) part[a] += __shfl_xor_sync(0xffffffffu, part[a], o);
    }
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float* at = Ps + (ty + 16 * a) * kPRow + tx + 16 * c;
        const float p = *at;
        const float ds = __fsub_rn(__fmul_rn(p, acc[a][c]), __fmul_rn(p, part[a]));
        *at = __fmul_rn(ds, scale);
      }
  }
  __syncthreads();

  {  // dq' = dS k', dk' = dS^T q', then un-rotated
    float acc[8][4];
    tile_mm<8, 4, false, T>(acc, Ps, kPRow, 1, Ks, kRow, 1, kMaxL, ty, tx);
    store_unrotated<T>(acc, dq, out_head, out_stride, cos, sin, L, ty, tx);
    tile_mm<8, 4, false, T>(acc, Ps, 1, kPRow, Qs, kRow, 1, kMaxL, ty, tx);
    store_unrotated<T>(acc, dk, out_head, out_stride, cos, sin, L, ty, tx);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* cos, const void* sin,
           const void* dout, void* dq, void* dk, void* dv, int B, int L, int H, int tok_stride,
           int causal, float scale, cudaStream_t stream) {
  if (B <= 0 || L <= 0 || L > kMaxL || H <= 0 || tok_stride < H * kD)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(rope_attention_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmem));
  if (err != cudaSuccess) return err;
  rope_attention_bwd_kernel<T><<<dim3(H, B), kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(cos), static_cast<const float*>(sin),
      static_cast<const T*>(dout), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), L, H, tok_stride, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: (B, L, H, 64) with one token stride; cos, sin: (L, 32) fp32;
// dout and the outputs dq, dk, dv: contiguous (B, L, H, 64); L <= 128.
extern "C" int ddg_rope_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* cos, const void* sin, const void* dout,
                                      void* dq, void* dk, void* dv, int B, int L, int H,
                                      int tok_stride, int causal, float scale, int dtype,
                                      void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ddg::kF32)
    return launch<float>(q, k, v, cos, sin, dout, dq, dk, dv, B, L, H, tok_stride, causal,
                         scale, s);
  if (dtype == ddg::kBF16)
    return launch<__nv_bfloat16>(q, k, v, cos, sin, dout, dq, dk, dv, B, L, H, tok_stride,
                                 causal, scale, s);
  return cudaErrorInvalidValue;
}
