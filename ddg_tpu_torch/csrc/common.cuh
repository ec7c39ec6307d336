// Helpers shared by the ddg_tpu_torch kernels: 16-byte vector loads and
// stores of fp32 / bf16 rows as fp32 registers, warp reductions, the bf16
// tensor-core product (mma.sync m16n8k16) and its fragment loads, 2^x and
// log2 by the SFU, and the sampling kernels' Philox generator, Gumbel
// noise, the rule that skips the noise where it cannot win, and argmax
// merge.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ddg {

// Element type code passed from Python: 0 = float32, 1 = bfloat16.
enum DType : int { kF32 = 0, kBF16 = 1 };

template <typename T> struct Vec16;
template <> struct Vec16<float> { static constexpr int N = 4; };
template <> struct Vec16<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store16(float* p, const float* in) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* in) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = v;
}

// N consecutive fp32 values (N a multiple of 4, 16-byte aligned).
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float* out) {
#pragma unroll
  for (int i = 0; i < N; i += 4) load16(p + i, out + i);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Round an fp32 value to T and back (the cast the TPU kernels make).
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += A (16x16, row) * B (16x8, col), bf16 in, fp32 accumulate. Fragments
// of lane (g = lane / 4, t = lane % 4): a0 = A[g][2t..2t+1], a1 = A[g+8][2t..],
// a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]; b0 = B[2t..2t+1][g], b1 =
// B[2t+8..][g]; c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1].
__device__ __forceinline__ void mma_16816(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Philox4x32-10 (Salmon et al., SC'11): one call gives four 32-bit words
// for the counter c under the key k.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// Standard Gumbel noise from 32 random bits, as the TPU kernels' _gumbel
// builds it: the top 24 bits give u = top24 / 2^24 + 1e-10, then
// g = -log(-log(u)).
__device__ __forceinline__ float gumbel_from_bits(unsigned bits) {
  const float u = static_cast<float>(bits >> 8) * (1.0f / 16777216.0f) + 1e-10f;
  return -logf(-logf(u));
}

// 2^x and log2(x) by the SFU (ex2.approx / lg2.approx: 2 ulp; subnormal
// inputs and results flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLn2 = 0.693147180559945309f;

// The Gumbel noise of the absorbing steps K7 and K8 (absorbing_sample.cu),
// the uniform steps K9 and K10 (uniform_sample.cu) and the int8 head-fused
// step K12 (head_sample.cu); only K11 (the bf16 and fp32 head-fused step)
// still forms gumbel_from_bits.
//
// -log(u) for a normal u in (0, 1], to a few parts in 1e8 of itself (also
// near u = 1, where the SFU's lg2 is not): u = 2^e m with m in [2/3, 4/3),
// log(u) = e log(2) + log1p(f), f = m - 1 exact, and log1p(f) = f - f^2 / 2
// + f^3 R(f) with R a degree-6 fit on [-1/3, 1/3] (weighted minimax).
__device__ __forceinline__ float neg_log(float u) {
  const int ib = __float_as_int(u);
  const int e = (ib - 0x3f2aaaab) >> 23;
  const float f = __fsub_rn(__int_as_float(ib - static_cast<int>(static_cast<unsigned>(e) << 23)),
                            1.0f);
  const float ef = __fsub_rn(__int_as_float(0x4b400000 + e), 12582912.0f);  // e, exact
  float r = 0.13819070160388947f;
  r = __fmaf_rn(r, f, -0.15121205151081085f);
  r = __fmaf_rn(r, f, 0.1404252052307129f);
  r = __fmaf_rn(r, f, -0.1647246778011322f);
  r = __fmaf_rn(r, f, 0.200079083442688f);
  r = __fmaf_rn(r, f, -0.2500423192977905f);
  r = __fmaf_rn(r, f, 0.3333326578140259f);
  const float q = __fmaf_rn(r, f, -0.5f);
  const float p = __fmaf_rn(q, __fmul_rn(f, f), f);
  return -__fmaf_rn(ef, kLn2, p);
}

// Standard Gumbel noise from 32 random bits: u = top24 / 2^24 + 1e-10 as
// gumbel_from_bits forms it, g = -log(-log(u)), the inner log neg_log's,
// the outer the SFU's (g within ~2e-6 of -log(-log u) in float64).
__device__ __forceinline__ float gumbel(unsigned bits) {
  const float u = __fmaf_rn(static_cast<float>(bits >> 8), 1.0f / 16777216.0f, 1e-10f);
  return __fmul_rn(lg2(neg_log(u)), -kLn2);
}

// Which noise can win. A column whose score is x + g beats `best` (the
// score of a column already formed) only if g > t = best - x, and g <=
// -log(1 - u) for every u: a column with 1 - u >= e^-t (t less a margin
// for the fp32 roundings of g and of x + g and for ex2's error) cannot
// win, and its noise need not be formed. Those are the columns whose
// Philox word's top 24 bits are at most the value returned; x may be the
// largest of a group's x, which bounds every column of the group.
__device__ __forceinline__ int noise_kmax(float best, float x) {
  const float t = best - x - (1e-3f + fabsf(best) * 0x1p-20f);
  const float c = ex2(-t * 1.4426950408889634f) * (1.f + 0x1p-16f);
  return __float2int_rd(__fmaf_rn(-c, 16777216.f, 16777215.f));
}

// Online (max, sum of exp) pair: merge (m2, s2) into (m, s).
__device__ __forceinline__ void merge_ms(float& m, float& s, float m2, float s2) {
  const float mx = fmaxf(m, m2);
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

// merge_ms over the warp; every lane ends with the result.
__device__ __forceinline__ void warp_merge_ms(float& m, float& s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    merge_ms(m, s, m2, s2);
  }
}

// Argmax pair: keep (v2, i2) if larger, or equal with a lower index.
__device__ __forceinline__ void merge_arg(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// Argmax over the warp, the lowest index winning ties; every lane ends
// with the result.
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, v, o);
    const int i2 = __shfl_xor_sync(0xffffffffu, i, o);
    merge_arg(v, i, v2, i2);
  }
}

}  // namespace ddg
