// Head-fused absorbing-state denoise step: the vocab projection of the
// head features, SUBS + posterior + Gumbel-argmax + copy-over, without
// the (B, L, V) logits ever reaching device memory.
//
// Replaces the TPU kernels in ddg_tpu/ops/fused_sampling.py (one body,
// _head_kernel :464-556):
//   fused_absorbing_head_sample      (pallas_call :617)  bf16 or fp32
//   fused_absorbing_head_sample_int8 (pallas_call :705)  s8 x s8 -> s32
// For each token (b, l), over the vocabulary rows v < V of the head:
//   z_v     = W_v . f + bias_v                   (bf16 / fp32: fp32 sum)
//   z_v     = (float(Wq_v . fq) * xs) * ws_v + bias_v      (int8: s32 sum)
//   lse     = log sum_{v != mask} exp(z_v)
//   best    = max_{v != mask} z_v + g_v, the lowest index winning ties
//   pm_non  = best - lse + log(mct - mcs);  pm_mask = log(mcs) + g_mask
//   out     = xt where xt != mask (copy-over); else the best index when
//             pm_non >= pm_mask, else the mask
// g is standard Gumbel noise, read from a (B, Vp, L) fp32 tensor or made
// here by K7's generator: Philox4x32-10 keyed on the seed, counter
// (v / 4, l, b), word v % 4, u = top24 / 2^24 + 1e-10, g = -log(-log(u)).
// With that key the kernel draws the same noise as K7 (absorbing_sample.cu)
// run on the materialised logits.
//
// Bound on the H100: tensor operations. At the LM1B slice (3072 tokens,
// D = 768, V = 30523) the product is 144 G operations, 0.146 ms in bf16 at
// 989 TFLOP/s and 0.073 ms in int8 at 1979 TOP/s; W and the features are
// 52 MB (bf16) or 26 MB (int8), and the epilogue's exps and logs ~0.07 ms
// of SFU time.
//
// Design (a first, simple kernel; wgmma and TMA are later work): one
// block of 8 warps takes 128 tokens and a contiguous range of 128-row
// vocab chunks (the vocab is split across blockIdx.y so that the 24 token
// tiles of the slice fill the card). For every chunk the block runs a
// 128 x 128 product over the whole of D through a 4-stage cp.async ring
// of 64-byte K slices (A = features, B = weight rows, both K-contiguous,
// rows padded to 80 bytes so that ldmatrix is free of bank conflicts),
// then an epilogue on the accumulators: each warp holds 32 tokens x 64
// vocab rows in the mma C layout (a lane: 4 tokens x 16 rows), and keeps
// per token an online (max, sum of exps), the best perturbed score and its
// index, and the mask channel's Gumbel. Philox words come four to a call;
// a lane holds two adjacent vocab rows of two tokens, so lane pairs split
// the calls (one token each) and swap the halves they do not own. At the
// end the per-token states are merged across the quad's lanes and the two
// vocab warps, and written per (split, token); a second small launch
// merges the splits in order and makes the pick. No atomics: reruns give
// identical tokens. Token tiles whose tokens are all decoded exit at once.
// bf16 runs mma.sync m16n8k16 (fp32 accumulators); int8 runs m16n8k32
// (s32, exact) with the rescale in explicit __fmul_rn / __fadd_rn, so that
// the logits equal PyTorch's separate multiply and add bit for bit; fp32
// (a float32 head) runs FMAs on the CUDA cores from the same staged
// tiles, never TF32.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;                       // tokens a block
constexpr int kBN = 128;                       // vocab rows a chunk
constexpr int kRow = 64;                       // K bytes of a staged row
constexpr int kStride = kRow + 16;             // padded row, bytes
constexpr int kStages = 4;
constexpr int kStageBytes = (kBM + kBN) * kStride;
constexpr int kSmem = kStages * kStageBytes;   // 80 KB
constexpr float kNeg = -1e30f;

enum Mode : int { kModeF32 = 0, kModeBF16 = 1, kModeS8 = 2 };

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += A (16x32, row) * B (32x8, col), s8 in, s32 accumulate. The byte
// layout of the fragments is that of m16n8k16 bf16: a0 = A[g][4t..4t+3],
// a1 = A[g+8][4t..], a2 = A[g][16+4t..], a3 = A[g+8][16+4t..]; b0 =
// B[4t..4t+3][g], b1 = B[16+4t..][g]; c as in mma_16816.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The logit a finished accumulator holds (the int8 path keeps its float
// bits in the int register).
__device__ __forceinline__ float as_logit(float v) { return v; }
__device__ __forceinline__ float as_logit(int v) { return __int_as_float(v); }

template <int kMode> struct Traits;
template <> struct Traits<kModeF32> { using Acc = float; };
template <> struct Traits<kModeBF16> { using Acc = float; };
template <> struct Traits<kModeS8> { using Acc = int; };

struct Args {
  const int* seed;
  const int* xt;
  const char* feats;     // (T, D) in the mode's type, T = B * L
  const char* w;         // (Vp, D) in the mode's type
  const float* bias;     // (Vp,)
  const float* x_scale;  // (T,), int8 only
  const float* w_scale;  // (Vp,), int8 only
  const float* gumbel;   // (B, Vp, L) or null
  float* logits_out;     // (T, Vp) or null: a probe of the logits
  float* part;           // (5, splits, T): m, s, best, idx (int), mask Gumbel
  int T, L, D_bytes, Vp, V, mask_index, chunks_per_split;
};

// The per-token running state of the epilogue.
struct RowState {
  float m, s, best, mg;
  int idx;
};

template <int kMode>
__global__ void __launch_bounds__(kThreads, 2) head_sample_kernel(const Args a) {
  using Acc = typename Traits<kMode>::Acc;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;     // 4 token rows x 2 vocab columns of warps
  const int g = lane >> 2, t = lane & 3;
  const int tok0 = blockIdx.x * kBM;
  const int splits = gridDim.y, sp = blockIdx.y;

  // A tile whose tokens are all decoded has nothing to sample.
  const bool live = tid < kBM && tok0 + tid < a.T && a.xt[tok0 + tid] == a.mask_index;
  if (!__syncthreads_or(live)) return;

  const int n_ch = a.Vp / kBN;
  const int ch0 = sp * a.chunks_per_split;
  const int ch1 = min(n_ch, ch0 + a.chunks_per_split);
  const int nk = a.D_bytes / kRow;
  const int total = (ch1 - ch0) * nk;

  auto load_stage = [&](int gidx) {
    const int ch = ch0 + gidx / nk, kb = (gidx % nk) * kRow;
    unsigned char* st = smem + (gidx % kStages) * kStageBytes;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kThreads, r = idx >> 2, c = (idx & 3) * 16;
      const int tok = tok0 + r;
      const bool ok = tok < a.T;
      cp_async16(st + r * kStride + c, a.feats + (size_t)(ok ? tok : 0) * a.D_bytes + kb + c, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kThreads, r = idx >> 2, c = (idx & 3) * 16;
      const size_t v = (size_t)ch * kBN + r;
      cp_async16(st + (kBM + r) * kStride + c, a.w + v * a.D_bytes + kb + c, true);
    }
  };

  Acc acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = Acc(0);

  RowState st[2][2];   // [m-tile][row g or g + 8]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) st[i][h] = RowState{kNeg, 0.f, -INFINITY, 0.f, 0x7fffffff};

  const unsigned seed = a.gumbel ? 0u : static_cast<unsigned>(a.seed[0]);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load_stage(s);
    cp_async_commit();
  }

  for (int gi = 0; gi < total; ++gi) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (gi + kStages - 1 < total) load_stage(gi + kStages - 1);
    cp_async_commit();

    const unsigned char* sa = smem + (gi % kStages) * kStageBytes;
    const unsigned char* sb = sa + kBM * kStride;
    if constexpr (kMode == kModeF32) {
      // CUDA-core FMAs into the mma C layout: rows wm*32 + i*16 + h*8 + g,
      // columns wn*64 + j*8 + 2t + e.
#pragma unroll
      for (int k4 = 0; k4 < kRow / 16; ++k4) {
        float4 av[2][2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            av[i][h] = *reinterpret_cast<const float4*>(
                sa + (wm * 32 + i * 16 + h * 8 + g) * kStride + k4 * 16);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float4 bv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            bv[e] = *reinterpret_cast<const float4*>(
                sb + (wn * 64 + j * 8 + 2 * t + e) * kStride + k4 * 16);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float& c = acc[i][j][h * 2 + e];
                c = fmaf(av[i][h].x, bv[e].x, c);
                c = fmaf(av[i][h].y, bv[e].y, c);
                c = fmaf(av[i][h].z, bv[e].z, c);
                c = fmaf(av[i][h].w, bv[e].w, c);
              }
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kRow / 32; ++kk) {
        uint32_t af[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldmatrix_x4(af[i], sa + (wm * 32 + i * 16 + (lane & 15)) * kStride + kk * 32 +
                                 (lane >> 4) * 16);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          uint32_t bf[4];
          ldmatrix_x4(bf, sb + (wn * 64 + p * 16 + (lane & 7) + ((lane >> 4) << 3)) * kStride +
                              kk * 32 + ((lane >> 3) & 1) * 16);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if constexpr (kMode == kModeBF16) {
              ddg::mma_16816(acc[i][2 * p], af[i][0], af[i][1], af[i][2], af[i][3], bf[0], bf[1]);
              ddg::mma_16816(acc[i][2 * p + 1], af[i][0], af[i][1], af[i][2], af[i][3], bf[2],
                             bf[3]);
            } else {
              mma_s8(acc[i][2 * p], af[i], bf[0], bf[1]);
              mma_s8(acc[i][2 * p + 1], af[i], bf[2], bf[3]);
            }
          }
        }
      }
    }

    if (gi % nk != nk - 1) continue;

    // ---- Epilogue of chunk ch: the logits of this lane's 4 tokens x 16
    // vocab rows, then the online updates.
    const int vb = (ch0 + gi / nk) * kBN + wn * 64;
    float xs[2][2] = {{1.f, 1.f}, {1.f, 1.f}};
    int tk[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        tk[i][h] = tok0 + wm * 32 + i * 16 + h * 8 + g;
        if constexpr (kMode == kModeS8)
          xs[i][h] = tk[i][h] < a.T ? a.x_scale[tk[i][h]] : 1.f;
      }
    // The logits, in place (as raw float bits for the int8 accumulators).
    float tmax[2][2] = {{kNeg, kNeg}, {kNeg, kNeg}};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int v = vb + j * 8 + 2 * t;
      const float2 bias = *reinterpret_cast<const float2*>(a.bias + v);
      float2 ws = make_float2(1.f, 1.f);
      if constexpr (kMode == kModeS8) ws = *reinterpret_cast<const float2*>(a.w_scale + v);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int h = q >> 1, e = q & 1;
          float z;
          if constexpr (kMode == kModeS8) {
            z = __fadd_rn(__fmul_rn(__fmul_rn(static_cast<float>(acc[i][j][q]), xs[i][h]),
                                    e ? ws.y : ws.x),
                          e ? bias.y : bias.x);
            acc[i][j][q] = __float_as_int(z);
          } else {
            z = __fadd_rn(acc[i][j][q], e ? bias.y : bias.x);
            acc[i][j][q] = z;
          }
          if (a.logits_out && tk[i][h] < a.T) a.logits_out[(size_t)tk[i][h] * a.Vp + v + e] = z;
          if (v + e < a.V && v + e != a.mask_index) tmax[i][h] = fmaxf(tmax[i][h], z);
        }
    }
    // The (b, l) of the token whose Philox words this lane draws.
    int own_b[2], own_l[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      own_b[i] = tk[i][t & 1] / a.L;
      own_l[i] = tk[i][t & 1] - own_b[i] * a.L;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (tmax[i][h] > st[i][h].m) {
          st[i][h].s *= expf(st[i][h].m - tmax[i][h]);
          st[i][h].m = tmax[i][h];
        }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int v = vb + j * 8 + 2 * t;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float gn[4];   // [h * 2 + e]
        if (a.gumbel) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int tok = min(tk[i][q >> 1], a.T - 1);
            const int b = tok / a.L, l = tok - b * a.L;
            gn[q] = a.gumbel[((size_t)b * a.Vp + v + (q & 1)) * a.L + l];
          }
        } else {
          // Lane pairs (t, t ^ 1) share v / 4: the even lane draws the
          // word quad of token row g, the odd lane that of row g + 8.
          const int odd = t & 1;
          const uint4 r = ddg::philox4x32_10(
              make_uint4(static_cast<unsigned>(v >> 2), static_cast<unsigned>(own_l[i]),
                         static_cast<unsigned>(own_b[i]), 0u),
              make_uint2(seed, 0u));
          const unsigned give0 = odd ? r.x : r.z, give1 = odd ? r.y : r.w;
          const unsigned got0 = __shfl_xor_sync(0xffffffffu, give0, 1);
          const unsigned got1 = __shfl_xor_sync(0xffffffffu, give1, 1);
          // Even lane: row g words (x, y) own, row g + 8 words (x, y)
          // from its partner. Odd lane: row g words (z, w) from its
          // partner, row g + 8 words (z, w) own.
          const unsigned w0 = odd ? got0 : r.x, w1 = odd ? got1 : r.y;
          const unsigned w2 = odd ? r.z : got0, w3 = odd ? r.w : got1;
          gn[0] = ddg::gumbel_from_bits(w0);
          gn[1] = ddg::gumbel_from_bits(w1);
          gn[2] = ddg::gumbel_from_bits(w2);
          gn[3] = ddg::gumbel_from_bits(w3);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int h = q >> 1, vv = v + (q & 1);
          RowState& r = st[i][h];
          const float z = as_logit(acc[i][j][q]);
          if (vv == a.mask_index) {
            r.mg += gn[q];
          } else if (vv < a.V) {
            r.s += expf(z - r.m);
            const float p = __fadd_rn(z, gn[q]);
            if (p > r.best) {
              r.best = p;
              r.idx = vv;
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = Acc(0);
  }

  // ---- Merge the per-lane states: across the quad, then the two vocab warps.
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);   // [5][2][kBM]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      RowState& r = st[i][h];
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const float m2 = __shfl_xor_sync(0xffffffffu, r.m, o);
        const float s2 = __shfl_xor_sync(0xffffffffu, r.s, o);
        const float b2 = __shfl_xor_sync(0xffffffffu, r.best, o);
        const int i2 = __shfl_xor_sync(0xffffffffu, r.idx, o);
        const float g2 = __shfl_xor_sync(0xffffffffu, r.mg, o);
        ddg::merge_ms(r.m, r.s, m2, s2);
        ddg::merge_arg(r.best, r.idx, b2, i2);
        r.mg += g2;
      }
      if (t == 0) {
        const int row = wm * 32 + i * 16 + h * 8 + g;
        red[(0 * 2 + wn) * kBM + row] = r.m;
        red[(1 * 2 + wn) * kBM + row] = r.s;
        red[(2 * 2 + wn) * kBM + row] = r.best;
        red[(3 * 2 + wn) * kBM + row] = __int_as_float(r.idx);
        red[(4 * 2 + wn) * kBM + row] = r.mg;
      }
    }
  __syncthreads();
  if (tid < kBM && tok0 + tid < a.T) {
    float m = red[0 * kBM + tid], s = red[2 * kBM + tid], best = red[4 * kBM + tid];
    int idx = __float_as_int(red[6 * kBM + tid]);
    float mg = red[8 * kBM + tid];
    ddg::merge_ms(m, s, red[1 * kBM + tid], red[3 * kBM + tid]);
    ddg::merge_arg(best, idx, red[5 * kBM + tid], __float_as_int(red[7 * kBM + tid]));
    mg += red[9 * kBM + tid];
    const size_t o = (size_t)sp * a.T + tok0 + tid, n = (size_t)splits * a.T;
    a.part[o] = m;
    a.part[n + o] = s;
    a.part[2 * n + o] = best;
    a.part[3 * n + o] = __int_as_float(idx);
    a.part[4 * n + o] = mg;
  }
}

// One thread a token: merge the splits in order, then the posterior pick
// and the copy-over (_head_kernel's _final, :539-556).
__global__ void head_merge_kernel(const int* __restrict__ xt, const float* __restrict__ mct,
                                  const float* __restrict__ mcs, const float* __restrict__ part,
                                  int* __restrict__ out, int T, int L, int splits,
                                  int mask_index) {
  const int tok = blockIdx.x * blockDim.x + threadIdx.x;
  if (tok >= T) return;
  const int x = xt[tok];
  if (x != mask_index) {
    out[tok] = x;
    return;
  }
  const size_t n = (size_t)splits * T;
  float m = part[tok], s = part[n + tok], best = part[2 * n + tok];
  int idx = __float_as_int(part[3 * n + tok]);
  float mg = part[4 * n + tok];
  for (int sp = 1; sp < splits; ++sp) {
    const size_t o = (size_t)sp * T + tok;
    ddg::merge_ms(m, s, part[o], part[n + o]);
    ddg::merge_arg(best, idx, part[2 * n + o], __float_as_int(part[3 * n + o]));
    mg += part[4 * n + o];
  }
  const int b = tok / L;
  const float lse = __fadd_rn(m, logf(s));
  const float pm_non = __fadd_rn(__fsub_rn(best, lse), logf(mct[b] - mcs[b]));
  const float pm_mask = __fadd_rn(logf(mcs[b]), mg);
  out[tok] = pm_non >= pm_mask ? idx : mask_index;
}

template <int kMode>
int launch(const Args& a, int splits, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        head_sample_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((a.T + kBM - 1) / kBM, splits);
  head_sample_kernel<kMode><<<grid, kThreads, kSmem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// mode: 0 fp32, 1 bf16, 2 int8 (then x_scale and w_scale are read).
// part: 5 * splits * B * L fp32 of scratch. Returns a CUDA error code.
extern "C" int ddg_head_sample(const void* seed, const void* xt, const void* feats,
                               const void* w, const void* bias, const void* x_scale,
                               const void* w_scale, const void* mct, const void* mcs,
                               const void* gumbel, void* out, void* part, void* logits_out,
                               int B, int L, int D, int Vp, int V, int mask_index, int mode,
                               int splits, void* stream) {
  const int es = mode == kModeF32 ? 4 : mode == kModeBF16 ? 2 : mode == kModeS8 ? 1 : 0;
  const int n_ch = Vp / kBN;
  if (es == 0 || B <= 0 || L <= 0 || D <= 0 || (D * es) % kRow || Vp <= 0 || Vp % kBN ||
      V < 2 || V > Vp || mask_index < 0 || mask_index >= V || splits <= 0 || splits > n_ch ||
      (mode == kModeS8 && (!x_scale || !w_scale)))
    return cudaErrorInvalidValue;
  Args a;
  a.seed = static_cast<const int*>(seed);
  a.xt = static_cast<const int*>(xt);
  a.feats = static_cast<const char*>(feats);
  a.w = static_cast<const char*>(w);
  a.bias = static_cast<const float*>(bias);
  a.x_scale = static_cast<const float*>(x_scale);
  a.w_scale = static_cast<const float*>(w_scale);
  a.gumbel = static_cast<const float*>(gumbel);
  a.logits_out = static_cast<float*>(logits_out);
  a.part = static_cast<float*>(part);
  a.T = B * L;
  a.L = L;
  a.D_bytes = D * es;
  a.Vp = Vp;
  a.V = V;
  a.mask_index = mask_index;
  a.chunks_per_split = (n_ch + splits - 1) / splits;
  if ((n_ch + a.chunks_per_split - 1) / a.chunks_per_split != splits) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  int rc = mode == kModeF32    ? launch<kModeF32>(a, splits, s)
           : mode == kModeBF16 ? launch<kModeBF16>(a, splits, s)
                               : launch<kModeS8>(a, splits, s);
  if (rc) return rc;
  head_merge_kernel<<<(a.T + 255) / 256, 256, 0, s>>>(a.xt, static_cast<const float*>(mct),
                                                       static_cast<const float*>(mcs), a.part,
                                                       static_cast<int*>(out), a.T, L, splits,
                                                       mask_index);
  return cudaGetLastError();
}
