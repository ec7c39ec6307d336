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
// run on the materialised logits; the int8 wgmma kernel forms it with
// K7's own formula (ddg::gumbel), the others with ddg::gumbel_from_bits.
//
// Bound on the H100: tensor operations. At the LM1B slice (3072 tokens,
// D = 768, V = 30523) the product is 144 G operations, 0.146 ms in bf16 at
// 989 TFLOP/s and 0.073 ms in int8 at 1979 TOP/s; W and the features are
// 52 MB (bf16) or 26 MB (int8), the epilogue's exps and logs ~0.07 ms of
// SFU time, and its Philox rounds and conversions ~30 integer and fp32
// instructions a logit, ~0.08 ms of issue on the CUDA cores.
//
// Three designs, by `head_plan` (from the shape alone): the bf16 head runs
// `hw::head_wgmma_kernel` (TMA, wgmma, warp-specialised; described at its
// namespace below) where its feature tiles fit (D up to 1280), the int8
// head `s8::head_s8_kernel` (the same shape on int8 wgmma, with a wider
// epilogue that forms K7's noise only where it can win; its namespace
// below) where its tiles fit (D up to 2560); every other call runs the
// first design:
//
// One block of 8 warps takes 128 tokens and a contiguous range of 128-row
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

#include "async.cuh"
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

// Keep (sc, v) as the best if it beats it, the lower index winning ties.
__device__ __forceinline__ void take_best(RowState& st, float sc, int v) {
  if (sc > st.best || (sc == st.best && v < st.idx)) {
    st.best = sc;
    st.idx = v;
  }
}

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

// ---- The bf16 kernel for Hopper (path 1 of `head_plan`) -----------------
//
// A block takes kTok = 64 tokens and one vocab split of kSplitChunks chunks
// of kVt = 128 rows (the last split what is left), with its warps
// specialised:
//   - the producer (the last warp's first thread) loads the block's
//     features once (D / 64 tiles of 64 x 64 bf16 in the 128-byte swizzle,
//     by TMA) and W's tiles of 128 rows x 64 columns through a ring of
//     kStages slots (TMA, the 128-byte swizzle, an mbarrier a slot);
//   - warpgroup 0 runs each chunk's product (wgmma m64n128k16, A and B
//     from shared memory, 64 fp32 accumulators a thread, kInFlight slabs
//     left running behind the newest) and writes its logits to a 64 x 128
//     fp32 tile in shared memory;
//   - warpgroups 1 and 2 run the epilogue of each tile, a token and 32
//     consecutive vocab rows a thread: the bias, the online (max, sum of
//     exps), the Gumbel noise (K7's Philox words: kPhilox calls of a
//     thread's rows run round by round side by side, so their chains
//     overlap), the perturbed scores, and the tile's sum of exps and best
//     score (the lowest index winning ties) by fixed trees, merged into
//     the token's state, and the mask's Gumbel.
// The two sides hand each tile over by two mbarriers. At the split's end
// each token's four states are merged by shuffles in a fixed order and
// written per (split, token); `head_merge_kernel` merges the splits in
// order. The split and every merge's order follow the shape only, so a
// token's bits follow its inputs and not the card. The sum of exps uses
// __expf and the Gumbel noise's outer log __logf (each within 2 ulp); the
// inner log, whose argument nears 1 for the largest draws, stays logf.
// Thirteen warps leave each thread 128 registers, without spills.
//
// Layouts tried before this one and dropped (no script of the repo times
// them, so no times are given): consumer warpgroups that each ran their
// own chunks' products and epilogues in turn (ping-pong by named
// barriers), which left one or two warps an SMSP on the latency-bound
// epilogue; `setmaxnreg`, which did not lift ptxas's allocation above the
// launch bound's; a cluster of 2 with W's tiles multicast, whose products
// were slower than each block loading its own W tiles.
namespace hw {

constexpr int kTok = 64;                 // tokens a block: one wgmma M
constexpr int kVt = 128;                 // vocab rows a chunk: one wgmma N
constexpr int kSplitChunks = 8;          // chunks a split: 1024 vocab rows
constexpr int kEpiThreads = 256;         // two epilogue warpgroups
constexpr int kThreads = 128 + kEpiThreads + 32;  // and the producer's warp
constexpr int kInFlight = 2;             // wgmma groups (slabs) left running behind the newest
constexpr int kPhilox = 2;               // Philox calls of a thread run side by side
constexpr int kTileBytes = kTok * 128;   // a feature tile: 64 rows x 64 bf16
constexpr int kStageBytes = kVt * 128;   // a W slot: 128 rows x 64 bf16
constexpr int kZRow = kVt + 4;           // the logits tile's padded row, floats
constexpr int kZBytes = kTok * kZRow * 4;
constexpr int kMaxStages = 8;
constexpr int kSmemMax = 232448;
constexpr int kAlign = 1024;             // the 128-byte swizzle's repeat

// Shared memory of a block with nk feature tiles and `stages` W slots
// (with the logits tile, the alignment slack and the mbarriers).
__host__ __device__ constexpr int smem_bytes(int nk, int stages) {
  return kAlign + nk * kTileBytes + stages * kStageBytes + kZBytes + 8 * (2 * stages + 3);
}
__host__ __device__ constexpr int stages_for(int nk) {
  int s = kMaxStages;
  while (s > 0 && smem_bytes(nk, s) > kSmemMax) --s;
  return s;
}

__device__ __forceinline__ uint64_t desc128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// The thread's index, read where it is used: ptxas cannot keep a value
// formed from it live across the epilogue's loop (it spilled two such).
__device__ __forceinline__ int thread_x() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

// Pin the accumulators here: no read or write of them moves across.
__device__ __forceinline__ void pin(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Standard Gumbel noise from 32 random bits as ddg::gumbel_from_bits, the
// outer log by the SFU (its argument, -log u, is never near 1).
__device__ __forceinline__ float gumbel_bits(unsigned bits) {
  const float u = static_cast<float>(bits >> 8) * (1.0f / 16777216.0f) + 1e-10f;
  return -__logf(-logf(u));
}

// One Philox4x32-10 round (`ddg::philox4x32_10`'s), each product's high
// and low words from one 64-bit multiply.
__device__ __forceinline__ uint4 philox_round(uint4 c, unsigned k0, unsigned k1) {
  const unsigned long long p0 = static_cast<unsigned long long>(0xD2511F53u) * c.x;
  const unsigned long long p1 = static_cast<unsigned long long>(0xCD9E8D57u) * c.z;
  return make_uint4(static_cast<unsigned>(p1 >> 32) ^ c.y ^ k0, static_cast<unsigned>(p1),
                    static_cast<unsigned>(p0 >> 32) ^ c.w ^ k1, static_cast<unsigned>(p0));
}

// d += A B, 64 x 128 x 16: A (64 x 16) and B (16 x 128) from shared memory
// through their descriptors, both K-major. Thread (warp w of the
// warpgroup, lane = 4 g + t) holds d[4 j + e] = D[16 w + g + 8 (e >> 1)]
// [8 j + 2 t + (e & 1)], j < 16.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18,"
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52,"
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

struct HArgs {
  const int* seed;
  const int* xt;
  const float* bias;     // (Vp,)
  const float* gumbel;   // (B, Vp, L) or null
  float* logits_out;     // (T, Vp) or null
  float* part;           // (5, splits, T)
  int T, L, nk, Vp, V, mask_index, splits, stages;
};

__global__ void __launch_bounds__(kThreads, 1)
    head_wgmma_kernel(const __grid_constant__ CUtensorMap tm_f,
                      const __grid_constant__ CUtensorMap tm_w, const HArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) & ~static_cast<uintptr_t>(kAlign - 1));
  const int nk = a.nk, S = a.stages;
  unsigned char* fs = smem;                            // nk feature tiles
  unsigned char* ring = fs + nk * kTileBytes;          // S W slots
  float* zt = reinterpret_cast<float*>(ring + S * kStageBytes);   // kTok x kZRow
  uint64_t* full = reinterpret_cast<uint64_t*>(zt + kTok * kZRow);
  uint64_t* empty = full + S;
  uint64_t* fbar = empty + S;
  uint64_t* zfull = fbar + 1;
  uint64_t* zempty = zfull + 1;
  const int tid = threadIdx.x;
  const int tok0 = blockIdx.x * kTok, split = blockIdx.y;
  const int items = min(kSplitChunks, a.Vp / kVt - split * kSplitChunks);

  // A block whose tokens are all decoded has nothing to sample.
  const bool mine = tid < kTok && tok0 + tid < a.T && a.xt[tok0 + tid] == a.mask_index;
  if (!__syncthreads_or(mine)) return;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      ddg::mbar_init(ddg::smem_u32(full + s), 1);
      ddg::mbar_init(ddg::smem_u32(empty + s), 4);   // warpgroup 0's warps
    }
    ddg::mbar_init(ddg::smem_u32(fbar), 1);
    ddg::mbar_init(ddg::smem_u32(zfull), 128);
    ddg::mbar_init(ddg::smem_u32(zempty), kEpiThreads);
    ddg::fence_mbar_init();
  }
  __syncthreads();
  auto vrow = [&](int i) { return (split * kSplitChunks + i) * kVt; };

  if (tid >= 128 + kEpiThreads) {        // ---- the producer
    if (tid == 128 + kEpiThreads) {
      const uint32_t fb = ddg::smem_u32(fbar);
      ddg::mbar_expect_tx(fb, nk * kTileBytes);
      for (int k = 0; k < nk; ++k)
        ddg::tma_load_2d(ddg::smem_u32(fs + k * kTileBytes), &tm_f, k * 64, tok0, fb);
      for (int idx = 0; idx < items * nk; ++idx) {
        const int slot = idx % S;
        ddg::mbar_wait(ddg::smem_u32(empty + slot), ((idx / S) & 1) ^ 1);
        const uint32_t fb2 = ddg::smem_u32(full + slot);
        ddg::mbar_expect_tx(fb2, kStageBytes);
        ddg::tma_load_2d(ddg::smem_u32(ring + slot * kStageBytes), &tm_w, (idx % nk) * 64,
                         vrow(idx / nk), fb2);
      }
    }
    return;
  }

  if (tid < 128) {                       // ---- the products
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    float acc[64];
#pragma unroll
    for (int q = 0; q < 64; ++q) acc[q] = 0.f;
    ddg::mbar_wait(ddg::smem_u32(fbar), 0);
    const uint32_t fs0 = ddg::smem_u32(fs), ring0 = ddg::smem_u32(ring);
    for (int i = 0; i < items; ++i) {
      for (int k = 0; k < nk; ++k) {
        const int idx = i * nk + k, slot = idx % S;
        ddg::mbar_wait(ddg::smem_u32(full + slot), (idx / S) & 1);
        wg_fence();
        pin(acc);
        const uint32_t fa = fs0 + k * kTileBytes, fw = ring0 + slot * kStageBytes;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_n128(acc, desc128(fa + 32 * kk), desc128(fw + 32 * kk), k > 0 || kk > 0);
        wg_commit();
        pin(acc);
        if (k >= kInFlight) {            // slab k - kInFlight is done: its slot is free
          wg_wait<kInFlight>();
          pin(acc);
          if (lane == 0) ddg::mbar_arrive(ddg::smem_u32(empty + (idx - kInFlight) % S));
          __syncwarp();
        }
      }
      wg_wait<0>();
      pin(acc);
      if (lane == 0)
        for (int k = max(0, nk - kInFlight); k < nk; ++k)
          ddg::mbar_arrive(ddg::smem_u32(empty + (i * nk + k) % S));
      __syncwarp();
      // The logits tile, once the epilogue has read the last one.
      ddg::mbar_wait(ddg::smem_u32(zempty), (i & 1) ^ 1);
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(zt + (16 * warp + g + 8 * h) * kZRow + 8 * j + 2 * t) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      ddg::mbar_arrive(ddg::smem_u32(zfull));
    }
    return;
  }

  // ---- The epilogue: token row 8 (warp) + r, vocab rows 32 q .. 32 q + 31
  // of each chunk (lane = 8 q + r, so a quarter warp's 16-byte reads of the
  // tile fall in distinct banks).
  auto row = [](int t) { return 8 * ((t - 128) >> 5) + (t & 7); };   // token row
  const int q = (tid & 31) >> 3;
  const int tok_c = min(tok0 + row(tid), a.T - 1);
  const int tb = tok_c / a.L, tl = tok_c - tb * a.L;
  const unsigned seed = a.gumbel ? 0u : static_cast<unsigned>(a.seed[0]);
  RowState st = RowState{kNeg, 0.f, -INFINITY, 0.f, 0x7fffffff};
  for (int i = 0; i < items; ++i) {
    const int v0 = vrow(i) + 32 * q;
    // Rows of this thread that are sampled (below V, not the mask).
    unsigned on = a.V - v0 >= 32 ? 0xffffffffu : a.V > v0 ? (1u << (a.V - v0)) - 1u : 0u;
    const int mc = a.mask_index - v0;    // the mask's row here, if in [0, 32)
    if (mc >= 0 && mc < 32) on &= ~(1u << mc);
    float z[32], gn[32];
    ddg::mbar_wait(ddg::smem_u32(zfull), i & 1);
    const float* zrow = zt + row(thread_x()) * kZRow + 32 * q;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float4 w = *reinterpret_cast<const float4*>(zrow + 4 * k);
      z[4 * k] = w.x, z[4 * k + 1] = w.y, z[4 * k + 2] = w.z, z[4 * k + 3] = w.w;
    }
    ddg::mbar_arrive(ddg::smem_u32(zempty));
    // The logits and their max over the sampled rows (max is exact in any
    // order).
    float tmax = kNeg;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float4 bias = *reinterpret_cast<const float4*>(a.bias + v0 + 4 * k);
      const float bv[4] = {bias.x, bias.y, bias.z, bias.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * k + e;
        z[c] = __fadd_rn(z[c], bv[e]);
        if ((on >> c) & 1u) tmax = fmaxf(tmax, z[c]);
      }
    }
    if (a.logits_out && tok0 + row(thread_x()) < a.T) {
      const size_t tok = tok0 + row(thread_x());
#pragma unroll
      for (int k = 0; k < 8; ++k)
        *reinterpret_cast<float4*>(a.logits_out + tok * a.Vp + v0 + 4 * k) =
            make_float4(z[4 * k], z[4 * k + 1], z[4 * k + 2], z[4 * k + 3]);
    }
    if (tmax > st.m) {
      st.s *= __expf(st.m - tmax);
      st.m = tmax;
    }
    // The noise: the eight Philox calls of the 32 rows, counters (v / 4,
    // l, b, 0), kPhilox at a time round by round side by side.
    if (a.gumbel) {
#pragma unroll
      for (int c = 0; c < 32; ++c) gn[c] = a.gumbel[((size_t)tb * a.Vp + v0 + c) * a.L + tl];
    } else {
#pragma unroll
      for (int k0 = 0; k0 < 8; k0 += kPhilox) {
        uint4 ctr[kPhilox];
#pragma unroll
        for (int k = 0; k < kPhilox; ++k)
          ctr[k] = make_uint4(static_cast<unsigned>((v0 >> 2) + k0 + k),
                              static_cast<unsigned>(tl), static_cast<unsigned>(tb), 0u);
        unsigned key0 = seed, key1 = 0u;
#pragma unroll
        for (int rnd = 0; rnd < 10; ++rnd) {
#pragma unroll
          for (int k = 0; k < kPhilox; ++k) ctr[k] = philox_round(ctr[k], key0, key1);
          key0 += 0x9E3779B9u;
          key1 += 0xBB67AE85u;
        }
#pragma unroll
        for (int k = 0; k < kPhilox; ++k) {
          gn[4 * (k0 + k)] = gumbel_bits(ctr[k].x);
          gn[4 * (k0 + k) + 1] = gumbel_bits(ctr[k].y);
          gn[4 * (k0 + k) + 2] = gumbel_bits(ctr[k].z);
          gn[4 * (k0 + k) + 3] = gumbel_bits(ctr[k].w);
        }
      }
    }
    // Each row's exp and perturbed score; the mask's Gumbel.
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      if (c == mc) st.mg += gn[c];
      const bool in = (on >> c) & 1u;
      gn[c] = in ? __fadd_rn(z[c], gn[c]) : -INFINITY;
      z[c] = in ? __expf(z[c] - st.m) : 0.f;
    }
    // Their sum and best by fixed trees: pairs (2c, 2c + 1), then halves
    // (c, c + w), the lower index kept on ties.
    float g16[16], z16[16];
    int i16[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      i16[c] = gn[2 * c + 1] > gn[2 * c] ? 2 * c + 1 : 2 * c;
      g16[c] = fmaxf(gn[2 * c], gn[2 * c + 1]);
      z16[c] = z[2 * c] + z[2 * c + 1];
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      i16[c] = g16[c + 8] > g16[c] ? i16[c + 8] : i16[c];
      g16[c] = fmaxf(g16[c], g16[c + 8]);
      z16[c] = z16[c] + z16[c + 8];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      i16[c] = g16[c + 4] > g16[c] ? i16[c + 4] : i16[c];
      g16[c] = fmaxf(g16[c], g16[c + 4]);
      z16[c] = z16[c] + z16[c + 4];
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      i16[c] = g16[c + 2] > g16[c] ? i16[c + 2] : i16[c];
      g16[c] = fmaxf(g16[c], g16[c + 2]);
      z16[c] = z16[c] + z16[c + 2];
    }
    i16[0] = g16[1] > g16[0] ? i16[1] : i16[0];
    g16[0] = fmaxf(g16[0], g16[1]);
    st.s += z16[0] + z16[1];
    if (on) ddg::merge_arg(st.best, st.idx, g16[0], v0 + i16[0]);
  }

  // ---- The split's state of each token: its four lanes' merged in a
  // fixed order, written per token.
#pragma unroll
  for (int o = 8; o < 32; o <<= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, st.m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, st.s, o);
    const float b2 = __shfl_xor_sync(0xffffffffu, st.best, o);
    const int i2 = __shfl_xor_sync(0xffffffffu, st.idx, o);
    const float g2 = __shfl_xor_sync(0xffffffffu, st.mg, o);
    ddg::merge_ms(st.m, st.s, m2, s2);
    ddg::merge_arg(st.best, st.idx, b2, i2);
    st.mg += g2;
  }
  const int tok = tok0 + row(thread_x());
  if (q == 0 && tok < a.T) {
    const size_t o = (size_t)split * a.T + tok, n = (size_t)a.splits * a.T;
    a.part[o] = st.m;
    a.part[n + o] = st.s;
    a.part[2 * n + o] = st.best;
    a.part[3 * n + o] = __int_as_float(st.idx);
    a.part[4 * n + o] = st.mg;
  }
}

}  // namespace hw

// ---- The int8 kernel for Hopper (path 1 of `head_plan` for int8) --------
//
// hw::head_wgmma_kernel's warp-specialised shape with int8 operands and an
// epilogue that forms K7's noise only where it can win: a block takes kTok
// = 64 tokens and one vocab split of kSplitChunks chunks of kVt = 128 rows
// (3840 rows, the last split what is left: 384 blocks, 2.9 waves, at the
// LM1B slice; 1024- to 2560-row splits left a part-filled last wave and
// more first chunks, whose noise pruning has no best yet, 0.48-0.49 ms).
//   - The producer (the last warp's first thread) loads the block's int8
//     features once (ceil(D / 128) TMA tiles of 64 tokens x 128 bytes in
//     the 128-byte swizzle) and W's tiles of 128 rows x 128 bytes through a
//     ring of up to kMaxStages slots (half the bytes of bf16's tiles a K
//     step, so more slots fit).
//   - The product warpgroup runs each chunk's product (wgmma m64n128k32
//     s8 x s8 -> s32, exact, A and B from shared memory, both K-major as
//     `feats_q` (B, L, D) and `w_q` (Vp, D) are) and writes the s32 tile to
//     shared memory.
//   - Eight epilogue warps take kRows consecutive vocab rows of a chunk for
//     each of kHt tokens a thread: the rescale (float(acc) * xs) * ws + bias
//     in explicit roundings (the logits of ops.quant.int8_dense bit for
//     bit), the online (max, sum of exps) by fixed trees, and the best z + g
//     with K7's noise (ddg::gumbel), formed only where it can beat the best
//     z + g of the token's threads when the chunk began (ddg::noise_kmax
//     against each Philox quad's largest z; a row no lane of the warp forms
//     is skipped by the whole warp), and always for the mask's row. A
//     thread's Philox calls run side by side.
// The split's state of each token is merged over its threads in a fixed
// order and written per (split, token); `head_merge_kernel` merges the
// splits in order, so reruns give the same tokens. Layouts measured before
// this one on an H100 at the LM1B slice (`scripts/ab_torch_head_sample.py
// --phases --int8`; PERF.md §6): 128 tokens a block over two product
// warpgroups (W read from L2 half as often, but 17-24 warps leave 80-96
// registers and the epilogue spills), sixteen epilogue warps of 16 rows (96
// registers), the producer's loads issued by the first product thread (the
// products alone 0.44 ms against 0.31 with their own warp), and the rescale
// and LSE on the product warpgroup's accumulators (the products' time
// doubled).
namespace s8 {

constexpr int kVt = 128;                 // vocab rows a chunk: one wgmma N
constexpr int kRows = 16;                // vocab rows of a chunk an epilogue thread takes
constexpr int kEpiWarps = 8;             // epilogue warps
constexpr int kSplitRows = 3840;         // vocab rows a split
constexpr int kTok = 64;                 // tokens a block: one wgmma M
constexpr int kK = 128;                  // K bytes of a tile
constexpr int kProdThreads = 128;        // one product warpgroup
constexpr int kEpiThreads = 32 * kEpiWarps;
constexpr int kThreads = kProdThreads + kEpiThreads + 32;   // and the producer's warp
constexpr int kSplitChunks = kSplitRows / kVt;
constexpr int kHt = kTok * kVt / (kRows * kEpiThreads);   // tokens an epilogue thread
constexpr int kTpw = 32 * kRows / kVt;   // tokens an epilogue warp's lanes take at once
constexpr int kInFlight = 2;             // wgmma groups left running behind the newest
constexpr int kTileBytes = kTok * kK;    // a feature tile: kTok tokens x 128 int8
constexpr int kStageBytes = kVt * kK;    // a W slot: kVt rows x 128 int8
constexpr int kZRow = kVt + 4;           // the s32 tile's padded row, words
constexpr int kMaxStages = 8;
constexpr int kMinStages = 2;
constexpr int kSmemMax = 232448;
constexpr int kAlign = 1024;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kHt >= 1 && kTok * kVt == kHt * kRows * kEpiThreads, "epilogue split");

// Shared memory of a block with nk feature tiles and `stages` W slots
// (with the s32 tile, the alignment slack and the mbarriers).
__host__ __device__ constexpr int smem_bytes(int nk, int stages) {
  return kAlign + nk * kTileBytes + stages * kStageBytes + kTok * kZRow * 4 +
         8 * (2 * stages + 3);
}
__host__ __device__ constexpr int stages_for(int nk) {
  int s = kMaxStages;
  while (s > 0 && smem_bytes(nk, s) > kSmemMax) --s;
  return s;
}

__device__ __forceinline__ void pin(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d += A B, 64 x 128 x 32: A (64 x 32) and B (32 x 128) int8 from shared
// memory, both K-major, s32 accumulators laid out as hw::wgmma_n128's
// (thread (warp w, lane 4 g + t) holds D[16 w + g + 8 (e >> 1)][8 j + 2 t
// + (e & 1)] at 4 j + e, j < 16).
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18,"
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52,"
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

struct SArgs {
  const int* seed;
  const int* xt;
  const float* bias;     // (Vp,)
  const float* x_scale;  // (T,)
  const float* w_scale;  // (Vp,)
  const float* gumbel;   // (B, Vp, L) or null
  float* logits_out;     // (T, Vp) or null
  float* part;           // (5, splits, T)
  int T, L, nk, Vp, V, mask_index, splits, stages;
};

// The largest of x[0 .. N), by a tree.
template <int N>
__device__ __forceinline__ float tree_max(const float (&x)[N]) {
  float t[N / 2];
#pragma unroll
  for (int c = 0; c < N / 2; ++c) t[c] = fmaxf(x[2 * c], x[2 * c + 1]);
#pragma unroll
  for (int w = N / 4; w > 0; w >>= 1)
#pragma unroll
    for (int c = 0; c < w; ++c) t[c] = fmaxf(t[c], t[c + w]);
  return t[0];
}

// The Philox words of vocab rows v0 .. v0 + N - 1 of token (tb, tl):
// counters (v / 4, l, b, 0), the N / 4 calls side by side round by round.
template <int N>
__device__ __forceinline__ void words(unsigned (&w)[N], int v0, int tb, int tl, unsigned seed) {
  uint4 ctr[N / 4];
#pragma unroll
  for (int k = 0; k < N / 4; ++k)
    ctr[k] = make_uint4(static_cast<unsigned>((v0 >> 2) + k), static_cast<unsigned>(tl),
                        static_cast<unsigned>(tb), 0u);
  unsigned key0 = seed, key1 = 0u;
#pragma unroll
  for (int rnd = 0; rnd < 10; ++rnd) {
#pragma unroll
    for (int k = 0; k < N / 4; ++k) ctr[k] = hw::philox_round(ctr[k], key0, key1);
    key0 += 0x9E3779B9u;
    key1 += 0xBB67AE85u;
  }
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    w[4 * k] = ctr[k].x;
    w[4 * k + 1] = ctr[k].y;
    w[4 * k + 2] = ctr[k].z;
    w[4 * k + 3] = ctr[k].w;
  }
}

// One token's vocab rows v0 .. v0 + kRows - 1 of a chunk (`acc`: their s32
// sums): the logits, the online (max, sum of exps), the mask row's noise
// and the best z + g, into `st`. `floor` is a z + g that some row of the
// token reached (the best of its threads when the chunk began).
__device__ __forceinline__ void rows(const int (&acc)[kRows], const SArgs& a, int v0, int tok,
                                     float xs, int tb, int tl, unsigned seed, float floor,
                                     RowState& st) {
  constexpr int N = kRows;
  // The Philox words first: they need no logit, so their chains overlap
  // the rest.
  unsigned w[N];
  if (!a.gumbel) words(w, v0, tb, tl, seed);
  float z[N];
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    const float4 ws = *reinterpret_cast<const float4*>(a.w_scale + v0 + 4 * k);
    const float4 bias = *reinterpret_cast<const float4*>(a.bias + v0 + 4 * k);
    const float wv[4] = {ws.x, ws.y, ws.z, ws.w}, bv[4] = {bias.x, bias.y, bias.z, bias.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      z[4 * k + e] = __fadd_rn(
          __fmul_rn(__fmul_rn(static_cast<float>(acc[4 * k + e]), xs), wv[e]), bv[e]);
  }
  if (a.logits_out && tok < a.T) {
#pragma unroll
    for (int k = 0; k < N / 4; ++k)
      *reinterpret_cast<float4*>(a.logits_out + static_cast<size_t>(tok) * a.Vp + v0 + 4 * k) =
          make_float4(z[4 * k], z[4 * k + 1], z[4 * k + 2], z[4 * k + 3]);
  }
  // -inf at the rows that are not sampled (V and past, the mask).
  const int mc = a.mask_index - v0;      // the mask's row here, if in [0, N)
  if (a.V - v0 < N || (mc >= 0 && mc < N)) {
#pragma unroll
    for (int c = 0; c < N; ++c)
      if (v0 + c >= a.V || c == mc) z[c] = -INFINITY;
  }
  // The online max and sum of exps.
  const float tmax = fmaxf(tree_max(z), kNeg);
  if (tmax > st.m) {
    st.s *= ddg::ex2((st.m - tmax) * kLog2e);
    st.m = tmax;
  }
  const float ml = st.m * kLog2e;
  float e[N / 2];
#pragma unroll
  for (int c = 0; c < N / 2; ++c)
    e[c] = ddg::ex2(__fmaf_rn(z[2 * c], kLog2e, -ml)) +
           ddg::ex2(__fmaf_rn(z[2 * c + 1], kLog2e, -ml));
#pragma unroll
  for (int k = N / 4; k > 0; k >>= 1)
#pragma unroll
    for (int c = 0; c < k; ++c) e[c] += e[c + k];
  st.s += e[0];
  // The noise and the best z + g.
  if (a.gumbel) {
#pragma unroll
    for (int c = 0; c < N; ++c) {
      if (z[c] == -INFINITY && c != mc) continue;
      const float g = a.gumbel[(static_cast<size_t>(tb) * a.Vp + v0 + c) * a.L + tl];
      if (c == mc)
        st.mg += g;
      else
        take_best(st, __fadd_rn(z[c], g), v0 + c);
    }
    return;
  }
  if (mc >= 0 && mc < N) {
#pragma unroll
    for (int c = 0; c < N; ++c)
      if (c == mc) st.mg += ddg::gumbel(w[c]);
  }
  const float best0 = fmaxf(floor, st.best);
  // Each quad's bound from its largest z; the rows whose noise can win,
  // this thread's (fm) and the warp's (wm: a row no lane forms is skipped
  // by the whole warp).
  unsigned fm = 0u;
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    const int kmax = ddg::noise_kmax(
        best0, fmaxf(fmaxf(z[4 * k], z[4 * k + 1]), fmaxf(z[4 * k + 2], z[4 * k + 3])));
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (z[4 * k + i] > -INFINITY && static_cast<int>(w[4 * k + i] >> 8) > kmax)
        fm |= 1u << (4 * k + i);
  }
  const unsigned wm = __reduce_or_sync(0xffffffffu, fm);
#pragma unroll
  for (int c = 0; c < N; ++c)
    if ((wm >> c) & 1u) {
      if ((fm >> c) & 1u) take_best(st, __fadd_rn(z[c], ddg::gumbel(w[c])), v0 + c);
    }
}

__global__ void __launch_bounds__(kThreads, 1)
    head_s8_kernel(const __grid_constant__ CUtensorMap tm_f,
                   const __grid_constant__ CUtensorMap tm_w, const SArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) & ~static_cast<uintptr_t>(kAlign - 1));
  const int nk = a.nk, S = a.stages;
  unsigned char* fs = smem;                            // nk feature tiles
  unsigned char* ring = fs + nk * kTileBytes;          // S W slots
  int* zt = reinterpret_cast<int*>(ring + S * kStageBytes);   // kTok x kZRow
  uint64_t* full = reinterpret_cast<uint64_t*>(zt + kTok * kZRow);
  uint64_t* empty = full + S;
  uint64_t* fbar = empty + S;
  uint64_t* zfull = fbar + 1;
  uint64_t* zempty = zfull + 1;
  const int tid = threadIdx.x;
  const int tok0 = blockIdx.x * kTok, split = blockIdx.y;
  const int items = min(kSplitChunks, a.Vp / kVt - split * kSplitChunks);

  // A block whose tokens are all decoded has nothing to sample.
  const bool mine = tid < kTok && tok0 + tid < a.T && a.xt[tok0 + tid] == a.mask_index;
  if (!__syncthreads_or(mine)) return;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      ddg::mbar_init(ddg::smem_u32(full + s), 1);
      ddg::mbar_init(ddg::smem_u32(empty + s), kProdThreads / 32);   // the product warps
    }
    ddg::mbar_init(ddg::smem_u32(fbar), 1);
    ddg::mbar_init(ddg::smem_u32(zfull), kProdThreads);
    ddg::mbar_init(ddg::smem_u32(zempty), kEpiThreads);
    ddg::fence_mbar_init();
  }
  __syncthreads();
  auto vrow = [&](int i) { return (split * kSplitChunks + i) * kVt; };

  if (tid >= kProdThreads + kEpiThreads) {   // ---- the producer
    if (tid == kProdThreads + kEpiThreads) {
      const uint32_t fb = ddg::smem_u32(fbar);
      ddg::mbar_expect_tx(fb, nk * kTileBytes);
      for (int k = 0; k < nk; ++k)
        ddg::tma_load_2d(ddg::smem_u32(fs + k * kTileBytes), &tm_f, k * kK, tok0, fb);
      for (int idx = 0; idx < items * nk; ++idx) {
        const int slot = idx % S;
        ddg::mbar_wait(ddg::smem_u32(empty + slot), ((idx / S) & 1) ^ 1);
        const uint32_t fb2 = ddg::smem_u32(full + slot);
        ddg::mbar_expect_tx(fb2, kStageBytes);
        ddg::tma_load_2d(ddg::smem_u32(ring + slot * kStageBytes), &tm_w, (idx % nk) * kK,
                         vrow(idx / nk), fb2);
      }
    }
    return;
  }

  if (tid < kProdThreads) {              // ---- the products
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int r0 = 16 * warp + g;        // this thread's token rows r0, r0 + 8
    // Slab idx's products are done: its slot is free.
    auto release = [&](int idx) {
      if (lane == 0) ddg::mbar_arrive(ddg::smem_u32(empty + idx % S));
      __syncwarp();
    };
    int acc[kVt / 2];
#pragma unroll
    for (int q = 0; q < kVt / 2; ++q) acc[q] = 0;
    ddg::mbar_wait(ddg::smem_u32(fbar), 0);
    const uint32_t fs0 = ddg::smem_u32(fs), ring0 = ddg::smem_u32(ring);
    for (int i = 0; i < items; ++i) {
      for (int k = 0; k < nk; ++k) {
        const int idx = i * nk + k, slot = idx % S;
        ddg::mbar_wait(ddg::smem_u32(full + slot), (idx / S) & 1);
        hw::wg_fence();
        pin(acc);
        const uint32_t fa = fs0 + k * kTileBytes, fw = ring0 + slot * kStageBytes;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_s8(acc, hw::desc128(fa + 32 * kk), hw::desc128(fw + 32 * kk),
                   k > 0 || kk > 0);
        hw::wg_commit();
        pin(acc);
        if (k >= kInFlight) {            // slab idx - kInFlight is done
          hw::wg_wait<kInFlight>();
          pin(acc);
          release(idx - kInFlight);
        }
      }
      hw::wg_wait<0>();
      pin(acc);
      for (int k = max(0, nk - kInFlight); k < nk; ++k) release(i * nk + k);
      // The s32 tile, once the epilogue has read the last one.
      ddg::mbar_wait(ddg::smem_u32(zempty), (i & 1) ^ 1);
#pragma unroll
      for (int j = 0; j < kVt / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<int2*>(zt + (r0 + 8 * h) * kZRow + 8 * j + 2 * t) =
              make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      ddg::mbar_arrive(ddg::smem_u32(zfull));
    }
    return;
  }

  // ---- The epilogue: token rows kTpw w + r + kTpw kEpiWarps h (w the
  // epilogue warp, h < kHt), vocab rows kRows q .. kRows q + kRows - 1 of
  // each chunk (lane = kTpw q + r, so a quarter warp's 16-byte reads of the
  // tile fall in distinct banks).
  const int e = tid - kProdThreads, lane = e & 31, q = lane / kTpw;
  const int row0 = kTpw * (e >> 5) + lane % kTpw;
  const unsigned seed = a.gumbel ? 0u : static_cast<unsigned>(a.seed[0]);
  RowState st[kHt];
  int tb[kHt], tl[kHt];
  float xs[kHt];
#pragma unroll
  for (int h = 0; h < kHt; ++h) {
    st[h] = RowState{kNeg, 0.f, -INFINITY, 0.f, 0x7fffffff};
    const int tok_c = min(tok0 + row0 + kTpw * kEpiWarps * h, a.T - 1);
    tb[h] = tok_c / a.L;
    tl[h] = tok_c - tb[h] * a.L;
    xs[h] = a.x_scale[tok_c];
  }
  for (int i = 0; i < items; ++i) {
    const int v0 = vrow(i) + kRows * q;
    ddg::mbar_wait(ddg::smem_u32(zfull), i & 1);
#pragma unroll
    for (int h = 0; h < kHt; ++h) {
      const int row = row0 + kTpw * kEpiWarps * h;
      // The best z + g of the token's threads when the chunk began.
      float floor = st[h].best;
#pragma unroll
      for (int o = kTpw; o < 32; o <<= 1)
        floor = fmaxf(floor, __shfl_xor_sync(0xffffffffu, floor, o));
      int acc[kRows];
#pragma unroll
      for (int k = 0; k < kRows / 4; ++k)
        *reinterpret_cast<int4*>(acc + 4 * k) =
            *reinterpret_cast<const int4*>(zt + row * kZRow + kRows * q + 4 * k);
      if (h == kHt - 1) ddg::mbar_arrive(ddg::smem_u32(zempty));
      rows(acc, a, v0, tok0 + row, xs[h], tb[h], tl[h], seed, floor, st[h]);
    }
  }

  // ---- The split's state of each token: its threads' merged in a fixed
  // order, written per token.
#pragma unroll
  for (int h = 0; h < kHt; ++h) {
    RowState& r = st[h];
#pragma unroll
    for (int o = kTpw; o < 32; o <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, r.m, o);
      const float s2 = __shfl_xor_sync(0xffffffffu, r.s, o);
      const float b2 = __shfl_xor_sync(0xffffffffu, r.best, o);
      const int i2 = __shfl_xor_sync(0xffffffffu, r.idx, o);
      const float g2 = __shfl_xor_sync(0xffffffffu, r.mg, o);
      ddg::merge_ms(r.m, r.s, m2, s2);
      ddg::merge_arg(r.best, r.idx, b2, i2);
      r.mg += g2;
    }
    const int tok = tok0 + row0 + kTpw * kEpiWarps * h;
    if (q == 0 && tok < a.T) {
      const size_t o = static_cast<size_t>(split) * a.T + tok;
      const size_t n = static_cast<size_t>(a.splits) * a.T;
      a.part[o] = r.m;
      a.part[n + o] = r.s;
      a.part[2 * n + o] = r.best;
      a.part[3 * n + o] = __int_as_float(r.idx);
      a.part[4 * n + o] = r.mg;
    }
  }
}

}  // namespace s8

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

// How a call runs, from its shape alone (no SM count): path 1, the bf16
// kernel (hw) or the int8 kernel (s8) above, where its feature tiles fit
// beside two W slots (bf16, D up to 1280; int8, D up to 2560, a multiple
// of 16); path 0, the
// first kernel (fp32, and bf16 and int8 past those). A bf16 head's vocab
// splits are hw::kSplitChunks kVt = 1024 rows (the last what is left) on
// either path, an int8 head's on path 1 s8::kSplitChunks chunks; the fp32
// head's, and the int8 head's on path 0, the wrapper sets.
// ops/fused_sampling.py's `head_plan` mirrors it, and chip_smoke.py holds
// the two equal through `ddg_head_plan`.
struct HeadPlan {
  int path, tokens, chunk, split_chunks, splits, stages, smem;
};

HeadPlan head_plan(int T, int D, int Vp, int mode) {
  if (mode == kModeS8) {
    const int nk = (D + s8::kK - 1) / s8::kK, st = s8::stages_for(nk);
    const int rows = s8::kSplitChunks * s8::kVt;
    if (T <= 0 || D <= 0 || D % 16 || Vp <= 0 || Vp % hw::kVt || st < s8::kMinStages)
      return HeadPlan{0, 0, 0, 0, 0, 0, 0};
    return HeadPlan{1, s8::kTok, s8::kVt, s8::kSplitChunks, (Vp + rows - 1) / rows, st,
                    s8::smem_bytes(nk, st)};
  }
  const int nk = (D + 63) / 64, st = hw::stages_for(nk);
  const int rows = hw::kSplitChunks * hw::kVt, splits = (Vp + rows - 1) / rows;
  if (mode != kModeBF16 || T <= 0 || D <= 0 || D % 8 || Vp <= 0 || Vp % hw::kVt)
    return HeadPlan{0, 0, 0, 0, 0, 0, 0};
  if (st < 2) return HeadPlan{0, 0, 0, hw::kSplitChunks, splits, 0, 0};
  return HeadPlan{1, hw::kTok, hw::kVt, hw::kSplitChunks, splits, st, hw::smem_bytes(nk, st)};
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, fetched through the runtime's
// entry-point query (no link against libcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) != cudaSuccess)
      return nullptr;
#endif
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (rows, cols) bf16 (or int8) row-major tensor as boxes of box_rows x
// 128 bytes in the 128-byte swizzle; boxes past its edges read zeros.
bool make_map(CUtensorMap* m, const void* base, int rows, int cols, int box_rows,
              bool int8 = false) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const int bytes = int8 ? 1 : 2;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / bytes),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t es[2] = {1, 1};
  return enc(m, int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(base), dims, strides, box,
             es, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_wgmma(const HeadPlan& pl, const void* feats, const void* w, int D, const hw::HArgs& h,
                 cudaStream_t stream) {
  CUtensorMap tf, tw;
  if (!make_map(&tf, feats, h.T, D, hw::kTok) || !make_map(&tw, w, h.Vp, D, hw::kVt))
    return cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        hw::head_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, hw::kSmemMax);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((h.T + hw::kTok - 1) / hw::kTok, h.splits);
  hw::head_wgmma_kernel<<<grid, hw::kThreads, pl.smem, stream>>>(tf, tw, h);
  return cudaGetLastError();
}

int launch_s8(const HeadPlan& pl, const void* feats, const void* w, int D, const s8::SArgs& h,
              cudaStream_t stream) {
  CUtensorMap tf, tw;
  if (!make_map(&tf, feats, h.T, D, s8::kTok, true) ||
      !make_map(&tw, w, h.Vp, D, s8::kVt, true))
    return cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        s8::head_s8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, s8::kSmemMax);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((h.T + s8::kTok - 1) / s8::kTok, h.splits);
  s8::head_s8_kernel<<<grid, s8::kThreads, pl.smem, stream>>>(tf, tw, h);
  return cudaGetLastError();
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
  auto s = static_cast<cudaStream_t>(stream);
  const HeadPlan pl = head_plan(a.T, D, Vp, mode);
  if ((mode == kModeBF16 || pl.path == 1) && splits != pl.splits) return cudaErrorInvalidValue;
  int rc;
  if (pl.path == 1 && mode == kModeS8) {
    s8::SArgs h;
    h.seed = a.seed;
    h.xt = a.xt;
    h.bias = a.bias;
    h.x_scale = a.x_scale;
    h.w_scale = a.w_scale;
    h.gumbel = a.gumbel;
    h.logits_out = a.logits_out;
    h.part = a.part;
    h.T = a.T;
    h.L = L;
    h.nk = (D + s8::kK - 1) / s8::kK;
    h.Vp = Vp;
    h.V = V;
    h.mask_index = mask_index;
    h.splits = splits;
    h.stages = pl.stages;
    rc = launch_s8(pl, feats, w, D, h, s);
  } else if (pl.path == 1) {
    hw::HArgs h;
    h.seed = a.seed;
    h.xt = a.xt;
    h.bias = a.bias;
    h.gumbel = a.gumbel;
    h.logits_out = a.logits_out;
    h.part = a.part;
    h.T = a.T;
    h.L = L;
    h.nk = (D + 63) / 64;
    h.Vp = Vp;
    h.V = V;
    h.mask_index = mask_index;
    h.splits = splits;
    h.stages = pl.stages;
    rc = launch_wgmma(pl, feats, w, D, h, s);
  } else {
    a.chunks_per_split = (n_ch + splits - 1) / splits;
    if ((n_ch + a.chunks_per_split - 1) / a.chunks_per_split != splits)
      return cudaErrorInvalidValue;
    rc = mode == kModeF32    ? launch<kModeF32>(a, splits, s)
         : mode == kModeBF16 ? launch<kModeBF16>(a, splits, s)
                             : launch<kModeS8>(a, splits, s);
  }
  if (rc) return rc;
  head_merge_kernel<<<(a.T + 255) / 256, 256, 0, s>>>(a.xt, static_cast<const float*>(mct),
                                                       static_cast<const float*>(mcs), a.part,
                                                       static_cast<int*>(out), a.T, L, splits,
                                                       mask_index);
  return cudaGetLastError();
}

// The plan of a call (`head_plan`) into out[0..6]: path, tokens a block,
// vocab rows a chunk, chunks a split, splits, W slots, shared memory a
// block.
extern "C" void ddg_head_plan(int T, int D, int Vp, int mode, int* out) {
  const HeadPlan p = head_plan(T, D, Vp, mode);
  const int v[7] = {p.path, p.tokens, p.chunk, p.split_chunks, p.splits, p.stages, p.smem};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
}
