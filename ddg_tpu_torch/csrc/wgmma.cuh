// Hopper building blocks shared by the attention kernels (K1/K2 forward in
// rope_attention.cu, K1b/K2b backward in rope_attention_bwd.cu): 16-byte
// cp.async copies of 64-row tiles into shared memory in the 128-byte
// swizzle, the wgmma shared-memory descriptor, wgmma m64n64k16 with A
// from shared memory or from registers, the fences that order them, and 2^x
// by the SFU. flash_attention.cu's wgmma K20-K22 use them too, with one
// warpgroup a block, and the DiMamba kernels' bf16 products (mamba.cuh);
// the absorbing step (absorbing_sample.cu) takes its 2^x.
//
// Tiles are 64 rows x 64 bf16 (D = 64, 128 bytes a row), loaded by blocks
// of two warpgroups (256 threads) unless load_tile is told otherwise. The
// definitions live in an unnamed namespace: each .cu is its own library
// with a plain C interface.
#pragma once

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMmaD = 64;                  // head dim
constexpr int kTileRows = 64;              // rows of a tile: a warpgroup's rows (one
                                           // wgmma M), a key or query tile
constexpr int kMmaThreads = 256;           // two warpgroups a block
constexpr int kTileBytes = kTileRows * kMmaD * 2;   // 64 rows x 128 bytes
constexpr int kSwizzleAlign = 1024;        // the 128-byte swizzle's repeat
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of the 16-byte chunk c of row r in a swizzled 64 x 64 tile.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Order this thread's shared-memory writes (cp.async or st.shared) before
// the async proxy's reads (wgmma); a barrier then makes them everyone's.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a swizzled tile at `addr`: start address,
// leading offset 16 bytes (unused by the swizzled layouts here), stride
// offset 1024 bytes (eight 128-byte rows), 128-byte swizzle.
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// 2^x by the SFU (common.cuh).
using ddg::ex2;

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pin register values at this point of the program: the compiler may not
// move their reads or writes across it (wgmma writes and reads them
// asynchronously between issue and wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define DDG_D32                                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define DDG_D32_OUT                                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d += A B, 64 x 64 x 16: A (64 x 16) and B (16 x 64) both read from shared
// memory through their descriptors, both K-major. Thread (warp w, lane = 4 g
// + t) holds d[4 j + e] = D[16 w + g + 8 (e >> 1)][8 j + 2 t + (e & 1)].
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DDG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : DDG_D32_OUT
      : "l"(da), "l"(db), "r"(1));
}

// d += A B, 64 x 64 x 16, both from shared memory and both MN-major (A's
// rows and B's columns contiguous: the transpose bits set), as the weight
// gradients X^T Y read X and Y row by row.
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DDG_D32
      ", %32, %33, p, 1, 1, 1, 1;\n}\n"
      : DDG_D32_OUT
      : "l"(da), "l"(db), "r"(1));
}

// d += A B, 64 x 64 x 16: A from registers (warp w's 16 rows in mma.sync's
// m16n8k16 A layout: a0 = A[g][2t..2t+1], a1 = A[g+8][2t..], a2 =
// A[g][2t+8..], a3 = A[g+8][2t+8..]), B from shared memory, MN-major
// (transpose-B bit set).
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32], uint32_t a0, uint32_t a1,
                                            uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DDG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : DDG_D32_OUT
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

#undef DDG_D32
#undef DDG_D32_OUT

// Copy rows row0 .. row0 + 63 of one head (token stride ts elements) into
// a swizzled tile with cp.async, by the block's NT threads; rows past L
// read as zeros.
template <int NT = kMmaThreads>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, int ts, int row0,
                                          int L) {
  const int c = threadIdx.x & 7;
#pragma unroll
  for (int i = 0; i < kTileRows * 8 / NT; ++i) {
    const int r = (threadIdx.x >> 3) + i * (NT / 8), p = row0 + r;
    const bool ok = p < L;
    cp_async16(dst + swz(r, c), src + static_cast<size_t>(ok ? p : 0) * ts + c * 8, ok);
  }
}

}  // namespace
