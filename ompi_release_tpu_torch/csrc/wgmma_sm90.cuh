// Shared pieces of the bf16 flash-attention kernels on Hopper's tensor
// cores (sm_90a): the forward (flash_attn_wgmma.cu) and the backward
// pair (flash_attn_bwd_wgmma.cu) include this one copy.
//
// - wgmma (inline PTX): the no-swizzle shared-memory matrix descriptor
//   (mdesc), the m64n64k16 product with both operands in shared memory
//   (mma_ss_n64), the m64nNk16 products with A in registers and B
//   MN-major in shared memory (mma_rs, N = 64 or 128), and the fences,
//   commit and wait of the asynchronous groups;
// - cp.async copies, the proxy fence that makes them visible to wgmma;
// - the tile loader (load_tile: rows of an (S, D) bf16 tensor into a
//   64 x DP tile in the core-matrix layout, zeros past S and D) and its
//   f32 row-vector twin (load_rows);
// - the bf16 hi + lo split of an f32 accumulator into the register-A
//   fragments of the next product (split2, split_fragments);
// - the bf16 store of an f32 accumulator (store_tile), and the test for
//   16-byte copies (vec_ok).
//
// The layouts and the reasons behind them are in flash_attn_bwd_wgmma.cu's
// note. Everything here has internal linkage: each kernel file gets its
// own instance. cuda_op.build() hashes this header with the sources, so
// an edit here rebuilds the library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 64;      // rows of every tile: wgmma's M
constexpr int kThreads = 128;  // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory matrix descriptor, no swizzle (layout type 0):
// start address, leading and stride byte offsets, each in 16-byte units
__device__ __forceinline__ uint64_t mdesc(uint32_t addr, uint32_t lbo,
                                          uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// the block's shared-memory writes made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are still in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of wgmma's registers across
// the asynchronous window
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define WG_ACC4(d, b) "+f"(d[b]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3])
#define WG_ACC32(d, o)                                                    \
  WG_ACC4(d, o), WG_ACC4(d, o + 4), WG_ACC4(d, o + 8), WG_ACC4(d, o + 12), \
      WG_ACC4(d, o + 16), WG_ACC4(d, o + 20), WG_ACC4(d, o + 24),          \
      WG_ACC4(d, o + 28)

// D (64 x 64, f32) (+)= A (64 x 16, shared, K-major) B (16 x 64, shared,
// K-major); accumulate = 0 overwrites D
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC32(d, 0)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x N, f32) += A (64 x 16, registers) B (16 x N, shared, MN-major:
// the transpose bit of B set), N = 64 or 128
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_ACC32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t (&a)[4],
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_ACC32(d, 0), WG_ACC32(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef WG_ACC32
#undef WG_ACC4

// rows row0 .. row0 + 63 of one head's (S, D) bf16 tensor into a 64 x DP
// tile in the core-matrix layout; thread i copies the 16-byte core row i
// (consecutive threads, consecutive shared addresses). Rows past S and
// columns past D are zeros. vec: 16-byte cp.async (zero-filled past S);
// else element loads, synchronous.
template <int DP>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const bf16* __restrict__ src,
                                          int64_t base, int row0, int S,
                                          int D, bool vec) {
  constexpr int kCoresPerRow = DP / 8;
#pragma unroll
  for (int it = 0; it < kRows * DP / 8 / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int core = i >> 3;
    const int r = (core / kCoresPerRow) * 8 + (i & 7);
    const int c = (core % kCoresPerRow) * 8;
    const int p = row0 + r;
    if (vec) {
      const bool ok = p < S && c < D;
      cp_async_16(smem_addr(dst + i * 16),
                  ok ? src + base + (int64_t)p * D + c : src, ok ? 16 : 0);
    } else {
      union {
        uint4 v;
        bf16 e[8];
      } u;
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        u.e[x] = p < S && c + x < D ? src[base + (int64_t)p * D + c + x]
                                    : __float2bfloat16_rn(0.f);
      }
      *reinterpret_cast<uint4*>(dst + i * 16) = u.v;
    }
  }
}

// 64 f32 rows row0 .. row0 + 63 of one head's (S) vector, zeros past S
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          int64_t base, int row0, int S) {
  if (threadIdx.x < kRows) {
    const int p = row0 + threadIdx.x;
    cp_async_4(smem_addr(dst + threadIdx.x), p < S ? src + base + p : src,
               p < S ? 4 : 0);
  }
}

// x as the pair (hi, lo) of bf16 operands: hi = bf16(x), lo = bf16(x - hi),
// two values per 32-bit register, the lower column in the low half
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The 64 x 64 f32 accumulator x (this thread's 32 values) as the hi and lo
// register-A fragments of the four k-steps of the next product: element
// (row, 8j + 2t + c) of the accumulator is x[4j + 2i + c] (row = 16 warp +
// lane / 4 + 8i, t = lane % 4), and register i of k-step kk's A fragment
// holds columns 16kk + 8(i / 2) + 2t, +1 of row 16 warp + lane / 4 +
// 8(i % 2): x[8kk + 2i], x[8kk + 2i + 1].
__device__ __forceinline__ void split_fragments(const float (&x)[32],
                                                uint32_t (&hi)[4][4],
                                                uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      split2(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1], hi[kk][i], lo[kk][i]);
    }
  }
}

// this thread's values of a 64 x DP f32 accumulator, times mul, rounded
// once to bf16 into rows row0 + (its rows) of one head's (S, D) output;
// rows past S and columns past D are not stored
template <int DP>
__device__ __forceinline__ void store_tile(bf16* __restrict__ out,
                                           int64_t base, int row0, int S,
                                           int D, const float (&acc)[DP / 2],
                                           float mul) {
  const int lane = threadIdx.x & 31;
  const int r = row0 + 16 * (threadIdx.x >> 5) + (lane >> 2);
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int p = r + 8 * i;
        const int col = 8 * j + 2 * (lane & 3) + c;
        if (p < S && col < D) {
          out[base + (int64_t)p * D + col] =
              __float2bfloat16_rn(acc[4 * j + 2 * i + c] * mul);
        }
      }
    }
  }
}

// 16-byte copies need D % 8 == 0 and 16-byte aligned operands
bool vec_ok(int D, const void* q, const void* k, const void* v,
            const void* dout) {
  const uintptr_t bits = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                         (uintptr_t)dout;
  return D % 8 == 0 && bits % 16 == 0;
}

}  // namespace
