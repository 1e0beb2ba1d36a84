// ring_fold: the tuned ring allreduce's two passes (reduce-scatter, then
// allgather) over a rank-stacked (n, total) buffer as one kernel, SUM
// only, written for Hopper (sm_90a).
//
// Replaces no Pallas kernel. The JAX package runs the ring as a
// shard_map body whose per-round ppermutes XLA schedules; the port ran
// the same body interpreted (coll/spmd.py _ring_passes): every one of
// the 2 (n - 1) rounds a gather, a rank-axis permutation, a second
// gather, the SUM combine and an indexed put, each its own launch over
// device memory. With the n ranks as virtual ranks of one card, a
// rank's send is a copy between two rows of the same memory, so the
// partial a ring carries can stay in a register instead.
//
// What it computes, bit for bit the interpreted ring: position p of a
// rank's buffer belongs to chunk j = (p % seg) / chunk (seg = total for
// the plain ring; the segmented ring's segment length otherwise), and
// the ring completes chunk j by the fold
//   acc = x[j][p]; for t in 1..n-1: acc = x[(j + t) % n][p] + acc
// then copies acc to every rank. In f32 each step is one __fadd_rn; in
// bf16 each step widens both operands, adds in f32 and rounds back to
// bf16 (__float2bfloat16_rn), as the SUM combiner does: a partial is
// never carried across steps in f32. Only positions that exist are
// computed: the interpreted ring's padding with the op identity only
// ever meets other padding.
//
// Bound: bytes. Every rank's row is read once and written once, 2 x n x
// total x itemsize: at 8 ranks x 256 MiB f32, 4.29 GB, 1.28 ms at the
// H100 SXM's 3.35 TB/s. The arithmetic (n - 1 adds per element) is far
// below the card's compute rate.
//
// Design: one thread per 16-byte vector of positions (4 f32 or 8 bf16),
// on a grid sized to the work (blocks of 256 threads; at 8 x 2^26 f32,
// 65,536 blocks). The streaming kernels of stream_ops.cu measured the
// same choice against a persistent grid capped to the SMs: the cap made
// a second wave and left each thread one load in flight, and lost. A
// thread loads its chunk's first row, then folds the other n - 1 rows in
// ring order, rotated in the address computation (step t reads row
// (j + t) % n), and writes the n output rows as 16-byte stores. A warp's
// loads and stores are 512 contiguous bytes of a row. One path serves
// every comm size and every length: n is read at run time and chunk
// indices are computed in 64 bits. On an H100 at 8 ranks x 256 MiB, f32
// and bf16, that path timed within 1 % of n = 8 as a template argument
// (8 loads issued before the fold), of 32-bit chunk indices, and of
// loads issued in batches of 8: the loads of the many resident threads
// keep the memory busy, and the divisions hide under them.
// The vector path needs every row 16-byte aligned (both base addresses,
// total a multiple of the vector); otherwise every position is a thread
// of its own (scalar path). A vector whose positions cross a chunk's or
// a segment's edge (chunk or seg not a multiple of the vector) folds
// its positions one by one, each in its own chunk's order.
//
// The kernel allocates nothing, reads no index tensor and never syncs,
// so a CUDA graph captures it as it is; the C entry launches on the
// caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFoldThreads = 256;

// one ring step: acc = v + acc, rounded as the SUM combiner rounds
__device__ __forceinline__ float step(float v, float acc) {
  return __fadd_rn(v, acc);
}
__device__ __forceinline__ __nv_bfloat16 step(__nv_bfloat16 v,
                                              __nv_bfloat16 acc) {
  return __float2bfloat16_rn(
      __fadd_rn(__bfloat162float(v), __bfloat162float(acc)));
}

template <typename T>
__device__ __forceinline__ uint4 step_vec(uint4 v, uint4 acc) {
  constexpr int K = 16 / sizeof(T);
  const T* ev = reinterpret_cast<const T*>(&v);
  T* ea = reinterpret_cast<T*>(&acc);
#pragma unroll
  for (int e = 0; e < K; ++e) ea[e] = step(ev[e], ea[e]);
  return acc;
}

__device__ __forceinline__ int chunk_of(int64_t p, int64_t seg,
                                        int64_t chunk) {
  return (int)((p % seg) / chunk);
}

// row (j + t) % n for 0 <= j < n, 0 <= t < n
__device__ __forceinline__ int ring_row(int j, int t, int n) {
  const int r = j + t;
  return r >= n ? r - n : r;
}

// position p alone, in its own chunk's order
template <typename T>
__device__ __forceinline__ void fold_one(const T* __restrict__ x,
                                         T* __restrict__ out, int n,
                                         int64_t total, int64_t p, int j) {
  T acc = x[j * total + p];
  for (int t = 1; t < n; ++t) {
    acc = step(x[ring_row(j, t, n) * total + p], acc);
  }
  for (int r = 0; r < n; ++r) out[r * total + p] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kFoldThreads)
    ring_fold_kernel(const T* __restrict__ x, T* __restrict__ out, int n,
                     int64_t total, int64_t seg, int64_t chunk, int64_t work,
                     int vec) {
  const int64_t i = (int64_t)blockIdx.x * kFoldThreads + threadIdx.x;
  if (i >= work) return;
  if (!vec) {
    fold_one<T>(x, out, n, total, i, chunk_of(i, seg, chunk));
    return;
  }
  constexpr int K = 16 / sizeof(T);
  const int64_t p = i * K;
  const int64_t q = p % seg;  // the vector's first position in its segment
  const int j = (int)(q / chunk);
  if (q + (K - 1) >= seg || j != (int)((q + (K - 1)) / chunk)) {
    // the vector crosses a segment's or a chunk's edge
#pragma unroll 1
    for (int e = 0; e < K; ++e) {
      fold_one<T>(x, out, n, total, p + e, chunk_of(p + e, seg, chunk));
    }
    return;
  }
  const int64_t rowv = total / K;  // vectors a row
  const uint4* xv = reinterpret_cast<const uint4*>(x) + i;
  uint4* ov = reinterpret_cast<uint4*>(out) + i;
  uint4 acc = xv[j * rowv];
#pragma unroll 4
  for (int t = 1; t < n; ++t) {
    acc = step_vec<T>(xv[ring_row(j, t, n) * rowv], acc);
  }
#pragma unroll
  for (int r = 0; r < n; ++r) ov[r * rowv] = acc;
}

template <typename T>
int launch_fold(const void* x, void* out, int n, int64_t total, int64_t seg,
                int64_t chunk, cudaStream_t s) {
  constexpr int64_t K = 16 / sizeof(T);
  const bool vec = total % K == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  const int64_t work = vec ? total / K : total;
  const int64_t grid = (work + kFoldThreads - 1) / kFoldThreads;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ring_fold_kernel<T><<<(unsigned)grid, kFoldThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, total, seg, chunk,
      work, vec);
  return 0;
}

}  // namespace

// x, out: (n, total) contiguous, not overlapping; dtype 0 = float32,
// 1 = bfloat16. Chunk j of a position p is (p % seg) / chunk, so
// chunk * n must cover seg. Returns cudaGetLastError().
extern "C" int ring_fold(int dtype, const void* x, void* out, int n,
                         long long total, long long seg, long long chunk,
                         void* stream) {
  if (n < 2 || total < 1 || seg < 1 || chunk < 1 ||
      chunk * (long long)n < seg) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 0) {
    err = launch_fold<float>(x, out, n, total, seg, chunk, s);
  } else if (dtype == 1) {
    err = launch_fold<__nv_bfloat16>(x, out, n, total, seg, chunk, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return err ? err : (int)cudaGetLastError();
}
