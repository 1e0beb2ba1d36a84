// Streaming elementwise kernels for the op framework's accelerated SUM
// and the bench loops, written for Hopper (sm_90a).
//
// Replaces the Pallas kernels of ompi_release_tpu/ops/pallas_op.py, all
// launched through _blocked_call's pl.pallas_call (pallas_op.py:79):
//   stream_axpy  <- _pallas_sum_fn (pallas_op.py:156, out = b + a) and
//                   axpy (pallas_op.py:93, out = acc*c + a)
//   stream_scale <- scale (pallas_op.py:105, out = x*c)
//
// Bound: pure streaming, no reuse. stream_axpy moves 3 x n x itemsize
// bytes (two reads, one write) and stream_scale 2 x n x itemsize, so the
// least time is bytes / HBM bandwidth (3.35 TB/s on an H100 SXM). The
// arithmetic (one or two flops per element) is far below the card's
// compute rate.
//
// Design: one grid-stride loop. When every pointer is 16-byte aligned
// the body moves 16 bytes per thread per load (4 f32 or 8 bf16 values);
// the remainder of the vectorised range and every element of a
// misaligned call (a view at an odd element offset) go through a scalar
// loop, so the ragged tail is always covered (the Pallas kernel instead
// refused a truncated grid and padded to whole blocks).
//
// Rounding: arithmetic is in f32 with explicit __fmul_rn/__fadd_rn so
// nvcc cannot contract acc*c + a into an FMA; bf16 values are widened
// to f32 and the result is rounded once with __float2bfloat16_rn. With
// c == 1 (the SUM path) the kernel does one IEEE add per element.
//
// Kernels allocate nothing and launch on the caller's stream; each C
// entry returns cudaGetLastError() for the wrapper to check.
//
// The bench loops' two other kernels follow the streaming pair at the
// end of the file (tile_transpose_32, chain_add_one); each has its own
// note there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 resident blocks per SM

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <bool kPlainAdd>
__device__ __forceinline__ float axpy1(float acc, float a, float c) {
  return kPlainAdd ? __fadd_rn(acc, a) : __fadd_rn(__fmul_rn(acc, c), a);
}

// out = acc*c + a (or acc + a when kPlainAdd)
template <typename T, bool kPlainAdd>
__global__ void __launch_bounds__(kThreads)
    axpy_kernel(const T* __restrict__ a, const T* __restrict__ acc,
                T* __restrict__ out, float c, int64_t n, int vec) {
  constexpr int K = 16 / sizeof(T);
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t nvec = vec ? n / K : 0;
  const uint4* a4 = reinterpret_cast<const uint4*>(a);
  const uint4* acc4 = reinterpret_cast<const uint4*>(acc);
  uint4* out4 = reinterpret_cast<uint4*>(out);
  for (int64_t i = tid; i < nvec; i += stride) {
    uint4 va = a4[i];
    uint4 vb = acc4[i];
    uint4 vo;
    const T* pa = reinterpret_cast<const T*>(&va);
    const T* pb = reinterpret_cast<const T*>(&vb);
    T* po = reinterpret_cast<T*>(&vo);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      po[j] = from_f<T>(axpy1<kPlainAdd>(to_f(pb[j]), to_f(pa[j]), c));
    }
    out4[i] = vo;
  }
  for (int64_t i = nvec * K + tid; i < n; i += stride) {
    out[i] = from_f<T>(axpy1<kPlainAdd>(to_f(acc[i]), to_f(a[i]), c));
  }
}

// out = x*c
template <typename T>
__global__ void __launch_bounds__(kThreads)
    scale_kernel(const T* __restrict__ x, T* __restrict__ out, float c,
                 int64_t n, int vec) {
  constexpr int K = 16 / sizeof(T);
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t nvec = vec ? n / K : 0;
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  uint4* out4 = reinterpret_cast<uint4*>(out);
  for (int64_t i = tid; i < nvec; i += stride) {
    uint4 vx = x4[i];
    uint4 vo;
    const T* px = reinterpret_cast<const T*>(&vx);
    T* po = reinterpret_cast<T*>(&vo);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      po[j] = from_f<T>(__fmul_rn(to_f(px[j]), c));
    }
    out4[i] = vo;
  }
  for (int64_t i = nvec * K + tid; i < n; i += stride) {
    out[i] = from_f<T>(__fmul_rn(to_f(x[i]), c));
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int grid_for(int64_t work) {
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return (int)blocks;
}

template <typename T>
void launch_axpy(const void* a, const void* acc, void* out, float c,
                 int plain_add, int64_t n, cudaStream_t stream) {
  const int vec = aligned16(a) && aligned16(acc) && aligned16(out);
  const int64_t K = 16 / sizeof(T);
  const int grid = grid_for(vec ? n / K + n % K : n);
  const T* pa = static_cast<const T*>(a);
  const T* pacc = static_cast<const T*>(acc);
  T* pout = static_cast<T*>(out);
  if (plain_add) {
    axpy_kernel<T, true><<<grid, kThreads, 0, stream>>>(pa, pacc, pout, c,
                                                       n, vec);
  } else {
    axpy_kernel<T, false><<<grid, kThreads, 0, stream>>>(pa, pacc, pout, c,
                                                        n, vec);
  }
}

template <typename T>
void launch_scale(const void* x, void* out, float c, int64_t n,
                  cudaStream_t stream) {
  const int vec = aligned16(x) && aligned16(out);
  const int64_t K = 16 / sizeof(T);
  const int grid = grid_for(vec ? n / K + n % K : n);
  scale_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), c, n, vec);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError().
extern "C" int stream_axpy(int dtype, const void* a, const void* acc,
                           void* out, float c, int plain_add, long long n,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_axpy<float>(a, acc, out, c, plain_add, n, s);
  } else if (dtype == 1) {
    launch_axpy<__nv_bfloat16>(a, acc, out, c, plain_add, n, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int stream_scale(int dtype, const void* x, void* out, float c,
                            long long n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_scale<float>(x, out, c, n, s);
  } else if (dtype == 1) {
    launch_scale<__nv_bfloat16>(x, out, c, n, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tile_transpose_32: out (cols, rows) = in (rows, cols) transposed, for
// 32-bit words (int32 and float32 share it: it moves bits).
//
// Replaces the blocked transpose of make_transpose_loop
// (ompi_release_tpu/ops/pallas_op.py:300, body :297-298), the
// single-chip analogue of BASELINE config 5's all-pairs alltoall.
//
// Bound: bytes. Each call reads and writes the whole array once,
// 2 x rows x cols x 4 bytes (512 MiB at n = 8192: 0.160 ms at
// 3.35 TB/s); there is no arithmetic.
//
// Design: a naive transpose makes either its reads or its writes
// strided (one 32-byte sector per 4-byte word). Each block stages one
// 32x32 tile in shared memory instead: a warp reads 32 consecutive
// words of an input row and writes 32 consecutive words of an output
// row, so both directions are coalesced. The tile is padded to 33
// columns so that reading a tile column (32 words 33 apart) hits 32
// different banks. Blocks are 32x8 threads, each thread moving 4 rows,
// so a block holds 4.2 KB of shared memory and many tiles are in
// flight per SM. The Pallas kernel's VMEM block size (256-1024) has no
// counterpart: a Hopper block has at most 227 KB of shared memory and
// the 132 SMs need many small tiles. Edge tiles are masked, so any
// shape is taken (the Pallas call refused n % block != 0). Tile rows
// beyond gridDim.y (more than 65535 x 32 rows) are covered by a
// grid-stride loop.
// ---------------------------------------------------------------------------

namespace {

constexpr int kTile = 32;
constexpr int kTileRows = 8;  // threads per tile column: 4 rows each

__global__ void __launch_bounds__(kTile * kTileRows)
    transpose32_kernel(const uint32_t* __restrict__ in,
                       uint32_t* __restrict__ out, int64_t rows,
                       int64_t cols) {
  __shared__ uint32_t tile[kTile][kTile + 1];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int64_t c0 = (int64_t)blockIdx.x * kTile;  // input column origin
  const int64_t tiles_y = (rows + kTile - 1) / kTile;
  for (int64_t by = blockIdx.y; by < tiles_y; by += gridDim.y) {
    const int64_t r0 = by * kTile;  // input row origin
    const int64_t c = c0 + tx;
#pragma unroll
    for (int j = 0; j < kTile; j += kTileRows) {
      const int64_t r = r0 + ty + j;
      if (r < rows && c < cols) tile[ty + j][tx] = in[r * cols + c];
    }
    __syncthreads();
    // output row = input column, output column = input row
    const int64_t oc = r0 + tx;
#pragma unroll
    for (int j = 0; j < kTile; j += kTileRows) {
      const int64_t orow = c0 + ty + j;
      if (orow < cols && oc < rows) out[orow * rows + oc] = tile[tx][ty + j];
    }
    __syncthreads();  // the tile is refilled on the next pass
  }
}

// ---------------------------------------------------------------------------
// chain_add_one: out = x + 1 on one (8, 128) float32 tile (1,024 values).
//
// Replaces the body of make_chain_loop
// (ompi_release_tpu/ops/pallas_op.py:336, body :333-334), the
// single-chip analogue of BASELINE config 1's token ring: each hop is
// one launch that depends on the previous one.
//
// Bound: launch latency. The bytes bound is 8 KiB per hop (4 KiB read,
// 4 KiB written: about 2.4 ns at 3.35 TB/s), far below what a launch
// costs, so the kernel is as small as a launch can be: one block of 256
// threads, each loading one float4 and storing it plus 1 (__fadd_rn:
// one IEEE add, as x + 1 in PyTorch). Its per-hop time is reported
// eager (one launch from Python per hop) and replayed from a CUDA graph
// (the analogue of the TPU's single compiled fori_loop).
// ---------------------------------------------------------------------------

constexpr int kChainThreads = 256;  // x 4 floats = one (8, 128) tile

__global__ void __launch_bounds__(kChainThreads)
    chain_add_one_kernel(const float4* x, float4* out) {
  const int i = threadIdx.x;
  float4 v = x[i];
  v.x = __fadd_rn(v.x, 1.0f);
  v.y = __fadd_rn(v.y, 1.0f);
  v.z = __fadd_rn(v.z, 1.0f);
  v.w = __fadd_rn(v.w, 1.0f);
  out[i] = v;
}

}  // namespace

// in and out must not overlap. Returns cudaGetLastError().
extern "C" int tile_transpose_32(const void* in, void* out, long long rows,
                                 long long cols, void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  const int64_t tiles_x = (cols + kTile - 1) / kTile;
  const int64_t tiles_y = (rows + kTile - 1) / kTile;
  if (tiles_x > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles_x,
                  (unsigned)(tiles_y < 65535 ? tiles_y : 65535));
  const dim3 block(kTile, kTileRows);
  transpose32_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), rows,
      cols);
  return (int)cudaGetLastError();
}

// x and out: 1,024 float32 values each, 16-byte aligned; they may be
// the same buffer (each thread reads its float4 before writing it).
extern "C" int chain_add_one(const void* x, void* out, void* stream) {
  chain_add_one_kernel<<<1, kChainThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(out));
  return (int)cudaGetLastError();
}
