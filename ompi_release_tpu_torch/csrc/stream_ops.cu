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
