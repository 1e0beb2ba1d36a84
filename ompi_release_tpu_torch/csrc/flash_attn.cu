// Flash-attention forward for Hopper (sm_90a): online-softmax attention
// that never writes the (S, S) score matrix to device memory.
//
// The C entry flash_fwd below takes f32 (dtype 0) and bf16 (dtype 1).
// This file holds the f32 route, on the CUDA cores; the bf16 route runs
// on the tensor cores (wgmma) in flash_attn_wgmma.cu.
//
// Replaces the Pallas forward of ompi_release_tpu/ops/pallas_attention.py:
// the pl.pallas_call of _flash_forward (pallas_attention.py:114), body
// _attn_kernel (:38-88). Same function: for each of N independent heads,
// q, k, v (S, D) f32 (or bf16) -> o (S, D) in the input type and the per-row
// logsumexp lse (S) in f32, with q scaled by rsqrt(D), the tail mask
// k_pos < S, the causal mask q_pos >= k_pos, the -1e30 sentinel, the
// running max/sum-exp in f32, o = acc / max(l, 1e-30) rounded once and
// lse = m + log(max(l, 1e-30)) (finite on every row).
//
// Bound: operations. The work is 4 * N * D * S^2 flops (half of it under
// the causal mask) against 4 * N * S * D elements moved, so at D = 64 the
// kernel does about 256 flops per byte (bf16), near the H100's balance
// point of ~295 for the tensor cores and far above it for the CUDA cores
// this kernel uses (67 TFLOP/s f32). The CUDA-core floor at the model's
// shape (N = 64, S = 2048, D = 64, causal) is about 0.51 ms.
//
// Design of the f32 route (simple and exact first; TF32 would miss the
// f32 gate of 2e-5, so it stays on the CUDA cores):
// - One block of 256 threads owns BQ = 64 query rows of one head:
//   grid (ceil(S / 64), N). The TPU kernel's grid (H, S/128) with whole
//   K/V rows resident in VMEM has no counterpart here: a block has at
//   most 227 KB of shared memory, so K/V stream through it in tiles of
//   BK = 64 rows instead.
// - Shared memory, all f32: the pre-scaled Q tile (64 x (D+1)), the K
//   tile (64 x (D+1)), the V tile (64 x D) and the probability tile P
//   (64 x 65). The +1 columns put the rows a warp reads at once in
//   different banks. That is ~65 KB at D = 64 and ~113 KB at D = 128, above
//   the 48 KB static limit, so the C entry raises the kernel's dynamic
//   shared-memory limit with cudaFuncSetAttribute before the launch.
// - Thread (ty, tx) = (tid / 16, tid % 16) owns rows 4ty..4ty+3 of the
//   tile: it computes their scores at columns tx + 16j (j < 4) and their
//   output columns tx + 16j (j < D/16, at most 8), so the running m, l
//   and the (4 x 8) accumulator live in registers. A row's 64 scores are
//   spread over 16 lanes of one warp; its max and sum are butterfly
//   shuffles (__shfl_xor_sync), which give every lane the same bits.
// - Causal: the k-loop stops at the diagonal tile. Every tile after it is
//   fully masked for every row of the block; there m stays finite (tile 0
//   always holds k_pos = 0 <= q_pos), p = exp(-1e30 - m) = 0 and
//   alpha = 1, so skipping such a tile leaves acc and l unchanged bit for
//   bit: exact, and it halves the work. Blocks are issued heaviest first
//   (the last q-tile has the most k-tiles) so the tail of the grid is
//   short.
// - Edges: rows past S are loaded as zeros and never stored; K/V rows
//   past S are loaded as zeros and masked (k_pos < S), never read past
//   the end of the buffers. S = 1, 100 and 129 are ordinary cases.
// - Arithmetic: f32 throughout, expf/logf, no --use_fast_math.
//
// The kernel allocates nothing and launches on the caller's stream; the
// C entry returns cudaGetLastError() for the wrapper to check.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kFlashThreads = 256;  // 16 row groups x 16 lanes
constexpr int kMaxD = 128;
constexpr int kPStride = kBK + 1;
constexpr float kNegInf = -1e30f;  // pallas_attention.NEG_INF

__device__ __forceinline__ float load_f(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ void store_f(float* p, int64_t i, float v) {
  p[i] = v;
}

// max / sum over the 16 lanes that hold one row (lanes 0-15 or 16-31)
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// kJ: output columns per thread (D <= 16 * kJ)
template <typename T, int kJ>
__global__ void __launch_bounds__(kFlashThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int S, int D, float scale,
                     int causal) {
  extern __shared__ float smem[];
  const int ldq = D + 1;
  float* Qs = smem;              // kBQ x (D+1), pre-scaled
  float* Ks = Qs + kBQ * ldq;    // kBK x (D+1)
  float* Vs = Ks + kBK * ldq;    // kBK x D
  float* Ps = Vs + kBK * D;      // kBQ x (kBK+1)

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int qb = gridDim.x - 1 - blockIdx.x;  // heaviest q-tile first
  const int64_t head = blockIdx.y;
  const int64_t base = head * S * D;
  const int q0 = qb * kBQ;

  for (int i = tid; i < kBQ * D; i += kFlashThreads) {
    const int r = i / D;
    const int c = i - r * D;
    const int qp = q0 + r;
    Qs[r * ldq + c] = qp < S ? load_f(q, base + (int64_t)qp * D + c) * scale
                             : 0.f;
  }

  float acc[4][kJ];
  float row_m[4];
  float row_l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row_m[i] = kNegInf;
    row_l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kJ; ++j) acc[i][j] = 0.f;
  }

  int nk = (S + kBK - 1) / kBK;
  if (causal) {
    const int last_q = min(q0 + kBQ, S) - 1;  // the block's last real row
    nk = min(nk, last_q / kBK + 1);           // stop at the diagonal tile
  }
  for (int jk = 0; jk < nk; ++jk) {
    const int k0 = jk * kBK;
    __syncthreads();  // Q is in place; the last tile's readers are done
    for (int i = tid; i < kBK * D; i += kFlashThreads) {
      const int r = i / D;
      const int c = i - r * D;
      const int kp = k0 + r;
      const int64_t g = base + (int64_t)kp * D + c;
      Ks[r * ldq + c] = kp < S ? load_f(k, g) : 0.f;
      Vs[r * D + c] = kp < S ? load_f(v, g) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
    for (int d = 0; d < D; ++d) {
      float qv[4];
      float kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * ldq + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * ldq + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i;
      const int qp = q0 + row;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool keep = kp < S && (!causal || qp >= kp);
        s[i][j] = keep ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(row_m[i], row_max16(mx));
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[row * kPStride + tx + 16 * j] = p;
        psum += p;
      }
      const float alpha = expf(row_m[i] - m_new);
      row_l[i] = row_l[i] * alpha + row_sum16(psum);
      row_m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * kPStride + c];
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int d = tx + 16 * j;
        const float vv = d < D ? Vs[c * D + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= S) continue;
    const float l = fmaxf(row_l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) store_f(o, base + (int64_t)qp * D + d, acc[i][j] / l);
    }
    if (tx == 0) lse[head * S + qp] = row_m[i] + logf(l);
  }
}

size_t smem_bytes(int D) {
  return sizeof(float) *
         ((size_t)kBQ * (D + 1) + (size_t)kBK * (D + 1) + (size_t)kBK * D +
          (size_t)kBQ * kPStride);
}

template <typename T, int kJ>
int launch_flash(const void* q, const void* k, const void* v, void* o,
                 float* lse, int n, int S, int D, float scale, int causal,
                 cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, kJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((S + kBQ - 1) / kBQ), (unsigned)n);
  flash_fwd_kernel<T, kJ><<<grid, kFlashThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, D, scale,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace

// The bf16 route on the tensor cores (flash_attn_wgmma.cu).
int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                   float* lse, int n, int S, int D, float scale, int causal,
                   cudaStream_t stream);

// Bytes of dynamic shared memory the f32 kernel asks for at head dim D.
extern "C" long long flash_fwd_smem_bytes(int D) {
  return (long long)smem_bytes(D);
}

// q, k, v, o: (n, S, D) contiguous, dtype 0 = float32, 1 = bfloat16;
// lse: (n, S) float32. 1 <= D <= 128, 1 <= n <= 65535, S >= 1.
// Returns cudaGetLastError() (or the attribute call's error).
extern "C" int flash_fwd(int dtype, const void* q, const void* k,
                         const void* v, void* o, void* lse, long long n,
                         long long S, int D, float scale, int causal,
                         void* stream) {
  if (n < 1 || n > 65535 || S < 1 || S > 0x7fffffffLL || D < 1 ||
      D > kMaxD) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const int ni = (int)n;
  const int si = (int)S;
  if (dtype == 0) {
    return D <= 64 ? launch_flash<float, 4>(q, k, v, o, l, ni, si, D, scale,
                                            causal, s)
                   : launch_flash<float, 8>(q, k, v, o, l, ni, si, D, scale,
                                            causal, s);
  }
  if (dtype == 1) {
    return flash_fwd_bf16(q, k, v, o, l, ni, si, D, scale, causal, s);
  }
  return (int)cudaErrorInvalidValue;
}
