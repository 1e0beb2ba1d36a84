// Flash-attention backward for Hopper (sm_90a): dq, dk and dv of blocked
// attention, recomputing each probability tile from the forward's saved
// logsumexp so that no (S, S) tensor is ever written to device memory.
//
// The C entries flash_bwd_dq / flash_bwd_dkv below take f32 (dtype 0) and
// bf16 (dtype 1). This file holds the f32 route, on the CUDA cores; the
// bf16 route runs on the tensor cores (wgmma) in flash_attn_bwd_wgmma.cu.
//
// Replaces the two Pallas kernels of _flash_backward in
// ompi_release_tpu/ops/pallas_attention.py:
// - flash_bwd_dq: the pl.pallas_call at :264, body _bwd_dq_kernel (:140-182);
// - flash_bwd_dkv: the pl.pallas_call at :283, body _bwd_dkv_kernel
//   (:185-232).
// Same function: for each of N independent heads, q, k, v, dO (S, D) f32
// (or bf16), the forward's lse (S) f32 and delta = rowsum(dO * O) (S) f32
// (computed outside the kernels, as _flash_backward does at :244-246) ->
//   qs = q * rsqrt(D),  P = where(mask, exp(qs k^T - lse), 0),
//   dP = dO v^T,        dS = P * (dP - delta),
//   dq = (dS k) * rsqrt(D),  dk = dS^T qs,  dv = P^T dO,
// with mask = (q_pos < S) & (k_pos < S) [& (q_pos >= k_pos) when causal],
// f32 throughout and each output rounded once to the input type (the
// bf16 route's operands: flash_attn_bwd_wgmma.cu).
//
// Bound: operations. At the model's shape (N = 64, S = 2048, D = 64,
// causal) one (S, S, D) product costs 2 N D S(S+1)/2 = 17.2 GFLOP: dq does
// three (S, dP, dS k) = 51.6 GFLOP, dk/dv four (S, dP, P^T dO, dS^T qs) =
// 68.8 GFLOP, against ~85 MB and ~102 MB moved. The bf16 tensor-core bound
// is 0.052 ms and 0.070 ms; these f32 kernels use the CUDA cores (f32 FMA,
// 67 TFLOP/s), whose floor is 0.77 ms and 1.03 ms.
//
// Design (simple and exact first; tensor cores, TMA and warp
// specialisation are later work). It reuses flash_fwd's layout
// (flash_attn.cu): 64-row tiles, 256 threads, thread (ty, tx) =
// (tid / 16, tid % 16) owning 4 rows x columns tx + 16 j, f32 tiles in
// dynamic shared memory with a +1 column pad (rows a warp reads at once
// fall in different banks), expf (no fast math).
// - Two kernels and no atomics. The TPU grid runs in order; Hopper blocks
//   run in no order. JAX's split is kept: dq is owned by q-tiles and
//   dk/dv by k-tiles, so no block sums into another's output and the
//   backward is deterministic (bitwise equal run to run).
// - flash_bwd_dq, grid (ceil(S / 64), N): the block holds its scaled Q
//   tile, its dO tile and its rows' lse/delta (in registers), streams the
//   K and V tiles, computes S and dP together (two 4 x 4 register tiles),
//   writes dS to a 64 x 65 shared tile and accumulates dq += dS k in a
//   4 x (D / 16) register accumulator. Causal: the loop stops at the
//   diagonal tile; every later tile has P = 0 exactly (the mask selects
//   0, exp is never taken), so skipping it is bit-exact. Blocks are
//   issued heaviest first (the last q-tile has the most k-tiles).
// - flash_bwd_dkv, grid (ceil(S / 64), N): the block holds its K and V
//   tiles and streams Q (scaled), dO, lse and delta tiles. Causal: from
//   the diagonal q-tile to the end (q-tiles before it see none of its
//   keys: every q_pos there is below every k_pos of the block). It
//   computes the transposed tiles S^T and dP^T (thread rows = its keys),
//   writes P^T and dS^T to two 64 x 65 shared tiles, and accumulates
//   dv += P^T dO and dk += dS^T qs in two register accumulators. k-tile 0
//   has the most q-tiles and is issued first.
// - Shared memory: dq 83,200 B at D = 64 and 148,736 B at D = 128; dk/dv
//   100,352 B and 165,888 B. Above the 48 KB static limit, so each C
//   entry raises its kernel's dynamic limit with cudaFuncSetAttribute.
// - Edges: rows past S are loaded as zeros (never read past a buffer's
//   end), masked, and never stored. S = 1, 100 and 129 are ordinary.
//
// The kernels allocate nothing and launch on the caller's stream; each C
// entry returns cudaGetLastError() for the wrapper to check.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // rows of every q- and k-tile
constexpr int kThreads = 256;  // 16 row groups x 16 lanes
constexpr int kMaxD = 128;
constexpr int kTStride = kTile + 1;  // the 64 x 65 score-shaped tiles

__device__ __forceinline__ float load_f(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ void store_f(float* p, int64_t i, float v) {
  p[i] = v;
}

// rows row0 .. row0 + 63 of one head's (S, D) tensor, times mul, into a
// 64 x ld f32 tile; rows past S are zeros
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const T* __restrict__ src,
                                          int64_t base, int row0, int S,
                                          int D, float mul) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    const int p = row0 + r;
    dst[r * ld + c] =
        p < S ? load_f(src, base + (int64_t)p * D + c) * mul : 0.f;
  }
}

// kJ: output columns per thread (D <= 16 * kJ)
template <typename T, int kJ>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int S, int D, float scale, int causal) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* Qs = smem;                // 64 x (D+1), q * scale
  float* dOs = Qs + kTile * ld;    // 64 x (D+1)
  float* Ks = dOs + kTile * ld;    // 64 x (D+1)
  float* Vs = Ks + kTile * ld;     // 64 x (D+1)
  float* dSs = Vs + kTile * ld;    // 64 x 65

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int qb = gridDim.x - 1 - blockIdx.x;  // heaviest q-tile first
  const int64_t head = blockIdx.y;
  const int64_t base = head * S * D;
  const int q0 = qb * kTile;

  load_tile(Qs, ld, q, base, q0, S, D, scale);
  load_tile(dOs, ld, dout, base, q0, S, D, 1.f);
  float row_lse[4];
  float row_dlt[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    row_lse[i] = qp < S ? lse[head * S + qp] : 0.f;
    row_dlt[i] = qp < S ? delta[head * S + qp] : 0.f;
  }

  float acc[4][kJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < kJ; ++j) acc[i][j] = 0.f;
  }

  int nk = (S + kTile - 1) / kTile;
  if (causal) {
    const int last_q = min(q0 + kTile, S) - 1;  // the block's last real row
    nk = min(nk, last_q / kTile + 1);           // stop at the diagonal tile
  }
  for (int jk = 0; jk < nk; ++jk) {
    const int k0 = jk * kTile;
    __syncthreads();  // Q/dO are in place; the last tile's readers are done
    load_tile(Ks, ld, k, base, k0, S, D, 1.f);
    load_tile(Vs, ld, v, base, k0, S, D, 1.f);
    __syncthreads();

    float s[4][4];
    float dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = 0.f;
        dp[i][j] = 0.f;
      }
    }
    for (int d = 0; d < D; ++d) {
      float qv[4];
      float ov[4];
      float kv[4];
      float vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty * 4 + i) * ld + d];
        ov[i] = dOs[(ty * 4 + i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * ld + d];
        vv[j] = Vs[(tx + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i;
      const int qp = q0 + row;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool keep = qp < S && kp < S && (!causal || qp >= kp);
        const float p = keep ? expf(s[i][j] - row_lse[i]) : 0.f;
        dSs[row * kTStride + tx + 16 * j] = p * (dp[i][j] - row_dlt[i]);
      }
    }
    __syncthreads();

    for (int c = 0; c < kTile; ++c) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dSs[(ty * 4 + i) * kTStride + c];
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int d = tx + 16 * j;
        const float kval = d < D ? Ks[c * ld + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dsv[i], kval, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= S) continue;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) store_f(dq, base + (int64_t)qp * D + d, acc[i][j] * scale);
    }
  }
}

template <typename T, int kJ>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int S, int D,
                         float scale, int causal) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* Ks = smem;                 // 64 x (D+1)
  float* Vs = Ks + kTile * ld;      // 64 x (D+1)
  float* Qs = Vs + kTile * ld;      // 64 x (D+1), q * scale
  float* dOs = Qs + kTile * ld;     // 64 x (D+1)
  float* Pt = dOs + kTile * ld;     // 64 x 65: P^T (row = key)
  float* dSt = Pt + kTile * kTStride;  // 64 x 65: dS^T
  float* Ls = dSt + kTile * kTStride;  // 64 lse of the q-tile
  float* Dl = Ls + kTile;              // 64 delta of the q-tile

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int kb = blockIdx.x;  // k-tile 0 has the most q-tiles: issued first
  const int64_t head = blockIdx.y;
  const int64_t base = head * S * D;
  const int k0 = kb * kTile;

  load_tile(Ks, ld, k, base, k0, S, D, 1.f);
  load_tile(Vs, ld, v, base, k0, S, D, 1.f);

  float acc_dk[4][kJ];
  float acc_dv[4][kJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      acc_dk[i][j] = 0.f;
      acc_dv[i][j] = 0.f;
    }
  }

  const int nq = (S + kTile - 1) / kTile;
  // causal: q-tiles before the diagonal see none of this block's keys
  for (int iq = causal ? kb : 0; iq < nq; ++iq) {
    const int q0 = iq * kTile;
    __syncthreads();  // K/V are in place; the last tile's readers are done
    load_tile(Qs, ld, q, base, q0, S, D, scale);
    load_tile(dOs, ld, dout, base, q0, S, D, 1.f);
    if (tid < kTile) {
      const int qp = q0 + tid;
      Ls[tid] = qp < S ? lse[head * S + qp] : 0.f;
      Dl[tid] = qp < S ? delta[head * S + qp] : 0.f;
    }
    __syncthreads();

    // transposed tiles: [i] over this thread's keys ty*4+i, [j] over the
    // queries tx+16j
    float st[4][4];
    float dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        st[i][j] = 0.f;
        dpt[i][j] = 0.f;
      }
    }
    for (int d = 0; d < D; ++d) {
      float kv[4];
      float vv[4];
      float qv[4];
      float ov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = Ks[(ty * 4 + i) * ld + d];
        vv[i] = Vs[(ty * 4 + i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = Qs[(tx + 16 * j) * ld + d];
        ov[j] = dOs[(tx + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] = fmaf(qv[j], kv[i], st[i][j]);
          dpt[i][j] = fmaf(ov[j], vv[i], dpt[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = ty * 4 + i;
      const int kp = k0 + key;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        const int qp = q0 + r;
        const bool keep = qp < S && kp < S && (!causal || qp >= kp);
        const float p = keep ? expf(st[i][j] - Ls[r]) : 0.f;
        Pt[key * kTStride + r] = p;
        dSt[key * kTStride + r] = p * (dpt[i][j] - Dl[r]);
      }
    }
    __syncthreads();

    for (int r = 0; r < kTile; ++r) {
      float pv[4];
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Pt[(ty * 4 + i) * kTStride + r];
        dsv[i] = dSt[(ty * 4 + i) * kTStride + r];
      }
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int d = tx + 16 * j;
        const float ov = d < D ? dOs[r * ld + d] : 0.f;
        const float qv = d < D ? Qs[r * ld + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc_dv[i][j] = fmaf(pv[i], ov, acc_dv[i][j]);
          acc_dk[i][j] = fmaf(dsv[i], qv, acc_dk[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty * 4 + i;
    if (kp >= S) continue;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) {
        store_f(dk, base + (int64_t)kp * D + d, acc_dk[i][j]);
        store_f(dv, base + (int64_t)kp * D + d, acc_dv[i][j]);
      }
    }
  }
}

size_t dq_smem_bytes(int D) {
  return sizeof(float) *
         (4 * (size_t)kTile * (D + 1) + (size_t)kTile * kTStride);
}

size_t dkv_smem_bytes(int D) {
  return sizeof(float) * (4 * (size_t)kTile * (D + 1) +
                          2 * (size_t)kTile * kTStride + 2 * (size_t)kTile);
}

bool bad_shape(long long n, long long S, int D) {
  return n < 1 || n > 65535 || S < 1 || S > 0x7fffffffLL || D < 1 ||
         D > kMaxD;
}

template <typename T, int kJ>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int n, int S,
              int D, float scale, int causal, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, kJ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((S + kTile - 1) / kTile), (unsigned)n);
  flash_bwd_dq_kernel<T, kJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), S, D, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int kJ>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int n, int S, int D, float scale, int causal,
               cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, kJ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((S + kTile - 1) / kTile), (unsigned)n);
  flash_bwd_dkv_kernel<T, kJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), S, D, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// The bf16 route on the tensor cores (flash_attn_bwd_wgmma.cu).
int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int n, int S, int D, float scale, int causal,
                      cudaStream_t stream);
int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int n, int S,
                       int D, float scale, int causal, cudaStream_t stream);

// Bytes of dynamic shared memory each f32 kernel asks for at head dim D.
extern "C" long long flash_bwd_dq_smem_bytes(int D) {
  return (long long)dq_smem_bytes(D);
}
extern "C" long long flash_bwd_dkv_smem_bytes(int D) {
  return (long long)dkv_smem_bytes(D);
}

// q, k, v, dout, dq: (n, S, D) contiguous, dtype 0 = float32,
// 1 = bfloat16; lse, delta: (n, S) float32. 1 <= D <= 128,
// 1 <= n <= 65535, S >= 1. Returns cudaGetLastError() (or the attribute
// call's error).
extern "C" int flash_bwd_dq(int dtype, const void* q, const void* k,
                            const void* v, const void* dout, const void* lse,
                            const void* delta, void* dq, long long n,
                            long long S, int D, float scale, int causal,
                            void* stream) {
  if (bad_shape(n, S, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int ni = (int)n;
  const int si = (int)S;
  if (dtype == 0) {
    return D <= 64 ? launch_dq<float, 4>(q, k, v, dout, l, dl, dq, ni, si, D,
                                         scale, causal, s)
                   : launch_dq<float, 8>(q, k, v, dout, l, dl, dq, ni, si, D,
                                         scale, causal, s);
  }
  if (dtype == 1) {
    return flash_bwd_dq_bf16(q, k, v, dout, l, dl, dq, ni, si, D, scale,
                             causal, s);
  }
  return (int)cudaErrorInvalidValue;
}

// As flash_bwd_dq, with the outputs dk, dv: (n, S, D) in the input type.
extern "C" int flash_bwd_dkv(int dtype, const void* q, const void* k,
                             const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk,
                             void* dv, long long n, long long S, int D,
                             float scale, int causal, void* stream) {
  if (bad_shape(n, S, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int ni = (int)n;
  const int si = (int)S;
  if (dtype == 0) {
    return D <= 64 ? launch_dkv<float, 4>(q, k, v, dout, l, dl, dk, dv, ni,
                                          si, D, scale, causal, s)
                   : launch_dkv<float, 8>(q, k, v, dout, l, dl, dk, dv, ni,
                                          si, D, scale, causal, s);
  }
  if (dtype == 1) {
    return flash_bwd_dkv_bf16(q, k, v, dout, l, dl, dk, dv, ni, si, D, scale,
                              causal, s);
  }
  return (int)cudaErrorInvalidValue;
}
