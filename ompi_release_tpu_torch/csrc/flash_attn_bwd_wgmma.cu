// Flash-attention backward for bf16 on Hopper's tensor cores (sm_90a):
// the bf16 route of the C entries flash_bwd_dq / flash_bwd_dkv
// (flash_attn_bwd.cu, which keeps the f32 route on the CUDA cores).
//
// Replaces, for bf16, the two Pallas kernels of _flash_backward in
// ompi_release_tpu/ops/pallas_attention.py:
// - flash_bwd_dq_wgmma: the pl.pallas_call at :264, body _bwd_dq_kernel
//   (:140-182);
// - flash_bwd_dkv_wgmma: the pl.pallas_call at :283, body _bwd_dkv_kernel
//   (:185-232).
// Same function as flash_attn_bwd.cu states: for each of N heads, q, k, v,
// dO (S, D) bf16, lse and delta (S) f32 ->
//   P = where(mask, exp(scale q k^T - lse), 0),  dS = P * (dO v^T - delta),
//   dq = scale dS k,  dk = scale dS^T q,  dv = P^T dO,
// each output rounded once to bf16.
//
// Bound: operations. At the model's shape (N = 64, S = 2048, D = 64,
// causal) one (S, S, D) product is 2 N D S(S+1)/2 = 17.2 GFLOP; the
// function needs three for dq and four for dk/dv: 0.052 ms and 0.070 ms at
// the 989 TFLOP/s bf16 tensor-core peak (the bytes, ~85 MB and ~102 MB,
// take ~0.03 ms at 3.35 TB/s).
//
// The gate, and the hi/lo split. Every product runs on wgmma with bf16
// operands and f32 accumulation. S = Q K^T and dP = dO V^T are exact in
// that form (bf16 inputs). P and dS are f32 values computed in registers;
// rounded once to bf16 as operands of the three output products they miss
// the kernels' gate (within one bf16 ulp plus 2e-4 of the f32 plain twin
// on every element: about 1 % of the elements fail at S = 2048, causal).
// So each is split into hi = bf16(x) and lo = bf16(x - hi) and each output
// product runs twice, hi then lo, into one f32 accumulator: hi + lo keeps
// ~16 significant bits, and the outputs meet the gate
// (tests/test_torch_flash_split.py emulates this on the CPU). dq does
// 2 + 2 x 1 = 4 products and dk/dv 2 + 2 x 2 = 6 instead of 3 and 4.
//
// Design (right and simple first). 64-row tiles, one warpgroup (128
// threads) per block, bf16 tiles in dynamic shared memory in wgmma's
// no-swizzle layout: 8 x 8 core matrices of 128 contiguous bytes (8 rows
// of 16 B), row-block major, so element (r, c) of a 64 x DP tile lies at
// ((r / 8) (DP / 8) + c / 8) 128 + (r % 8) 16 + (c % 8) 2. One tile serves
// as a K-major operand (K = its columns: LBO 128 B, SBO 16 DP B) and as an
// MN-major one (K = its rows, the 16-bit transpose bit set: LBO 16 DP B,
// SBO 128 B) with no copy. DP, the padded head dim, is 64 (D <= 64) or 128
// (D <= 128); columns past D and rows past S load as zeros, are masked and
// never stored.
// - flash_bwd_dkv_wgmma, grid (ceil(S / 64), N) read in linear order
//   with the heads fastest, so k-tile 0 of every head (the most q-tiles)
//   starts first: the block keeps its K and V tiles and streams Q, dO,
//   lse and delta tiles, double-buffered with cp.async (16-byte copies,
//   zero-filled past S; element loads when D % 8 != 0 or an operand is
//   not 16-byte aligned). Per
//   q-tile: S^T = K Q^T and dP^T = V dO^T (A and B K-major, N = 64), so
//   the accumulators hold the block's keys as rows; P^T and dS^T in f32
//   in those registers; then split into hi/lo bf16 pairs and repacked in
//   registers into the A fragments of the next wgmma (the m64nNk16 f32
//   accumulator's 8-column chunks 2kk and 2kk+1 are the register-A
//   fragment of k-step kk, as in FlashAttention-3), so P^T and dS^T never
//   touch shared memory; dV += P^T_hi dO + P^T_lo dO and
//   dK += dS^T_hi Q + dS^T_lo Q with B = dO or Q MN-major (N = DP).
//   S^T and dP^T are two commit groups, so P^T is taken while dP^T runs,
//   and the dV products run while dS^T is taken.
//   Causal: it starts at the diagonal q-tile (earlier ones see none of
//   its keys) and masks only that tile and the ragged tail.
// - flash_bwd_dq_wgmma, grid (ceil(S / 64), N), the heaviest q-tile of
//   every head first (the same linear order): keeps Q and dO, streams K,
//   V double-buffered; S = Q K^T and dP = dO V^T (two groups: P while dP
//   runs), P and dS in registers, dQ += dS_hi K + dS_lo K (B = K
//   MN-major). Causal: it stops at the diagonal tile.
// - The scale is applied in f32 after the products: P = exp2(S scale log2e
//   - lse log2e) (one FMA and exp2f, a relative error of ~1e-6 in P
//   against exp(qs k - lse), far inside the gate), dk and dq multiplied
//   once at the end. (rsqrt(64) = 1/8 would be exact on q in bf16;
//   rsqrt(128) is not.)
// - No atomics: dq is owned by q-tiles and dk/dv by k-tiles, so no block
//   sums into another's output and the backward is bitwise equal from
//   run to run. Skipped causal tiles have P = 0 exactly (the mask selects
//   0; exp is never taken), so skipping them is exact.
// - Each wgmma group is waited for (wait_group) before its results or
//   register operands are touched, and wgmma.fence orders the registers
//   written before a group; the next tile's copies are in flight
//   meanwhile.
//
// ptxas (-Xptxas -v, CUDA 12.8, sm_90a; chip_smoke.py's ptxas_report
// prints it from every build): dq 142 registers at DP 64 and 197 at DP
// 128, dk/dv 204 (two blocks per SM) and 255 with a 16-byte spill at DP
// 128 (two 64 x 128 f32 accumulators, S^T, dP^T and four fragment sets);
// no static shared memory. Dynamic shared memory: dq 6 x 64 DP x 2 B
// (49,152 / 98,304 B), dk/dv the same plus 1 KiB of lse/delta (50,176 /
// 99,328 B), above the 48 KB default at DP 128 and for dk/dv, so each
// launcher raises the limit with cudaFuncSetAttribute.
//
// Later work: warp specialisation (a producer warp with TMA), a persistent
// grid, swizzled layouts, two consumer warpgroups or 128-row tiles (wider
// products), overlapping the output products with the next tile's S/dP
// products.
//
// The descriptors, the wgmma and cp.async wrappers, load_tile, the hi/lo
// split and store_tile are in wgmma_sm90.cuh, shared with the bf16
// forward (flash_attn_wgmma.cu).
//
// The kernels allocate nothing and launch on the caller's stream; each
// launcher returns cudaGetLastError() (or the attribute call's error).

#include "wgmma_sm90.cuh"

namespace {

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int S,
                        int D, float scale, int causal, int vec) {
  constexpr int kTile = kRows * DP * 2;  // bytes of one bf16 tile
  extern __shared__ __align__(128) unsigned char dkv_smem[];
  unsigned char* Ks = dkv_smem;
  unsigned char* Vs = Ks + kTile;
  unsigned char* Qs = Vs + kTile;    // 2 stages
  unsigned char* dOs = Qs + 2 * kTile;  // 2 stages
  float* Ls = reinterpret_cast<float*>(dOs + 2 * kTile);  // 2 x 64 lse
  float* Dl = Ls + 2 * kRows;                             // 2 x 64 delta

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // blocks start in linear order; read it with the heads fastest, so
  // k-tile 0 of every head (the most q-tiles) is issued first
  const int64_t lin = blockIdx.x + (int64_t)gridDim.x * blockIdx.y;
  const int kb = (int)(lin / gridDim.y);
  const int64_t head = lin % gridDim.y;
  const int64_t base = head * S * D;
  const int64_t rbase = head * S;
  const int k0 = kb * kRows;
  const int nq = (S + kRows - 1) / kRows;
  // causal: q-tiles before the diagonal see none of this block's keys
  const int first = causal ? kb : 0;
  const bool v16 = vec != 0;

  load_tile<DP>(Ks, k, base, k0, S, D, v16);
  load_tile<DP>(Vs, v, base, k0, S, D, v16);
  load_tile<DP>(Qs, q, base, first * kRows, S, D, v16);
  load_tile<DP>(dOs, dout, base, first * kRows, S, D, v16);
  load_rows(Ls, lse, rbase, first * kRows, S);
  load_rows(Dl, delta, rbase, first * kRows, S);
  cp_async_commit();

  float dk_acc[DP / 2];
  float dv_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) {
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }
  const uint32_t k_addr = smem_addr(Ks);
  const uint32_t v_addr = smem_addr(Vs);
  const int key0 = 16 * warp + (lane >> 2);  // this thread's first key row
  const float scale2 = scale * kLog2e;  // P = exp2(S scale2 - lse log2 e)

  for (int iq = first, st = 0; iq < nq; ++iq, st ^= 1) {
    const int q0 = iq * kRows;
    if (iq + 1 < nq) {  // the next q-tile streams in meanwhile
      const int n0 = q0 + kRows;
      load_tile<DP>(Qs + (st ^ 1) * kTile, q, base, n0, S, D, v16);
      load_tile<DP>(dOs + (st ^ 1) * kTile, dout, base, n0, S, D, v16);
      load_rows(Ls + (st ^ 1) * kRows, lse, rbase, n0, S);
      load_rows(Dl + (st ^ 1) * kRows, delta, rbase, n0, S);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this q-tile (and K/V) landed
    fence_async_smem();
    __syncthreads();

    const uint32_t q_addr = smem_addr(Qs + st * kTile);
    const uint32_t o_addr = smem_addr(dOs + st * kTile);
    // S^T = K Q^T and dP^T = V dO^T: keys as rows, queries as columns;
    // two groups, so that P^T is taken while dP^T is still running
    float sacc[32];
    float pacc[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      mma_ss_n64(sacc, mdesc(k_addr + kk * 256, 128, 16 * DP),
                 mdesc(q_addr + kk * 256, 128, 16 * DP), kk);
    }
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      mma_ss_n64(pacc, mdesc(v_addr + kk * 256, 128, 16 * DP),
                 mdesc(o_addr + kk * 256, 128, 16 * DP), kk);
    }
    wg_commit();
    wg_wait<1>();
    fence_regs(sacc);

    // P^T in f32, in place
    const float* L = Ls + st * kRows;
    const float* Dd = Dl + st * kRows;
    const bool edge = (causal && iq == kb) || q0 + kRows > S ||
                      k0 + kRows > S;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + 2 * (lane & 3) + c;
        const float l2 = L[col] * kLog2e;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 4 * j + 2 * i + c;
          bool keep = true;
          if (edge) {
            const int qp = q0 + col;
            const int kp = k0 + key0 + 8 * i;
            keep = qp < S && kp < S && (!causal || qp >= kp);
          }
          sacc[e] = keep ? exp2f(fmaf(sacc[e], scale2, -l2)) : 0.f;
        }
      }
    }
    uint32_t p_hi[4][4], p_lo[4][4], ds_hi[4][4], ds_lo[4][4];
    split_fragments(sacc, p_hi, p_lo);
    wg_wait<0>();
    fence_regs(pacc);
    // dV += P^T dO as hi + lo (B = dO with K = its rows, the queries:
    // MN-major), running while dS^T is taken
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bo = mdesc(o_addr + kk * 32 * DP, 16 * DP, 128);
      mma_rs(dv_acc, p_hi[kk], bo);
      mma_rs(dv_acc, p_lo[kk], bo);
    }
    wg_commit();
    // dS^T = P^T (dP^T - delta), in place
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float dl = Dd[8 * j + 2 * (lane & 3) + c];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 4 * j + 2 * i + c;
          pacc[e] = sacc[e] * (pacc[e] - dl);
        }
      }
    }
    split_fragments(pacc, ds_hi, ds_lo);
    // dK += dS^T Q as hi + lo (B = Q, MN-major)
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bq = mdesc(q_addr + kk * 32 * DP, 16 * DP, 128);
      mma_rs(dk_acc, ds_hi[kk], bq);
      mma_rs(dk_acc, ds_lo[kk], bq);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    __syncthreads();  // this stage is free for the copy after next
  }

  store_tile<DP>(dk, base, k0, S, D, dk_acc, scale);
  store_tile<DP>(dv, base, k0, S, D, dv_acc, 1.f);
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       bf16* __restrict__ dq, int S, int D, float scale,
                       int causal, int vec) {
  constexpr int kTile = kRows * DP * 2;
  extern __shared__ __align__(128) unsigned char dq_smem[];
  unsigned char* Qs = dq_smem;
  unsigned char* dOs = Qs + kTile;
  unsigned char* Ks = dOs + kTile;     // 2 stages
  unsigned char* Vs = Ks + 2 * kTile;  // 2 stages

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // the heaviest q-tile (the last) of every head first, as in dk/dv
  const int64_t lin = blockIdx.x + (int64_t)gridDim.x * blockIdx.y;
  const int qb = gridDim.x - 1 - (int)(lin / gridDim.y);
  const int64_t head = lin % gridDim.y;
  const int64_t base = head * S * D;
  const int q0 = qb * kRows;
  const int nk = causal ? qb + 1 : (S + kRows - 1) / kRows;  // to the diagonal
  const bool v16 = vec != 0;

  load_tile<DP>(Qs, q, base, q0, S, D, v16);
  load_tile<DP>(dOs, dout, base, q0, S, D, v16);
  load_tile<DP>(Ks, k, base, 0, S, D, v16);
  load_tile<DP>(Vs, v, base, 0, S, D, v16);
  cp_async_commit();

  const int row0 = 16 * warp + (lane >> 2);  // this thread's first q row
  const float scale2 = scale * kLog2e;  // P = exp2(S scale2 - lse log2 e)
  float row_lse2[2];  // lse * log2(e)
  float row_dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = q0 + row0 + 8 * i;
    row_lse2[i] = p < S ? lse[head * S + p] * kLog2e : 0.f;
    row_dlt[i] = p < S ? delta[head * S + p] : 0.f;
  }
  float dq_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq_acc[i] = 0.f;
  const uint32_t q_addr = smem_addr(Qs);
  const uint32_t o_addr = smem_addr(dOs);

  for (int jk = 0, st = 0; jk < nk; ++jk, st ^= 1) {
    const int k0 = jk * kRows;
    if (jk + 1 < nk) {  // the next k-tile streams in meanwhile
      load_tile<DP>(Ks + (st ^ 1) * kTile, k, base, k0 + kRows, S, D, v16);
      load_tile<DP>(Vs + (st ^ 1) * kTile, v, base, k0 + kRows, S, D, v16);
    }
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();

    const uint32_t k_addr = smem_addr(Ks + st * kTile);
    const uint32_t v_addr = smem_addr(Vs + st * kTile);
    // S = Q K^T and dP = dO V^T: queries as rows, keys as columns; two
    // groups, so that P is taken while dP is still running
    float sacc[32];
    float pacc[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      mma_ss_n64(sacc, mdesc(q_addr + kk * 256, 128, 16 * DP),
                 mdesc(k_addr + kk * 256, 128, 16 * DP), kk);
    }
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      mma_ss_n64(pacc, mdesc(o_addr + kk * 256, 128, 16 * DP),
                 mdesc(v_addr + kk * 256, 128, 16 * DP), kk);
    }
    wg_commit();
    wg_wait<1>();
    fence_regs(sacc);

    // P in f32, in place
    const bool edge = (causal && jk == qb) || q0 + kRows > S ||
                      k0 + kRows > S;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kp = k0 + 8 * j + 2 * (lane & 3) + c;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 4 * j + 2 * i + c;
          bool keep = true;
          if (edge) {
            const int qp = q0 + row0 + 8 * i;
            keep = qp < S && kp < S && (!causal || qp >= kp);
          }
          sacc[e] = keep ? exp2f(fmaf(sacc[e], scale2, -row_lse2[i])) : 0.f;
        }
      }
    }
    wg_wait<0>();
    fence_regs(pacc);
    // dS = P (dP - delta), in place; element e is in row i = (e / 2) % 2
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      pacc[e] = sacc[e] * (pacc[e] - row_dlt[(e >> 1) & 1]);
    }
    uint32_t ds_hi[4][4], ds_lo[4][4];
    split_fragments(pacc, ds_hi, ds_lo);

    // dQ += dS K as hi + lo; B = K with K = its rows (keys): MN-major
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bk = mdesc(k_addr + kk * 32 * DP, 16 * DP, 128);
      mma_rs(dq_acc, ds_hi[kk], bk);
      mma_rs(dq_acc, ds_lo[kk], bk);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(dq_acc);
    __syncthreads();  // this stage is free for the copy after next
  }

  store_tile<DP>(dq, base, q0, S, D, dq_acc, scale);
}

size_t dq_smem_bytes(int dp) { return 6 * (size_t)kRows * dp * 2; }
size_t dkv_smem_bytes(int dp) {
  return dq_smem_bytes(dp) + 4 * (size_t)kRows * sizeof(float);
}

template <int DP>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int n, int S,
              int D, float scale, int causal, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes(DP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((S + kRows - 1) / kRows), (unsigned)n);
  flash_bwd_dq_wgmma<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
      delta, static_cast<bf16*>(dq), S, D, scale, causal,
      (int)vec_ok(D, q, k, v, dout));
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dkv(const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* delta,
               void* dk, void* dv, int n, int S, int D, float scale,
               int causal, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes(DP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((S + kRows - 1) / kRows), (unsigned)n);
  flash_bwd_dkv_wgmma<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
      delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, D, scale,
      causal, (int)vec_ok(D, q, k, v, dout));
  return (int)cudaGetLastError();
}

}  // namespace

// The bf16 launchers behind flash_bwd_dq / flash_bwd_dkv (dtype 1), on
// shapes those entries have checked (1 <= D <= 128).
int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int n, int S, int D, float scale, int causal,
                      cudaStream_t stream) {
  return D <= 64 ? launch_dq<64>(q, k, v, dout, lse, delta, dq, n, S, D,
                                 scale, causal, stream)
                 : launch_dq<128>(q, k, v, dout, lse, delta, dq, n, S, D,
                                  scale, causal, stream);
}

int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int n, int S,
                       int D, float scale, int causal, cudaStream_t stream) {
  return D <= 64 ? launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, n, S,
                                  D, scale, causal, stream)
                 : launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, n, S,
                                   D, scale, causal, stream);
}

// Bytes of dynamic shared memory each bf16 kernel asks for at head dim D.
extern "C" long long flash_bwd_dq_bf16_smem_bytes(int D) {
  return (long long)dq_smem_bytes(D <= 64 ? 64 : 128);
}
extern "C" long long flash_bwd_dkv_bf16_smem_bytes(int D) {
  return (long long)dkv_smem_bytes(D <= 64 ? 64 : 128);
}
