// Flash-attention forward for bf16 on Hopper's tensor cores (sm_90a):
// the bf16 route of the C entry flash_fwd (flash_attn.cu, which keeps the
// f32 route on the CUDA cores).
//
// Replaces, for bf16, the Pallas forward of
// ompi_release_tpu/ops/pallas_attention.py: the pl.pallas_call of
// _flash_forward (:114), body _attn_kernel (:38-88). Same function as
// flash_attn.cu states: for each of N heads, q, k, v (S, D) bf16 ->
// o (S, D) bf16 and lse (S) f32, with the scores scaled by rsqrt(D), the
// tail mask k_pos < S, the causal mask q_pos >= k_pos, the running
// max/sum in f32, o = acc / max(l, 1e-30) rounded once and
// lse = m + log(max(l, 1e-30)) (finite on every row).
//
// Bound: operations. At the model's shape (N = 64, S = 2048, D = 64,
// causal) the function needs two (S, S, D) products, S = Q K^T and
// O = P V, 2 x 2 N D S(S+1)/2 = 34.4 GFLOP: 0.0348 ms at the 989 TFLOP/s
// bf16 tensor-core peak (q, k, v, o and lse, ~67 MB, take ~0.02 ms at
// 3.35 TB/s). The bound is not recounted for the split's third product.
//
// The gate, and the hi/lo split. S = Q K^T is exact on wgmma (bf16
// operands, f32 sums). P is an f32 value computed in registers; rounded
// once to bf16 as the A operand of O += P V it misses the forward's gate
// (out within one bf16 ulp plus 2e-5 of the f32 plain twin on every
// element, lse within 1e-5): emulated on the CPU at 2 heads x S 2048,
// 10-11 % of the elements fail, causal or not, at D 64 and 128. So P is
// split into hi = bf16(p) and lo = bf16(p - hi), and each k-step runs
// O += P_hi V and O += P_lo V into one f32 accumulator (~16 significant
// bits of P): no element fails (tests/test_torch_flash_split.py pins
// both). lse comes from the f32 P, before any rounding. Three products
// instead of two.
//
// Design (right and simple first): flash_bwd_dq_wgmma's skeleton
// (flash_attn_bwd_wgmma.cu) without dO and dP, with an online softmax
// and with V in K's place. The shared pieces (descriptors, wgmma,
// cp.async, the tile loader, the hi/lo split, the store) are
// wgmma_sm90.cuh's.
// - Grid (ceil(S / 64), N), one warpgroup (128 threads) per block owning
//   64 query rows, read in linear order with the heads fastest, so the
//   heaviest q-tile (the last) of every head is issued first.
// - Q is loaded once into shared memory as bf16 in the no-swizzle
//   core-matrix layout (64 x DP); K and V stream in 64-row tiles,
//   double-buffered with cp.async (16-byte copies when D % 8 == 0 and q,
//   k, v are 16-byte aligned, element loads otherwise). Rows past S and
//   columns past D load as zeros, are masked and never stored. DP, the
//   padded head dim, is 64 (D <= 64) or 128 (D <= 128).
// - S = Q K^T: m64n64k16 with A = Q and B = K, both K-major, DP / 16
//   k-steps. The scale is applied in f32 after the product, never to q
//   in bf16 (rsqrt(128) is not a power of two).
// - Online softmax in the accumulator registers: each thread holds 16 of
//   the 64 scores of rows 16 warp + lane / 4 and +8; the row max is a
//   quad shuffle (__shfl_xor_sync, offsets 1 and 2). m is kept in log2
//   units (m2 = max(S) scale log2 e), P = exp2f(fmaf(S, scale log2 e,
//   -m2)) and alpha = exp2f(m2_old - m2); the O accumulator (DP / 2
//   floats) is scaled by alpha; l is this lane's part of the sum of the
//   f32 P, scaled by the same alpha and summed over the quad once, at
//   the end.
// - O += P V as hi + lo: split_fragments turns P's accumulator into the
//   register-A fragments of the four k-steps (the m64nNk16 accumulator's
//   8-column chunks 2kk and 2kk+1 are, lane for lane, k-step kk's A);
//   B = V with K = its rows (the keys): MN-major, the transpose bit set.
//   P never touches shared memory.
// - Causal: the k-loop stops at the diagonal tile; only the diagonal tile
//   and the ragged tail are masked, by select (p = 0; the masked scores
//   stay out of the max), never by exp of the sentinel. A skipped tile
//   would give p = 0 and alpha = 1 to every row: skipping is exact.
// - Each wgmma group is waited for (wait_group) before its results are
//   read or its register operands rewritten; wgmma.fence orders the
//   registers written before a group (alpha's rescale of O). The next
//   K/V tile's copies are in flight meanwhile.
// - Epilogue: out = O / max(l, 1e-30), rounded once to bf16
//   (__float2bfloat16_rn), stored for rows < S and columns < D;
//   lse = m2 ln 2 + logf(max(l, 1e-30)) in f32.
//
// ptxas (-Xptxas -v, CUDA 12.8, sm_90a; chip_smoke.py's ptxas_report
// prints it from every build): 133 registers at DP 64 and 191 at DP 128,
// no spill, no static shared memory (the f32 accumulators of S and O,
// and P's two fragment sets). cuobjdump -sass: 12 HGMMA at DP 64 (4 for
// S, 8 for P V) and 16 at DP 128, no atomic.
// Dynamic shared memory 5 x 64 DP x 2 B (Q and two stages of K and V):
// 40,960 B at DP 64 and 81,920 B at DP 128, above the 48 KB default at
// DP 128, so the launcher raises the limit with cudaFuncSetAttribute.
//
// Later work: overlapping the next tile's S product with this tile's
// softmax (FlashAttention-3's intra-warpgroup pipelining), TMA with warp
// specialisation, a swizzled layout, two consumer warpgroups (128 query
// rows sharing each K/V tile).
//
// The kernel allocates nothing and launches on the caller's stream; the
// launcher returns cudaGetLastError() (or the attribute call's error).

#include "wgmma_sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // pallas_attention.NEG_INF
constexpr float kLn2 = 0.6931471805599453f;

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, int S, int D, float scale,
                    int causal, int vec) {
  constexpr int kTile = kRows * DP * 2;  // bytes of one bf16 tile
  extern __shared__ __align__(128) unsigned char fwd_smem[];
  unsigned char* Qs = fwd_smem;
  unsigned char* Ks = Qs + kTile;      // 2 stages
  unsigned char* Vs = Ks + 2 * kTile;  // 2 stages

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // blocks start in linear order; read it with the heads fastest, so the
  // heaviest q-tile (the last) of every head is issued first
  const int64_t lin = blockIdx.x + (int64_t)gridDim.x * blockIdx.y;
  const int qb = gridDim.x - 1 - (int)(lin / gridDim.y);
  const int64_t head = lin % gridDim.y;
  const int64_t base = head * S * D;
  const int q0 = qb * kRows;
  const int nk = causal ? qb + 1 : (S + kRows - 1) / kRows;  // to the diagonal
  const bool v16 = vec != 0;

  load_tile<DP>(Qs, q, base, q0, S, D, v16);
  load_tile<DP>(Ks, k, base, 0, S, D, v16);
  load_tile<DP>(Vs, v, base, 0, S, D, v16);
  cp_async_commit();

  const int row0 = 16 * warp + (lane >> 2);  // this thread's first q row
  const float scale2 = scale * kLog2e;  // P = exp2(S scale2 - m2)
  float row_m2[2] = {kNegInf, kNegInf};  // running max of S scale2
  float row_l[2] = {0.f, 0.f};  // this lane's part of the running sum
  float o_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o_acc[i] = 0.f;
  const uint32_t q_addr = smem_addr(Qs);

  for (int jk = 0, st = 0; jk < nk; ++jk, st ^= 1) {
    const int k0 = jk * kRows;
    if (jk + 1 < nk) {  // the next k-tile streams in meanwhile
      load_tile<DP>(Ks + (st ^ 1) * kTile, k, base, k0 + kRows, S, D, v16);
      load_tile<DP>(Vs + (st ^ 1) * kTile, v, base, k0 + kRows, S, D, v16);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this k-tile (and Q) landed
    fence_async_smem();
    __syncthreads();

    const uint32_t k_addr = smem_addr(Ks + st * kTile);
    const uint32_t v_addr = smem_addr(Vs + st * kTile);
    // S = Q K^T: queries as rows, keys as columns
    float sacc[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      mma_ss_n64(sacc, mdesc(q_addr + kk * 256, 128, 16 * DP),
                 mdesc(k_addr + kk * 256, 128, 16 * DP), kk);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(sacc);

    // element e = 4j + 2i + c is (row0 + 8i, key k0 + 8j + 2(lane % 4) + c)
    const bool edge = (causal && jk == qb) || k0 + kRows > S;
    auto kept = [&](int j, int i, int c) {
      const int kp = k0 + 8 * j + 2 * (lane & 3) + c;
      return !edge ||
             (kp < S && (!causal || q0 + row0 + 8 * i >= kp));
    };
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          if (kept(j, i, c)) mx[i] = fmaxf(mx[i], sacc[4 * j + 2 * i + c]);
        }
      }
    }
    float m2[2];
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // a row with every key of the tile masked keeps its max (alpha 1)
      m2[i] = fmaxf(row_m2[i], mx[i] * scale2);
      alpha[i] = exp2f(row_m2[i] - m2[i]);
      row_m2[i] = m2[i];
    }
    // P in f32, in place; l from the f32 P
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * i + c;
          sacc[e] = kept(j, i, c) ? exp2f(fmaf(sacc[e], scale2, -m2[i]))
                                  : 0.f;
          psum[i] += sacc[e];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) row_l[i] = row_l[i] * alpha[i] + psum[i];
    // O's element e is in row i = (e / 2) % 2, as S's
#pragma unroll
    for (int e = 0; e < DP / 2; ++e) o_acc[e] *= alpha[(e >> 1) & 1];
    uint32_t p_hi[4][4], p_lo[4][4];
    split_fragments(sacc, p_hi, p_lo);

    // O += P V as hi + lo; B = V with K = its rows (keys): MN-major
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bv = mdesc(v_addr + kk * 32 * DP, 16 * DP, 128);
      mma_rs(o_acc, p_hi[kk], bv);
      mma_rs(o_acc, p_lo[kk], bv);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(o_acc);
    __syncthreads();  // this stage is free for the copy after next
  }

  float l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = row_l[i];
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int e = 0; e < DP / 2; ++e) o_acc[e] = o_acc[e] / l[(e >> 1) & 1];
  store_tile<DP>(o, base, q0, S, D, o_acc, 1.f);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = q0 + row0 + 8 * i;
      if (p < S) lse[head * S + p] = row_m2[i] * kLn2 + logf(l[i]);
    }
  }
}

size_t fwd_smem_bytes(int dp) { return 5 * (size_t)kRows * dp * 2; }

template <int DP>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int n, int S, int D, float scale, int causal,
               cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(DP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((S + kRows - 1) / kRows), (unsigned)n);
  // o is stored element by element: only q, k, v need the alignment
  flash_fwd_wgmma<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, S, D, scale,
      causal, (int)vec_ok(D, q, k, v, v));
  return (int)cudaGetLastError();
}

}  // namespace

// The bf16 launcher behind flash_fwd (dtype 1), on shapes that entry has
// checked (1 <= D <= 128).
int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                   float* lse, int n, int S, int D, float scale, int causal,
                   cudaStream_t stream) {
  return D <= 64 ? launch_fwd<64>(q, k, v, o, lse, n, S, D, scale, causal,
                                  stream)
                 : launch_fwd<128>(q, k, v, o, lse, n, S, D, scale, causal,
                                   stream);
}

// Bytes of dynamic shared memory the bf16 kernel asks for at head dim D.
extern "C" long long flash_fwd_bf16_smem_bytes(int D) {
  return (long long)fwd_smem_bytes(D <= 64 ? 64 : 128);
}
