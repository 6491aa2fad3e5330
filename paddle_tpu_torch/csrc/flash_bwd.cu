// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes:
// two kernels, as the TPU split them, neither needing atomics, so every run
// gives the same bits.
//
// Replaces: paddle_tpu/ops/attention.py::_flash_bwd_dq_kernel (K2, launched
// by _pallas_flash_bwd_32) and ::_flash_bwd_dkv_kernel (K3). With
// P = exp(S * scale [causal mask -1e30] - LSE), dP = dO V^T and
// dS = P * (dP - delta), delta = rowsum(dO * O) precomputed by the caller:
//
//   K2  dQ = scale * dS K       one block per (64-row query tile, b*h),
//                               walking the key tiles
//   K3  dV = P^T dO             one block per (64-row key tile, b*h),
//       dK = scale * dS^T Q     walking the query tiles
//
//   q, k, v, dout   [B, H, S, D]  f32 or bf16, contiguous, D in {64, 128}
//   lse, delta      [B, H, 1, S]  f32
//   dq, dk, dv      [B, H, S, D]  q's dtype
//
// What bounds it on this card: operations. Per (query, key) pair K2 does
// three products of D multiply-adds (S, dP, dQ) and K3 four (S, dP, dV,
// dK), hundreds of flops per byte at S = 1024: the tensor cores' rate in
// bf16 (989 TFLOP/s), the CUDA cores' in f32 (67 TFLOP/s; TF32 is off by
// contract).
//
// Both dtypes recompute S and P from LSE tile by tile, so nothing of size
// S x S exists, and sum every product in f32. Causal: tiles wholly in the
// future are not visited (K2: key tiles past the query tile; K3: query
// tiles before the key tile), as the TPU kernels skipped qi < ki. Ragged S:
// rows past S load as zeros, get P = dS = 0 (or touch only rows that are
// never written) and are never written.
//
// bf16 (flash_bwd_dq_mma_kernel, flash_bwd_dkv_mma_kernel): the Pallas
// kernels' arithmetic on the tensor cores, in the forward's FA2 layout on
// mma.sync.m16n8k16 (bf16 in, f32 sum); wgmma, TMA and warp specialisation
// come later:
//   * a block of 4 warps owns 64 rows, 16 a warp: K2 64 query rows, whose
//     Q and dO A fragments stay in registers (loaded once through
//     ldmatrix); K3 64 key rows, whose K and V A fragments stay there. At
//     D = 128 the fragments are read from the staged tile each time
//     instead, so the accumulators fit in registers;
//   * the other side streams through shared memory in 64-row bf16 tiles
//     (K2: K and V; K3: Q, dO and their 64 LSE and delta values), rows
//     padded by 16 bytes, double-buffered by cp.async: the next tile loads
//     while this one computes, one barrier a tile;
//   * S and dP (16 x 64 a warp, 32 f32 a thread each) stay in registers,
//     their B fragments from the staged tile through plain ldmatrix. LSE is
//     natural-log, so P = exp2(S * scale * log2(e) - LSE * log2(e)), one
//     FMA and one exp2f an element;
//   * K2: dS = P (dP - delta) in f32, rounded to bf16 straight into the A
//     layout of dQ += dS K (the two n8 accumulator tiles of S over keys
//     16j..16j+15 are the k16 A fragment j), K's B fragments through
//     ldmatrix.trans from the same staged tile;
//   * K3 computes the transposes S^T = K Q^T and dP^T = V dO^T, so P^T and
//     dS^T come out in the A layout of dV += P^T dO and dK += dS^T Q (dO
//     and Q through ldmatrix.trans); LSE and delta are per column there;
//   * P is rounded to bf16 before the dV product and dS before the dQ and
//     dK products, as the Pallas kernels round them (attention.py:227,
//     :264, :267); dS is made from the unrounded P. The gradients (16 x D
//     f32 a warp, dQ and dK scaled) are rounded once;
//   * causal: only the diagonal tile (and a ragged last tile) is masked, by
//     each element's own row and column; the grid runs the longest tiles
//     first. q, k, v or dO not 16-byte aligned stage element by element.
//
// f32 (flash_bwd_dq_f32_kernel, flash_bwd_dkv_f32_kernel) on the CUDA cores,
// the Pallas kernels' arithmetic with P and dS unrounded:
//   * a block of 4 warps holds 64 rows (K2: query rows with their Q, dO,
//     LSE and delta; K3: key rows with their K and V), 16 a warp, and
//     streams the other side in tiles of 32 rows at D = 64, 16 at D = 128
//     (K2: K and V; K3: Q, dO and their LSE and delta) by 16-byte cp.async,
//     double-buffered: the next tile loads while this one computes, one
//     barrier a tile. Q, K, V or dO (or an output) not 16-byte aligned
//     stage (and store) element by element through the same kernel;
//   * a lane (row group rg = lane / 8, column group cg = lane % 8) owns
//     the warp's rows rg + 4i, i < 4, in every product: S and dP for the
//     streamed rows cg + 8j, the gradient for the columns 4 cg + 32 m.
//     P (K3) and dS change layout through a tile private to the warp, so a
//     __syncwarp, not a block barrier, separates writing and reading them;
//   * every shared-memory read is a float4 (LDS.128): S and dP read the
//     held and streamed rows along D, the gradient products read P or dS
//     along the contraction and the staged rows across the output columns.
//     Rows padded to D + 4 (staged) and columns + 8 (P, dS tiles) put each
//     load's words in distinct banks. FMAs per word a lane reads, over 4
//     steps of the contraction:
//       S, dP (K2, K3)   D = 64: 64 per 32 words (2); D = 128: 32 per 24 (1.3)
//       dQ, dV, dK       D = 64: 128 per 48 (2.7); D = 128: 256 per 80 (3.2)
//     All fall short of the 4 a lane needs for its loads to keep pace with
//     its FMAs, so the loads, not the FMA units, set the products' rate.
//     Why: a warp owns 16 rows, so a lane's tile is 4 x 4 of S at D = 64,
//     4 x 2 at D = 128 (4 x D/8 of a gradient). Larger lane tiles need
//     more held rows a warp and more registers: a layout with 8 rows a
//     lane at D = 64 (2 or 3 warps a block) ran slower, and 6 warps a
//     block of 16 rows each gained nothing, so warps are not short;
//   * P = exp2(S * scale * log2(e) - LSE * log2(e)), one FMA and one exp2f;
//     causal: only the tiles that cross the diagonal (and a ragged last
//     tile) are masked, by each element's own row and column; both grids
//     run the longest tiles first;
//   * shared memory a block (from dq_f32_smem_bytes / dkv_f32_smem_bytes):
//     K2 79,872 B at D = 64 and 107,520 B at D = 128, K3 90,624 and 113,920
//     B, so two blocks (8 warps) an SM at either width.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kB = 64;         // rows of a query or key tile

// ---- bf16 on the tensor cores ----------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kMThreads = 128;  // 4 warps, 16 rows each
constexpr float kLog2e = 1.4426950408889634f;

// the block's own Q and dO (K2) or K and V (K3), then the streamed pair
// double-buffered, in bf16 rows of D + 8; K3 adds its double-buffered LSE
// and delta
template <int D>
constexpr int mma_smem_bytes(bool stats) {
  return 6 * kB * (D + 8) * 2 + (stats ? 4 * kB * 4 : 0);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `bytes` = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// 4 bytes global -> shared; `bytes` = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and each thread gets (row lane/4, columns 2(lane%4), +1) of
// each (.trans: of each one's transpose)
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c[16 x 8] += a[16 x 16] b[16 x 8], bf16 in, f32 sum
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 as one bf16x2 register (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 64 rows from r0 of a [S, D] matrix into dst (row stride D + 8); rows past
// S are zero. `vec`: the source is 16-byte aligned
template <int D>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, int r0,
                                      int S, int vec) {
  constexpr int LD = D + 8;
  if (vec) {
    for (int idx = threadIdx.x; idx < kB * (D / 8); idx += kMThreads) {
      const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
      const bool ok = r0 + r < S;
      cp_async16(dst + r * LD + c, ok ? src + (size_t)(r0 + r) * D + c : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < kB * D; idx += kMThreads) {
      const int r = idx / D, c = idx % D;
      dst[r * LD + c] = r0 + r < S ? src[(size_t)(r0 + r) * D + c]
                                   : __float2bfloat16(0.f);
    }
  }
}

// a[rows 16, k 16] A fragment kk of this warp's 16 rows of a staged tile
template <int D>
__device__ __forceinline__ void a_frag(uint32_t a[4], const bf16* tile,
                                       int warp, int lane, int kk) {
  const int lr = lane & 7, lm = lane >> 3;
  ldsm_x4(a, tile + (warp * 16 + lr + (lm & 1) * 8) * (D + 8) + kk * 16 +
                 (lm >> 1) * 8);
}

// acc[16 x 64] = A B^T of this warp: A its 16 rows (fragments `af`, or read
// from `a_tile` when `held` is false), B the 64 rows of a staged tile
template <int D, bool held>
__device__ __forceinline__ void warp_abt(float acc[8][4],
                                         const uint32_t af[][4],
                                         const bf16* a_tile, const bf16* b,
                                         int warp, int lane) {
  constexpr int LD = D + 8;
  const int lr = lane & 7, lm = lane >> 3;
  const int b_row = lr + (lm >> 1) * 8, b_col = (lm & 1) * 8;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    if (held) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = af[kk][i];
    } else {
      a_frag<D>(a, a_tile, warp, lane, kk);
    }
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      uint32_t bfr[4];
      ldsm_x4(bfr, b + (nb * 16 + b_row) * LD + kk * 16 + b_col);
      mma_bf16(acc[2 * nb], a, bfr[0], bfr[1]);
      mma_bf16(acc[2 * nb + 1], a, bfr[2], bfr[3]);
    }
  }
}

// out[16 x D] += A[16 x 64] B[64 x D]: A as four k16 fragments (bf16 pairs
// in registers), B the 64 rows of a staged tile through ldmatrix.trans
template <int D>
__device__ __forceinline__ void warp_ab(float out[][4], const uint32_t a[4][4],
                                        const bf16* b, int lane) {
  constexpr int LD = D + 8;
  const int lr = lane & 7, lm = lane >> 3;
  const int t_row = lr + (lm & 1) * 8, t_col = (lm >> 1) * 8;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int nd = 0; nd < D / 16; ++nd) {
      uint32_t bfr[4];
      ldsm_x4_t(bfr, b + (j * 16 + t_row) * LD + nd * 16 + t_col);
      mma_bf16(out[2 * nd], a[j], bfr[0], bfr[1]);
      mma_bf16(out[2 * nd + 1], a[j], bfr[2], bfr[3]);
    }
  }
}

// this thread's two rows (row0, row0 + 8) of a warp's 16 x D f32
// accumulator, times `mul`, rounded to bf16, where the row is below S
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const float acc[][4],
                                           int row0, int tq, int S,
                                           float mul) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + h * 8;
    if (row >= S) continue;
    bf16* out = dst + (size_t)row * D + 2 * tq;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + n * 8) = __floats2bfloat162_rn(
          acc[n][2 * h] * mul, acc[n][2 * h + 1] * mul);
  }
}

// K2 in bf16: one block per (b*h = blockIdx.x, 64-row query tile
// nq - 1 - blockIdx.y). scale_log2 = scale * log2(e).
template <int D>
__global__ void __launch_bounds__(kMThreads)
    flash_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const bf16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            bf16* __restrict__ dq, int S, float scale,
                            float scale_log2, int causal, int vec) {
  constexpr int LD = D + 8;
  constexpr int KD = D / 16;  // k16 steps of S and dP
  constexpr int ND = D / 8;   // n8 tiles of dQ
  constexpr bool held = D <= 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [kB][LD]
  bf16* sdO = sQ + kB * LD;                      // [kB][LD]
  bf16* sK = sdO + kB * LD;                      // [2][kB][LD]
  bf16* sV = sK + 2 * kB * LD;                   // [2][kB][LD]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // the longest tiles first
  const int q0 = qt * kB;
  const size_t off = bh * S * D;
  const int gq = lane >> 2, tq = lane & 3;  // accumulator row, column pair
  const int row0 = q0 + warp * 16 + gq;     // this thread's rows: row0, +8

  const int n_tiles = (S + kB - 1) / kB;
  const int last = causal ? min(n_tiles - 1, qt) : n_tiles - 1;

  stage<D>(sQ, q + off, q0, S, vec);
  stage<D>(sdO, dout + off, q0, S, vec);
  stage<D>(sK, k + off, 0, S, vec);
  stage<D>(sV, v + off, 0, S, vec);
  cp_async_commit();

  // LSE in log2 units and delta of this thread's two rows (0 past S)
  float l2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + h * 8;
    l2[h] = row < S ? lse[bh * S + row] * kLog2e : 0.f;
    dl[h] = row < S ? delta[bh * S + row] : 0.f;
  }

  uint32_t qf[KD][4], dof[KD][4];
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt <= last; ++kt) {
    cp_async_wait_all();
    __syncthreads();  // tile kt is staged; every warp is past tile kt - 1
    if (held && kt == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        a_frag<D>(qf[kk], sQ, warp, lane, kk);
        a_frag<D>(dof[kk], sdO, warp, lane, kk);
      }
    }
    if (kt < last) {  // into the buffers tile kt - 1 used
      const int nb = (kt + 1) & 1;
      stage<D>(sK + nb * kB * LD, k + off, (kt + 1) * kB, S, vec);
      stage<D>(sV + nb * kB * LD, v + off, (kt + 1) * kB, S, vec);
      cp_async_commit();
    }
    const bf16* cK = sK + (kt & 1) * kB * LD;
    const bf16* cV = sV + (kt & 1) * kB * LD;

    float s[8][4], dp[8][4];
    warp_abt<D, held>(s, qf, sQ, cK, warp, lane);
    warp_abt<D, held>(dp, dof, sdO, cV, warp, lane);

    // P, then dS = P (dP - delta) rounded to bf16 as the A fragments of
    // dS K; masked (the causal diagonal and a ragged last tile) P is 0
    const int k0 = kt * kB;
    const bool masked = k0 + kB > S || (causal && kt == qt);
    uint32_t dsf[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[n][e], scale_log2, -l2[e >> 1]));
        if (masked) {
          const int col = k0 + n * 8 + 2 * tq + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          if (col >= S || (causal && col > row)) p = 0.f;
        }
        ds[e] = p * (dp[n][e] - dl[e >> 1]);
      }
      dsf[n >> 1][(n & 1) * 2] = pack_bf16(ds[0], ds[1]);
      dsf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    warp_ab<D>(acc, dsf, cK, lane);
  }

  store_rows<D>(dq + off, acc, row0, tq, S, scale);
}

// K3 in bf16: one block per (b*h = blockIdx.x, 64-row key tile blockIdx.y;
// causal, the first key tiles see the most query tiles). Rows of every
// product are this block's keys, columns the streamed queries.
template <int D>
__global__ void __launch_bounds__(kMThreads)
    flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             bf16* __restrict__ dk, bf16* __restrict__ dv,
                             int S, float scale, float scale_log2, int causal,
                             int vec) {
  constexpr int LD = D + 8;
  constexpr int KD = D / 16;
  constexpr int ND = D / 8;
  constexpr bool held = D <= 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // [kB][LD]
  bf16* sV = sK + kB * LD;                       // [kB][LD]
  bf16* sQ = sV + kB * LD;                       // [2][kB][LD]
  bf16* sdO = sQ + 2 * kB * LD;                  // [2][kB][LD]
  float* sL = reinterpret_cast<float*>(sdO + 2 * kB * LD);  // [2][kB]
  float* sD = sL + 2 * kB;                                  // [2][kB]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const size_t bh = blockIdx.x;
  const int kt = blockIdx.y;
  const int k0 = kt * kB;
  const size_t off = bh * S * D;
  const int gq = lane >> 2, tq = lane & 3;
  const int row0 = k0 + warp * 16 + gq;  // this thread's keys: row0, +8

  const int n_tiles = (S + kB - 1) / kB;
  const int first = causal ? kt : 0;

  // Q, dO and the 64 LSE and delta values of query tile qt into buffer b
  auto stage_q = [&](int b, int qt) {
    const int q0 = qt * kB;
    stage<D>(sQ + b * kB * LD, q + off, q0, S, vec);
    stage<D>(sdO + b * kB * LD, dout + off, q0, S, vec);
    const float* src = tid < kB ? lse : delta;
    const int r = tid % kB;
    const bool ok = q0 + r < S;
    cp_async4((tid < kB ? sL : sD) + b * kB + r,
              ok ? src + bh * S + q0 + r : src, ok ? 4 : 0);
  };

  stage<D>(sK, k + off, k0, S, vec);
  stage<D>(sV, v + off, k0, S, vec);
  stage_q(0, first);
  cp_async_commit();

  uint32_t kf[KD][4], vf[KD][4];
  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  for (int qt = first; qt < n_tiles; ++qt) {
    const int it = qt - first;
    cp_async_wait_all();
    __syncthreads();  // tile qt is staged; every warp is past tile qt - 1
    if (held && it == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        a_frag<D>(kf[kk], sK, warp, lane, kk);
        a_frag<D>(vf[kk], sV, warp, lane, kk);
      }
    }
    if (qt + 1 < n_tiles) {  // into the buffers tile qt - 1 used
      stage_q((it + 1) & 1, qt + 1);
      cp_async_commit();
    }
    const int b = it & 1;
    const bf16* cQ = sQ + b * kB * LD;
    const bf16* cdO = sdO + b * kB * LD;
    const float* cL = sL + b * kB;
    const float* cD = sD + b * kB;

    // P^T = exp(S^T scale - LSE[col]); masked (the causal diagonal and a
    // ragged last query tile) P^T is 0; rounded to bf16 for dV
    float s[8][4];
    warp_abt<D, held>(s, kf, sK, cQ, warp, lane);
    const int q0 = qt * kB;
    const bool masked = q0 + kB > S || (causal && qt == kt);
    uint32_t af[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 l = *reinterpret_cast<const float2*>(cL + n * 8 + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[n][e], scale_log2,
                             -((e & 1) ? l.y : l.x) * kLog2e));
        if (masked) {
          const int col = q0 + n * 8 + 2 * tq + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          if (col >= S || (causal && col < row)) p = 0.f;
        }
        s[n][e] = p;
      }
      af[n >> 1][(n & 1) * 2] = pack_bf16(s[n][0], s[n][1]);
      af[n >> 1][(n & 1) * 2 + 1] = pack_bf16(s[n][2], s[n][3]);
    }
    warp_ab<D>(acc_v, af, cdO, lane);

    // dS^T = P^T (dP^T - delta[col]), from the unrounded P^T; rounded to
    // bf16 for dK
    float dp[8][4];
    warp_abt<D, held>(dp, vf, sV, cdO, warp, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 d = *reinterpret_cast<const float2*>(cD + n * 8 + 2 * tq);
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[e] = s[n][e] * (dp[n][e] - ((e & 1) ? d.y : d.x));
      af[n >> 1][(n & 1) * 2] = pack_bf16(ds[0], ds[1]);
      af[n >> 1][(n & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    warp_ab<D>(acc_k, af, cQ, lane);
  }

  store_rows<D>(dk + off, acc_k, row0, tq, S, scale);
  store_rows<D>(dv + off, acc_v, row0, tq, S, 1.f);
}

// ---- f32 on the CUDA cores -------------------------------------------------

constexpr int kFThreads = 128;  // 4 warps, 16 held rows each

// rows of a streamed tile: 32 at D = 64, 16 at D = 128, so that two blocks
// fit an SM at either width
template <int D>
__host__ __device__ constexpr int f_cols() {
  return D == 64 ? 32 : 16;
}

// row strides in floats: a staged tile (D + 4: consecutive rows start in
// consecutive 16-byte bank groups) and a warp's P or dS tile (columns + 8:
// a lane group's scalar stores hit 32 banks, its float4 loads distinct
// groups)
template <int D>
__host__ __device__ constexpr int f_ld() {
  return D + 4;
}

template <int D>
__host__ __device__ constexpr int f_ldp() {
  return f_cols<D>() + 8;
}

// K2: Q and dO held, K and V double-buffered, a dS tile a warp
template <int D>
constexpr int dq_f32_smem_bytes() {
  return (2 * kB * f_ld<D>() + 4 * f_cols<D>() * f_ld<D>() +
          4 * 16 * f_ldp<D>()) *
         4;
}

// K3: K and V held, Q and dO double-buffered with their LSE and delta, a P
// and a dS tile a warp
template <int D>
constexpr int dkv_f32_smem_bytes() {
  return (2 * kB * f_ld<D>() + 4 * f_cols<D>() * f_ld<D>() +
          4 * f_cols<D>() + 2 * 4 * 16 * f_ldp<D>()) *
         4;
}

// `rows` rows from r0 of a [S, D] f32 matrix into dst (row stride D + 4);
// rows past S are zero. `vec`: the source is 16-byte aligned (cp.async by
// 16 bytes, waited for by the caller); else element by element
template <int D>
__device__ __forceinline__ void stage_f32(float* dst,
                                          const float* __restrict__ src,
                                          int r0, int rows, int S, int vec) {
  constexpr int LD = f_ld<D>();
  if (vec) {
    for (int idx = threadIdx.x; idx < rows * (D / 4); idx += kFThreads) {
      const int r = idx / (D / 4), c = (idx % (D / 4)) * 4;
      const bool ok = r0 + r < S;
      cp_async16(dst + r * LD + c, ok ? src + (size_t)(r0 + r) * D + c : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * D; idx += kFThreads) {
      const int r = idx / D, c = idx % D;
      dst[r * LD + c] = r0 + r < S ? src[(size_t)(r0 + r) * D + c] : 0.f;
    }
  }
}

__device__ __forceinline__ float f4_at(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// acc[i][j] = sum over D of A[4i][c] B[8j][c]: A this thread's 4 held rows
// (stride 4 rows), B its NJ streamed rows (stride 8 rows), both read as
// float4 along the contraction
template <int D, int NJ>
__device__ __forceinline__ void f_abt(float acc[4][NJ], const float* A,
                                      const float* B) {
  constexpr int LD = f_ld<D>();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; c += 4) {
    float4 a[4], b[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + i * 4 * LD + c);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + j * 8 * LD + c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

// out[i][4m + e] += sum over NT of A[4i][t] B[t][32m + e]: A this thread's 4
// rows of its warp's P or dS tile, B a staged tile from this thread's first
// column; A as float4 along the contraction, B as float4 across the output
template <int D, int NT>
__device__ __forceinline__ void f_ab(float out[4][D / 8], const float* A,
                                     const float* B) {
  constexpr int LD = f_ld<D>(), LDP = NT + 8, M = D / 32;
#pragma unroll
  for (int t = 0; t < NT; t += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + i * 4 * LDP + t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float4 b[M];
#pragma unroll
      for (int m = 0; m < M; ++m)
        b[m] = *reinterpret_cast<const float4*>(B + (t + e) * LD + 32 * m);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av = f4_at(a[i], e);
#pragma unroll
        for (int m = 0; m < M; ++m) {
          out[i][4 * m] = fmaf(av, b[m].x, out[i][4 * m]);
          out[i][4 * m + 1] = fmaf(av, b[m].y, out[i][4 * m + 1]);
          out[i][4 * m + 2] = fmaf(av, b[m].z, out[i][4 * m + 2]);
          out[i][4 * m + 3] = fmaf(av, b[m].w, out[i][4 * m + 3]);
        }
      }
    }
  }
}

// this thread's 4 rows (hr + 4i, below S) of a gradient, times `mul`, from
// column 4 cg in float4 steps of 32 (`vec`) or one float at a time
template <int D>
__device__ __forceinline__ void store_f32(float* dst,
                                          const float acc[4][D / 8],
                                          int row0, int cg, int S, float mul,
                                          int vec) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * i;
    if (row >= S) continue;
    float* out = dst + (size_t)row * D + 4 * cg;
#pragma unroll
    for (int m = 0; m < D / 32; ++m) {
      const float4 g =
          make_float4(acc[i][4 * m] * mul, acc[i][4 * m + 1] * mul,
                      acc[i][4 * m + 2] * mul, acc[i][4 * m + 3] * mul);
      if (vec) {
        *reinterpret_cast<float4*>(out + 32 * m) = g;
      } else {
        out[32 * m] = g.x;
        out[32 * m + 1] = g.y;
        out[32 * m + 2] = g.z;
        out[32 * m + 3] = g.w;
      }
    }
  }
}

// K2 in f32: one block per (b*h = blockIdx.x, 64-row query tile
// nq - 1 - blockIdx.y). scale_log2 = scale * log2(e).
template <int D>
__global__ void __launch_bounds__(kFThreads)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dq, int S, float scale,
                            float scale_log2, int causal, int vec) {
  constexpr int LD = f_ld<D>(), NC = f_cols<D>(), NJ = NC / 8;
  constexpr int LDP = f_ldp<D>();
  extern __shared__ __align__(16) float fsm[];
  float* sQ = fsm;                // [kB][LD]
  float* sdO = sQ + kB * LD;      // [kB][LD]
  float* sK = sdO + kB * LD;      // [2][NC][LD]
  float* sV = sK + 2 * NC * LD;   // [2][NC][LD]
  float* sdS = sV + 2 * NC * LD;  // [4 warps][16][LDP]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane >> 3, cg = lane & 7;
  const size_t bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // the longest tiles first
  const int q0 = qt * kB;
  const size_t off = bh * S * D;
  const int hr = warp * 16 + rg;  // this thread's query rows: hr + 4i
  float* myS = sdS + warp * 16 * LDP;

  const int n_tiles = (S + NC - 1) / NC;
  const int last =
      causal ? min(n_tiles - 1, (q0 + kB - 1) / NC) : n_tiles - 1;

  stage_f32<D>(sQ, q + off, q0, kB, S, vec);
  stage_f32<D>(sdO, dout + off, q0, kB, S, vec);
  stage_f32<D>(sK, k + off, 0, NC, S, vec);
  stage_f32<D>(sV, v + off, 0, NC, S, vec);
  cp_async_commit();

  // LSE in log2 units and delta of this thread's rows (0 past S)
  float l2[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + hr + 4 * i;
    l2[i] = row < S ? lse[bh * S + row] * kLog2e : 0.f;
    dl[i] = row < S ? delta[bh * S + row] : 0.f;
  }

  float acc[4][D / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 8; ++c) acc[i][c] = 0.f;

  for (int kt = 0; kt <= last; ++kt) {
    cp_async_wait_all();
    __syncthreads();  // tile kt is staged; every warp is past tile kt - 1
    if (kt < last) {  // into the buffers tile kt - 1 used
      const int nb = (kt + 1) & 1;
      stage_f32<D>(sK + nb * NC * LD, k + off, (kt + 1) * NC, NC, S, vec);
      stage_f32<D>(sV + nb * NC * LD, v + off, (kt + 1) * NC, NC, S, vec);
      cp_async_commit();
    }
    const float* cK = sK + (kt & 1) * NC * LD;
    const float* cV = sV + (kt & 1) * NC * LD;

    float s[4][NJ], dp[4][NJ];
    f_abt<D, NJ>(s, sQ + hr * LD, cK + cg * LD);
    f_abt<D, NJ>(dp, sdO + hr * LD, cV + cg * LD);

    // dS = P (dP - delta) into the warp's tile; masked (the causal
    // diagonal and a ragged last tile) P is 0
    const int k0 = kt * NC;
    const bool masked = k0 + NC > S || (causal && k0 + NC - 1 > q0);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float p = exp2f(fmaf(s[i][j], scale_log2, -l2[i]));
        if (masked) {
          const int col = k0 + cg + 8 * j, row = q0 + hr + 4 * i;
          if (col >= S || (causal && col > row)) p = 0.f;
        }
        myS[(rg + 4 * i) * LDP + cg + 8 * j] = p * (dp[i][j] - dl[i]);
      }
    __syncwarp();
    f_ab<D, NC>(acc, myS + rg * LDP, cK + 4 * cg);
  }

  store_f32<D>(dq + off, acc, q0 + hr, cg, S, scale, vec);
}

// K3 in f32: one block per (b*h = blockIdx.x, 64-row key tile blockIdx.y;
// causal, the first key tiles see the most query tiles). Rows of every
// product are this block's keys, columns the streamed queries.
template <int D>
__global__ void __launch_bounds__(kFThreads)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv,
                             int S, float scale, float scale_log2, int causal,
                             int vec) {
  constexpr int LD = f_ld<D>(), NC = f_cols<D>(), NJ = NC / 8;
  constexpr int LDP = f_ldp<D>();
  extern __shared__ __align__(16) float fsm[];
  float* sK = fsm;                  // [kB][LD]
  float* sV = sK + kB * LD;         // [kB][LD]
  float* sQ = sV + kB * LD;         // [2][NC][LD]
  float* sdO = sQ + 2 * NC * LD;    // [2][NC][LD]
  float* sL = sdO + 2 * NC * LD;    // [2][NC]
  float* sD = sL + 2 * NC;          // [2][NC]
  float* sP = sD + 2 * NC;          // [4 warps][16][LDP]
  float* sdS = sP + 4 * 16 * LDP;   // [4 warps][16][LDP]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int rg = lane >> 3, cg = lane & 7;
  const size_t bh = blockIdx.x;
  const int kt = blockIdx.y;
  const int k0 = kt * kB;
  const size_t off = bh * S * D;
  const int hr = warp * 16 + rg;  // this thread's key rows: hr + 4i
  float* myP = sP + warp * 16 * LDP;
  float* mydS = sdS + warp * 16 * LDP;

  const int n_tiles = (S + NC - 1) / NC;
  const int first = causal ? k0 / NC : 0;

  // Q, dO and the NC LSE and delta values of query tile qt into buffer b
  auto stage_q = [&](int b, int qt) {
    const int q0 = qt * NC;
    stage_f32<D>(sQ + b * NC * LD, q + off, q0, NC, S, vec);
    stage_f32<D>(sdO + b * NC * LD, dout + off, q0, NC, S, vec);
    if (tid < 2 * NC) {
      const float* src = tid < NC ? lse : delta;
      const int r = tid % NC;
      const bool ok = q0 + r < S;
      cp_async4((tid < NC ? sL : sD) + b * NC + r,
                ok ? src + bh * S + q0 + r : src, ok ? 4 : 0);
    }
  };

  stage_f32<D>(sK, k + off, k0, kB, S, vec);
  stage_f32<D>(sV, v + off, k0, kB, S, vec);
  stage_q(0, first);
  cp_async_commit();

  float acc_k[4][D / 8], acc_v[4][D / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 8; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int qt = first; qt < n_tiles; ++qt) {
    const int it = qt - first;
    cp_async_wait_all();
    __syncthreads();  // tile qt is staged; every warp is past tile qt - 1
    if (qt + 1 < n_tiles) {  // into the buffers tile qt - 1 used
      stage_q((it + 1) & 1, qt + 1);
      cp_async_commit();
    }
    const int b = it & 1;
    const float* cQ = sQ + b * NC * LD;
    const float* cdO = sdO + b * NC * LD;
    const float* cL = sL + b * NC;
    const float* cD = sD + b * NC;

    // P^T = exp(S^T scale - LSE[col]) into the warp's tile; masked (the
    // causal diagonal and a ragged last query tile) P^T is 0
    float s[4][NJ];
    f_abt<D, NJ>(s, sK + hr * LD, cQ + cg * LD);
    const int q0 = qt * NC;
    const bool masked = q0 + NC > S || (causal && q0 < k0 + kB - 1);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float l2 = cL[cg + 8 * j] * kLog2e;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = exp2f(fmaf(s[i][j], scale_log2, -l2));
        if (masked) {
          const int col = q0 + cg + 8 * j, row = k0 + hr + 4 * i;
          if (col >= S || (causal && col < row)) p = 0.f;
        }
        s[i][j] = p;
        myP[(rg + 4 * i) * LDP + cg + 8 * j] = p;
      }
    }

    // dS^T = P^T (dP^T - delta[col]) into the warp's other tile
    float dp[4][NJ];
    f_abt<D, NJ>(dp, sV + hr * LD, cdO + cg * LD);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float d = cD[cg + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mydS[(rg + 4 * i) * LDP + cg + 8 * j] = s[i][j] * (dp[i][j] - d);
    }
    __syncwarp();
    f_ab<D, NC>(acc_v, myP + rg * LDP, cdO + 4 * cg);
    f_ab<D, NC>(acc_k, mydS + rg * LDP, cQ + 4 * cg);
  }

  store_f32<D>(dk + off, acc_k, k0 + hr, cg, S, scale, vec);
  store_f32<D>(dv + off, acc_v, k0 + hr, cg, S, 1.f, vec);
}

bool aligned16(const void* a, const void* b, const void* c, const void* d) {
  return (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
          reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d)) %
             16 ==
         0;
}

template <int D>
int launch_dq_f32(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dq, int BH, int S, float scale, int causal,
                  cudaStream_t stream) {
  const int bytes = dq_f32_smem_bytes<D>();
  // above 48 KB a block must opt in to dynamic shared memory; two blocks
  // an SM need the largest shared-memory carveout
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_f32_kernel<D>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(BH, (S + kB - 1) / kB);
  flash_bwd_dq_f32_kernel<D><<<grid, kFThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dq), S, scale, scale * kLog2e, causal,
      aligned16(q, k, v, dout) && aligned16(dq, dq, dq, dq));
  return 0;
}

template <int D>
int launch_dkv_f32(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dk, void* dv, int BH, int S, float scale, int causal,
                   cudaStream_t stream) {
  const int bytes = dkv_f32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_f32_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dkv_f32_kernel<D>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(BH, (S + kB - 1) / kB);
  flash_bwd_dkv_f32_kernel<D><<<grid, kFThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dk), static_cast<float*>(dv), S, scale,
      scale * kLog2e, causal,
      aligned16(q, k, v, dout) && aligned16(dk, dv, dk, dv));
  return 0;
}

// blocks an SM of one f32 kernel (K2 or K3) at its shared memory, or -1
template <int D>
int f32_blocks_per_sm(bool dkv) {
  int n = -1;
  cudaError_t err =
      dkv ? cudaFuncSetAttribute(flash_bwd_dkv_f32_kernel<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 dkv_f32_smem_bytes<D>())
          : cudaFuncSetAttribute(flash_bwd_dq_f32_kernel<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 dq_f32_smem_bytes<D>());
  if (err != cudaSuccess) return -1;
  err = dkv ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  &n, flash_bwd_dkv_f32_kernel<D>, kFThreads,
                  dkv_f32_smem_bytes<D>())
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  &n, flash_bwd_dq_f32_kernel<D>, kFThreads,
                  dq_f32_smem_bytes<D>());
  return err == cudaSuccess ? n : -1;
}

template <int D>
int launch_dq_mma(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dq, int BH, int S, float scale, int causal,
                  cudaStream_t stream) {
  const int bytes = mma_smem_bytes<D>(false);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(BH, (S + kB - 1) / kB);
  flash_bwd_dq_mma_kernel<D><<<grid, kMThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dq), S, scale, scale * kLog2e, causal,
      aligned16(q, k, v, dout));
  return 0;
}

template <int D>
int launch_dkv_mma(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dk, void* dv, int BH, int S, float scale, int causal,
                   cudaStream_t stream) {
  const int bytes = mma_smem_bytes<D>(true);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_mma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(BH, (S + kB - 1) / kB);
  flash_bwd_dkv_mma_kernel<D><<<grid, kMThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, scale,
      scale * kLog2e, causal, aligned16(q, k, v, dout));
  return 0;
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 on success). dtype:
// 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores). They launch on
// `stream`, do not synchronise and allocate nothing.
extern "C" int flash_attention_backward_dq(const void* q, const void* k,
                                           const void* v, const void* dout,
                                           const void* lse, const void* delta,
                                           void* dq, int BH, int S, int D,
                                           float scale, int causal, int dtype,
                                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
  int bad = (int)cudaErrorInvalidValue;
  if (dtype == 0 && D == 64)
    bad = launch_dq_f32<64>(q, k, v, dout, l, d, dq, BH, S, scale, causal,
                            st);
  else if (dtype == 0 && D == 128)
    bad = launch_dq_f32<128>(q, k, v, dout, l, d, dq, BH, S, scale, causal,
                             st);
  else if (dtype == 1 && D == 64)
    bad = launch_dq_mma<64>(q, k, v, dout, l, d, dq, BH, S, scale, causal,
                            st);
  else if (dtype == 1 && D == 128)
    bad = launch_dq_mma<128>(q, k, v, dout, l, d, dq, BH, S, scale, causal,
                             st);
  if (bad) return bad;
  return (int)cudaGetLastError();
}

extern "C" int flash_attention_backward_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int BH, int S,
    int D, float scale, int causal, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
  int bad = (int)cudaErrorInvalidValue;
  if (dtype == 0 && D == 64)
    bad = launch_dkv_f32<64>(q, k, v, dout, l, d, dk, dv, BH, S, scale,
                             causal, st);
  else if (dtype == 0 && D == 128)
    bad = launch_dkv_f32<128>(q, k, v, dout, l, d, dk, dv, BH, S, scale,
                              causal, st);
  else if (dtype == 1 && D == 64)
    bad = launch_dkv_mma<64>(q, k, v, dout, l, d, dk, dv, BH, S, scale,
                             causal, st);
  else if (dtype == 1 && D == 128)
    bad = launch_dkv_mma<128>(q, k, v, dout, l, d, dk, dv, BH, S, scale,
                              causal, st);
  if (bad) return bad;
  return (int)cudaGetLastError();
}

// Blocks an SM of the f32 K2 (dkv = 0) or K3 (dkv = 1) at head_dim D, from
// their registers and shared memory; -1 on a bad D or a CUDA error.
extern "C" int flash_attention_backward_f32_blocks_per_sm(int D, int dkv) {
  if (D == 64) return f32_blocks_per_sm<64>(dkv != 0);
  if (D == 128) return f32_blocks_per_sm<128>(dkv != 0);
  return -1;
}
