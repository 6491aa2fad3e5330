// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: paddle_tpu/ops/attention.py::_flash_fwd_kernel (the Pallas TPU
// kernel launched by _pallas_flash_fwd_32). Computes, per (batch, head),
// O = softmax(Q K^T * scale [causal mask]) V with an online softmax, and
// LSE = m + log(l) for the backward pass.
//
//   q, k, v  [B, H, S, D]   f32 or bf16, contiguous, D in {64, 128}
//   o        [B, H, S, D]   q's dtype
//   lse      [B, H, 1, S]   f32
//
// What bounds it on this card: operations. Attention does 4*S*S*D flops
// (half that causal) on 4*S*D elements of traffic, hundreds of flops per
// byte at S = 1024: the tensor cores' rate in bf16 (989 TFLOP/s), the
// CUDA cores' in f32 (67 TFLOP/s; TF32 is off by contract).
//
// bf16 (flash_fwd_mma_kernel): the Pallas kernel's arithmetic on the
// tensor cores, FA2's layout on mma.sync.m16n8k16 (bf16 in, f32 sum):
//   * a block of 4 warps owns 64 query rows, 16 a warp; its Q fragments
//     are loaded once into registers through ldmatrix (D/16 A fragments);
//   * K and V stream through shared memory in 64-row bf16 tiles (rows
//     padded by 16 bytes, so the 8 rows an ldmatrix reads fall in 8
//     distinct bank groups), double-buffered by cp.async: the next tile
//     loads while this one computes, one barrier a tile;
//   * S = Q K^T (16 x 64 a warp, 32 f32 a thread) stays in registers; the
//     scale is folded with log2(e) so every exp is one exp2f; the row
//     max and row sum are shuffles within the quad of lanes that share a
//     row, and every thread owns two rows' (m, l) in f32;
//   * P = exp(S - m) goes from the accumulator layout straight into the
//     A-operand layout of P V (two n8 tiles of S are one k16 fragment),
//     rounded to bf16 as the Pallas kernel rounds it (attention.py:105);
//     l sums the unrounded P in f32, as there; V comes in through
//     ldmatrix.trans. O (16 x D, D/2 f32 a thread) is rounded once;
//   * causal: key tiles wholly in the future are skipped, only the
//     diagonal tile (and a ragged last tile) is masked, and the grid runs
//     the longest query tiles first (blockIdx.y counts them down) so the
//     short ones fill the tail;
//   * ragged S: rows past S load as zeros (cp.async with a source size of
//     0) and are masked like the future; rows past S are never written.
//     q, k or v not 16-byte aligned stage element by element instead.
//
// f32 (flash_fwd_f32_kernel) on the CUDA cores, the layout of the f32 K2
// (flash_bwd.cu, flash_bwd_dq_f32_kernel) with the online softmax:
//   * a block of 4 warps holds 64 query rows of Q in shared memory, 16 a
//     warp, and streams K and V in tiles of 64 keys at D = 64, 32 at
//     D = 128, by 16-byte cp.async into a second buffer: the next tile
//     loads while this one computes, one barrier a tile. q, k, v or o not
//     16-byte aligned stage (and store) element by element in the same
//     kernel;
//   * a lane (row group rg = lane / 8, column group cg = lane % 8) owns the
//     warp's rows rg + 4i, i < 4: S for the keys cg + 8j, O for the columns
//     4 cg + 32 m. The running (m, l) of a row sit in its 8 lanes (three
//     shuffles for a row max or sum). P goes through a tile private to the
//     warp, so a __syncwarp, not a block barrier, separates writing and
//     reading it;
//   * the scale is folded with log2(e), so every exp is one exp2f of the
//     running max's difference; LSE goes back to natural log at the end;
//   * every shared-memory read is a float4 (LDS.128). FMAs per word a lane
//     reads, over 4 steps of the contraction:
//       S = Q K^T  D = 64: KS = 1 128 per 48 (2.7), KS = 2 64 per 32 (2),
//                  KS = 4 32 per 24 (1.3); D = 128: KS = 1 64 per 32 (2),
//                  KS = 2 32 per 24 (1.3)
//       O += P V   D = 64: 128 per 48 (2.7); D = 128: 256 per 80 (3.2)
//     A lane needs 4 for its loads to keep pace with its FMAs, so the
//     loads, not the FMA units, set the products' rate (as in K2/K3);
//   * short grids: while the 64-row blocks make fewer than 2.5 waves of
//     the SMs, a block takes 64 / KS rows and KS = 2 or 4 warps share each
//     16 rows, each taking one slice of NT / KS keys of every tile with its
//     own (m, l, acc); the slices merge in warp order at the end, so the
//     bits do not depend on scheduling. At [1,12,661,64] the 64-row grid is
//     132 blocks, one an SM, and its longest block walks all 661 keys
//     alone; 16-row blocks give 504 blocks whose longest walk is a quarter
//     of that work a warp (f32_key_split picks KS from the shape);
//   * causal: key tiles wholly in the future are skipped, only a tile that
//     crosses the diagonal (or S) is masked, by each element's own row and
//     column, with -1e30 as in the Pallas kernel; the grid runs the longest
//     query tiles first;
//   * shared memory a block (f32_smem_bytes): 105,472 / 88,576 / 80,128 B
//     at D = 64 and KS = 1 / 2 / 4, 111,616 / 90,624 B at D = 128 and
//     KS = 1 / 2: two blocks an SM at either width.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;        // query rows per block
constexpr int kBN = 64;        // key rows per tile

// ---- bf16 on the tensor cores ----------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kMThreads = 128;  // 4 warps, 16 query rows each
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
constexpr int mma_smem_bytes() {  // Q, then K and V double-buffered
  return (kBM + 4 * kBN) * (D + 8) * 2;
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

// One block per (b*h = blockIdx.x, 64-row query tile nq - 1 - blockIdx.y).
// scale_log2 = scale * log2(e): m and S are kept in log2 units, so P =
// exp2(S - m) = exp(S_nat - m_nat). `vec`: q, k, v are 16-byte aligned.
template <int D>
__global__ void __launch_bounds__(kMThreads)
    flash_fwd_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         float* __restrict__ lse, int S, float scale_log2,
                         int causal, int vec) {
  constexpr int LD = D + 8;  // bf16 row stride of a staged tile
  constexpr int KD = D / 16;  // k16 steps of S = Q K^T
  constexpr int ND = D / 8;   // n8 tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [kBM][LD]
  bf16* sK = sQ + kBM * LD;                      // [2][kBN][LD]
  bf16* sV = sK + 2 * kBN * LD;                  // [2][kBN][LD]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const size_t bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // the longest tiles first
  const int q0 = qt * kBM;
  const bf16* qb = q + bh * S * D;
  const bf16* kb = k + bh * S * D;
  const bf16* vb = v + bh * S * D;

  // 64 rows from r0 of a [S, D] matrix into dst (row stride LD); rows past
  // S zero
  auto stage = [&](bf16* dst, const bf16* src, int r0) {
    if (vec) {
      for (int idx = tid; idx < kBN * (D / 8); idx += kMThreads) {
        const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
        const bool ok = r0 + r < S;
        cp_async16(dst + r * LD + c, ok ? src + (size_t)(r0 + r) * D + c : src,
                   ok ? 16 : 0);
      }
    } else {
      for (int idx = tid; idx < kBN * D; idx += kMThreads) {
        const int r = idx / D, c = idx % D;
        dst[r * LD + c] = r0 + r < S ? src[(size_t)(r0 + r) * D + c]
                                     : __float2bfloat16(0.f);
      }
    }
  };

  // ldmatrix row addresses of this lane: an A operand (rows m, contiguous
  // k); S's B operand (rows n, contiguous k, the matrices in the other
  // order); P V's B operand through .trans (rows k, contiguous n) takes
  // the A offsets
  const int lr = lane & 7, lm = lane >> 3;
  const int a_row = lr + (lm & 1) * 8, a_col = (lm >> 1) * 8;
  const int b_row = lr + (lm >> 1) * 8, b_col = (lm & 1) * 8;
  const int gq = lane >> 2, tq = lane & 3;  // accumulator row, column pair
  const int row0 = q0 + warp * 16 + gq;     // this thread's rows: row0, +8

  const int n_tiles = (S + kBN - 1) / kBN;
  const int last = causal ? min(n_tiles - 1, qt) : n_tiles - 1;

  stage(sQ, qb, q0);
  stage(sK, kb, 0);
  stage(sV, vb, 0);
  cp_async_commit();

  uint32_t qf[KD][4];
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  float oacc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;

  for (int kt = 0; kt <= last; ++kt) {
    cp_async_wait_all();
    __syncthreads();  // tile kt is staged; every warp is past tile kt - 1
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldsm_x4(qf[kk], sQ + (warp * 16 + a_row) * LD + kk * 16 + a_col);
    }
    if (kt < last) {  // into the buffers tile kt - 1 used
      const int nb = (kt + 1) & 1;
      stage(sK + nb * kBN * LD, kb, (kt + 1) * kBN);
      stage(sV + nb * kBN * LD, vb, (kt + 1) * kBN);
      cp_async_commit();
    }
    const bf16* cK = sK + (kt & 1) * kBN * LD;
    const bf16* cV = sV + (kt & 1) * kBN * LD;

    // S [16 x 64] of this warp: 8 n8 tiles
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        uint32_t bfr[4];
        ldsm_x4(bfr, cK + (nb * 16 + b_row) * LD + kk * 16 + b_col);
        mma_bf16(s[2 * nb], qf[kk], bfr[0], bfr[1]);
        mma_bf16(s[2 * nb + 1], qf[kk], bfr[2], bfr[3]);
      }
    }

    // scale, mask (the causal diagonal and a ragged last tile only), row
    // max over the quad
    const int k0 = kt * kBN;
    const bool masked = k0 + kBN > S || (causal && kt == qt);
    float mx[2] = {-1e30f, -1e30f};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (masked) {
          const int col = k0 + n * 8 + 2 * tq + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          if (col >= S || (causal && col > row)) x = -1e30f;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
    }
    // P in f32 for l; bf16 for P V (the Pallas kernel's p.astype(v.dtype))
    uint32_t pf[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(s[n][e] - m[e >> 1]);
        sum[e >> 1] += p[e];
      }
      // n8 tiles 2j and 2j + 1 are the k16 A fragment j
      pf[n >> 1][(n & 1) * 2] = pack_bf16(p[0], p[1]);
      pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = alpha[h] * l[h] + sum[h];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      oacc[n][0] *= alpha[0];
      oacc[n][1] *= alpha[0];
      oacc[n][2] *= alpha[1];
      oacc[n][3] *= alpha[1];
    }

    // O [16 x D] += P [16 x 64] V [64 x D]
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int nd = 0; nd < ND / 2; ++nd) {
        uint32_t bfr[4];
        ldsm_x4_t(bfr, cV + (j * 16 + a_row) * LD + nd * 16 + a_col);
        mma_bf16(oacc[2 * nd], pf[j], bfr[0], bfr[1]);
        mma_bf16(oacc[2 * nd + 1], pf[j], bfr[2], bfr[3]);
      }
    }
  }

  // O = acc / l, rounded once; LSE in natural log
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + h * 8;
    if (row >= S) continue;
    const float inv = 1.f / l[h];
    bf16* orow = o + (bh * S + row) * D + 2 * tq;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) = __floats2bfloat162_rn(
          oacc[n][2 * h] * inv, oacc[n][2 * h + 1] * inv);
    if (tq == 0) lse[bh * S + row] = m[h] * kLn2 + logf(l[h]);
  }
}

// ---- f32 on the CUDA cores -------------------------------------------------

constexpr int kFThreads = 128;  // 4 warps of 16 query rows each

// keys of a staged K/V tile: 64 at D = 64, 32 at D = 128, so that two
// blocks fit an SM at either width
template <int D>
__host__ __device__ constexpr int f_nt() {
  return D == 64 ? 64 : 32;
}

// row stride of a staged tile in floats (D + 4: consecutive rows start in
// consecutive 16-byte bank groups)
template <int D>
__host__ __device__ constexpr int f_ld() {
  return D + 4;
}

// row stride of a warp's P tile: its NT / KS keys + 8 (a lane group's
// scalar stores hit 32 banks, its float4 loads distinct groups)
template <int D, int KS>
__host__ __device__ constexpr int f_ldp() {
  return f_nt<D>() / KS + 8;
}

// Q (64 / KS rows), K and V double-buffered, a P tile a warp
template <int D, int KS>
constexpr int f32_smem_bytes() {
  return ((64 / KS) * f_ld<D>() + 4 * f_nt<D>() * f_ld<D>() +
          4 * 16 * f_ldp<D, KS>()) *
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

// acc[i][j] = sum over D of A[4i][c] B[8j][c]: A this thread's 4 query rows
// (stride 4 rows), B its NJ keys (stride 8 rows), both read as float4
// along the contraction
template <int D, int NJ>
__device__ __forceinline__ void f_abt(float acc[4][NJ], const float* A,
                                      const float* B) {
  constexpr int LD = f_ld<D>();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
#pragma unroll (D == 64 ? 4 : 2)
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

// out[i][4m + e] += sum over NT keys of P[4i][t] V[t][32m + e]: P this
// thread's 4 rows of its warp's tile (row stride NT + 8), V a staged tile
// from this thread's first column; P as float4 along the keys, V as float4
// across the output
template <int D, int NT>
__device__ __forceinline__ void f_pv(float out[4][D / 8], const float* P,
                                     const float* V) {
  constexpr int LD = f_ld<D>(), LDP = NT + 8, M = D / 32;
#pragma unroll
  for (int t = 0; t < NT; t += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(P + i * 4 * LDP + t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float4 b[M];
#pragma unroll
      for (int m = 0; m < M; ++m)
        b[m] = *reinterpret_cast<const float4*>(V + (t + e) * LD + 32 * m);
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

// One block per (b*h = blockIdx.x, query tile nq - 1 - blockIdx.y) of
// 64 / KS rows; KS warps share each 16 rows and split every key tile into
// KS slices of NT / KS keys, each slice with its own (m, l, acc), merged in
// warp order at the end. scale_log2 = scale * log2(e): m and S are kept in
// log2 units. `vec`: q, k, v and o are 16-byte aligned.
template <int D, int KS>
__global__ void __launch_bounds__(kFThreads)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int S, float scale_log2,
                         int causal, int vec) {
  constexpr int LD = f_ld<D>(), NT = f_nt<D>(), BM = 64 / KS;
  constexpr int CW = NT / KS, NJ = CW / 8, LDP = f_ldp<D, KS>();
  extern __shared__ __align__(16) float fsm[];
  float* sQ = fsm;               // [BM][LD]
  float* sK = sQ + BM * LD;      // [2][NT][LD]
  float* sV = sK + 2 * NT * LD;  // [2][NT][LD]
  float* sP = sV + 2 * NT * LD;  // [4 warps][16][LDP]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int rg = lane >> 3, cg = lane & 7;
  const int kw = warp % KS;  // this warp's key slice of each tile
  const size_t bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // the longest tiles first
  const int q0 = qt * BM;
  const size_t off = bh * S * D;
  const int hr = (warp / KS) * 16 + rg;  // this thread's query rows: hr + 4i
  float* myP = sP + warp * 16 * LDP;

  const int n_tiles = (S + NT - 1) / NT;
  const int last =
      causal ? min(n_tiles - 1, (q0 + BM - 1) / NT) : n_tiles - 1;

  stage_f32<D>(sQ, q + off, q0, BM, S, vec);
  stage_f32<D>(sK, k + off, 0, NT, S, vec);
  stage_f32<D>(sV, v + off, 0, NT, S, vec);
  cp_async_commit();

  float m[4], l[4], acc[4][D / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -1e30f;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt <= last; ++kt) {
    cp_async_wait_all();
    __syncthreads();  // tile kt is staged; every warp is past tile kt - 1
    if (kt < last) {  // into the buffers tile kt - 1 used
      const int nb = (kt + 1) & 1;
      stage_f32<D>(sK + nb * NT * LD, k + off, (kt + 1) * NT, NT, S, vec);
      stage_f32<D>(sV + nb * NT * LD, v + off, (kt + 1) * NT, NT, S, vec);
      cp_async_commit();
    }
    const float* cK = sK + ((kt & 1) * NT + kw * CW) * LD;
    const float* cV = sV + ((kt & 1) * NT + kw * CW) * LD;

    float s[4][NJ];
    f_abt<D, NJ>(s, sQ + hr * LD, cK + cg * LD);

    // scale, mask (only a tile that crosses the diagonal or S), online
    // softmax over the 8 lanes of a row, P into the warp's tile
    const int k0 = kt * NT + kw * CW;
    const bool masked = kt * NT + NT > S || (causal && kt * NT + NT - 1 > q0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -1e30f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float x = s[i][j] * scale_log2;
        if (masked) {
          const int col = k0 + cg + 8 * j, row = q0 + hr + 4 * i;
          if (col >= S || (causal && col > row)) x = -1e30f;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int sh = 1; sh < 8; sh <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        sum += p;
        myP[(rg + 4 * i) * LDP + cg + 8 * j] = p;
      }
#pragma unroll
      for (int sh = 1; sh < 8; sh <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, sh);
      l[i] = alpha * l[i] + sum;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();
    f_pv<D, CW>(acc, myP + rg * LDP, cV + 4 * cg);
  }

  // every warp's (m, l, acc) into the K/V buffers (no copy is in flight
  // after the last tile), then the block merges each row's KS slices in
  // warp order: O = sum acc 2^(m - M) / L, L = sum l 2^(m - M), LSE in
  // natural log. A slice that saw only masked keys has m = -1e30 and
  // weight 0; with KS = 1 the weight is 1 and O = acc / l
  __syncthreads();
  float* sO = sK;            // [4 warps x 16 rows][LD]
  float* sM = sO + 64 * LD;  // [64]
  float* sL = sM + 64;       // [64]
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = warp * 16 + rg + 4 * i;
    if (cg == 0) {
      sM[r] = m[i];
      sL[r] = l[i];
    }
#pragma unroll
    for (int c = 0; c < D / 32; ++c)
      *reinterpret_cast<float4*>(sO + r * LD + 4 * cg + 32 * c) =
          make_float4(acc[i][4 * c], acc[i][4 * c + 1], acc[i][4 * c + 2],
                      acc[i][4 * c + 3]);
  }
  __syncthreads();
  for (int idx = tid; idx < BM * (D / 4); idx += kFThreads) {
    const int r = idx / (D / 4), c = (idx % (D / 4)) * 4;
    const int row = q0 + r;
    if (row >= S) continue;
    const int g0 = (r / 16) * KS * 16 + r % 16;  // the row in warp slice 0
    float mx = -1e30f;
#pragma unroll
    for (int w = 0; w < KS; ++w) mx = fmaxf(mx, sM[g0 + 16 * w]);
    float sum = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < KS; ++w) {
      const int g = g0 + 16 * w;
      const float f = exp2f(sM[g] - mx);
      const float4 x = *reinterpret_cast<const float4*>(sO + g * LD + c);
      sum = fmaf(sL[g], f, sum);
      a.x = fmaf(x.x, f, a.x);
      a.y = fmaf(x.y, f, a.y);
      a.z = fmaf(x.z, f, a.z);
      a.w = fmaf(x.w, f, a.w);
    }
    const float inv = 1.f / sum;
    float* out = o + off + (size_t)row * D + c;
    if (vec) {
      *reinterpret_cast<float4*>(out) =
          make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv);
    } else {
      out[0] = a.x * inv;
      out[1] = a.y * inv;
      out[2] = a.z * inv;
      out[3] = a.w * inv;
    }
    if (c == 0) lse[bh * S + row] = mx * kLn2 + logf(sum);
  }
}

bool aligned16(const void* a, const void* b, const void* c, const void* d) {
  return (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
          reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d)) %
             16 ==
         0;
}

// above 48 KB a block must opt in to dynamic shared memory; two blocks an
// SM need the largest shared-memory carveout
template <int D, int KS>
cudaError_t f32_attributes() {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D, KS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, f32_smem_bytes<D, KS>());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_fwd_f32_kernel<D, KS>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

template <int D, int KS>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int BH, int S, float scale, int causal,
               cudaStream_t stream) {
  const cudaError_t err = f32_attributes<D, KS>();
  if (err != cudaSuccess) return (int)err;
  dim3 grid(BH, (S + 64 / KS - 1) / (64 / KS));
  flash_fwd_f32_kernel<D, KS>
      <<<grid, kFThreads, f32_smem_bytes<D, KS>(), stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<float*>(o), lse, S,
          scale * kLog2e, causal, aligned16(q, k, v, o));
  return 0;
}

// blocks an SM of flash_fwd_f32_kernel<D, KS> at its shared memory, or -1
template <int D, int KS>
int f32_blocks_per_sm() {
  int n = -1;
  if (f32_attributes<D, KS>() != cudaSuccess) return -1;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &n, flash_fwd_f32_kernel<D, KS>, kFThreads,
             f32_smem_bytes<D, KS>()) == cudaSuccess
             ? n
             : -1;
}

// KS, the warps that share each 16 query rows, from the waves W the
// 64-row blocks make over the card's SMs: KS = 1 (64-row blocks) from
// W = 2.5 up, 2 (32-row blocks) above W = 1, else 4 (16-row blocks; 2 at
// D = 128). Fewer rows a block cut the longest block's serial walk over
// the keys, and more warps share the SMs; on long grids they only read K
// and V more often (tools/sweep_flash_f32_split.py, H100 80GB HBM3 at
// 700 W: at [1,12,661,64], W = 1.00, KS = 4 took 0.0439 ms against
// 0.0768 with KS = 1; at [2,12,1024,64], W = 2.91, KS = 1 took 0.1279
// against 0.1398 with KS = 2)
int f32_key_split(int BH, int S, int D) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  const long blocks64 = (long)BH * ((S + 63) / 64);
  if (2 * blocks64 >= 5L * sms) return 1;
  if (D == 128 || blocks64 > sms) return 2;
  return 4;
}

int launch_f32_split(const void* q, const void* k, const void* v, void* o,
                     float* lse, int BH, int S, int D, float scale,
                     int causal, int ks, cudaStream_t stream) {
  if (D == 64 && ks == 1)
    return launch_f32<64, 1>(q, k, v, o, lse, BH, S, scale, causal, stream);
  if (D == 64 && ks == 2)
    return launch_f32<64, 2>(q, k, v, o, lse, BH, S, scale, causal, stream);
  if (D == 64 && ks == 4)
    return launch_f32<64, 4>(q, k, v, o, lse, BH, S, scale, causal, stream);
  if (D == 128 && ks == 1)
    return launch_f32<128, 1>(q, k, v, o, lse, BH, S, scale, causal, stream);
  if (D == 128 && ks == 2)
    return launch_f32<128, 2>(q, k, v, o, lse, BH, S, scale, causal, stream);
  return (int)cudaErrorInvalidValue;
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               float* lse, int BH, int S, float scale, int causal,
               cudaStream_t stream) {
  const int bytes = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const int vec = reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v) % 16 == 0;
  dim3 grid(BH, (S + kBM - 1) / kBM);
  flash_fwd_mma_kernel<D><<<grid, kMThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, S,
      scale * kLog2e, causal, vec);
  return 0;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). dtype: 0 =
// float32 (CUDA cores), 1 = bfloat16 (tensor cores). Launches on `stream`,
// does not synchronise and allocates nothing.
extern "C" int flash_attention_forward(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int BH, int S, int D, float scale,
                                       int causal, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lp = static_cast<float*>(lse);
  int bad = (int)cudaErrorInvalidValue;
  if (dtype == 0 && (D == 64 || D == 128))
    bad = launch_f32_split(q, k, v, o, lp, BH, S, D, scale, causal,
                           f32_key_split(BH, S, D), st);
  else if (dtype == 1 && D == 64)
    bad = launch_mma<64>(q, k, v, o, lp, BH, S, scale, causal, st);
  else if (dtype == 1 && D == 128)
    bad = launch_mma<128>(q, k, v, o, lp, BH, S, scale, causal, st);
  if (bad) return bad;
  return (int)cudaGetLastError();
}

// The f32 kernel with KS warps on each 16 query rows (D = 64: 1, 2 or 4;
// D = 128: 1 or 2) whatever the shape, for timing the choices; otherwise
// as flash_attention_forward with dtype 0.
extern "C" int flash_attention_forward_f32_split(
    const void* q, const void* k, const void* v, void* o, void* lse, int BH,
    int S, int D, float scale, int causal, int ks, void* stream) {
  const int bad =
      launch_f32_split(q, k, v, o, static_cast<float*>(lse), BH, S, D, scale,
                       causal, ks, static_cast<cudaStream_t>(stream));
  if (bad) return bad;
  return (int)cudaGetLastError();
}

// The KS flash_attention_forward takes for f32 at this shape.
extern "C" int flash_attention_forward_f32_key_split(int BH, int S, int D) {
  return f32_key_split(BH, S, D);
}

// Blocks an SM of the f32 kernel at head_dim D with KS warps on each 16
// query rows, from its registers and shared memory; -1 on a bad D or KS or
// a CUDA error.
extern "C" int flash_attention_forward_f32_blocks_per_sm(int D, int ks) {
  if (D == 64 && ks == 1) return f32_blocks_per_sm<64, 1>();
  if (D == 64 && ks == 2) return f32_blocks_per_sm<64, 2>();
  if (D == 64 && ks == 4) return f32_blocks_per_sm<64, 4>();
  if (D == 128 && ks == 1) return f32_blocks_per_sm<128, 1>();
  if (D == 128 && ks == 2) return f32_blocks_per_sm<128, 2>();
  return -1;
}
