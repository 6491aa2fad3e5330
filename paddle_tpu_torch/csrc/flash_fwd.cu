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
// f32 (flash_fwd_kernel, a simple first kernel; wgmma, TMA and warp
// specialisation come later):
//   * one thread block of 256 threads per (64-row query tile, b*h); K/V
//     stream through shared memory 64 rows at a time, so nothing of size
//     S x S ever exists, and the softmax state (m, l, acc) stays in
//     registers in f32;
//   * each thread computes a 4 x 4 register tile of scores and a 4 x D/16
//     tile of the output, so every shared-memory load feeds 2 (scores) or
//     4+ (P*V) FMAs; Q and K rows are padded by one float so the 16
//     threads of a row group read 16 different banks;
//   * row max and row sum are 16-lane shuffles (a row's 16 threads sit in
//     one half-warp);
//   * causal: key tiles entirely in a query tile's future are not visited,
//     as the TPU kernel skipped them; masked scores get -1e30 as there;
//   * ragged S: rows past S load as zeros and are masked like the future,
//     so any S works, not only multiples of the tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;        // query rows per block
constexpr int kBN = 64;        // key rows per tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kPP = kBN + 1;   // padded P row

template <int D>
constexpr int smem_floats() {
  return kBM * (D + 1) + kBN * (D + 1) + kBN * D + kBM * kPP;
}

// rows [row0, row0 + 64) of a [S, D] matrix into shared memory with row
// stride `ld`; rows past S are zero
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* __restrict__ src,
                                          int row0, int S) {
  for (int idx = threadIdx.x; idx < kBN * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int g = row0 + r;
    dst[r * ld + c] = g < S ? src[(size_t)g * D + c] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int S, float scale,
                     int causal) {
  constexpr int LQ = D + 1;  // padded Q/K row
  constexpr int C = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBM * LQ;
  float* sV = sK + kBN * LQ;
  float* sP = sV + kBN * D;

  const int qt = blockIdx.x;
  const size_t bh = blockIdx.y;
  const int q0 = qt * kBM;
  const float* qb = q + bh * S * D;
  const float* kb = k + bh * S * D;
  const float* vb = v + bh * S * D;

  const int tx = threadIdx.x & 15;  // key / output-column group
  const int ty = threadIdx.x >> 4;  // query-row group: rows ty*4 .. ty*4+3

  load_tile<D>(sQ, LQ, qb, q0, S);

  float m[4], l[4], acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -1e30f;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  const int n_tiles = (S + kBN - 1) / kBN;
  const int last = causal ? min(n_tiles - 1, qt) : n_tiles - 1;
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kBN;
    __syncthreads();  // previous tile's readers are done with sK/sV/sP
    load_tile<D>(sK, LQ, kb, k0, S);
    load_tile<D>(sV, D, vb, k0, S);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * LQ + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * LQ + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float rmax = -1e30f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (kpos >= S || (causal && kpos > qpos)) x = -1e30f;
        s[i][j] = x;
        rmax = fmaxf(rmax, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rsum += p;
        sP[(ty * 4 + i) * kPP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBN; ++j) {
      float pv[4], vv[C];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * kPP + j];
#pragma unroll
      for (int c = 0; c < C; ++c) vv[c] = sV[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= S) continue;
    const float inv = 1.f / l[i];
    float* orow = o + (bh * S + qpos) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) orow[tx + 16 * c] = acc[i][c] * inv;
    if (tx == 0) lse[bh * S + qpos] = m[i] + logf(l[i]);
  }
}

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

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int BH, int S, float scale, int causal, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * (int)sizeof(float);
  // above 48 KB a block must opt in to dynamic shared memory
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kBM - 1) / kBM, BH);
  flash_fwd_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, scale,
      causal);
  return 0;
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
  if (dtype == 0 && D == 64)
    bad = launch<64>(q, k, v, o, lp, BH, S, scale, causal, st);
  else if (dtype == 0 && D == 128)
    bad = launch<128>(q, k, v, o, lp, BH, S, scale, causal, st);
  else if (dtype == 1 && D == 64)
    bad = launch_mma<64>(q, k, v, o, lp, BH, S, scale, causal, st);
  else if (dtype == 1 && D == 128)
    bad = launch_mma<128>(q, k, v, o, lp, BH, S, scale, causal, st);
  if (bad) return bad;
  return (int)cudaGetLastError();
}
