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
// dK), hundreds of flops per byte at S = 1024; in f32 without TF32 they run
// on the FP32 CUDA cores (67 TFLOP/s).
//
// What the design does about it (a simple first kernel; tensor cores,
// wgmma and one fused kernel with an atomic dQ come later):
//   * both kernels recompute S and P from LSE tile by tile, so nothing of
//     size S x S exists; all sums are f32 in registers;
//   * each of the 256 threads computes a 4 x 4 register tile of S and of dP
//     (rows ty*4.., columns tx + 16j), the layout of the forward kernel, so
//     every shared-memory load feeds 2 FMAs; rows of Q, K, V and dO are
//     padded by one float so a row group's 16 threads read 16 banks;
//   * the accumulated gradient is a 4 x D/16 register tile per thread
//     (4 rows, columns tx + 16c); P and dS go through shared memory to
//     change hands between the two layouts;
//   * causal: tiles wholly in the future are not visited (K2: key tiles
//     past the query tile; K3: query tiles before the key tile), as the TPU
//     kernels skipped qi < ki; on the diagonal tiles every element is
//     masked;
//   * ragged S: rows past S load as zeros and get P = dS = 0 exactly, so
//     they add nothing and are never written;
//   * bf16 inputs are widened to f32 on the way into shared memory; P and
//     dS stay f32 (the TPU kernels rounded them to bf16 for the MXU) and
//     the gradients are rounded once at the end.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kB = 64;         // rows of a query or key tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kPP = kB + 1;    // padded row of a P or dS tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// rows [row0, row0 + 64) of a [S, D] matrix into shared memory with row
// stride D + 1; rows past S are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst,
                                          const T* __restrict__ src,
                                          int row0, int S) {
  for (int idx = threadIdx.x; idx < kB * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int g = row0 + r;
    dst[r * (D + 1) + c] = g < S ? to_f32(src[(size_t)g * D + c]) : 0.f;
  }
}

// acc[i][j] = sum_c A[ty*4 + i][c] * B[tx + 16j][c] over tiles with row
// stride D + 1: the thread's 4 x 4 piece of A B^T
template <int D>
__device__ __forceinline__ void tile_abt(const float* A, const float* B,
                                         float acc[4][4], int tx, int ty) {
  constexpr int L = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int c = 0; c < D; ++c) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty * 4 + i) * L + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * L + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// P and dS of the thread's 4 x 4 piece of the (q0, k0) tile pair, from its
// pieces of S = Q K^T and dP = dO V^T; masked and ragged elements give 0
__device__ __forceinline__ void probs_and_dscores(
    float s[4][4], float dp[4][4], const float lse[4], const float dl[4],
    int q0, int k0, int S, float scale, int causal, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kpos = k0 + tx + 16 * j;
      const bool live = qpos < S && kpos < S && !(causal && kpos > qpos);
      const float p = live ? expf(s[i][j] * scale - lse[i]) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - dl[i]);
    }
  }
}

// the f32 LSE and delta of the thread's 4 query rows (0 past S)
__device__ __forceinline__ void row_stats(const float* __restrict__ lse,
                                          const float* __restrict__ delta,
                                          size_t base, int q0, int S, int ty,
                                          float l[4], float d[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    l[i] = qpos < S ? lse[base + qpos] : 0.f;
    d[i] = qpos < S ? delta[base + qpos] : 0.f;
  }
}

template <int D>
constexpr int dq_smem_floats() {
  return 4 * kB * (D + 1) + kB * kPP;
}

template <int D>
constexpr int dkv_smem_floats() {
  return 4 * kB * (D + 1) + 2 * kB * kPP;
}

// K2: one block per (query tile, b*h)
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int S, float scale, int causal) {
  constexpr int L = D + 1;
  constexpr int C = D / 16;  // gradient columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + kB * L;
  float* sK = sdO + kB * L;
  float* sV = sK + kB * L;
  float* sdS = sV + kB * L;

  const int qt = blockIdx.x;
  const size_t bh = blockIdx.y;
  const int q0 = qt * kB;
  const size_t off = bh * S * D;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<T, D>(sQ, q + off, q0, S);
  load_tile<T, D>(sdO, dout + off, q0, S);
  float l[4], dl[4];
  row_stats(lse, delta, bh * S, q0, S, ty, l, dl);

  float acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;

  const int n_tiles = (S + kB - 1) / kB;
  const int last = causal ? min(n_tiles - 1, qt) : n_tiles - 1;
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();  // previous tile's readers are done with sK/sV/sdS
    load_tile<T, D>(sK, k + off, k0, S);
    load_tile<T, D>(sV, v + off, k0, S);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_abt<D>(sQ, sK, s, tx, ty);
    tile_abt<D>(sdO, sV, dp, tx, ty);
    probs_and_dscores(s, dp, l, dl, q0, k0, S, scale, causal, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sdS[(ty * 4 + i) * kPP + tx + 16 * j] = dp[i][j];
    __syncthreads();

    // dQ[rows] += dS[rows, :] K
#pragma unroll 4
    for (int j = 0; j < kB; ++j) {
      float ds[4], kv[C];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = sdS[(ty * 4 + i) * kPP + j];
#pragma unroll
      for (int c = 0; c < C; ++c) kv[c] = sK[j * L + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] = fmaf(ds[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= S) continue;
    T* row = dq + off + (size_t)qpos * D;
#pragma unroll
    for (int c = 0; c < C; ++c) store(row + tx + 16 * c, acc[i][c] * scale);
  }
}

// K3: one block per (key tile, b*h)
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int S, float scale, int causal) {
  constexpr int L = D + 1;
  constexpr int C = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kB * L;
  float* sQ = sV + kB * L;
  float* sdO = sQ + kB * L;
  float* sP = sdO + kB * L;
  float* sdS = sP + kB * kPP;

  const int kt = blockIdx.x;
  const size_t bh = blockIdx.y;
  const int k0 = kt * kB;
  const size_t off = bh * S * D;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<T, D>(sK, k + off, k0, S);
  load_tile<T, D>(sV, v + off, k0, S);

  // rows are this tile's keys ty*4 + i, columns tx + 16c
  float acc_k[4][C], acc_v[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  const int n_tiles = (S + kB - 1) / kB;
  for (int qt = causal ? kt : 0; qt < n_tiles; ++qt) {
    const int q0 = qt * kB;
    __syncthreads();  // previous tile's readers are done with sQ/sdO/sP/sdS
    load_tile<T, D>(sQ, q + off, q0, S);
    load_tile<T, D>(sdO, dout + off, q0, S);
    float l[4], dl[4];
    row_stats(lse, delta, bh * S, q0, S, ty, l, dl);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_abt<D>(sQ, sK, s, tx, ty);
    tile_abt<D>(sdO, sV, dp, tx, ty);
    probs_and_dscores(s, dp, l, dl, q0, k0, S, scale, causal, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sP[(ty * 4 + i) * kPP + tx + 16 * j] = s[i][j];
        sdS[(ty * 4 + i) * kPP + tx + 16 * j] = dp[i][j];
      }
    __syncthreads();

    // dV[keys] += P[:, keys]^T dO,  dK[keys] += dS[:, keys]^T Q
#pragma unroll 2
    for (int r = 0; r < kB; ++r) {
      float p[4], ds[4], dov[C], qv[C];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = sP[r * kPP + ty * 4 + i];
        ds[i] = sdS[r * kPP + ty * 4 + i];
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        dov[c] = sdO[r * L + tx + 16 * c];
        qv[c] = sQ[r * L + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          acc_v[i][c] = fmaf(p[i], dov[c], acc_v[i][c]);
          acc_k[i][c] = fmaf(ds[i], qv[c], acc_k[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty * 4 + i;
    if (kpos >= S) continue;
    T* krow = dk + off + (size_t)kpos * D;
    T* vrow = dv + off + (size_t)kpos * D;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      store(krow + tx + 16 * c, acc_k[i][c] * scale);
      store(vrow + tx + 16 * c, acc_v[i][c]);
    }
  }
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int BH, int S,
              float scale, int causal, cudaStream_t stream) {
  const int bytes = dq_smem_floats<D>() * (int)sizeof(float);
  // above 48 KB a block must opt in to dynamic shared memory
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kB - 1) / kB, BH);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), S, scale, causal);
  return 0;
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int BH, int S, float scale, int causal, cudaStream_t stream) {
  const int bytes = dkv_smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kB - 1) / kB, BH);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), S, scale, causal);
  return 0;
}

template <typename T>
int dispatch_dq(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dq, int BH, int S,
                int D, float scale, int causal, cudaStream_t st) {
  switch (D) {
    case 64:
      return launch_dq<T, 64>(q, k, v, dout, lse, delta, dq, BH, S, scale,
                              causal, st);
    case 128:
      return launch_dq<T, 128>(q, k, v, dout, lse, delta, dq, BH, S, scale,
                               causal, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_dkv(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dk, void* dv, int BH, int S, int D, float scale,
                 int causal, cudaStream_t st) {
  switch (D) {
    case 64:
      return launch_dkv<T, 64>(q, k, v, dout, lse, delta, dk, dv, BH, S,
                               scale, causal, st);
    case 128:
      return launch_dkv<T, 128>(q, k, v, dout, lse, delta, dk, dv, BH, S,
                                scale, causal, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 on success). dtype:
// 0 = float32, 1 = bfloat16. They launch on `stream`, do not synchronise
// and allocate nothing.
extern "C" int flash_attention_backward_dq(const void* q, const void* k,
                                           const void* v, const void* dout,
                                           const void* lse, const void* delta,
                                           void* dq, int BH, int S, int D,
                                           float scale, int causal, int dtype,
                                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
  int bad;
  if (dtype == 0)
    bad = dispatch_dq<float>(q, k, v, dout, l, d, dq, BH, S, D, scale, causal,
                             st);
  else if (dtype == 1)
    bad = dispatch_dq<__nv_bfloat16>(q, k, v, dout, l, d, dq, BH, S, D, scale,
                                     causal, st);
  else
    bad = (int)cudaErrorInvalidValue;
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
  int bad;
  if (dtype == 0)
    bad = dispatch_dkv<float>(q, k, v, dout, l, d, dk, dv, BH, S, D, scale,
                              causal, st);
  else if (dtype == 1)
    bad = dispatch_dkv<__nv_bfloat16>(q, k, v, dout, l, d, dk, dv, BH, S, D,
                                      scale, causal, st);
  else
    bad = (int)cudaErrorInvalidValue;
  if (bad) return bad;
  return (int)cudaGetLastError();
}
