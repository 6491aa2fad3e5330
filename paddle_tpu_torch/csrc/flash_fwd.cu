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
// byte at S = 1024. In f32 without TF32 the flops run on the FP32 CUDA
// cores (67 TFLOP/s), not the tensor cores.
//
// What the design does about it (a simple first kernel; wgmma, TMA and
// warp specialisation come later):
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
//     so any S works, not only multiples of the tile;
//   * bf16 inputs are widened to f32 on the way into shared memory; all
//     arithmetic is f32 and O is rounded once at the end.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kBM = 64;        // query rows per block
constexpr int kBN = 64;        // key rows per tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kPP = kBN + 1;   // padded P row

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int D>
constexpr int smem_floats() {
  return kBM * (D + 1) + kBN * (D + 1) + kBN * D + kBM * kPP;
}

// rows [row0, row0 + 64) of a [S, D] matrix into shared memory with row
// stride `ld`; rows past S are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const T* __restrict__ src,
                                          int row0, int S) {
  for (int idx = threadIdx.x; idx < kBN * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int g = row0 + r;
    dst[r * ld + c] = g < S ? to_f32(src[(size_t)g * D + c]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
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
  const T* qb = q + bh * S * D;
  const T* kb = k + bh * S * D;
  const T* vb = v + bh * S * D;

  const int tx = threadIdx.x & 15;  // key / output-column group
  const int ty = threadIdx.x >> 4;  // query-row group: rows ty*4 .. ty*4+3

  load_tile<T, D>(sQ, LQ, qb, q0, S);

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
    load_tile<T, D>(sK, LQ, kb, k0, S);
    load_tile<T, D>(sV, D, vb, k0, S);
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
    T* orow = o + (bh * S + qpos) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) store(orow + tx + 16 * c, acc[i][c] * inv);
    if (tx == 0) lse[bh * S + qpos] = m[i] + logf(l[i]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int BH, int S, float scale, int causal, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * (int)sizeof(float);
  // above 48 KB a block must opt in to dynamic shared memory
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kBM - 1) / kBM, BH);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, scale, causal);
  return 0;
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o,
               float* lse, int BH, int S, int D, float scale, int causal,
               cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, o, lse, BH, S, scale, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, BH, S, scale, causal, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). dtype: 0 =
// float32, 1 = bfloat16. Launches on `stream`, does not synchronise and
// allocates nothing.
extern "C" int flash_attention_forward(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int BH, int S, int D, float scale,
                                       int causal, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lp = static_cast<float*>(lse);
  int bad;
  if (dtype == 0)
    bad = dispatch_d<float>(q, k, v, o, lp, BH, S, D, scale, causal, st);
  else if (dtype == 1)
    bad = dispatch_d<__nv_bfloat16>(q, k, v, o, lp, BH, S, D, scale, causal,
                                    st);
  else
    bad = (int)cudaErrorInvalidValue;
  if (bad) return bad;
  return (int)cudaGetLastError();
}
