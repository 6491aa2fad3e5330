// Paged decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: paddle_tpu/ops/paged_attention.py::_paged_decode_kernel (the
// Pallas TPU kernel launched by _paged_decode_32). One new-token query per
// slot attends over that slot's live cache rows, read in place from the
// paged pool through the slot's block-table row.
//
//   q        [S, nh, hd]            f32 or bf16
//   k/v pool [NB, nh, BS, hd]       same dtype as q
//   tables   [S, MB] int32          logical block -> physical block
//   lengths  [S] int32              live rows, including this step's row
//   out      [S, nh, hd]            q's dtype
//
// What bounds it on this card: device-memory bytes. Each live K/V row is
// read once and used for 2*hd flops per operand, far below the ~20 flops a
// byte the H100's f32 CUDA cores need to be the limit.
//
// What the design does about it:
//   * one thread block per (head, slot) reads only that slot's live rows:
//     min(ceil(len/BS), MB) blocks, the clamp the TPU index map applied
//     (a parked slot's length keeps growing past MB*BS); rows past the
//     length are never loaded, so trash-block and stale rows carry exactly
//     zero weight, as the -1e30 mask gives them in the reference;
//   * the block reads its own table row and length (the TPU kernel had
//     them as scalar-prefetch operands);
//   * each warp walks its own rows, kRows at a time, issuing all of their
//     K and V loads before any arithmetic, so enough loads are in flight
//     to cover the memory latency; a row is one coalesced warp read
//     (lanes on consecutive elements);
//   * scores are a warp reduction over hd (the contraction is 1 x hd per
//     row, far too thin for the tensor cores), f32 online softmax per
//     warp, then the warps' (m, l, acc) merge through shared memory;
//   * l is floored at 1e-37 as in the reference, so a length <= 0 slot
//     writes zeros instead of NaN.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc,
                        const int* __restrict__ tables,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int nh, int bs, int mb) {
  constexpr int E = HD / 32;  // elements of a row each lane holds
  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float rsd = sqrtf((float)HD);

  float qr[E];
  const T* qp = q + ((size_t)s * nh + h) * HD;
#pragma unroll
  for (int e = 0; e < E; ++e) qr[e] = to_f32(qp[lane + 32 * e]);

  const int len = lengths[s];
  const int n_rows = min(max(len, 0), mb * bs);
  const int* row = tables + (size_t)s * mb;

  float m = -1e30f, l = 0.f;
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

  for (int j0 = warp * kRows; j0 < n_rows; j0 += kWarps * kRows) {
    float kr[kRows][E], vr[kRows][E];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int j = j0 + r;
      if (j < n_rows) {
        const int blk = row[j / bs];
        const size_t base = (((size_t)blk * nh + h) * bs + (j % bs)) * HD;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          kr[r][e] = to_f32(kc[base + lane + 32 * e]);
          vr[r][e] = to_f32(vc[base + lane + 32 * e]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kr[r][e] = vr[r][e] = 0.f;
      }
    }
    float sc[kRows];
    float cmax = -INFINITY;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) d = fmaf(qr[e], kr[r][e], d);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, off);
      sc[r] = (j0 + r < n_rows) ? d / rsd : -INFINITY;
      cmax = fmaxf(cmax, sc[r]);
    }
    const float m_new = fmaxf(m, cmax);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= alpha;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float p = (j0 + r < n_rows) ? expf(sc[r] - m_new) : 0.f;
      l += p;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = fmaf(p, vr[r][e], acc[e]);
    }
    m = m_new;
  }

  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][HD];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) sm_acc[warp][lane + 32 * e] = acc[e];
  __syncthreads();

  const int c = threadIdx.x;
  if (c < HD) {
    float mx = -1e30f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w] - mx);
      lsum = fmaf(sm_l[w], f, lsum);
      a = fmaf(sm_acc[w][c], f, a);
    }
    lsum = fmaxf(lsum, 1e-37f);
    store(out + ((size_t)s * nh + h) * HD + c, a / lsum);
  }
}

template <typename T, int HD>
void launch(const void* q, const void* kc, const void* vc, const void* tables,
            const void* lengths, void* out, int S, int nh, int bs, int mb,
            cudaStream_t stream) {
  dim3 grid(nh, S);
  paged_decode_kernel<T, HD><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), nh, bs, mb);
}

template <typename T>
int dispatch_hd(const void* q, const void* kc, const void* vc,
                const void* tables, const void* lengths, void* out, int S,
                int nh, int hd, int bs, int mb, cudaStream_t stream) {
  switch (hd) {
    case 32:
      launch<T, 32>(q, kc, vc, tables, lengths, out, S, nh, bs, mb, stream);
      return 0;
    case 64:
      launch<T, 64>(q, kc, vc, tables, lengths, out, S, nh, bs, mb, stream);
      return 0;
    case 128:
      launch<T, 128>(q, kc, vc, tables, lengths, out, S, nh, bs, mb, stream);
      return 0;
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). dtype: 0 =
// float32, 1 = bfloat16. Launches on `stream`, does not synchronise and
// allocates nothing.
extern "C" int paged_decode_attention(const void* q, const void* kc,
                                      const void* vc, const void* tables,
                                      const void* lengths, void* out, int S,
                                      int nh, int hd, int bs, int mb,
                                      int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int bad;
  if (dtype == 0)
    bad = dispatch_hd<float>(q, kc, vc, tables, lengths, out, S, nh, hd, bs,
                             mb, st);
  else if (dtype == 1)
    bad = dispatch_hd<__nv_bfloat16>(q, kc, vc, tables, lengths, out, S, nh,
                                     hd, bs, mb, st);
  else
    bad = (int)cudaErrorInvalidValue;
  if (bad) return bad;
  return (int)cudaGetLastError();
}
