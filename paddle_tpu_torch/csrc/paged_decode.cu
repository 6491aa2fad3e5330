// Paged decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: paddle_tpu/ops/paged_attention.py::_paged_decode_kernel (the
// Pallas TPU kernel launched by _paged_decode_32). One new-token query per
// slot attends over that slot's live cache rows, read in place from the
// paged pool through the slot's block-table row.
//
//   q         [S, nh, hd]            f32 or bf16
//   k/v pool  [NB, nh, BS, hd]       same dtype as q
//   tables    [S, MB] int32          logical block -> physical block
//   lengths   [S] int32              live rows, including this step's row
//   out       [S, nh, hd]            q's dtype
//   workspace [S, nh, NC, hd + 2]    f32, the chunks' partials (below)
//
// What bounds it on this card: device-memory bytes. Each live K/V row is
// read once and used for 2*hd flops per operand, far below the ~20 flops a
// byte the H100's f32 CUDA cores need to be the limit.
//
// What the design does about it (split-KV, "flash-decoding"):
//   * a slot's rows are cut into chunks of `cp` pages (the wrapper picks cp
//     so that a chunk is 16 KB of K and 16 KB of V a head); the grid is
//     (nh, S, NC = ceil(MB / cp) chunks), fixed by the static shapes, so
//     the longest slot's rows spread over NC x nh blocks. `lengths` stays
//     on the device: a block whose chunk lies past its slot's length
//     (clamped to MB*BS, as the TPU index map clamped it) exits at once.
//     The chunk index varies slowest, so the first chunks of every slot,
//     which are live whenever the slot is, start first, and the blocks
//     past the shorter slots' lengths exit together at the end instead of
//     holding places in every wave;
//   * a block reads its own table entries and length (the TPU kernel had
//     them as scalar-prefetch operands), both issued before the first
//     dependent load; rows past the length are never loaded, so
//     trash-block and stale rows carry exactly zero weight, as the -1e30
//     mask gives them in the reference;
//   * a row is read by hd / VE lanes, 16 bytes each (VE = 4 f32 or 8
//     bf16), so a warp instruction reads 512 contiguous bytes of a page;
//     each lane issues the K and V loads of kRows rows before any
//     arithmetic, to keep enough bytes in flight to cover the latency.
//     Operands not 16-byte aligned load element by element instead;
//   * the score is a dot product over the row's lanes (a shuffle tree),
//     f32 online softmax per row group with the scale folded with log2(e)
//     (one exp2f a row); the groups of a block merge through shared memory
//     in a fixed order, and the chunk writes (m, l, acc[hd]) to the
//     workspace;
//   * paged_decode_combine, one block per (head, slot), merges the slot's
//     live chunks in chunk order (so the bits do not depend on scheduling;
//     no atomics) and writes out = acc / max(l, 1e-37) in q's dtype: a
//     length <= 0 slot has no live chunk and writes zeros, as the floor in
//     the reference keeps it finite.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 8;  // rows a lane loads before any arithmetic
constexpr float kLog2e = 1.4426950408889634f;

// 16 bytes of T: 4 f32 or 8 bf16
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ uint4 load(const float* p, int vec) {
    if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
    return make_uint4(__float_as_uint(p[0]), __float_as_uint(p[1]),
                      __float_as_uint(p[2]), __float_as_uint(p[3]));
  }
  static __device__ __forceinline__ void unpack(const uint4& r, float f[4]) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ uint32_t pair(const __nv_bfloat16* p) {
    return (uint32_t)__bfloat16_as_ushort(p[0]) |
           ((uint32_t)__bfloat16_as_ushort(p[1]) << 16);
  }
  static __device__ __forceinline__ uint4 load(const __nv_bfloat16* p,
                                               int vec) {
    if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
    return make_uint4(pair(p), pair(p + 2), pair(p + 4), pair(p + 6));
  }
  static __device__ __forceinline__ float lo(uint32_t w) {
    return __uint_as_float(w << 16);
  }
  static __device__ __forceinline__ float hi(uint32_t w) {
    return __uint_as_float(w & 0xffff0000u);
  }
  static __device__ __forceinline__ void unpack(const uint4& r, float f[8]) {
    f[0] = lo(r.x);
    f[1] = hi(r.x);
    f[2] = lo(r.y);
    f[3] = hi(r.y);
    f[4] = lo(r.z);
    f[5] = hi(r.z);
    f[6] = lo(r.w);
    f[7] = hi(r.w);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
  }
};

// One block per (head blockIdx.x, slot blockIdx.y, chunk blockIdx.z): the
// chunk's rows r0 .. r0 + cp*bs of the slot, at most its clamped length.
// scale_log2 = log2(e) / sqrt(hd).
template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc,
                        const int* __restrict__ tables,
                        const int* __restrict__ lengths,
                        float* __restrict__ ws, int nh, int bs, int mb,
                        int cp, float scale_log2, int vec) {
  constexpr int VE = Vec<T>::N;      // elements of a lane's 16 bytes
  constexpr int LPR = HD / VE;       // lanes a row
  constexpr int RPW = 32 / LPR;      // rows a warp instruction reads
  constexpr int G = kWarps * RPW;    // row groups a block
  constexpr int ROUND = G * kRows;   // rows a block loads at once
  const int h = blockIdx.x, s = blockIdx.y, c = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane / LPR, col = (lane % LPR) * VE;
  const int g = warp * RPW + sub;    // this lane's row group
  const int cr = cp * bs;            // rows a chunk
  const int r0 = c * cr;
  const int cap = mb * bs;
  const int* trow = tables + (size_t)s * mb;

  // the length, this lane's first table entries and q, all at once
  const int len = lengths[s];
  int blk[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int j = r0 + (warp * kRows + r) * RPW + sub;
    blk[r] = j < cap ? trow[j / bs] : 0;
  }
  float qf[VE];
  Vec<T>::unpack(Vec<T>::load(q + ((size_t)s * nh + h) * HD + col, vec), qf);

  const int n_rows = min(max(len, 0), cap);
  if (r0 >= n_rows) return;  // this chunk is past the slot's length
  const int end = min(r0 + cr, n_rows);

  float m = -1e30f, l = 0.f, acc[VE];
#pragma unroll
  for (int e = 0; e < VE; ++e) acc[e] = 0.f;

  for (int base = r0; base < end; base += ROUND) {
    if (base != r0) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int j = base + (warp * kRows + r) * RPW + sub;
        blk[r] = j < end ? trow[j / bs] : 0;
      }
    }
    uint4 kr[kRows], vr[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int j = base + (warp * kRows + r) * RPW + sub;
      if (j < end) {
        const size_t p = (((size_t)blk[r] * nh + h) * bs + j % bs) * HD + col;
        kr[r] = Vec<T>::load(kc + p, vec);
        vr[r] = Vec<T>::load(vc + p, vec);
      } else {
        kr[r] = vr[r] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    float sc[kRows];
    float mx = -1e30f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float kf[VE];
      Vec<T>::unpack(kr[r], kf);
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < VE; ++e) d = fmaf(qf[e], kf[e], d);
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, off);
      const int j = base + (warp * kRows + r) * RPW + sub;
      sc[r] = j < end ? d * scale_log2 : -1e30f;
      mx = fmaxf(mx, sc[r]);
    }
    const float m_new = fmaxf(m, mx);
    const float alpha = exp2f(m - m_new);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[e] *= alpha;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int j = base + (warp * kRows + r) * RPW + sub;
      const float p = j < end ? exp2f(sc[r] - m_new) : 0.f;
      float vf[VE];
      Vec<T>::unpack(vr[r], vf);
      l += p;
#pragma unroll
      for (int e = 0; e < VE; ++e) acc[e] = fmaf(p, vf[e], acc[e]);
    }
    m = m_new;
  }

  // the block's row groups merge in group order; a group that saw no row
  // has m = -1e30, l = 0 and weight 0
  __shared__ float sm_m[G], sm_l[G];
  __shared__ __align__(16) float sm_acc[G][HD];
  if (lane % LPR == 0) {
    sm_m[g] = m;
    sm_l[g] = l;
  }
#pragma unroll
  for (int e = 0; e < VE; ++e) sm_acc[g][col + e] = acc[e];
  __syncthreads();
  if (tid < HD) {
    float mx = -1e30f;
#pragma unroll
    for (int i = 0; i < G; ++i) mx = fmaxf(mx, sm_m[i]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const float f = exp2f(sm_m[i] - mx);
      lsum = fmaf(sm_l[i], f, lsum);
      a = fmaf(sm_acc[i][tid], f, a);
    }
    const size_t part = ((size_t)s * nh + h) * gridDim.z + c;
    const size_t n_part = (size_t)gridDim.y * nh * gridDim.z;
    ws[part * HD + tid] = a;
    if (tid == 0) {
      ws[n_part * HD + part] = mx;
      ws[n_part * (HD + 1) + part] = lsum;
    }
  }
}

// One block of hd threads per (head blockIdx.x, slot blockIdx.y): the
// slot's live chunks merged in chunk order, out = acc / max(l, 1e-37).
// The m and l of all NC chunks come into shared memory with one load a
// thread, issued with the length's (those past it are never used), and
// the acc loop is unrolled, so the loads of several chunks are in flight
// at once rather than one chunk's latency after another's.
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
    paged_decode_combine(const float* __restrict__ ws,
                         const int* __restrict__ lengths, T* __restrict__ out,
                         int S, int nh, int bs, int mb, int cp, int nc) {
  extern __shared__ float sml[];  // [nc] m, then [nc] l
  const int h = blockIdx.x, s = blockIdx.y, t = threadIdx.x;
  const int len = lengths[s];
  const size_t part = ((size_t)s * nh + h) * nc;
  const size_t n_part = (size_t)S * nh * nc;
  for (int c = t; c < nc; c += HD) {
    sml[c] = ws[n_part * HD + part + c];
    sml[nc + c] = ws[n_part * (HD + 1) + part + c];
  }
  const int n_rows = min(max(len, 0), mb * bs);
  const int live = (n_rows + cp * bs - 1) / (cp * bs);
  __syncthreads();
  float mx = -1e30f;
  for (int c = 0; c < live; ++c) mx = fmaxf(mx, sml[c]);
  float lsum = 0.f, a = 0.f;
#pragma unroll 8
  for (int c = 0; c < live; ++c) {
    const float f = exp2f(sml[c] - mx);
    lsum = fmaf(sml[nc + c], f, lsum);
    a = fmaf(ws[(part + c) * HD + t], f, a);
  }
  Vec<T>::store(out + ((size_t)s * nh + h) * HD + t, a / fmaxf(lsum, 1e-37f));
}

template <typename T, int HD>
void launch(const void* q, const void* kc, const void* vc, const void* tables,
            const void* lengths, void* out, float* ws, int S, int nh, int bs,
            int mb, int cp, cudaStream_t stream) {
  const int nc = (mb + cp - 1) / cp;
  const int vec = ((reinterpret_cast<uintptr_t>(q) |
                    reinterpret_cast<uintptr_t>(kc) |
                    reinterpret_cast<uintptr_t>(vc)) %
                   16) == 0;
  if (nc > 0)  // mb = 0: no chunk, the combine writes zeros
    paged_decode_kernel<T, HD><<<dim3(nh, S, nc), kWarps * 32, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kc),
        static_cast<const T*>(vc), static_cast<const int*>(tables),
        static_cast<const int*>(lengths), ws, nh, bs, mb, cp,
        kLog2e / sqrtf((float)HD), vec);
  paged_decode_combine<T, HD>
      <<<dim3(nh, S), HD, 2 * nc * sizeof(float), stream>>>(
      ws, static_cast<const int*>(lengths), static_cast<T*>(out), S, nh, bs,
      mb, cp, nc);
}

template <typename T>
int dispatch_hd(const void* q, const void* kc, const void* vc,
                const void* tables, const void* lengths, void* out, float* ws,
                int S, int nh, int hd, int bs, int mb, int cp,
                cudaStream_t stream) {
  switch (hd) {
    case 32:
      launch<T, 32>(q, kc, vc, tables, lengths, out, ws, S, nh, bs, mb, cp,
                    stream);
      return 0;
    case 64:
      launch<T, 64>(q, kc, vc, tables, lengths, out, ws, S, nh, bs, mb, cp,
                    stream);
      return 0;
    case 128:
      launch<T, 128>(q, kc, vc, tables, lengths, out, ws, S, nh, bs, mb, cp,
                     stream);
      return 0;
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Returns cudaGetLastError() after the two launches (0 on success). dtype:
// 0 = float32, 1 = bfloat16. `chunk_pages` pages a chunk; the workspace
// holds S * nh * ceil(mb / chunk_pages) * (hd + 2) floats. Launches on
// `stream`, does not synchronise and allocates nothing.
extern "C" int paged_decode_attention(const void* q, const void* kc,
                                      const void* vc, const void* tables,
                                      const void* lengths, void* out,
                                      void* workspace, int S, int nh, int hd,
                                      int bs, int mb, int chunk_pages,
                                      int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  int bad;
  if (chunk_pages < 1)
    bad = (int)cudaErrorInvalidValue;
  else if (dtype == 0)
    bad = dispatch_hd<float>(q, kc, vc, tables, lengths, out, ws, S, nh, hd,
                             bs, mb, chunk_pages, st);
  else if (dtype == 1)
    bad = dispatch_hd<__nv_bfloat16>(q, kc, vc, tables, lengths, out, ws, S,
                                     nh, hd, bs, mb, chunk_pages, st);
  else
    bad = (int)cudaErrorInvalidValue;
  if (bad) return bad;
  return (int)cudaGetLastError();
}
