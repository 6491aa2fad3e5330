// Fused linear + softmax cross-entropy (the tied LM head) for Hopper
// (sm_90a), plain C interface for ctypes: the per-token loss of
// logits = x W^T without the [T, V] logits ever reaching device memory, in
// either direction. Three kernels, as the TPU split them; none uses atomics,
// so every run gives the same bits.
//
// Replaces paddle_tpu/ops/fused_ce.py:
//   K5  _fwd_kernel (:93, pallas_call :144)     loss and LSE per token
//   K6  _bwd_dx_kernel (:183, pallas_call :226)  dx = d W
//   K7  _bwd_dw_kernel (:198, pallas_call :242)  dW = d^T x
// with the d tile recomputed from the forward's LSE as in _dtile (:172):
//   d[t, v] = (exp(S[t, v] - lse[t]) - [v == label[t]]) * g[t] * valid[t],
//   S = x W^T, valid[t] = label[t] != ignore_index.
//
//   x       [T, H]  f32 or bf16, contiguous
//   w       [V, H]  x's dtype (the embedding layout: no transpose)
//   labels  [T]     int32 or int64; a label outside [0, V) that is not
//                   ignore_index gives a label logit of 0 (undefined input)
//   lse, g  [T]     f32;  loss [T] f32;  dx [T, H], dW [V, H] x's dtype
//
// What bounds it on this card: operations. At the flagship shape (T = 8192,
// H = 768, V = 50304) K5 does 2 T V H = 6.33e11 flops: 9.45 ms at the 67
// TFLOP/s of the f32 CUDA cores, 0.64 ms at the 989 TFLOP/s of bf16 tensor
// cores, while its bytes (x, W, labels in; loss, lse out) are 180 MB in f32,
// 0.054 ms at 3.35 TB/s. K6 and K7 each recompute S and do one more product
// of the same size: 1.27e12 flops, 18.9 ms in f32, 1.28 ms in bf16.
//
// What the design does about it (a simple first kernel: f32 FMAs on the
// CUDA cores for both dtypes; mma.sync / wgmma for bf16, TMA and a fused
// backward are later work):
//   * every logits tile S [64 x 64] is a small GEMM over H, staged in shared
//     memory 32 columns at a time; each of the 256 threads owns a 4 x 4
//     register tile (rows ty*4.., columns tx + 16j), the layout of the
//     flash kernels, so each shared-memory load feeds 2 FMAs;
//   * K5: a block owns 64 token rows and loops over its share of the vocab
//     tiles, keeping an online max / sum-exp per row and thread; the 16
//     threads of a row combine once, with shuffles, at the end. The vocab
//     is split over a second grid dimension so that T = 8192 (128 row
//     tiles) still fills the card with several blocks per SM; a small
//     combine kernel merges the splits in a fixed order;
//   * K6 keeps the block's [64 x H] dx resident in shared memory (192 KB at
//     H = 768, one block per SM) rather than splitting H over blocks, which
//     would recompute every S tile once per split: the recompute costs as
//     much as the product itself. Each vocab tile makes the d tile in
//     shared memory and adds d W_tile into the accumulator 64 columns at a
//     time. Above H = 768 columns go to a second grid dimension;
//   * K7 is the same kernel with the roles swapped: a block owns 64 vocab
//     rows of dW and loops over the token tiles (786 blocks at V = 50304);
//   * d stays f32 (the TPU kernels rounded it to W's dtype before the
//     product; the port keeps it f32 as _xla_bwd does), bf16 inputs are
//     widened on load and the outputs are rounded once, at the end;
//   * ragged T, V and H: rows and columns outside the matrices load as
//     zeros and give d = 0 exactly, so any size works; ignore_index rows
//     give loss 0 and add exactly nothing to dx or dW.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kB = 64;         // rows of a token or vocab tile
constexpr int kC = 32;         // columns of H staged per chunk
constexpr int kThreads = 256;  // 16 x 16
constexpr int kL = kC + 1;     // padded row of a staged chunk
constexpr int kPD = kB + 1;    // padded row of the d tile
constexpr int kHB = 768;       // most columns of dx / dW one block owns
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// rows [r0, r0 + 64) x columns [k0, k0 + 32) of a row-major [n, H] matrix
// into shared memory with row stride kL; outside the matrix zero
template <typename T>
__device__ __forceinline__ void load_chunk(float* dst,
                                           const T* __restrict__ src, int r0,
                                           int n, int k0, int H) {
  for (int idx = threadIdx.x; idx < kB * kC; idx += kThreads) {
    const int r = idx / kC, c = idx % kC;
    const int g = r0 + r, k = k0 + c;
    dst[r * kL + c] = (g < n && k < H) ? to_f32(src[(size_t)g * H + k]) : 0.f;
  }
}

// acc[i][j] = sum_k A[a0 + ty*4 + i][k] * B[b0 + tx + 16j][k] over all of
// H: the thread's 4 x 4 piece of the tile A_rows B_rows^T. Starts with a
// barrier, so the caller may have used sA/sB (or what aliases them) before.
template <typename T>
__device__ __forceinline__ void tile_abt(const T* __restrict__ A, int a0,
                                         int na, const T* __restrict__ B,
                                         int b0, int nb, int H, float* sA,
                                         float* sB, float acc[4][4], int tx,
                                         int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < H; k0 += kC) {
    __syncthreads();  // the previous chunk's readers are done
    load_chunk<T>(sA, A, a0, na, k0, H);
    load_chunk<T>(sB, B, b0, nb, k0, H);
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kC; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sA[(ty * 4 + i) * kL + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sB[(tx + 16 * j) * kL + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// K5: one block per (64-row token tile, vocab split). Writes the split's
// per-row max m, sum of exp(S - m) and label logit into part[3][nsplit][T].
template <typename T, typename L>
__global__ void __launch_bounds__(kThreads)
    fused_ce_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const L* __restrict__ labels, float* __restrict__ part,
                        int Tn, int V, int H, int tiles_per_split,
                        int nsplit) {
  __shared__ float sA[kB * kL];
  __shared__ float sB[kB * kL];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int t0 = blockIdx.x * kB;
  const int split = blockIdx.y;
  const int n_vt = (V + kB - 1) / kB;
  const int vt_end = min(n_vt, (split + 1) * tiles_per_split);

  long long lab[4];
  float m[4], s[4], ll[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty * 4 + i;
    lab[i] = t < Tn ? (long long)labels[t] : -1;
    m[i] = kNeg;
    s[i] = 0.f;
    ll[i] = 0.f;
  }

  for (int vt = split * tiles_per_split; vt < vt_end; ++vt) {
    const int v0 = vt * kB;
    float acc[4][4];
    tile_abt<T>(x, t0, Tn, w, v0, V, H, sA, sB, acc, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int v = v0 + tx + 16 * j;
        if (v < V) {
          tmax = fmaxf(tmax, acc[i][j]);
          if (v == lab[i]) ll[i] += acc[i][j];  // out-of-tile labels miss
        }
      }
      if (tmax > m[i]) {
        s[i] *= expf(m[i] - tmax);
        m[i] = tmax;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (v0 + tx + 16 * j < V) s[i] += expf(acc[i][j] - m[i]);
    }
  }

  // the 16 threads of a row are the lanes of one half warp
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float os = __shfl_xor_sync(0xffffffffu, s[i], off);
      const float ol = __shfl_xor_sync(0xffffffffu, ll[i], off);
      const float nm = fmaxf(m[i], om);
      s[i] = s[i] * expf(m[i] - nm) + os * expf(om - nm);
      m[i] = nm;
      ll[i] += ol;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty * 4 + i;
      if (t >= Tn) continue;
      part[((size_t)0 * nsplit + split) * Tn + t] = m[i];
      part[((size_t)1 * nsplit + split) * Tn + t] = s[i];
      part[((size_t)2 * nsplit + split) * Tn + t] = ll[i];
    }
  }
}

// K5's last step: merge the vocab splits of each row in split order
template <typename L>
__global__ void fused_ce_fwd_combine(const float* __restrict__ part,
                                     const L* __restrict__ labels,
                                     float* __restrict__ loss,
                                     float* __restrict__ lse, int Tn,
                                     int nsplit, long long ignore_index) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Tn) return;
  float M = kNeg;
  for (int p = 0; p < nsplit; ++p) M = fmaxf(M, part[(size_t)p * Tn + t]);
  float S = 0.f, LL = 0.f;
  for (int p = 0; p < nsplit; ++p) {
    S += part[((size_t)nsplit + p) * Tn + t] *
         expf(part[(size_t)p * Tn + t] - M);
    LL += part[((size_t)2 * nsplit + p) * Tn + t];
  }
  const float l = M + logf(S);
  lse[t] = l;
  loss[t] = (long long)labels[t] != ignore_index ? l - LL : 0.f;
}

constexpr int bwd_smem_floats(int hb) {
  return 2 * kB * kL + kB * kPD + kB * hb;
}

// K6 (TOK_A: the block's rows are tokens; A = x, B = W, out = dx) and K7
// (the block's rows are vocab entries; A = W, B = x, out = dW). One block
// per (64 rows of A, hb columns of H); it walks every 64-row tile of B:
//   S = A_rows B_tile^T,  d = (exp(S - lse) - onehot) g valid,
//   out[rows, cols] += d B_tile[:, cols]
template <typename T, typename L, bool TOK_A>
__global__ void __launch_bounds__(kThreads)
    fused_ce_bwd_kernel(const T* __restrict__ A, const T* __restrict__ B,
                        const L* __restrict__ labels,
                        const float* __restrict__ lse,
                        const float* __restrict__ g, T* __restrict__ out,
                        int na, int nb, int H, int hb,
                        long long ignore_index) {
  extern __shared__ float smem[];
  float* sA = smem;           // staged chunks of A and B for S
  float* sB = sA + kB * kL;
  float* sW = smem;           // 64 rows of B x 64 columns (aliases sA, sB)
  float* sD = sB + kB * kL;   // the d tile [a][b]
  float* acc = sD + kB * kPD; // out[rows, h_lo .. h_lo + hb), f32

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int a0 = blockIdx.x * kB;
  const int h_lo = blockIdx.y * hb;
  const int h_hi = min(H, h_lo + hb);
  for (int idx = threadIdx.x; idx < kB * hb; idx += kThreads) acc[idx] = 0.f;

  // per-token statistics: of the block's rows (K6) or of each B tile (K7);
  // gv = g * valid, 0 outside the matrix
  float st_lse[4], st_gv[4];
  long long st_lab[4];
  auto token_stats = [&](int t0, int stride, int lane) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int t = t0 + lane + stride * k;
      const int n_tok = TOK_A ? na : nb;
      if (t < n_tok) {
        const long long lb = (long long)labels[t];
        st_lab[k] = lb;
        st_lse[k] = lse[t];
        st_gv[k] = lb != ignore_index ? g[t] : 0.f;
      } else {
        st_lab[k] = -1;
        st_lse[k] = 0.f;
        st_gv[k] = 0.f;
      }
    }
  };
  if (TOK_A) token_stats(a0, 1, ty * 4);
  __syncthreads();  // acc is zero before anyone adds to it

  const int n_bt = (nb + kB - 1) / kB;
  for (int bt = 0; bt < n_bt; ++bt) {
    const int b0 = bt * kB;
    if (!TOK_A) token_stats(b0, 16, tx);
    float s[4][4];
    tile_abt<T>(A, a0, na, B, b0, nb, H, sA, sB, s, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int a = a0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int b = b0 + tx + 16 * j;
        const int k = TOK_A ? i : j;  // which statistic is this token's
        const long long v = TOK_A ? b : a;
        float d = 0.f;
        if (a < na && b < nb)
          d = (expf(s[i][j] - st_lse[k]) - (v == st_lab[k] ? 1.f : 0.f)) *
              st_gv[k];
        sD[(ty * 4 + i) * kPD + tx + 16 * j] = d;
      }
    }
    // out[rows, h0 .. h0 + 64) += d B_tile[:, h0 .. h0 + 64)
    for (int h0 = h_lo; h0 < h_hi; h0 += kB) {
      __syncthreads();  // sD is written; sA/sB (sW) readers are done
      for (int idx = threadIdx.x; idx < kB * kB; idx += kThreads) {
        const int r = idx / kB, c = idx % kB;
        const int gb = b0 + r, h = h0 + c;
        sW[r * kB + c] =
            (gb < nb && h < h_hi) ? to_f32(B[(size_t)gb * H + h]) : 0.f;
      }
      __syncthreads();
      float o[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
#pragma unroll 8
      for (int r = 0; r < kB; ++r) {
        float dv[4], wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) dv[i] = sD[(ty * 4 + i) * kPD + r];
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = sW[r * kB + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) o[i][j] = fmaf(dv[i], wv[j], o[i][j]);
      }
      // each thread adds to, and at the end writes, only its own elements
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[(ty * 4 + i) * hb + (h0 - h_lo) + tx + 16 * j] += o[i][j];
    }
  }

  for (int h0 = h_lo; h0 < h_hi; h0 += kB) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int a = a0 + ty * 4 + i;
      if (a >= na) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int h = h0 + tx + 16 * j;
        if (h < h_hi)
          store(out + (size_t)a * H + h,
                acc[(ty * 4 + i) * hb + (h0 - h_lo) + tx + 16 * j]);
      }
    }
  }
}

template <typename T, typename L>
int launch_fwd(const void* x, const void* w, const void* labels, float* part,
               float* loss, float* lse, int Tn, int V, int H, int nsplit,
               int tiles_per_split, long long ignore_index, cudaStream_t st) {
  const L* lab = static_cast<const L*>(labels);
  dim3 grid((Tn + kB - 1) / kB, nsplit);
  fused_ce_fwd_kernel<T, L><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), lab, part, Tn, V, H,
      tiles_per_split, nsplit);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_ce_fwd_combine<L><<<(Tn + 255) / 256, 256, 0, st>>>(
      part, lab, loss, lse, Tn, nsplit, ignore_index);
  return 0;
}

template <typename T, typename L, bool TOK_A>
int launch_bwd(const void* a, const void* b, const void* labels,
               const float* lse, const float* g, void* out, int na, int nb,
               int H, long long ignore_index, cudaStream_t st) {
  const int h64 = (H + kB - 1) / kB * kB;
  const int hb = h64 < kHB ? h64 : kHB;
  const int bytes = bwd_smem_floats(hb) * (int)sizeof(float);
  // above 48 KB a block must opt in to dynamic shared memory
  cudaError_t err = cudaFuncSetAttribute(
      fused_ce_bwd_kernel<T, L, TOK_A>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((na + kB - 1) / kB, (H + hb - 1) / hb);
  fused_ce_bwd_kernel<T, L, TOK_A><<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const L*>(labels), lse, g, static_cast<T*>(out), na, nb, H,
      hb, ignore_index);
  return 0;
}

template <typename T, bool TOK_A>
int bwd_by_label(const void* a, const void* b, const void* labels,
                 const float* lse, const float* g, void* out, int na, int nb,
                 int H, long long ignore_index, int label_dtype,
                 cudaStream_t st) {
  if (label_dtype == 0)
    return launch_bwd<T, int32_t, TOK_A>(a, b, labels, lse, g, out, na, nb, H,
                                         ignore_index, st);
  if (label_dtype == 1)
    return launch_bwd<T, int64_t, TOK_A>(a, b, labels, lse, g, out, na, nb, H,
                                         ignore_index, st);
  return (int)cudaErrorInvalidValue;
}

template <bool TOK_A>
int bwd(const void* a, const void* b, const void* labels, const void* lse,
        const void* g, void* out, int na, int nb, int H,
        long long ignore_index, int dtype, int label_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* gg = static_cast<const float*>(g);
  int bad;
  if (dtype == 0)
    bad = bwd_by_label<float, TOK_A>(a, b, labels, l, gg, out, na, nb, H,
                                     ignore_index, label_dtype, st);
  else if (dtype == 1)
    bad = bwd_by_label<__nv_bfloat16, TOK_A>(a, b, labels, l, gg, out, na, nb,
                                             H, ignore_index, label_dtype, st);
  else
    bad = (int)cudaErrorInvalidValue;
  if (bad) return bad;
  return (int)cudaGetLastError();
}

}  // namespace

// All three return cudaGetLastError() after their launches (0 on success).
// dtype: 0 = float32, 1 = bfloat16 (x and w alike); label_dtype: 0 = int32,
// 1 = int64. They launch on `stream`, do not synchronise and allocate
// nothing: `part` is the caller's f32 scratch of 3 * nsplit * T floats.

// K5: loss and lse of every token, the vocab tiles split over `nsplit`
// groups of `tiles_per_split` 64-column tiles
extern "C" int fused_ce_forward(const void* x, const void* w,
                                const void* labels, void* part, void* loss,
                                void* lse, int T, int V, int H, int nsplit,
                                int tiles_per_split, long long ignore_index,
                                int dtype, int label_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* lo = static_cast<float*>(loss);
  float* ls = static_cast<float*>(lse);
  int bad = (int)cudaErrorInvalidValue;
  if (dtype == 0 && label_dtype == 0)
    bad = launch_fwd<float, int32_t>(x, w, labels, p, lo, ls, T, V, H, nsplit,
                                     tiles_per_split, ignore_index, st);
  else if (dtype == 0 && label_dtype == 1)
    bad = launch_fwd<float, int64_t>(x, w, labels, p, lo, ls, T, V, H, nsplit,
                                     tiles_per_split, ignore_index, st);
  else if (dtype == 1 && label_dtype == 0)
    bad = launch_fwd<__nv_bfloat16, int32_t>(x, w, labels, p, lo, ls, T, V, H,
                                             nsplit, tiles_per_split,
                                             ignore_index, st);
  else if (dtype == 1 && label_dtype == 1)
    bad = launch_fwd<__nv_bfloat16, int64_t>(x, w, labels, p, lo, ls, T, V, H,
                                             nsplit, tiles_per_split,
                                             ignore_index, st);
  if (bad) return bad;
  return (int)cudaGetLastError();
}

// K6: dx [T, H] in x's dtype
extern "C" int fused_ce_backward_dx(const void* x, const void* w,
                                    const void* labels, const void* lse,
                                    const void* g, void* dx, int T, int V,
                                    int H, long long ignore_index, int dtype,
                                    int label_dtype, void* stream) {
  return bwd<true>(x, w, labels, lse, g, dx, T, V, H, ignore_index, dtype,
                   label_dtype, stream);
}

// K7: dW [V, H] in w's dtype
extern "C" int fused_ce_backward_dw(const void* x, const void* w,
                                    const void* labels, const void* lse,
                                    const void* g, void* dw, int T, int V,
                                    int H, long long ignore_index, int dtype,
                                    int label_dtype, void* stream) {
  return bwd<false>(w, x, labels, lse, g, dw, V, T, H, ignore_index, dtype,
                    label_dtype, stream);
}
