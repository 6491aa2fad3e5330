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
// bf16 K5 (fused_ce_fwd_mma_kernel): the Pallas kernel's arithmetic on the
// tensor cores. S = x W^T is bf16 x bf16 -> f32 (mma.sync.m16n8k16 from
// ldmatrix), exact products summed in f32, so the f32 plain version is the
// reference for it; the max, sum of exp and label logit are f32. What bounds
// it besides the tensor cores: every operand is staged through shared
// memory and ldmatrix, and a 128 x 128 tile over 64 columns of H does 64
// flops per byte staged, so L2 must feed the SMs about 10 GB at the
// flagship shape; W (77 MB in bf16) is larger than the 50 MB L2.
//   * a block of 8 warps owns 128 token rows and walks its split's 128-row
//     vocab tiles; each warp owns a 32 x 64 piece of every S tile, 2 m16 x
//     8 n8 mma tiles = 64 f32 accumulators a thread;
//   * x and W stream in 64-column bf16 slices (rows padded by 16 bytes, so
//     ldmatrix is free of bank conflicts) through a 3-stage cp.async ring
//     that runs on across tile boundaries: two slices are in flight while
//     one computes, one barrier a slice, 108 KB of shared memory. Two
//     blocks share an SM (126 registers a thread, no spills): while one
//     waits at its barrier or folds its statistics, the other's mma.sync
//     keep the tensor cores busy (faster than one block an SM: PERF.md,
//     tools/ab_fused_ce.py);
//   * the softmax statistics stay in registers: after each tile every
//     thread folds its fragment into running (m, s, ll) for its 4 rows, m
//     in log2 units so each exp is one exp2f. The 4 lanes of a quad, then
//     the 2 warps that share rows (through shared memory), merge once, at
//     the end of the block, in a fixed order;
//   * the vocab is split over the grid's second dimension, about 16
//     blocks per SM in all (33 splits of 12 tiles at T = 8192: 8 waves of
//     264 blocks), and the grid runs token tiles fastest, so the blocks on
//     the card at one time read the same few W slices and all of x from
//     L2; the combine kernel merges the splits in split order;
//   * ragged T, V and H: rows and columns outside the matrices stage as
//     zeros (cp.async with a source size of 0; element by element where H
//     is not a multiple of 8), and columns past V are left out of the
//     statistics.
//
// f32 K5 (fused_ce_fwd_f32_kernel): S = x W^T in full f32 on the CUDA
// cores (TF32 is off by contract) with the bf16 K5's walk and fused
// epilogue. What bounds it: the FMA units (9.45 ms at the flagship shape),
// if every lane keeps its FMA pipe fed; on the CUDA cores that takes about
// 4 FMAs a word read from shared memory, and L2 must feed the SMs the
// staged slices (32 flops per byte at a 128 x 128 tile, about 20 GB):
//   * a block of 256 threads owns 128 token rows and walks its split's
//     128-row vocab tiles; lane (ty, tx) holds the 8 x 8 tile of rows
//     ty + 16 i and columns tx + 16 j of every S tile in 64 f32
//     accumulators;
//   * x and W stream in 64-column f32 slices through a 3-stage cp.async
//     ring (16-byte copies, rows padded by 4 floats so the float4 reads of
//     8 rows fall in 8 distinct bank groups) that runs on across tile
//     boundaries: two slices in flight while one computes, one barrier a
//     slice (4,096 FMAs a lane), 205 KB of shared memory. One block an SM,
//     250 registers a thread, no spills: two blocks an SM cap a thread at
//     128 registers, where ptxas spills and the kernel ran 12 % slower;
//     32-column slices, with 3 or 4 stages, ran 4-5 % slower (PERF.md,
//     tools/ab_fused_ce.py --f32);
//   * every shared-memory read is a float4 along H: 8 of x and 8 of W feed
//     the 256 FMAs of 4 steps of H, 4 FMAs a word;
//   * the softmax statistics stay in registers: at a tile's end the 16
//     lanes of each row (one half warp) meet by butterfly shuffles on the
//     tile's max and sum of exp (m in log2 units, each exp one exp2f), and
//     lane tx folds them into the running (m, s) of row ty + 16 (tx % 8);
//     the one lane that sees a row's label column writes its logit to
//     shared memory. Shuffles give every lane the same bits, so no order
//     depends on timing;
//   * the vocab is split over the grid's second dimension and the grid
//     runs token tiles fastest, as in the bf16 K5, so the blocks on the
//     card at one time read the same W slices from L2 (W, 154.5 MB in f32,
//     does not fit the 50 MB L2; x, 25.2 MB, does); the combine kernel
//     merges the splits in split order;
//   * ragged T, V and H: rows and columns outside the matrices stage as
//     zeros (cp.async with a source size of 0) and columns past V are left
//     out of the statistics. Where H % 4 != 0 or x or W is not 16-byte
//     aligned, slices stage element by element in the same kernel. No
//     atomics: two runs give the same bits.
//
// f32 K6/K7 (fused_ce_bwd_f32_kernel): the arithmetic of _dtile and the two
// products in full f32 on the CUDA cores. What bounds it besides the FMA
// units: on the CUDA cores a lane's shared-memory loads set the pace (a
// lane needs 4 FMAs a word it reads to keep the FMA pipe fed), so the
// layout is chosen for FMAs per word:
//   * one kernel, two roles, as the bf16 one: a block of 8 warps owns 32
//     rows of A (x rows for K6, W rows for K7) and the 768 columns of
//     out[rows] of one chunk of H (blockIdx.y; a second chunk above H =
//     768), and walks every 16-row tile of B (W for K6, x for K7) in the
//     same order as every other block, so the blocks on the card read the
//     same B tiles from L2;
//   * the accumulator lives in registers: warp w owns out columns 96w ..
//     96w + 95 of all 32 rows, a lane (row group rg = lane / 8, column
//     group cg = lane % 8) the 8 x 12 tile of rows rg + 4i and columns
//     4cg + 32m + e: 96 f32 a thread, written to global memory once, at
//     the end. One block an SM (221,184 B of shared memory, 256 threads);
//   * A is staged once, [32 x 772] f32 (rows padded by 16 bytes), and kept
//     for the whole walk when H is one chunk; each B tile is staged once,
//     [16 x 772], by 16-byte cp.async into the second of two buffers while
//     the current one computes, and the same copy feeds S (along H) and
//     the d-product (across the output columns). Three barriers a tile:
//     staged, S partials written, d written;
//   * S [32 x 16] is split over H across the warps: warp w sums columns
//     96w .. 96w + 95 of the chunk, each half warp (kh = lane / 16) 48 of
//     them, a lane the 8 x 4 tile of A rows lane % 4 + 4i and B rows
//     (lane / 4) % 4 + 4j. The two halves meet by one shuffle a pair of
//     rows (half 0 keeps the even i, half 1 the odd), the 8 warps'
//     partials in shared memory, added in warp order, where every thread
//     makes 2 elements of d (K6: the statistics of its row, in registers;
//     K7: of its columns, staged with the tile) into a [32 x 16] tile;
//   * every shared-memory read is a float4. FMAs per word a lane reads,
//     over 4 steps of the contraction:
//       S           8 x 4 tile: 128 per 48 words (2.7)
//       d-product   8 x 12 tile: 384 per 80 words (4.8)
//     The S layout is 2-3 % faster than 4 x 4 tiles over all 96 columns
//     (2 FMAs a word; PERF.md, tools/ab_fused_ce.py --f32): the loads are
//     not what holds the kernel at half its bound. The S -> d ->
//     d-product phases of each tile are serial, three barriers apart,
//     with one block an SM;
//     Padded rows put each load's distinct words in distinct banks: A and
//     B rows of 772 floats start 4 banks apart, and the S partials and
//     the d tile have rows of 20 floats;
//   * above H = 768 the chunks of H are walked for S with the block's own
//     chunk last (the d-product reads the last B copy staged), and A is
//     staged again at each step, with nothing in flight;
//   * ragged T, V and H: rows and columns outside the matrices stage as
//     zeros (cp.async with a source size of 0) and give d = 0 exactly;
//     ignore_index rows add exactly nothing. Where H % 4 != 0 or x, W or
//     the output is not 16-byte aligned, staging and the final store go
//     element by element in the same kernel. No atomics: two runs give
//     the same bits.
//
// bf16 K6/K7 (fused_ce_bwd_mma_kernel): the Pallas kernels' arithmetic on
// the tensor cores. S = x W_v^T is bf16 x bf16 -> f32; d is made in f32,
// exp included, and rounded to bf16 (fused_ce.py:195, :211); the
// d-product is bf16 x bf16 -> f32; the output is rounded once, at the end.
// Both products are mma.sync.m16n8k16 with operands from ldmatrix.
// What bounds it besides the tensor cores: each block of 32 rows streams
// all of B (W for K6, x for K7) through shared memory, 64 flops per byte
// staged, and every operand reaches the tensor cores through ldmatrix at
// 128 bytes a cycle per SM; mma.sync itself issues below wgmma's rate.
//   * one kernel, two roles: a block owns 32 rows of A (x rows for K6,
//     W rows for K7, so K7 makes d^T directly as the A operand) and the
//     768 columns of out[rows] of one chunk of H (blockIdx.y; a second
//     chunk above H = 768). It walks every 32-row tile of B;
//   * the accumulator lives in registers: 8 warps x 96 columns, each warp
//     2 m16 x 12 n8 mma tiles = 96 f32 a thread (192 registers, one block
//     of 256 threads per SM, about 218 KB of shared memory);
//   * B tiles are staged once, in bf16, as [32 x 776] (rows padded by 16
//     bytes, so the 8 rows an ldmatrix reads fall in 8 distinct bank
//     groups): the same copy feeds S (K = H, ldmatrix) and the d-product
//     (K = 32, ldmatrix.trans). cp.async double-buffers them: the next
//     tile loads while this one computes. A stays resident when H is one
//     chunk;
//   * every chunk is staged 768 columns wide, zeros past H, so both
//     products run fixed, fully unrolled loops;
//   * S [32 x 32] is split over the 8 warps as 4 quarters of K x 2 column
//     halves (4 independent mma chains a warp); the 4 f32 partials meet in
//     shared memory, where every thread makes 4 elements of d (lse, g and
//     label per row for K6, per column for K7, staged with the tile) and
//     writes them as bf16: the A operand of the d-product. Three barriers
//     a tile: staged, S partials written, d written;
//   * above H = 768 the chunks of H are walked for S with the block's own
//     chunk last, so the B copy that the d-product reads is the last one
//     staged;
//   * ragged T, V and H: rows and columns outside the matrices load as
//     zeros (cp.async with a source size of 0; element by element where H
//     is not a multiple of 8) and give d = 0 exactly; ignore_index rows
//     give loss 0 and add exactly nothing to dx or dW. No atomics: two
//     runs give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNeg = -1e30f;

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

// ---- bf16 K6 / K7 on the tensor cores -------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kMR = 32;              // rows of A (and of out) a block owns
constexpr int kNR = 32;              // rows of a B tile: the K of d-product
constexpr int kMThreads = 256;       // 8 warps
constexpr int kHC = 768;             // columns of an H chunk; out columns
constexpr int kWC = kHC / 8;         //   of a block, 96 of them a warp
constexpr int kLD = kHC + 8;         // bf16 row stride of staged A and B
constexpr int kKS = 4;               // warps splitting the K of S
constexpr int kSLD = kNR + 8;        // f32 row stride of the S partials
constexpr int kDLD = kNR + 8;        // bf16 row stride of the d tile
constexpr int kMmaSmem = 2 * kMR * kLD * 2 + 2 * kNR * kLD * 2 +
                         kKS * kMR * kSLD * 4 + kMR * kDLD * 2 +
                         2 * kNR * (4 + 4 + 8);

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

template <int N>
__device__ __forceinline__ void cp_async_small(void* dst, const void* src,
                                               int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "n"(N), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// ---- bf16 K5 on the tensor cores ------------------------------------------

constexpr int kFM = 128;             // token rows of a block
constexpr int kFN = 128;             // vocab rows of a tile
constexpr int kFK = 64;              // columns of H a stage holds
constexpr int kFThreads = 256;       // 8 warps: 4 row bands x 2 column halves
constexpr int kFStages = 3;          // the cp.async ring
constexpr int kFLD = kFK + 8;        // bf16 row stride of a staged slice
constexpr int kFStage = (kFM + kFN) * kFLD;  // bf16 elements a stage
constexpr int kFwdMmaSmem = kFStages * kFStage * 2;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// bf16 K5: one block per (128-row token tile, vocab split). The split's
// 128-row vocab tiles are walked in order; every tile's S = x W^T [128 x
// 128] is accumulated over H in 64-column slices of x and W that stream
// through a kFStages-deep cp.async ring (one barrier a slice), then folded
// into each thread's running max, sum of exp and label logit of its 4
// rows. The lanes of a quad, then the two warps that share rows, merge in
// a fixed order at the end; part[3][nsplit][T] gets the split's (m, s, ll)
// as fused_ce_fwd_f32_kernel writes them. `vec`: H % 8 == 0 and x, w 16-byte
// aligned, so slices stage by cp.async.
template <typename L>
__global__ void __launch_bounds__(kFThreads, 2)
    fused_ce_fwd_mma_kernel(const bf16* __restrict__ x,
                            const bf16* __restrict__ w,
                            const L* __restrict__ labels,
                            float* __restrict__ part, int Tn, int V, int H,
                            int tiles_per_split, int nsplit, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // [kFStages][x | W]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;  // 32-row band, 64-column half
  const int t0 = blockIdx.x * kFM;
  const int split = blockIdx.y;
  const int n_vt = (V + kFN - 1) / kFN;
  const int vt0 = split * tiles_per_split;
  const int vt_end = min(n_vt, vt0 + tiles_per_split);
  const int nk = max(1, (H + kFK - 1) / kFK);
  const int steps = (vt_end - vt0) * nk;

  // step s: columns (s % nk) * 64 .. of the block's x rows and of vocab
  // tile vt0 + s / nk, into ring slot s % kFStages; outside the matrices
  // zero
  auto stage = [&](int s) {
    const int vt = vt0 + s / nk;
    const int k0 = (s % nk) * kFK;
    bf16* bx = ring + (s % kFStages) * kFStage;
    bf16* bw = bx + kFM * kFLD;
    const int v0 = vt * kFN;
    if (vec) {
#pragma unroll
      for (int i = 0; i < kFM * kFK / 8 / kFThreads; ++i) {
        const int idx = tid + i * kFThreads;
        const int r = idx >> 3, c = (idx & 7) * 8;
        const bool kin = k0 + c < H;
        const bool xo = kin && t0 + r < Tn, wo = kin && v0 + r < V;
        cp_async16(bx + r * kFLD + c,
                   xo ? x + (size_t)(t0 + r) * H + k0 + c : x, xo ? 16 : 0);
        cp_async16(bw + r * kFLD + c,
                   wo ? w + (size_t)(v0 + r) * H + k0 + c : w, wo ? 16 : 0);
      }
    } else {
      for (int idx = tid; idx < kFM * kFK; idx += kFThreads) {
        const int r = idx / kFK, c = idx % kFK;
        const bool kin = k0 + c < H;
        bx[r * kFLD + c] = kin && t0 + r < Tn
                               ? x[(size_t)(t0 + r) * H + k0 + c]
                               : __float2bfloat16(0.f);
        bw[r * kFLD + c] = kin && v0 + r < V
                               ? w[(size_t)(v0 + r) * H + k0 + c]
                               : __float2bfloat16(0.f);
      }
    }
  };

  const int lr = lane & 7, lm = lane >> 3;
  const int a_row = lr + (lm & 1) * 8, a_col = (lm >> 1) * 8;
  const int b_row = lr + (lm >> 1) * 8, b_col = (lm & 1) * 8;
  const int gq = lane >> 2, tq = lane & 3;

  // the thread's 4 rows: band row wm * 32 + mi * 16 + gq + 8 h, i = 2 mi + h;
  // a label outside [0, V) (ignore_index included) matches no column
  int lab[4];
  float m[4], s[4], ll[4];  // m in log2 units
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + wm * 32 + (i >> 1) * 16 + gq + (i & 1) * 8;
    const long long raw = t < Tn ? (long long)labels[t] : -1;
    lab[i] = raw >= 0 && raw < V ? (int)raw : -1;
    m[i] = kNeg;
    s[i] = 0.f;
    ll[i] = 0.f;
  }
  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][n][e] = 0.f;

#pragma unroll
  for (int st = 0; st < kFStages - 1; ++st) {
    if (st < steps) stage(st);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kFStages - 2>();
    __syncthreads();  // slice `step` is staged; every warp is past step - 1
    if (step + kFStages - 1 < steps) stage(step + kFStages - 1);
    cp_async_commit();
    const bf16* bx = ring + (step % kFStages) * kFStage;
    const bf16* bw = bx + kFM * kFLD;
#pragma unroll
    for (int kk = 0; kk < kFK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(af[mi], bx + (wm * 32 + mi * 16 + a_row) * kFLD + kk + a_col);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        uint32_t bfr[4];
        ldsm_x4(bfr, bw + (wn * 64 + nb * 16 + b_row) * kFLD + kk + b_col);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * nb], af[mi], bfr[0], bfr[1]);
          mma_bf16(acc[mi][2 * nb + 1], af[mi], bfr[2], bfr[3]);
        }
      }
    }
    if (step % nk != nk - 1) continue;

    // the tile is whole: fold it into (m, s, ll), columns past V left out
    const int c0 = (vt0 + step / nk) * kFN + wn * 64 + 2 * tq;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int mi = i >> 1, h = i & 1;
      float tmax = kNeg;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + n * 8 + e;
          const float val = acc[mi][n][2 * h + e];
          if (col < V) tmax = fmaxf(tmax, val);
          if (col == lab[i]) ll[i] += val;
        }
      const float tmax2 = tmax * kLog2e;
      if (tmax2 > m[i]) {
        s[i] *= exp2f(m[i] - tmax2);
        m[i] = tmax2;
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (c0 + n * 8 + e < V)
            s[i] += exp2f(fmaf(acc[mi][n][2 * h + e], kLog2e, -m[i]));
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][n][e] = 0.f;
  }

  // merge: the quad's lanes (butterfly), then the two column halves
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float os = __shfl_xor_sync(0xffffffffu, s[i], off);
      const float ol = __shfl_xor_sync(0xffffffffu, ll[i], off);
      const float nm = fmaxf(m[i], om);
      s[i] = s[i] * exp2f(m[i] - nm) + os * exp2f(om - nm);
      m[i] = nm;
      ll[i] += ol;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the halves' statistics
  float* sm = reinterpret_cast<float*>(smem_raw);  // [3][2][kFM]
  if (tq == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = wm * 32 + (i >> 1) * 16 + gq + (i & 1) * 8;
      sm[(0 * 2 + wn) * kFM + r] = m[i];
      sm[(1 * 2 + wn) * kFM + r] = s[i];
      sm[(2 * 2 + wn) * kFM + r] = ll[i];
    }
  }
  __syncthreads();
  if (tid < kFM && t0 + tid < Tn) {
    const int r = tid, t = t0 + tid;
    const float m0 = sm[0 * kFM + r], m1 = sm[1 * kFM + r];
    const float nm = fmaxf(m0, m1);
    const float sv = sm[2 * kFM + r] * exp2f(m0 - nm) +
                     sm[3 * kFM + r] * exp2f(m1 - nm);
    part[((size_t)0 * nsplit + split) * Tn + t] = nm * kLn2;
    part[((size_t)1 * nsplit + split) * Tn + t] = sv;
    part[((size_t)2 * nsplit + split) * Tn + t] =
        sm[4 * kFM + r] + sm[5 * kFM + r];
  }
}

// ---- f32 K5 on the CUDA cores ---------------------------------------------

constexpr int kPM = 128;             // token rows of a block
constexpr int kPN = 128;             // vocab rows of a tile
constexpr int kPThreads = 256;       // 16 x 16 lanes, an 8 x 8 piece each
constexpr int kPK = 64;              // columns of H a stage holds
constexpr int kPStages = 3;          // the cp.async ring
constexpr int kPLD = kPK + 4;        // f32 row stride of a staged slice
constexpr int kPStage = (kPM + kPN) * kPLD;  // floats a stage
constexpr int kFwdF32Smem = (kPStages * kPStage + 2 * kPM) * 4;
static_assert(kPM == 16 * 8 && kPN == 16 * 8, "16 lanes of 8 rows a side");

// f32 K5: one block per (128-row token tile, vocab split), the bf16 K5's
// walk on the CUDA cores. The split's 128-row vocab tiles are walked in
// order; every tile's S = x W^T [128 x 128] is summed over H in 64-column
// slices of x and W that stream through a kPStages-deep cp.async ring
// (one barrier a slice). Lane (ty, tx) = (tid / 16, tid % 16) owns the
// 8 x 8 piece of rows ty + 16 i and columns tx + 16 j. At a tile's end the
// 16 lanes of a row (a half warp) meet by shuffles on the tile's max and
// sum of exp, and lane tx folds them into the running (m, s) of row
// ty + 16 (tx % 8); the one lane that holds a row's label column writes
// its logit to shared memory. part[3][nsplit][T] gets the split's (m, s,
// ll) as the bf16 K5 writes them. `vec`: H % 4 == 0 and x, w 16-byte
// aligned, so slices stage by cp.async.
template <typename L>
__global__ void __launch_bounds__(kPThreads, 1)
    fused_ce_fwd_f32_kernel(const float* __restrict__ x,
                            const float* __restrict__ w,
                            const L* __restrict__ labels,
                            float* __restrict__ part, int Tn, int V, int H,
                            int tiles_per_split, int nsplit, int vec) {
  extern __shared__ __align__(16) float psm[];
  float* ring = psm;                               // [kPStages][x | W]
  float* sLL = psm + kPStages * kPStage;           // [kPM] label logits
  int* sLab = reinterpret_cast<int*>(sLL + kPM);   // [kPM] labels in [0, V)

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int t0 = blockIdx.x * kPM;
  const int split = blockIdx.y;
  const int n_vt = (V + kPN - 1) / kPN;
  const int vt0 = split * tiles_per_split;
  const int vt_end = min(n_vt, vt0 + tiles_per_split);
  const int nk = max(1, (H + kPK - 1) / kPK);
  const int steps = max(0, vt_end - vt0) * nk;

  // step s: columns (s % nk) * kPK .. of the block's x rows and of vocab
  // tile vt0 + s / nk, into ring slot s % kPStages; outside the matrices
  // zero
  auto stage = [&](int s) {
    const int k0 = (s % nk) * kPK;
    const int v0 = (vt0 + s / nk) * kPN;
    float* bx = ring + (s % kPStages) * kPStage;
    float* bw = bx + kPM * kPLD;
    if (vec) {
#pragma unroll
      for (int i = 0; i < kPM * kPK / 4 / kPThreads; ++i) {
        const int idx = tid + i * kPThreads;
        const int r = idx / (kPK / 4), c = (idx % (kPK / 4)) * 4;
        const bool kin = k0 + c < H;
        const bool xo = kin && t0 + r < Tn, wo = kin && v0 + r < V;
        cp_async16(bx + r * kPLD + c,
                   xo ? x + (size_t)(t0 + r) * H + k0 + c : x, xo ? 16 : 0);
        cp_async16(bw + r * kPLD + c,
                   wo ? w + (size_t)(v0 + r) * H + k0 + c : w, wo ? 16 : 0);
      }
    } else {
      for (int idx = tid; idx < kPM * kPK; idx += kPThreads) {
        const int r = idx / kPK, c = idx % kPK;
        const bool kin = k0 + c < H;
        bx[r * kPLD + c] =
            kin && t0 + r < Tn ? x[(size_t)(t0 + r) * H + k0 + c] : 0.f;
        bw[r * kPLD + c] =
            kin && v0 + r < V ? w[(size_t)(v0 + r) * H + k0 + c] : 0.f;
      }
    }
  };

  // a label outside [0, V) (ignore_index included) matches no column
  if (tid < kPM) {
    const long long raw = t0 + tid < Tn ? (long long)labels[t0 + tid] : -1;
    sLab[tid] = raw >= 0 && raw < V ? (int)raw : -1;
    sLL[tid] = 0.f;
  }
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float m_run = kNeg, s_run = 0.f;  // row ty + 16 (tx % 8); m in log2 units

#pragma unroll
  for (int st = 0; st < kPStages - 1; ++st) {
    if (st < steps) stage(st);
    cp_async_commit();
  }
  const float* px0 = ring + ty * kPLD;
  const float* pw0 = ring + (kPM + tx) * kPLD;
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kPStages - 2>();
    __syncthreads();  // slice `step` is staged; every warp is past step - 1
    if (step + kPStages - 1 < steps) stage(step + kPStages - 1);
    cp_async_commit();
    const float* px = px0 + (step % kPStages) * kPStage;
    const float* pw = pw0 + (step % kPStages) * kPStage;
    // float4 reads along H: 8 of x and 8 of W feed 256 FMAs (4 a word)
#pragma unroll
    for (int kk = 0; kk < kPK; kk += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(px + 16 * i * kPLD + kk);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 b =
            *reinterpret_cast<const float4*>(pw + 16 * j * kPLD + kk);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
        }
      }
    }
    if (step % nk != nk - 1) continue;

    // the tile is whole: each row's max and sum of exp over its 128
    // columns (past V left out), the 16 lanes meeting by shuffles
    const int c0 = (vt0 + step / nk) * kPN + tx;
    float tm = kNeg, tp = 0.f;  // the tile's of row ty + 16 (tx % 8)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int lab = sLab[ty + 16 * i];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (c0 + 16 * j < V) mx = fmaxf(mx, acc[i][j]);
        if (c0 + 16 * j == lab) sLL[ty + 16 * i] = acc[i][j];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mx2 = mx * kLog2e;
      float p = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (c0 + 16 * j < V) p += exp2f(fmaf(acc[i][j], kLog2e, -mx2));
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, o);
      if (i == (tx & 7)) {
        tm = mx2;
        tp = p;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    const float nm = fmaxf(m_run, tm);
    s_run = s_run * exp2f(m_run - nm) + tp * exp2f(tm - nm);
    m_run = nm;
  }

  cp_async_wait<0>();
  __syncthreads();  // every label logit is written
  if (tx < 8 && t0 + ty + 16 * tx < Tn) {
    const int r = ty + 16 * tx, t = t0 + r;
    part[((size_t)0 * nsplit + split) * Tn + t] = m_run * kLn2;
    part[((size_t)1 * nsplit + split) * Tn + t] = s_run;
    part[((size_t)2 * nsplit + split) * Tn + t] = sLL[r];
  }
}

// bf16 K6 (TOK_A: A = x, B = W, out = dx) and K7 (A = W, B = x, out = dW).
// One block per (32 rows of A, 768-column chunk `own` of H). For every
// 32-row tile of B:  S = A_rows B_tile^T over all of H,
//   d = bf16((exp(S - lse) - onehot) g valid),  acc += d B_tile[:, own].
// `vec`: H % 8 == 0 and A, B 16-byte aligned, so rows stage by cp.async.
template <typename L, bool TOK_A>
__global__ void __launch_bounds__(kMThreads, 1)
    fused_ce_bwd_mma_kernel(const bf16* __restrict__ A,
                            const bf16* __restrict__ B,
                            const L* __restrict__ labels,
                            const float* __restrict__ lse,
                            const float* __restrict__ g,
                            bf16* __restrict__ out, int na, int nb, int H,
                            long long ignore_index, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sA = reinterpret_cast<bf16*>(smem_raw);            // [2][kMR][kLD]
  bf16* sB = sA + 2 * kMR * kLD;                           // [2][kNR][kLD]
  float* sS = reinterpret_cast<float*>(sB + 2 * kNR * kLD);  // [kKS][kMR][kSLD]
  bf16* sD = reinterpret_cast<bf16*>(sS + kKS * kMR * kSLD);  // [kMR][kDLD]
  float* sLse = reinterpret_cast<float*>(sD + kMR * kDLD);    // [2][kNR]
  float* sG = sLse + 2 * kNR;                                 // [2][kNR]
  L* sLab = reinterpret_cast<L*>(sG + 2 * kNR);               // [2][kNR]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int a0 = blockIdx.x * kMR;
  const int own = blockIdx.y;
  const int nch = (H + kHC - 1) / kHC;
  const int steps = (nb + kNR - 1) / kNR * nch;
  const int n_tok = TOK_A ? na : nb;

  // 32 rows from r0 of a row-major [n, H] matrix, the 768 columns of
  // chunk c, into dst (row stride kLD); outside the matrix zero
  auto stage_rows = [&](bf16* dst, const bf16* src, int r0, int n, int c) {
    const int k0 = c * kHC;
    const int hc = min(kHC, H - k0);
    if (vec) {  // a warp a row at a time, a lane 16 bytes
      for (int r = warp; r < kMR; r += kMThreads / 32) {
        const bool row_ok = r0 + r < n;
        const bf16* row = src + (size_t)(row_ok ? r0 + r : 0) * H + k0;
        for (int k = lane * 8; k < kHC; k += 256) {
          const bool ok = row_ok && k < hc;
          cp_async16(dst + r * kLD + k, ok ? row + k : src, ok ? 16 : 0);
        }
      }
    } else {
      for (int idx = tid; idx < kMR * kHC; idx += kMThreads) {
        const int r = idx / kHC, k = idx - r * kHC;
        dst[r * kLD + k] = (r0 + r < n && k < hc)
                               ? src[(size_t)(r0 + r) * H + k0 + k]
                               : __float2bfloat16(0.f);
      }
    }
  };
  // lse, g and label of the 32 tokens from t0 into statistics slot `slot`
  auto stage_stats = [&](int slot, int t0) {
    if (tid < kNR) {
      const bool ok = t0 + tid < n_tok;
      const int t = ok ? t0 + tid : 0;
      cp_async_small<4>(sLse + slot * kNR + tid, lse + t, ok ? 4 : 0);
      cp_async_small<4>(sG + slot * kNR + tid, g + t, ok ? 4 : 0);
      cp_async_small<(int)sizeof(L)>(sLab + slot * kNR + tid, labels + t,
                                     ok ? (int)sizeof(L) : 0);
    }
  };
  // step s = (B tile s / nch, the (s % nch)-th chunk of H in the order
  // own + 1, own + 2, ..., own): stage it into buffer s & 1. A is staged
  // once when H is one chunk, with every step otherwise.
  auto stage = [&](int s) {
    const int bt = s / nch, i = s - bt * nch;
    const int c = (own + 1 + i) % nch;
    if (nch > 1 || s == 0)
      stage_rows(sA + (nch > 1 ? (s & 1) : 0) * kMR * kLD, A, a0, na, c);
    stage_rows(sB + (s & 1) * kNR * kLD, B, bt * kNR, nb, c);
    if (!TOK_A && i == 0) stage_stats(bt & 1, bt * kNR);
    if (TOK_A && s == 0) stage_stats(0, a0);
    cp_async_commit();
  };

  // ldmatrix row addresses of this lane: for an A operand (rows m,
  // contiguous k) and, the same offsets, for the d-product's B operand
  // through .trans (rows k, contiguous n); S's B operand is rows n,
  // contiguous k with the matrices in the other order
  const int lr = lane & 7, lm = lane >> 3;
  const int a_row = lr + (lm & 1) * 8, a_col = (lm >> 1) * 8;
  const int b_row = lr + (lm >> 1) * 8, b_col = (lm & 1) * 8;
  const int gq = lane >> 2, tq = lane & 3;  // accumulator row, column pair
  const int kq = warp >> 1, nh = warp & 1;  // S: K quarter, column half

  float acc[2][12][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 12; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
  float sacc[2][2][4];

  stage(0);
  for (int s = 0; s < steps; ++s) {
    const int bt = s / nch, i = s - bt * nch;
    cp_async_wait<0>();
    __syncthreads();  // step s is staged; every warp is past step s - 1
    if (s + 1 < steps) stage(s + 1);  // into step s - 1's buffers
    const bf16* cA = sA + (nch > 1 ? (s & 1) : 0) * kMR * kLD;
    const bf16* cB = sB + (s & 1) * kNR * kLD;

    if (i == 0) {
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[m][n][e] = 0.f;
    }
#pragma unroll
    for (int k = kq * 16; k < kHC; k += kKS * 16) {
      uint32_t af[2][4], bfr[4];
      ldsm_x4(af[0], cA + a_row * kLD + k + a_col);
      ldsm_x4(af[1], cA + (16 + a_row) * kLD + k + a_col);
      ldsm_x4(bfr, cB + (nh * 16 + b_row) * kLD + k + b_col);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        mma_bf16(sacc[m][0], af[m], bfr[0], bfr[1]);
        mma_bf16(sacc[m][1], af[m], bfr[2], bfr[3]);
      }
    }
    if (i < nch - 1) continue;

    // the tile's S: this warp's partial [32 x 16] into shared memory
    float* part = sS + kq * kMR * kSLD;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float* p = part + (m * 16 + gq) * kSLD + nh * 16 + n * 8 + 2 * tq;
        *reinterpret_cast<float2*>(p) =
            make_float2(sacc[m][n][0], sacc[m][n][1]);
        *reinterpret_cast<float2*>(p + 8 * kSLD) =
            make_float2(sacc[m][n][2], sacc[m][n][3]);
      }
    __syncthreads();

    // d: thread owns row r, columns c4 .. c4 + 3; partials summed in order
    {
      const int r = tid >> 3, c4 = (tid & 7) * 4;
      float4 sv = *reinterpret_cast<const float4*>(sS + r * kSLD + c4);
#pragma unroll
      for (int q = 1; q < kKS; ++q) {
        const float4 o = *reinterpret_cast<const float4*>(
            sS + (q * kMR + r) * kSLD + c4);
        sv.x += o.x;
        sv.y += o.y;
        sv.z += o.z;
        sv.w += o.w;
      }
      const float sj[4] = {sv.x, sv.y, sv.z, sv.w};
      float dv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ra = a0 + r, rb = bt * kNR + c4 + j;
        // the token's statistics: of row r (K6) or of column c4 + j (K7)
        const int at = TOK_A ? r : (bt & 1) * kNR + c4 + j;
        float d = 0.f;
        if (ra < na && rb < nb) {
          const long long lab = (long long)sLab[at];
          const long long v = TOK_A ? rb : ra;
          if (lab != ignore_index)
            d = (expf(sj[j] - sLse[at]) - (v == lab ? 1.f : 0.f)) * sG[at];
        }
        dv[j] = d;
      }
      // rounded to bf16 (to nearest even), as the Pallas kernels round d
      __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(sD + r * kDLD + c4);
      q[0] = __floats2bfloat162_rn(dv[0], dv[1]);
      q[1] = __floats2bfloat162_rn(dv[2], dv[3]);
    }
    __syncthreads();

    // acc[32 x this warp's 96 columns] += d [32 x 32] B_tile[32 x cols]
    const int col0 = warp * kWC;
#pragma unroll
    for (int k = 0; k < kNR; k += 16) {
      uint32_t af[2][4];
      ldsm_x4(af[0], sD + a_row * kDLD + k + a_col);
      ldsm_x4(af[1], sD + (16 + a_row) * kDLD + k + a_col);
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        uint32_t bfr[4];
        ldsm_x4_t(bfr, cB + (k + a_row) * kLD + col0 + j * 16 + a_col);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma_bf16(acc[m][2 * j], af[m], bfr[0], bfr[1]);
          mma_bf16(acc[m][2 * j + 1], af[m], bfr[2], bfr[3]);
        }
      }
    }
  }

  // out, rounded once
  const int h0 = own * kHC + warp * kWC + 2 * tq;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int a = a0 + m * 16 + gq + half * 8;
      if (a >= na) continue;
#pragma unroll
      for (int n = 0; n < 12; ++n) {
        const int h = h0 + n * 8;
        if (h < H)
          out[(size_t)a * H + h] = __float2bfloat16(acc[m][n][2 * half]);
        if (h + 1 < H)
          out[(size_t)a * H + h + 1] =
              __float2bfloat16(acc[m][n][2 * half + 1]);
      }
    }
}

// ---- f32 K6 / K7 on the CUDA cores ----------------------------------------

constexpr int kGR = 32;              // rows of A (and of out) a block owns
constexpr int kGN = 16;              // rows of a B tile: the K of d-product
constexpr int kGThreads = 256;       // 8 warps
constexpr int kGH = 768;             // columns of an H chunk; out columns
constexpr int kGW = kGH / 8;         //   of a block, 96 of them a warp
constexpr int kGLD = kGH + 4;        // f32 row stride of staged A and B
constexpr int kGPLD = kGN + 4;       // row stride of the S partials and d
constexpr int kGSmem = (kGR * kGLD + 2 * kGN * kGLD + 8 * kGR * kGPLD +
                        kGR * kGPLD + 4 * kGN) * 4 + 2 * kGN * 8;

__device__ __forceinline__ float f4_at(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// f32 K6 (TOK_A: A = x, B = W, out = dx) and K7 (A = W, B = x, out = dW).
// One block per (32 rows of A, 768-column chunk `own` of H). For every
// 16-row tile of B:  S = A_rows B_tile^T over all of H,
//   d = (exp(S - lse) - onehot) g valid,  acc += d B_tile[:, own].
// `vec`: H % 4 == 0 and A, B, out 16-byte aligned, so rows stage by
// cp.async and out is stored by float4.
template <typename L, bool TOK_A>
__global__ void __launch_bounds__(kGThreads, 1)
    fused_ce_bwd_f32_kernel(const float* __restrict__ A,
                            const float* __restrict__ B,
                            const L* __restrict__ labels,
                            const float* __restrict__ lse,
                            const float* __restrict__ g,
                            float* __restrict__ out, int na, int nb, int H,
                            long long ignore_index, int vec) {
  extern __shared__ __align__(16) float gsm[];
  float* sA = gsm;                     // [kGR][kGLD]
  float* sB = sA + kGR * kGLD;         // [2][kGN][kGLD]
  float* sP = sB + 2 * kGN * kGLD;     // [8 warps][kGR][kGPLD]
  float* sD = sP + 8 * kGR * kGPLD;    // [kGR][kGPLD]
  float* sLse = sD + kGR * kGPLD;      // [2][kGN]
  float* sG = sLse + 2 * kGN;          // [2][kGN]
  L* sLab = reinterpret_cast<L*>(sG + 2 * kGN);  // [2][kGN]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int a0 = blockIdx.x * kGR;
  const int own = blockIdx.y;
  const int nch = (H + kGH - 1) / kGH;
  const int steps = (nb + kGN - 1) / kGN * nch;
  const int kw = warp * kGW;  // the warp's slice of a chunk: S and out

  // `rows` rows from r0 of a row-major [n, H] matrix, the 768 columns of
  // chunk c, into dst (row stride kGLD); outside the matrix zero
  auto stage_rows = [&](float* dst, const float* src, int r0, int rows,
                        int n, int c) {
    const int k0 = c * kGH;
    const int hc = min(kGH, H - k0);
    if (vec) {
      for (int idx = tid; idx < rows * (kGH / 4); idx += kGThreads) {
        const int r = idx / (kGH / 4), k = (idx - r * (kGH / 4)) * 4;
        const bool ok = r0 + r < n && k < hc;
        cp_async16(dst + r * kGLD + k,
                   ok ? src + (size_t)(r0 + r) * H + k0 + k : src,
                   ok ? 16 : 0);
      }
    } else {
      for (int idx = tid; idx < rows * kGH; idx += kGThreads) {
        const int r = idx / kGH, k = idx - r * kGH;
        dst[r * kGLD + k] = (r0 + r < n && k < hc)
                                ? src[(size_t)(r0 + r) * H + k0 + k]
                                : 0.f;
      }
    }
  };
  // step s = (B tile s / nch, the (s % nch)-th chunk of H in the order
  // own + 1, own + 2, ..., own): its B rows into buffer s & 1 and, at a
  // tile's first step of K7, the tile's 16 tokens' lse, g and label into
  // statistics slot (s / nch) & 1
  auto stage = [&](int s) {
    const int bt = s / nch, i = s - bt * nch;
    stage_rows(sB + (s & 1) * kGN * kGLD, B, bt * kGN, kGN, nb,
               (own + 1 + i) % nch);
    if (!TOK_A && i == 0 && tid < kGN) {
      const int t0 = bt * kGN, slot = bt & 1;
      const bool ok = t0 + tid < nb;
      const int t = ok ? t0 + tid : 0;
      cp_async_small<4>(sLse + slot * kGN + tid, lse + t, ok ? 4 : 0);
      cp_async_small<4>(sG + slot * kGN + tid, g + t, ok ? 4 : 0);
      cp_async_small<(int)sizeof(L)>(sLab + slot * kGN + tid, labels + t,
                                     ok ? (int)sizeof(L) : 0);
    }
    cp_async_commit();
  };

  // d: thread tid makes row dr, columns dc, dc + 1 of every d tile. K6
  // keeps its row's statistics in registers (a row past T gets d = 0)
  const int dr = tid >> 3, dc = (tid & 7) * 2;
  long long my_lab = 0;
  float my_lse = 0.f, my_g = 0.f;
  if (TOK_A && a0 + dr < na) {
    my_lab = (long long)labels[a0 + dr];
    my_lse = lse[a0 + dr];
    my_g = g[a0 + dr];
  }

  // S: half kh of the warp's 96 columns; A rows sa + 4i, B rows sb + 4j
  const int kh = lane >> 4, sa = lane & 3, sb = (lane >> 2) & 3;
  const int rg = lane >> 3, cg = lane & 7;  // out: rows rg + 4i, cols 4cg..

  float acc[8][12];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 12; ++c) acc[i][c] = 0.f;
  float sacc[8][4];

  if (nch == 1) stage_rows(sA, A, a0, kGR, na, 0);  // once, for the walk
  stage(0);
  for (int s = 0; s < steps; ++s) {
    const int bt = s / nch, i = s - bt * nch;
    const int c = (own + 1 + i) % nch;
    const int hc = min(kGH, H - c * kGH);
    cp_async_wait<0>();
    __syncthreads();  // step s is staged; every warp is past step s - 1
    if (nch > 1) {    // A's chunk c, with nothing else in flight
      stage_rows(sA, A, a0, kGR, na, c);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    if (s + 1 < steps) stage(s + 1);  // into step s - 1's buffer
    const float* cB = sB + (s & 1) * kGN * kGLD;

    if (i == 0) {
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) sacc[a][b] = 0.f;
    }
    if (kw + 48 * kh < hc) {  // columns past H are zeros: skip them
      const float* pa = sA + sa * kGLD + kw + 48 * kh;
      const float* pb = cB + sb * kGLD + kw + 48 * kh;
#pragma unroll 4
      for (int k = 0; k < kGW / 2; k += 4) {
        float4 av[8], bv[4];
#pragma unroll
        for (int a = 0; a < 8; ++a)
          av[a] = *reinterpret_cast<const float4*>(pa + 4 * a * kGLD + k);
#pragma unroll
        for (int b = 0; b < 4; ++b)
          bv[b] = *reinterpret_cast<const float4*>(pb + 4 * b * kGLD + k);
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            sacc[a][b] = fmaf(av[a].x, bv[b].x, sacc[a][b]);
            sacc[a][b] = fmaf(av[a].y, bv[b].y, sacc[a][b]);
            sacc[a][b] = fmaf(av[a].z, bv[b].z, sacc[a][b]);
            sacc[a][b] = fmaf(av[a].w, bv[b].w, sacc[a][b]);
          }
      }
    }
    if (i < nch - 1) continue;

    // the two halves meet: half 0 keeps rows sa + 8i', half 1 rows
    // sa + 4 + 8i'; then this warp's partial [32 x 16] into shared memory
    float* part = sP + warp * kGR * kGPLD;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float keep = kh ? sacc[2 * a + 1][b] : sacc[2 * a][b];
        const float give = kh ? sacc[2 * a][b] : sacc[2 * a + 1][b];
        part[(sa + 4 * kh + 8 * a) * kGPLD + sb + 4 * b] =
            keep + __shfl_xor_sync(0xffffffffu, give, 16);
      }
    __syncthreads();

    // d: the partials summed in warp order
    {
      float2 sv = *reinterpret_cast<const float2*>(sP + dr * kGPLD + dc);
#pragma unroll
      for (int w = 1; w < 8; ++w) {
        const float2 o = *reinterpret_cast<const float2*>(
            sP + (w * kGR + dr) * kGPLD + dc);
        sv.x += o.x;
        sv.y += o.y;
      }
      const float sj[2] = {sv.x, sv.y};
      float dv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ra = a0 + dr, rb = bt * kGN + dc + e;
        // the token's statistics: of row dr (K6) or of column dc + e (K7)
        const int at = (bt & 1) * kGN + dc + e;
        const long long lab = TOK_A ? my_lab : (long long)sLab[at];
        const float l = TOK_A ? my_lse : sLse[at];
        const float gv = TOK_A ? my_g : sG[at];
        const long long v = TOK_A ? rb : ra;
        float d = 0.f;
        if (ra < na && rb < nb && lab != ignore_index)
          d = (expf(sj[e] - l) - (v == lab ? 1.f : 0.f)) * gv;
        dv[e] = d;
      }
      *reinterpret_cast<float2*>(sD + dr * kGPLD + dc) =
          make_float2(dv[0], dv[1]);
    }
    __syncthreads();

    // acc[8 rows x 12 columns] += d [32 x 16] B_tile[16 x this warp's 96]
    if (kw < hc) {
      const float* pd = sD + rg * kGPLD;
      const float* pw = cB + kw + 4 * cg;
#pragma unroll
      for (int k = 0; k < kGN; k += 4) {
        float4 dv[8];
#pragma unroll
        for (int a = 0; a < 8; ++a)
          dv[a] = *reinterpret_cast<const float4*>(pd + 4 * a * kGPLD + k);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float4 wv[3];
#pragma unroll
          for (int m = 0; m < 3; ++m)
            wv[m] = *reinterpret_cast<const float4*>(pw + (k + e) * kGLD +
                                                     32 * m);
#pragma unroll
          for (int a = 0; a < 8; ++a) {
            const float x = f4_at(dv[a], e);
#pragma unroll
            for (int m = 0; m < 3; ++m) {
              acc[a][4 * m] = fmaf(x, wv[m].x, acc[a][4 * m]);
              acc[a][4 * m + 1] = fmaf(x, wv[m].y, acc[a][4 * m + 1]);
              acc[a][4 * m + 2] = fmaf(x, wv[m].z, acc[a][4 * m + 2]);
              acc[a][4 * m + 3] = fmaf(x, wv[m].w, acc[a][4 * m + 3]);
            }
          }
        }
      }
    }
  }

  // out, once: rows rg + 4i, columns own * 768 + 96 warp + 4 cg + 32 m + e
  const int h0 = own * kGH + kw + 4 * cg;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int row = a0 + rg + 4 * a;
    if (row >= na) continue;
    float* o = out + (size_t)row * H;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const int h = h0 + 32 * m;
      if (vec) {
        if (h < H)
          *reinterpret_cast<float4*>(o + h) =
              make_float4(acc[a][4 * m], acc[a][4 * m + 1],
                          acc[a][4 * m + 2], acc[a][4 * m + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (h + e < H) o[h + e] = acc[a][4 * m + e];
      }
    }
  }
}

// above 48 KB a block must opt in to dynamic shared memory; the largest
// carveout leaves room for one block an SM
template <typename L>
cudaError_t prepare_fwd_f32() {
  cudaError_t err = cudaFuncSetAttribute(
      fused_ce_fwd_f32_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kFwdF32Smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fused_ce_fwd_f32_kernel<L>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename L>
int launch_fwd(const void* x, const void* w, const void* labels, float* part,
               float* loss, float* lse, int Tn, int V, int H, int nsplit,
               int tiles_per_split, long long ignore_index, cudaStream_t st) {
  cudaError_t err = prepare_fwd_f32<L>();
  if (err != cudaSuccess) return (int)err;
  const L* lab = static_cast<const L*>(labels);
  const int vec = H % 4 == 0 && (reinterpret_cast<uintptr_t>(x) |
                                  reinterpret_cast<uintptr_t>(w)) % 16 == 0;
  dim3 grid((Tn + kPM - 1) / kPM, nsplit);
  fused_ce_fwd_f32_kernel<L><<<grid, kPThreads, kFwdF32Smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), lab, part,
      Tn, V, H, tiles_per_split, nsplit, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_ce_fwd_combine<L><<<(Tn + 255) / 256, 256, 0, st>>>(
      part, lab, loss, lse, Tn, nsplit, ignore_index);
  return 0;
}

template <typename L>
int launch_fwd_mma(const void* x, const void* w, const void* labels,
                   float* part, float* loss, float* lse, int Tn, int V, int H,
                   int nsplit, int tiles_per_split, long long ignore_index,
                   cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_ce_fwd_mma_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kFwdMmaSmem);
  if (err != cudaSuccess) return (int)err;
  const L* lab = static_cast<const L*>(labels);
  const int vec = H % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(w) % 16 == 0;
  dim3 grid((Tn + kFM - 1) / kFM, nsplit);
  fused_ce_fwd_mma_kernel<L><<<grid, kFThreads, kFwdMmaSmem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), lab, part, Tn,
      V, H, tiles_per_split, nsplit, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_ce_fwd_combine<L><<<(Tn + 255) / 256, 256, 0, st>>>(
      part, lab, loss, lse, Tn, nsplit, ignore_index);
  return 0;
}

// above 48 KB a block must opt in to dynamic shared memory; the largest
// carveout leaves room for one block an SM
template <typename L, bool TOK_A>
cudaError_t prepare_bwd_f32() {
  cudaError_t err = cudaFuncSetAttribute(
      fused_ce_bwd_f32_kernel<L, TOK_A>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kGSmem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fused_ce_bwd_f32_kernel<L, TOK_A>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename L, bool TOK_A>
int launch_bwd_f32(const void* a, const void* b, const void* labels,
                   const float* lse, const float* g, void* out, int na,
                   int nb, int H, long long ignore_index, cudaStream_t st) {
  cudaError_t err = prepare_bwd_f32<L, TOK_A>();
  if (err != cudaSuccess) return (int)err;
  const int vec = H % 4 == 0 &&
                  (reinterpret_cast<uintptr_t>(a) |
                   reinterpret_cast<uintptr_t>(b) |
                   reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  dim3 grid((na + kGR - 1) / kGR, (H + kGH - 1) / kGH);
  fused_ce_bwd_f32_kernel<L, TOK_A><<<grid, kGThreads, kGSmem, st>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const L*>(labels), lse, g, static_cast<float*>(out), na,
      nb, H, ignore_index, vec);
  return 0;
}

template <typename L, bool TOK_A>
int launch_bwd_mma(const void* a, const void* b, const void* labels,
                   const float* lse, const float* g, void* out, int na,
                   int nb, int H, long long ignore_index, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_ce_bwd_mma_kernel<L, TOK_A>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMmaSmem);
  if (err != cudaSuccess) return (int)err;
  const int vec = H % 8 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(b) % 16 == 0;
  dim3 grid((na + kMR - 1) / kMR, (H + kHC - 1) / kHC);
  fused_ce_bwd_mma_kernel<L, TOK_A><<<grid, kMThreads, kMmaSmem, st>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<const L*>(labels), lse, g, static_cast<bf16*>(out), na, nb,
      H, ignore_index, vec);
  return 0;
}

// bf16 to the tensor-core kernel, f32 to the CUDA-core one
template <typename T, typename L, bool TOK_A>
int launch_bwd_for(const void* a, const void* b, const void* labels,
                   const float* lse, const float* g, void* out, int na,
                   int nb, int H, long long ignore_index, cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value)
    return launch_bwd_mma<L, TOK_A>(a, b, labels, lse, g, out, na, nb, H,
                                    ignore_index, st);
  else
    return launch_bwd_f32<L, TOK_A>(a, b, labels, lse, g, out, na, nb, H,
                                    ignore_index, st);
}

template <typename T, bool TOK_A>
int bwd_by_label(const void* a, const void* b, const void* labels,
                 const float* lse, const float* g, void* out, int na, int nb,
                 int H, long long ignore_index, int label_dtype,
                 cudaStream_t st) {
  if (label_dtype == 0)
    return launch_bwd_for<T, int32_t, TOK_A>(a, b, labels, lse, g, out, na,
                                             nb, H, ignore_index, st);
  if (label_dtype == 1)
    return launch_bwd_for<T, int64_t, TOK_A>(a, b, labels, lse, g, out, na,
                                             nb, H, ignore_index, st);
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
// groups of `tiles_per_split` tiles of 128 vocab rows (both dtypes)
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
    bad = launch_fwd<int32_t>(x, w, labels, p, lo, ls, T, V, H, nsplit,
                              tiles_per_split, ignore_index, st);
  else if (dtype == 0 && label_dtype == 1)
    bad = launch_fwd<int64_t>(x, w, labels, p, lo, ls, T, V, H, nsplit,
                              tiles_per_split, ignore_index, st);
  else if (dtype == 1 && label_dtype == 0)
    bad = launch_fwd_mma<int32_t>(x, w, labels, p, lo, ls, T, V, H, nsplit,
                                  tiles_per_split, ignore_index, st);
  else if (dtype == 1 && label_dtype == 1)
    bad = launch_fwd_mma<int64_t>(x, w, labels, p, lo, ls, T, V, H, nsplit,
                                  tiles_per_split, ignore_index, st);
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

// Blocks an SM of the f32 K6 (dx = 1) or K7 (dx = 0), from their registers
// and shared memory; -1 on a CUDA error.
extern "C" int fused_ce_backward_f32_blocks_per_sm(int dx) {
  int n = -1;
  cudaError_t err = dx ? prepare_bwd_f32<int64_t, true>()
                       : prepare_bwd_f32<int64_t, false>();
  if (err != cudaSuccess) return -1;
  err = dx ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &n, fused_ce_bwd_f32_kernel<int64_t, true>, kGThreads,
                 kGSmem)
           : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &n, fused_ce_bwd_f32_kernel<int64_t, false>, kGThreads,
                 kGSmem);
  return err == cudaSuccess ? n : -1;
}

// Blocks an SM of the f32 K5, from its registers and shared memory; -1 on
// a CUDA error.
extern "C" int fused_ce_forward_f32_blocks_per_sm() {
  int n = -1;
  if (prepare_fwd_f32<int64_t>() != cudaSuccess) return -1;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, fused_ce_fwd_f32_kernel<int64_t>, kPThreads, kFwdF32Smem);
  return err == cudaSuccess ? n : -1;
}
