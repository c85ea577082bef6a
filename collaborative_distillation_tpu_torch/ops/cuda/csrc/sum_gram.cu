// One-pass feature statistics: sum(x - s) (C,) and (x - s)^T (x - s) (C, C)
// over the P rows of a (P, C) float32 matrix, for sm_90a.
//
// Replaces fused_sum_gram (reference ops/pallas/stats.py:61). The TPU kernel
// walked a sequential grid and carried its sums in VMEM from step to step;
// blocks here run in parallel and in no order, so:
//   * pass 1: block (r, t) takes row range r and a CT x CT tile t of the Gram
//     matrix, stages RB rows of its two column strips in shared memory and
//     accumulates a TM x TM register tile per thread; blocks of column tile 0
//     also accumulate the column sums. Each block writes its partials to a
//     scratch buffer the wrapper allocates.
//   * pass 2: one thread per output element adds the partials of all row
//     ranges in a fixed order. No float atomics, so results repeat exactly
//     from run to run.
// The optional per-channel shift s turns the uncentred Gram, which cancels
// catastrophically in f32 once P reaches millions of pixels, into a Gram of
// nearly centred data (the caller passes an estimate of the mean and corrects
// with d = mean - s; exact in exact arithmetic). shift == nullptr is plain
// sum(x) and x^T x, exactly fused_sum_gram.
//
// What bounds it: bytes. Each element is read once per column-tile pair;
// at the cascade's widths (C <= 128, at most 2x2 tiles of 64) the kernel
// streams the map ~C/64 times and does 2*C^2 FLOPs per row, below the FP32
// ridge at C <= 32 and near it at C = 128.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // 16 x 16 threads, each a TM x TM tile
constexpr int RB = 32;        // rows staged per pass

template <int TM>
__global__ void __launch_bounds__(THREADS)
sum_gram_partial_kernel(const float* __restrict__ x,
                        const float* __restrict__ shift,
                        float* __restrict__ partial, int P, int C,
                        int rows_per_block, int tiles_c) {
  constexpr int CT = 16 * TM;
  __shared__ __align__(16) float xa[RB][CT];
  __shared__ __align__(16) float xb[RB][CT];

  const int ti = blockIdx.y / tiles_c;
  const int tj = blockIdx.y % tiles_c;
  const int i0 = ti * CT;
  const int j0 = tj * CT;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(P, r0 + rows_per_block);
  const int t = threadIdx.x;
  const int tr = t / 16;
  const int tc = t % 16;
  const bool do_sum = (tj == 0) && (t < CT);

  float acc[TM][TM];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int c = 0; c < TM; ++c) acc[a][c] = 0.f;
  float s = 0.f;

  for (int rb = r0; rb < r1; rb += RB) {
    for (int e = t; e < RB * CT; e += THREADS) {
      const int c = e % CT;
      const int r = e / CT;
      const int p = rb + r;
      const int ca = i0 + c;
      const int cb = j0 + c;
      float va = 0.f, vb = 0.f;  // rows past the range contribute nothing
      if (p < r1) {
        const float* row = x + (size_t)p * C;
        if (ca < C) va = row[ca] - (shift ? shift[ca] : 0.f);
        if (cb < C) vb = row[cb] - (shift ? shift[cb] : 0.f);
      }
      xa[r][c] = va;
      xb[r][c] = vb;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < RB; ++r) {
      float av[TM], bv[TM];
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        av[m] = xa[r][tr * TM + m];
        bv[m] = xb[r][tc * TM + m];
      }
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int c = 0; c < TM; ++c) acc[a][c] = fmaf(av[a], bv[c], acc[a][c]);
    }
    if (do_sum) {
      for (int r = 0; r < RB; ++r) s += xa[r][t];
    }
    __syncthreads();
  }

  // partial layout per row range: gram (C, C) then sum (C,)
  float* out = partial + (size_t)blockIdx.x * ((size_t)C * C + C);
#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const int i = i0 + tr * TM + a;
    if (i >= C) continue;
#pragma unroll
    for (int c = 0; c < TM; ++c) {
      const int j = j0 + tc * TM + c;
      if (j < C) out[(size_t)i * C + j] = acc[a][c];
    }
  }
  if (do_sum && i0 + t < C) out[(size_t)C * C + i0 + t] = s;
}

__global__ void sum_gram_reduce_kernel(const float* __restrict__ partial,
                                       float* __restrict__ out, int nblocks,
                                       int len) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= len) return;
  float s = 0.f;
  for (int k = 0; k < nblocks; ++k) s += partial[(size_t)k * len + e];
  out[e] = s;
}

}  // namespace

// out: gram (C*C) followed by sum (C); partial: nblocks x (C*C + C) scratch.
extern "C" int cd_sum_gram(const float* x, const float* shift, float* partial,
                           float* out, int P, int C, int nblocks,
                           int rows_per_block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 32) {
    const int tiles = (C + 31) / 32;
    sum_gram_partial_kernel<2><<<dim3(nblocks, tiles * tiles), THREADS, 0, s>>>(
        x, shift, partial, P, C, rows_per_block, tiles);
  } else {
    const int tiles = (C + 63) / 64;
    sum_gram_partial_kernel<4><<<dim3(nblocks, tiles * tiles), THREADS, 0, s>>>(
        x, shift, partial, P, C, rows_per_block, tiles);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int len = C * C + C;
  sum_gram_reduce_kernel<<<(len + 255) / 256, 256, 0, s>>>(partial, out,
                                                           nblocks, len);
  return static_cast<int>(cudaGetLastError());
}
