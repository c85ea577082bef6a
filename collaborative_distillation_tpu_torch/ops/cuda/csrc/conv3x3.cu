// Reflect-padded 3x3 convolution + bias (+ ReLU), NHWC float32, for sm_90a.
//
// Replaces the reference package's three Pallas conv3x3 kernels for plain
// (unpacked) NHWC maps: conv3x3_tiled (ops/pallas/conv.py:754),
// conv3x3_subin (:1039) and conv3x3_lane128 (:332). They compute one
// function, y = act(reflectpad1(x) * w + b); the TPU split it by lane density,
// a distinction this card does not have.
//
// What bounds it: arithmetic. At the cascade's widths (Cin, Cout 16..128) a
// 3x3 conv does 18*Cin*Cout FLOPs per pixel against 4*(Cin+Cout) bytes, far
// above the card's FP32 ridge (67 TFLOP/s over 3.35 TB/s, ~20 FLOP/B), so
// the kernel is written to keep the FMA pipes fed from shared memory:
//   * one block computes a 16x16 pixel tile x a CO_T-wide Cout tile;
//   * per Cin chunk of 16 it stages the (16+2)x(16+2) input halo and the
//     9 x 16 x CO_T weight chunk in shared memory, channel-major so that
//     neighbouring threads read neighbouring columns (no bank conflicts);
//   * each thread holds 4 pixels (one column, 4 rows) x CPT couts in
//     registers and reuses each staged input value across the 3 ky taps;
//   * accumulation is FP32 FFMA, not TF32, to match the reference's f32
//     HIGHEST-precision path; bias and ReLU run in the epilogue.
// Reflect padding lives in the index math: the padded map is never written.
// A size-1 dimension reflects onto itself (index -1 and index n both map to
// 0), as jnp.pad(mode="reflect") does and F.pad(mode="reflect") refuses.
//
// Simple and right first: no tensor cores, no cp.async/TMA pipelining. Cin
// below 16 and Cout below CO_T waste the unused lanes of their chunk.

#include <cuda_runtime.h>

namespace {

constexpr int TH = 16;          // tile rows
constexpr int TW = 16;          // tile cols
constexpr int CI_T = 16;        // Cin chunk staged per pass
constexpr int HR = TH + 2;
constexpr int HC = TW + 2;
constexpr int THREADS = 256;    // 64 pixel groups x 4 cout groups

__device__ __forceinline__ int reflect1(int i, int n) {
  if (n == 1) return 0;
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  // ragged edge tiles read past the map for outputs that are never stored
  return min(max(i, 0), n - 1);
}

template <int CPT>  // couts per thread; the block's Cout tile is 4 * CPT
__global__ void __launch_bounds__(THREADS)
conv3x3_reflect_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ b, float* __restrict__ y,
                       int H, int W, int Cin, int Cout, int relu, int tiles_w) {
  constexpr int CO_T = 4 * CPT;
  __shared__ float xs[CI_T][HR][HC];
  __shared__ __align__(16) float ws[9][CI_T][CO_T];

  const int ty0 = (blockIdx.x / tiles_w) * TH;
  const int tx0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * CO_T;
  const size_t n = blockIdx.z;
  const float* xn = x + n * H * W * Cin;

  const int t = threadIdx.x;
  const int cg = t & 3;             // cout group: couts cg*CPT .. +CPT
  const int pg = t >> 2;            // pixel group 0..63
  const int px = pg & (TW - 1);     // tile column
  const int py0 = (pg >> 4) * 4;    // first of this thread's 4 tile rows

  float acc[4][CPT];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[p][j] = 0.f;

  for (int ci0 = 0; ci0 < Cin; ci0 += CI_T) {
    // input halo, read channel-fastest (coalesced along Cin)
    for (int e = t; e < HR * HC * CI_T; e += THREADS) {
      const int ci = e % CI_T;
      const int rc = e / CI_T;
      const int c = rc % HC;
      const int r = rc / HC;
      const int gc = ci0 + ci;
      float v = 0.f;
      if (gc < Cin) {
        const int gy = reflect1(ty0 + r - 1, H);
        const int gx = reflect1(tx0 + c - 1, W);
        v = xn[((size_t)gy * W + gx) * Cin + gc];
      }
      xs[ci][r][c] = v;
    }
    // weight chunk: w is (3, 3, Cin, Cout) = (9, Cin, Cout)
    for (int e = t; e < 9 * CI_T * CO_T; e += THREADS) {
      const int co = e % CO_T;
      const int r = e / CO_T;
      const int ci = r % CI_T;
      const int tap = r / CI_T;
      const int gc = ci0 + ci;
      const int go = co0 + co;
      ws[tap][ci][co] = (gc < Cin && go < Cout)
                            ? w[((size_t)tap * Cin + gc) * Cout + go] : 0.f;
    }
    __syncthreads();

    const int cimax = min(CI_T, Cin - ci0);
    for (int ci = 0; ci < cimax; ++ci) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        float v[6];
#pragma unroll
        for (int r = 0; r < 6; ++r) v[r] = xs[ci][py0 + r][px + kx];
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          float wv[CPT];
#pragma unroll
          for (int j = 0; j < CPT; ++j) wv[j] = ws[ky * 3 + kx][ci][cg * CPT + j];
#pragma unroll
          for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int j = 0; j < CPT; ++j)
              acc[p][j] = fmaf(v[p + ky], wv[j], acc[p][j]);
        }
      }
    }
    __syncthreads();
  }

  const int gx = tx0 + px;
  if (gx >= W) return;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int gy = ty0 + py0 + p;
    if (gy >= H) continue;
    float* yp = y + ((n * H + gy) * W + gx) * Cout;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int co = co0 + cg * CPT + j;
      if (co < Cout) {
        float o = acc[p][j] + b[co];
        yp[co] = (relu && o < 0.f) ? 0.f : o;  // NaN stays NaN, as in torch.relu
      }
    }
  }
}

template <int CPT>
void launch(const float* x, const float* w, const float* b, float* y, int n,
            int h, int wd, int cin, int cout, int relu, cudaStream_t s) {
  const int tiles_w = (wd + TW - 1) / TW;
  const int tiles_h = (h + TH - 1) / TH;
  dim3 grid(tiles_w * tiles_h, (cout + 4 * CPT - 1) / (4 * CPT), n);
  conv3x3_reflect_kernel<CPT><<<grid, THREADS, 0, s>>>(
      x, w, b, y, h, wd, cin, cout, relu, tiles_w);
}

}  // namespace

extern "C" int cd_conv3x3_reflect(const float* x, const float* w,
                                  const float* b, float* y, int n, int h,
                                  int wd, int cin, int cout, int relu,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cout > 16)
    launch<8>(x, w, b, y, n, h, wd, cin, cout, relu, s);
  else if (cout > 8)
    launch<4>(x, w, b, y, n, h, wd, cin, cout, relu, s);
  else
    launch<2>(x, w, b, y, n, h, wd, cin, cout, relu, s);
  return static_cast<int>(cudaGetLastError());
}
