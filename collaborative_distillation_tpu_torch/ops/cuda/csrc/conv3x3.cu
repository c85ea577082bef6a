// Reflect-padded 3x3 convolution + bias (+ ReLU), NHWC float32, for sm_90a.
//
// Replaces the reference package's three Pallas conv3x3 kernels for plain
// (unpacked) NHWC maps: conv3x3_tiled (ops/pallas/conv.py:754),
// conv3x3_subin (:1039) and conv3x3_lane128 (:332). They compute one
// function, y = act(reflectpad1(x) * w + b); the TPU split it by lane density,
// a distinction this card does not have.
//
// What bounds it: arithmetic. At the cascade's widths (Cin, Cout 16..128) a
// 3x3 conv does 18*Cin*Cout FLOPs per pixel against 4*(Cin+Cout) bytes, at or
// above the card's FP32 ridge (67 TFLOP/s over 3.35 TB/s, ~20 FLOP/B); the
// narrow full-resolution layers (3 -> 16, 16 -> 3, 16 -> 16) sit near it and
// need the bytes streamed as well. Accumulation is FP32 FFMA, not TF32, to
// match the reference's f32 HIGHEST-precision path; bias and ReLU run in the
// epilogue, and ReLU keeps NaN (o < 0 is false for NaN), as torch.relu does.
// Reflect padding lives in the index math: the padded map is never written.
// A size-1 dimension reflects onto itself (index -1 and index n both map to
// 0), as jnp.pad(mode="reflect") does and F.pad(mode="reflect") refuses.
//
// Two kernels, chosen per shape by the launch plan in ../conv.py
// (launch_plan), never as a fallback:
//
// ring_conv3x3_kernel (the path's widths: Cin and Cout in {3, 16, 24, 32, 64, 128}):
//   * a persistent block walks over TH x TW pixel tiles (grid stride) and
//     computes each for ALL of Cout (a Cout tile CO_T up to 128), so the
//     input halo is staged once per tile;
//   * the work is one sequence of steps (tile, Cin chunk of CI_T); each step's
//     (TH+2) x (TW+2) x CI_T halo and 9 x CI_T x CO_T weights are copied into
//     a ring of NS shared-memory slots by cp.async, 16 bytes at a time where
//     Cin (Cout) % 4 == 0 and x (w) is 16-byte aligned, 4 bytes otherwise, so
//     the copies of the next steps, across tile boundaries, overlap the FMAs of
//     this one. Reflect index math runs only for halo rows and columns that
//     fall outside the map. Cin = 3 takes a chunk of 4 (one zero channel);
//   * the halo is staged pixel-major, [row][col][CIS] with CIS = CI_T (+4 past
//     4) and an odd column pitch, so that the strips of one warp, on
//     consecutive rows, read distinct banks;
//   * each thread holds a strip of PX = 8 consecutive pixels of one row x CPT
//     couts (two groups of 4, half a Cout tile apart, so neighbouring threads
//     read neighbouring 16-byte words of w). Per (ci, ky) it loads the 10
//     inputs of the strip once and uses each for the 3 kx taps: 10 floats of
//     x and 24 of w per 192 FMAs, 0.71 shared bytes per FMA at CPT = 8 (a
//     warp's 16-byte shared load costs the pipe 4 cycles whatever its
//     addresses, so bytes per FMA is what the FMA pipe is fed by). Where a
//     warp holds 16 or more strips (Cout <= 16), x is read 4 channels at a
//     time, as float4, to keep those reads free of bank conflicts.
//   Where it stands on an H100: ~55 % of FFMA peak at Cout 32..128, ~45 % at
//   Cout 16, ~30 % of the byte bound at Cout 3 and Cin 3. Two output rows a
//   thread (0.53 shared bytes per FMA), 16-pixel strips, all 16 couts a
//   thread at Cout 16 and two blocks an SM each measured slower or no faster
//   (tools/bench_kernels.py), so the shared pipe alone does not hold it.
//
// first_conv3x3_kernel (every other width: the teachers' 256 and 512, odd widths):
//   the first port's kernel, a 16x16 tile x a Cout tile of 4 * CPT, Cin
//   chunks of 16 staged by plain loads, 4 pixels x CPT couts a thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int reflect1(int i, int n) {
  if (n == 1) return 0;
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  // ragged edge tiles read past the map for outputs that are never stored
  return min(max(i, 0), n - 1);
}

constexpr int kMaxDevices = 64;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// ---- ring_conv3x3_kernel ------------------------------------------------------

constexpr int PX = 8;   // pixels of a thread strip, one row

// One block of 256 threads an SM (__launch_bounds__(NT, 1)): the compiler
// keeps ~250 registers a thread, most for shared loads it starts early; at
// two blocks an SM (128 registers) it spilled and took 1.22x as long on an
// H100.
template <int CO_T_, int CPT_, int TH_, int TW_, int CI_T_, int NS_, bool X4_>
struct Ring {
  static constexpr int CO_T = CO_T_, CPT = CPT_, TH = TH_, TW = TW_, CI_T = CI_T_;
  static constexpr int NS = NS_;
  static constexpr bool X4 = X4_;                 // read x as float4, 4 channels at once
  static constexpr int G = CO_T / CPT;            // cout groups
  static constexpr int S = TH * TW / PX;          // pixel strips
  static constexpr int NT = G * S;                // threads
  static constexpr int NGRP = CPT / 4;            // float4 groups a thread holds
  static constexpr int GSTRIDE = CO_T / NGRP;     // couts between them
  static constexpr int HR = TH + 2, HC = TW + 2;
  static constexpr int TWP = HC | 1;              // odd pixel pitch of a halo row
  static constexpr int CIS = CI_T % 8 == 0 ? CI_T + 4 : CI_T;   // CIS / 4 odd
  static constexpr int XSLOT = HR * TWP * CIS;
  static constexpr int WSLOT = 9 * CI_T * CO_T;
  static constexpr int SLOT = XSLOT + WSLOT;
  static constexpr size_t SMEM = (size_t)NS * SLOT * sizeof(float);
  static_assert(CO_T % CPT == 0 && CPT % 4 == 0 && CI_T % 4 == 0, "tile");
  static_assert(TW % PX == 0 && NT % 32 == 0 && NT <= 1024, "threads");
};

template <class R>
__global__ void __launch_bounds__(R::NT, 1)
ring_conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ b, float* __restrict__ y, int H, int W,
                    int Cin, int Cout, int relu, int vec_x, int vec_w, int vec_y,
                    int tiles_h, int tiles_w, int ntiles) {
  constexpr int CO_T = R::CO_T, CPT = R::CPT, TH = R::TH, TW = R::TW;
  constexpr int CI_T = R::CI_T, NS = R::NS, NT = R::NT, G = R::G;
  constexpr int HR = R::HR, HC = R::HC, TWP = R::TWP, CIS = R::CIS;
  extern __shared__ __align__(16) float smem[];

  const int t = threadIdx.x;
  const int cg = t % G;
  const int strip = t / G;
  const int sr = strip % TH;                 // strips of a warp: consecutive rows
  const int sc = (strip / TH) * PX;

  const int nchunks = (Cin + CI_T - 1) / CI_T;
  const int per_img = tiles_h * tiles_w;
  const int nt = (ntiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int nsteps = nt * nchunks;

  // step k = (this block's tile k / nchunks, Cin chunk k % nchunks) into slot
  // k % NS: one commit group per step, empty past the last
  auto prefetch = [&](int k) {
    if (k < nsteps) {
      const int tile = blockIdx.x + (k / nchunks) * gridDim.x;
      const int ci0 = (k % nchunks) * CI_T;
      const int n = tile / per_img;
      const int r0 = tile - n * per_img;
      const int ty0 = (r0 / tiles_w) * TH;
      const int tx0 = (r0 % tiles_w) * TW;
      const float* xn = x + (size_t)n * H * W * Cin;
      float* xs = smem + (k % NS) * R::SLOT;
      float* ws = xs + R::XSLOT;
      if (vec_x) {
        constexpr int Q = CI_T / 4;
        for (int e = t; e < HR * HC * Q; e += NT) {
          const int q = e % Q;
          const int pix = e / Q;
          const int c = pix % HC;
          const int r = pix / HC;
          int gy = ty0 + r - 1, gx = tx0 + c - 1;
          if (static_cast<unsigned>(gy) >= static_cast<unsigned>(H)) gy = reflect1(gy, H);
          if (static_cast<unsigned>(gx) >= static_cast<unsigned>(W)) gx = reflect1(gx, W);
          float* dst = xs + (r * TWP + c) * CIS + 4 * q;
          const int ci = ci0 + 4 * q;
          if (ci < Cin)
            cp_async16(dst, xn + ((size_t)gy * W + gx) * Cin + ci);
          else
            *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      } else {
        for (int e = t; e < HR * HC * CI_T; e += NT) {
          const int q = e % CI_T;
          const int pix = e / CI_T;
          const int c = pix % HC;
          const int r = pix / HC;
          int gy = ty0 + r - 1, gx = tx0 + c - 1;
          if (static_cast<unsigned>(gy) >= static_cast<unsigned>(H)) gy = reflect1(gy, H);
          if (static_cast<unsigned>(gx) >= static_cast<unsigned>(W)) gx = reflect1(gx, W);
          float* dst = xs + (r * TWP + c) * CIS + q;
          if (ci0 + q < Cin)
            cp_async4(dst, xn + ((size_t)gy * W + gx) * Cin + ci0 + q);
          else
            *dst = 0.f;
        }
      }
      // weights: w is (3, 3, Cin, Cout) = (9, Cin, Cout); ws [9][CI_T][CO_T]
      if (vec_w) {
        constexpr int Q = CO_T / 4;
        for (int e = t; e < 9 * CI_T * Q; e += NT) {
          const int q = e % Q;
          const int row = e / Q;               // tap * CI_T + ci
          const int ci = row % CI_T;
          const int tap = row / CI_T;
          float* dst = ws + row * CO_T + 4 * q;
          if (ci0 + ci < Cin && 4 * q < Cout)
            cp_async16(dst, w + ((size_t)tap * Cin + ci0 + ci) * Cout + 4 * q);
          else
            *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      } else {
        for (int e = t; e < 9 * CI_T * CO_T; e += NT) {
          const int co = e % CO_T;
          const int row = e / CO_T;
          const int ci = row % CI_T;
          const int tap = row / CI_T;
          if (ci0 + ci < Cin && co < Cout)
            cp_async4(ws + e, w + ((size_t)tap * Cin + ci0 + ci) * Cout + co);
          else
            ws[e] = 0.f;
        }
      }
    }
    cp_async_commit();
  };

  float bias[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int co = (j / 4) * R::GSTRIDE + cg * 4 + j % 4;
    bias[j] = co < Cout ? b[co] : 0.f;
  }
  float acc[PX][CPT];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[p][j] = 0.f;

#pragma unroll
  for (int k = 0; k < NS - 1; ++k) prefetch(k);

  for (int k = 0; k < nsteps; ++k) {
    cp_async_wait<NS - 2>();   // this thread's copies of step k have landed
    __syncthreads();           // everyone's; and slot (k - 1) % NS is free
    prefetch(k + NS - 1);
    const float* xs = smem + (k % NS) * R::SLOT;
    const float* ws = xs + R::XSLOT;
    const float* xb = xs + (sr * TWP + sc) * CIS;

#pragma unroll 1
    for (int c4 = 0; c4 < CI_T; c4 += 4) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const float* xr = xb + ky * TWP * CIS + c4;
        float4 xq[R::X4 ? PX + 2 : 1];   // 4 channels of the strip's 10 inputs
        if constexpr (R::X4) {
#pragma unroll
          for (int j = 0; j < PX + 2; ++j)
            xq[j] = *reinterpret_cast<const float4*>(xr + j * CIS);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float xv[PX + 2];
          if constexpr (R::X4) {
#pragma unroll
            for (int j = 0; j < PX + 2; ++j) xv[j] = lane(xq[j], kk);
          } else {
#pragma unroll
            for (int j = 0; j < PX + 2; ++j) xv[j] = xr[j * CIS + kk];
          }
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const float* wr = ws + ((ky * 3 + kx) * CI_T + c4 + kk) * CO_T + cg * 4;
            float wv[CPT];
#pragma unroll
            for (int g = 0; g < R::NGRP; ++g) {
              const float4 v = *reinterpret_cast<const float4*>(wr + g * R::GSTRIDE);
              wv[4 * g] = v.x;
              wv[4 * g + 1] = v.y;
              wv[4 * g + 2] = v.z;
              wv[4 * g + 3] = v.w;
            }
#pragma unroll
            for (int p = 0; p < PX; ++p)
#pragma unroll
              for (int j = 0; j < CPT; ++j)
                acc[p][j] = fmaf(xv[p + kx], wv[j], acc[p][j]);
          }
        }
      }
    }

    if (k % nchunks == nchunks - 1) {   // the tile's last chunk: epilogue
      const int tile = blockIdx.x + (k / nchunks) * gridDim.x;
      const int n = tile / per_img;
      const int r0 = tile - n * per_img;
      const int gy = (r0 / tiles_w) * TH + sr;
      const int gx0 = (r0 % tiles_w) * TW + sc;
      if (gy < H) {
        float* yrow = y + ((size_t)n * H + gy) * W * Cout;
#pragma unroll
        for (int p = 0; p < PX; ++p) {
          if (gx0 + p >= W) break;
          float* yp = yrow + (size_t)(gx0 + p) * Cout;
#pragma unroll
          for (int g = 0; g < R::NGRP; ++g) {
            const int co = g * R::GSTRIDE + cg * 4;
            float o[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              o[j] = acc[p][4 * g + j] + bias[4 * g + j];
              if (relu && o[j] < 0.f) o[j] = 0.f;  // NaN stays NaN
            }
            if (vec_y) {   // Cout % 4 == 0: a group lies wholly inside or out
              if (co < Cout)
                *reinterpret_cast<float4*>(yp + co) = make_float4(o[0], o[1], o[2], o[3]);
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (co + j < Cout) yp[co + j] = o[j];
            }
          }
        }
      }
#pragma unroll
      for (int p = 0; p < PX; ++p)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[p][j] = 0.f;
    }
  }
  cp_async_wait<0>();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <class R>
int launch_ring(const float* x, const float* w, const float* b, float* y, int n,
                int h, int wd, int cin, int cout, int relu, int nblocks,
                cudaStream_t s) {
  if (cout > R::CO_T || nblocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_h = (h + R::TH - 1) / R::TH;
  const int tiles_w = (wd + R::TW - 1) / R::TW;
  const long long ntiles = (long long)n * tiles_h * tiles_w;
  if (ntiles > 0x7fffffffLL || nblocks > ntiles) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = ring_conv3x3_kernel<R>;
  // the opt-in above 48 KB of dynamic shared memory, once per device
  static bool opted[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(R::SMEM));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[dev] = true;
  }
  kernel<<<nblocks, R::NT, R::SMEM, s>>>(
      x, w, b, y, h, wd, cin, cout, relu, cin % 4 == 0 && aligned16(x),
      cout % 4 == 0 && aligned16(w), cout % 4 == 0 && aligned16(y), tiles_h, tiles_w,
      static_cast<int>(ntiles));
  return static_cast<int>(cudaGetLastError());
}

// The templates, by the id the launch plan gives (../conv.py _TEMPLATES):
// (Cout tile, couts a thread, tile rows, tile cols, Cin chunk, slots, x read
// as float4). Chosen step by step on the card (tools/bench_kernels.py): Cin
// chunks of 16 at the wide Couts, 4 where a warp holds 16+ strips (Cout 16)
// and for Cin = 3, 8 at Cout = 3.
using RingCo128 = Ring<128, 8, 8, 16, 16, 2, false>;    // 256 threads, 178 KB
using RingCo64 = Ring<64, 8, 16, 16, 16, 3, false>;     // 256 threads, 193 KB
using RingCo32 = Ring<32, 8, 16, 32, 16, 2, false>;     // 256 threads, 138 KB
using RingCo32Cin3 = Ring<32, 8, 16, 32, 4, 3, false>;  // 256 threads, 44 KB
using RingCo16 = Ring<16, 8, 32, 32, 4, 3, true>;       // 256 threads, 64 KB
using RingCo4 = Ring<4, 4, 32, 64, 8, 2, true>;         // 256 threads, 219 KB

// ---- first_conv3x3_kernel -----------------------------------------------------

constexpr int F_TH = 16;          // tile rows
constexpr int F_TW = 16;          // tile cols
constexpr int F_CI_T = 16;        // Cin chunk staged per pass
constexpr int F_HR = F_TH + 2;
constexpr int F_HC = F_TW + 2;
constexpr int F_THREADS = 256;    // 64 pixel groups x 4 cout groups

template <int CPT>  // couts per thread; the block's Cout tile is 4 * CPT
__global__ void __launch_bounds__(F_THREADS)
first_conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ b, float* __restrict__ y,
                     int H, int W, int Cin, int Cout, int relu, int tiles_w) {
  constexpr int CO_T = 4 * CPT;
  __shared__ float xs[F_CI_T][F_HR][F_HC];
  __shared__ __align__(16) float ws[9][F_CI_T][CO_T];

  const int ty0 = (blockIdx.x / tiles_w) * F_TH;
  const int tx0 = (blockIdx.x % tiles_w) * F_TW;
  const int co0 = blockIdx.y * CO_T;
  const size_t n = blockIdx.z;
  const float* xn = x + n * H * W * Cin;

  const int t = threadIdx.x;
  const int cg = t & 3;             // cout group: couts cg*CPT .. +CPT
  const int pg = t >> 2;            // pixel group 0..63
  const int px = pg & (F_TW - 1);   // tile column
  const int py0 = (pg >> 4) * 4;    // first of this thread's 4 tile rows

  float acc[4][CPT];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[p][j] = 0.f;

  for (int ci0 = 0; ci0 < Cin; ci0 += F_CI_T) {
    // input halo, read channel-fastest (coalesced along Cin)
    for (int e = t; e < F_HR * F_HC * F_CI_T; e += F_THREADS) {
      const int ci = e % F_CI_T;
      const int rc = e / F_CI_T;
      const int c = rc % F_HC;
      const int r = rc / F_HC;
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
    for (int e = t; e < 9 * F_CI_T * CO_T; e += F_THREADS) {
      const int co = e % CO_T;
      const int r = e / CO_T;
      const int ci = r % F_CI_T;
      const int tap = r / F_CI_T;
      const int gc = ci0 + ci;
      const int go = co0 + co;
      ws[tap][ci][co] = (gc < Cin && go < Cout)
                            ? w[((size_t)tap * Cin + gc) * Cout + go] : 0.f;
    }
    __syncthreads();

    const int cimax = min(F_CI_T, Cin - ci0);
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
int launch_first(const float* x, const float* w, const float* b, float* y, int n,
                 int h, int wd, int cin, int cout, int relu, cudaStream_t s) {
  const int tiles_w = (wd + F_TW - 1) / F_TW;
  const int tiles_h = (h + F_TH - 1) / F_TH;
  dim3 grid(tiles_w * tiles_h, (cout + 4 * CPT - 1) / (4 * CPT), n);
  first_conv3x3_kernel<CPT><<<grid, F_THREADS, 0, s>>>(x, w, b, y, h, wd, cin, cout,
                                                       relu, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (N, H, W, Cin), w (3, 3, Cin, Cout), b (Cout,), y (N, H, W, Cout).
// tmpl: 0 = first_conv3x3_kernel, 1.. = the ring templates above; nblocks: the ring
// kernel's persistent grid (ignored by first_conv3x3_kernel).
extern "C" int cd_conv3x3_reflect(const float* x, const float* w,
                                  const float* b, float* y, int n, int h,
                                  int wd, int cin, int cout, int relu, int tmpl,
                                  int nblocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tmpl) {
    case 0:
      if (cout > 16) return launch_first<8>(x, w, b, y, n, h, wd, cin, cout, relu, s);
      if (cout > 8) return launch_first<4>(x, w, b, y, n, h, wd, cin, cout, relu, s);
      return launch_first<2>(x, w, b, y, n, h, wd, cin, cout, relu, s);
    case 1:
      return launch_ring<RingCo128>(x, w, b, y, n, h, wd, cin, cout, relu, nblocks, s);
    case 2:
      return launch_ring<RingCo64>(x, w, b, y, n, h, wd, cin, cout, relu, nblocks, s);
    case 3:
      return launch_ring<RingCo32>(x, w, b, y, n, h, wd, cin, cout, relu, nblocks, s);
    case 4:
      return launch_ring<RingCo32Cin3>(x, w, b, y, n, h, wd, cin, cout, relu, nblocks, s);
    case 5:
      return launch_ring<RingCo16>(x, w, b, y, n, h, wd, cin, cout, relu, nblocks, s);
    case 6:
      return launch_ring<RingCo4>(x, w, b, y, n, h, wd, cin, cout, relu, nblocks, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
