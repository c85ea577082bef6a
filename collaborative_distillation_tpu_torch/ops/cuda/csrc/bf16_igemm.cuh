// bf16 implicit GEMM on the tensor cores (mma.sync m16n8k16, f32 accumulation)
// for sm_90a: the tile code of the bf16 conv3x3 (conv3x3_bf16.cu) and the bf16
// 1x1 (conv1x1.cu).
//
// One block computes an M x N tile of the product
//     y[p, co] = act(sum_k A[p, k] * B[k, co] + bias[co])
// M = 128 pixels (8 rows of 16: a 2D tile of the map for the 3x3, 128
// consecutive pixels for the 1x1), N = NT couts (16, 32 or 64), K = TAPS * Cin,
// walked in chunks of 32 input channels:
//   * staging: the chunk's input pixels (the 3x3's tile with its one-pixel
//     reflected border, reflect_index semantics as ops/pad.py) and its
//     TAPS x chunk x NT weights go into shared memory as bf16; channels are
//     zero-padded to a multiple of 8 (Cin = 3 stages 8), couts past Cout are
//     zero. Pixels are staged with a stride of 40 bf16 (80 B) and weight rows
//     with NT + 8, so the eight 16-byte rows one ldmatrix phase reads fall in
//     distinct banks. 16-byte copies where Cin % 8 == 0 (Cout % 8 == 0 for
//     the weights) and the tensor is 16-byte aligned, 2-byte ones otherwise;
//   * K runs in groups of 8: group j of a chunk is tap j / G, channels
//     8 (j % G) .. +7 (G = staged channels / 8). An ldmatrix row address is
//     per lane, so each 8-deep half of an m16n8k16 step may sit at another
//     tap: A (pixels x k, row-major) comes straight out of the staged tile by
//     ldmatrix.x4, B (k x couts, HWIO's own row-major layout) by
//     ldmatrix.x4.trans. An odd last group pairs with a zero row (A) and
//     zero weights (B);
//   * 4 warps, each 2 m16 fragments (two tile rows) x NT / 8 n8 fragments;
//     the sum stays in f32 registers across all of K;
//   * epilogue in f32: + bias (bf16 or f32), ReLU (NaN stays NaN), one
//     rounding to bf16 (RNE), NHWC store, masked at the map's edges and past
//     Cout.
// No double buffering, no wgmma or TMA: staging and products alternate, with
// two to five blocks an SM overlapping one another's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// internal linkage: each translation unit that includes it has its own copy
namespace cd_bf16 {
namespace {

constexpr int kThreads = 128;          // 4 warps
constexpr int kTileW = 16;             // pixels of one m16 fragment: a tile row
constexpr int kTileH = 8;              // tile rows, 2 a warp
constexpr int kCK = 32;                // input channels staged per chunk
constexpr int kXS = kCK + 8;           // staged pixel stride, bf16
constexpr int kMaxDevices = 64;

// the 3x3's staged pixels: the tile and its one-pixel border
struct Conv3x3Geom {
  static constexpr int kTaps = 9;
  static constexpr int kStagePix = (kTileH + 2) * (kTileW + 2);
};
// the 1x1's: 128 consecutive pixels
struct PointGeom {
  static constexpr int kTaps = 1;
  static constexpr int kStagePix = kTileH * kTileW;
};

struct Args {
  const unsigned short* x;   // bf16 bits, NHWC or (P, Cin)
  const unsigned short* w;   // bf16 bits, (TAPS, Cin, Cout): HWIO or (Cin, Cout)
  const void* b;             // (Cout,) bf16 or f32, or null
  __nv_bfloat16* y;          // (..., Cout)
  long long P;               // pixels (the 1x1)
  int H, W;                  // map (the 3x3)
  int Cin, Cout, relu, bias_bf16, vec_x, vec_w, vec_y;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16, row-major) * b (16x8, column-major), bf16 in, f32 sum
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// reflect-pad-1 source index of i in [-1, n] on an n-long axis (n = 1
// reflects onto itself); indices past a ragged tile's end take any row in
// range: their outputs are never stored
__device__ __forceinline__ int reflect1(int i, int n) {
  if (n == 1) return 0;
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// 8 bf16 from src, those at channel ch + j >= lim zero
__device__ __forceinline__ uint4 load8_masked(const unsigned short* src, int ch, int lim) {
  uint32_t v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t lo = ch + 2 * j < lim ? src[2 * j] : 0u;
    const uint32_t hi = ch + 2 * j + 1 < lim ? src[2 * j + 1] : 0u;
    v[j] = lo | (hi << 16);
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float bias_at(const Args& a, int co) {
  if (a.b == nullptr) return 0.f;
  return a.bias_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.b)[co])
                     : static_cast<const float*>(a.b)[co];
}

template <class G, int NT>
struct Smem {
  static constexpr int kKRows = (G::kTaps * kCK + 15) / 16 * 16;   // weight rows
  static constexpr int kWS = NT + 8;                               // weight row stride
  // staged pixels, 8 zeros (the A row of an odd last k group), weights
  static constexpr size_t kBytes =
      (size_t)(G::kStagePix * kXS + 8 + kKRows * kWS) * sizeof(__nv_bfloat16);
};

template <class G, int NT>
__global__ void __launch_bounds__(kThreads) igemm_bf16_kernel(const Args a) {
  constexpr int TAPS = G::kTaps;
  constexpr int SP = G::kStagePix;
  constexpr int WS = Smem<G, NT>::kWS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [SP][kXS]
  __nv_bfloat16* zrow = xs + SP * kXS;                               // 8 zeros
  __nv_bfloat16* ws = zrow + 8;                                       // [kKRows][WS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.y * NT;
  int img = 0, ty0 = 0, tx0 = 0;
  long long p0 = 0;
  if constexpr (TAPS == 9) {
    const int tiles_w = (a.W + kTileW - 1) / kTileW;
    ty0 = (blockIdx.x / tiles_w) * kTileH;
    tx0 = (blockIdx.x % tiles_w) * kTileW;
    img = blockIdx.z;
  } else {
    p0 = (long long)blockIdx.x * (kTileH * kTileW);
  }
  if (tid < 8) zrow[tid] = __float2bfloat16_rn(0.f);

  float acc[2][NT / 8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[m][j][r] = 0.f;

  const uint32_t xs_base = smem_u32(xs), ws_base = smem_u32(ws), z_addr = smem_u32(zrow);
  // ldmatrix.x4 row addresses: lanes 0-7, 8-15, 16-23, 24-31 give matrices
  // 0-3. A: rows (pixels) 0-7 / 8-15 of k 0-7, then of k 8-15. B (trans):
  // k rows 0-7 / 8-15 of couts 0-7, then of couts 8-15
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lhalf = lane >> 4;

  for (int c0 = 0; c0 < a.Cin; c0 += kCK) {
    const int cc = min(kCK, a.Cin - c0);
    const int cp = (cc + 7) & ~7;         // staged channels per pixel
    const int groups = cp / 8;            // k groups of one tap
    const int kg_total = TAPS * groups;
    const int steps = (kg_total + 1) / 2;

    for (int e = tid; e < SP * groups; e += kThreads) {
      const int sp = e / groups, g = e - (e / groups) * groups;
      long long pix;
      bool valid = true;
      if constexpr (TAPS == 9) {
        const int hy = sp / (kTileW + 2), hx = sp - hy * (kTileW + 2);
        const int gy = reflect1(ty0 - 1 + hy, a.H), gx = reflect1(tx0 - 1 + hx, a.W);
        pix = ((long long)img * a.H + gy) * a.W + gx;
      } else {
        pix = p0 + sp;
        valid = pix < a.P;
      }
      const int ch = c0 + g * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (valid) {
        const unsigned short* src = a.x + pix * a.Cin + ch;
        v = a.vec_x ? *reinterpret_cast<const uint4*>(src) : load8_masked(src, ch, a.Cin);
      }
      *reinterpret_cast<uint4*>(xs + sp * kXS + g * 8) = v;
    }
    // weight row r = tap * cp + ci (zero past cc, past TAPS * cp and past Cout)
    constexpr int Q = NT / 8;
    for (int e = tid; e < steps * 16 * Q; e += kThreads) {
      const int r = e / Q, q = e - (e / Q) * Q;
      const int tap = r / cp, ci = r - tap * cp;
      const int co = n0 + q * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (tap < TAPS && ci < cc && co < a.Cout) {
        const unsigned short* src = a.w + ((long long)tap * a.Cin + c0 + ci) * a.Cout + co;
        v = a.vec_w ? *reinterpret_cast<const uint4*>(src) : load8_masked(src, co, a.Cout);
      }
      *reinterpret_cast<uint4*>(ws + r * WS + q * 8) = v;
    }
    __syncthreads();

    for (int s = 0; s < steps; ++s) {
      const int kg = 2 * s + lhalf;
      uint32_t afr[2][4];
#pragma unroll
      for (int mf = 0; mf < 2; ++mf) {
        uint32_t addr = z_addr;
        if (kg < kg_total) {
          const int tap = kg / groups, g = kg - tap * groups;
          const int tr = warp * 2 + mf;
          int sp;
          if constexpr (TAPS == 9)
            sp = (tr + tap / 3) * (kTileW + 2) + lrow + tap % 3;
          else
            sp = tr * kTileW + lrow;
          addr = xs_base + (uint32_t)(sp * kXS + g * 8) * 2u;
        }
        ldsm_x4(afr[mf], addr);
      }
#pragma unroll
      for (int nb = 0; nb < NT / 16; ++nb) {
        uint32_t bfr[4];
        ldsm_x4_t(bfr, ws_base + (uint32_t)((s * 16 + lrow) * WS + nb * 16 + lhalf * 8) * 2u);
#pragma unroll
        for (int mf = 0; mf < 2; ++mf) {
          mma_bf16(acc[mf][2 * nb], afr[mf], bfr[0], bfr[1]);
          mma_bf16(acc[mf][2 * nb + 1], afr[mf], bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();
  }

  // c0, c1 at (pixel gid, couts 2 tig, +1); c2, c3 at pixel gid + 8
  const int gid = lane >> 2, tig = lane & 3;
  float bias[NT / 8][2];
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
    const int co = n0 + j * 8 + tig * 2;
    bias[j][0] = co < a.Cout ? bias_at(a, co) : 0.f;
    bias[j][1] = co + 1 < a.Cout ? bias_at(a, co + 1) : 0.f;
  }
#pragma unroll
  for (int mf = 0; mf < 2; ++mf) {
    const int tr = warp * 2 + mf;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int px = gid + 8 * h;
      long long opix;
      if constexpr (TAPS == 9) {
        const int gy = ty0 + tr, gx = tx0 + px;
        if (gy >= a.H || gx >= a.W) continue;
        opix = ((long long)img * a.H + gy) * a.W + gx;
      } else {
        opix = p0 + tr * kTileW + px;
        if (opix >= a.P) continue;
      }
      __nv_bfloat16* yp = a.y + opix * a.Cout;
#pragma unroll
      for (int j = 0; j < NT / 8; ++j) {
        const int co = n0 + j * 8 + tig * 2;
        if (co >= a.Cout) continue;
        float v0 = acc[mf][j][2 * h] + bias[j][0];
        float v1 = acc[mf][j][2 * h + 1] + bias[j][1];
        if (a.relu) {   // NaN stays NaN, as in torch.relu
          if (v0 < 0.f) v0 = 0.f;
          if (v1 < 0.f) v1 = 0.f;
        }
        if (co + 1 < a.Cout && a.vec_y) {
          *reinterpret_cast<__nv_bfloat162*>(yp + co) = __floats2bfloat162_rn(v0, v1);
        } else {
          yp[co] = __float2bfloat16_rn(v0);
          if (co + 1 < a.Cout) yp[co + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

// One launch of the NT instantiation over ``grid``: opts in to its dynamic
// shared memory once per device.
template <class G, int NT>
int launch(const Args& a, dim3 grid, cudaStream_t s) {
  constexpr size_t smem = Smem<G, NT>::kBytes;
  auto kernel = igemm_bf16_kernel<G, NT>;
  static bool opted[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[dev] = true;
  }
  kernel<<<grid, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The Cout tile: the narrowest of 16, 32, 64 that holds Cout, else 64
// (grid.y walks the tiles).
template <class G>
int dispatch(const Args& a, unsigned gx, unsigned gz, cudaStream_t s) {
  const int nt = a.Cout <= 16 ? 16 : a.Cout <= 32 ? 32 : 64;
  const dim3 grid(gx, (a.Cout + nt - 1) / nt, gz);
  if (nt == 16) return launch<G, 16>(a, grid, s);
  if (nt == 32) return launch<G, 32>(a, grid, s);
  return launch<G, 64>(a, grid, s);
}

inline bool aligned(const void* p, size_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

}  // namespace
}  // namespace cd_bf16
