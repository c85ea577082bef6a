// Per-pixel 1x1 convolution: y = act(x @ W + b) over the P rows of a (P, Cin)
// float32 map, Cin and Cout in 1..128, for sm_90a.
//
// Replaces conv1x1_lane128 (reference ops/pallas/conv.py:437, body
// _conv1x1_kernel :370-389). The slab cascade applies the folded WCT through
// it (reference models/packed_vgg.py packed_wct_apply): x @ M + beta with
// M = alpha T^T + (1 - alpha) I.
//
// What bounds it: bytes at C <= 64, operations at C = 128. With Cin = Cout = C
// a pixel costs 2 C^2 FLOPs against 8 C bytes, C/4 FLOP/B, and the card's FP32
// ridge is ~20 FLOP/B (67 TFLOP/s over 3.35 TB/s). So:
//   * a persistent block (one wave) copies W (Cin x a Cout tile of up to 128)
//     into shared memory with its first pixel tile and keeps it for its whole
//     life, so W is read from L2 once per block;
//   * the pixel tiles stream through a ring of NS slots filled by cp.async:
//     while the block multiplies tile i, tiles i+1 .. i+NS-1 are in flight,
//     so an SM keeps its share of HBM busy. A tile of TP pixels is one
//     contiguous run of TP * Cin floats, copied 16 bytes at a time where
//     Cin % 4 == 0 and x is 16-byte aligned (a slab's feature rows may start
//     anywhere), 4 bytes at a time otherwise. Rows are staged with a stride
//     of Cin + 4 floats, so the rows one quarter-warp reads fall in distinct
//     banks;
//   * each thread holds PPT pixels x 8 couts in registers (two groups of 4,
//     half a tile apart, so that neighbouring threads read neighbouring
//     16-byte words of W). Shared bytes loaded per FMA: 4 (PPT + 8) / (8 PPT),
//     1.5 at PPT = 4 (C <= 32, bound by bytes) and 1 at PPT = 8 (C = 64, 128):
//     a warp's 16-byte shared load costs the pipe 4 cycles whatever its
//     addresses, so this ratio is what keeps the FMA pipe fed;
//   * accumulation is FP32 FFMA in the order k = 0..Cin-1, no TF32 (the
//     reference runs Precision.HIGHEST for f32, conv.py:383); bias and ReLU
//     run in the epilogue, with 16-byte stores where Cout % 4 == 0.
// Where it stands on an H100: C = 24 and 32 at 85-92 % of the time a device
// copy of the same bytes takes, C = 64 and 128 at ~55 % of FFMA peak (one
// block of 8 warps an SM: W alone takes 64 KB of shared memory at C = 128).
//
// cd_conv1x1_bias_bf16 is the bf16 instantiation (conv1x1_lane128's "bf16
// inputs keep the bf16 pass", :382-386; the bf16 engine's folded WCT, M in
// bf16 and beta in f32, reference models/packed_vgg.py:246-252): x and W in
// bf16, f32 sums, + f32 beta, one rounding to bf16. At C = 128 the bf16
// product is 128 FLOP/B, under the tensor cores' 295 FLOP/B ridge: bound by
// bytes at every width. It is the persistent ring kernel of bf16_igemm.cuh
// with one tap, the f32 kernel's shape on the tensor cores: one block an SM
// keeps W (at most 128 x 128 x 2 B = 32 KB, the whole Cout in one block, so
// every pixel is read once) resident, runs of 512 / 256 / 128 consecutive
// pixels (Cin and Cout up to 32 / 64 / 128) stream through a cp.async ring
// of 4 / 3 / 3 slots, mma.sync from ldmatrix, and each warp stores its
// 16-pixel fragments as 16-byte vectors from shared memory. The first bf16 kernel, the 3x3
// tile code with one tap, re-staged W for every 128 pixels, split Cout at
// 64 and kept nothing in flight: 21-68 % of the byte bound. This one: 70 %
// at C 24 and 32, 75 % at 64, 36 % at 128 (one fragment a warp, each
// re-reading all of W), 66 % over the UHD slab path's 20 launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_igemm.cuh"

namespace {

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

// TX threads across the Cout tile (8 couts each), TY across the pixel tile
// (PPT pixels each); NS ring slots; K4: Cin % 4 == 0, so rows are read as
// float4. Two ways to deal pixels to blocks:
//   * TX < 8 (C <= 32, bound by bytes): tiles of TP dealt round the grid
//     (block b takes tiles b, b + grid, ...), so the blocks stream one compact
//     window of the map at a time; a thread's pixels are strided by TY, so
//     the thread rows of one quarter-warp read distinct banks;
//   * TX >= 8 (C = 64, 128, bound by operations): block b owns the run
//     [b * chunk, min(P, (b + 1) * chunk)), equal runs for all blocks, in
//     tiles of TP with a short last one; a thread's pixels are consecutive
//     rows (one quarter-warp holds one thread row), so a warp whose rows all
//     lie past a short tile skips it. Dealing whole tiles would leave the
//     last round of a small map (82 x 640: 410 tiles on 132 blocks) a fourth
//     full.
template <int TX, int TY, int PPT, int NS, bool K4>
__global__ void __launch_bounds__(TX * TY)
conv1x1_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ b, float* __restrict__ y, long long P,
               long long chunk, int Cin, int Cout, int relu, int vec_in, int vec_w,
               int vec_out) {
  constexpr int NT = TX * TY;
  constexpr int CO_T = TX * 8;
  constexpr int HALF = CO_T / 2;
  constexpr int TP = TY * PPT;
  constexpr bool CONTIG = TX >= 8;
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                  // [Cin][CO_T], zero past Cout
  float* xs = smem + Cin * CO_T;     // NS slots of [TP][XS]
  const int XS = Cin + 4;
  const int slot = TP * XS;

  const int t = threadIdx.x;
  const int tx = t % TX;
  const int ty = t / TX;
  // the tile row of this thread's pixel p; the first row of its warp
  auto row = [&](int p) { return CONTIG ? ty * PPT + p : ty + p * TY; };
  const int warp_row0 = CONTIG ? (t / 32) * (32 / TX) * PPT : 0;

  const long long begin = CONTIG ? blockIdx.x * chunk : 0;
  const long long end = CONTIG ? (begin + chunk < P ? begin + chunk : P) : P;
  const long long ntiles = (P + TP - 1) / TP;
  const int nt = static_cast<int>(CONTIG ? (end - begin + TP - 1) / TP
                                         : (ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x);
  // first pixel of this block's tile j
  auto first = [&](int j) {
    return CONTIG ? begin + (long long)j * TP : (blockIdx.x + (long long)j * gridDim.x) * TP;
  };
  // copy units: 4 floats (16-byte copies) or 1 float a unit, q units a row;
  // thread t copies units t, t + NT, ...: its (row, unit) steps by (dr, du)
  // with a carry, so the loop divides by nothing
  const int unit = vec_in ? 4 : 1;
  const int q = Cin / unit;
  const int dr = NT / q, du = NT % q;
  const int r0 = t / q, u0 = t % q;

  // tile j of this block into slot j % NS: one commit group per tile
  auto prefetch = [&](int j) {
    if (j < nt) {
      const long long p0 = first(j);
      const int np = static_cast<int>(end - p0 < TP ? end - p0 : TP);
      const float* src = x + p0 * Cin;
      float* dst = xs + (j % NS) * slot;
      int r = r0, u = u0;
      for (int e = t; e < np * q; e += NT) {
        if (vec_in)
          cp_async16(dst + r * XS + 4 * u, src + 4 * (long long)e);
        else
          cp_async4(dst + r * XS + u, src + e);
        r += dr;
        u += du;
        if (u >= q) {
          u -= q;
          ++r;
        }
      }
    }
    cp_async_commit();
  };

  // W into shared memory with the first tile's group, zero past Cout
  if (vec_w) {   // Cout % 4 == 0, w 16-byte aligned: a group of 4 wholly in or out
    for (int e = t; e < Cin * (CO_T / 4); e += NT) {
      const int c4 = 4 * (e % (CO_T / 4));
      const int k = e / (CO_T / 4);
      float* dst = ws + k * CO_T + c4;
      if (c4 < Cout)
        cp_async16(dst, w + (size_t)k * Cout + c4);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int e = t; e < Cin * CO_T; e += NT) {
      const int co = e % CO_T;
      const int k = e / CO_T;
      if (co < Cout)
        cp_async4(ws + e, w + (size_t)k * Cout + co);
      else
        ws[e] = 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < NS - 1; ++j) prefetch(j);
  float bias[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int co = (j / 4) * HALF + tx * 4 + j % 4;
    bias[j] = (b != nullptr && co < Cout) ? b[co] : 0.f;
  }

  for (int i = 0; i < nt; ++i) {
    cp_async_wait<NS - 2>();   // this thread's copies of tile i have landed
    __syncthreads();           // everyone's; and slot (i - 1) % NS is free
    prefetch(i + NS - 1);
    const long long p0 = first(i);
    if (p0 + warp_row0 >= end) continue;   // CONTIG: no row of this warp in the tile
    const float* xt = xs + (i % NS) * slot;

    float acc[PPT][8];
#pragma unroll
    for (int p = 0; p < PPT; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[p][j] = 0.f;

    if constexpr (K4) {
#pragma unroll 2
      for (int k = 0; k < Cin; k += 4) {
        float4 xv[PPT];
#pragma unroll
        for (int p = 0; p < PPT; ++p)
          xv[p] = *reinterpret_cast<const float4*>(&xt[row(p) * XS + k]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* wr = ws + (k + kk) * CO_T + tx * 4;
          const float4 w0 = *reinterpret_cast<const float4*>(wr);
          const float4 w1 = *reinterpret_cast<const float4*>(wr + HALF);
          const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int p = 0; p < PPT; ++p)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[p][j] = fmaf(lane(xv[p], kk), wv[j], acc[p][j]);
        }
      }
    } else {
      for (int k = 0; k < Cin; ++k) {
        const float* wr = ws + k * CO_T + tx * 4;
        const float4 w0 = *reinterpret_cast<const float4*>(wr);
        const float4 w1 = *reinterpret_cast<const float4*>(wr + HALF);
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int p = 0; p < PPT; ++p) {
          const float xv = xt[row(p) * XS + k];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[p][j] = fmaf(xv, wv[j], acc[p][j]);
        }
      }
    }

    // rows past the tile's end hold stale values: computed, never stored
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      const long long pix = p0 + row(p);
      if (pix >= end) continue;
      float* yp = y + pix * Cout;
      float o[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[j] = acc[p][j] + bias[j];
        if (relu && o[j] < 0.f) o[j] = 0.f;  // NaN stays NaN, as in torch.relu
      }
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int co = g * HALF + tx * 4;
        if (vec_out) {  // Cout % 4 == 0: a group of 4 lies wholly inside or out
          if (co < Cout)
            *reinterpret_cast<float4*>(yp + co) =
                make_float4(o[4 * g], o[4 * g + 1], o[4 * g + 2], o[4 * g + 3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (co + j < Cout) yp[co + j] = o[4 * g + j];
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <int TX, int TY, int PPT, int NS, bool K4>
int launch(const float* x, const float* w, const float* b, float* y,
           long long P, int cin, int cout, int relu, int vec_in, int vec_w,
           int vec_out, cudaStream_t s) {
  constexpr int NT = TX * TY;
  constexpr int CO_T = TX * 8;
  constexpr int TP = TY * PPT;
  const size_t smem =
      ((size_t)cin * CO_T + (size_t)NS * TP * (cin + 4)) * sizeof(float);
  auto kernel = conv1x1_kernel<TX, TY, PPT, NS, K4>;
  // once per device: the opt-in to all the dynamic shared memory a block
  // may have; once per device and Cin: the blocks a wave holds (runtime
  // queries cost microseconds, as much as the smallest launches take)
  static bool opted[kMaxDevices];
  static int wave_of[kMaxDevices][129];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted[dev]) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[dev] = true;
  }
  if (wave_of[dev][cin] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    wave_of[dev][cin] = sms * (per_sm > 0 ? per_sm : 1);
  }
  // one wave; with runs (TX >= 8) each block an equal run of pixels, a
  // multiple of 16, every block at least one
  const long long ntiles = (P + TP - 1) / TP;
  const long long wave = wave_of[dev][cin];
  const long long blocks = ntiles < wave ? ntiles : wave;
  const long long chunk = ((P + blocks - 1) / blocks + 15) / 16 * 16;
  const int grid = static_cast<int>(TX >= 8 ? (P + chunk - 1) / chunk : blocks);
  kernel<<<grid, NT, smem, s>>>(x, w, b, y, P, chunk, cin, cout, relu, vec_in, vec_w,
                                vec_out);
  return static_cast<int>(cudaGetLastError());
}

// Tiles by the wider of Cin and Cout (the slots hold Cin-wide rows):
// (TX, TY, PPT, NS) = Cout tile 8 TX, TY * PPT pixels, NS slots. Shared
// memory at the widest Cin of each class: 113, 76, 152 and 196 KB.
template <bool K4>
int dispatch(const float* x, const float* w, const float* b, float* y,
             long long P, int cin, int cout, int relu, int vec_in, int vec_w,
             int vec_out, cudaStream_t s) {
  const int wide = cin > cout ? cin : cout;
  if (wide <= 32 && cout <= 24)   // 3 x 64 threads, 256 pixels, 3 slots (C = 24)
    return launch<3, 64, 4, 3, K4>(x, w, b, y, P, cin, cout, relu, vec_in, vec_w, vec_out, s);
  if (wide <= 32)                 // 4 x 64 threads, 256 pixels, 2 slots (C = 32)
    return launch<4, 64, 4, 2, K4>(x, w, b, y, P, cin, cout, relu, vec_in, vec_w, vec_out, s);
  if (wide <= 64)                 // 8 x 32 threads, 256 pixels (8 px x 8 co a thread)
    return launch<8, 32, 8, 2, K4>(x, w, b, y, P, cin, cout, relu, vec_in, vec_w, vec_out, s);
  return launch<16, 16, 8, 2, K4>(x, w, b, y, P, cin, cout, relu, vec_in, vec_w, vec_out, s);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x (P, Cin), w (Cin, Cout), b (Cout,) or null, y (P, Cout); Cin, Cout <= 128.
extern "C" int cd_conv1x1_bias(const float* x, const float* w, const float* b,
                               float* y, long long P, int cin, int cout,
                               int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P <= 0) return static_cast<int>(cudaGetLastError());
  const int vec_w = cout % 4 == 0 && aligned16(w);
  const int vec_out = cout % 4 == 0 && aligned16(y);
  if (cin % 4 == 0)
    return dispatch<true>(x, w, b, y, P, cin, cout, relu, aligned16(x), vec_w, vec_out, s);
  return dispatch<false>(x, w, b, y, P, cin, cout, relu, 0, vec_w, vec_out, s);
}

namespace {

//                          TAPS CK   NT  TH TW  S  WARPS WG
using Point32 = cd_bf16::Ring<1, 32, 32, 32, 16, 4, 16, 0>;    // 512 pixels, 199 KB
using Point64 = cd_bf16::Ring<1, 64, 64, 16, 16, 3, 8, 0>;     // 256 pixels, 152 KB
using Point128 = cd_bf16::Ring<1, 128, 128, 8, 16, 3, 8, 0>;   // 128 pixels, 170 KB

template <class R>
int run_point(cd_bf16::Args a, int grid, cudaStream_t s) {
  constexpr int tile = R::TH * R::TW;
  const long long tiles = (a.P + tile - 1) / tile;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  a.tiles = (int)tiles;
  a.cout_tiles = 1;
  a.chunks = 1;
  a.resident = 1;
  if (a.Cin > R::CK || a.Cout > R::NT) return static_cast<int>(cudaErrorInvalidValue);
  return cd_bf16::launch<R>(a, grid, s);
}

}  // namespace

// x (P, Cin) bf16, w (Cin, Cout) bf16, b (Cout,) f32 or null, y (P, Cout)
// bf16; Cin, Cout <= 128. ``tmpl`` and ``grid`` are the launch plan's
// (ops/cuda/conv.py:launch_plan_bf16 with taps=1).
extern "C" int cd_conv1x1_bias_bf16(const void* x, const void* w, const float* b, void* y,
                                    long long P, int cin, int cout, int relu, int tmpl,
                                    int grid, void* stream) {
  if (P <= 0) return static_cast<int>(cudaGetLastError());
  cd_bf16::Args a = cd_bf16::make_args(x, w, b, y, cin, cout, relu);
  a.P = P;
  a.bias_bf16 = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tmpl) {
    case 11: return run_point<Point32>(a, grid, s);
    case 12: return run_point<Point64>(a, grid, s);
    case 13: return run_point<Point128>(a, grid, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
