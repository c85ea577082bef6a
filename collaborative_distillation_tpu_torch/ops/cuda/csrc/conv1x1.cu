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
//   * a block keeps W (Cin x a Cout tile of up to 128) in shared memory for
//     its whole life and walks over pixel tiles (one wave of blocks, grid
//     stride), so W is read from L2 once per block, not once per tile;
//   * a tile of TP pixels is one contiguous run of TP * Cin floats, read with
//     16-byte loads where Cin % 4 == 0 and x is 16-byte aligned (a slab's
//     feature rows may start anywhere), scalar loads otherwise. It is staged
//     row-major with a row stride of Cin + 4, so the 2 to 4 pixel rows one
//     warp reads at once fall in different banks;
//   * each thread holds PPT pixels x CPT couts in registers; accumulation is
//     FP32 FFMA in the order k = 0..Cin-1, no TF32 (the reference runs
//     Precision.HIGHEST for f32, conv.py:383); bias and ReLU run in the
//     epilogue, with 16-byte stores where Cout % 4 == 0.
// Simple and right first: one tile in flight per block, no cp.async or TMA
// double buffering, no tensor cores.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// TX threads across the Cout tile (CPT couts each), THREADS / TX across the
// pixel tile (PPT pixels each, strided by THREADS / TX).
template <int TX, int CPT, int PPT, bool VEC>
__global__ void __launch_bounds__(THREADS)
conv1x1_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ b, float* __restrict__ y, long long P,
               int Cin, int Cout, int relu, int vec_out) {
  constexpr int CO_T = TX * CPT;
  constexpr int TY = THREADS / TX;
  constexpr int TP = TY * PPT;
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                  // [Cin][CO_T], zero past Cout
  float* xs = smem + Cin * CO_T;     // [TP][XS]
  const int XS = Cin + 4;

  const int t = threadIdx.x;
  const int tx = t % TX;
  const int ty = t / TX;
  const int co0 = tx * CPT;

  for (int e = t; e < Cin * CO_T; e += THREADS) {
    const int co = e % CO_T;
    const int k = e / CO_T;
    ws[e] = co < Cout ? w[(size_t)k * Cout + co] : 0.f;
  }
  float bias[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j)
    bias[j] = (b != nullptr && co0 + j < Cout) ? b[co0 + j] : 0.f;

  const long long ntiles = (P + TP - 1) / TP;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long p0 = tile * TP;
    const int np = static_cast<int>(P - p0 < TP ? P - p0 : TP);
    const float* xt = x + p0 * Cin;
    __syncthreads();  // W is staged; the previous tile's reads of xs are done
    if constexpr (VEC) {
      const int n4 = np * Cin / 4;
      const float4* xt4 = reinterpret_cast<const float4*>(xt);
      for (int e = t; e < n4; e += THREADS) {
        const int i = 4 * e;  // Cin % 4 == 0: the 4 values share a pixel
        *reinterpret_cast<float4*>(&xs[(i / Cin) * XS + i % Cin]) = xt4[e];
      }
    } else {
      const int n = np * Cin;
      for (int e = t; e < n; e += THREADS) xs[(e / Cin) * XS + e % Cin] = xt[e];
    }
    __syncthreads();

    float acc[PPT][CPT];
#pragma unroll
    for (int i = 0; i < PPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

    if constexpr (VEC) {
      for (int k = 0; k < Cin; k += 4) {
        float4 xv[PPT];
#pragma unroll
        for (int i = 0; i < PPT; ++i)
          xv[i] = *reinterpret_cast<const float4*>(&xs[(ty + i * TY) * XS + k]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float wv[CPT];
#pragma unroll
          for (int j = 0; j < CPT; j += 4) {
            const float4 v =
                *reinterpret_cast<const float4*>(&ws[(k + kk) * CO_T + co0 + j]);
            wv[j] = v.x;
            wv[j + 1] = v.y;
            wv[j + 2] = v.z;
            wv[j + 3] = v.w;
          }
#pragma unroll
          for (int i = 0; i < PPT; ++i)
#pragma unroll
            for (int j = 0; j < CPT; ++j)
              acc[i][j] = fmaf(lane(xv[i], kk), wv[j], acc[i][j]);
        }
      }
    } else {
      for (int k = 0; k < Cin; ++k) {
        float xv[PPT];
#pragma unroll
        for (int i = 0; i < PPT; ++i) xv[i] = xs[(ty + i * TY) * XS + k];
#pragma unroll
        for (int i = 0; i < PPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j)
            acc[i][j] = fmaf(xv[i], ws[k * CO_T + co0 + j], acc[i][j]);
      }
    }

    // rows past np hold stale values: computed, never stored
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const int p = ty + i * TY;
      if (p >= np) continue;
      float* yp = y + (p0 + p) * Cout;
      float o[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        o[j] = acc[i][j] + bias[j];
        if (relu && o[j] < 0.f) o[j] = 0.f;  // NaN stays NaN, as in torch.relu
      }
      if (vec_out) {  // Cout % 4 == 0: a group of 4 lies wholly inside or out
#pragma unroll
        for (int j = 0; j < CPT; j += 4)
          if (co0 + j < Cout)
            *reinterpret_cast<float4*>(yp + co0 + j) =
                make_float4(o[j], o[j + 1], o[j + 2], o[j + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < CPT; ++j)
          if (co0 + j < Cout) yp[co0 + j] = o[j];
      }
    }
  }
}

template <int TX, int CPT, int PPT, bool VEC>
int launch(const float* x, const float* w, const float* b, float* y,
           long long P, int cin, int cout, int relu, int vec_out,
           cudaStream_t s) {
  constexpr int CO_T = TX * CPT;
  constexpr int TP = (THREADS / TX) * PPT;
  const size_t smem = ((size_t)cin * CO_T + (size_t)TP * (cin + 4)) * sizeof(float);
  auto kernel = conv1x1_kernel<TX, CPT, PPT, VEC>;
  // above 48 KB (Cin = Cout = 128 takes 97 KB) only as opted-in dynamic memory
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long ntiles = (P + TP - 1) / TP;
  const long long wave = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(ntiles < wave ? ntiles : wave);
  kernel<<<grid, THREADS, smem, s>>>(x, w, b, y, P, cin, cout, relu, vec_out);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC>
int dispatch(const float* x, const float* w, const float* b, float* y,
             long long P, int cin, int cout, int relu, int vec_out,
             cudaStream_t s) {
  if (cout <= 32)   // 8 x 32 threads, 128-pixel tiles
    return launch<8, 4, 4, VEC>(x, w, b, y, P, cin, cout, relu, vec_out, s);
  if (cout <= 64)   // 16 x 16 threads, 64-pixel tiles
    return launch<16, 4, 4, VEC>(x, w, b, y, P, cin, cout, relu, vec_out, s);
  return launch<16, 8, 4, VEC>(x, w, b, y, P, cin, cout, relu, vec_out, s);
}

bool aligned16(const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; }

}  // namespace

// x (P, Cin), w (Cin, Cout), b (Cout,) or null, y (P, Cout); Cin, Cout <= 128.
extern "C" int cd_conv1x1_bias(const float* x, const float* w, const float* b,
                               float* y, long long P, int cin, int cout,
                               int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P <= 0) return static_cast<int>(cudaGetLastError());
  const int vec_out = cout % 4 == 0 && aligned16(y);
  if (cin % 4 == 0 && aligned16(x))
    return dispatch<true>(x, w, b, y, P, cin, cout, relu, vec_out, s);
  return dispatch<false>(x, w, b, y, P, cin, cout, relu, vec_out, s);
}
