// 2x2/2 max pool (floor) and nearest 2x upsample, NHWC float32, for sm_90a.
//
// max_pool_2x2 replaces packed_pool_lane (reference ops/pallas/pool.py:96)
// for unpacked maps (its f == 1 branch): odd trailing rows and columns are
// dropped, as nn.MaxPool2d(2, 2) does. upsample_nearest_2x replaces
// packed_upsample_lane (pool.py:141): each input pixel is written to its
// 2x2 output block.
//
// What bounds them: bytes. Neither does arithmetic worth counting, so each
// reads every input element once and writes every output element once,
// with one thread per output (pool) or input (upsample) vector of 4
// channels: 16-byte loads and stores where C % 4 == 0 and the tensors are
// 16-byte aligned, scalar accesses otherwise. Neighbouring threads take
// neighbouring channels, then neighbouring pixels, so every warp touches
// contiguous memory.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ float4 vmax(float4 a, float4 b) {
  return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z),
                     fmaxf(a.w, b.w));
}

template <typename T>
__global__ void max_pool_2x2_kernel(const T* __restrict__ x, T* __restrict__ y,
                                    int H, int W, int Cv, size_t total) {
  const int Ho = H / 2, Wo = W / 2;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int c = e % Cv;
    size_t r = e / Cv;
    const int ox = r % Wo;
    r /= Wo;
    const int oy = r % Ho;
    const size_t n = r / Ho;
    const T* p = x + ((n * H + 2 * oy) * W + 2 * ox) * Cv + c;
    const size_t row = (size_t)W * Cv;
    y[e] = vmax(vmax(p[0], p[Cv]), vmax(p[row], p[row + Cv]));
  }
}

template <typename T>
__global__ void upsample_nearest_2x_kernel(const T* __restrict__ x,
                                           T* __restrict__ y, int H, int W,
                                           int Cv, size_t total) {
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int c = e % Cv;
    size_t r = e / Cv;
    const int ix = r % W;
    r /= W;
    const int iy = r % H;
    const size_t n = r / H;
    const T v = x[e];
    const size_t row = (size_t)2 * W * Cv;
    T* q = y + ((n * 2 * H + 2 * iy) * 2 * W + 2 * ix) * Cv + c;
    q[0] = v;
    q[Cv] = v;
    q[row] = v;
    q[row + Cv] = v;
  }
}

int blocks_for(size_t total) {
  const size_t b = (total + 255) / 256;
  return static_cast<int>(b < 1048576 ? b : 1048576);  // grid-stride beyond
}

bool vec4(const void* a, const void* b, int c) {
  return c % 4 == 0 && reinterpret_cast<size_t>(a) % 16 == 0 &&
         reinterpret_cast<size_t>(b) % 16 == 0;
}

}  // namespace

extern "C" int cd_max_pool_2x2(const float* x, float* y, int n, int h, int w,
                               int c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t pix = (size_t)n * (h / 2) * (w / 2);
  if (pix == 0) return static_cast<int>(cudaGetLastError());
  if (vec4(x, y, c)) {
    const size_t total = pix * (c / 4);
    max_pool_2x2_kernel<float4><<<blocks_for(total), 256, 0, s>>>(
        reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(y), h,
        w, c / 4, total);
  } else {
    const size_t total = pix * c;
    max_pool_2x2_kernel<float><<<blocks_for(total), 256, 0, s>>>(x, y, h, w, c,
                                                                 total);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cd_upsample_nearest_2x(const float* x, float* y, int n, int h,
                                      int w, int c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t pix = (size_t)n * h * w;
  if (pix == 0) return static_cast<int>(cudaGetLastError());
  if (vec4(x, y, c)) {
    const size_t total = pix * (c / 4);
    upsample_nearest_2x_kernel<float4><<<blocks_for(total), 256, 0, s>>>(
        reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(y), h,
        w, c / 4, total);
  } else {
    const size_t total = pix * c;
    upsample_nearest_2x_kernel<float><<<blocks_for(total), 256, 0, s>>>(
        x, y, h, w, c, total);
  }
  return static_cast<int>(cudaGetLastError());
}
