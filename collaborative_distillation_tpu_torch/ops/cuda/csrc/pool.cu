// 2x2/2 max pool (floor) and nearest 2x upsample, NHWC float32, for sm_90a.
//
// max_pool_2x2 replaces packed_pool_lane (reference ops/pallas/pool.py:96)
// for unpacked maps (its f == 1 branch): odd trailing rows and columns are
// dropped, as nn.MaxPool2d(2, 2) does. upsample_nearest_2x replaces
// packed_upsample_lane (pool.py:141): each input pixel is written to its
// 2x2 output block. On the inference paths the conv kernels beside them do
// this work themselves (conv3x3.cu, bf16_igemm.cuh: POOL and UP); these
// kernels serve training under autograd, the per-conv sharded path and the
// widths without a fused instantiation.
//
// cd_max_pool_2x2_bf16 and cd_upsample_nearest_2x_bf16 are the bf16
// instantiations (packed_pool_lane and packed_upsample_lane keep the input's
// dtype, pool.py:118, :155): the same kernels on 16-byte vectors of 8 bf16
// where C % 8 == 0 and both tensors are 16-byte aligned, single bf16
// otherwise. A max and a copy are exact in any type.
//
// What bounds them: bytes. Neither does arithmetic worth counting, so each
// reads every input element once and writes every output element once,
// with one thread per output (pool) or input (upsample) vector of 4
// channels: 16-byte loads and stores where C % 4 == 0 and the tensors are
// 16-byte aligned, scalar accesses otherwise. Neighbouring threads take
// neighbouring channels, then neighbouring pixels, so every warp touches
// contiguous memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// a NaN wins, as in torch's and XLA's max (fmaxf would drop it): a NaN
// feature map, as a one-pixel covariance gives, must stay NaN
__device__ __forceinline__ float vmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float4 vmax(float4 a, float4 b) {
  return make_float4(vmax(a.x, b.x), vmax(a.y, b.y), vmax(a.z, b.z),
                     vmax(a.w, b.w));
}
// the same in bf16: the comparison in float (exact), one of the two inputs out
__device__ __forceinline__ __nv_bfloat16 vmax(__nv_bfloat16 a, __nv_bfloat16 b) {
  const float fa = __bfloat162float(a), fb = __bfloat162float(b);
  return (fa > fb || fa != fa) ? a : b;
}
__device__ __forceinline__ __nv_bfloat162 vmax(__nv_bfloat162 a, __nv_bfloat162 b) {
  return __halves2bfloat162(vmax(a.x, b.x), vmax(a.y, b.y));
}
struct __align__(16) bf16x8 {
  __nv_bfloat162 v[4];
};
__device__ __forceinline__ bf16x8 vmax(bf16x8 a, bf16x8 b) {
  bf16x8 r;
#pragma unroll
  for (int i = 0; i < 4; ++i) r.v[i] = vmax(a.v[i], b.v[i]);
  return r;
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

// bf16: 16-byte vectors of 8 where C % 8 == 0 and both are 16-byte aligned
bool vec8(const void* a, const void* b, int c) {
  return c % 8 == 0 && reinterpret_cast<size_t>(a) % 16 == 0 &&
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

extern "C" int cd_max_pool_2x2_bf16(const void* x, void* y, int n, int h, int w, int c,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t pix = (size_t)n * (h / 2) * (w / 2);
  if (pix == 0) return static_cast<int>(cudaGetLastError());
  if (vec8(x, y, c)) {
    const size_t total = pix * (c / 8);
    max_pool_2x2_kernel<bf16x8><<<blocks_for(total), 256, 0, s>>>(
        static_cast<const bf16x8*>(x), static_cast<bf16x8*>(y), h, w, c / 8, total);
  } else {
    const size_t total = pix * c;
    max_pool_2x2_kernel<__nv_bfloat16><<<blocks_for(total), 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), h, w, c,
        total);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cd_upsample_nearest_2x_bf16(const void* x, void* y, int n, int h, int w,
                                           int c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t pix = (size_t)n * h * w;
  if (pix == 0) return static_cast<int>(cudaGetLastError());
  if (vec8(x, y, c)) {
    const size_t total = pix * (c / 8);
    upsample_nearest_2x_kernel<uint4><<<blocks_for(total), 256, 0, s>>>(
        static_cast<const uint4*>(x), static_cast<uint4*>(y), h, w, c / 8, total);
  } else {
    const size_t total = pix * c;
    upsample_nearest_2x_kernel<unsigned short><<<blocks_for(total), 256, 0, s>>>(
        static_cast<const unsigned short*>(x), static_cast<unsigned short*>(y), h, w, c,
        total);
  }
  return static_cast<int>(cudaGetLastError());
}
