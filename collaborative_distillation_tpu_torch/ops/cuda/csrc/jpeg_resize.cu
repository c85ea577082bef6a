// The shorter-side resize of a decoded JPEG on the card, (H, W, 3) uint8
// RGB, for sm_90a.
//
// Not a TPU kernel: these are the card's counterpart of
// native/imgcodec.cpp, the reference's host codec. Its training loader
// (collaborative_distillation_tpu/data/native_codec.py:414-441) lets libjpeg
// decode at scale 1/d (d in {1, 2, 4, 8}, its scaled IDCT) and then
// box-resizes with cd_resize_rgb (native/imgcodec.cpp:441-469). nvJPEG has
// no scaled decode, so the card decodes whole and reproduces both steps:
//
// scale_reduce: (H, W, 3) -> (ceil(H/d), ceil(W/d), 3), libjpeg's scaled
//   size; each output pixel is the mean of its d x d block, rounded as
//   (sum + n/2) / n in integers (n = d * d), the last row and column of
//   blocks edge-replicated (a block index past the image reads its last
//   row or column). It stands in for the scaled IDCT, which it matches to
//   ~50 dB (it averages the decoded pixels, libjpeg drops the DCT's high
//   frequencies).
// box_resize: cd_resize_rgb exactly: output pixel (x, y) sums the window
//   [x*sw/dw, (x+1)*sw/dw) x [y*sh/dh, (y+1)*sh/dh) in integer division,
//   widened to one pixel where it is empty (an upscale), and divides each
//   channel's sum by the pixel count with truncation.
//
// What bounds them: bytes. Each is a gather over interleaved uint8 with one
// integer add per byte read. One thread per output pixel and its three
// channels; neighbouring threads take neighbouring output columns, so a
// warp's reads of one input row are one contiguous run of 32 blocks (or
// windows) of 3-byte pixels. Rows go to grid.y (a grid-stride loop beyond
// 65535). A simple kernel that is right: the images are at most a few
// megabytes and one launch each per training image.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;

__global__ void scale_reduce_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
                                    int h, int w, int ho, int wo, int d) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  if (ox >= wo) return;
  const unsigned n = static_cast<unsigned>(d) * d;
  for (int oy = blockIdx.y; oy < ho; oy += gridDim.y) {
    unsigned s0 = 0, s1 = 0, s2 = 0;
    for (int i = 0; i < d; ++i) {
      const int yy = min(oy * d + i, h - 1);
      const uint8_t* row = x + static_cast<size_t>(yy) * w * 3;
      for (int j = 0; j < d; ++j) {
        const uint8_t* p = row + static_cast<size_t>(min(ox * d + j, w - 1)) * 3;
        s0 += p[0];
        s1 += p[1];
        s2 += p[2];
      }
    }
    uint8_t* o = y + (static_cast<size_t>(oy) * wo + ox) * 3;
    o[0] = static_cast<uint8_t>((s0 + n / 2) / n);
    o[1] = static_cast<uint8_t>((s1 + n / 2) / n);
    o[2] = static_cast<uint8_t>((s2 + n / 2) / n);
  }
}

__global__ void box_resize_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
                                  int sh, int sw, int dh, int dw) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  if (ox >= dw) return;
  const long long x0 = static_cast<long long>(ox) * sw / dw;
  long long x1 = static_cast<long long>(ox + 1) * sw / dw;
  if (x1 <= x0) x1 = x0 + 1;
  for (int oy = blockIdx.y; oy < dh; oy += gridDim.y) {
    const long long y0 = static_cast<long long>(oy) * sh / dh;
    long long y1 = static_cast<long long>(oy + 1) * sh / dh;
    if (y1 <= y0) y1 = y0 + 1;
    unsigned long long a0 = 0, a1 = 0, a2 = 0;
    for (long long yy = y0; yy < y1; ++yy) {
      const uint8_t* row = x + (yy * sw + x0) * 3;
      for (long long k = 0; k < x1 - x0; ++k) {
        a0 += row[k * 3 + 0];
        a1 += row[k * 3 + 1];
        a2 += row[k * 3 + 2];
      }
    }
    const unsigned long long n = static_cast<unsigned long long>((y1 - y0) * (x1 - x0));
    uint8_t* o = y + (static_cast<size_t>(oy) * dw + ox) * 3;
    o[0] = static_cast<uint8_t>(a0 / n);
    o[1] = static_cast<uint8_t>(a1 / n);
    o[2] = static_cast<uint8_t>(a2 / n);
  }
}

dim3 grid_for(int rows, int cols) {
  return dim3((cols + kThreads - 1) / kThreads, rows < 65535 ? rows : 65535);
}

}  // namespace

// x: (h, w, 3) uint8, y: (ceil(h/d), ceil(w/d), 3) uint8, 1 <= d <= 8
extern "C" int cd_scale_reduce_u8(const void* x, void* y, int h, int w, int d, void* stream) {
  const int ho = (h + d - 1) / d, wo = (w + d - 1) / d;
  if (ho > 0 && wo > 0) {
    scale_reduce_kernel<<<grid_for(ho, wo), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x), static_cast<uint8_t*>(y), h, w, ho, wo, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// x: (sh, sw, 3) uint8, y: (dh, dw, 3) uint8
extern "C" int cd_box_resize_u8(const void* x, void* y, int sh, int sw, int dh, int dw,
                                void* stream) {
  if (dh > 0 && dw > 0) {
    box_resize_kernel<<<grid_for(dh, dw), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x), static_cast<uint8_t*>(y), sh, sw, dh, dw);
  }
  return static_cast<int>(cudaGetLastError());
}
