// Row-halo exchange of a row-sharded NHWC map, any element type, for sm_90a.
//
// halo_exchange_rows replaces halo_exchange_rows_pallas (reference
// ops/pallas/halo.py:148, body _halo_kernel :47-143): a shard (N, H, W, C)
// becomes (N, H + 2*hm, W, C), rows [hm, hm + H) the shard itself, rows
// [0, hm) the top halo and rows [hm + H, H + 2*hm) the bottom halo. One
// launch writes the whole extended map. Each halo is read straight from a
// source pointer with its own batch stride: the neighbour shard's boundary
// rows (its last hm rows for the top halo, its first hm for the bottom),
// or, for the one-row halos of a per-conv exchange at a global edge, the
// shard's own reflection row. A null source is zero fill, the reference's
// contract at the global edges. A source may lie on another card where the
// two have peer access: the kernel only dereferences the pointer.
//
// The reference pushes rows into the neighbour's output and needs a barrier
// and five semaphores for that. This kernel pulls from the neighbour's
// input, which nobody writes during the exchange, so nothing is carried over
// of that protocol: ordering against the producer of the neighbour's rows is
// the stream's (one stream on one card) or an event's (the wrapper, across
// cards).
//
// What bounds it: bytes. It is a copy: every output byte is written once and
// read once from one of three contiguous sources per image. Threads walk the
// output in 16-byte units where every pointer, segment length and batch
// stride is a multiple of 16 (checked at launch), in 4-byte or 1-byte units
// otherwise; neighbouring threads take neighbouring units, so every warp
// touches contiguous memory on both sides. Offsets are size_t throughout.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// Sizes and strides in units of T. x_img: one image of the shard; halo: one
// image's halo rows; per image the output is halo + x_img + halo units.
template <typename T>
__global__ void halo_rows_kernel(const T* __restrict__ x,
                                 const T* __restrict__ top,
                                 const T* __restrict__ bot,
                                 T* __restrict__ out, size_t x_img,
                                 size_t halo, size_t top_stride,
                                 size_t bot_stride, size_t total) {
  const size_t per_img = x_img + 2 * halo;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const size_t n = e / per_img;
    const size_t r = e - n * per_img;
    T v = T{};
    if (r < halo) {
      if (top) v = top[n * top_stride + r];
    } else if (r < halo + x_img) {
      v = x[n * x_img + (r - halo)];
    } else {
      if (bot) v = bot[n * bot_stride + (r - halo - x_img)];
    }
    out[e] = v;
  }
}

int blocks_for(size_t total) {
  const size_t b = (total + 255) / 256;
  return static_cast<int>(b < 1048576 ? b : 1048576);  // grid-stride beyond
}

bool multiple_of(size_t unit, const void* x, const void* top, const void* bot,
                 const void* out, size_t x_img, size_t halo, size_t top_stride,
                 size_t bot_stride) {
  const size_t bits = reinterpret_cast<size_t>(x) |
                      reinterpret_cast<size_t>(top) |
                      reinterpret_cast<size_t>(bot) |
                      reinterpret_cast<size_t>(out) | x_img | halo |
                      top_stride | bot_stride;
  return bits % unit == 0;  // unit is a power of two; null counts as aligned
}

template <typename T>
void launch(const void* x, const void* top, const void* bot, void* out,
            size_t n, size_t x_img, size_t halo, size_t top_stride,
            size_t bot_stride, cudaStream_t s) {
  const size_t u = sizeof(T);
  const size_t total = n * (x_img + 2 * halo) / u;
  halo_rows_kernel<T><<<blocks_for(total), 256, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(top),
      static_cast<const T*>(bot), static_cast<T*>(out), x_img / u, halo / u,
      top_stride / u, bot_stride / u, total);
}

}  // namespace

// x: (n, h) rows of row_bytes each, contiguous; out: (n, h + 2*hm) rows.
// top, bot: the first of hm contiguous rows for image 0, or null; image i's
// rows start i * {top,bot}_stride_bytes further on.
extern "C" int cd_halo_exchange_rows(const void* x, const void* top,
                                     const void* bot, void* out, long long n,
                                     long long h, long long hm,
                                     long long row_bytes,
                                     long long top_stride_bytes,
                                     long long bot_stride_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t x_img = (size_t)h * (size_t)row_bytes;
  const size_t halo = (size_t)hm * (size_t)row_bytes;
  const size_t ts = top ? (size_t)top_stride_bytes : 0;
  const size_t bs = bot ? (size_t)bot_stride_bytes : 0;
  if (n <= 0 || x_img + 2 * halo == 0)
    return static_cast<int>(cudaGetLastError());
  if (multiple_of(16, x, top, bot, out, x_img, halo, ts, bs)) {
    launch<uint4>(x, top, bot, out, (size_t)n, x_img, halo, ts, bs, s);
  } else if (multiple_of(4, x, top, bot, out, x_img, halo, ts, bs)) {
    launch<uint32_t>(x, top, bot, out, (size_t)n, x_img, halo, ts, bs, s);
  } else {
    launch<uint8_t>(x, top, bot, out, (size_t)n, x_img, halo, ts, bs, s);
  }
  return static_cast<int>(cudaGetLastError());
}
