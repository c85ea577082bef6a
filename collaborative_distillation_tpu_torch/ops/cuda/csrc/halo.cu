// Row halos of row-sharded NHWC maps, any element type, for sm_90a: one
// launch copies a table of byte segments.
//
// It replaces halo_exchange_rows_pallas (reference ops/pallas/halo.py:148,
// body _halo_kernel :47-143), which turns a row shard (N, H, W, C) into
// (N, H + 2*hm, W, C): rows [hm, hm + H) the shard, rows [0, hm) the top
// halo, rows [hm + H, H + 2*hm) the bottom halo. Both uses of the port are
// segment tables built by the wrapper (ops/cuda/halo.py):
//   * the full exchange, halo_exchange_rows: three segments a shard (top
//     halo, interior, bottom halo) into a new extended map;
//   * the fill, halo_fill_rows: two segments a shard, the halo rows of an
//     extended map whose interior the previous stage's decode wrote in place.
// A segment is {src, dst, bytes an image, images, src and dst batch
// strides}; a null src is zero fill, the reference's contract at the global
// edges. A source is a neighbour shard's boundary rows, or for the one-row
// halos of a per-conv exchange the shard's own reflection row, and may lie
// on another card with peer access: the kernel only dereferences pointers.
//
// The reference pushes rows into the neighbour's output and needs a barrier
// and five semaphores for that. This kernel pulls from rows that nobody
// writes during the launch, so nothing is carried over of that protocol:
// ordering against the rows' producer is the stream's (one card) or an
// event's (the wrapper, across cards).
//
// What bounds it: bytes, each halo byte read once and written once (and each
// interior byte of the full exchange). The table is a __grid_constant__
// parameter; blockIdx.y picks a segment, so a block knows its segment with
// no search and no per-unit branch, and the blocks of a segment stride over
// its units. The host cuts large segments into pieces of about equal size
// (at most kMaxPieces a launch), so that the blocks of one launch have equal
// work, and sizes the grid to the 132 SMs. Each thread loads kIlp units
// before it stores them, so four loads are in flight a thread. A segment
// whose pointers, length and strides are multiples of 16 bytes moves 16-byte
// units; otherwise 4-byte or 1-byte units. Offsets are size_t.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxPieces = 64;   // table entries of one launch (3 KB of parameters)
constexpr int kThreads = 256;
constexpr int kIlp = 4;
constexpr int kBlocksPerSm = 8;  // 2048 threads an SM
constexpr int kSms = 132;
constexpr int kTargetPieces = 32;  // the host cuts a table into about this many pieces more

struct Piece {
  const unsigned char* src;  // null: zero fill
  unsigned char* dst;
  long long bytes;           // an image
  long long src_stride;      // bytes from one image to the next
  long long dst_stride;
  int n;                     // images
  int unit;                  // 16, 4 or 1
};

struct Table {
  Piece p[kMaxPieces];
};

// Units [blockIdx.x * tile + tid, units) of one image, tile by tile: kIlp
// loads, then kIlp stores. ZERO stores zeros and reads nothing.
template <typename T, bool ZERO>
__device__ __forceinline__ void copy_units(const T* __restrict__ src, T* __restrict__ dst,
                                           size_t units) {
  constexpr size_t tile = (size_t)kThreads * kIlp;
  const size_t step = (size_t)gridDim.x * tile;
  size_t e = (size_t)blockIdx.x * tile + threadIdx.x;
  for (; e + (kIlp - 1) * kThreads < units; e += step) {
    T v[kIlp];
#pragma unroll
    for (int k = 0; k < kIlp; ++k) v[k] = ZERO ? T{} : src[e + k * kThreads];
#pragma unroll
    for (int k = 0; k < kIlp; ++k) dst[e + k * kThreads] = v[k];
  }
  if (e < units) {  // the segment's last, partial tile
    T v[kIlp];
#pragma unroll
    for (int k = 0; k < kIlp; ++k)
      if (e + k * kThreads < units) v[k] = ZERO ? T{} : src[e + k * kThreads];
#pragma unroll
    for (int k = 0; k < kIlp; ++k)
      if (e + k * kThreads < units) dst[e + k * kThreads] = v[k];
  }
}

template <typename T>
__device__ __forceinline__ void copy_piece(const Piece& g) {
  const size_t units = (size_t)g.bytes / sizeof(T);
  for (int i = 0; i < g.n; ++i) {
    T* dst = reinterpret_cast<T*>(g.dst + (size_t)i * g.dst_stride);
    if (g.src)
      copy_units<T, false>(reinterpret_cast<const T*>(g.src + (size_t)i * g.src_stride), dst,
                           units);
    else
      copy_units<T, true>(nullptr, dst, units);
  }
}

__global__ void __launch_bounds__(kThreads) segment_copy_kernel(const __grid_constant__ Table t) {
  const Piece& g = t.p[blockIdx.y];
  if (g.unit == 16)
    copy_piece<uint4>(g);
  else if (g.unit == 4)
    copy_piece<uint32_t>(g);
  else
    copy_piece<uint8_t>(g);
}

bool multiple_of(size_t bits, size_t unit) { return bits % unit == 0; }

int unit_of(const Piece& p) {
  size_t bits = reinterpret_cast<size_t>(p.src) | reinterpret_cast<size_t>(p.dst) |
                (size_t)p.bytes;
  if (p.n > 1) bits |= (size_t)p.dst_stride | (p.src ? (size_t)p.src_stride : 0);
  return multiple_of(bits, 16) ? 16 : multiple_of(bits, 4) ? 4 : 1;
}

// The launch's pieces from ``count`` rows of six int64, {src (0: zero fill),
// dst, bytes an image, images, src batch stride, dst batch stride}: a
// segment of n images is cut into pieces of `len` bytes an image (the last
// shorter), len a multiple of 16 and len * n about total / kTargetPieces,
// so at most count + kTargetPieces pieces, each with its segment's
// alignment. Returns the number of pieces; `largest` gets the most bytes a
// piece moves.
int build_table(const long long* table, int count, Table& t, long long& largest) {
  long long total = 0;
  for (int i = 0; i < count; ++i)
    if (table[6 * i + 2] > 0 && table[6 * i + 3] > 0) total += table[6 * i + 2] * table[6 * i + 3];
  const long long piece = (total + kTargetPieces - 1) / kTargetPieces;
  int np = 0;
  largest = 0;
  for (int i = 0; i < count && total > 0; ++i) {
    const long long* r = table + 6 * i;
    const long long bytes = r[2], n = r[3];
    if (bytes <= 0 || n <= 0) continue;
    const long long len = ((piece + n - 1) / n + 15) / 16 * 16;
    for (long long off = 0; off < bytes; off += len) {
      Piece& p = t.p[np++];
      p.src = r[0] ? reinterpret_cast<const unsigned char*>(r[0]) + off : nullptr;
      p.dst = reinterpret_cast<unsigned char*>(r[1]) + off;
      p.bytes = bytes - off < len ? bytes - off : len;
      p.n = static_cast<int>(n);
      p.src_stride = r[4];
      p.dst_stride = r[5];
      p.unit = unit_of(p);
      largest = p.bytes * n > largest ? p.bytes * n : largest;
    }
  }
  return np;
}

constexpr int kMaxSegments = kMaxPieces - kTargetPieces;  // segments a launch

}  // namespace

// table: ``count`` rows of six int64 each (build_table); pointers as
// integers, strides in bytes. Queues one launch on ``stream`` for each
// kMaxSegments rows that move a byte, and writes how many to ``launches``.
extern "C" int cd_halo_copy_segments(const long long* table, int count, int* launches,
                                     void* stream) {
  *launches = 0;
  if (count <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < count; i += kMaxSegments) {
    Table t{};
    long long largest = 0;
    const int part = count - i < kMaxSegments ? count - i : kMaxSegments;
    const int np = build_table(table + 6 * i, part, t, largest);
    if (np == 0) continue;
    const long long tile = 16LL * kThreads * kIlp;
    const long long tiles = (largest + tile - 1) / tile;
    long long gx = ((long long)kBlocksPerSm * kSms + np - 1) / np;
    gx = gx < tiles ? gx : tiles;
    segment_copy_kernel<<<dim3(static_cast<unsigned>(gx), np), kThreads, 0, s>>>(t);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launches;
  }
  return static_cast<int>(cudaSuccess);
}
