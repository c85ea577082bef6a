// bf16 implicit GEMM on the tensor cores (mma.sync m16n8k16, or wgmma
// m64n64k16 at 64-wide Cout tiles; f32 sums) for sm_90a: the persistent ring
// kernel of the bf16 conv3x3 (conv3x3_bf16.cu) and of the bf16 1x1
// (conv1x1.cu).
//
// It computes y[p, co] = act(sum_k A[p, k] * B[k, co] + bias[co]), rounded
// once to bf16, with A the pixels (for the 3x3 the nine taps of a reflect-
// padded tile, for the 1x1 a run of consecutive pixels) and B the weights
// (HWIO or (Cin, Cout)). One template, `Ring<TAPS, CK, NT, TH, TW, S, WARPS, WG>`:
//   * persistent blocks: one block of 8 or 16 warps an SM (the grid is the
//     launch plan's, ops/cuda/conv.py:launch_plan_bf16, at most the SMs).
//     Block b keeps one Cout tile of NT couts, b % cout_tiles, for its whole
//     life and walks the pixel tiles b / cout_tiles, + grid / cout_tiles, ...
//     (TH x TW pixels of one image for the 3x3, TH * TW consecutive pixels
//     for the 1x1; the blocks of both Cout tiles of a 128-wide layer read the
//     same pixel tile at about the same time, the second from L2);
//   * resident weights: the block copies its Cout tile's weights, every tap
//     and every Cin chunk, into shared memory once (cast to nothing: bf16
//     stays bf16) and keeps them. Where they do not fit beside the ring (Cin
//     256/512, the teachers' widths) the plan says so and each step streams
//     its chunk's weights through the ring slot instead;
//   * an S-slot cp.async ring of steps, a step being one pixel tile and one
//     chunk of CK input channels (the 3x3's tile with its one-pixel border;
//     the 1x1's run with all of Cin, CK its capacity): while the block
//     multiplies step j, steps j+1 .. j+S-1 are in flight, and one
//     __syncthreads a step separates the slot's reads from its refill.
//     16-byte cp.async where Cin % 8 == 0 and x is 16-byte aligned (channels
//     past Cin zero-filled by the copy itself), 2-byte loads otherwise (Cin
//     = 3, offset views); at Cin <= 8 the loads go through registers one
//     step ahead. A tile whose border lies inside the map addresses all its
//     pixels from one pointer; reflect indices are computed only on the
//     others (reflect_index semantics, ops/pad.py);
//   * K in groups of 8 channels: group kg of a chunk is tap kg / G, channels
//     8 (kg % G) .. +7, G = CK / 8 (the 1x1: ceil(Cin / 8)). An ldmatrix row
//     address is per lane, so each 8-deep half of an m16n8k16 step may sit at
//     another tap: A (pixels x k) comes out of the staged tile by
//     ldmatrix.x4, B (k x couts) out of the resident weights by
//     ldmatrix.x4.trans (x2 at NT = 8). An odd last group reads a zero row
//     for A and zero weight rows for B. With WG (the 64- and 128-wide
//     layers, at and above the 295 FLOP/B ridge) a warpgroup issues wgmma
//     m64n64k16 on its 4 warps' ldmatrix'd A fragments, B read by the
//     tensor cores straight from the resident weights through a shared-
//     memory descriptor: their rows are 128 bytes (64 couts) and their
//     swizzle is wgmma's 128-byte one, so no copy re-lays them out;
//   * each warp owns MF m16 fragments (16 pixels each: a tile row segment)
//     for all NT couts, MF * NT / 2 f32 sums a thread (32 or 64); the k
//     loop is unrolled, so every ldmatrix address is a per-lane base plus a
//     constant;
//   * halo rows (the 3x3, kernel template flag HALO): a shard of a row-
//     sharded map convolved as the reference's conv3x3_halo does it
//     (parallel/spatial.py:79-88): the staging reads map row -1 of image n
//     from top + n top_stride and row H from bot + n bot_stride where those
//     are given (the neighbour shards' boundary rows, read in place, through
//     a peer pointer where they lie on another card), and reflects where one
//     is null; columns reflect inside a halo row too, the corners of the
//     reference's W-only pad. Only the units of a tile whose border leaves
//     the map pick a source; interior tiles address as without HALO. The
//     flag is a template argument, so the instantiations without it carry
//     no halo code;
//   * epilogue: + bias (bf16 or f32) in f32, ReLU (NaN stays NaN), one RNE
//     rounding, written into the warp's own staging area in shared memory and
//     stored from there as 16-byte vectors (Cout % 8 == 0: a fragment's 16
//     pixels are one contiguous run), 2-byte elements otherwise (Cout 3). The
//     warp needs no block barrier for it, so its stores overlap the other
//     warps' products and the ring's loads.
//   * the 3x3's fused pool and upsample (kernel template flags POOL and UP,
//     conv3x3_bf16.cu's head says why). POOL: the staging rows hold the
//     rounded outputs of the block's tile, fragment f at rows 16 f ..; a 2x2
//     window's two tile rows are fragments TW / 16 apart, in one warp where
//     its fragments are an even number of tile rows, else in the warps 2i
//     and 2i + 1, which meet at a named barrier of their own (64 threads)
//     and store half the pooled row each. The max is taken of the rounded
//     values in pool.cu's order (a NaN wins), so it is the pool of the
//     rounded map bit for bit. UP: x is the half-resolution map; a staged
//     unit of the 2H x 2W map it stands for is reflected on that map and
//     read from (gy >> 1, gx >> 1) of x by its cp.async source address.
// Bank conflicts: staged pixels have a stride of an odd number of 16-byte
// units (CK + 8 where CK / 8 is even), weight and output rows XOR their
// 16-byte unit index with the row (swz), so the eight rows one ldmatrix
// phase or one store instruction touches fall in distinct banks.
// No TMA: the copies are cp.async, and A always comes through ldmatrix.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// internal linkage: each translation unit that includes it has its own copy
namespace cd_bf16 {
namespace {

constexpr int kMaxSmem = 232448;   // an H100 block's opt-in shared memory
constexpr int kMaxDevices = 64;

struct Args {
  const unsigned short* x;   // bf16 bits, NHWC or (P, Cin)
  const unsigned short* w;   // bf16 bits, (TAPS, Cin, Cout): HWIO or (Cin, Cout)
  const void* b;             // (Cout,) bf16 or f32, or null
  __nv_bfloat16* y;          // (..., Cout)
  long long P;               // pixels (the 1x1)
  int tiles;                 // pixel tiles of the whole batch
  int H, W, tiles_w;         // map and tile columns (the 3x3)
  int Cin, Cout, cout_tiles, chunks, resident;
  int relu, bias_bf16, vec_x, vec_w, vec_y;
  // halo rows (the 3x3 with HALO): image 0's row -1 and row H, (W, Cin)
  // each, image n's *_stride elements further on; null: reflect
  const unsigned short* top;
  const unsigned short* bot;
  long long top_stride, bot_stride;
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

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
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

// sm_90a warpgroup MMA, D (64 x 64 f32, 8 n8 blocks of the m16n8 layout in
// each warp) += A (64 x 16 bf16 from registers: each warp's 16 rows in the
// m16n8k16 A layout) * B (16 x 64 bf16 in shared memory, through desc).
// TB = 1: B is MN-major (couts contiguous), as the resident weights are.
template <int TB>
__device__ __forceinline__ void wgmma_64x64(float (&d)[8][4], const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %37;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(TB), "r"(1));
}

// The shared-memory descriptor of a 16 x 64 bf16 B block at addr: MN-major
// rows of 128 bytes (64 couts), the 128-byte swizzle (16-byte unit q of row
// r at q ^ (r & 7), addr 1024-byte aligned), 8-row groups 1024 bytes apart.
// One swizzle atom spans all 64 couts, so the leading offset is unused; it
// is set to the same 1024 bytes.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of r across the asynchronous MMAs
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// 16 bytes from global to shared, zero-filled where !valid (nothing read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// The map that staging reads row gy of an image from, for a row outside
// [0, H): row -1 from top_n and row H from bot_n (the image's halo rows)
// where given, gy moved to 0 in it (so a one-row shard takes both rows and
// never reflects onto itself); any other row reflects into xn
__device__ __forceinline__ const unsigned short* edge_row(const unsigned short* xn,
                                                          const unsigned short* top_n,
                                                          const unsigned short* bot_n, int& gy,
                                                          int H) {
  if (gy == -1 && top_n) {
    gy = 0;
    return top_n;
  }
  if (gy == H && bot_n) {
    gy = 0;
    return bot_n;
  }
  gy = reflect1(gy, H);
  return xn;
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

// pool.cu's bf16 max, 8 lanes at a time: the comparison in float (exact),
// one of the two inputs out; a NaN wins, of two equal values the second
__device__ __forceinline__ uint32_t bmax2(uint32_t a, uint32_t b) {
  uint32_t r = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t ua = (a >> (16 * h)) & 0xFFFFu, ub = (b >> (16 * h)) & 0xFFFFu;
    const float fa = __uint_as_float(ua << 16), fb = __uint_as_float(ub << 16);
    r |= ((fa > fb || fa != fa) ? ua : ub) << (16 * h);
  }
  return r;
}
__device__ __forceinline__ uint4 bmax8(uint4 a, uint4 b) {
  return make_uint4(bmax2(a.x, b.x), bmax2(a.y, b.y), bmax2(a.z, b.z), bmax2(a.w, b.w));
}

// The XOR of a row of U 16-byte units: the 16-byte unit q of row r sits at
// q ^ swz<U>(r), so that the same unit of 8 consecutive rows (one ldmatrix
// phase, one store instruction) lands in 8 distinct bank groups.
template <int U>
__device__ __forceinline__ int swz(int r) {
  if constexpr (U >= 8) return r & 7;
  else if constexpr (U == 4) return (r >> 1) & 3;
  else if constexpr (U == 2) return (r >> 2) & 1;
  else return 0;
}

// The template: TAPS 9 (3x3) or 1 (1x1); CK input channels a step stages
// (the 1x1: its capacity); NT couts a block; a TH x TW pixel tile (the 1x1:
// TH * TW consecutive pixels, TW = 16); S ring slots; WARPS warps a block
// (16 where the Cout tile is narrow and the work a warp is little, so that
// twice the warps hide each other's latencies; 8 at NT 64 and 128, where a
// warp's fragments share each B load); WG 1: the products are wgmma
// (m64n64k16, a warpgroup's fragment mf of each of its 4 warps at once, B
// from the resident weights), else mma.sync.
template <int TAPS_, int CK_, int NT_, int TH_, int TW_, int S_, int WARPS_, int WG_>
struct Ring {
  static constexpr int TAPS = TAPS_, CK = CK_, NT = NT_, TH = TH_, TW = TW_, S = S_;
  static constexpr int WARPS = WARPS_, THREADS = 32 * WARPS_, WG = WG_;
  static constexpr int XS = (CK / 8) % 2 == 0 ? CK + 8 : CK;   // staged pixel stride
  static constexpr int SP = TAPS == 9 ? (TH + 2) * (TW + 2) : TH * TW;   // staged pixels
  static constexpr int FR = TH * TW / 16;   // m16 fragments of a tile
  static constexpr int MF = FR / WARPS;     // a warp's
  static constexpr int U = NT / 8;          // 16-byte units of a weight or output row
  static_assert(TW % 16 == 0 && FR % WARPS == 0 && (U == 1 || U % 2 == 0), "tile");
  static_assert(TAPS == 1 || CK <= 32, "3x3 chunks");
  static_assert(!WG || (TAPS == 9 && NT == 64 && CK % 16 == 0 && WARPS % 4 == 0), "wgmma");
};

// Weight rows of one chunk (a multiple of 16: whole k16 steps)
template <class R>
__host__ __device__ inline int k_rows(int cin) {
  const int groups = R::TAPS == 9 ? R::CK / 8 : (cin + 7) / 8;
  return (R::TAPS * groups * 8 + 15) / 16 * 16;
}

// Dynamic shared memory: the weights (resident: all chunks; streamed: one
// chunk a slot; first, so that wgmma's swizzled B is 1024-byte aligned), the
// ring's pixel slots, the warps' output staging, 16 zero bytes
template <class R>
__host__ __device__ inline size_t smem_bytes(int cin, int chunks, bool resident) {
  const size_t w = (size_t)(resident ? chunks : R::S) * k_rows<R>(cin) * R::NT;
  return 2 * ((size_t)R::S * R::SP * R::XS + w + (size_t)R::TH * R::TW * R::NT) + 16;
}

template <class R, bool HALO = false, bool POOL = false, bool UP = false>
__global__ void __launch_bounds__(R::THREADS, 1) bf16_ring_kernel(const Args a) {
  static_assert(!HALO || R::TAPS == 9, "halo rows are the 3x3's");
  static_assert(!(POOL || UP) || (R::TAPS == 9 && !HALO && POOL != UP), "one 3x3 fused flag");
  constexpr int TAPS = R::TAPS, CK = R::CK, NT = R::NT, TH = R::TH, TW = R::TW, S = R::S;
  constexpr int kThreads = R::THREADS;
  constexpr int XS = R::XS, SP = R::SP, MF = R::MF, U = R::U;
  // Cin <= 8 (Cin 3: 6-byte pixels, no 16-byte copies): the pixels go
  // through registers, loaded a step ahead of their store into the ring, so
  // their latency hides behind a step's products as cp.async's does
  constexpr bool PRE = TAPS == 9 && CK == 8;
  constexpr int PN = PRE ? (SP + kThreads - 1) / kThreads : 1;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int KR = k_rows<R>(a.Cin);
  const int G = TAPS == 9 ? CK / 8 : (a.Cin + 7) / 8;   // k groups of one tap
  const int kgt = TAPS * G;                              // k groups of a chunk
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [chunks or S][KR][NT],
                                                                     // rows swizzled
  __nv_bfloat16* xs = ws + (a.resident ? a.chunks : S) * KR * NT;   // [S][SP][XS]
  __nv_bfloat16* os = xs + S * SP * XS;      // [warps][MF*16][NT]
  __nv_bfloat16* zrow = os + TH * TW * NT;   // 8 zeros

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ct = blockIdx.x % a.cout_tiles;
  const int n0 = ct * NT;
  const int t_first = blockIdx.x / a.cout_tiles, t_step = gridDim.x / a.cout_tiles;
  const int my_tiles = t_first < a.tiles ? (a.tiles - t_first + t_step - 1) / t_step : 0;
  const int steps = my_tiles * a.chunks;
  const int per_image = (a.H + TH - 1) / TH * a.tiles_w;   // the 3x3's tiles an image
  if (tid == 0) *reinterpret_cast<uint4*>(zrow) = make_uint4(0u, 0u, 0u, 0u);

  // A step is (pixel tile t, Cin chunk c), the chunks of a tile in a row:
  // step j of this block is tile t_first + (j / chunks) t_step, chunk j % chunks
  struct Step {
    int t, c;
  };
  auto next = [&](Step st) {
    if (++st.c == a.chunks) {
      st.c = 0;
      st.t += t_step;
    }
    return st;
  };
  // the 3x3 tile's image, first row and first column
  auto origin = [&](int t, int& img, int& ty0, int& tx0) {
    img = t / per_image;
    const int r = t - img * per_image, ty = r / a.tiles_w;
    ty0 = ty * TH;
    tx0 = (r - ty * a.tiles_w) * TW;
  };

  // one chunk of the Cout tile's weights into dst, row r = tap * 8 G + ci,
  // zero past Cin, past the chunk's taps and past Cout
  auto stage_w = [&](int c, __nv_bfloat16* dst) {
    const uint32_t base = smem_u32(dst);
    for (int e = tid; e < KR * U; e += kThreads) {
      const int r = e / U, q = e - (e / U) * U;
      const int tap = r / (8 * G), ci = c * CK + (r - tap * 8 * G);
      const int co = n0 + q * 8;
      const bool valid = tap < TAPS && ci < a.Cin && co < a.Cout;
      const unsigned short* src = a.w + ((long long)tap * a.Cin + ci) * a.Cout + co;
      const uint32_t d = base + (uint32_t)(r * NT + ((q ^ swz<U>(r)) * 8)) * 2u;
      if (a.vec_w) {
        cp_async16(d, valid ? src : a.w, valid);
      } else {
        const uint4 v = valid ? load8_masked(src, co, a.Cout) : make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(dst + r * NT + (q ^ swz<U>(r)) * 8) = v;
      }
    }
  };

  // The step's staged units: unit e is pixel sp = e / G of the slot (the
  // 3x3: halo row sp / (TW + 2), column sp % (TW + 2)), channels
  // ch = c CK + 8 (e % G) ..; fn(k, dst, src, ch, valid) for this thread's
  // k-th unit e = tid + k kThreads, dst its offset in the slot. An interior
  // 3x3 tile (its border inside the map) and a 1x1 run address every unit
  // from one base pointer; the other 3x3 tiles reflect per unit (HALO:
  // rows -1 and H from the image's halo rows where given).
  auto units = [&](Step st, auto&& fn) {
    if constexpr (TAPS == 9) {
      const int ch0 = st.c * CK;
      int img, ty0, tx0;
      origin(st.t, img, ty0, tx0);
      const bool inner = ty0 >= 1 && ty0 + TH < a.H && tx0 >= 1 && tx0 + TW < a.W;
      const unsigned short* xb =
          a.x + (((long long)img * a.H + ty0 - 1) * a.W + tx0 - 1) * a.Cin + ch0;
      const int row = a.W * a.Cin;
      int k = 0;
      for (int e = tid; e < SP * G; e += kThreads, ++k) {
        const int sp = e / G, g = e - (e / G) * G;
        const int hy = sp / (TW + 2), hx = sp - (sp / (TW + 2)) * (TW + 2);
        const unsigned short* src;
        if constexpr (UP) {   // x: the (H / 2, W / 2) map the upsampled one stands for
          int gy = ty0 - 1 + hy, gx = tx0 - 1 + hx;
          if ((unsigned)gy >= (unsigned)a.H) gy = reflect1(gy, a.H);
          if ((unsigned)gx >= (unsigned)a.W) gx = reflect1(gx, a.W);
          src = a.x + (((long long)img * (a.H >> 1) + (gy >> 1)) * (a.W >> 1) + (gx >> 1)) *
                          a.Cin + ch0 + g * 8;
        } else if (inner) {
          src = xb + hy * row + hx * a.Cin + g * 8;
        } else if constexpr (HALO) {
          int gy = ty0 - 1 + hy, gx = tx0 - 1 + hx;
          const unsigned short* xn = a.x + (long long)img * a.H * row;
          const unsigned short* xr = xn;
          if ((unsigned)gy >= (unsigned)a.H)
            xr = edge_row(xn, a.top ? a.top + img * a.top_stride : nullptr,
                          a.bot ? a.bot + img * a.bot_stride : nullptr, gy, a.H);
          if ((unsigned)gx >= (unsigned)a.W) gx = reflect1(gx, a.W);
          src = xr + ((long long)gy * a.W + gx) * a.Cin + ch0 + g * 8;
        } else {
          int gy = ty0 - 1 + hy, gx = tx0 - 1 + hx;
          if ((unsigned)gy >= (unsigned)a.H) gy = reflect1(gy, a.H);
          if ((unsigned)gx >= (unsigned)a.W) gx = reflect1(gx, a.W);
          src = a.x + (((long long)img * a.H + gy) * a.W + gx) * a.Cin + ch0 + g * 8;
        }
        fn(k, sp * XS + g * 8, src, ch0 + g * 8, ch0 + g * 8 < a.Cin);
      }
    } else {
      const long long p0 = (long long)st.t * (TH * TW);
      const unsigned short* xb = a.x + p0 * a.Cin;
      const int left = (int)min((long long)SP, a.P - p0);   // pixels in the run
      // (sp, g) of e = tid + k kThreads, stepped without dividing
      const int dq = kThreads / G, dr = kThreads - dq * G;
      int sp = tid / G, g = tid - (tid / G) * G, k = 0;
      for (int e = tid; e < SP * G; e += kThreads, ++k) {
        fn(k, sp * XS + g * 8, xb + (long long)sp * a.Cin + g * 8, g * 8,
           sp < left && g * 8 < a.Cin);
        sp += dq;
        g += dr;
        if (g >= G) {
          g -= G;
          ++sp;
        }
      }
    }
  };
  auto load_unit = [&](const unsigned short* src, int ch, bool valid) {
    if (!valid) return make_uint4(0u, 0u, 0u, 0u);
    if (a.vec_x) return *reinterpret_cast<const uint4*>(src);
    return load8_masked(src, ch, a.Cin);
  };

  // the ring's copies of step st into slot: 16-byte cp.async (PRE: the
  // pixels by pre_load and pre_store instead), and streamed weights
  auto issue = [&](Step st, int slot) {
    if constexpr (!PRE) {
      __nv_bfloat16* dst = xs + slot * SP * XS;
      const uint32_t base = smem_u32(dst);
      units(st, [&](int, int d, const unsigned short* src, int ch, bool valid) {
        if (a.vec_x)
          cp_async16(base + (uint32_t)d * 2u, valid ? src : a.x, valid);
        else
          *reinterpret_cast<uint4*>(dst + d) = load_unit(src, ch, valid);
      });
    }
    if (!a.resident) stage_w(st.c, ws + slot * KR * NT);
  };
  uint4 pre[PN];
  auto pre_load = [&](Step st) {
    units(st, [&](int k, int, const unsigned short* src, int ch, bool valid) {
#pragma unroll
      for (int i = 0; i < PN; ++i)   // a constant index keeps pre[] in registers
        if (i == k) pre[i] = load_unit(src, ch, valid);
    });
  };
  auto pre_store = [&](int slot) {
    __nv_bfloat16* dst = xs + slot * SP * XS;
#pragma unroll
    for (int k = 0; k < PN; ++k) {
      const int e = tid + k * kThreads;
      if (e < SP * G) *reinterpret_cast<uint4*>(dst + (e / G) * XS + (e % G) * 8) = pre[k];
    }
  };

  if (a.resident)
    for (int c = 0; c < a.chunks; ++c) stage_w(c, ws + c * KR * NT);

  // the lane's bias at its output columns n0 + 8 j + 2 tig (+1)
  const int gid = lane >> 2, tig = lane & 3;
  float bias[U][2];
#pragma unroll
  for (int j = 0; j < U; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = n0 + j * 8 + tig * 2 + h;
      float v = 0.f;
      if (a.b != nullptr && co < a.Cout)
        v = a.bias_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.b)[co])
                        : static_cast<const float*>(a.b)[co];
      bias[j][h] = v;
    }

  // the epilogue's stores: a pixel's NT couts in 16-byte units (whole), the
  // Cout tile's cw couts in 16-byte units (Cout % 8 == 0), else 2-byte
  // elements: the lane's first at pixel e_px, cout e_co, each next one 32
  // elements on, e_dpx pixels and e_dco couts further
  const int cw = min(NT, a.Cout - n0);
  const bool whole = a.vec_y && cw == NT;
  const int e_px = lane / cw, e_co = lane - e_px * cw;
  const int e_dpx = 32 / cw, e_dco = 32 - e_dpx * cw;

  Step is{t_first, 0};   // the next step to issue
#pragma unroll
  for (int j = 0; j < S - 1; ++j) {
    if (j < steps) {
      issue(is, j);
      if constexpr (PRE) {
        pre_load(is);
        pre_store(j);
      }
      is = next(is);
    }
    cp_async_commit();
  }
  if constexpr (PRE)
    if (S - 1 < steps) pre_load(is);

  // ldmatrix.x4 row addresses: lanes 0-7, 8-15, 16-23, 24-31 give matrices
  // 0-3. A: rows (pixels) 0-7 / 8-15 of k 0-7, then of k 8-15. B (trans):
  // k rows 0-7 / 8-15 of couts 0-7, then of couts 8-15
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lhalf = lane >> 4;
  const uint32_t z_addr = smem_u32(zrow);
  // this lane's A row in its first fragment (the 3x3: at tap 0, from the
  // staged tile's top-left), in bytes; fragment mf sits a_step(mf) further
  // (a compile-time offset: the warp's fragments are whole tile rows); B:
  // k row lrow of couts 16 nb + 8 lhalf (its swizzle is that of every k row
  // 16 s + lrow)
  static_assert(TAPS == 1 || MF % (TW / 16) == 0, "a warp's fragments are whole tile rows");
  uint32_t a_off;
  if constexpr (TAPS == 9)
    a_off = (uint32_t)((warp * MF / (TW / 16) * (TW + 2) + lrow) * XS) * 2u;
  else
    a_off = (uint32_t)((warp * MF * 16 + lrow) * XS) * 2u;
  auto a_step = [](int mf) {
    return TAPS == 9 ? ((mf / (TW / 16)) * (TW + 2) + (mf % (TW / 16)) * 16) * XS * 2
                     : mf * 16 * XS * 2;
  };
  uint32_t b_off[(U + 1) / 2];
#pragma unroll
  for (int nb = 0; nb < (U + 1) / 2; ++nb)
    b_off[nb] = (uint32_t)(lrow * NT + (U == 1 ? 0 : ((2 * nb + lhalf) ^ swz<U>(lrow)) * 8)) * 2u;
  float acc[MF][U][4];

  Step cs{t_first, 0};   // the step being multiplied
  for (int j = 0; j < steps; ++j) {
    cp_async_wait<S - 2>();
    __syncthreads();   // step j staged by all; step j - 1's slot free
    if (j + S - 1 < steps) {
      issue(is, (j + S - 1) % S);
      if constexpr (PRE) {
        pre_store((j + S - 1) % S);
        if (j + S < steps) pre_load(next(is));
      }
      is = next(is);
    }
    cp_async_commit();

    const int slot = j % S;
    if (cs.c == 0) {
#pragma unroll
      for (int m = 0; m < MF; ++m)
#pragma unroll
        for (int q = 0; q < U; ++q)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[m][q][r] = 0.f;
    }
    const uint32_t xa = smem_u32(xs + slot * SP * XS) + a_off;
    const uint32_t ws_base = smem_u32(ws + (a.resident ? cs.c : slot) * KR * NT);
    // one k16 step: B (k rows 16 s .., all NT couts), then each fragment's A
    // at the lane's k group (byte offset koff; zero: the zero row) and its U
    // products
    auto k_step = [&](int s, uint32_t koff, bool zero) {
      uint32_t bfr[(U + 1) / 2][4];
      const uint32_t wb = ws_base + (uint32_t)(s * 16 * NT * 2);
      if constexpr (U == 1) {
        ldsm_x2_t(bfr[0], wb + b_off[0]);
      } else {
#pragma unroll
        for (int nb = 0; nb < U / 2; ++nb) ldsm_x4_t(bfr[nb], wb + b_off[nb]);
      }
      const uint32_t xk = xa + koff;
#pragma unroll
      for (int mf = 0; mf < MF; ++mf) {
        uint32_t afr[4];
        ldsm_x4(afr, zero ? z_addr : xk + (uint32_t)a_step(mf));
#pragma unroll
        for (int q = 0; q < U; ++q)
          mma_bf16(acc[mf][q], afr, bfr[q / 2][(q & 1) * 2], bfr[q / 2][(q & 1) * 2 + 1]);
      }
    };
    if constexpr (TAPS == 9) {
      // k group kg = 2 s + lhalf: tap kg / G at rows + tap / 3 and columns +
      // tap % 3, channels 8 (kg % G) ..; unrolled, so each step's two
      // offsets are constants
      constexpr int G9 = CK / 8, KG = 9 * G9;
      auto koff = [&](int s) {
        const int kg0 = 2 * s, kg1 = 2 * s + 1;
        const uint32_t o0 = (uint32_t)((((kg0 / G9) / 3) * (TW + 2) + (kg0 / G9) % 3) * XS +
                                       (kg0 % G9) * 8) * 2u;
        const uint32_t o1 = (uint32_t)((((kg1 / G9) / 3) * (TW + 2) + (kg1 / G9) % 3) * XS +
                                       (kg1 % G9) * 8) * 2u;
        return lhalf ? o1 : o0;
      };
      if constexpr (R::WG) {
        // a warpgroup's m64 product: fragment mf of each of its 4 warps. A
        // (this warp's fragment, from ldmatrix) is double-buffered across
        // k steps: step s's loads overlap step s - 1's products, which are
        // waited for before step s + 1 reuses their registers
        uint32_t afr[2][MF][4];
#pragma unroll
        for (int m = 0; m < MF; ++m)
#pragma unroll
          for (int q = 0; q < U; ++q)
#pragma unroll
            for (int r = 0; r < 4; ++r) reg_fence(acc[m][q][r]);
#pragma unroll
        for (int s = 0; s < KG / 2; ++s) {
          const uint32_t xk = xa + koff(s);
#pragma unroll
          for (int mf = 0; mf < MF; ++mf) ldsm_x4(afr[s & 1][mf], xk + (uint32_t)a_step(mf));
          wgmma_fence();
          const uint64_t desc = wgmma_desc(ws_base + (uint32_t)(s * 16 * NT * 2));
#pragma unroll
          for (int mf = 0; mf < MF; ++mf) wgmma_64x64<1>(acc[mf], afr[s & 1][mf], desc);
          wgmma_commit();
          wgmma_wait<1>();
        }
        wgmma_wait<0>();
#pragma unroll
        for (int m = 0; m < MF; ++m)
#pragma unroll
          for (int q = 0; q < U; ++q)
#pragma unroll
            for (int r = 0; r < 4; ++r) reg_fence(acc[m][q][r]);
      } else {
#pragma unroll
        for (int s = 0; s < (KG + 1) / 2; ++s) k_step(s, koff(s), lhalf && 2 * s + 1 >= KG);
      }
    } else {
      for (int s = 0; s < (kgt + 1) / 2; ++s) {
        const int kg = 2 * s + lhalf;
        k_step(s, (uint32_t)kg * 16u, kg >= kgt);
      }
    }
    const Step done = cs;
    cs = next(cs);
    if (done.c != a.chunks - 1) continue;

    // epilogue: bias, ReLU, one rounding, into the warp's staging rows
    // (row mf * 16 + pixel), then 16-byte (or 2-byte) stores of each fragment
    __nv_bfloat16* wos = os + warp * MF * 16 * NT;
#pragma unroll
    for (int mf = 0; mf < MF; ++mf)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = mf * 16 + gid + 8 * h;
#pragma unroll
        for (int q = 0; q < U; ++q) {
          float v0 = acc[mf][q][2 * h] + bias[q][0];
          float v1 = acc[mf][q][2 * h + 1] + bias[q][1];
          if (a.relu) {   // NaN stays NaN, as in torch.relu
            if (v0 < 0.f) v0 = 0.f;
            if (v1 < 0.f) v1 = 0.f;
          }
          *reinterpret_cast<__nv_bfloat162*>(wos + row * NT + (q ^ swz<U>(row)) * 8 +
                                             tig * 2) = __floats2bfloat162_rn(v0, v1);
        }
      }
    __syncwarp();
    int img = 0, ty0 = 0, tx0 = 0;
    if constexpr (TAPS == 9) origin(done.t, img, ty0, tx0);
    if constexpr (POOL) {
      // pooled row pr of a group (one warp, or warps 2i and 2i + 1) is tile
      // rows 2 pr and 2 pr + 1 of its own; pixel px of fragment f is staging
      // row 16 f + px, swizzled as row px of the warp's area
      constexpr int RPW = MF / (TW / 16);   // tile rows a warp
      constexpr int PG = RPW % 2 ? 2 : 1;   // warps a group
      static_assert(RPW % 2 == 0 || (RPW == 1 && R::WARPS % 2 == 0 && R::WARPS <= 30),
                    "pool pairs");
      constexpr int PR = PG * RPW / 2, PC = TW / 2;   // pooled rows and columns of a group
      if constexpr (PG == 2)
        asm volatile("bar.sync %0, %1;\n" ::"r"(1 + warp / 2), "r"(64) : "memory");
      const int tr0 = (warp / PG) * PG * RPW;
      const int Ho = a.H >> 1, Wo = a.W >> 1;
      for (int e = (warp % PG) * 32 + lane; e < PR * PC * U; e += PG * 32) {
        const int q = e % U, pc = (e / U) % PC, tr = tr0 + 2 * (e / (U * PC));
        const int oy = (ty0 + tr) >> 1, ox = (tx0 >> 1) + pc;
        if (oy >= Ho || ox >= Wo) continue;
        const int px = (2 * pc) % 16;
        const __nv_bfloat16* s0 = os + (tr * (TW / 16) + (2 * pc) / 16) * 16 * NT;
        const __nv_bfloat16* s1 = s0 + (TW / 16) * 16 * NT;   // the next tile row
        const int u0 = (q ^ swz<U>(px)) * 8, u1 = (q ^ swz<U>(px + 1)) * 8;
        const uint4 top = bmax8(*reinterpret_cast<const uint4*>(s0 + px * NT + u0),
                                *reinterpret_cast<const uint4*>(s0 + (px + 1) * NT + u1));
        const uint4 bot = bmax8(*reinterpret_cast<const uint4*>(s1 + px * NT + u0),
                                *reinterpret_cast<const uint4*>(s1 + (px + 1) * NT + u1));
        *reinterpret_cast<uint4*>(a.y + (((long long)img * Ho + oy) * Wo + ox) * a.Cout + n0 +
                                  q * 8) = bmax8(top, bot);
      }
      __syncwarp();
      continue;
    }
#pragma unroll
    for (int mf = 0; mf < MF; ++mf) {
      const int f = warp * MF + mf;
      long long pix;
      int nv;
      if constexpr (TAPS == 9) {
        const int tr = f / (TW / 16);
        const int gy = ty0 + tr, gx = tx0 + (f - tr * (TW / 16)) * 16;
        nv = gy < a.H ? max(0, min(16, a.W - gx)) : 0;
        pix = ((long long)img * a.H + gy) * a.W + gx;
      } else {
        pix = (long long)done.t * (TH * TW) + f * 16;
        nv = (int)max(0LL, min(16LL, a.P - pix));
      }
      __nv_bfloat16* yp = a.y + pix * a.Cout + n0;
      const __nv_bfloat16* src = wos + mf * 16 * NT;
      if (whole) {   // all NT couts of each pixel: 16 U units, U a pixel
#pragma unroll
        for (int i = 0; i < (16 * U + 31) / 32; ++i) {
          const int e = lane + 32 * i, px = e / U, q = e % U;
          if (px < nv)
            *reinterpret_cast<uint4*>(yp + (long long)px * a.Cout + q * 8) =
                *reinterpret_cast<const uint4*>(src + px * NT + (q ^ swz<U>(mf * 16 + px)) * 8);
        }
      } else if (a.vec_y) {
        const int uo = cw / 8;
        for (int e = lane; e < nv * uo; e += 32) {
          const int px = e / uo, q = e - (e / uo) * uo;
          *reinterpret_cast<uint4*>(yp + (long long)px * a.Cout + q * 8) =
              *reinterpret_cast<const uint4*>(src + px * NT + (q ^ swz<U>(mf * 16 + px)) * 8);
        }
      } else {   // 2-byte elements, lane + 32 i of the fragment's nv * cw
        for (int px = e_px, co = e_co; px < nv;) {
          yp[(long long)px * a.Cout + co] =
              src[px * NT + ((co / 8) ^ swz<U>(mf * 16 + px)) * 8 + co % 8];
          px += e_dpx;
          co += e_dco;
          if (co >= cw) {
            co -= cw;
            ++px;
          }
        }
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();
}

// One launch of template R (HALO: the 3x3 with halo rows) over ``grid``
// blocks: opts in to the card's largest dynamic shared memory once per
// device; refuses a plan whose shared memory exceeds it or whose grid is not
// whole Cout tiles.
template <class R, bool HALO = false, bool POOL = false, bool UP = false>
int launch(const Args& a, int grid, cudaStream_t s) {
  const size_t smem = smem_bytes<R>(a.Cin, a.chunks, a.resident != 0);
  if (smem > (size_t)kMaxSmem || grid <= 0 || grid % a.cout_tiles != 0 ||
      (R::TAPS == 1 && a.cout_tiles != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  // POOL stores whole 16-byte units of whole Cout tiles; UP needs an even map
  if ((POOL && !(a.vec_y && a.Cout % R::NT == 0)) || (UP && (a.H % 2 || a.W % 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = bf16_ring_kernel<R, HALO, POOL, UP>;
  static bool opted[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[dev] = true;
  }
  kernel<<<grid, R::THREADS, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

inline bool aligned(const void* p, size_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

// The fields every entry fills alike
inline Args make_args(const void* x, const void* w, const void* b, void* y, int cin, int cout,
                      int relu) {
  Args a{};
  a.x = static_cast<const unsigned short*>(x);
  a.w = static_cast<const unsigned short*>(w);
  a.b = b;
  a.y = static_cast<__nv_bfloat16*>(y);
  a.Cin = cin;
  a.Cout = cout;
  a.relu = relu;
  a.vec_x = cin % 8 == 0 && aligned(x, 16);
  a.vec_w = cout % 8 == 0 && aligned(w, 16);
  a.vec_y = cout % 8 == 0 && aligned(y, 16);
  return a;
}

}  // namespace
}  // namespace cd_bf16
