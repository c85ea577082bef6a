// Reflect-padded 3x3 conv, bf16 NHWC in and out with f32 accumulation, on the
// tensor cores, for sm_90a.
//
// Replaces the bfloat16 instantiation of conv3x3_lane128, conv3x3_tiled and
// conv3x3_subin (reference ops/pallas/conv.py:332, :754, :1039; contract at
// :340, "bf16 in -> bf16 out with f32 accumulation inside"; try_conv3x3_tiled
// routes bf16 maps at :837): y = act(reflect_pad(x) (*) w + b), rounded once.
//
// An implicit GEMM, M = pixels, N = Cout, K = 9 Cin, by the persistent ring
// kernel of bf16_igemm.cuh (its head says how). Any Cin and Cout in 1..512;
// the 16-byte cp.async staging needs Cin % 8 == 0 (the cascade's 16..128,
// the teachers' 256/512), Cin = 3 takes 2-byte loads.
//
// What bounds it on an H100, per pixel 2 * 9 Cin Cout FLOPs against
// 2 (Cin + Cout) bytes, the ridge at 295 FLOP/B (989 TFLOP/s over 3.35 TB/s):
//   * Cin, Cout <= 32 (the 2048^2 and 10240-wide maps, most of the time):
//     bytes by the roofline, 27-144 FLOP/B. The first kernel reached 14-28 %
//     of that bound: a 16x8 tile staged 1.41x its pixels with no copy in
//     flight behind the products, re-staged its weights every 128 pixels,
//     stored 4 bytes a lane (2 at Cout 3) and ran reflect and division
//     arithmetic for every staged unit. Here 512- and 1024-pixel tiles
//     (16x32, 32x32) stage 1.13-1.20x, two steps are in flight behind the
//     one being multiplied, the weights stay resident, a fragment's 16
//     pixels leave as 16-byte vectors, an interior tile addresses its
//     units from one pointer and 16 warps share an SM. It reaches 29-60 %
//     of the byte bound: with one block an SM, instruction issue and
//     latency bind it before bytes do (Cin 3 and Cout 3 worst, 30-40 %);
//   * 64 -> 64 (288 FLOP/B, at the ridge) and the 128-wide layers (576):
//     operations. The first kernel re-staged 9 x 32 x 64 weights (36.9 KB)
//     against 11.5 KB of pixels every chunk and reached 10-13 %. Here the
//     whole Cin of a 64-wide Cout tile is resident (73.7 KB at Cin 64,
//     147 KB at 128, the latter with a two-slot ring) and the two Cout
//     halves of a 128-wide layer run on different blocks over the same
//     pixel tiles. On mma.sync (each of 8 warps re-reading B for its two
//     fragments; 4 or 16 warps were slower) that reached 21-33 %; the
//     products are now wgmma m64n64k16 with B from the resident weights in
//     place, 5-9 % faster again: A's ldmatrix staging and the ring's
//     latency, not the tensor cores, hold this class;
//   * Cin 256 / 512 (the teachers): the weights do not fit; they stream
//     through the ring with each 32-channel chunk.
// The template and the grid are ops/cuda/conv.py:launch_plan_bf16's, by id.
//
// Halo rows (the per-conv sharded path, kernel table row 8b): given `top` or
// `bot`, the launch is the template's HALO instantiation, whose staging reads
// map row -1 and row H from them in place (bf16_igemm.cuh's head), as the
// float32 kernel's HALO flag does (conv3x3.cu). Without them it is the
// instantiation without HALO, which has no halo code. What the rows must move
// is two rows of W x Cin bf16 a shard; the staging already computes a source
// for every unit of a tile that crosses the map's border, so the rows cost
// no pass and no launch of their own. The 16-byte copies need the rows and
// their image strides 16-byte aligned too; rows that are not take the
// kernel's 2-byte loads.
//
// Pool and upsample folded in (cd_conv3x3_bf16_fused; the templates the plan
// picks at the cascade's fused widths 16, 32, 64 and 128, ids 4, 8, 9, 10,
// resident weights). A conv before a 2x2 max pool wrote its full-resolution
// map for pool.cu to read back and write a quarter of; a conv after a
// nearest 2x upsample read the four copies pool.cu had written. With POOL the
// epilogue pools the rounded tile in shared memory and writes only the
// pooled map; with UP the staging reads the half-resolution map
// (bf16_igemm.cuh's head says how). Both compute the bits of the two-kernel
// sequence; the instantiations without the flags are the kernels they were.

#include "bf16_igemm.cuh"

namespace {

using cd_bf16::Ring;

//                             TAPS CK  NT  TH  TW  S  WARPS WG
using RingCk8Co16 = Ring<9, 8, 16, 32, 32, 3, 16, 0>;      //  91 KB (Cin 3)
using RingCk8Co32 = Ring<9, 8, 32, 16, 32, 3, 16, 0>;      //  67 KB
using RingCk16Co8 = Ring<9, 16, 8, 32, 32, 3, 16, 0>;      // 185 KB
using RingCk16Co16 = Ring<9, 16, 16, 32, 32, 3, 16, 0>;    // 204 KB
using RingCk16Co32 = Ring<9, 16, 32, 16, 32, 3, 16, 0>;    // 130 KB
using RingCk24Co8 = Ring<9, 24, 8, 32, 32, 3, 16, 0>;      // 186 KB
using RingCk32Co16 = Ring<9, 32, 16, 16, 32, 3, 16, 0>;    // 172 KB (Cin 32)
using RingCk32Co32 = Ring<9, 32, 32, 16, 32, 3, 16, 0>;    // 217 KB (Cin 64)
using RingCk32Co64 = Ring<9, 32, 64, 16, 16, 3, 8, 1>;     // 184 KB (Cin 64)
using RingCk32Co64S2 = Ring<9, 32, 64, 16, 16, 2, 8, 1>;   // 232 KB (Cin 128); streamed past it

template <class R>
int run(cd_bf16::Args a, int n, int grid, int resident, cudaStream_t s) {
  a.tiles_w = (a.W + R::TW - 1) / R::TW;
  const long long tiles = (long long)n * ((a.H + R::TH - 1) / R::TH) * a.tiles_w;
  a.cout_tiles = (a.Cout + R::NT - 1) / R::NT;
  a.chunks = (a.Cin + R::CK - 1) / R::CK;
  if (tiles * a.chunks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  a.tiles = (int)tiles;
  a.resident = resident;
  if (a.top || a.bot) return cd_bf16::launch<R, true>(a, grid, s);
  return cd_bf16::launch<R>(a, grid, s);
}

// run<R> with the pool after the conv (POOL) or the upsample before it
template <class R, bool POOL>
int run_fused(cd_bf16::Args a, int n, int grid, int resident, cudaStream_t s) {
  a.tiles_w = (a.W + R::TW - 1) / R::TW;
  const long long tiles = (long long)n * ((a.H + R::TH - 1) / R::TH) * a.tiles_w;
  a.cout_tiles = (a.Cout + R::NT - 1) / R::NT;
  a.chunks = (a.Cin + R::CK - 1) / R::CK;
  if (tiles * a.chunks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  a.tiles = (int)tiles;
  a.resident = resident;
  return cd_bf16::launch<R, false, POOL, !POOL>(a, grid, s);
}

}  // namespace

// x (N, H, W, Cin), w (3, 3, Cin, Cout) HWIO, both bf16; b (Cout,) bf16
// (bias_bf16) or f32, or null; y (N, H, W, Cout) bf16. top, bot: null, or
// one bf16 row (W, Cin) of image 0 that stands for map row -1 (row H),
// image i's row i * {top,bot}_stride elements further on. ``tmpl``,
// ``grid`` and ``resident`` are the launch plan's.
extern "C" int cd_conv3x3_reflect_bf16(const void* x, const void* w, const void* b, void* y,
                                       const void* top, const void* bot,
                                       long long top_stride, long long bot_stride, int n,
                                       int h, int wd, int cin, int cout, int relu,
                                       int bias_bf16, int tmpl, int grid, int resident,
                                       void* stream) {
  if ((long long)n * h * wd == 0) return static_cast<int>(cudaGetLastError());
  cd_bf16::Args a = cd_bf16::make_args(x, w, b, y, cin, cout, relu);
  a.H = h;
  a.W = wd;
  a.bias_bf16 = bias_bf16;
  a.top = static_cast<const unsigned short*>(top);
  a.bot = static_cast<const unsigned short*>(bot);
  a.top_stride = top ? top_stride : 0;
  a.bot_stride = bot ? bot_stride : 0;
  // the 16-byte copies read the halo rows as they read x
  a.vec_x = a.vec_x && cd_bf16::aligned(top, 16) && cd_bf16::aligned(bot, 16) &&
            a.top_stride % 8 == 0 && a.bot_stride % 8 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tmpl) {
    case 1: return run<RingCk8Co16>(a, n, grid, resident, s);
    case 2: return run<RingCk8Co32>(a, n, grid, resident, s);
    case 3: return run<RingCk16Co8>(a, n, grid, resident, s);
    case 4: return run<RingCk16Co16>(a, n, grid, resident, s);
    case 5: return run<RingCk16Co32>(a, n, grid, resident, s);
    case 6: return run<RingCk24Co8>(a, n, grid, resident, s);
    case 7: return run<RingCk32Co16>(a, n, grid, resident, s);
    case 8: return run<RingCk32Co32>(a, n, grid, resident, s);
    case 9: return run<RingCk32Co64>(a, n, grid, resident, s);
    case 10: return run<RingCk32Co64S2>(a, n, grid, resident, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bf16 conv with the 2x2 max pool after it (fuse 1: y is (N, H / 2,
// W / 2, Cout)) or the nearest 2x upsample before it (fuse 2: x is (N, H / 2,
// W / 2, Cin)); h, wd are the conv's map. Only the templates the launch plan
// fuses (../conv.py BF16_FUSED_TEMPLATES) are instantiated.
extern "C" int cd_conv3x3_bf16_fused(const void* x, const void* w, const void* b, void* y,
                                     int n, int h, int wd, int cin, int cout, int relu,
                                     int bias_bf16, int tmpl, int grid, int resident, int fuse,
                                     void* stream) {
  if ((long long)n * h * wd == 0 || (fuse != 1 && fuse != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cd_bf16::Args a = cd_bf16::make_args(x, w, b, y, cin, cout, relu);
  a.H = h;
  a.W = wd;
  a.bias_bf16 = bias_bf16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pool = fuse == 1;
  switch (tmpl) {
    case 4:
      return pool ? run_fused<RingCk16Co16, true>(a, n, grid, resident, s)
                  : run_fused<RingCk16Co16, false>(a, n, grid, resident, s);
    case 8:
      return pool ? run_fused<RingCk32Co32, true>(a, n, grid, resident, s)
                  : run_fused<RingCk32Co32, false>(a, n, grid, resident, s);
    case 9:
      return pool ? run_fused<RingCk32Co64, true>(a, n, grid, resident, s)
                  : run_fused<RingCk32Co64, false>(a, n, grid, resident, s);
    case 10:
      return pool ? run_fused<RingCk32Co64S2, true>(a, n, grid, resident, s)
                  : run_fused<RingCk32Co64S2, false>(a, n, grid, resident, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
