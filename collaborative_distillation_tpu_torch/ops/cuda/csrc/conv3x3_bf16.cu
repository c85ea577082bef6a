// Reflect-padded 3x3 conv, bf16 NHWC in and out with f32 accumulation, on the
// tensor cores, for sm_90a.
//
// Replaces the bfloat16 instantiation of conv3x3_lane128, conv3x3_tiled and
// conv3x3_subin (reference ops/pallas/conv.py:332, :754, :1039; contract at
// :340, "bf16 in -> bf16 out with f32 accumulation inside"; try_conv3x3_tiled
// routes bf16 maps at :837): y = act(reflect_pad(x) (*) w + b), rounded once.
//
// An implicit GEMM, M = the pixels of a 16x8 tile, N = Cout, K = 9 Cin, by
// the tile code of bf16_igemm.cuh (mma.sync m16n8k16 from ldmatrix'd staged
// tiles, f32 sums, one RNE rounding in the epilogue). Any Cin and Cout in
// 1..512; the 16-byte staging path needs Cin % 8 == 0 (the cascade's 16..128,
// the teachers' 256/512), Cin = 3 takes 2-byte loads.
//
// What bounds it on an H100: at the cascade's widths the bf16 product needs
// 2 * 9 Cin Cout FLOPs a pixel against 2 (Cin + Cout) bytes, under the 295
// FLOP/B ridge of 989 TFLOP/s over 3.35 TB/s for Cin, Cout <= 64 (bytes) and
// above it at 128 (operations). This first kernel does neither justice: one
// 128-pixel tile re-stages its 9 x 32 x NT weights every chunk and no copy
// overlaps the products; wgmma, TMA and a persistent ring are later work.

#include "bf16_igemm.cuh"

// x (N, H, W, Cin), w (3, 3, Cin, Cout) HWIO, both bf16; b (Cout,) bf16
// (bias_bf16) or f32, or null; y (N, H, W, Cout) bf16. N <= 65535.
extern "C" int cd_conv3x3_reflect_bf16(const void* x, const void* w, const void* b, void* y,
                                       int n, int h, int wd, int cin, int cout, int relu,
                                       int bias_bf16, void* stream) {
  using namespace cd_bf16;
  if ((long long)n * h * wd == 0) return static_cast<int>(cudaGetLastError());
  Args a;
  a.x = static_cast<const unsigned short*>(x);
  a.w = static_cast<const unsigned short*>(w);
  a.b = b;
  a.y = static_cast<__nv_bfloat16*>(y);
  a.P = (long long)n * h * wd;
  a.H = h;
  a.W = wd;
  a.Cin = cin;
  a.Cout = cout;
  a.relu = relu;
  a.bias_bf16 = bias_bf16;
  a.vec_x = cin % 8 == 0 && aligned(x, 16);
  a.vec_w = cout % 8 == 0 && aligned(w, 16);
  a.vec_y = cout % 2 == 0 && aligned(y, 4);
  const unsigned tiles = (unsigned)((h + kTileH - 1) / kTileH) * ((wd + kTileW - 1) / kTileW);
  return dispatch<Conv3x3Geom>(a, tiles, (unsigned)n, static_cast<cudaStream_t>(stream));
}
