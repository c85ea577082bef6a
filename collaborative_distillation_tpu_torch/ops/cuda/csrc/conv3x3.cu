// Reflect-padded 3x3 convolution + bias (+ ReLU), NHWC float32, for sm_90a.
//
// Replaces the reference package's three Pallas conv3x3 kernels for plain
// (unpacked) NHWC maps: conv3x3_tiled (ops/pallas/conv.py:754),
// conv3x3_subin (:1039) and conv3x3_lane128 (:332). They compute one
// function, y = act(reflectpad1(x) * w + b); the TPU split it by lane density,
// a distinction this card does not have.
//
// What bounds it: arithmetic. At the cascade's widths (Cin, Cout 16..128) a
// 3x3 conv does 18*Cin*Cout FLOPs per pixel against 4*(Cin+Cout) bytes, at or
// above the card's FP32 ridge (67 TFLOP/s over 3.35 TB/s, ~20 FLOP/B); the
// narrow full-resolution layers (3 -> 16, 16 -> 3, 16 -> 16) sit near it and
// need the bytes streamed as well. Accumulation is FP32 FFMA, not TF32, to
// match the reference's f32 HIGHEST-precision path; bias and ReLU run in the
// epilogue, and ReLU keeps NaN (o < 0 is false for NaN), as torch.relu does.
// Reflect padding lives in the index math: the padded map is never written.
// A size-1 dimension reflects onto itself (index -1 and index n both map to
// 0), as jnp.pad(mode="reflect") does and F.pad(mode="reflect") refuses.
//
// Two kernels, chosen per shape by the launch plan in ../conv.py
// (launch_plan), never as a fallback:
//
// ring_conv3x3_kernel (the path's and the teachers' widths: Cin and Cout in
// {3, 16, 24, 32, 64, 128, 256, 512}):
//   * a persistent block walks over TH x TW pixel tiles (grid stride) and
//     computes each for ALL of Cout (a Cout tile CO_T up to 128), so the
//     input halo is staged once per tile. Templates with WALK (the
//     teachers' widths) walk work items (pixel tile, Cout tile of CO_T)
//     instead, the Cout tile innermost, as the reference's conv3x3_tiled
//     orders its grid: the 2..8 Cout tiles of one pixel tile run on
//     neighbouring blocks of one wave and read its halo from L2 (a 64^2 x 256
//     x 16 map is 67 MB, more than the 50 MB L2); the epilogue and the bias
//     index from the Cout tile's first cout. WALK is a template flag, so the
//     templates without it compile to what they did before it;
//   * the work is one sequence of steps (work item, Cin chunk of CI_T); each step's
//     (TH+2) x (TW+2) x CI_T halo and 9 x CI_T x CO_T weights are copied into
//     a ring of NS shared-memory slots by cp.async, 16 bytes at a time where
//     Cin (Cout) % 4 == 0 and x (w) is 16-byte aligned, 4 bytes otherwise, so
//     the copies of the next steps, across tile boundaries, overlap the FMAs of
//     this one. Reflect index math runs only for halo rows and columns that
//     fall outside the map. Cin = 3 takes a chunk of 4 (one zero channel);
//   * the halo is staged pixel-major, [row][col][CIS] with CIS = CI_T (+4 past
//     4) and an odd column pitch, so that the strips of one warp, on
//     consecutive rows, read distinct banks;
//   * each thread holds a strip of PX = 8 consecutive pixels of one row x CPT
//     couts (two groups of 4, half a Cout tile apart, so neighbouring threads
//     read neighbouring 16-byte words of w). Per (ci, ky) it loads the 10
//     inputs of the strip once and uses each for the 3 kx taps: 10 floats of
//     x and 24 of w per 192 FMAs, 0.71 shared bytes per FMA at CPT = 8 (a
//     warp's 16-byte shared load costs the pipe 4 cycles whatever its
//     addresses, so bytes per FMA is what the FMA pipe is fed by). Where a
//     warp holds 16 or more strips (Cout <= 16), x is read 4 channels at a
//     time, as float4, to keep those reads free of bank conflicts.
//   Where it stands on an H100: ~55 % of FFMA peak at Cout 32..128, ~45 % at
//   Cout 16, ~30 % of the byte bound at Cout 3 and Cin 3. Two output rows a
//   thread (0.53 shared bytes per FMA), 16-pixel strips, all 16 couts a
//   thread at Cout 16 and two blocks an SM each measured slower or no faster
//   (tools/bench_kernels.py), so the shared pipe alone does not hold it. At
//   the teachers' widths the walking 16x16 x 64-cout template reaches ~63 %
//   of FFMA peak over a training step's 27 convs at 256/512 (the first kernel
//   took them at ~40 %). Over those convs the other walking templates
//   measured were slower: two slots 1 %, 8x32 tiles 4 %, 8x16 tiles x 128
//   couts 5 %, Cin chunks of 8 with 3 to 6 slots 6-11 %.
//
// first_conv3x3_kernel (widths outside the ring's set, such as 129):
//   the first port's kernel, a 16x16 tile x a Cout tile of 4 * CPT, Cin
//   chunks of 16 staged by plain loads, 4 pixels x CPT couts a thread.
//
// Halo rows (both kernels, template flag HALO): a shard of a row-sharded map
// is convolved as the reference's conv3x3_halo (parallel/spatial.py:79-88)
// does it: its rows with one row above and one below, reflect-padded in W
// only. With HALO the staging reads map row -1 from `top` and row H from `bot`
// where those are given (one row of W x Cin floats for image 0, image i's
// `*_stride` elements further on; the neighbour shard's boundary row, read in
// place, through a peer pointer where it lies on another card), and reflects
// where one is null (a global edge of a shard of 2+ rows). Columns reflect
// inside the halo row too, so the corners are those of the reference's W-only
// pad of the concatenated map. This replaces the per-conv path's exchange
// through halo.cu (kernel table row 8a), which wrote each shard whole into an
// extended map for the conv to compute two rows nobody wanted (8.77-10.92 ms
// timed alone against a 4.06 ms bound over the 248 shard-convs of a
// 2000 x 2048 cascade). What the rows must move is two of W x Cin floats per
// shard, a 0.0124 ms bound for that cascade. The staging is the place for
// them: it already computes a source address for every halo row of its tile
// (that is where reflection lives), so another source costs no pass and no
// launch of its own. Image n's two row pointers are taken once a staging
// step, and only a row outside [0, H) picks between them and reflection, so
// rows inside the map stage as they do without HALO (whose code is the
// kernel's without halo rows).
//
// Pool and upsample folded in (ring templates 1, 2, 3 and 5, the cascade's
// 128-, 64-, 32- and 16-wide layers; template flags POOL and UP). An
// encoder's conv before a 2x2 max pool and a decoder's conv after a nearest
// 2x upsample were each a conv launch plus a pass of csrc/pool.cu over the
// full-resolution map in HBM: the pool read the map the conv had just
// written and wrote a quarter of it; the upsample wrote four copies of a map
// that the conv then read back.
//   * POOL: the tile origins and sizes are even, so a 2x2 window never
//     crosses a tile. The epilogue (+ bias, ReLU) reduces the horizontal
//     pairs of a thread's strip, takes the row below from the thread that
//     holds it (G lanes on: the strips of a warp are consecutive rows of one
//     column of strips, TH and the strips a warp even), and stores only the
//     pooled map, in pool.cu's order of maxima (a NaN wins), so its bits are
//     those of the conv followed by the pool kernel. Floor semantics: a
//     window with its second row or column past the map is dropped;
//   * UP: x is the half-resolution map; the staging reflects the halo on the
//     2H x 2W map it stands for and reads pixel (gy, gx) of that map from
//     (gy >> 1, gx >> 1) of x. The staged tile is the one the upsampled map
//     gives, so the conv's bits are those of the upsample kernel then the
//     conv.
// The flags are template arguments: the instantiations without them are the
// kernels they were before them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int reflect1(int i, int n) {
  if (n == 1) return 0;
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  // ragged edge tiles read past the map for outputs that are never stored
  return min(max(i, 0), n - 1);
}

constexpr int kMaxDevices = 64;

// Halo rows of a shard (see the header): null where the shard reflects.
struct Halo {
  const float* top;
  const float* bot;
  long long top_stride, bot_stride;   // elements from image i's row to i + 1's
};

// The map that staging reads row gy of image n from, for a row outside
// [0, H): row -1 from top_n and row H from bot_n (image n's halo rows) where
// given, gy moved to 0 in it; any other row reflects into x (and is clamped
// for ragged tiles, so rows past H that are never stored read no further).
__device__ __forceinline__ const float* edge_row(const float* xn, const float* top_n,
                                                 const float* bot_n, int& gy, int H) {
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

// Image n's halo rows, or null.
__device__ __forceinline__ const float* halo_row(const float* row, long long stride, int n) {
  return row ? row + n * stride : nullptr;
}

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

// pool.cu's max: a NaN wins (fmaxf would drop it), and of two equal values
// (0 and -0) the second
__device__ __forceinline__ float vmax(float a, float b) { return (a > b || a != a) ? a : b; }

// ---- ring_conv3x3_kernel ------------------------------------------------------

constexpr int PX = 8;   // pixels of a thread strip, one row

// One block of 256 threads an SM (__launch_bounds__(NT, 1)): the compiler
// keeps ~250 registers a thread, most for shared loads it starts early; at
// two blocks an SM (128 registers) it spilled and took 1.22x as long on an
// H100.
template <int CO_T_, int CPT_, int TH_, int TW_, int CI_T_, int NS_, bool X4_,
          bool WALK_ = false>
struct Ring {
  static constexpr int CO_T = CO_T_, CPT = CPT_, TH = TH_, TW = TW_, CI_T = CI_T_;
  static constexpr int NS = NS_;
  static constexpr bool X4 = X4_;                 // read x as float4, 4 channels at once
  static constexpr bool WALK = WALK_;             // walk the Cout tiles of a wider Cout
  static constexpr int G = CO_T / CPT;            // cout groups
  static constexpr int S = TH * TW / PX;          // pixel strips
  static constexpr int NT = G * S;                // threads
  static constexpr int NGRP = CPT / 4;            // float4 groups a thread holds
  static constexpr int GSTRIDE = CO_T / NGRP;     // couts between them
  static constexpr int HR = TH + 2, HC = TW + 2;
  static constexpr int TWP = HC | 1;              // odd pixel pitch of a halo row
  static constexpr int CIS = CI_T % 8 == 0 ? CI_T + 4 : CI_T;   // CIS / 4 odd
  static constexpr int XSLOT = HR * TWP * CIS;
  static constexpr int WSLOT = 9 * CI_T * CO_T;
  static constexpr int SLOT = XSLOT + WSLOT;
  static constexpr size_t SMEM = (size_t)NS * SLOT * sizeof(float);
  static_assert(CO_T % CPT == 0 && CPT % 4 == 0 && CI_T % 4 == 0, "tile");
  static_assert(TW % PX == 0 && NT % 32 == 0 && NT <= 1024, "threads");
};

template <class R, bool HALO, bool POOL = false, bool UP = false>
__global__ void __launch_bounds__(R::NT, 1)
ring_conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ b, float* __restrict__ y, int H, int W,
                    int Cin, int Cout, int relu, int vec_x, int vec_w, int vec_y,
                    int tiles_h, int tiles_w, int nitems, Halo halo) {
  constexpr int CO_T = R::CO_T, CPT = R::CPT, TH = R::TH, TW = R::TW;
  constexpr int CI_T = R::CI_T, NS = R::NS, NT = R::NT, G = R::G;
  constexpr int HR = R::HR, HC = R::HC, TWP = R::TWP, CIS = R::CIS;
  static_assert(!((POOL || UP) && (HALO || R::WALK || POOL == UP)), "one fused flag, no halo");
  // POOL: a warp's strips pair up as rows 2i, 2i + 1 of one strip column
  static_assert(!POOL || (G <= 16 && 32 % G == 0 && (32 / G) % 2 == 0 && TH % (32 / G) == 0),
                "pool pairs");
  extern __shared__ __align__(16) float smem[];

  const int t = threadIdx.x;
  const int cg = t % G;
  const int strip = t / G;
  const int sr = strip % TH;                 // strips of a warp: consecutive rows
  const int sc = (strip / TH) * PX;

  const int nchunks = (Cin + CI_T - 1) / CI_T;
  const int per_img = tiles_h * tiles_w;
  const int nco = R::WALK ? (Cout + CO_T - 1) / CO_T : 1;   // Cout tiles of a pixel tile
  const int nt = (nitems - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int nsteps = nt * nchunks;

  // step k = (this block's work item k / nchunks, Cin chunk k % nchunks) into
  // slot k % NS: one commit group per step, empty past the last. Work item i
  // is pixel tile i / nco, Cout tile i % nco (Cout tile innermost, so that a
  // tile's Cout tiles run on neighbouring blocks and share its halo in L2)
  auto prefetch = [&](int k) {
    if (k < nsteps) {
      const int item = blockIdx.x + (k / nchunks) * gridDim.x;
      const int tile = R::WALK ? item / nco : item;
      const int co0 = R::WALK ? (item - tile * nco) * CO_T : 0;
      const int ci0 = (k % nchunks) * CI_T;
      const int n = tile / per_img;
      const int r0 = tile - n * per_img;
      const int ty0 = (r0 / tiles_w) * TH;
      const int tx0 = (r0 % tiles_w) * TW;
      // UP: x holds the (H / 2, W / 2) map that the upsampled one stands for
      const int xw = UP ? W >> 1 : W;
      const float* xn = UP ? x + (size_t)n * (H >> 1) * xw * Cin : x + (size_t)n * H * W * Cin;
      const float* top_n = HALO ? halo_row(halo.top, halo.top_stride, n) : nullptr;
      const float* bot_n = HALO ? halo_row(halo.bot, halo.bot_stride, n) : nullptr;
      float* xs = smem + (k % NS) * R::SLOT;
      float* ws = xs + R::XSLOT;
      if (vec_x) {
        constexpr int Q = CI_T / 4;
        for (int e = t; e < HR * HC * Q; e += NT) {
          const int q = e % Q;
          const int pix = e / Q;
          const int c = pix % HC;
          const int r = pix / HC;
          int gy = ty0 + r - 1, gx = tx0 + c - 1;
          const float* xr = xn;
          if (static_cast<unsigned>(gy) >= static_cast<unsigned>(H)) {
            if constexpr (HALO) xr = edge_row(xn, top_n, bot_n, gy, H);
            else gy = reflect1(gy, H);
          }
          if (static_cast<unsigned>(gx) >= static_cast<unsigned>(W)) gx = reflect1(gx, W);
          if constexpr (UP) {
            gy >>= 1;
            gx >>= 1;
          }
          float* dst = xs + (r * TWP + c) * CIS + 4 * q;
          const int ci = ci0 + 4 * q;
          if (ci < Cin)
            cp_async16(dst, xr + ((size_t)gy * xw + gx) * Cin + ci);
          else
            *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      } else {
        for (int e = t; e < HR * HC * CI_T; e += NT) {
          const int q = e % CI_T;
          const int pix = e / CI_T;
          const int c = pix % HC;
          const int r = pix / HC;
          int gy = ty0 + r - 1, gx = tx0 + c - 1;
          const float* xr = xn;
          if (static_cast<unsigned>(gy) >= static_cast<unsigned>(H)) {
            if constexpr (HALO) xr = edge_row(xn, top_n, bot_n, gy, H);
            else gy = reflect1(gy, H);
          }
          if (static_cast<unsigned>(gx) >= static_cast<unsigned>(W)) gx = reflect1(gx, W);
          if constexpr (UP) {
            gy >>= 1;
            gx >>= 1;
          }
          float* dst = xs + (r * TWP + c) * CIS + q;
          if (ci0 + q < Cin)
            cp_async4(dst, xr + ((size_t)gy * xw + gx) * Cin + ci0 + q);
          else
            *dst = 0.f;
        }
      }
      // weights: w is (3, 3, Cin, Cout) = (9, Cin, Cout); ws [9][CI_T][CO_T]
      if (vec_w) {
        constexpr int Q = CO_T / 4;
        for (int e = t; e < 9 * CI_T * Q; e += NT) {
          const int q = e % Q;
          const int row = e / Q;               // tap * CI_T + ci
          const int ci = row % CI_T;
          const int tap = row / CI_T;
          float* dst = ws + row * CO_T + 4 * q;
          if (ci0 + ci < Cin && co0 + 4 * q < Cout)
            cp_async16(dst, w + ((size_t)tap * Cin + ci0 + ci) * Cout + co0 + 4 * q);
          else
            *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      } else {
        for (int e = t; e < 9 * CI_T * CO_T; e += NT) {
          const int co = e % CO_T;
          const int row = e / CO_T;
          const int ci = row % CI_T;
          const int tap = row / CI_T;
          if (ci0 + ci < Cin && co0 + co < Cout)
            cp_async4(ws + e, w + ((size_t)tap * Cin + ci0 + ci) * Cout + co0 + co);
          else
            ws[e] = 0.f;
        }
      }
    }
    cp_async_commit();
  };

  float bias[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int co = (j / 4) * R::GSTRIDE + cg * 4 + j % 4;
    bias[j] = co < Cout ? b[co] : 0.f;
  }
  float acc[PX][CPT];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[p][j] = 0.f;

#pragma unroll
  for (int k = 0; k < NS - 1; ++k) prefetch(k);

  for (int k = 0; k < nsteps; ++k) {
    cp_async_wait<NS - 2>();   // this thread's copies of step k have landed
    __syncthreads();           // everyone's; and slot (k - 1) % NS is free
    prefetch(k + NS - 1);
    const float* xs = smem + (k % NS) * R::SLOT;
    const float* ws = xs + R::XSLOT;
    const float* xb = xs + (sr * TWP + sc) * CIS;

#pragma unroll 1
    for (int c4 = 0; c4 < CI_T; c4 += 4) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const float* xr = xb + ky * TWP * CIS + c4;
        float4 xq[R::X4 ? PX + 2 : 1];   // 4 channels of the strip's 10 inputs
        if constexpr (R::X4) {
#pragma unroll
          for (int j = 0; j < PX + 2; ++j)
            xq[j] = *reinterpret_cast<const float4*>(xr + j * CIS);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float xv[PX + 2];
          if constexpr (R::X4) {
#pragma unroll
            for (int j = 0; j < PX + 2; ++j) xv[j] = lane(xq[j], kk);
          } else {
#pragma unroll
            for (int j = 0; j < PX + 2; ++j) xv[j] = xr[j * CIS + kk];
          }
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const float* wr = ws + ((ky * 3 + kx) * CI_T + c4 + kk) * CO_T + cg * 4;
            float wv[CPT];
#pragma unroll
            for (int g = 0; g < R::NGRP; ++g) {
              const float4 v = *reinterpret_cast<const float4*>(wr + g * R::GSTRIDE);
              wv[4 * g] = v.x;
              wv[4 * g + 1] = v.y;
              wv[4 * g + 2] = v.z;
              wv[4 * g + 3] = v.w;
            }
#pragma unroll
            for (int p = 0; p < PX; ++p)
#pragma unroll
              for (int j = 0; j < CPT; ++j)
                acc[p][j] = fmaf(xv[p + kx], wv[j], acc[p][j]);
          }
        }
      }
    }

    if (k % nchunks == nchunks - 1) {   // the work item's last chunk: epilogue
      const int item = blockIdx.x + (k / nchunks) * gridDim.x;
      const int tile = R::WALK ? item / nco : item;
      const int co0 = R::WALK ? (item - tile * nco) * CO_T : 0;
      if constexpr (R::WALK) {   // this Cout tile's bias (the first tile's is loaded above)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int co = co0 + (j / 4) * R::GSTRIDE + cg * 4 + j % 4;
          bias[j] = co < Cout ? b[co] : 0.f;
        }
      }
      const int n = tile / per_img;
      const int r0 = tile - n * per_img;
      const int gy = (r0 / tiles_w) * TH + sr;
      const int gx0 = (r0 % tiles_w) * TW + sc;
      if constexpr (POOL) {
        // pool.cu's order: max(max(row 2i's pair), max(row 2i + 1's pair));
        // the thread G lanes on holds row sr + 1 of the same columns
        float m[PX / 2][CPT];
#pragma unroll
        for (int p = 0; p < PX / 2; ++p)
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            float o0 = acc[2 * p][j] + bias[j], o1 = acc[2 * p + 1][j] + bias[j];
            if (relu && o0 < 0.f) o0 = 0.f;   // NaN stays NaN
            if (relu && o1 < 0.f) o1 = 0.f;
            const float h = vmax(o0, o1);
            m[p][j] = vmax(h, __shfl_down_sync(0xffffffffu, h, G));
          }
        const int Ho = H >> 1, Wo = W >> 1, oy = gy >> 1;
        if (sr % 2 == 0 && oy < Ho) {
          float* yrow = y + ((size_t)n * Ho + oy) * Wo * Cout;
#pragma unroll
          for (int p = 0; p < PX / 2; ++p) {
            const int ox = (gx0 >> 1) + p;
            if (ox >= Wo) break;
            float* yp = yrow + (size_t)ox * Cout;
#pragma unroll
            for (int g = 0; g < R::NGRP; ++g) {
              const int co = g * R::GSTRIDE + cg * 4;
              if (vec_y) {
                if (co < Cout)
                  *reinterpret_cast<float4*>(yp + co) =
                      make_float4(m[p][4 * g], m[p][4 * g + 1], m[p][4 * g + 2], m[p][4 * g + 3]);
              } else {
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  if (co + j < Cout) yp[co + j] = m[p][4 * g + j];
              }
            }
          }
        }
      } else if (gy < H) {
        float* yrow = y + ((size_t)n * H + gy) * W * Cout;
#pragma unroll
        for (int p = 0; p < PX; ++p) {
          if (gx0 + p >= W) break;
          float* yp = yrow + (size_t)(gx0 + p) * Cout;
#pragma unroll
          for (int g = 0; g < R::NGRP; ++g) {
            const int co = co0 + g * R::GSTRIDE + cg * 4;
            float o[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              o[j] = acc[p][4 * g + j] + bias[4 * g + j];
              if (relu && o[j] < 0.f) o[j] = 0.f;  // NaN stays NaN
            }
            if (vec_y) {   // Cout % 4 == 0: a group lies wholly inside or out
              if (co < Cout)
                *reinterpret_cast<float4*>(yp + co) = make_float4(o[0], o[1], o[2], o[3]);
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (co + j < Cout) yp[co + j] = o[j];
            }
          }
        }
      }
#pragma unroll
      for (int p = 0; p < PX; ++p)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[p][j] = 0.f;
    }
  }
  cp_async_wait<0>();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// 16-byte cp.async of x also needs the halo rows and their strides on 16 bytes
bool halo_aligned16(const Halo& hl) {
  return aligned16(hl.top) && aligned16(hl.bot) && hl.top_stride % 4 == 0 &&
         hl.bot_stride % 4 == 0;
}

template <class R, bool HALO, bool POOL = false, bool UP = false>
int launch_ring_as(const float* x, const float* w, const float* b, float* y, const Halo& hl,
                   int n, int h, int wd, int cin, int cout, int relu, int nblocks,
                   cudaStream_t s) {
  if ((!R::WALK && cout > R::CO_T) || nblocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_h = (h + R::TH - 1) / R::TH;
  const int tiles_w = (wd + R::TW - 1) / R::TW;
  const long long nitems = (long long)n * tiles_h * tiles_w * ((cout + R::CO_T - 1) / R::CO_T);
  if (nitems > 0x7fffffffLL || nblocks > nitems) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = ring_conv3x3_kernel<R, HALO, POOL, UP>;
  // the opt-in above 48 KB of dynamic shared memory, once per device
  static bool opted[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(R::SMEM));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[dev] = true;
  }
  kernel<<<nblocks, R::NT, R::SMEM, s>>>(
      x, w, b, y, h, wd, cin, cout, relu, cin % 4 == 0 && aligned16(x) && halo_aligned16(hl),
      cout % 4 == 0 && aligned16(w), cout % 4 == 0 && aligned16(y), tiles_h, tiles_w,
      static_cast<int>(nitems), hl);
  return static_cast<int>(cudaGetLastError());
}

// HALO only where a halo row is given: without one both compute the same
template <class R>
int launch_ring(const float* x, const float* w, const float* b, float* y, const Halo& hl,
                int n, int h, int wd, int cin, int cout, int relu, int nblocks,
                cudaStream_t s) {
  if (hl.top || hl.bot)
    return launch_ring_as<R, true>(x, w, b, y, hl, n, h, wd, cin, cout, relu, nblocks, s);
  return launch_ring_as<R, false>(x, w, b, y, hl, n, h, wd, cin, cout, relu, nblocks, s);
}

// The templates, by the id the launch plan gives (../conv.py _TEMPLATES):
// (Cout tile, couts a thread, tile rows, tile cols, Cin chunk, slots, x read
// as float4, Cout walk). Chosen step by step on the card
// (tools/bench_kernels.py, --template at the teachers' widths): Cin chunks
// of 16 at the wide Couts, 4 where a warp holds 16+ strips (Cout 16) and for
// Cin = 3, 8 at Cout = 3.
using RingCo128 = Ring<128, 8, 8, 16, 16, 2, false>;    // 256 threads, 178 KB
using RingCo64 = Ring<64, 8, 16, 16, 16, 3, false>;     // 256 threads, 193 KB
using RingCo32 = Ring<32, 8, 16, 32, 16, 2, false>;     // 256 threads, 138 KB
using RingCo32Cin3 = Ring<32, 8, 16, 32, 4, 3, false>;  // 256 threads, 44 KB
using RingCo16 = Ring<16, 8, 32, 32, 4, 3, true>;       // 256 threads, 64 KB
using RingCo4 = Ring<4, 4, 32, 64, 8, 2, true>;         // 256 threads, 219 KB
// The teachers' widths (Cin or Cout 256, 512; Cout 64 and up): RingCo64's
// geometry, walking the Cout tiles of a Cout up to 512 (WALK).
using RingW64 = Ring<64, 8, 16, 16, 16, 3, false, true>;  // 256 threads, 193 KB

// ---- first_conv3x3_kernel -----------------------------------------------------

constexpr int F_TH = 16;          // tile rows
constexpr int F_TW = 16;          // tile cols
constexpr int F_CI_T = 16;        // Cin chunk staged per pass
constexpr int F_HR = F_TH + 2;
constexpr int F_HC = F_TW + 2;
constexpr int F_THREADS = 256;    // 64 pixel groups x 4 cout groups

template <int CPT, bool HALO>  // couts per thread; the block's Cout tile is 4 * CPT
__global__ void __launch_bounds__(F_THREADS)
first_conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ b, float* __restrict__ y,
                     int H, int W, int Cin, int Cout, int relu, int tiles_w, Halo halo) {
  constexpr int CO_T = 4 * CPT;
  __shared__ float xs[F_CI_T][F_HR][F_HC];
  __shared__ __align__(16) float ws[9][F_CI_T][CO_T];

  const int ty0 = (blockIdx.x / tiles_w) * F_TH;
  const int tx0 = (blockIdx.x % tiles_w) * F_TW;
  const int co0 = blockIdx.y * CO_T;
  const size_t n = blockIdx.z;
  const float* xn = x + n * H * W * Cin;
  const float* top_n = HALO ? halo_row(halo.top, halo.top_stride, blockIdx.z) : nullptr;
  const float* bot_n = HALO ? halo_row(halo.bot, halo.bot_stride, blockIdx.z) : nullptr;

  const int t = threadIdx.x;
  const int cg = t & 3;             // cout group: couts cg*CPT .. +CPT
  const int pg = t >> 2;            // pixel group 0..63
  const int px = pg & (F_TW - 1);   // tile column
  const int py0 = (pg >> 4) * 4;    // first of this thread's 4 tile rows

  float acc[4][CPT];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[p][j] = 0.f;

  for (int ci0 = 0; ci0 < Cin; ci0 += F_CI_T) {
    // input halo, read channel-fastest (coalesced along Cin)
    for (int e = t; e < F_HR * F_HC * F_CI_T; e += F_THREADS) {
      const int ci = e % F_CI_T;
      const int rc = e / F_CI_T;
      const int c = rc % F_HC;
      const int r = rc / F_HC;
      const int gc = ci0 + ci;
      float v = 0.f;
      if (gc < Cin) {
        if constexpr (HALO) {
          int gy = ty0 + r - 1;
          const float* xr = xn;
          if (static_cast<unsigned>(gy) >= static_cast<unsigned>(H))
            xr = edge_row(xn, top_n, bot_n, gy, H);
          v = xr[((size_t)gy * W + reflect1(tx0 + c - 1, W)) * Cin + gc];
        } else {
          const int gy = reflect1(ty0 + r - 1, H);
          const int gx = reflect1(tx0 + c - 1, W);
          v = xn[((size_t)gy * W + gx) * Cin + gc];
        }
      }
      xs[ci][r][c] = v;
    }
    // weight chunk: w is (3, 3, Cin, Cout) = (9, Cin, Cout)
    for (int e = t; e < 9 * F_CI_T * CO_T; e += F_THREADS) {
      const int co = e % CO_T;
      const int r = e / CO_T;
      const int ci = r % F_CI_T;
      const int tap = r / F_CI_T;
      const int gc = ci0 + ci;
      const int go = co0 + co;
      ws[tap][ci][co] = (gc < Cin && go < Cout)
                            ? w[((size_t)tap * Cin + gc) * Cout + go] : 0.f;
    }
    __syncthreads();

    const int cimax = min(F_CI_T, Cin - ci0);
    for (int ci = 0; ci < cimax; ++ci) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        float v[6];
#pragma unroll
        for (int r = 0; r < 6; ++r) v[r] = xs[ci][py0 + r][px + kx];
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          float wv[CPT];
#pragma unroll
          for (int j = 0; j < CPT; ++j) wv[j] = ws[ky * 3 + kx][ci][cg * CPT + j];
#pragma unroll
          for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int j = 0; j < CPT; ++j)
              acc[p][j] = fmaf(v[p + ky], wv[j], acc[p][j]);
        }
      }
    }
    __syncthreads();
  }

  const int gx = tx0 + px;
  if (gx >= W) return;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int gy = ty0 + py0 + p;
    if (gy >= H) continue;
    float* yp = y + ((n * H + gy) * W + gx) * Cout;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int co = co0 + cg * CPT + j;
      if (co < Cout) {
        float o = acc[p][j] + b[co];
        yp[co] = (relu && o < 0.f) ? 0.f : o;  // NaN stays NaN, as in torch.relu
      }
    }
  }
}

template <int CPT>
int launch_first(const float* x, const float* w, const float* b, float* y, const Halo& hl,
                 int n, int h, int wd, int cin, int cout, int relu, cudaStream_t s) {
  const int tiles_w = (wd + F_TW - 1) / F_TW;
  const int tiles_h = (h + F_TH - 1) / F_TH;
  dim3 grid(tiles_w * tiles_h, (cout + 4 * CPT - 1) / (4 * CPT), n);
  auto kernel = hl.top || hl.bot ? first_conv3x3_kernel<CPT, true>
                                 : first_conv3x3_kernel<CPT, false>;
  kernel<<<grid, F_THREADS, 0, s>>>(x, w, b, y, h, wd, cin, cout, relu, tiles_w, hl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (N, H, W, Cin), w (3, 3, Cin, Cout), b (Cout,), y (N, H, W, Cout).
// top, bot: null, or one row (W, Cin) of image 0 that stands for map row -1
// (row H), image i's row i * {top,bot}_stride elements further on.
// tmpl: 0 = first_conv3x3_kernel, 1.. = the ring templates above; nblocks: the ring
// kernel's persistent grid (ignored by first_conv3x3_kernel).
extern "C" int cd_conv3x3_reflect(const float* x, const float* w,
                                  const float* b, float* y, const float* top,
                                  const float* bot, long long top_stride,
                                  long long bot_stride, int n, int h,
                                  int wd, int cin, int cout, int relu, int tmpl,
                                  int nblocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Halo hl{top, bot, top ? top_stride : 0, bot ? bot_stride : 0};
  switch (tmpl) {
    case 0:
      if (cout > 16) return launch_first<8>(x, w, b, y, hl, n, h, wd, cin, cout, relu, s);
      if (cout > 8) return launch_first<4>(x, w, b, y, hl, n, h, wd, cin, cout, relu, s);
      return launch_first<2>(x, w, b, y, hl, n, h, wd, cin, cout, relu, s);
    case 1:
      return launch_ring<RingCo128>(x, w, b, y, hl, n, h, wd, cin, cout, relu, nblocks, s);
    case 2:
      return launch_ring<RingCo64>(x, w, b, y, hl, n, h, wd, cin, cout, relu, nblocks, s);
    case 3:
      return launch_ring<RingCo32>(x, w, b, y, hl, n, h, wd, cin, cout, relu, nblocks, s);
    case 4:
      return launch_ring<RingCo32Cin3>(x, w, b, y, hl, n, h, wd, cin, cout, relu, nblocks, s);
    case 5:
      return launch_ring<RingCo16>(x, w, b, y, hl, n, h, wd, cin, cout, relu, nblocks, s);
    case 6:
      return launch_ring<RingCo4>(x, w, b, y, hl, n, h, wd, cin, cout, relu, nblocks, s);
    case 7:
      return launch_ring<RingW64>(x, w, b, y, hl, n, h, wd, cin, cout, relu, nblocks, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The conv with the 2x2 max pool after it (fuse 1: y is (N, H / 2, W / 2,
// Cout)) or the nearest 2x upsample before it (fuse 2: x is (N, H / 2, W / 2,
// Cin)); h, wd are the conv's map, the pooled map's input or the upsampled
// map. Only the ring templates the launch plan fuses (../conv.py
// FUSED_TEMPLATES) are instantiated; any other template is refused.
extern "C" int cd_conv3x3_fused(const float* x, const float* w, const float* b, float* y,
                                int n, int h, int wd, int cin, int cout, int relu, int tmpl,
                                int nblocks, int fuse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Halo hl{nullptr, nullptr, 0, 0};
  if (fuse == 1) {
    switch (tmpl) {
      case 1:
        return launch_ring_as<RingCo128, false, true>(x, w, b, y, hl, n, h, wd, cin, cout, relu,
                                                      nblocks, s);
      case 2:
        return launch_ring_as<RingCo64, false, true>(x, w, b, y, hl, n, h, wd, cin, cout, relu,
                                                     nblocks, s);
      case 3:
        return launch_ring_as<RingCo32, false, true>(x, w, b, y, hl, n, h, wd, cin, cout, relu,
                                                     nblocks, s);
      case 5:
        return launch_ring_as<RingCo16, false, true>(x, w, b, y, hl, n, h, wd, cin, cout, relu,
                                                     nblocks, s);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (fuse == 2 && h % 2 == 0 && wd % 2 == 0) {
    switch (tmpl) {
      case 1:
        return launch_ring_as<RingCo128, false, false, true>(x, w, b, y, hl, n, h, wd, cin, cout,
                                                             relu, nblocks, s);
      case 2:
        return launch_ring_as<RingCo64, false, false, true>(x, w, b, y, hl, n, h, wd, cin, cout,
                                                            relu, nblocks, s);
      case 3:
        return launch_ring_as<RingCo32, false, false, true>(x, w, b, y, hl, n, h, wd, cin, cout,
                                                            relu, nblocks, s);
      case 5:
        return launch_ring_as<RingCo16, false, false, true>(x, w, b, y, hl, n, h, wd, cin, cout,
                                                            relu, nblocks, s);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
