// One-pass feature statistics: sum(x - s) (C,) and (x - s)^T (x - s) (C, C)
// over the P rows of a (P, C) float32 matrix, for sm_90a.
//
// Replaces fused_sum_gram (reference ops/pallas/stats.py:61). The TPU kernel
// walked a sequential grid and carried its sums in VMEM from step to step;
// blocks here run in parallel and in no order, so each block writes the sums
// of its own row range to a scratch buffer the wrapper allocates, and a
// second kernel adds them in a fixed order. No float atomics, so results
// repeat exactly from run to run.
//
// The optional per-channel shift s turns the uncentred Gram, which cancels
// catastrophically in f32 once P reaches millions of pixels, into a Gram of
// nearly centred data (the caller passes an estimate of the mean and corrects
// with d = mean - s; exact in exact arithmetic). shift == nullptr is plain
// sum(x) and x^T x, exactly fused_sum_gram.
//
// What bounds it: bytes at C = 24 (C/2 FLOPs a byte of input, under the
// card's FP32 ridge of 67 TFLOP/s over 3.35 TB/s = 20), and the shared-memory
// pipe at C = 32 to 128: a warp's 16-byte shared load costs that pipe 4
// cycles whatever its addresses, while an SM retires 4 warp FFMAs a cycle, so
// a TI x TJ register tile keeps up only if it loads no more than one byte per
// FMA (4 (TI + TJ) / (TI TJ) <= 1: 8 x 8). So:
//   * sum_gram_rows_kernel (C in {24, 32, 64, 128}): one block holds the whole
//     C x C Gram of its row range, so each row goes from HBM to shared memory
//     once, by 16-byte cp.async copies into a 3-deep ring of ~30 KB slots:
//     the next blocks land while the current one is multiplied. The Gram is
//     cut into blocks, of which only those on and above the diagonal are
//     computed (10 of 16 at C = 24 and 32, 36 of 64 at 64, 3 of 4 at 128) and
//     mirrored when written. Each thread keeps a TI x TJ register tile (8x8;
//     6x6 at C = 24, where the bytes bound it anyway); several row groups
//     share a block at C <= 64 and are added through shared memory at the
//     end. Rows are padded in shared memory where a warp spans rows that
//     would share banks, and a thread's two 16-byte runs are read in the
//     order that keeps a warp on distinct banks. One pass over each landed
//     slot subtracts the shift in place and adds the column sums, so the
//     inner loop is loads and FFMAs only. Each thread sums ~256 rows into a
//     fresh accumulator, then folds it into its running sum, so no serial
//     chain of adds grows with P. Full FP32 FFMA: TF32 tensor cores keep ~3
//     digits, short of the 2e-5 Gram tolerance.
//   * sum_gram_tiled_kernel (every other C up to 512, off the 16x path): block
//     (r, t) takes row range r and a CT x CT tile t of the Gram, staging 32
//     rows of its two column strips; it reads the map once per tile.
//   * sum_gram_reduce_kernel: 32 outputs x 8 slices of the partials per block,
//     each slice in a fixed order, the 8 slices added in a fixed order.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;

// ---- cp.async ----------------------------------------------------------------

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

// nrows contiguous rows of C floats from global to shared memory by NT
// threads, row r landing at dst + r * CS; 16-byte copies where the source
// allows (C % 4 == 0 and dst is 16-byte aligned), 4-byte ones otherwise.
template <int NT, int C, int CS>
__device__ __forceinline__ void copy_rows_async(float* dst, const float* src, int nrows) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    constexpr int Q = C / 4;
    for (int e = threadIdx.x; e < nrows * Q; e += NT) {
      const int r = CS == C ? 0 : e / Q;
      cp_async16(dst + r * (CS - C) + 4 * e, src + 4 * e);
    }
  } else {
    for (int e = threadIdx.x; e < nrows * C; e += NT) {
      const int r = CS == C ? 0 : e / C;
      cp_async4(dst + r * (CS - C) + e, src + e);
    }
  }
}

// ---- the row kernel --------------------------------------------------------------

// A thread's T columns out of N * T: T / V runs of V (the load width) that
// interleave with the other N threads of its dimension, so that a warp's
// V-float loads of one row are contiguous. The runs are rotated by sw: a
// thread whose block starts 32 floats into the row loads them in the other
// order, so that at the same instant it reads other banks than a thread of
// the block 32 floats before.
template <int T>
__host__ __device__ constexpr int vec_width() {
  return T % 4 == 0 ? 4 : (T % 2 == 0 ? 2 : 1);
}

template <int T, int N>
__device__ __forceinline__ int col(int t, int k, int sw) {
  constexpr int V = vec_width<T>();
  return ((k / V + sw) % (T / V)) * N * V + t * V + k % V;
}

template <int T, int N>
__device__ __forceinline__ void load_cols(const float* row, int t, int sw, float (&v)[T]) {
  constexpr int V = vec_width<T>();
#pragma unroll
  for (int s = 0; s < T / V; ++s) {
    const float* p = row + ((s + sw) % (T / V)) * N * V + t * V;
    if constexpr (V == 4) {
      const float4 q = *reinterpret_cast<const float4*>(p);
      v[4 * s] = q.x;
      v[4 * s + 1] = q.y;
      v[4 * s + 2] = q.z;
      v[4 * s + 3] = q.w;
    } else if constexpr (V == 2) {
      const float2 q = *reinterpret_cast<const float2*>(p);
      v[2 * s] = q.x;
      v[2 * s + 1] = q.y;
    } else {
      v[s] = *p;
    }
  }
}

// The row kernel's shape: the Gram in H x H blocks of W = C / H columns, of
// which the H (H + 1) / 2 on and above the diagonal are computed and the
// others mirrored; each block in NI x NJ threads of TI x TJ; G row groups
// that take every G-th row; RB rows staged per slot of a STAGES-deep ring,
// PAD floats after each row in shared memory, so that where a warp holds
// several rows (C a multiple of 32) they fall on different banks.
template <int C_, int H_, int TI_, int TJ_, int G_, int RB_, int STAGES_, int MINB_,
          int PAD_>
struct RowShape {
  static constexpr int C = C_, H = H_, TI = TI_, TJ = TJ_, G = G_, RB = RB_;
  static constexpr int STAGES = STAGES_, MINB = MINB_, CS = C + PAD_;
  static constexpr int W = C / H, NI = W / TI, NJ = W / TJ, TB = NI * NJ;
  static constexpr int T = H * (H + 1) / 2 * TB;  // threads of one row group
  static constexpr int NT = G * T;                // threads of the block
  static constexpr int L = C * C + C;
  static constexpr int Q = C / 4;                 // float4s of a row
  static constexpr int PT = NT - NT % Q;          // threads of the shift pass
  // blocks between folds into the running sums: ~256 rows per thread
  static constexpr int FOLD = 256 * G / RB > 0 ? 256 * G / RB : 1;
  static constexpr size_t RING = (size_t)STAGES * RB * CS;
  static constexpr size_t TAIL = (G > 1 ? (size_t)G * C * C : 0) + 4 * PT;
  static constexpr size_t SMEM = (RING > TAIL ? RING : TAIL) * sizeof(float);
  static_assert(C % 4 == 0 && PAD_ % 4 == 0 && C % H == 0 && W % TI == 0 && W % TJ == 0,
                "tile widths must divide the block width");
  static_assert(RB % G == 0 && NT <= 1024, "row groups must divide the staged rows");
};

// Block k sums rows [k * rows_per_block, min(P, (k + 1) * rows_per_block)).
template <class S>
__global__ void __launch_bounds__(S::NT, S::MINB)
sum_gram_rows_kernel(const float* __restrict__ x, const float* __restrict__ shift,
            float* __restrict__ partial, int P, int rows_per_block) {
  constexpr int C = S::C, CS = S::CS, TI = S::TI, TJ = S::TJ, NI = S::NI, NJ = S::NJ;
  constexpr int G = S::G, RB = S::RB, STAGES = S::STAGES, Q = S::Q, PT = S::PT;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x;
  const int g = tid / S::T, u = tid % S::T, v = u % S::TB;
  const int ti = v / NJ, tj = v % NJ;
  // this thread's block (bi, bj), bi <= bj, counted row by row
  int bi = 0, bj = u / S::TB;
  while (bj >= S::H - bi) {
    bj -= S::H - bi;
    ++bi;
  }
  bj += bi;
  const int ia = bi * S::W, jb = bj * S::W;
  // blocks narrower than 32 columns in a row wider than 32 rotate their runs
  constexpr bool ROT = S::W < 32 && C > 32;
  const int swa = ROT ? (ia / 32) & 1 : 0, swb = ROT ? (jb / 32) & 1 : 0;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const int nrows = static_cast<int>(min((long long)rows_per_block, (long long)P - r0));
  const int nblk = (nrows + RB - 1) / RB;
  const float* xb = x + r0 * C;

  // the shift pass: thread tid < PT owns the 4 columns from qc of every row
  const int qc = 4 * (tid % Q);
  float4 sh = make_float4(0.f, 0.f, 0.f, 0.f);
  if (shift && tid < PT) sh = make_float4(shift[qc], shift[qc + 1], shift[qc + 2], shift[qc + 3]);
  float4 ssum = make_float4(0.f, 0.f, 0.f, 0.f), srun = ssum;
  float acc[TI][TJ], run[TI][TJ];
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int j = 0; j < TJ; ++j) acc[i][j] = run[i][j] = 0.f;

  // one commit group per block, empty past the end, so that wait_group
  // STAGES - 2 at block k means blocks 0..k have landed
  auto stage = [&](int k) {
    if (k < nblk)
      copy_rows_async<S::NT, C, CS>(smem + (size_t)(k % STAGES) * RB * CS,
                                    xb + (size_t)k * RB * C, min(RB, nrows - k * RB));
    cp_async_commit();
  };
  auto rows = [&](const float* xs, int nv) {
#pragma unroll 2
    for (int r = g; r < nv; r += G) {
      float a[TI], b[TJ];
      load_cols<TI, NI>(xs + r * CS + ia, ti, swa, a);
      load_cols<TJ, NJ>(xs + r * CS + jb, tj, swb, b);
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int j = 0; j < TJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  };
  for (int k = 0; k < STAGES - 1; ++k) stage(k);

  int since = 0;
  for (int k = 0; k < nblk; ++k) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // block k visible to all; block k - 1's slot is free
    stage(k + STAGES - 1);
    float* xs = smem + (size_t)(k % STAGES) * RB * CS;
    const int nv = min(RB, nrows - k * RB);
    // subtract the shift in place, once per element, and add the rows to
    // the column sums
    if (tid < PT) {
      for (int e = tid; e < nv * Q; e += PT) {
        const int r = CS == C ? 0 : e / Q;
        float4* p = reinterpret_cast<float4*>(xs + r * (CS - C)) + e;
        float4 w = *p;
        if (shift) {
          w.x -= sh.x;
          w.y -= sh.y;
          w.z -= sh.z;
          w.w -= sh.w;
          *p = w;
        }
        ssum.x += w.x;
        ssum.y += w.y;
        ssum.z += w.z;
        ssum.w += w.w;
      }
    }
    __syncthreads();
    if (nv == RB)
      rows(xs, RB);  // a trip count the compiler knows
    else
      rows(xs, nv);
    if (++since == S::FOLD || k == nblk - 1) {
      since = 0;
      srun.x += ssum.x;
      srun.y += ssum.y;
      srun.z += ssum.z;
      srun.w += ssum.w;
      ssum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int j = 0; j < TJ; ++j) {
          run[i][j] += acc[i][j];
          acc[i][j] = 0.f;
        }
    }
  }

  // partial layout per block: gram (C, C) then sum (C,); the row groups'
  // Grams and the shift pass's sums meet in shared memory, added in order
  cp_async_wait<0>();
  __syncthreads();  // the ring is free
  float* out = partial + (size_t)blockIdx.x * S::L;
  float* gram = G > 1 ? smem + (size_t)g * C * C : out;
  float4* sums = reinterpret_cast<float4*>(smem + (G > 1 ? (size_t)G * C * C : 0));
  if (tid < PT) sums[tid] = srun;
#pragma unroll
  for (int i = 0; i < TI; ++i) {
    const int ci = ia + col<TI, NI>(ti, i, swa);
#pragma unroll
    for (int j = 0; j < TJ; ++j) {
      const int cj = jb + col<TJ, NJ>(tj, j, swb);
      gram[ci * C + cj] = run[i][j];
      if (bi != bj) gram[cj * C + ci] = run[i][j];
    }
  }
  __syncthreads();
  if constexpr (G > 1) {
    for (int e = tid; e < C * C; e += S::NT) {
      float t = 0.f;
#pragma unroll
      for (int q = 0; q < G; ++q) t += smem[(size_t)q * C * C + e];
      out[e] = t;
    }
  }
  if (tid < Q) {
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int m = tid; m < PT; m += Q) {
      t.x += sums[m].x;
      t.y += sums[m].y;
      t.z += sums[m].z;
      t.w += sums[m].w;
    }
    out[C * C + 4 * tid] = t.x;
    out[C * C + 4 * tid + 1] = t.y;
    out[C * C + 4 * tid + 2] = t.z;
    out[C * C + 4 * tid + 3] = t.w;
  }
}

template <class S>
cudaError_t launch_rows(const float* x, const float* shift, float* partial, int P,
                        int nblocks, int rows_per_block, cudaStream_t s) {
  auto kernel = sum_gram_rows_kernel<S>;
  // above 48 KB only as opted-in dynamic memory, set once per device: the
  // call costs the host more than a small launch's whole run
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= 64 || !opted[dev])) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(S::SMEM));
    if (err == cudaSuccess && dev < 64) opted[dev] = true;
  }
  if (err != cudaSuccess) return err;
  kernel<<<nblocks, S::NT, S::SMEM, s>>>(x, shift, partial, P, rows_per_block);
  return cudaGetLastError();
}

// ---- the tiled kernel (other widths) -----------------------------------------------

constexpr int TILE_RB = 32;  // rows staged per pass

template <int TM>
__global__ void __launch_bounds__(THREADS)
sum_gram_tiled_kernel(const float* __restrict__ x, const float* __restrict__ shift,
             float* __restrict__ partial, int P, int C, int rows_per_block, int tiles_c) {
  constexpr int CT = 16 * TM;
  __shared__ __align__(16) float xa[TILE_RB][CT];
  __shared__ __align__(16) float xb[TILE_RB][CT];

  const int ti = blockIdx.y / tiles_c;
  const int tj = blockIdx.y % tiles_c;
  const int i0 = ti * CT;
  const int j0 = tj * CT;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(P, r0 + rows_per_block);
  const int t = threadIdx.x;
  const int tr = t / 16;
  const int tc = t % 16;
  const bool do_sum = (tj == 0) && (t < CT);

  float acc[TM][TM];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int c = 0; c < TM; ++c) acc[a][c] = 0.f;
  float s = 0.f;

  for (int rb = r0; rb < r1; rb += TILE_RB) {
    for (int e = t; e < TILE_RB * CT; e += THREADS) {
      const int c = e % CT;
      const int r = e / CT;
      const int p = rb + r;
      const int ca = i0 + c;
      const int cb = j0 + c;
      float va = 0.f, vb = 0.f;  // rows past the range contribute nothing
      if (p < r1) {
        const float* row = x + (size_t)p * C;
        if (ca < C) va = row[ca] - (shift ? shift[ca] : 0.f);
        if (cb < C) vb = row[cb] - (shift ? shift[cb] : 0.f);
      }
      xa[r][c] = va;
      xb[r][c] = vb;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < TILE_RB; ++r) {
      float av[TM], bv[TM];
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        av[m] = xa[r][tr * TM + m];
        bv[m] = xb[r][tc * TM + m];
      }
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int c = 0; c < TM; ++c) acc[a][c] = fmaf(av[a], bv[c], acc[a][c]);
    }
    if (do_sum) {
      for (int r = 0; r < TILE_RB; ++r) s += xa[r][t];
    }
    __syncthreads();
  }

  float* out = partial + (size_t)blockIdx.x * ((size_t)C * C + C);
#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const int i = i0 + tr * TM + a;
    if (i >= C) continue;
#pragma unroll
    for (int c = 0; c < TM; ++c) {
      const int j = j0 + tc * TM + c;
      if (j < C) out[(size_t)i * C + j] = acc[a][c];
    }
  }
  if (do_sum && i0 + t < C) out[(size_t)C * C + i0 + t] = s;
}

// ---- the reduce ---------------------------------------------------------------------

constexpr int RED_LANES = 32, RED_SLICES = THREADS / RED_LANES;

__global__ void __launch_bounds__(THREADS)
sum_gram_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out, int nblocks,
              int len) {
  __shared__ float part[RED_SLICES][RED_LANES];
  const int lane = threadIdx.x % RED_LANES, slice = threadIdx.x / RED_LANES;
  const int e = blockIdx.x * RED_LANES + lane;
  float s = 0.f;
  if (e < len)
    for (int k = slice; k < nblocks; k += RED_SLICES) s += partial[(size_t)k * len + e];
  part[slice][lane] = s;
  __syncthreads();
  if (slice == 0 && e < len) {
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < RED_SLICES; ++q) t += part[q][lane];
    out[e] = t;
  }
}

cudaError_t launch_partials(const float* x, const float* shift, float* partial, int P,
                            int C, int nblocks, int rows_per_block, cudaStream_t s) {
  // RowShape<C, H, TI, TJ, G, RB, STAGES, MINB, PAD>; the wrapper's launch
  // plan (stats.py) knows RB and the blocks per SM
  switch (C) {
    case 24:  // the 10 of 4 x 4 tiles of 6 x 6 on and above the diagonal,
              // 25 row groups: 250 threads
      return launch_rows<RowShape<24, 4, 6, 6, 25, 300, 3, 2, 0>>(x, shift, partial, P,
                                                                  nblocks, rows_per_block, s);
    case 32:  // the 10 of 4 x 4 tiles of 8 x 8, 25 row groups: 250 threads
      return launch_rows<RowShape<32, 4, 8, 8, 25, 250, 3, 1, 4>>(x, shift, partial, P,
                                                                  nblocks, rows_per_block, s);
    case 64:  // the 36 of 8 x 8 tiles of 8 x 8, 7 row groups: 252 threads
      return launch_rows<RowShape<64, 8, 8, 8, 7, 126, 3, 1, 4>>(x, shift, partial, P,
                                                                 nblocks, rows_per_block, s);
    case 128:  // 3 blocks of 64 x 64, each 8 x 8 threads of 8 x 8: 192 threads,
               // two blocks per SM (the 136 tiles of 8 x 8 spill at that cap)
      return launch_rows<RowShape<128, 2, 8, 8, 1, 64, 3, 2, 0>>(x, shift, partial, P,
                                                                 nblocks, rows_per_block, s);
    default:
      break;
  }
  if (C <= 32) {
    const int tiles = (C + 31) / 32;
    sum_gram_tiled_kernel<2><<<dim3(nblocks, tiles * tiles), THREADS, 0, s>>>(
        x, shift, partial, P, C, rows_per_block, tiles);
  } else {
    const int tiles = (C + 63) / 64;
    sum_gram_tiled_kernel<4><<<dim3(nblocks, tiles * tiles), THREADS, 0, s>>>(
        x, shift, partial, P, C, rows_per_block, tiles);
  }
  return cudaGetLastError();
}

}  // namespace

// out: gram (C*C) followed by sum (C); partial: nblocks x (C*C + C) scratch;
// block k of the first kernel sums rows [k * rows_per_block, ...).
extern "C" int cd_sum_gram(const float* x, const float* shift, float* partial,
                           float* out, int P, int C, int nblocks,
                           int rows_per_block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_partials(x, shift, partial, P, C, nblocks, rows_per_block, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int len = C * C + C;
  sum_gram_reduce_kernel<<<(len + RED_LANES - 1) / RED_LANES, THREADS, 0, s>>>(partial, out,
                                                                      nblocks, len);
  return static_cast<int>(cudaGetLastError());
}
