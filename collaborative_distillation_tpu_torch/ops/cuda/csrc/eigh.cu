// Batched symmetric eigensolver: eigenvalues (ascending) and eigenvectors of
// B symmetric n x n float32 matrices, n <= 128, one block a matrix, for sm_90a.
//
// Replaces no TPU kernel: the reference takes its WCT roots from
// jnp.linalg.eigh, a library solver. It was added because no library solver
// on this card runs without stopping the host: torch.linalg.eigh (cuSOLVER)
// reads its info flag back with a blocking copy and drives its Jacobi sweeps
// from the host, so the queue drains at every decomposition of the WCT and
// the card then waits for the host's next launches. Here everything, the
// convergence test included, is decided on the card, and nothing is read
// back.
//
// Parallel cyclic Jacobi with round-robin (circle) ordering: a sweep is
// n - 1 rounds, each of n/2 disjoint pairs (p, q), so every pair of indices
// meets once a sweep and the rotations of one round commute. A and V live
// whole in dynamic shared memory (float32, row stride n + 1, odd, so a warp
// walking a row or a column of pair indices falls on distinct banks): about
// 140 KB at n = 128, opted in with cudaFuncSetAttribute. A is kept in its
// upper triangle alone, so it stays exactly symmetric and no mirror is
// written. An odd n is padded to even with a row and column of zeros off the
// diagonal: every rotation that meets it is skipped, so it stays decoupled
// and is dropped at the end.
//
// One round:
//   1. one thread a pair computes the symmetric Schur rotation of its 2 x 2
//      block (c, s, t = s / c), skipped (c = 1, s = 0) where
//      |a_pq| <= tol sqrt(|a_pp a_qq|), tol float32's epsilon, and writes
//      the block's own result at once (a_pp - t a_pq, a_qq + t a_pq, 0): no
//      other thread of the phase reads those three entries;
//   2. barrier; the two-sided update R_i^T A_ij R_j of the 2 x 2 blocks
//      (i < j) of A, listed once in a table in shared memory, and V's column
//      pairs, each thread keeping one pair of columns over every
//      (threads / (n/2))-th row; blocks and columns whose rotations are
//      skipped are left alone; barrier.
// A sweep that rotated nothing ends the block's sweeps (a flag a sweep in
// shared memory, so no extra barrier resets it); the sweeps are capped. The
// eigenvalues are the diagonal, ranked in shared memory (ties by index) and
// written with V's columns in that order, as torch.linalg.eigh gives them;
// the number of sweeps goes to a small int tensor that nothing on the path
// reads.
//
// What bounds it: latency. A sweep is n - 1 dependent rounds, each two
// barriers, one rotation a pair (a chain of a division and square roots)
// and one pass of shared-memory loads and stores over A's upper triangle and
// V (n^2 / 2 and n^2 values): the matrix never leaves shared memory, and the
// device memory traffic is the input read once and the output written once.
// Only B blocks run (two in the WCT: content and style), and nothing else
// can run beside them (the coloring matrix waits for them), so a round's
// time is the kernel's: ~1.8 us at n = 128 on an H100, of which A's update
// ~1.0, V's ~0.9 and the rotations with the barriers ~0.33; shared memory's
// bandwidth alone puts the pass over A and V at ~0.9 us. Hence the index
// arithmetic of the update is done once (the block table, one column pair a
// thread), and a pair is taken in position order, so that neighbouring
// threads touch neighbouring indices, on distinct banks.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_N = 128;
constexpr int MAX_SWEEPS = 64;   // the flags' room; the wrapper's cap is lower
constexpr int THREADS = 1024;

__host__ __device__ constexpr int padded(int n) { return n + (n & 1); }

// rows of V a pass: each thread keeps one pair of columns (tid % half) and
// walks the rows tid / half, + rows_step, ...
__host__ __device__ constexpr int rows_step(int n) {
  return padded(n) < THREADS / (padded(n) / 2) ? padded(n) : THREADS / (padded(n) / 2);
}

__host__ __device__ constexpr int blocks_of(int n) {
  return (padded(n) / 2) * (padded(n) / 2 - 1) / 2;
}

// floats of A and V, the pairs' rotations (c, s) and the eigenvalues, then
// ints: the 2 x 2 blocks' table, the pairs' indices (the ranks after), the
// flags
__host__ __device__ constexpr size_t smem_bytes(int n) {
  return sizeof(float) * (2 * padded(n) * (padded(n) + 1) + 2 * (padded(n) / 2) + padded(n)) +
         sizeof(int) * (blocks_of(n) + padded(n) + MAX_SWEEPS);
}

// A is kept in its upper triangle: entry (x, y) lies at (min, max)
__device__ __forceinline__ int upper(int x, int y, int ld) { return min(x, y) * ld + max(x, y); }

__global__ void __launch_bounds__(THREADS)
sym_eigh_kernel(const float* __restrict__ a, float* __restrict__ w, float* __restrict__ v,
                int* __restrict__ sweeps_out, int n, int max_sweeps, float tol) {
  extern __shared__ float smem[];
  const int np = padded(n), ld = np + 1, half = np / 2, nb = blocks_of(n);
  float* sa = smem;
  float* sv = sa + np * ld;
  float2* rcs = reinterpret_cast<float2*>(sv + np * ld);   // (c, s) of each pair
  float* sw = reinterpret_cast<float*>(rcs + half);       // the eigenvalues
  int* blk = reinterpret_cast<int*>(sw + np);   // block (i, j), i < j: i | j << 16
  int* rxy = blk + nb;          // each pair's indices in position order: x | y << 16
  int* rotated = rxy + np;      // one flag a sweep

  const int tid = threadIdx.x, nt = blockDim.x;
  const float* ab = a + static_cast<size_t>(blockIdx.x) * n * n;

  // the lower triangle (as torch.linalg.eigh reads it) into A's upper; V = I
  for (int idx = tid; idx < np * np; idx += nt) {
    const int c = idx / np, r = idx - c * np;   // input row c, read along
    if (r <= c) sa[r * ld + c] = c < n ? ab[c * n + r] : 0.f;
    sv[c * ld + r] = r == c ? 1.f : 0.f;
  }
  for (int j = 1 + tid; j < half; j += nt)
    for (int i = 0; i < j; ++i) blk[j * (j - 1) / 2 + i] = i | j << 16;
  for (int s = tid; s < MAX_SWEEPS; s += nt) rotated[s] = 0;
  __syncthreads();

  // this thread's pair of V's columns and its first row
  const int vk = tid % half, vrow = tid / half, vstep = nt / half;
  int sweep = 0;
  while (sweep < max_sweeps) {
    for (int r = 0; r < np - 1; ++r) {
      // the rotations of round r (circle method: position 0 holds index 0,
      // position j >= 1 index 1 + (j - 1 + r) mod (np - 1); pair k is
      // position k, x, against np - 1 - k, y), each pair's own block written
      // at once. The updates take a pair as (x, y), so that neighbouring
      // threads touch neighbouring indices, on distinct banks; s is signed
      // for that order (the rotation of (q, p) is that of (p, q) with -s)
      for (int k = tid; k < half; k += nt) {
        const int x = k == 0 ? 0 : 1 + (k - 1 + r) % (np - 1);
        const int y = 1 + (np - 2 - k + r) % (np - 1);
        const int p = min(x, y), q = max(x, y);
        const float app = sa[p * ld + p], aqq = sa[q * ld + q], apq = sa[p * ld + q];
        float c = 1.f, s = 0.f;
        if (fabsf(apq) > tol * sqrtf(fabsf(app)) * sqrtf(fabsf(aqq))) {
          // the tangent of the angle, the smaller root (1/(2 theta) where
          // theta^2 would overflow); its rounding only tilts the rotation,
          // which c and s keep orthogonal
          const float theta = __fdividef(aqq - app, 2.f * apq);
          const float at = fabsf(theta);
          const float t = copysignf(at > 1e18f ? __frcp_rn(2.f * at)
                                               : __frcp_rn(at + sqrtf(fmaf(at, at, 1.f))),
                                    theta);
          c = 1.f / sqrtf(fmaf(t, t, 1.f));
          s = t * c;
          sa[p * ld + p] = fmaf(-t, apq, app);
          sa[q * ld + q] = fmaf(t, apq, aqq);
          sa[p * ld + q] = 0.f;
          rotated[sweep] = 1;
        }
        rxy[k] = x | y << 16;
        rcs[k] = make_float2(c, x < y ? s : -s);
      }
      __syncthreads();
      // A's 2 x 2 blocks (i, j), i < j: R_i^T A_ij R_j, columns first
      for (int idx = tid; idx < nb; idx += nt) {
        const int ij = blk[idx], i = ij & 0xffff, j = ij >> 16;
        const float2 csi = rcs[i], csj = rcs[j];
        const float ci = csi.x, si = csi.y, cj = csj.x, sj = csj.y;
        if (si == 0.f && sj == 0.f) continue;
        const int xyi = rxy[i], xyj = rxy[j];
        const int xi = xyi & 0xffff, yi = xyi >> 16, xj = xyj & 0xffff, yj = xyj >> 16;
        const int e00 = upper(xi, xj, ld), e01 = upper(xi, yj, ld);
        const int e10 = upper(yi, xj, ld), e11 = upper(yi, yj, ld);
        const float b00 = sa[e00], b01 = sa[e01], b10 = sa[e10], b11 = sa[e11];
        const float x00 = cj * b00 - sj * b01, x01 = sj * b00 + cj * b01;
        const float x10 = cj * b10 - sj * b11, x11 = sj * b10 + cj * b11;
        sa[e00] = ci * x00 - si * x10;
        sa[e10] = si * x00 + ci * x10;
        sa[e01] = ci * x01 - si * x11;
        sa[e11] = si * x01 + ci * x11;
      }
      // V's columns x, y of this thread's pair, every vstep-th row
      {
        const float2 cs = rcs[vk];
        if (cs.y != 0.f) {
          const int xy = rxy[vk], x = xy & 0xffff, y = xy >> 16;
          for (int row = vrow; row < np; row += vstep) {
            const float vx = sv[row * ld + x], vy = sv[row * ld + y];
            sv[row * ld + x] = cs.x * vx - cs.y * vy;
            sv[row * ld + y] = cs.y * vx + cs.x * vy;
          }
        }
      }
      __syncthreads();
    }
    // every write of this sweep's flag came before the last barrier
    const bool done = rotated[sweep] == 0;
    ++sweep;
    if (done) break;
  }

  // rank sort of the n eigenvalues (the padding's is left out), ties by index
  for (int i = tid; i < n; i += nt) sw[i] = sa[i * ld + i];
  __syncthreads();
  float* wb = w + static_cast<size_t>(blockIdx.x) * n;
  float* vb = v + static_cast<size_t>(blockIdx.x) * n * n;
  int* rank = rxy;   // the pairs' indices are spent: np ints of room
  for (int i = tid; i < n; i += nt) {
    const float wi = sw[i];
    int below = 0;
    for (int j = 0; j < n; ++j) {
      const float wj = sw[j];
      below += (wj < wi) || (wj == wi && j < i);
    }
    rank[i] = below;
    wb[below] = wi;
  }
  __syncthreads();
  for (int idx = tid; idx < n * n; idx += nt) {
    const int row = idx / n, col = idx - row * n;
    vb[row * n + rank[col]] = sv[row * ld + col];
  }
  if (tid == 0) sweeps_out[blockIdx.x] = sweep;
}

}  // namespace

extern "C" int cd_sym_eigh(const float* a, float* w, float* v, int* sweeps, int batch, int n,
                           int max_sweeps, float tol, void* stream) {
  if (n < 1 || n > MAX_N || batch < 1 || max_sweeps < 1 || max_sweeps > MAX_SWEEPS)
    return static_cast<int>(cudaErrorInvalidValue);
  // above 48 KB only as opted-in dynamic memory: set once per device, for
  // the widest matrix, since the call costs the host more than a launch
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= 64 || !opted[dev])) {
    err = cudaFuncSetAttribute(sym_eigh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes(MAX_N)));
    if (err == cudaSuccess && dev < 64) opted[dev] = true;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // one thread a pair of V's columns and a row of each pass
  const int threads = (padded(n) / 2) * rows_step(n);
  sym_eigh_kernel<<<batch, threads, smem_bytes(n), static_cast<cudaStream_t>(stream)>>>(
      a, w, v, sweeps, n, max_sweeps, tol);
  return static_cast<int>(cudaGetLastError());
}
