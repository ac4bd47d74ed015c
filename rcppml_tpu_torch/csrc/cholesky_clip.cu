// Shared-Gram Cholesky solve + clip for a whole column batch, for sm_90a.
//
// Replaces the TPU kernel rcppml_tpu/ops/pallas_experiments.py::cholesky_clip_pallas
// (body _make_chol_kernel).  For G (k, k) symmetric positive definite (the
// caller has added any ridge) and B (k, n), float32 row-major:
//
//   G = L L^T          k Schur-complement steps on the lower triangle
//   L Y = B            forward substitution, every column
//   L^T X = Y          back substitution, every column
//   X = min(max(X, 0), upper_bound)   as asked (nonneg, upper_bound > 0)
//
// Every operation is an _rn intrinsic in the order of the plain twin
// (rcppml_tpu_torch/ops/cholesky_clip.py::cholesky_clip_plain), with no
// multiply-add contraction, so the result is the twin's bit for bit.
//
// What does not carry over: the TPU kernel keeps L and L^T to turn both
// substitutions into masked full-column reductions (its vector unit has no
// scalar path).  Here a column's substitutions are a chain of scalar steps,
// and the design is about that chain.
//
// Route 1, one launch (k <= kLanesMaxK; chol_lanes_kernel): every block
// factors G itself and then solves its own columns.
//   * The factor: warp 0, lane a holding rows a and a + 32 of the trailing
//     matrix in registers.  Step j: one shuffle hands the owner's pivot to
//     the warp, every lane takes its square root and divides its entry of
//     column j; then for every c > j one shuffle hands out L[c, j] and each
//     lane updates its entry (row, c).  No barrier and no memory operand on
//     the chain; each step writes its column of L to shared memory (row
//     stride k | 1).  Every block does the same operations, so every
//     block's L is the same bits.
//   * Meanwhile the block's columns of B are copied into a shared tile with
//     4-byte cp.async (consecutive threads on consecutive columns).
//   * The solve: a group of g lanes (a power of two) owns a column; lane t
//     holds rows t + g q in registers.  Forward step i: the owner (lane
//     i mod g, slot i / g) divides by L[i, i], one shuffle of width g hands
//     y_i to the group, every lane subtracts L[l, i] y_i from its rows
//     l > i.  Back substitution the same, i descending, rows l < i.  This
//     is the twin's column-oriented order, so the chain of a column is 2k
//     steps of a division, a shuffle and a multiply-subtract, all operands
//     in registers: each lane keeps its rows' 1 / L[l, l] in double
//     precision, the division being x times it rounded to float (exactly
//     the IEEE quotient, see divide()), and the next step's entries of L
//     are loaded from shared memory (bank-distinct strides) while a step
//     computes.  At most 8 rows a lane (kR), every slot
//     updated under a predicate, as the CD kernels do (cd_nnls.cuh).
//   * X goes back through the tile and leaves it coalesced, clipped on the
//     way.
//   * Code size matters here: both loops are written so that their bodies
//     are the same code for every step (each lane's rows shift through a
//     fixed window of registers), which keeps the kernel within the
//     instruction cache.
// Group width, rows a lane and block size come from the plan
// (rcppml_tpu_torch/ops/cholesky_clip.py::plan_cholesky_clip), which fills
// the card where the columns allow it.
//
// Route 2, two launches (k > kLanesMaxK): chol_factor_kernel, one block of
// 32 x 32 threads, factors G into L (k, k) in device memory, in shared
// memory while k (k | 1) floats fit (k <= 240) and in place in device memory
// beyond; chol_solve_clip_kernel runs one thread per column against a
// broadcast L (shared memory while k^2 floats fit).
//
// A pivot that is not above 1e-30 (G not positive definite, or NaN) is
// replaced by G's own diagonal entry, or by 1e-30 where that is not above it
// either: the solve ends with a finite, damped X (NaN only from a NaN in G)
// instead of hanging or raising.  A rank-deficient fp32 Gram can meet this
// even with the fit's ridge, where rounding leaves a pivot at or below zero;
// a floor of 1e-30 alone then divides by 1e-15 and the fit ends in NaN.
//
// Bound on the H100: k^3 / 3 + 2 k^2 n float32 operations outside the tensor
// cores against one read of G and B and one write of X, bytes first at the
// main path's shapes.  What it waits for is latency: the k pivot steps of
// the factor and the 2k steps of each column's substitutions are sequential.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFactorSide = 32;                  // route 2: 32 x 32 threads
constexpr int kSolveThreads = 128;
constexpr float kPivotFloor = 1e-30f;
constexpr int kLanesMaxK = 64;                   // route 1 up to this k
constexpr int kLanesMaxThreads = 256;
constexpr int kFactorRun = 8;
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// Route 1: one launch, a lane group per column
// ---------------------------------------------------------------------------

// x / d, correctly rounded, from rd = 1 / d rounded to double: x rd carries
// a relative error below 2^-52, and a quotient of two floats lies at least
// 2^-49 (relative) from every midpoint between two floats (its distance
// to one is a nonzero multiple of 2^(e-1) / D for the quotient's exponent e
// and d's significand D < 2^24), so rounding x rd to float gives the float
// nearest x / d: __fdiv_rn's result, with a multiply and a conversion on
// the chain instead of a division and its branch to a slow path.
__device__ __forceinline__ double recip(float d) {
  return __drcp_rn(static_cast<double>(d));
}
__device__ __forceinline__ float divide(float x, double rd) {
  return __double2float_rn(static_cast<double>(x) * rd);
}

// Warp 0 factors G into L in shared memory (Ls, row stride ldl).  Lane a
// holds rows a + 32 p, p < kP, of the trailing matrix in registers, shifted
// so that r[p][0] is always the current column: at step j, r[p][i] =
// S[row, j + i].  kP = 1 covers k <= 32, kP = 2 k <= 64.  The step is a
// loop over j whose body is the same code for every j: the k x k unrolled
// factor compiled to straight-line code whose instruction fetch bounded it.
template <int kP>
__device__ __forceinline__ void factor_warp(const float* __restrict__ G,
                                            float* Ls, int k, int ldl,
                                            int lane) {
  constexpr int kF = 32 * kP;
  float r[kP][kF];
  float stand[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    const int row = lane + 32 * p;
    const bool real = row < k;
    const float g = real ? G[static_cast<size_t>(row) * k + row] : 1.f;
    stand[p] = g > kPivotFloor ? g : kPivotFloor;
#pragma unroll
    for (int c = 0; c < kF; ++c)
      r[p][c] = (real && c <= row && c < k)
                    ? G[static_cast<size_t>(row) * k + c] : 0.f;
  }
  for (int j = 0; j < k; ++j) {
    // the owner's pivot, or its stand-in, to every lane
    float mine = r[0][0] > kPivotFloor ? r[0][0] : stand[0];
    if (kP == 2 && j >= 32) mine = r[kP - 1][0] > kPivotFloor
                                       ? r[kP - 1][0] : stand[kP - 1];
    const float d = __fsqrt_rn(__shfl_sync(kFull, mine, j & 31));
    // column j: L[row, j] = S[row, j] / d below the pivot, d on it.  A row
    // at or above the pivot divides 0: its registers hold what the shifted
    // updates left there, which can grow past the float range, and a
    // division of an infinity or NaN takes __fdiv_rn's slow path
    float l[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int row = lane + 32 * p;
      l[p] = __fdiv_rn(row > j ? r[p][0] : 0.f, d);
      if (row < k && row >= j) Ls[row * ldl + j] = row == j ? d : l[p];
    }
    // S[row, c] -= L[row, j] L[c, j] for c > j, shifted down by one column,
    // in runs of 8 columns with no branch inside a run, so that a run's
    // shuffles are all in flight together (a column past k computes what
    // is never read)
#pragma unroll
    for (int i0 = 0; i0 + 1 < kF; i0 += kFactorRun) {
      if (j + 1 + i0 >= k) break;
#pragma unroll
      for (int i = i0; i < i0 + kFactorRun && i + 1 < kF; ++i) {
        const int c = j + 1 + i;
        const float v = (kP == 2 && c >= 32) ? l[kP - 1] : l[0];
        const float lc = __shfl_sync(kFull, v, c & 31);
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          // the next pivot's row takes its own L entry, not its shuffle's:
          // the same value, one shuffle off the chain
          const float lm = i == 0 && lane + 32 * p == c ? l[p] : lc;
          r[p][i] = __fsub_rn(r[p][i + 1], __fmul_rn(l[p], lm));
        }
      }
    }
  }
}

// Shared memory: Ls[k][ldl] (ldl = k | 1), then the column tile Ts[k][ldx],
// column c of the block at Ts[l * ldx + c].  A block of blockDim.x threads
// owns cols = blockDim.x / g columns from blockIdx.x * cols.  kR: rows a
// lane holds in registers (1, 2, 4 or 8, at least ceil(k / g)).
template <int kP, int kR>
__global__ void __launch_bounds__(kLanesMaxThreads)
chol_lanes_kernel(const float* __restrict__ G, const float* __restrict__ B,
                  float* __restrict__ X, int k, int n, int g, int ldx,
                  int nonneg, float upper_bound) {
  extern __shared__ __align__(16) float smem[];
  const int ldl = k | 1;
  float* Ls = smem;
  float* Ts = smem + k * ldl;
  const int tid = threadIdx.x, lane = tid % 32;
  const int cols = blockDim.x / g;
  const int j0 = blockIdx.x * cols;
  const size_t sn = static_cast<size_t>(n);

  // the block's columns of B into the tile, zero past n
  for (int e = tid; e < k * cols; e += blockDim.x) {
    const int l = e / cols, c = e % cols;
    float* dst = Ts + l * ldx + c;
    if (j0 + c < n) {
      const uint32_t d =
          static_cast<uint32_t>(__cvta_generic_to_shared(dst));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                   "l"(B + l * sn + j0 + c)
                   : "memory");
    } else {
      *dst = 0.f;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (tid < 32) factor_warp<kP>(G, Ls, k, ldl, lane);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // This lane's column and its rows t + g q.  The registers hold a window
  // of kR slots that moves with the substitution: slot s holds row
  // t + g (q + s) while the forward pass is at slot q (t + g (q - s) in the
  // back pass), so the current row is always x[0] and the loop over q is
  // the same code for every q.  A finished row goes back to the tile.  Rows
  // at or past k (padding) read row k - 1 of L and are never an owner nor
  // written back.  Each lane keeps its window's 1 / L[l, l] in double
  // precision (rd): the owner of row i divides by its own, so no load waits
  // on the chain, and the next step's entries of L are loaded while a step
  // computes.
  const int t = lane % g;
  const int col = tid / g;
  const int rq = (k + g - 1) / g;
  float x[kR], lc[kR];
  double rd[kR];
#pragma unroll
  for (int s = 0; s < kR; ++s) {
    const int l = t + g * s;
    x[s] = l < k ? Ts[l * ldx + col] : 0.f;
    rd[s] = l < k ? recip(Ls[l * ldl + l]) : 1.0;
  }

  // L y = b: y_i = b_i / L[i, i], then b_l -= L[l, i] y_i for l > i
  for (int q = 0; q < rq; ++q) {
    int at[kR];
#pragma unroll
    for (int s = 0; s < kR; ++s) at[s] = min(t + g * (q + s), k - 1) * ldl;
    const int i0 = q * g;
#pragma unroll
    for (int s = 0; s < kR; ++s) lc[s] = Ls[at[s] + i0];
    const int steps = min(g, k - i0);
    for (int ti = 0; ti < steps; ++ti) {
      const int i = i0 + ti;
      const int next = min(i + 1, k - 1);
      float ln[kR];
#pragma unroll
      for (int s = 0; s < kR; ++s) ln[s] = Ls[at[s] + next];
      const float y = __shfl_sync(kFull, divide(x[0], rd[0]), ti, g);
      if (t == ti) x[0] = y;
#pragma unroll
      for (int s = 0; s < kR; ++s) {
        if (t + g * (q + s) > i) x[s] = __fsub_rn(x[s], __fmul_rn(lc[s], y));
        lc[s] = ln[s];
      }
    }
    if (t + i0 < k) Ts[(t + i0) * ldx + col] = x[0];
#pragma unroll
    for (int s = 0; s + 1 < kR; ++s) {
      x[s] = x[s + 1];
      rd[s] = rd[s + 1];
    }
    x[kR - 1] = 0.f;
    rd[kR - 1] = 1.0;
  }

  // L^T x = y: x_i = y_i / L[i, i], then y_l -= L[i, l] x_i for l < i, i
  // descending; row i of L is read at the lanes' columns l
#pragma unroll
  for (int s = 0; s < kR; ++s) {
    const int l = t + g * (rq - 1 - s);
    x[s] = l >= 0 && l < k ? Ts[l * ldx + col] : 0.f;
    rd[s] = l >= 0 && l < k ? recip(Ls[l * ldl + l]) : 1.0;
  }
  for (int q = rq - 1; q >= 0; --q) {
    int at[kR];
#pragma unroll
    for (int s = 0; s < kR; ++s) at[s] = min(max(t + g * (q - s), 0), k - 1);
    const int i0 = q * g;
    const int steps = min(g, k - i0);
#pragma unroll
    for (int s = 0; s < kR; ++s) lc[s] = Ls[(i0 + steps - 1) * ldl + at[s]];
    for (int ti = steps - 1; ti >= 0; --ti) {
      const int i = i0 + ti;
      const int next = max(i - 1, 0);
      float ln[kR];
#pragma unroll
      for (int s = 0; s < kR; ++s) ln[s] = Ls[next * ldl + at[s]];
      const float y = __shfl_sync(kFull, divide(x[0], rd[0]), ti, g);
      if (t == ti) x[0] = y;
#pragma unroll
      for (int s = 0; s < kR; ++s) {
        if (t + g * (q - s) < i) x[s] = __fsub_rn(x[s], __fmul_rn(lc[s], y));
        lc[s] = ln[s];
      }
    }
    if (t + i0 < k) Ts[(t + i0) * ldx + col] = x[0];
#pragma unroll
    for (int s = 0; s + 1 < kR; ++s) {
      x[s] = x[s + 1];
      rd[s] = rd[s + 1];
    }
    x[kR - 1] = 0.f;
    rd[kR - 1] = 1.0;
  }
  __syncthreads();

  // solve, then clip (clipping inside the recurrence would change the
  // solution, cholesky_clip.hpp), on the way out of the tile, coalesced
  for (int e = tid; e < k * cols; e += blockDim.x) {
    const int l = e / cols, c = e % cols;
    if (j0 + c >= n) continue;
    float v = Ts[l * ldx + c];
    if (nonneg) v = fmaxf(v, 0.f);
    if (upper_bound > 0.f) v = fminf(v, upper_bound);
    X[l * sn + j0 + c] = v;
  }
}

// ---------------------------------------------------------------------------
// Route 2: the factor in one block, then one thread per column
// ---------------------------------------------------------------------------

// S (row stride ld) starts as G's lower triangle and ends as L; `work` is
// shared memory (ld = k | 1: column reads hit distinct banks) or L itself in
// device memory (ld = k).
__global__ void __launch_bounds__(kFactorSide * kFactorSide)
chol_factor_kernel(const float* __restrict__ G, float* L, int k, int ld,
                   int use_smem) {
  extern __shared__ float smem[];
  float* S = use_smem ? smem : L;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kFactorSide + tx;
  const int nthreads = kFactorSide * kFactorSide;
  const size_t sld = static_cast<size_t>(ld);

  for (int idx = tid; idx < k * k; idx += nthreads) {
    const int a = idx / k, c = idx % k;
    if (c <= a) S[a * sld + c] = G[idx];
  }
  __syncthreads();

  for (int j = 0; j < k; ++j) {
    float piv = S[j * sld + j];
    if (!(piv > kPivotFloor)) {
      const float g = G[static_cast<size_t>(j) * k + j];
      piv = g > kPivotFloor ? g : kPivotFloor;
    }
    const float d = __fsqrt_rn(piv);
    __syncthreads();  // every thread has read the pivot
    for (int a = j + tid; a < k; a += nthreads)
      S[a * sld + j] = a == j ? d : __fdiv_rn(S[a * sld + j], d);
    __syncthreads();
    // trailing update of the lower triangle: S[a, c] -= L[a, j] * L[c, j]
    for (int a = j + 1 + ty; a < k; a += kFactorSide) {
      const float la = S[a * sld + j];
      for (int c = j + 1 + tx; c <= a; c += kFactorSide)
        S[a * sld + c] =
            __fsub_rn(S[a * sld + c], __fmul_rn(la, S[c * sld + j]));
    }
    __syncthreads();
  }

  // L as a full (k, k) matrix, zero above the diagonal
  for (int idx = tid; idx < k * k; idx += nthreads) {
    const int a = idx / k, c = idx % k;
    if (c > a) {
      L[idx] = 0.f;
    } else if (use_smem) {
      L[idx] = S[a * sld + c];
    }
  }
}

__global__ void __launch_bounds__(kSolveThreads)
chol_solve_clip_kernel(const float* __restrict__ L,
                       const float* __restrict__ B, float* X, int k, int n,
                       int use_smem, int nonneg, float upper_bound) {
  extern __shared__ float smem[];
  if (use_smem) {
    for (int idx = threadIdx.x; idx < k * k; idx += blockDim.x)
      smem[idx] = L[idx];
    __syncthreads();
  }
  const float* Lp = use_smem ? smem : L;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const size_t sn = static_cast<size_t>(n);
  const size_t sk = static_cast<size_t>(k);

  // L y = b: y_i = (b_i - sum_{l < i} L[i, l] y_l) / L[i, i], l ascending
  for (int i = 0; i < k; ++i) {
    float acc = B[i * sn + j];
    for (int l = 0; l < i; ++l)
      acc = __fsub_rn(acc, __fmul_rn(Lp[i * sk + l], X[l * sn + j]));
    X[i * sn + j] = __fdiv_rn(acc, Lp[i * sk + i]);
  }
  // L^T x = y: x_i = (y_i - sum_{l > i} L[l, i] x_l) / L[i, i], l descending
  for (int i = k - 1; i >= 0; --i) {
    float acc = X[i * sn + j];
    for (int l = k - 1; l > i; --l)
      acc = __fsub_rn(acc, __fmul_rn(Lp[l * sk + i], X[l * sn + j]));
    X[i * sn + j] = __fdiv_rn(acc, Lp[i * sk + i]);
  }
  if (nonneg || upper_bound > 0.f) {
    for (int i = 0; i < k; ++i) {
      float x = X[i * sn + j];
      if (nonneg) x = fmaxf(x, 0.f);
      if (upper_bound > 0.f) x = fminf(x, upper_bound);
      X[i * sn + j] = x;
    }
  }
}

cudaError_t allow_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int kP, int kR>
cudaError_t launch_lanes(const float* G, const float* B, float* X, int k,
                         int n, int g, int threads, int ldx, int nonneg,
                         float upper_bound, cudaStream_t s) {
  const size_t bytes =
      sizeof(float) * static_cast<size_t>(k) * ((k | 1) + ldx);
  cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(chol_lanes_kernel<kP, kR>), bytes);
  if (err != cudaSuccess) return err;
  const int cols = threads / g;
  chol_lanes_kernel<kP, kR><<<(n + cols - 1) / cols, threads, bytes, s>>>(
      G, B, X, k, n, g, ldx, nonneg, upper_bound);
  return cudaGetLastError();
}

template <int kP>
cudaError_t launch_rows(const float* G, const float* B, float* X, int k,
                        int n, int g, int rows, int threads, int ldx,
                        int nonneg, float upper_bound, cudaStream_t s) {
  switch (rows) {
    case 1:
      return launch_lanes<kP, 1>(G, B, X, k, n, g, threads, ldx, nonneg,
                                 upper_bound, s);
    case 2:
      return launch_lanes<kP, 2>(G, B, X, k, n, g, threads, ldx, nonneg,
                                 upper_bound, s);
    case 4:
      return launch_lanes<kP, 4>(G, B, X, k, n, g, threads, ldx, nonneg,
                                 upper_bound, s);
    case 8:
      return launch_lanes<kP, 8>(G, B, X, k, n, g, threads, ldx, nonneg,
                                 upper_bound, s);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t launch_two(const float* G, const float* B, float* L, float* X,
                       int k, int n, int nonneg, float upper_bound,
                       int smem_optin, cudaStream_t s) {
  const int ld_smem = k | 1;
  size_t bytes = sizeof(float) * static_cast<size_t>(k) * ld_smem;
  int use_smem = bytes <= static_cast<size_t>(smem_optin);
  if (!use_smem) bytes = 0;
  cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(chol_factor_kernel), bytes);
  if (err != cudaSuccess) return err;
  chol_factor_kernel<<<1, dim3(kFactorSide, kFactorSide), bytes, s>>>(
      G, L, k, use_smem ? ld_smem : k, use_smem);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  bytes = sizeof(float) * static_cast<size_t>(k) * k;
  use_smem = bytes <= static_cast<size_t>(smem_optin);
  if (!use_smem) bytes = 0;
  err = allow_smem(reinterpret_cast<const void*>(chol_solve_clip_kernel),
                   bytes);
  if (err != cudaSuccess) return err;
  chol_solve_clip_kernel<<<(n + kSolveThreads - 1) / kSolveThreads,
                           kSolveThreads, bytes, s>>>(
      L, B, X, k, n, use_smem, nonneg, upper_bound);
  return cudaGetLastError();
}

}  // namespace

// G (k, k), B (k, n) -> X (k, n), all float32, contiguous, on the current
// device, distinct buffers.  The plan (rcppml_tpu_torch/ops/cholesky_clip.py
// ::plan_cholesky_clip): lanes > 0 takes route 1 with groups of `lanes`
// lanes, `rows` (1, 2, 4 or 8) rows a lane, blocks of `threads` threads and a
// tile of row stride `ldx`; L is not used.  lanes == 0 takes route 2, with
// L (k, k) as scratch that ends as the factor.  Returns the cudaError_t of
// the first launch that failed (0 on success).
extern "C" int cholesky_clip_launch(const float* G, const float* B, float* L,
                                    float* X, int k, int n, int nonneg,
                                    float upper_bound, int lanes, int rows,
                                    int threads, int ldx, void* stream) {
  if (k <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes > 0) {
    if (k > kLanesMaxK || lanes > 32 || (lanes & (lanes - 1)) != 0 ||
        threads % 32 != 0 || threads > kLanesMaxThreads ||
        static_cast<long long>(lanes) * rows < k || ldx < threads / lanes)
      return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err =
        k <= 32 ? launch_rows<1>(G, B, X, k, n, lanes, rows, threads, ldx,
                                 nonneg, upper_bound, s)
                : launch_rows<2>(G, B, X, k, n, lanes, rows, threads, ldx,
                                 nonneg, upper_bound, s);
    return static_cast<int>(err);
  }
  if (L == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int smem_optin = 0;
  err = cudaDeviceGetAttribute(&smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_two(G, B, L, X, k, n, nonneg, upper_bound,
                                     smem_optin, s));
}
