// Coordinate-descent NNLS, one lane group per column: the device code that
// both CD kernels (cd_nnls_shared.cu, kernel 1; cd_nnls_batched.cu, kernel 2)
// share.  A shared-Gram solve is a batched solve whose Grams all alias one
// matrix, so the two kernels differ only in where a column's Gram comes from.
//
// The solve, per column j, as the plain twins compute it
// (rcppml_tpu_torch/ops/cd_nnls.py::cd_nnls_shared_plain and
// ops/cd_nnls_batched.py::cd_nnls_batched_plain):
//
//   for each sweep (at most maxit, while the column is active):
//     for i = 0..k-1:
//       diff   = g_ii > 0 ? b_i / g_ii - L1 : 0     (dead coordinate skipped,
//                                                   its L1 term included)
//       new    = clamp(x_i + diff)                  (nonneg, upper_bound)
//       actual = new - x_i;  x_i += actual
//       b_r   -= G[r, i] * actual   for every r     (column i of the Gram)
//       tol   += |actual| / (|x_i| + CD_ABS_TOL)
//     the column freezes once tol * (1/k) < cd_tol.
//
// Design.  A group of kG lanes (a power of two, at most 32: the smallest
// >= k, or fewer where the columns are so many that the issue of their steps
// bounds the solve and idle lanes would cost issue slots) owns a column;
// lane l owns rows r = l + kG s, s < kR, and holds their residual b_r and
// solution x_r in registers for the whole solve.  A step on coordinate i:
// the owner lane (i mod kG, slot i / kG) computes diff, new, actual and x_i;
// one __shfl_sync of width kG hands `actual` to the group; every lane
// updates its own b_r.  At the end of the sweep each owner makes the tol
// terms of its coordinates, and tol is added in coordinate order on every
// lane alike (one shuffle a coordinate), so the freeze test is uniform over
// the group, which then leaves its sweep loop: a frozen column is never
// touched again.  The group shuffles with a mask of its own lanes, so the
// other groups of its warp run on.
//
// Why the results are bitwise the twins': for a coordinate step nothing is
// reduced.  The k residual updates are independent across r, and the only
// sum, tol, runs over i in order.  Lanes owning rows and one lane owning the
// coordinate therefore perform every floating-point operation of the twin's
// order, each rounded once: every operation is an explicit _rn intrinsic, so
// nvcc cannot contract b - g a into an FMA, and division is IEEE-exact.  The
// twins leave a frozen column's b and x as they are (actual = 0 * active).
//
// Slots are unrolled (kR a template parameter) so that b and x stay in
// registers; with more than 8 rows a lane (k > 256), solve_loop keeps them
// in the group's shared memory instead.  The Gram is read as G[r * ld + i]
// from shared memory (ld = k | 1, odd, so that the lanes of a group reading
// column i meet distinct banks) or from device memory (ld = k).
//
// Bound on the H100: the dependent chain of a column, max sweeps x k steps,
// each an IEEE division, a few adds, compares and a shuffle; and the issue
// rate of all columns' steps together.  Kernel 2 also reads each column's
// Gram once per solve, n k^2 4 bytes in all.

#pragma once

#include <cuda_runtime.h>

namespace cd_nnls {

struct Params {
  float l1, cd_tol, inv_k, abs_tol, upper_bound;
  int nonneg, maxit;
};

// Lanes of the group that thread `tid` belongs to, as a warp mask.
template <int kG>
__device__ __forceinline__ unsigned group_mask(int tid) {
  if (kG == 32) return 0xffffffffu;
  return ((1u << kG) - 1u) << ((tid % 32) / kG * kG);
}

// One coordinate step's arithmetic on the owner's b_i and x_i, in the twins'
// order.  Returns actual and sets the new x_i.  The division is made whatever
// g_ii is and used only where g_ii > 0, so that no branch splits the step.
__device__ __forceinline__ float step(float bi, float xi, float gii,
                                      const Params& p, float& xn) {
  const float q = __fdiv_rn(bi, gii);
  const float diff = gii > 0.f ? __fsub_rn(q, p.l1) : 0.f;
  float nv = __fadd_rn(xi, diff);
  if (p.nonneg) nv = fmaxf(nv, 0.f);
  if (p.upper_bound > 0.f) nv = fminf(nv, p.upper_bound);
  const float actual = __fsub_rn(nv, xi);
  xn = __fadd_rn(xi, actual);
  return actual;
}

// A step's tol term: |actual| / (|x_i| + CD_ABS_TOL), x_i the new value.
__device__ __forceinline__ float tol_term(float actual, float xn,
                                          const Params& p) {
  return __fdiv_rn(fabsf(actual), __fadd_rn(fabsf(xn), p.abs_tol));
}

// The column of group-lane `lane` (rows lane + kG s), b and x in registers.
// `gram` is the column's Gram, G[r, i] at gram[r * ld + i].  Rows at or past
// k read row k - 1 and are never written back.
//
// Only what the next step needs is on the dependent chain: the owner's
// division, adds and clamps, the shuffle of `actual` and each lane's
// multiply-subtract.  The next step's Gram column is loaded while this one
// computes, and the tol terms wait for the end of the sweep: the owner keeps
// the `actual` of each coordinate it owns (with its x, the term's inputs),
// and the sweep's tol is then added in coordinate order on every lane from
// one shuffle per coordinate, the same sum the twins take step by step.
template <int kG, int kR>
__device__ __forceinline__ void solve_regs(const float* gram, int ld, int k,
                                           int lane, unsigned mask,
                                           float (&b)[kR], float (&x)[kR],
                                           const Params& p) {
  int off[kR];
  float act[kR];   // the step's actual of the coordinate t kG + lane
#pragma unroll
  for (int s = 0; s < kR; ++s) {
    off[s] = min(s * kG + lane, k - 1) * ld;
    act[s] = 0.f;
  }
  for (int it = 0; it < p.maxit; ++it) {
    float g[kR];
#pragma unroll
    for (int s = 0; s < kR; ++s) g[s] = gram[off[s]];
    float gii = gram[0];
#pragma unroll
    for (int t = 0; t < kR; ++t) {
      const int steps = min(kG, k - t * kG);
      for (int o = 0; o < steps; ++o) {
        // the next step's column, loaded while this step computes
        const int next = min(t * kG + o + 1, k - 1);
        float g_next[kR];
#pragma unroll
        for (int s = 0; s < kR; ++s) g_next[s] = gram[off[s] + next];
        const float gii_next = gram[next * ld + next];
        // every lane computes, the owner's result is taken
        float xn;
        const float mine = step(b[t], x[t], gii, p, xn);
        if (lane == o) {
          x[t] = xn;
          act[t] = mine;
        }
        const float actual = __shfl_sync(mask, mine, o, kG);
#pragma unroll
        for (int s = 0; s < kR; ++s) {
          b[s] = __fsub_rn(b[s], __fmul_rn(g[s], actual));
          g[s] = g_next[s];
        }
        gii = gii_next;
      }
    }
    // tol = (((0 + term_0) + term_1) + ...) over the coordinates in order
    float tol_sum = 0.f;
#pragma unroll
    for (int t = 0; t < kR; ++t) {
      const int steps = min(kG, k - t * kG);
      const float mine = tol_term(act[t], x[t], p);
      float term[kG];
#pragma unroll
      for (int o = 0; o < kG; ++o) term[o] = __shfl_sync(mask, mine, o, kG);
#pragma unroll
      for (int o = 0; o < kG; ++o)
        if (o < steps) tol_sum = __fadd_rn(tol_sum, term[o]);
    }
    if (!(__fmul_rn(tol_sum, p.inv_k) >= p.cd_tol)) break;
  }
}

// The same solve for any k, one warp a column: b and x are this column's k
// floats in shared memory, lane l owning rows l + 32 s (the owner of
// coordinate i is lane i mod 32, which owns row i too, so no lane reads what
// another writes).
__device__ __forceinline__ void solve_loop(const float* gram, int ld, int k,
                                           int lane, float* b, float* x,
                                           const Params& p) {
  for (int it = 0; it < p.maxit; ++it) {
    float tol_sum = 0.f;
    for (int i = 0; i < k; ++i) {
      const int o = i % 32;
      float actual = 0.f, term = 0.f;
      if (lane == o) {
        float xn;
        actual = step(b[i], x[i], gram[i * ld + i], p, xn);
        term = tol_term(actual, xn, p);
        x[i] = xn;
      }
      actual = __shfl_sync(0xffffffffu, actual, o);
      for (int r = lane; r < k; r += 32)
        b[r] = __fsub_rn(b[r], __fmul_rn(gram[r * ld + i], actual));
      tol_sum = __fadd_rn(tol_sum, __shfl_sync(0xffffffffu, term, o));
    }
    if (!(__fmul_rn(tol_sum, p.inv_k) >= p.cd_tol)) break;
  }
}

// A column's residual and warm start, (k, n) row-major, into registers.
template <int kG, int kR>
__device__ __forceinline__ void load_column(const float* __restrict__ B,
                                            const float* __restrict__ X0,
                                            int k, int n, int j, int lane,
                                            float (&b)[kR], float (&x)[kR]) {
#pragma unroll
  for (int s = 0; s < kR; ++s) {
    const int r = s * kG + lane;
    const size_t at = static_cast<size_t>(r) * n + j;
    b[s] = r < k ? B[at] : 0.f;
    x[s] = r < k ? X0[at] : 0.f;
  }
}

template <int kG, int kR>
__device__ __forceinline__ void store_column(float* __restrict__ X, int k,
                                             int n, int j, int lane,
                                             const float (&x)[kR]) {
#pragma unroll
  for (int s = 0; s < kR; ++s) {
    const int r = s * kG + lane;
    if (r < k) X[static_cast<size_t>(r) * n + j] = x[s];
  }
}

// What a launch needs, whichever kernel.
struct Launch {
  const float* gram;   // G (k, k) or Gb (n, k, k), row-major
  const float* B;      // (k, n) residual B - G X0, read only
  const float* X0;     // (k, n) warm start
  float* X;            // (k, n) solution
  int k, n;
  Params p;
  int threads, shared_bytes;
  cudaStream_t stream;
};

// Picks the instantiation: `lanes` in {1, 2, 4, 8, 16, 32} and `rows` in
// {1, 2, 4, 8}, each with the Gram in shared memory or not; rows == 0 is the
// loop variant (lanes == 32, Gram in device memory).  Kernels::go<kG, kR,
// kGramShared>(launch) launches one of them (kR == 0: the loop variant).
template <class Kernels, int kG>
cudaError_t dispatch_rows(const Launch& L, int rows, bool gram_shared) {
#define CD_GO(R)                                                           \
  return gram_shared ? Kernels::template go<kG, R, true>(L)                \
                     : Kernels::template go<kG, R, false>(L)
  switch (rows) {
    case 1: CD_GO(1);
    case 2: CD_GO(2);
    case 4: CD_GO(4);
    case 8: CD_GO(8);
    default: return cudaErrorInvalidValue;
  }
#undef CD_GO
}

template <class Kernels>
cudaError_t dispatch(const Launch& L, int lanes, int rows, bool gram_shared) {
  if (rows == 0) {
    return lanes == 32 && !gram_shared
               ? Kernels::template go<32, 0, false>(L)
               : cudaErrorInvalidValue;
  }
  switch (lanes) {
    case 1: return dispatch_rows<Kernels, 1>(L, rows, gram_shared);
    case 2: return dispatch_rows<Kernels, 2>(L, rows, gram_shared);
    case 4: return dispatch_rows<Kernels, 4>(L, rows, gram_shared);
    case 8: return dispatch_rows<Kernels, 8>(L, rows, gram_shared);
    case 16: return dispatch_rows<Kernels, 16>(L, rows, gram_shared);
    case 32: return dispatch_rows<Kernels, 32>(L, rows, gram_shared);
    default: return cudaErrorInvalidValue;
  }
}

// Sets the dynamic shared memory a kernel may take, then launches it on
// `grid` blocks; returns the launch's error.
template <class Kernel>
cudaError_t launch_with_shared(Kernel kernel, const Launch& L, int grid) {
  if (L.shared_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.shared_bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, L.threads, L.shared_bytes, L.stream>>>(L);
  return cudaGetLastError();
}

}  // namespace cd_nnls
