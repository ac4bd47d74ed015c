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
// multiply-add contraction.
//
// What does not carry over: the TPU kernel factors G again in every block of
// 128 columns and keeps L and L^T to turn both substitutions into masked
// full-column reductions (its vector unit has no scalar path).  Here one C
// call enqueues two kernels.  chol_factor_kernel: one block factors G once
// into L (k, k) in device memory, working in shared memory while k (k | 1)
// floats fit (k <= 240) and in place in device memory beyond.
// chol_solve_clip_kernel: one thread per column; L is staged in shared memory
// while k^2 floats fit and read through the cache beyond, always as a
// broadcast (every thread of a warp reads the same L entry); Y and the
// unclipped X live in the output buffer, which a thread reads and writes only
// in its own column, coalesced across the warp.
//
// A pivot that is not above 1e-30 (G not positive definite, or NaN) is
// replaced by G's own diagonal entry, or by 1e-30 where that is not above it
// either: the solve ends with a finite, damped X (NaN only from a NaN in G)
// instead of hanging or raising.  A rank-deficient fp32 Gram can meet this
// even with the fit's ridge, where rounding leaves a pivot at or below zero;
// a floor of 1e-30 alone then divides by 1e-15 and the fit ends in NaN.
//
// Bound on the H100: float32 operations outside the tensor cores, k^3 / 3 for
// the factorization plus 2 k^2 n for the substitutions, against one read of
// G and B and one write of X.  What it really waits for is latency: the k
// pivot steps are sequential, and each column's 2 k^2 multiply-subtracts form
// two dependent chains.

#include <cuda_runtime.h>

namespace {

constexpr int kFactorSide = 32;                  // 32 x 32 threads
constexpr int kSolveThreads = 128;
constexpr float kPivotFloor = 1e-30f;

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
  // solve, then clip: clipping inside the recurrence would change the
  // solution (cholesky_clip.hpp)
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

}  // namespace

// G (k, k), B (k, n) -> X (k, n); L (k, k) is scratch that ends as the
// factor.  All float32, contiguous, on the current device; G, B, L and X are
// distinct buffers.  Returns the cudaError_t of the first launch that failed
// (0 on success).
extern "C" int cholesky_clip_launch(const float* G, const float* B, float* L,
                                    float* X, int k, int n, int nonneg,
                                    float upper_bound, void* stream) {
  if (k <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int smem_optin = 0;
  err = cudaDeviceGetAttribute(&smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);

  const int ld_smem = k | 1;
  size_t bytes = sizeof(float) * static_cast<size_t>(k) * ld_smem;
  int use_smem = bytes <= static_cast<size_t>(smem_optin);
  if (!use_smem) bytes = 0;
  err = allow_smem(reinterpret_cast<const void*>(chol_factor_kernel), bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_factor_kernel<<<1, dim3(kFactorSide, kFactorSide), bytes, s>>>(
      G, L, k, use_smem ? ld_smem : k, use_smem);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  bytes = sizeof(float) * static_cast<size_t>(k) * k;
  use_smem = bytes <= static_cast<size_t>(smem_optin);
  if (!use_smem) bytes = 0;
  err = allow_smem(reinterpret_cast<const void*>(chol_solve_clip_kernel),
                   bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_solve_clip_kernel<<<(n + kSolveThreads - 1) / kSolveThreads,
                           kSolveThreads, bytes, s>>>(
      L, B, X, k, n, use_smem, nonneg, upper_bound);
  return static_cast<int>(cudaGetLastError());
}
