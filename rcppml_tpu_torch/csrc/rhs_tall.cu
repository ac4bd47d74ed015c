// B = F . A and B = H . A^T with A read from device memory once, for sm_90a.
//
// Replaces the TPU kernels rcppml_tpu/ops/pallas_experiments.py::
// rhs_tall_pallas (B = F . A, F (k, m), A (m, n)) and rhs_tall_t_pallas
// (B = H . A^T, H (k, n), A (m, n), no transpose made).  The device code is
// in rhs_tall.cuh, where the design and the bound are set out; the same code
// computes the two products inside fused_als.cu.  The plain versions are
// rcppml_tpu_torch/ops/rhs_tall.py::rhs_tall_plain / rhs_tall_t_plain.

#include "rhs_tall.cuh"

// out (k, n) = F (k, m) . A (m, n), or with transposed != 0
// out (k, m) = H (k, n) . A (m, n)^T, where X is F or H.  A holds float32, or
// bfloat16 with a_bf16 != 0 (X is then rounded to bfloat16).  Everything is
// row-major and dense.  The reduction (over m, or over n when transposed) is
// cut into `splits` ranges of `chunk` (a multiple of 32) that are summed in
// the order of their index; with splits > 1 `work` holds splits partial
// outputs.  Returns the cudaError_t of the first launch that failed (0 on
// success).
extern "C" int rhs_tall_launch(const float* X, const void* A, float* out,
                               float* work, int k, int m, int n, int a_bf16,
                               int transposed, int splits, int chunk,
                               void* stream) {
  if (k <= 0 || m <= 0 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int J = transposed ? m : n;
  const int R = transposed ? n : m;
  float* partials = splits > 1 ? work : out;
  if (partials == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = rhs_tall::launch_product(X, R, A, n, a_bf16 != 0,
                                             transposed != 0, partials, k, J,
                                             R, splits, chunk, s);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  err = rhs_tall::launch_reduce(partials, splits,
                                static_cast<size_t>(k) * J, 0.f, out, nullptr,
                                s);
  return static_cast<int>(err);
}
