// B = F . A and B = H . A^T with A read from device memory once, for sm_90a.
//
// Replaces the TPU kernels rcppml_tpu/ops/pallas_experiments.py::
// rhs_tall_pallas (B = F . A, F (k, m), A (m, n)) and rhs_tall_t_pallas
// (B = H . A^T, H (k, n), A (m, n), no transpose made).  The device code is
// the tall product of rhs_tall.cuh, where the design and the bound are set
// out: tensor cores (bfloat16, or 3xTF32 for a float32 A), producer warps
// that keep a ring of 16-byte cp.async stages in flight whatever the
// alignment of A's rows, the work cut into equal runs across the card
// (stream-K).  What bounds it is the copy of A, which the ring moves at
// about 2.4 TB/s on an H100.  A call enqueues the preparation of the small
// operand, the product and the sum of its pieces.  The same device code
// computes the two products inside fused_als.cu.  The plain versions are
// rcppml_tpu_torch/ops/rhs_tall.py::rhs_tall_plain / rhs_tall_t_plain.

#include "rhs_tall.cuh"

// out (k, n) = F (k, m) . A (m, n), or with transposed != 0
// out (k, m) = H (k, n) . A (m, n)^T, where X is F or H.  A holds float32, or
// bfloat16 with a_bf16 != 0.  X is first prepared into `small` (rounded to
// bfloat16, or split into TF32 high and low parts: rhs_tall::store_small), a
// buffer of (k, small_ld(R)) bfloat16 values or 2 (k, small_ld(R)) words.
// Everything is row-major and dense.  The product runs in `blocks` runs of
// equal length (rhs_tall::launch_tall); `work` holds their pieces, 2 blocks
// k 128 floats, which are then added in the order of their blocks.  Returns
// the cudaError_t of the first launch that failed (0 on success).
extern "C" int rhs_tall_launch(const float* X, const void* A, float* out,
                               float* work, void* small, int k, int m, int n,
                               int a_bf16, int transposed, int blocks,
                               void* stream) {
  if (k <= 0 || m <= 0 || n <= 0 || work == nullptr || small == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int J = transposed ? m : n;
  const int R = transposed ? n : m;
  const bool bf16 = a_bf16 != 0;
  const int ldp = rhs_tall::small_ld(R, bf16);
  cudaError_t err = rhs_tall::launch_prepare(X, R, small, ldp, k, R, bf16, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = rhs_tall::launch_tall(small, ldp, A, n, bf16, transposed != 0, work, k,
                              J, R, blocks, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = rhs_tall::launch_tall_reduce(work, blocks, k, J, R, bf16, 0.f, out,
                                     nullptr, s);
  return static_cast<int>(err);
}
